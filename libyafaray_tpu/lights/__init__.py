"""Unified light table: masked vectorized sample / pdf / emission.

Replaces the reference Light hierarchy (src/light/*, factory light.cc:46-55,
interface include/light/light.h:45-85). All light types are evaluated with
per-lane masks so a dynamically chosen light index (the path tracer's uniform
light pick, integrator_montecarlo.cc:70) costs one pass of cheap VPU math.

Conventions:
  - `color` column stores: radiance L_e for area-type lights (area/sphere/
    mesh), intensity (W/sr) for dirac lights (point/spot/directional/sun core).
  - `sample_light` returns solid-angle pdfs; dirac lights get pdf=1 and
    `is_dirac=True` with radiance already divided by distance^2.
"""
from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from .. import params as P
from ..math import vec
from ..scene_types import (
    LIGHT_AREA, LIGHT_BACKGROUND, LIGHT_BGPORTAL, LIGHT_DIRECTIONAL,
    LIGHT_IES, LIGHT_MESH, LIGHT_POINT, LIGHT_SPHERE, LIGHT_SPOT, LIGHT_SUN,
    LightTable, SceneData,
)

Array = jax.Array

FLAG_CAST_SHADOWS = 1
FLAG_ENABLED = 2
FLAG_PHOTON_ONLY = 4
FLAG_DOUBLE_SIDED = 8

WORLD_RADIUS = 1e4  # scene-bound proxy for infinite lights


@struct.dataclass
class LightSample:
    wi: Array        # f32[N,3] direction to light
    dist: Array      # f32[N] distance to light sample (inf for infinite)
    pdf: Array       # f32[N] solid-angle pdf (1 for dirac)
    radiance: Array  # f32[N,3] incident radiance (dirac: already /d^2)
    is_dirac: Array  # bool[N]
    valid: Array     # bool[N]


def _spot_falloff(cos_a: Array, cos_start: Array, cos_end: Array,
                  falloff: Array) -> Array:
    """Smooth spot edge (reference light_spot.cc: falloff curve between the
    inner and outer cone)."""
    t = (cos_a - cos_end) / jnp.maximum(cos_start - cos_end, 1e-9)
    t = jnp.clip(t, 0.0, 1.0)
    smooth = t * t * (3.0 - 2.0 * t)
    return jnp.where(cos_a >= cos_start, 1.0,
                     jnp.power(smooth, jnp.maximum(falloff, 1e-6)))


def _ies_factor(lt: LightTable, li: Array, cos_a: Array,
                wdir: Array | None = None) -> Array:
    """IES photometric profile lookup: candela multiplier vs (horizontal,
    vertical) emission angle (reference light_ies.cc getAngles +
    light_ies_data.h getRadiance). Profiles are resampled host-side to a
    uniform [IES_RES_H, IES_RES] grid (periodic in the horizontal angle),
    so the runtime is one bilinear fetch. `wdir` is the world direction
    used for the horizontal angle (surface->light for illumination,
    light->out for emission, mirroring the reference's two call sites);
    None means axially-symmetric lookup at h=0."""
    ies_id = lt.ies_id[li]
    has = ies_id >= 0
    if lt.ies_pool.ndim != 3:
        return jnp.ones_like(cos_a)
    res_h, res_v = lt.ies_pool.shape[-2], lt.ies_pool.shape[-1]
    prof = lt.ies_pool[jnp.maximum(ies_id, 0)]  # [N, res_h, res_v]
    lanes = jnp.arange(cos_a.shape[0])
    # vertical: angle from the light axis over [0, pi]
    xv = jnp.arccos(jnp.clip(cos_a, -1.0, 1.0)) / jnp.pi * (res_v - 1)
    v0 = jnp.clip(xv.astype(jnp.int32), 0, res_v - 2)
    fv = xv - v0
    # horizontal: reference getAngles (light_ies.cc:51-61) keys the
    # azimuth off the world direction: u = acos(dir.z), mirrored to
    # [180, 360) when dir.y < 0
    if res_h == 1 or wdir is None:
        h0 = jnp.zeros_like(v0)
        h1 = jnp.zeros_like(v0)
        fh = jnp.zeros_like(fv)
    else:
        u = jnp.arccos(jnp.clip(wdir[..., 2], -1.0, 1.0))
        u = jnp.where(wdir[..., 1] < 0.0, 2.0 * jnp.pi - u, u)
        xh = u / (2.0 * jnp.pi) * res_h
        h0 = jnp.mod(xh.astype(jnp.int32), res_h)
        h1 = jnp.mod(h0 + 1, res_h)
        fh = xh - jnp.floor(xh)
    p00 = prof[lanes, h0, v0]
    p01 = prof[lanes, h0, v0 + 1]
    p10 = prof[lanes, h1, v0]
    p11 = prof[lanes, h1, v0 + 1]
    val = ((p00 * (1 - fv) + p01 * fv) * (1 - fh)
           + (p10 * (1 - fv) + p11 * fv) * fh)
    return jnp.where(has, val, jnp.ones_like(cos_a))


def _has(lt: LightTable, ty: int) -> bool:
    """Trace-time presence check: light families absent from the scene are
    never traced (present_types is a static field; empty = unknown)."""
    return (not lt.present_types) or (ty in lt.present_types)


def sample_light_tri(lt: LightTable, num_faces: int, li: Array, u1: Array):
    """Area-CDF triangle pick within light li's face range [tri_start,
    tri_start+cnt) — the Pdf1D::dSample of light_object_light.cc /
    light_background_portal.cc sampleSurface. Bisection over the per-face
    normalized cumulative areas; uniform-AREA density 1/total_area, so the
    MIS pdf needs no per-triangle term. Returns (tri index, rescaled u1)."""
    start = lt.tri_start[li]
    cnt = jnp.maximum(lt.tri_count[li], 1)
    if lt.tri_cdf is None:   # no mesh lights compiled; uniform pick fallback
        x = u1 * cnt.astype(jnp.float32)
        tri = start + jnp.clip(x.astype(jnp.int32), 0, cnt - 1)
        return tri, x - jnp.floor(x)
    k = max(1, int(math.ceil(math.log2(max(2, num_faces)))))
    lo = jnp.zeros_like(start)
    hi = cnt - 1

    def body(_, st):
        lo, hi = st
        mid = (lo + hi) // 2
        cm = lt.tri_cdf[start + mid]
        go_hi = u1 > cm
        return (jnp.where(go_hi, mid + 1, lo),
                jnp.where(go_hi, hi, mid))

    lo, _ = jax.lax.fori_loop(0, k, body, (lo, hi))
    idx = jnp.clip(lo, 0, cnt - 1)
    tri = start + idx
    c1 = lt.tri_cdf[tri]
    c0 = jnp.where(idx > 0, lt.tri_cdf[jnp.maximum(tri - 1, 0)], 0.0)
    u1r = jnp.clip((u1 - c0) / jnp.maximum(c1 - c0, 1e-12), 0.0, 1.0)
    return tri, u1r


def sample_light(scene: SceneData, li: Array, p: Array, ns: Array,
                 u1: Array, u2: Array) -> LightSample:
    """Light::illumSample for a per-lane light index `li` at shading points
    `p` (with shading normal `ns` for pdf-free culling)."""
    lt = scene.lights
    ty = lt.light_type[li]
    pos = lt.position[li]
    ldir = lt.direction[li]
    col = lt.color[li]
    n = p.shape[0]

    to_l = pos - p
    d2 = jnp.maximum(vec.dot(to_l, to_l), 1e-12)
    dist_pt = jnp.sqrt(d2)
    wi_pt = to_l / dist_pt[..., None]

    wi = jnp.zeros_like(p)
    dist = jnp.full((n,), jnp.inf, jnp.float32)
    pdf = jnp.ones((n,), jnp.float32)
    rad = jnp.zeros_like(p)
    dirac = jnp.zeros((n,), bool)
    valid = jnp.ones((n,), bool)

    # ---- point (light_point.cc) + IES ----
    if _has(lt, LIGHT_POINT):
        m = ty == LIGHT_POINT
        rad_p = col / d2[..., None]
        wi = jnp.where(m[..., None], wi_pt, wi)
        dist = jnp.where(m, dist_pt, dist)
        rad = jnp.where(m[..., None], rad_p, rad)
        dirac = dirac | m

    # ---- IES (dirac with profile factor around axis) ----
    if _has(lt, LIGHT_IES):
        m = ty == LIGHT_IES
        cos_ax = vec.dot(-wi_pt, ldir)
        ies_f = _ies_factor(lt, li, cos_ax, wi_pt)
        rad_i = col * (ies_f / d2)[..., None]
        wi = jnp.where(m[..., None], wi_pt, wi)
        dist = jnp.where(m, dist_pt, dist)
        rad = jnp.where(m[..., None], rad_i, rad)
        dirac = dirac | m

    # ---- spot (light_spot.cc) ----
    if _has(lt, LIGHT_SPOT):
        m = ty == LIGHT_SPOT
        cos_a = vec.dot(-wi_pt, ldir)
        fall = _spot_falloff(cos_a, lt.cos_start[li], lt.cos_end[li], lt.falloff[li])
        rad_s = col * (fall / d2)[..., None]
        wi = jnp.where(m[..., None], wi_pt, wi)
        dist = jnp.where(m, dist_pt, dist)
        rad = jnp.where(m[..., None], rad_s, rad)
        dirac = dirac | m
        valid = valid & jnp.where(m, fall > 0.0, True)

    # ---- directional (light_directional.cc) ----
    if _has(lt, LIGHT_DIRECTIONAL):
        m = ty == LIGHT_DIRECTIONAL
        wi = jnp.where(m[..., None], -ldir, wi)
        rad = jnp.where(m[..., None], col, rad)
        dirac = dirac | m

    # ---- sun: cone around -direction (light_sun.cc) ----
    if _has(lt, LIGHT_SUN):
        m = ty == LIGHT_SUN
        cos_max = lt.cos_start[li]
        u_ax, v_ax = vec.orthonormal_basis(-ldir)
        cone = vec.uniform_sample_cone(u1, u2, cos_max)
        wi_sun = (u_ax * cone[..., 0:1] + v_ax * cone[..., 1:2]
                  + (-ldir) * cone[..., 2:3])
        pdf_sun = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max), 1e-9)
        wi = jnp.where(m[..., None], wi_sun, wi)
        pdf = jnp.where(m, pdf_sun, pdf)
        rad = jnp.where(m[..., None], col, rad)

    # ---- area light: parallelogram corner+e1+e2 (light_area.cc) ----
    if _has(lt, LIGHT_AREA):
        m = ty == LIGHT_AREA
        lp = pos + lt.edge1[li] * u1[..., None] + lt.edge2[li] * u2[..., None]
        to_a = lp - p
        d2a = jnp.maximum(vec.dot(to_a, to_a), 1e-12)
        dist_a = jnp.sqrt(d2a)
        wi_a = to_a / dist_a[..., None]
        cos_l = vec.dot(-wi_a, ldir)
        dbl = (lt.flags[li] & FLAG_DOUBLE_SIDED) != 0
        cos_l_eff = jnp.where(dbl, jnp.abs(cos_l), cos_l)
        pdf_a = d2a / jnp.maximum(lt.area[li] * jnp.maximum(cos_l_eff, 1e-9), 1e-12)
        ok_a = cos_l_eff > 1e-6
        wi = jnp.where(m[..., None], wi_a, wi)
        dist = jnp.where(m, dist_a, dist)
        pdf = jnp.where(m, pdf_a, pdf)
        rad = jnp.where(m[..., None], col, rad)
        valid = valid & jnp.where(m, ok_a, True)

    # ---- sphere light: solid-angle cone sampling (light_sphere.cc) ----
    if _has(lt, LIGHT_SPHERE):
        m = ty == LIGHT_SPHERE
        r = lt.radius[li]
        sin2_max = jnp.clip(r * r / d2, 0.0, 1.0)
        cos_max_s = jnp.sqrt(jnp.maximum(1.0 - sin2_max, 0.0))
        u_s, v_s = vec.orthonormal_basis(wi_pt)
        cone_s = vec.uniform_sample_cone(u1, u2, cos_max_s)
        wi_s = (u_s * cone_s[..., 0:1] + v_s * cone_s[..., 1:2]
                + wi_pt * cone_s[..., 2:3])
        pdf_s = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max_s), 1e-9)
        inside = d2 <= r * r
        # exact shadow-ray length: distance to the sphere surface along the
        # sampled cone direction (nearer root of |o + t*wi - c| = r), not
        # the center distance — occluders between surface and center were
        # mis-shadowed before (reference light_sphere.cc intersects exactly)
        mm = vec.dot(to_l, wi_s)
        disc = r * r - (d2 - mm * mm)
        dist_s = mm - jnp.sqrt(jnp.maximum(disc, 0.0))
        wi = jnp.where(m[..., None], wi_s, wi)
        dist = jnp.where(m, jnp.maximum(dist_s, 1e-6), dist)
        pdf = jnp.where(m, pdf_s, pdf)
        rad = jnp.where(m[..., None], col, rad)
        valid = valid & jnp.where(m, ~inside, True)

    # ---- mesh light / background portal: area-CDF triangle pick
    #      (light_object_light.cc, light_background_portal.cc) ----
    has_mesh = scene.geom.num_faces > 0 and _has(lt, LIGHT_MESH)
    has_portal = scene.geom.num_faces > 0 and _has(lt, LIGHT_BGPORTAL)
    if has_mesh or has_portal:
        m_mesh = ty == LIGHT_MESH
        m_port = ty == LIGHT_BGPORTAL
        m = (m_mesh | m_port) if (has_mesh and has_portal) else (
            m_mesh if has_mesh else m_port)
        g = scene.geom
        tri_i, u1r = sample_light_tri(lt, g.num_faces, li, u1)
        fidx = g.faces[tri_i]
        v0 = g.vertices[fidx[:, 0]]
        v1 = g.vertices[fidx[:, 1]]
        v2 = g.vertices[fidx[:, 2]]
        b0, b1 = vec.sample_triangle_uniform(u1r, u2)
        lp_m = v0 * b0[..., None] + v1 * b1[..., None] + v2 * (1 - b0 - b1)[..., None]
        nrm = jnp.cross(v1 - v0, v2 - v0)
        n_l = nrm / jnp.maximum(vec.length(nrm), 1e-12)[..., None]
        to_m = lp_m - p
        d2m = jnp.maximum(vec.dot(to_m, to_m), 1e-12)
        dist_m = jnp.sqrt(d2m)
        wi_m = to_m / dist_m[..., None]
        cos_signed = vec.dot(-wi_m, n_l)
        # portals are single-sided (portal illumSample cos_angle<=0 cull);
        # mesh lights emit from both faces
        cos_lm = jnp.where(m_port, cos_signed, jnp.abs(cos_signed)) \
            if has_portal else jnp.abs(cos_signed)
        # area-CDF pick => uniform density 1/total_area over the surface
        pdf_m = d2m / jnp.maximum(
            lt.area[li] * jnp.maximum(cos_lm, 1e-9), 1e-12)
        rad_m = col
        if has_portal:
            from .. import backgrounds as BG
            rad_m = jnp.where(m_port[..., None],
                              BG.eval_background(scene, wi_m) * col, col)
        wi = jnp.where(m[..., None], wi_m, wi)
        dist = jnp.where(m, dist_m, dist)
        pdf = jnp.where(m, pdf_m, pdf)
        rad = jnp.where(m[..., None], rad_m, rad)
        valid = valid & jnp.where(m, cos_lm > 1e-6, True)

    # ---- background light (light_background.cc) ----
    m = ty == LIGHT_BACKGROUND
    if scene.lights.bg_light_idx >= 0:
        from .. import backgrounds as BG
        bg = scene.background
        if (bg.env_alias_prob is not None and bg.env_shape[0] > 0):
            from ..textures import env_alias_sample
            wi_b, pdf_b = env_alias_sample(scene, u1, u2)
        else:
            wi_b = vec.uniform_sample_sphere(u1, u2)
            pdf_b = jnp.full((n,), 1.0 / (4.0 * jnp.pi), jnp.float32)
        rad_b = BG.eval_background(scene, wi_b)
        wi = jnp.where(m[..., None], wi_b, wi)
        pdf = jnp.where(m, pdf_b, pdf)
        rad = jnp.where(m[..., None], rad_b, rad)

    enabled = (lt.flags[li] & FLAG_ENABLED) != 0
    photon_only = (lt.flags[li] & FLAG_PHOTON_ONLY) != 0
    valid = valid & enabled & ~photon_only & (vec.dot(rad, rad) > 0)
    return LightSample(wi=wi, dist=dist, pdf=jnp.maximum(pdf, 1e-12),
                       radiance=rad, is_dirac=dirac, valid=valid)


def light_pdf_hit(scene: SceneData, light_id: Array, p_hit: Array, n_hit: Array,
                  p_from: Array) -> Array:
    """pdf (solid angle) that `sample_light` would have generated the
    direction from p_from to p_hit on intersectable light `light_id` —
    Light::illumPdf, needed for BSDF-sample MIS
    (integrator_montecarlo.cc areaLightSampleMaterial:284)."""
    lt = scene.lights
    ty = lt.light_type[light_id]
    to_h = p_hit - p_from
    d2 = jnp.maximum(vec.dot(to_h, to_h), 1e-12)
    wi = to_h * jax.lax.rsqrt(d2)[..., None]
    cos_l = jnp.abs(vec.dot(-wi, n_hit))
    pdf = jnp.zeros(p_from.shape[:-1], jnp.float32)

    if _has(lt, LIGHT_AREA):
        m = ty == LIGHT_AREA
        pdf = jnp.where(m, d2 / jnp.maximum(
            lt.area[light_id] * jnp.maximum(cos_l, 1e-9), 1e-12), pdf)
    if _has(lt, LIGHT_MESH):
        m = ty == LIGHT_MESH
        # area-CDF sampling (sample_light_tri) has uniform density
        # 1/total_area over the whole light surface, so this is EXACT for
        # unequal triangles too (lt.area = sum of tri areas)
        pdf = jnp.where(m, d2 / jnp.maximum(
            lt.area[light_id] * jnp.maximum(cos_l, 1e-9), 1e-12), pdf)
    if _has(lt, LIGHT_BGPORTAL):
        # single-sided: zero pdf from behind (portal illumPdf cos_n>0 test)
        m = ty == LIGHT_BGPORTAL
        cos_sp = vec.dot(-wi, n_hit)
        pdf = jnp.where(
            m, jnp.where(cos_sp > 1e-9,
                         d2 / jnp.maximum(lt.area[light_id]
                                          * jnp.maximum(cos_sp, 1e-9), 1e-12),
                         0.0), pdf)
    if _has(lt, LIGHT_SPHERE):
        m = ty == LIGHT_SPHERE
        c = lt.position[light_id]
        r = lt.radius[light_id]
        dc2 = jnp.maximum(vec.length_sq(c - p_from), 1e-12)
        sin2_max = jnp.clip(r * r / dc2, 0.0, 1.0)
        cos_max = jnp.sqrt(jnp.maximum(1.0 - sin2_max, 0.0))
        pdf = jnp.where(m, 1.0 / jnp.maximum(
            2.0 * jnp.pi * (1.0 - cos_max), 1e-9), pdf)
    return pdf


def background_pdf(scene: SceneData, d: Array) -> Array:
    """pdf of the background light generating direction d (env MIS)."""
    bg = scene.background
    if scene.lights.bg_light_idx < 0:
        return jnp.zeros(d.shape[:-1], jnp.float32)
    if bg.env_alias_prob is not None and bg.env_shape[0] > 0:
        from ..textures import env_pdf_dir
        return env_pdf_dir(scene, d)
    return jnp.full(d.shape[:-1], 1.0 / (4.0 * jnp.pi), jnp.float32)
