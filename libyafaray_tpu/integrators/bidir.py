"""Wavefront bidirectional path tracer (BDPT).

Wavefront re-design of the reference BidirectionalIntegrator
(src/integrator/surface/integrator_bidirectional.cc: createPath /
connectPaths / evalPath / pathWeight, include/integrator/surface/
integrator_bidirectional.h:53-65; flagged UNSTABLE in the reference factory,
src/integrator/integrator.cc:48). Instead of per-pixel recursive subpath
objects, whole wavefronts of eye and light subpaths are generated in two
statically-unrolled masked walks, then every (s,t) pair is connected with a
batched shadow ray; the contributions are MIS-weighted with the
power heuristic computed from stored forward/reverse area pdfs
(Veach-style, the vectorized equivalent of the reference's pathWeight).

Strategy set (all per-lane, all vectorized):
  - (s=0, t)   eye path hits an intersectable light -> emission term;
  - (s=1, t)   eye vertex z_t connected to the light subpath origin y_0
               (area-measure NEE; the shared light sample);
  - (s>=2, t)  eye vertex z_t connected to light subpath vertex y_{s-1}.
  - t = 0/1 strategies (light tracing splatted through the camera,
    reference connectPathE) ARE generated: light-subpath vertices are
    projected through cameras.project_lens() — pinhole AND thin-lens
    DOF (a fresh lens sample per lane refocused through the focal
    plane) — and returned as splat (pixel, rgb) pairs accumulated by
    film.add_splats. Gated to perspective cameras (like the reference,
    whose connectPathE calls Camera::project); on other camera kinds
    the strategy family is skipped and the MIS denominators exclude it,
    which keeps the estimator unbiased (weights still sum to one over
    the generated strategies).

Light subpaths start only from positional lights (point/spot/ies/area/
sphere/mesh). Directional/sun lights are handled by classic NEE at every
eye vertex (they admit no competing strategy -> weight 1); the background
is handled exactly like the forward path tracer (NEE + escaped-ray MIS).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp

from .. import lights as L
from .. import sampler
from ..backgrounds import eval_background
from ..materials import bsdf as B
from ..materials.nodes import bump_normal
from ..math import vec
from ..ops import intersect as I
from ..ops import surface as S
from ..scene_types import (LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_IES,
                           LIGHT_MESH, LIGHT_POINT, LIGHT_SPHERE, LIGHT_SPOT,
                           LIGHT_SUN, SceneData)
from . import common

Array = jax.Array

_EPS_PDF = 1e-12


def _remap0(p: Array) -> Array:
    """Veach/PBRT remap: treat zero pdfs as 1 in MIS ratio products (the
    corresponding strategies are excluded via the connectible flags)."""
    return jnp.where(p > 0.0, p, 1.0)


def _to_area(pdf_sa: Array, d2: Array, cos_t: Array) -> Array:
    """Solid-angle pdf at the source -> area pdf at the target point."""
    return pdf_sa * jnp.abs(cos_t) / jnp.maximum(d2, _EPS_PDF)


class _Vertex:
    """Per-depth SoA record of one subpath vertex (host-side container of
    device arrays; depths are static so a plain Python list of these keeps
    the whole construct jit-traceable)."""

    def __init__(self, sp, wo, beta, pdf_fwd, pdf_rev, connectible, valid,
                 d2_prev, cos_prev):
        self.sp = sp                    # SurfacePoint pytree [N]
        self.wo = wo                    # f32[N,3] direction toward previous
        self.beta = beta                # f32[N,3] throughput up to here
        self.pdf_fwd = pdf_fwd          # f32[N] area pdf from own side
        self.pdf_rev = pdf_rev          # f32[N] area pdf from opposite side
        self.connectible = connectible  # bool[N] non-delta lobes exist here
        self.valid = valid              # bool[N]
        self.d2_prev = d2_prev          # f32[N] |x - prev|^2
        self.cos_prev = cos_prev        # f32[N] |cos| at prev toward here


def _connectible(scene: SceneData, sp) -> Array:
    mp = B.resolve_mp(scene, sp)
    cos_one = jnp.ones(sp.t.shape, jnp.float32)
    _, _, w_mf, w_di, w_tl = B.lobe_weights(mp, cos_one)
    return (w_mf + w_di + w_tl) > 1e-6


# ---------------------------------------------------------------------------
# Light subpath origin: sample emission with explicit pdfs
# ---------------------------------------------------------------------------

class _LightOrigin:
    def __init__(self, li, p, nrm, has_normal, pdf_pos, pdf_dir, d0,
                 delta_pos, valid):
        self.li = li                # i32[N] light index
        self.p = p                  # f32[N,3]
        self.nrm = nrm              # f32[N,3] emission normal (0 if none)
        self.has_normal = has_normal  # bool[N]
        self.pdf_pos = pdf_pos      # f32[N] area pdf (1 for delta position)
        self.pdf_dir = pdf_dir      # f32[N] solid-angle pdf of d0
        self.d0 = d0                # f32[N,3] first emission direction
        self.delta_pos = delta_pos  # bool[N]
        self.valid = valid          # bool[N]
        self.pdf_rev = None         # f32[N] area pdf of y_0 from y_1
                                    # (filled during the light walk)


def _emit_origin(scene: SceneData, pid: Array, sid: Array) -> _LightOrigin:
    """Sample y_0 + first direction on a uniformly picked positional light
    (Light::emitSample analogue with explicit (pdf_pos, pdf_dir))."""
    lt = scene.lights
    nl = max(lt.num_lights, 1)
    n = pid.shape[0]
    u = sampler.rand4(pid, sid, 0, 3000)
    ul, u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    u4 = sampler.rand1(pid, sid, 0, 3001)
    li = jnp.clip((ul * nl).astype(jnp.int32), 0, nl - 1)
    ty = lt.light_type[li]
    pos = lt.position[li]

    p = jnp.zeros((n, 3), jnp.float32)
    nrm = jnp.zeros((n, 3), jnp.float32)
    has_n = jnp.zeros((n,), bool)
    pdf_pos = jnp.ones((n,), jnp.float32)
    pdf_dir = jnp.ones((n,), jnp.float32)
    d0 = jnp.zeros((n, 3), jnp.float32)
    delta_pos = jnp.zeros((n,), bool)
    valid = jnp.zeros((n,), bool)

    # point / ies: delta position, uniform-sphere direction
    m = (ty == LIGHT_POINT) | (ty == LIGHT_IES)
    d_sph = vec.uniform_sample_sphere(u1, u2)
    p = jnp.where(m[..., None], pos, p)
    d0 = jnp.where(m[..., None], d_sph, d0)
    pdf_dir = jnp.where(m, 1.0 / (4.0 * jnp.pi), pdf_dir)
    delta_pos = delta_pos | m
    valid = valid | m

    # spot: delta position, uniform cone
    m = ty == LIGHT_SPOT
    axis = lt.direction[li]
    au, av = vec.orthonormal_basis(axis)
    cone = vec.uniform_sample_cone(u1, u2, lt.cos_end[li])
    d_sp = au * cone[..., 0:1] + av * cone[..., 1:2] + axis * cone[..., 2:3]
    omega = jnp.maximum(2.0 * jnp.pi * (1.0 - lt.cos_end[li]), 1e-9)
    p = jnp.where(m[..., None], pos, p)
    d0 = jnp.where(m[..., None], d_sp, d0)
    pdf_dir = jnp.where(m, 1.0 / omega, pdf_dir)
    delta_pos = delta_pos | m
    valid = valid | m

    # area: uniform parallelogram point, cosine direction
    m = ty == LIGHT_AREA
    lp = pos + lt.edge1[li] * u1[..., None] + lt.edge2[li] * u2[..., None]
    a_n = lt.direction[li]
    nu, nv = vec.orthonormal_basis(a_n)
    dl = vec.cosine_sample_hemisphere(u3, u4)
    d_ar = nu * dl[..., 0:1] + nv * dl[..., 1:2] + a_n * dl[..., 2:3]
    p = jnp.where(m[..., None], lp, p)
    nrm = jnp.where(m[..., None], a_n, nrm)
    d0 = jnp.where(m[..., None], d_ar, d0)
    pdf_pos = jnp.where(m, 1.0 / jnp.maximum(lt.area[li], _EPS_PDF), pdf_pos)
    pdf_dir = jnp.where(m, jnp.maximum(dl[..., 2], 1e-9) / jnp.pi, pdf_dir)
    has_n = has_n | m
    valid = valid | m

    # sphere: uniform surface point, cosine direction around surface normal
    m = ty == LIGHT_SPHERE
    sn = vec.uniform_sample_sphere(u1, u2)
    sp_p = pos + sn * lt.radius[li][..., None]
    su, sv = vec.orthonormal_basis(sn)
    dl2 = vec.cosine_sample_hemisphere(u3, u4)
    d_sl = su * dl2[..., 0:1] + sv * dl2[..., 1:2] + sn * dl2[..., 2:3]
    r = lt.radius[li]
    area_s = jnp.maximum(4.0 * jnp.pi * r * r, _EPS_PDF)
    p = jnp.where(m[..., None], sp_p, p)
    nrm = jnp.where(m[..., None], sn, nrm)
    d0 = jnp.where(m[..., None], d_sl, d0)
    pdf_pos = jnp.where(m, 1.0 / area_s, pdf_pos)
    pdf_dir = jnp.where(m, jnp.maximum(dl2[..., 2], 1e-9) / jnp.pi, pdf_dir)
    has_n = has_n | m
    valid = valid | m

    # mesh light: area-CDF triangle pick + cosine direction
    if scene.geom.num_faces > 0:
        from ..lights import sample_light_tri
        m = ty == LIGHT_MESH
        g = scene.geom
        tri_i, u1r = sample_light_tri(lt, g.num_faces, li, u1)
        fidx = g.faces[tri_i]
        v0 = g.vertices[fidx[:, 0]]
        v1 = g.vertices[fidx[:, 1]]
        v2 = g.vertices[fidx[:, 2]]
        b0, b1 = vec.sample_triangle_uniform(u1r, u2)
        lp_m = (v0 * b0[..., None] + v1 * b1[..., None]
                + v2 * (1 - b0 - b1)[..., None])
        cr = jnp.cross(v1 - v0, v2 - v0)
        area2 = vec.length(cr)
        n_m = cr / jnp.maximum(area2, _EPS_PDF)[..., None]
        mu, mv = vec.orthonormal_basis(n_m)
        dl3 = vec.cosine_sample_hemisphere(u3, u4)
        d_m = mu * dl3[..., 0:1] + mv * dl3[..., 1:2] + n_m * dl3[..., 2:3]
        p = jnp.where(m[..., None], lp_m, p)
        nrm = jnp.where(m[..., None], n_m, nrm)
        d0 = jnp.where(m[..., None], d_m, d0)
        # approx equal-area triangles (consistent with light_pdf_hit)
        pdf_pos = jnp.where(m, 1.0 / jnp.maximum(lt.area[li], _EPS_PDF),
                            pdf_pos)
        pdf_dir = jnp.where(m, jnp.maximum(dl3[..., 2], 1e-9) / jnp.pi,
                            pdf_dir)
        has_n = has_n | m
        valid = valid | m

    enabled = (lt.flags[li] & L.FLAG_ENABLED) != 0
    valid = valid & enabled
    return _LightOrigin(li=li, p=p, nrm=nrm, has_normal=has_n,
                        pdf_pos=pdf_pos, pdf_dir=pdf_dir, d0=d0,
                        delta_pos=delta_pos, valid=valid)


def _emit_radiance_toward(scene: SceneData, org: _LightOrigin, wo: Array
                          ) -> Array:
    """Emitted radiance (intensity for delta-position lights) from y_0
    toward unit direction `wo`."""
    lt = scene.lights
    li = org.li
    ty = lt.light_type[li]
    col = lt.color[li]
    rad = jnp.zeros_like(col)

    m = (ty == LIGHT_POINT)
    rad = jnp.where(m[..., None], col, rad)

    m = ty == LIGHT_IES
    # _ies_factor expects the direction light->target convention used by
    # sample_light (cos against the light axis)
    cos_ax = vec.dot(wo, lt.direction[li])
    from ..lights import _ies_factor
    rad = jnp.where(m[..., None],
                    col * _ies_factor(lt, li, cos_ax, wo)[..., None],
                    rad)

    m = ty == LIGHT_SPOT
    cos_a = vec.dot(wo, lt.direction[li])
    from ..lights import _spot_falloff
    fall = _spot_falloff(cos_a, lt.cos_start[li], lt.cos_end[li],
                         lt.falloff[li])
    rad = jnp.where(m[..., None], col * fall[..., None], rad)

    area_like = ((ty == LIGHT_AREA) | (ty == LIGHT_SPHERE)
                 | (ty == LIGHT_MESH))
    cos_n = vec.dot(wo, org.nrm)
    dbl = (lt.flags[li] & L.FLAG_DOUBLE_SIDED) != 0
    front = (cos_n > 0.0) | dbl
    rad = jnp.where((area_like & front)[..., None], col, rad)
    return rad


def _light_pdf_pos_hit(scene: SceneData, light_id: Array) -> Array:
    """Area pdf of sampling the hit light's surface point via _emit_origin
    (for the s'=0 alternative-strategy term in the MIS walks)."""
    lt = scene.lights
    ty = lt.light_type[light_id]
    area = jnp.maximum(lt.area[light_id], _EPS_PDF)
    r = lt.radius[light_id]
    pdf = jnp.zeros(light_id.shape, jnp.float32)
    pdf = jnp.where((ty == LIGHT_AREA) | (ty == LIGHT_MESH), 1.0 / area, pdf)
    pdf = jnp.where(ty == LIGHT_SPHERE,
                    1.0 / jnp.maximum(4.0 * jnp.pi * r * r, _EPS_PDF), pdf)
    return pdf


# ---------------------------------------------------------------------------
# Subpath generation
# ---------------------------------------------------------------------------

def _walk_eye(scene, cfg, o, d, valid, pid, sid, max_t: int):
    """Generate eye subpath vertices z_1..z_{max_t}; returns (vertices,
    per-depth dicts of escaped/emission bookkeeping for the s=0 and
    background strategies)."""
    n = o.shape[0]
    beta = jnp.ones((n, 3), jnp.float32)
    alive = valid
    prev_prim = jnp.full((n,), -1, jnp.int32)
    prev_pdf_sa = jnp.zeros((n,), jnp.float32)
    prev_delta = jnp.ones((n,), bool)
    verts: List[_Vertex] = []
    escapes = []  # (escaped mask, beta, dir, prev_pdf_sa, prev_delta)
    alpha = jnp.zeros((n,), jnp.float32)
    first_hit_t = jnp.full((n,), 1e30, jnp.float32)
    first_sp = None

    for depth in range(max_t):
        if depth == 0:
            hit = I.camera_hit(scene, o, d, scene.ray_min_dist, 1e30)
        else:
            hit = I.closest_hit(scene, o, d, scene.ray_min_dist, 1e30,
                                exclude_prim=prev_prim)
        hit = hit.replace(valid=hit.valid & alive)
        sp = S.make_surface(scene, hit, o, d)
        sp = bump_normal(scene, sp)
        escaped = alive & ~hit.valid
        escapes.append((escaped, beta, d, prev_pdf_sa, prev_delta))
        if depth == 0:
            alpha = jnp.where(hit.valid, 1.0, 0.0)
            first_hit_t = jnp.where(hit.valid, hit.t, first_hit_t)
            first_sp = sp
        alive = alive & hit.valid
        wo = -d
        d2p = jnp.maximum(vec.length_sq(sp.p - o), _EPS_PDF)
        cos_here = jnp.abs(vec.dot(wo, sp.n))
        if depth == 0:
            # camera area pdf of z_1 (raster density is 1 sample per unit
            # raster area; J converts to solid angle) — the fwd pdf the
            # t'=0 light-tracing alternative competes against
            if scene.camera is not None \
                    and scene.camera.kind == "perspective":
                from ..cameras import raster_jacobian
                jac = raster_jacobian(scene.camera, d)
                pdf_fwd = _to_area(jac, d2p, cos_here)
            else:
                pdf_fwd = jnp.ones((n,), jnp.float32)
        else:
            pdf_fwd = _to_area(prev_pdf_sa, d2p, cos_here)
            pdf_fwd = jnp.where(prev_delta, 0.0, pdf_fwd)
        verts.append(_Vertex(
            sp=sp, wo=wo, beta=beta, pdf_fwd=pdf_fwd,
            pdf_rev=jnp.zeros((n,), jnp.float32),
            connectible=_connectible(scene, sp) & alive,
            valid=alive, d2_prev=d2p, cos_prev=cos_here))
        # standalone light quads terminate the path (pure emitters)
        alive = alive & ~((sp.light_id >= 0) & (sp.obj_id < 0))
        if depth == max_t - 1:
            break
        u1, u2, u3, urr = jnp.moveaxis(
            sampler.rand4(pid, sid, depth, 3100), -1, 0)
        ms = B.sample_bsdf(scene, sp, wo, u1, u2, u3)
        cont = alive & ms.valid
        new_beta = beta * ms.weight
        if depth >= cfg.russian_roulette_min_bounces:
            p_surv = jnp.clip(jnp.max(new_beta, axis=-1), 0.05, 1.0)
            kill = urr > p_surv
            new_beta = new_beta / p_surv[..., None]
            cont = cont & ~kill
        # reverse pdf of z_{depth-1} given the new outgoing direction
        if depth > 0:
            _, rev_sa = B.eval_bsdf(scene, sp, ms.wi, wo)
            pv = verts[depth - 1]
            rev_area = _to_area(rev_sa, d2p, jnp.abs(vec.dot(wo, pv.sp.n)))
            verts[depth - 1].pdf_rev = jnp.where(cont, rev_area,
                                                 verts[depth - 1].pdf_rev)
        beta = jnp.where(cont[..., None], new_beta, beta)
        alive = cont
        prev_prim = sp.prim
        prev_pdf_sa = ms.pdf
        prev_delta = ms.is_delta
        o = sp.p + ms.wi * scene.shadow_bias[..., None]
        d = ms.wi
    return verts, escapes, alpha, first_hit_t, first_sp


def _walk_light(scene, cfg, pid, sid, max_s: int, lane_valid=None):
    """Generate light subpath: origin y_0 + surface vertices y_1..; returns
    (_LightOrigin, list of _Vertex for y_1..). `lane_valid` masks lanes that
    must not trace a light subpath (padding lanes of a compacted adaptive
    pass — they duplicate another lane's pixel_id and would otherwise splat
    correlated duplicates into the film)."""
    nl = max(scene.lights.num_lights, 1)
    org = _emit_origin(scene, pid, sid)
    n = org.p.shape[0]
    if lane_valid is not None:
        org.valid = org.valid & lane_valid
    org.pdf_rev = jnp.zeros((n,), jnp.float32)
    pick = 1.0 / nl
    le0 = _emit_radiance_toward(scene, org, org.d0)
    cos0 = jnp.where(org.has_normal,
                     jnp.abs(vec.dot(org.d0, org.nrm)), 1.0)
    beta = le0 * (cos0 / jnp.maximum(org.pdf_pos * pick * org.pdf_dir,
                                     _EPS_PDF))[..., None]
    alive = org.valid & (jnp.max(le0, axis=-1) > 0.0)
    o = org.p + org.d0 * scene.shadow_bias[..., None]
    d = org.d0
    prev_prim = jnp.full((n,), -1, jnp.int32)
    prev_pdf_sa = org.pdf_dir
    prev_delta = jnp.zeros((n,), bool)
    verts: List[_Vertex] = []
    prev_p = org.p
    for depth in range(max_s):
        hit = I.closest_hit(scene, o, d, scene.ray_min_dist, 1e30,
                            exclude_prim=prev_prim)
        hit = hit.replace(valid=hit.valid & alive)
        sp = S.make_surface(scene, hit, o, d)
        sp = bump_normal(scene, sp)
        alive = alive & hit.valid
        wo = -d
        d2p = jnp.maximum(vec.length_sq(sp.p - prev_p), _EPS_PDF)
        cos_here = jnp.abs(vec.dot(wo, sp.n))
        pdf_fwd = _to_area(prev_pdf_sa, d2p, cos_here)
        pdf_fwd = jnp.where(prev_delta, 0.0, pdf_fwd)
        verts.append(_Vertex(
            sp=sp, wo=wo, beta=beta, pdf_fwd=pdf_fwd,
            pdf_rev=jnp.zeros((n,), jnp.float32),
            connectible=_connectible(scene, sp) & alive,
            valid=alive, d2_prev=d2p, cos_prev=cos_here))
        if depth == max_s - 1:
            break
        u1, u2, u3, urr = jnp.moveaxis(
            sampler.rand4(pid, sid, depth, 3200), -1, 0)
        ms = B.sample_bsdf(scene, sp, wo, u1, u2, u3)
        cont = alive & ms.valid
        new_beta = beta * ms.weight
        if depth >= 1:
            p_surv = jnp.clip(
                jnp.max(new_beta, -1)
                / jnp.maximum(jnp.max(beta, -1), _EPS_PDF), 0.05, 1.0)
            kill = urr > p_surv
            new_beta = new_beta / p_surv[..., None]
            cont = cont & ~kill
        _, rev_sa = B.eval_bsdf(scene, sp, ms.wi, wo)
        if depth > 0:
            pv = verts[depth - 1]
            rev_area = _to_area(rev_sa, d2p, jnp.abs(vec.dot(wo, pv.sp.n)))
            verts[depth - 1].pdf_rev = jnp.where(cont, rev_area,
                                                 verts[depth - 1].pdf_rev)
        else:
            # reverse pdf of the light ORIGIN y_0 from y_1 (needed by the
            # MIS light-side walk for s >= 3)
            cos_y0 = jnp.where(org.has_normal,
                               jnp.abs(vec.dot(wo, org.nrm)), 1.0)
            org.pdf_rev = jnp.where(cont, _to_area(rev_sa, d2p, cos_y0), 0.0)
        beta = jnp.where(cont[..., None], new_beta, beta)
        alive = cont
        prev_p = sp.p
        prev_prim = sp.prim
        prev_pdf_sa = ms.pdf
        prev_delta = ms.is_delta
        o = sp.p + ms.wi * scene.shadow_bias[..., None]
        d = ms.wi
    return org, verts


# ---------------------------------------------------------------------------
# MIS weight (power heuristic over implemented strategies)
# ---------------------------------------------------------------------------

def _mis_weight(eye: List[_Vertex], lv: List[_Vertex], org: _LightOrigin,
                pick: float, t: int, s: int,
                rev_zt: Array, rev_ztm1: Array,
                rev_ys: Array, rev_ysm1: Array,
                t0_ok=None, conn_zt=None) -> Array:
    """Power-heuristic (beta=2) MIS weight of strategy (s, t) given the
    per-connection endpoint reverse pdfs:
      rev_zt    area pdf of z_t generated from the light side
      rev_ztm1  area pdf of z_{t-1} generated from z_t (via connection dir)
      rev_ys    area pdf of y_{s-1} generated from z_t  (s >= 1; for t=0
                strategies this is the CAMERA area pdf of y_{s-1})
      rev_ysm1  area pdf of y_{s-2} generated from y_{s-1} (s >= 2)
      t0_ok     lane mask: the light-tracing strategy t'=0 (splat through
                the camera, connectPathE analogue) exists for this path
                (None = disabled; then eye[0].pdf_fwd is never consumed)

    Vertex indices are 1-based into `eye` (z_k = eye[k-1]) and 0-based into
    the light path (y_0 = org, y_k = lv[k-1]). t=0 encodes the light-tracing
    strategy itself (no surface eye vertices; eye walk empty)."""
    n = rev_ys.shape[0]
    sum_ri = jnp.zeros((n,), jnp.float32)

    def conn_eye(i):  # connectible flag of z_i (i >= 1); z_0 camera: False
        if i == t and conn_zt is not None:
            # s=0 strategies: z_t is the LIGHT vertex; as an alternative-
            # strategy endpoint it needs surface-sampleability (the light
            # side can generate it by area sampling), not BSDF lobes
            return conn_zt
        return eye[i - 1].connectible if i >= 1 else jnp.zeros((n,), bool)

    def conn_light(i):
        # y_i as a connection endpoint; y_0 is connectible even for
        # delta-POSITION lights (NEE to a point light is a valid strategy —
        # only delta-DIRECTION lights are excluded, and those never start
        # light subpaths here). The s'=0 "eye path hits the light" strategy
        # is gated separately on ~delta_pos.
        if i == 0:
            return org.valid
        return lv[i - 1].connectible

    # --- eye-side walk: strategies t' = t-1 .. 0 ---
    # stepping past z_i turns it into a light-side vertex; the hypothetical
    # strategy t'=i-1 is valid when both endpoints of its connection edge
    # (z_{i-1}, z_i) support non-delta scattering. The final step (i=1,
    # strategy t'=0) connects z_1 to the camera: eye[0].pdf_fwd holds the
    # CAMERA area pdf of z_1 and the strategy exists only when splatting
    # is enabled for the lane (t0_ok).
    ri = jnp.ones((n,), jnp.float32)
    last_i = 1 if t0_ok is not None else 2
    for i in range(t, last_i - 1, -1):
        rev = rev_zt if i == t else (
            rev_ztm1 if i == t - 1 else eye[i - 1].pdf_rev)
        fwd = eye[i - 1].pdf_fwd
        ri = ri * _remap0(rev) / _remap0(fwd)
        if i == 1:
            ok = t0_ok & conn_eye(1)
        else:
            ok = conn_eye(i - 1) & conn_eye(i)
        sum_ri = sum_ri + jnp.where(ok, ri * ri, 0.0)

    # --- light-side walk: strategies s' = s-1 .. 0 ---
    ri = jnp.ones((n,), jnp.float32)
    for i in range(s - 1, -1, -1):  # step past y_i -> strategy s' = i
        if i == s - 1:
            rev = rev_ys
        elif i == s - 2:
            rev = rev_ysm1
        elif i >= 1:
            rev = lv[i - 1].pdf_rev
        else:
            rev = org.pdf_rev
        if i == 0:
            fwd = jnp.where(org.delta_pos, 0.0, org.pdf_pos * pick)
        else:
            fwd = lv[i - 1].pdf_fwd
        ri = ri * _remap0(rev) / _remap0(fwd)
        # strategy s'=i connects the eye side to y_{i-1}; for i=0 the eye
        # path must HIT the light surface (requires non-delta light position)
        if i == 0:
            ok = ~org.delta_pos & org.valid
        else:
            ok = conn_light(i - 1) & conn_light(i)
        sum_ri = sum_ri + jnp.where(ok, ri * ri, 0.0)

    return 1.0 / (1.0 + sum_ri)


# ---------------------------------------------------------------------------
# Main entry
# ---------------------------------------------------------------------------

def integrate_bidir(scene: SceneData, cfg, ray_o: Array, ray_d: Array,
                    ray_valid: Array, pixel_id: Array, sample_idx: Array,
                    ray_time=None) -> Tuple[Array, Array, Dict[str, Array]]:
    """BDPT estimate for one wavefront of camera rays."""
    n = ray_o.shape[0]
    lt = scene.lights
    nl = max(lt.num_lights, 1)
    pick = 1.0 / nl
    max_t = cfg.bounces + 1
    max_s = max(cfg.bounces, 1)

    eye, escapes, alpha, first_hit_t, first_sp = _walk_eye(
        scene, cfg, ray_o, ray_d, ray_valid, pixel_id, sample_idx, max_t)
    if lt.num_lights > 0:
        org, lverts = _walk_light(scene, cfg, pixel_id, sample_idx, max_s,
                                  lane_valid=ray_valid)
    else:
        org, lverts = None, []

    # light-tracing splats (t=0, connectPathE analogue): perspective
    # cameras, pinhole AND lens-sampled DOF (project_lens refocuses the
    # light vertex through a sampled thin-lens point; the reference's
    # connectPathE has no pinhole restriction either,
    # integrator_bidirectional.h:57-58)
    do_splat = (org is not None and scene.camera is not None
                and scene.camera.kind == "perspective")
    t0_ok = None
    if do_splat:
        t0_ok = jnp.ones((n,), bool)

    radiance = jnp.zeros((n, 3), jnp.float32)

    # ---- background strategies (same 2-way MIS as the forward tracer) ----
    for depth, (escaped, beta_e, d_e, prev_pdf_sa, prev_delta) in \
            enumerate(escapes):
        bg_rad = eval_background(scene, d_e)
        bg_mis = jnp.ones((n,), jnp.float32)
        if lt.bg_light_idx >= 0:
            bpdf = L.background_pdf(scene, d_e)
            bg_mis = jnp.where(prev_delta, 1.0,
                               vec.power_heuristic(prev_pdf_sa, bpdf))
        add = (depth > 0) or not cfg.transp_background
        if add:
            radiance = radiance + jnp.where(
                escaped[..., None], beta_e * bg_rad * bg_mis[..., None], 0.0)

    # ---- s = 0: eye path hits an intersectable light ----
    for t in range(1, len(eye) + 1):
        z = eye[t - 1]
        sp = z.sp
        li = jnp.maximum(sp.light_id, 0)
        emit = common.emitted_radiance(scene, sp, z.wo)
        sampleable = (sp.light_id >= 0) & (
            _light_pdf_pos_hit(scene, li) > 0.0)
        if org is None or (t == 1 and t0_ok is None):
            # without light subpaths (or without the t'=0 splat strategy
            # for t=1) the emission hit is the only generator of this path
            w = jnp.ones((n,), jnp.float32)
        else:
            # endpoint reverse pdfs for the hypothetical light-side sampling
            rev_zt = _light_pdf_pos_hit(scene, li) * pick
            if t >= 2:
                # emission direction pdf from the light point toward z_{t-1}
                cos_l = jnp.abs(vec.dot(z.wo, sp.ng))
                pdf_dir_l = jnp.maximum(cos_l, 1e-9) / jnp.pi
                rev_ztm1 = _to_area(pdf_dir_l, z.d2_prev,
                                    jnp.abs(vec.dot(z.wo, eye[t - 2].sp.n)))
            else:
                rev_ztm1 = jnp.zeros((n,), jnp.float32)
            w = _mis_weight(eye, lverts, org, pick, t, 0,
                            rev_zt, rev_ztm1,
                            jnp.zeros((n,)), jnp.zeros((n,)), t0_ok=t0_ok,
                            conn_zt=sampleable)
        # material emission (no light id) keeps weight 1
        w = jnp.where(sp.light_id >= 0, w, 1.0)
        has_emit = z.valid & (jnp.max(emit, -1) > 0)
        radiance = radiance + jnp.where(has_emit[..., None],
                                        z.beta * emit * w[..., None], 0.0)

    # ---- NEE for non-positional lights (weight 1 / dirac) ----
    nonpos = ((lt.light_type == LIGHT_SUN)
              | (lt.light_type == LIGHT_DIRECTIONAL))
    for t in range(1, len(eye) + 1):
        z = eye[t - 1]
        for li_s in range(lt.num_lights):
            u1, u2 = sampler.rand2(pixel_id, sample_idx, t, 3300 + 2 * li_s)
            li_a = jnp.full((n,), li_s, jnp.int32)
            c = common.estimate_one_light(scene, z.sp, z.wo, li_a, u1, u2,
                                          cfg.transparent_shadows)
            m = z.valid & z.connectible & nonpos[li_s]
            radiance = radiance + jnp.where(m[..., None], z.beta * c, 0.0)
        # background NEE (bg light in the table samples the env map)
        if lt.bg_light_idx >= 0:
            u1, u2 = sampler.rand2(pixel_id, sample_idx, t, 3400)
            li_a = jnp.full((n,), lt.bg_light_idx, jnp.int32)
            c = common.estimate_one_light(scene, z.sp, z.wo, li_a, u1, u2,
                                          cfg.transparent_shadows)
            m = z.valid & z.connectible
            radiance = radiance + jnp.where(m[..., None], z.beta * c, 0.0)

    # ---- (s >= 1, t >= 1) connections ----
    if org is not None:
        for t in range(1, len(eye) + 1):
            z = eye[t - 1]
            for s in range(1, max_s + 1):
                if s == 1:
                    y_p = org.p
                    y_valid = org.valid
                    y_conn = jnp.ones((n,), bool)  # y_0 always connectible
                                                   # as NEE target
                else:
                    y = lverts[s - 2]
                    y_p = y.sp.p
                    y_valid = y.valid
                    y_conn = y.connectible
                to_y = y_p - z.sp.p
                d2 = jnp.maximum(vec.length_sq(to_y), _EPS_PDF)
                dist = jnp.sqrt(d2)
                wi = to_y / dist[..., None]
                cos_z = jnp.abs(vec.dot(wi, z.sp.n))
                f_z, pdf_z_sa = B.eval_bsdf(scene, z.sp, z.wo, wi)
                if s == 1:
                    le = _emit_radiance_toward(scene, org, -wi)
                    cos_y = jnp.where(org.has_normal,
                                      jnp.abs(vec.dot(-wi, org.nrm)), 1.0)
                    fy_beta = le / jnp.maximum(org.pdf_pos * pick,
                                               _EPS_PDF)[..., None]
                    # reverse-pdf bookkeeping: y_0 sampled from z_t by BSDF
                    rev_ys = _to_area(pdf_z_sa, d2, cos_y)
                    rev_ys = jnp.where(org.delta_pos, 0.0, rev_ys)
                    # z_t from y_0: light emission direction pdf
                    pdf_emit_dir = jnp.where(
                        org.has_normal, jnp.maximum(cos_y, 1e-9) / jnp.pi,
                        jnp.where(lt.light_type[org.li] == LIGHT_SPOT,
                                  1.0 / jnp.maximum(
                                      2.0 * jnp.pi
                                      * (1.0 - lt.cos_end[org.li]), 1e-9),
                                  1.0 / (4.0 * jnp.pi)))
                    rev_zt = _to_area(pdf_emit_dir, d2, cos_z)
                    rev_ysm1 = jnp.zeros((n,), jnp.float32)
                    f_y_cos = cos_y
                    y_n_ok = jnp.where(
                        org.has_normal & ~((lt.flags[org.li]
                                            & L.FLAG_DOUBLE_SIDED) != 0),
                        vec.dot(-wi, org.nrm) > 1e-6, True)
                else:
                    y = lverts[s - 2]
                    f_y, pdf_y_sa = B.eval_bsdf(scene, y.sp, y.wo, -wi)
                    fy_beta = y.beta * f_y
                    cos_y = jnp.abs(vec.dot(-wi, y.sp.n))
                    rev_ys = _to_area(pdf_z_sa, d2, cos_y)
                    rev_zt = _to_area(pdf_y_sa, d2, cos_z)
                    # y_{s-2} from y_{s-1} through the connection direction
                    _, rev_sa_y = B.eval_bsdf(scene, y.sp, -wi, y.wo)
                    if s == 2:
                        rev_ysm1 = _to_area(
                            rev_sa_y, y.d2_prev,
                            jnp.where(org.has_normal,
                                      jnp.abs(vec.dot(y.wo, org.nrm)), 1.0))
                    else:
                        rev_ysm1 = _to_area(
                            rev_sa_y, y.d2_prev,
                            jnp.abs(vec.dot(y.wo, lverts[s - 3].sp.n)))
                    f_y_cos = cos_y
                    y_n_ok = jnp.ones((n,), bool)
                # z_{t-1} from z_t through the connection direction
                _, rev_sa_z = B.eval_bsdf(scene, z.sp, wi, z.wo)
                if t >= 2:
                    rev_ztm1 = _to_area(rev_sa_z, z.d2_prev,
                                        jnp.abs(vec.dot(z.wo,
                                                        eye[t - 2].sp.n)))
                else:
                    rev_ztm1 = jnp.zeros((n,), jnp.float32)

                contrib_scale = (cos_z * f_y_cos / d2)
                partial = (z.beta * f_z * fy_beta
                           * contrib_scale[..., None])
                potential = (z.valid & z.connectible & y_valid & y_conn
                             & y_n_ok & (jnp.max(partial, -1) > 0.0))
                tr = common.trace_shadow(scene, z.sp.p, z.sp.prim, wi, dist,
                                         cfg.transparent_shadows,
                                         needed=potential)
                w = _mis_weight(eye, lverts, org, pick, t, s,
                                rev_zt, rev_ztm1, rev_ys, rev_ysm1,
                                t0_ok=t0_ok)
                radiance = radiance + jnp.where(
                    potential[..., None], partial * tr * w[..., None], 0.0)

    # ---- t = 0: light-tracing splats through the camera (connectPathE,
    #      include/integrator/surface/integrator_bidirectional.h:57-58) ----
    splat_px = splat_py = splat_rgb = None
    if do_splat:
        from ..cameras import project_lens, raster_jacobian
        cam = scene.camera
        sp_px, sp_py, sp_rgb = [], [], []
        for s in range(1, max_s + 1):
            if s == 1:
                y_p = org.p
                y_prim = jnp.full((n,), -1, jnp.int32)
                # direct light->camera splat: sampled-surface lights only
                y_ok = org.valid & ~org.delta_pos & org.has_normal
            else:
                y = lverts[s - 2]
                y_p = y.sp.p
                y_prim = y.sp.prim
                y_ok = y.valid & y.connectible
            # fresh lens sample per (lane, s): the pinhole case degenerates
            # to the camera origin inside project_lens
            lu, lv = sampler.rand2(pixel_id, sample_idx, s, 3500)
            pxs, pys, vis, lpt = project_lens(cam, y_p, lu, lv)
            to_c = lpt - y_p
            d2 = jnp.maximum(vec.length_sq(to_c), _EPS_PDF)
            dist = jnp.sqrt(d2)
            wi = to_c / dist[..., None]
            jac = raster_jacobian(cam, -wi)
            if s == 1:
                cos_y = vec.dot(wi, org.nrm)
                dbl = (lt.flags[org.li] & L.FLAG_DOUBLE_SIDED) != 0
                y_ok = y_ok & ((cos_y > 1e-6) | dbl)
                cos_y = jnp.abs(cos_y)
                le = _emit_radiance_toward(scene, org, wi)
                beta_f = le / jnp.maximum(org.pdf_pos * pick,
                                          _EPS_PDF)[..., None]
                rev_ysm1 = jnp.zeros((n,), jnp.float32)
            else:
                y = lverts[s - 2]
                f_y, _ = B.eval_bsdf(scene, y.sp, y.wo, wi)
                beta_f = y.beta * f_y
                cos_y = jnp.abs(vec.dot(wi, y.sp.n))
                # y_{s-2} regenerated from y_{s-1} with camera-side incoming
                _, rev_sa_y = B.eval_bsdf(scene, y.sp, wi, y.wo)
                if s == 2:
                    rev_ysm1 = _to_area(
                        rev_sa_y, y.d2_prev,
                        jnp.where(org.has_normal,
                                  jnp.abs(vec.dot(y.wo, org.nrm)), 1.0))
                else:
                    rev_ysm1 = _to_area(rev_sa_y, y.d2_prev,
                                        jnp.abs(vec.dot(y.wo,
                                                        lverts[s - 3].sp.n)))
            # camera area pdf of y_{s-1} (the competing forward strategy)
            rev_ys = _to_area(jac, d2, cos_y)
            contrib = beta_f * (cos_y / d2 * jac)[..., None]
            potential = (y_ok & vis & t0_ok
                         & (jnp.max(contrib, -1) > 0.0))
            tr = common.trace_shadow(scene, y_p, y_prim, wi, dist,
                                     cfg.transparent_shadows,
                                     needed=potential)
            w = _mis_weight(eye, lverts, org, pick, 0, s,
                            jnp.zeros((n,)), jnp.zeros((n,)),
                            rev_ys, rev_ysm1, t0_ok=t0_ok)
            val = jnp.where(potential[..., None], contrib * tr
                            * w[..., None], 0.0)
            sp_px.append(pxs)
            sp_py.append(pys)
            sp_rgb.append(val)
        splat_px = jnp.concatenate(sp_px)
        splat_py = jnp.concatenate(sp_py)
        splat_rgb = jnp.concatenate(sp_rgb)

    # ---- AOVs + volumes (same wrap-up as the forward tracer) ----
    from .mc import _first_hit_layers
    aux = _first_hit_layers(scene, cfg, first_sp, ray_d) if first_sp is not \
        None else {}
    if splat_px is not None:
        aux["splat_px"] = splat_px
        aux["splat_py"] = splat_py
        aux["splat_rgb"] = splat_rgb
    if (scene.volumes is not None or cfg.vol_kind == "sky") \
            and cfg.vol_kind != "none":
        from .volume import apply_volumetric
        radiance = apply_volumetric(scene, cfg, radiance, ray_o, ray_d,
                                    first_hit_t, pixel_id, sample_idx)
    return radiance, jnp.clip(alpha, 0.0, 1.0), aux
