"""Shared integrator machinery: shadow rays, direct-light MIS estimation.

Replaces the reference MonteCarloIntegrator's estimateAllDirectLight /
doLightEstimation (src/integrator/surface/integrator_montecarlo.cc:54-405):
light-sample and BSDF-sample MIS with the power-2 heuristic
(integrator_montecarlo.cc:227-230, :341-344), Dirac lights, and
transparent-shadow filtering (Accelerator::intersectTs analogue).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..materials import bsdf as B
from ..math import vec
from ..ops import intersect as I
from ..ops import surface as S
from .. import scene_types as ST
from ..scene_types import SceneData
from .. import lights as L
from .. import sampler

Array = jax.Array


def trace_shadow(scene: SceneData, p: Array, prim: Array, wi: Array,
                 dist: Array, transparent_depth: int = 0,
                 time=None, needed: Array | None = None) -> Array:
    """Shadow transmittance in [0,1]^3 along (p -> p + wi*dist).

    transparent_depth = 0: binary visibility (intersectS analogue).
    transparent_depth > 0: walk up to that many transparent surfaces,
    multiplying their filter colors (intersectTs analogue,
    src/accelerator/accelerator.cc:69-94).

    `needed` (optional bool [N]): rays where the result is irrelevant
    (dead path / zero BSDF / non-shadow-casting light) get an EMPTY
    t-range, which the block accelerator clusters into zero-candidate
    tiles — the traversal then skips them at ~zero cost."""
    bias = scene.shadow_bias
    o = p + wi * bias[..., None]
    t_max = jnp.where(jnp.isinf(dist), 1e30, dist - 2.0 * bias)
    if needed is not None:
        t_max = jnp.where(needed, t_max, -1.0)
    if transparent_depth == 0:
        blocked = I.any_hit(scene, o, wi, 0.0, t_max, exclude_prim=prim,
                            time=time)
        return jnp.where(blocked[..., None], 0.0, 1.0)
    filt = jnp.ones(p.shape, jnp.float32)
    cur_o = o
    cur_prim = prim
    cur_tmax = t_max
    for _ in range(transparent_depth + 1):
        hit = I.shadow_hit_surface(scene, cur_o, wi, 0.0, cur_tmax,
                                   exclude_prim=cur_prim)
        sp = S.make_surface(scene, hit, cur_o, wi)
        tr = B.transparency(scene, sp, -wi)
        opaque = hit.valid & (jnp.max(tr, axis=-1) <= 0.0)
        filt = jnp.where(opaque[..., None], 0.0,
                         jnp.where(hit.valid[..., None], filt * tr, filt))
        # advance past the transparent hit
        adv = hit.t + 2.0 * bias
        cur_o = jnp.where(hit.valid[..., None], cur_o + wi * adv[..., None], cur_o)
        cur_tmax = jnp.where(hit.valid, cur_tmax - adv, cur_tmax)
        cur_prim = jnp.where(hit.valid, hit.prim, cur_prim)
    return filt


def estimate_one_light(scene: SceneData, sp, wo: Array, li: Array,
                       u1: Array, u2: Array,
                       transparent_shadows: int = 0,
                       pick_pdf: Array | float = 1.0,
                       time=None, with_shadow_info: bool = False,
                       with_family_split: bool = False):
    """One-sample NEE toward light index `li` with MIS against BSDF sampling
    (areaLightSampleLight analogue). Returns radiance contribution [N,3];
    with_shadow_info additionally returns the UNSHADOWED contribution (the
    reference's shadow layer accumulates col_shadow = unoccluded - occluded
    during doLightEstimation); with_family_split additionally returns a dict
    of per-BSDF-family and per-estimation-technique contributions for the
    adv-* / debug-light-estimation-* AOV layers."""
    ls = L.sample_light(scene, li, sp.p, sp.n, u1, u2)
    cos_s = vec.dot(ls.wi, sp.n)
    # allow transmission through for translucent/transmissive materials:
    # eval_bsdf returns 0 where the lobe doesn't exist, so no explicit cull
    if with_family_split:
        f, bsdf_pdf, fam_f = B.eval_bsdf(scene, sp, wo, ls.wi, split=True)
    else:
        f, bsdf_pdf = B.eval_bsdf(scene, sp, wo, ls.wi)
    potential = ls.valid & sp.valid & (jnp.max(f, axis=-1) > 0.0)
    shadow_needed = potential & ((scene.lights.flags[li] & L.FLAG_CAST_SHADOWS) != 0)
    tr = trace_shadow(scene, sp.p, sp.prim, ls.wi, ls.dist,
                      transparent_shadows, time=time, needed=shadow_needed)
    no_shadow_test = potential & ~shadow_needed
    tr = jnp.where(no_shadow_test[..., None], 1.0, tr)
    mis_w = jnp.where(ls.is_dirac, 1.0,
                      vec.power_heuristic(ls.pdf * pick_pdf, bsdf_pdf))
    k = (ls.radiance
         * (jnp.abs(cos_s) * mis_w / (ls.pdf * pick_pdf))[..., None])
    base = f * k
    contrib = jnp.where(potential[..., None], base * tr, 0.0)
    if with_family_split:
        pot = potential[..., None]
        fam = {name: jnp.where(pot, fam_f[name] * k * tr, 0.0)
               for name in fam_f}
        fam["diffuse-noshadow"] = jnp.where(pot, fam_f["diffuse"] * k, 0.0)
        dirac = ls.is_dirac[..., None]
        fam["light-dirac"] = jnp.where(dirac, contrib, 0.0)
        fam["light-sampling"] = jnp.where(dirac, 0.0, contrib)
        if with_shadow_info:
            return contrib, jnp.where(pot, base, 0.0), fam
        return contrib, fam
    if with_shadow_info:
        return contrib, jnp.where(potential[..., None], base, 0.0)
    return contrib


def emitted_radiance(scene: SceneData, sp, wo: Array) -> Array:
    """Radiance emitted toward wo at a hit: light-table radiance when the
    primitive belongs to an intersectable light, else material emission."""
    from_light = sp.light_id >= 0
    li = jnp.maximum(sp.light_id, 0)
    lt = scene.lights
    front = vec.dot(wo, sp.ng) > 0.0
    dbl = (lt.flags[li] & L.FLAG_DOUBLE_SIDED) != 0
    light_rad = jnp.where((front | dbl)[..., None], lt.color[li], 0.0)
    if L._has(lt, ST.LIGHT_BGPORTAL):
        # a BSDF ray hitting a portal face sees the environment behind it
        # times the portal power, front side only
        # (light_background_portal.cc BackgroundPortalLight::intersect)
        from .. import backgrounds as BG
        m_port = lt.light_type[li] == ST.LIGHT_BGPORTAL
        bg_rad = BG.eval_background(scene, -wo) * lt.color[li]
        light_rad = jnp.where(m_port[..., None],
                              jnp.where(front[..., None], bg_rad, 0.0),
                              light_rad)
    mat_emit = B.emit(scene, sp, wo)
    return jnp.where(from_light[..., None], light_rad, mat_emit)


def hit_light_mis_weight(scene: SceneData, sp, prev_p: Array,
                         bsdf_pdf: Array, prev_delta: Array,
                         pick_pdf: Array | float = 1.0) -> Array:
    """MIS weight for BSDF-sampled rays that hit an intersectable light
    (areaLightSampleMaterial analogue). Delta bounces get weight 1."""
    from_light = sp.light_id >= 0
    li = jnp.maximum(sp.light_id, 0)
    lpdf = L.light_pdf_hit(scene, li, sp.p, sp.ng, prev_p) * pick_pdf
    w = vec.power_heuristic(bsdf_pdf, lpdf)
    w = jnp.where(prev_delta, 1.0, w)
    return jnp.where(from_light, w, 1.0)
