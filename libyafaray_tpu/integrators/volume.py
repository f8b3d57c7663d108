"""Volume integrators: emission / single-scatter / sky, wavefront-wide.

Replaces src/integrator/volume/* (EmissionIntegrator integrator_emission.cc,
SingleScatterIntegrator integrator_single_scatter.cc, SkyIntegrator
integrator_sky.cc). The reference ray-marches each camera ray with a
per-ray adaptive step; here the march is a fixed-step lax-unrolled loop over
the whole wavefront (static step count, masked segment bounds) — identical
estimator, wavefront-shaped control flow. Applied by the surface integrator like
the reference's applyVolumetricEffects (integrator_tiled.cc:694):
    L = transmittance(segment) * L_surface + L_volume(segment).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import lights as L
from .. import sampler
from ..math import vec
from ..scene_types import SceneData
from ..volumes import ray_aabb_span, sigma_st

Array = jax.Array

DEFAULT_STEPS = 16


def _segment(scene: SceneData, o: Array, d: Array, t_hit: Array):
    """Clip [0, t_hit] to the union volume AABB span."""
    hit, t0, t1 = ray_aabb_span(scene, o, d, t_hit)
    t0 = jnp.where(hit, t0, 0.0)
    t1 = jnp.where(hit, t1, 0.0)
    return t0, jnp.maximum(t1, t0)


def transmittance(scene: SceneData, o: Array, d: Array, t_hit: Array,
                  steps: int = DEFAULT_STEPS) -> Array:
    """exp(-tau) over the volume segment of each ray
    (DensityVolumeRegion::tau numeric integration, volume.h:57-132)."""
    if scene.volumes is None or scene.volumes.num_volumes == 0:
        return jnp.ones(o.shape, jnp.float32)
    t0, t1 = _segment(scene, o, d, t_hit)
    dt = (t1 - t0) / steps
    tau = jnp.zeros_like(o)
    for s in range(steps):
        tm = t0 + (s + 0.5) * dt
        p = o + d * tm[..., None]
        _, st, _ = sigma_st(scene, p)
        tau = tau + st * dt[..., None]
    return jnp.exp(-tau)


def _hg_phase(cos_t: Array, g: Array) -> Array:
    """Henyey-Greenstein phase function."""
    g2 = g * g
    denom = jnp.power(jnp.maximum(1.0 + g2 - 2.0 * g * cos_t, 1e-6), 1.5)
    return (1.0 - g2) / (4.0 * jnp.pi * denom)


def in_scatter(scene: SceneData, o: Array, d: Array, t_hit: Array,
               pixel_id: Array, sample_idx: Array,
               steps: int = DEFAULT_STEPS,
               transparent_shadows: int = 0,
               substeps: int = 1) -> Array:
    """Single-scattering + emission estimate along the segment
    (SingleScatterIntegrator::integrate, integrator_single_scatter.cc).
    One light sample per march step (uniform light pick), shadowed through
    scene geometry.

    `substeps > 1` is the wavefront-shaped equivalent of the reference's
    adaptive marching (integrator_single_scatter.cc:303-334, param
    "adaptive"): the reference marches coarse steps where accumulated
    density is flat and refines to fine steps where it varies — fewer
    EXPENSIVE in-scatter (shadow-ray) evaluations per unit accuracy. A
    per-lane variable step count would leave SIMD lanes idle, so here
    every coarse step integrates tau and emission over `substeps` CHEAP
    density probes (exact where the reference's coarse step would smear)
    and places its single expensive light sample at the
    scattering-density-weighted centroid of the step instead of its
    midpoint — the same cost profile (in-scatter evals at coarse
    resolution, density at fine resolution) with zero divergence."""
    if scene.volumes is None or scene.volumes.num_volumes == 0:
        return jnp.zeros(o.shape, jnp.float32)
    from . import common
    num_lights = scene.lights.num_lights
    t0, t1 = _segment(scene, o, d, t_hit)
    dt = (t1 - t0) / steps
    acc = jnp.zeros_like(o)
    tau = jnp.zeros_like(o)
    n = o.shape[0]
    g_mean = (scene.volumes.g.mean() if scene.volumes.num_volumes > 0
              else jnp.float32(0.0))
    for s in range(steps):
        if substeps > 1:
            # fine pass: tau, emission AND the transmittance-weighted
            # sigma_s integral at substep resolution; the single expensive
            # light sample goes to the sigma_s-weighted centroid. With L
            # locally constant the step contribution
            #   sum_k exp(-tau_k) ss_k L fdt  ==  tr(start) * ssw_acc * L
            # matches the fine march exactly — the substeps buy exact
            # density integration, the coarse step buys one shadow ray.
            fdt = dt / substeps
            st_acc = jnp.zeros_like(o)
            em_acc = jnp.zeros_like(o)
            ssw_acc = jnp.zeros_like(o)
            w_sum = jnp.zeros((n,), jnp.float32)
            tw_sum = jnp.zeros((n,), jnp.float32)
            tau_rel = jnp.zeros_like(o)   # tau within the step so far
            for k in range(substeps):
                tk = t0 + (s + (k + 0.5) / substeps) * dt
                pk = o + d * tk[..., None]
                ssk, stk, emk = sigma_st(scene, pk)
                em_acc = em_acc + (jnp.exp(-(tau + tau_rel)) * emk
                                   * fdt[..., None])
                ssw_acc = ssw_acc + (jnp.exp(-tau_rel) * ssk
                                     * fdt[..., None])
                tau_rel = tau_rel + stk * fdt[..., None]
                st_acc = st_acc + stk * fdt[..., None]
                wk = jnp.max(ssk, axis=-1)
                w_sum = w_sum + wk
                tw_sum = tw_sum + wk * tk
            tm = jnp.where(w_sum > 0, tw_sum / jnp.maximum(w_sum, 1e-12),
                           t0 + (s + 0.5) * dt)
            p = o + d * tm[..., None]
            tr = jnp.exp(-tau)
            acc = acc + em_acc
            # downstream uses contrib = ss * ... * dt: fold the fine
            # integral in so tr*ss*dt == tr(start) * ssw_acc
            ss = ssw_acc / jnp.maximum(dt, 1e-12)[..., None]
            # the step's tau increment comes from the fine integration
            st = st_acc / jnp.maximum(dt, 1e-12)[..., None]
        else:
            tm = t0 + (s + 0.5) * dt
            p = o + d * tm[..., None]
            ss, st, em = sigma_st(scene, p)
            tr = jnp.exp(-tau)
            # emission (EmissionIntegrator::integrate)
            acc = acc + tr * em * dt[..., None]
        if num_lights > 0:
            ul, u1, u2, _ = jnp.moveaxis(
                sampler.rand4(pixel_id, sample_idx, 40 + s, 5), -1, 0)
            li = jnp.clip((ul * num_lights).astype(jnp.int32), 0,
                          num_lights - 1)
            ls = L.sample_light(scene, li, p,
                                jnp.zeros_like(p).at[..., 2].set(1.0), u1, u2)
            # shadow from the march point
            shadow_o = p
            prim = jnp.full((n,), -1, jnp.int32)
            vis = common.trace_shadow(scene, shadow_o, prim, ls.wi, ls.dist,
                                      transparent_shadows)
            # medium attenuation toward the light: cached grid ("optimize")
            # or direct march (integrator_single_scatter.cc:35-108)
            if scene.vol_atten is not None:
                vis = vis * lookup_attenuation(scene.vol_atten, p, li)
            else:
                lp = p + ls.wi * jnp.minimum(ls.dist, 1e6)[..., None]
                vis = vis * jnp.exp(-light_tau(scene, p, lp))
            phase = _hg_phase(vec.dot(d, ls.wi), g_mean)
            contrib = (ss * ls.radiance * vis
                       * (phase / jnp.maximum(ls.pdf, 1e-9)
                          * num_lights)[..., None])
            acc = acc + tr * jnp.where(ls.valid[..., None], contrib, 0.0) \
                * dt[..., None]
        tau = tau + st * dt[..., None]
    return acc


# ---------------------------------------------------------------------------
# Per-light attenuation grid (SingleScatterIntegrator "optimize" mode,
# integrator_single_scatter.cc:35-108): a G^3 grid over the volume AABB
# caching, per light, the medium transmittance from each cell toward the
# light. Replaces an inner march per (step, light) with one trilinear
# lookup. Stored in SceneData.vol_atten by the render() preprocess.
# ---------------------------------------------------------------------------

ATTEN_GRID = 36          # reference grid resolution (att_grid_*=36)
ATTEN_MARCH_STEPS = 16


def light_tau(scene: SceneData, p: Array, light_pos: Array,
              steps: int = ATTEN_MARCH_STEPS) -> Array:
    """Optical depth of the medium from points p toward light positions
    (clipped to the volume AABB)."""
    delta = light_pos - p
    dist = jnp.linalg.norm(delta, axis=-1)
    d = delta / jnp.maximum(dist, 1e-9)[..., None]
    _, t0, t1 = ray_aabb_span(scene, p, d, dist)
    dt = jnp.maximum(t1 - t0, 0.0) / steps
    tau = jnp.zeros_like(p)
    for s in range(steps):
        q = p + d * (t0 + (s + 0.5) * dt)[..., None]
        _, st, _ = sigma_st(scene, q)
        tau = tau + st * dt[..., None]
    return tau


def build_attenuation_grid(scene: SceneData, grid: int = ATTEN_GRID):
    """Precompute exp(-tau) from every grid cell center to every light.
    Returns (atten[L, G, G, G, 3], bmin[3], bmax[3])."""
    vt = scene.volumes
    bmin = jnp.min(vt.bmin, axis=0)
    bmax = jnp.max(vt.bmax, axis=0)
    cs = jnp.linspace(0.5 / grid, 1.0 - 0.5 / grid, grid)
    zz, yy, xx = jnp.meshgrid(cs, cs, cs, indexing="ij")
    pts = bmin + jnp.stack([xx, yy, zz], -1).reshape(-1, 3) * (bmax - bmin)

    def per_light(lpos):
        tau = light_tau(scene, pts, jnp.broadcast_to(lpos, pts.shape))
        return jnp.exp(-tau).reshape(grid, grid, grid, 3)

    atten = jax.vmap(per_light)(scene.lights.position)
    return atten, bmin, bmax


def lookup_attenuation(vol_atten, p: Array, li: Array) -> Array:
    """Trilinear fetch of the per-light attenuation at points p."""
    atten, bmin, bmax = vol_atten
    g = atten.shape[1]
    rel = jnp.clip((p - bmin) / jnp.maximum(bmax - bmin, 1e-9), 0.0, 1.0)
    f = rel * g - 0.5
    i0 = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, g - 1)
    i1 = jnp.minimum(i0 + 1, g - 1)
    w = jnp.clip(f - i0, 0.0, 1.0)
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix = i1[..., 0] if dx else i0[..., 0]
                iy = i1[..., 1] if dy else i0[..., 1]
                iz = i1[..., 2] if dz else i0[..., 2]
                wx = w[..., 0] if dx else 1.0 - w[..., 0]
                wy = w[..., 1] if dy else 1.0 - w[..., 1]
                wz = w[..., 2] if dz else 1.0 - w[..., 2]
                out = out + (wx * wy * wz)[..., None] * atten[li, iz, iy, ix]
    return out


# ---------------------------------------------------------------------------
# Sky integrator: Rayleigh + Mie atmospheric scattering along the camera ray
# (reference SkyIntegrator, integrator_sky.cc:30-196). Needs no VolumeRegion:
# the medium is the analytic exponential atmosphere; in-scattered light is
# the scene background sampled over 24 fixed directions.
# ---------------------------------------------------------------------------

# Mie angular scattering lookup (integrator_sky.cc:175-196 piecewise lerp)
_MIE_DEG = np.array([0.0, 1.0, 4.0, 7.0, 10.0, 30.0, 60.0, 80.0, 180.0])
_MIE_VAL = np.array([4.192, 4.192, 3.311, 2.860, 2.518, 1.122,
                      0.3324, 0.1644, 0.1])


def sky_coeffs(alpha: float, turbidity: float):
    """Rayleigh/Mie extinction coefficients (integrator_sky.cc:38-58)."""
    import math as m
    alpha_r = 0.1136 * alpha
    alpha_m = 0.8333 * alpha
    n_mol, n_ref, p_n, lam = 2.545e25, 1.0003, 0.035, 500e-9
    b_r = (8 * m.pi ** 3 * (n_ref ** 2 - 1) ** 2
           / (3 * n_mol * lam ** 4) * (6 + 3 * p_n) / (6 - 7 * p_n))
    c = (0.6544 * turbidity - 0.651) * 1e-16
    v, k = 4.0, 0.67
    b_m = 0.434 * c * m.pi * (2 * m.pi / lam) ** (v - 2) * k * 0.01
    return alpha_r, alpha_m, b_r, b_m


def _sky_tau(beta, alpha, scale, o, d, t):
    """Closed-form optical depth of the exponential atmosphere
    (SkyIntegrator::skyTau, integrator_sky.cc:96-104)."""
    s = t * scale
    cos_t = d[..., 2]
    h0 = o[..., 2] * scale
    denom = jnp.where(jnp.abs(alpha * cos_t) < 1e-9, 1e-9, alpha * cos_t)
    tau = beta * jnp.exp(-alpha * h0) * (1.0 - jnp.exp(-alpha * cos_t * s)) \
        / denom
    return jnp.where(t > 0, jnp.maximum(tau, 0.0), 0.0)


def sky_transmittance(cfg, o: Array, d: Array, t_hit: Array) -> Array:
    alpha_r, alpha_m, b_r, b_m = sky_coeffs(cfg.sky_alpha, cfg.sky_turbidity)
    sc = cfg.sky_scale
    t = jnp.where(t_hit > 0, t_hit, 1000.0)
    tau = _sky_tau(b_m, alpha_m, sc, o, d, t) \
        + _sky_tau(b_r, alpha_r, sc, o, d, t)
    return jnp.exp(-tau)[..., None] * jnp.ones(3)


def sky_in_scatter(scene: SceneData, cfg, o: Array, d: Array, t_hit: Array,
                   pixel_id: Array, sample_idx: Array,
                   steps: int = DEFAULT_STEPS) -> Array:
    """Rayleigh+Mie single scattering march (integrator_sky.cc:115-173):
    source term S0 from 24 fixed background directions weighted by the
    Rayleigh phase / Mie angular table, then a transmittance-weighted
    march of the exponential density along the ray."""
    from ..backgrounds import eval_background
    alpha_r, alpha_m, b_r, b_m = sky_coeffs(cfg.sky_alpha, cfg.sky_turbidity)
    sc = cfg.sky_scale
    s = jnp.where(t_hit > 0, t_hit, 1000.0) * sc

    # source term: 3 zenith rings x 8 azimuths (integrator_sky.cc:118-146)
    vs = jnp.arange(3, dtype=jnp.float32)
    us = jnp.arange(8, dtype=jnp.float32)
    theta = (vs * 0.3 + 0.2)[:, None] * 0.5 * jnp.pi
    phi = us[None, :] * (2.0 * jnp.pi / 8.0)
    w = jnp.stack([jnp.sin(theta) * jnp.cos(phi),
                   jnp.sin(theta) * jnp.sin(phi),
                   jnp.cos(theta) * jnp.ones_like(phi)], -1).reshape(-1, 3)
    l_s = eval_background(scene, w)                       # [24, 3]
    cos_wd = jnp.einsum("kc,nc->nk", w, d,
                        precision=jax.lax.Precision.HIGHEST)  # [n, 24]
    b_r_ang = b_r * 3.0 / (2.0 * jnp.pi * 8.0) * (1.0 + cos_wd ** 2)
    ang_deg = jnp.degrees(jnp.arccos(jnp.clip(cos_wd, -1.0, 1.0)))
    mie = jnp.interp(ang_deg, _MIE_DEG, _MIE_VAL)
    b_m_ang = b_m / (2.0 * 0.67 * jnp.pi) * mie
    s0_r = jnp.einsum("nk,kc->nc", b_r_ang, l_s,
                      precision=jax.lax.Precision.HIGHEST) / 24.0   # [n, 3]
    s0_m = jnp.einsum("nk,kc->nc", b_m_ang, l_s,
                      precision=jax.lax.Precision.HIGHEST) / 24.0

    cos_t = d[..., 2]
    h0 = o[..., 2] * sc
    step = s / steps
    jit0 = sampler.rand1(pixel_id, sample_idx, 39, 11)
    i_r = jnp.zeros_like(s)
    i_m = jnp.zeros_like(s)
    for k in range(steps):
        pos = (k + jit0) * step
        u_r = jnp.exp(-alpha_r * (h0 + pos * cos_t))
        u_m = jnp.exp(-alpha_m * (h0 + pos * cos_t))
        tr_r = jnp.exp(-_sky_tau(b_r, alpha_r, sc, o, d, pos / sc))
        tr_m = jnp.exp(-_sky_tau(b_m, alpha_m, sc, o, d, pos / sc))
        i_r = i_r + tr_r * u_r * step
        i_m = i_m + tr_m * u_m * step
    return s0_r * i_r[..., None] + s0_m * i_m[..., None]


def apply_volumetric(scene: SceneData, cfg, radiance: Array, o: Array,
                     d: Array, t_hit: Array, pixel_id: Array,
                     sample_idx: Array, return_parts: bool = False):
    """applyVolumetricEffects analogue for the camera segment.
    return_parts=True returns (transmittance, in_scatter) instead of the
    composed radiance (for the adv-volume-* AOV layers)."""
    kind = getattr(cfg, "vol_kind", "single_scatter")
    if kind == "sky":
        tr = sky_transmittance(cfg, o, d, t_hit)
        vol = sky_in_scatter(scene, cfg, o, d, t_hit, pixel_id, sample_idx,
                             getattr(cfg, "vol_steps", DEFAULT_STEPS))
        if return_parts:
            return tr, vol
        return tr * radiance + vol
    if scene.volumes is None or scene.volumes.num_volumes == 0:
        if return_parts:
            return jnp.ones_like(radiance), jnp.zeros_like(radiance)
        return radiance
    kind = getattr(cfg, "vol_kind", "single_scatter")
    steps = getattr(cfg, "vol_steps", DEFAULT_STEPS)
    tr = transmittance(scene, o, d, t_hit, steps)
    if kind == "emission":
        em = jnp.zeros_like(radiance)
        t0, t1 = _segment(scene, o, d, t_hit)
        dt = (t1 - t0) / steps
        tau = jnp.zeros_like(radiance)
        for s in range(steps):
            tm = t0 + (s + 0.5) * dt
            p = o + d * tm[..., None]
            _, st, e = sigma_st(scene, p)
            em = em + jnp.exp(-tau) * e * dt[..., None]
            tau = tau + st * dt[..., None]
        vol = em
    else:
        vol = in_scatter(scene, o, d, t_hit, pixel_id, sample_idx, steps,
                         getattr(cfg, "transparent_shadows", 0),
                         substeps=(getattr(cfg, "vol_substeps", 8)
                                   if getattr(cfg, "vol_adaptive", False)
                                   else 1))
    if return_parts:
        return tr, vol
    return tr * radiance + vol
