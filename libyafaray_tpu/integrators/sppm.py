"""SPPM: stochastic progressive photon mapping.

Replaces SppmIntegrator (src/integrator/surface/integrator_sppm.cc): the
inverted loop — per pass, shoot a fresh photon map and trace ONE eye sample
per pixel to its first non-specular hit; per-pixel HitPoint statistics
(radius^2, accumulated flux, photon count) shrink with alpha = 0.7
(integrator_sppm.cc:243-249); radiance = flux / (pi r^2 N_emitted)
(integrator_sppm.cc:256). The reference's HashGrid becomes the dense photon
grid of photon.py; the per-pass photonWorker pool becomes one wavefront
walk. Direct lighting is estimated per pass with NEE and averaged.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from .. import film as F
from .. import photon as PH
from .. import sampler
from ..cameras import shoot_rays
from ..materials import bsdf as B
from ..math import vec
from ..ops import intersect as I
from ..ops import surface as S
from ..scene_types import SceneData
from . import common
from .mc import IntegratorConfig

Array = jax.Array

ALPHA = 0.7  # radius-shrink parameter (integrator_sppm.cc)


@struct.dataclass
class SppmState:
    radius2: Array    # f32[N] per-pixel gather radius^2
    flux: Array       # f32[N,3] accumulated (reduced) flux * f
    n_photons: Array  # f32[N] accumulated photon count (after alpha)
    direct: Array     # f32[N,3] accumulated direct+emission radiance
    n_passes: Array   # i32 number of completed passes
    n_emitted: Array  # f32 total photons emitted so far


def init_state(n_pixels: int, initial_radius: float) -> SppmState:
    return SppmState(
        radius2=jnp.full((n_pixels,), initial_radius ** 2, jnp.float32),
        flux=jnp.zeros((n_pixels, 3), jnp.float32),
        n_photons=jnp.zeros((n_pixels,), jnp.float32),
        direct=jnp.zeros((n_pixels, 3), jnp.float32),
        n_passes=jnp.zeros((), jnp.int32),
        n_emitted=jnp.zeros((), jnp.float32),
    )


def _eye_walk(scene: SceneData, cfg: IntegratorConfig, o, d, valid,
              pixel_id, sample_idx):
    """Trace camera rays through specular chains to the first non-specular
    hit; collect emission + NEE direct along the way (SppmIntegrator's eye
    pass, integrator_sppm.cc:174-258). Returns (sp, throughput, direct,
    diffuse_hit_mask)."""
    n = o.shape[0]
    throughput = jnp.ones((n, 3), jnp.float32)
    direct = jnp.zeros((n, 3), jnp.float32)
    alive = valid
    settled = jnp.zeros((n,), bool)
    prev_prim = jnp.full((n,), -1, jnp.int32)
    prev_delta = jnp.ones((n,), bool)
    sp_out = None
    wo_out = None
    num_lights = scene.lights.num_lights

    for depth in range(cfg.bounces + 1):
        if depth == 0:
            hit = I.camera_hit(scene, o, d, scene.ray_min_dist, 1e30)
        else:
            hit = I.closest_hit(scene, o, d, scene.ray_min_dist, 1e30,
                                exclude_prim=prev_prim)
        hit = hit.replace(valid=hit.valid & alive)
        sp = S.make_surface(scene, hit, o, d)
        wo = -d
        mis_w = common.hit_light_mis_weight(scene, sp, o, jnp.zeros((n,)),
                                            prev_delta, 1.0)
        emit = common.emitted_radiance(scene, sp, wo)
        direct = direct + jnp.where((alive & hit.valid)[..., None],
                                    throughput * emit, 0.0)
        # NEE at every surface
        if num_lights > 0:
            for li_static in range(num_lights):
                li = jnp.full((n,), li_static, jnp.int32)
                u1, u2 = sampler.rand2(pixel_id, sample_idx, depth,
                                       60 + 2 * li_static)
                c = common.estimate_one_light(scene, sp, wo, li, u1, u2, 0)
                direct = direct + jnp.where((alive & hit.valid)[..., None],
                                            throughput * c, 0.0)
        alive = alive & hit.valid
        # standalone light quads never scatter
        alive = alive & ~((sp.light_id >= 0) & (sp.obj_id < 0))

        mp = B.resolve_mp(scene, sp)
        cos_wo = jnp.abs(vec.dot(wo, sp.n))
        w_dr, w_dt, w_mf, w_di, w_tl = B.lobe_weights(mp, cos_wo)
        is_diffuse = (w_di + w_tl + w_mf) > 1e-5
        settle_now = alive & is_diffuse & ~settled
        if sp_out is None:
            sp_out = sp
            wo_out = wo
            settled_thr = jnp.where(settle_now[..., None], throughput, 0.0)
        else:
            sp_out = jax.tree_util.tree_map(
                lambda new, old: jnp.where(
                    settle_now.reshape((n,) + (1,) * (new.ndim - 1)),
                    new, old), sp, sp_out)
            wo_out = jnp.where(settle_now[..., None], wo, wo_out)
            settled_thr = jnp.where(settle_now[..., None], throughput,
                                    settled_thr)
        settled = settled | settle_now
        alive = alive & ~settle_now

        if depth == cfg.bounces:
            break
        u1, u2, u3, _ = jnp.moveaxis(
            sampler.rand4(pixel_id, sample_idx, depth, 70), -1, 0)
        ms = B.sample_bsdf(scene, sp, wo, u1, u2, u3)
        cont = alive & ms.valid & ms.is_delta
        throughput = jnp.where(cont[..., None], throughput * ms.weight,
                               throughput)
        alive = cont
        prev_prim = sp.prim
        prev_delta = ms.is_delta
        o = sp.p + ms.wi * scene.shadow_bias[..., None]
        d = ms.wi
    return sp_out, wo_out, settled_thr, direct, settled


def sppm_pass(scene: SceneData, cfg: IntegratorConfig, state: SppmState,
              height: int, width: int, pass_idx: Array,
              photons_per_pass: int) -> SppmState:
    """One SPPM pass: photon map rebuild + eye pass + statistics update."""
    n_pix = height * width
    yy, xx = jnp.meshgrid(jnp.arange(height), jnp.arange(width),
                          indexing="ij")
    pixel_id = (yy * width + xx).reshape(-1).astype(jnp.uint32)
    s_idx = jnp.asarray(pass_idx, jnp.uint32)
    scramble = sampler.pcg4d(jnp.stack(
        [pixel_id, jnp.full_like(pixel_id, 0x9E3779B9),
         jnp.full_like(pixel_id, 7), jnp.full_like(pixel_id, 11)], -1))[..., 0]
    ju, jv = sampler.ld02(s_idx, scramble)
    px = xx.reshape(-1).astype(jnp.float32) + ju
    py = yy.reshape(-1).astype(jnp.float32) + jv
    lu = sampler.rand1(pixel_id, s_idx, 0, 777)
    lv = sampler.rand1(pixel_id, s_idx, 0, 778)
    o, d, valid = shoot_rays(scene.camera, px, py, lu, lv)

    # fresh photon map for this pass (prePass, integrator_sppm.cc:485)
    g = scene.geom
    smin = jnp.min(g.vertices, axis=0)
    smax = jnp.max(g.vertices, axis=0)
    # traced per-pass seed -> decorrelated photon streams across passes
    pos, dir_, pw, caus, indirect, pvalid, _, _ = PH.shoot_photons(
        scene, photons_per_pass, cfg.pm_bounces, seed=s_idx)
    # indirect deposits only: the eye pass estimates direct light with NEE,
    # so direct (depth-0) photon deposits would double count.
    # Grid cell size follows the current largest per-pixel radius (the
    # hash-grid analogue of the reference rebuilding its HashGrid per
    # pass, integrator_sppm.cc:485): as radii shrink, cells shrink and
    # gathers touch fewer photons
    grid_r = jnp.sqrt(jnp.max(state.radius2))
    pmap = PH.build_photon_map(pos, dir_, pw, pvalid & indirect,
                               grid_r, smin, smax)

    sp, wo, thr, direct, settled = _eye_walk(scene, cfg, o, d, valid,
                                             pixel_id, s_idx)

    # gather flux within the exact per-pixel radius (r2 test below); the
    # grid cell tracks max(radius2) and shrinks with it — the 27-cell
    # neighborhood stays a superset of every pixel's gather sphere
    flux_new, m_new = PH.gather_flux(pmap, sp.p, sp.n, r2=state.radius2)
    mp = B.resolve_mp(scene, sp)
    f_diff = mp.diffuse_color / jnp.pi
    contrib = thr * f_diff * flux_new
    m_new = jnp.where(settled, m_new.astype(jnp.float32), 0.0)
    contrib = jnp.where(settled[..., None], contrib, 0.0)

    n_old = state.n_photons
    ratio = jnp.where(n_old + m_new > 0,
                      (n_old + ALPHA * m_new) / jnp.maximum(n_old + m_new, 1.0),
                      1.0)
    radius2 = state.radius2 * ratio
    flux = (state.flux + contrib) * ratio[..., None]
    n_phot = n_old + ALPHA * m_new
    return state.replace(
        radius2=radius2, flux=flux, n_photons=n_phot,
        direct=state.direct + direct,
        n_passes=state.n_passes + 1,
        n_emitted=state.n_emitted + photons_per_pass,
    )


def estimate_initial_radius(scene: SceneData, cfg: IntegratorConfig,
                            height: int, width: int,
                            photons_per_pass: int, r0: float,
                            n_search: int = 64) -> Array:
    """PM_IRE: per-pixel initial radius from local photon density
    (integrator_sppm.cc:635-649). The reference runs a kNN gather whose
    in-out radius shrinks to the n_search-th photon's distance; the
    wavefront equivalent counts photons inside the starting radius r0 and
    rescales by the 2-D disc density: r^2 = r0^2 * n_search / count
    (clamped to [r0/32, r0]); pixels that gather nothing keep r0 (the
    reference skips those too). Uses one throwaway photon map + eye walk,
    like the reference's "waste two gathers" first pass."""
    n_pix = height * width
    yy, xx = jnp.meshgrid(jnp.arange(height), jnp.arange(width),
                          indexing="ij")
    pixel_id = (yy * width + xx).reshape(-1).astype(jnp.uint32)
    px = xx.reshape(-1).astype(jnp.float32) + 0.5
    py = yy.reshape(-1).astype(jnp.float32) + 0.5
    zero = jnp.zeros((n_pix,), jnp.float32)
    o, d, valid = shoot_rays(scene.camera, px, py, zero, zero)
    g = scene.geom
    smin = jnp.min(g.vertices, axis=0)
    smax = jnp.max(g.vertices, axis=0)
    pos, dir_, pw, _, indirect, pvalid, _, _ = PH.shoot_photons(
        scene, photons_per_pass, cfg.pm_bounces, seed=jnp.uint32(0xA11CE))
    pmap = PH.build_photon_map(pos, dir_, pw, pvalid & indirect,
                               r0, smin, smax)
    sp, _, _, _, settled = _eye_walk(scene, cfg, o, d, valid, pixel_id,
                                     jnp.uint32(0))
    _, cnt = PH.gather_flux(pmap, sp.p, sp.n)
    cnt = cnt.astype(jnp.float32)
    r2 = jnp.where(settled & (cnt > 0),
                   jnp.clip(r0 * r0 * n_search / jnp.maximum(cnt, 1.0),
                            (r0 / 32.0) ** 2, r0 * r0),
                   r0 * r0)
    return r2


def resolve_sppm(state: SppmState, height: int, width: int) -> Array:
    """Final radiance: direct average + flux/(pi r^2 N_emitted)
    (integrator_sppm.cc:256)."""
    np_ = jnp.maximum(state.n_passes.astype(jnp.float32), 1.0)
    indirect = state.flux / (jnp.pi * state.radius2[..., None]
                             * jnp.maximum(state.n_emitted, 1.0))
    direct = state.direct / np_
    return (direct + indirect).reshape(height, width, 3)


def render_sppm(scene: SceneData, cfg: IntegratorConfig, width: int = None,
                height: int = None, passes: int = 8,
                photons_per_pass: int = 50_000,
                initial_radius: float = 0.05,
                pm_ire: bool = False) -> Array:
    """SppmIntegrator::render analogue: pass loop on the host, each pass one
    jitted wavefront. Returns the resolved [H,W,3] image. With pm_ire the
    per-pixel initial radius is estimated from local photon density
    (PM_IRE, integrator_sppm.cc:635-649) instead of the uniform
    initial_radius."""
    if width is None:
        width = scene.camera.resx
    if height is None:
        height = scene.camera.resy
    cfg = cfg.replace(pm_radius=initial_radius)
    state = init_state(width * height, initial_radius)
    if pm_ire:
        r2 = jax.jit(lambda: estimate_initial_radius(
            scene, cfg, height, width, photons_per_pass,
            initial_radius))()
        state = state.replace(radius2=r2)

    pass_fn = jax.jit(
        lambda st, pi: sppm_pass(scene, cfg, st, height, width, pi,
                                 photons_per_pass),
        donate_argnums=(0,))
    for p in range(passes):
        state = pass_fn(state, jnp.uint32(p))
    return resolve_sppm(state, height, width)
