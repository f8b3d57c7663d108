"""Wavefront Monte Carlo surface integrators: direct lighting + path tracing.

The wavefront re-design of the reference's recursive per-pixel integrators:
  - DirectLightIntegrator (integrator_direct_light.cc): emit + NEE + AO +
    specular recursion, no diffuse indirect;
  - PathIntegrator (integrator_path_tracer.cc:120-267): NEE every bounce,
    Halton-per-depth dims, Russian roulette after a minimum bounce count.

Instead of recursion over a scalar ray, the whole megabatch of rays marches
through a statically-unrolled bounce loop with masked lanes ("wavefront
formulation"); dead lanes simply carry zero throughput — there is no
divergence on the VPU. The reference's RayDivision trajectory splitting
(render_data.h:27-33) is subsumed by the flat sample budget.
"""
from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
from ..utils import struct

from .. import color as C
from .. import lights as L
from .. import sampler
from ..backgrounds import eval_background
from ..materials import bsdf as B
from ..materials.nodes import bump_normal
from ..math import vec
from ..ops import intersect as I
from ..ops import surface as S
from ..scene_types import SceneData
from . import common

Array = jax.Array


@struct.dataclass
class IntegratorConfig:
    """Static integrator settings (ParamMap-parsed; names follow the
    reference factories)."""
    kind: str = struct.field(pytree_node=False, default="pathtracing")
    bounces: int = struct.field(pytree_node=False, default=4)
    russian_roulette_min_bounces: int = struct.field(pytree_node=False, default=2)
    transparent_shadows: int = struct.field(pytree_node=False, default=0)
    use_ao: bool = struct.field(pytree_node=False, default=False)
    ao_samples: int = struct.field(pytree_node=False, default=8)
    ao_distance: float = struct.field(pytree_node=False, default=1.0)
    ao_color: Tuple[float, float, float] = struct.field(
        pytree_node=False, default=(1.0, 1.0, 1.0))
    no_recursive: bool = struct.field(pytree_node=False, default=False)
    sample_all_lights_direct: bool = struct.field(pytree_node=False, default=True)
    aov_layers: Tuple[str, ...] = struct.field(pytree_node=False, default=())
    transp_background: bool = struct.field(pytree_node=False, default=False)
    clamp_indirect: float = struct.field(pytree_node=False, default=0.0)
    # volume integrator (reference: a separate VolumeIntegrator entity;
    # factory types EmissionIntegrator / SingleScatterIntegrator / SkyIntegrator)
    vol_kind: str = struct.field(pytree_node=False, default="single_scatter")
    vol_steps: int = struct.field(pytree_node=False, default=16)
    # single-scatter attenuation-grid cache (param "optimize",
    # integrator_single_scatter.cc:35-108)
    vol_optimize: bool = struct.field(pytree_node=False, default=False)
    # adaptive marching (param "adaptive", integrator_single_scatter.cc:
    # 303-334): fine density substeps inside each coarse in-scatter step
    vol_adaptive: bool = struct.field(pytree_node=False, default=False)
    vol_substeps: int = struct.field(pytree_node=False, default=8)
    # sky integrator params (SkyIntegrator::factory, integrator_sky.cc:198)
    sky_alpha: float = struct.field(pytree_node=False, default=0.5)
    sky_turbidity: float = struct.field(pytree_node=False, default=3.0)
    sky_scale: float = struct.field(pytree_node=False, default=0.1)
    # photon mapping (integrator_photon_mapping.cc params)
    n_photons: int = struct.field(pytree_node=False, default=100_000)
    pm_radius: float = struct.field(pytree_node=False, default=0.05)
    pm_bounces: int = struct.field(pytree_node=False, default=5)
    # final gathering ("finalGather"/"fg_samples"/"fg_bounces",
    # integrator_photon_mapping.cc:806-808; default on like the reference)
    final_gather: bool = struct.field(pytree_node=False, default=True)
    fg_samples: int = struct.field(pytree_node=False, default=16)
    # secondary gather bounces + near-field cutoff ("fg_bounces" /
    # "fg_min_pathlen", integrator_photon_mapping.cc:806-810): gather
    # hits nearer than fg_min_pathlen don't trust the (blurry) radiance
    # cache — they take a real direct-light estimate and bounce on
    fg_bounces: int = struct.field(pytree_node=False, default=3)
    fg_min_pathlen: float = struct.field(pytree_node=False, default=0.0)
    # path tracer caustic modes: "none"|"path"|"photon"|"both"
    # (integrator_path_tracer.cc:325-345)
    caustic_type: str = struct.field(pytree_node=False, default="path")
    # index-mask layer params (reference mask_mat_index / mask_obj_index
    # render params feeding the *-index-mask layers)
    mask_mat_index: int = struct.field(pytree_node=False, default=0)
    mask_obj_index: int = struct.field(pytree_node=False, default=0)
    mask_invert: bool = struct.field(pytree_node=False, default=False)


def make_integrator(pm: dict) -> IntegratorConfig:
    """Factory mirroring src/integrator/integrator.cc:46-58 type strings."""
    from .. import params as P
    pm = P.ParamMap(pm)
    kind = pm.get_string("type", "pathtracing")
    if kind in ("directlighting", "pathtracing", "DebugIntegrator", "debug",
                "photonmapping", "SPPM", "bidirectional"):
        pass
    else:
        raise KeyError(f"integrator: unknown type {kind!r}")
    return IntegratorConfig(
        kind=kind,
        bounces=pm.get_int("bounces", pm.get_int("raydepth", 4)),
        russian_roulette_min_bounces=pm.get_int("russian_roulette_min_bounces", 2),
        transparent_shadows=(pm.get_int("shadowDepth", 4)
                             if pm.get_bool("transpShad", False) else 0),
        use_ao=pm.get_bool("do_AO", False),
        ao_samples=pm.get_int("AO_samples", 8),
        ao_distance=pm.get_float("AO_distance", 1.0),
        ao_color=tuple(pm.get_color("AO_color", (1, 1, 1))[:3].tolist()),
        no_recursive=pm.get_bool("no_recursive", False),
        clamp_indirect=pm.get_float("clamp_indirect", 0.0),
        vol_kind={"EmissionIntegrator": "emission",
                  "SingleScatterIntegrator": "single_scatter",
                  "SkyIntegrator": "sky",
                  "none": "none"}.get(
            pm.get_string("volume_integrator", "SingleScatterIntegrator"),
            "single_scatter"),
        vol_steps=pm.get_int("volume_steps", 16),
        vol_optimize=pm.get_bool("optimize", False),
        vol_adaptive=pm.get_bool("adaptive", False),
        vol_substeps=pm.get_int("adaptive_substeps", 8),
        sky_alpha=pm.get_float("alpha", 0.5),
        sky_turbidity=pm.get_float("turbidity", 3.0),
        sky_scale=pm.get_float("sigma_t", 0.1),
        n_photons=pm.get_int("photons", 100_000),
        pm_radius=pm.get_float("diffuseRadius", pm.get_float("causticRadius",
                                                             0.05)),
        pm_bounces=pm.get_int("bounces", 5) if kind == "photonmapping" else 5,
        caustic_type=pm.get_string("caustic_type", "path"),
        final_gather=pm.get_bool("finalGather", True),
        fg_samples=pm.get_int("fg_samples", 16),
        fg_bounces=pm.get_int("fg_bounces", 3),
        fg_min_pathlen=pm.get_float(
            "fg_min_pathlen", pm.get_float("diffuseRadius", 0.05)),
        mask_mat_index=pm.get_int("layer_mask_mat_index", 0),
        mask_obj_index=pm.get_int("layer_mask_obj_index", 0),
        mask_invert=pm.get_bool("layer_mask_invert", False),
    )


def _final_gather(scene, cfg, sp, wo, pixel_id, sample_idx, depth):
    """Final gathering over the precomputed radiance cache with secondary
    gather bounces (PhotonIntegrator::finalGathering,
    integrator_photon_mapping.cc:643-765, params fg_bounces /
    fg_min_pathlen :806-810): cosine-sampled gather rays; a gather hit
    FARTHER than fg_min_pathlen looks up the cached outgoing radiance
    (estimator mean(albedo * L_cache); the cos/pdf factors cancel for
    Lambertian gather). A hit NEARER than fg_min_pathlen does not trust
    the blurry cache — it takes a real one-light direct estimate there and
    bounces diffusely onward (up to fg_bounces), exactly the reference's
    near-field path-tracing correction. With fg_min_pathlen == 0 (our
    pre-r5 behavior) every lane terminates at the first hit."""
    from .. import photon as PH
    n = sp.p.shape[0]
    mp = B.resolve_mp(scene, sp)
    acc = jnp.zeros_like(sp.p)
    n_bounce = max(int(cfg.fg_bounces), 1) if cfg.fg_min_pathlen > 0 else 1
    for k in range(cfg.fg_samples):
        u1, u2 = sampler.rand2(pixel_id, sample_idx, depth, 9500 + 2 * k)
        d_loc = vec.cosine_sample_hemisphere(u1, u2)
        wi = vec.from_local(d_loc, sp.nu, sp.nv, sp.n)
        o = sp.p + wi * scene.shadow_bias[..., None]
        thr = jnp.ones((n, 3), jnp.float32)
        alive = sp.valid
        prim = sp.prim
        for b in range(n_bounce):
            hit = I.closest_hit(scene, o, wi, scene.ray_min_dist,
                                jnp.where(alive, 1e30, -1.0),
                                exclude_prim=prim)
            hit = hit.replace(valid=hit.valid & alive)
            gsp = S.make_surface(scene, hit, o, wi)
            last = b == n_bounce - 1
            close = hit.valid & (hit.t < cfg.fg_min_pathlen) & ~last
            # far (or final-bounce) hits: cache lookup, lane done
            rad = PH.lookup_radiance(scene.photons.radiance, gsp.p, gsp.n)
            acc = acc + jnp.where((hit.valid & ~close)[..., None],
                                  thr * rad, 0.0)
            if cfg.fg_min_pathlen <= 0 or last:
                break
            # near hits: direct light here + diffuse bounce onward
            ul, u3, u4, _ = jnp.moveaxis(
                sampler.rand4(pixel_id, sample_idx, depth,
                              9700 + 8 * k + 2 * b), -1, 0)
            nl = max(scene.lights.num_lights, 1)
            li = jnp.clip((ul * nl).astype(jnp.int32), 0, nl - 1)
            if scene.lights.num_lights > 0:
                c = common.estimate_one_light(scene, gsp, -wi, li, u3, u4,
                                              cfg.transparent_shadows)
                acc = acc + jnp.where(close[..., None],
                                      thr * c * nl, 0.0)
            gmp = B.resolve_mp(scene, gsp)
            u5, u6 = sampler.rand2(pixel_id, sample_idx, depth,
                                   9800 + 8 * k + 2 * b)
            d_loc2 = vec.cosine_sample_hemisphere(u5, u6)
            wi = vec.from_local(d_loc2, gsp.nu, gsp.nv, gsp.n)
            thr = jnp.where(close[..., None], thr * gmp.diffuse_color, thr)
            o = gsp.p + wi * scene.shadow_bias[..., None]
            prim = gsp.prim
            alive = close
    return mp.diffuse_color * acc / cfg.fg_samples


def _sample_ambient_occlusion(scene, cfg, sp, wo, pixel_id, sample_idx):
    """AO estimator (TiledIntegrator::sampleAmbientOcclusion,
    integrator_tiled.cc:644)."""
    col = jnp.zeros_like(sp.p)
    ao_col = jnp.asarray(cfg.ao_color, jnp.float32)
    for s in range(cfg.ao_samples):
        u1, u2 = sampler.rand2(pixel_id, sample_idx, 900 + s, 0)
        d_loc = vec.cosine_sample_hemisphere(u1, u2)
        wi = vec.from_local(d_loc, sp.nu, sp.nv, sp.n)
        tr = common.trace_shadow(scene, sp.p, sp.prim, wi,
                                 jnp.full(sp.t.shape, cfg.ao_distance),
                                 cfg.transparent_shadows, needed=sp.valid)
        col = col + ao_col * tr / cfg.ao_samples
    return jnp.where(sp.valid[..., None], col, 0.0)


def integrate(scene: SceneData, cfg: IntegratorConfig,
              ray_o: Array, ray_d: Array, ray_valid: Array,
              pixel_id: Array, sample_idx: Array,
              ray_time: Array = None
              ) -> Tuple[Array, Array, Dict[str, Array]]:
    """Trace one wavefront of camera rays to completion.

    Returns (rgb[N,3], alpha[N], aux_layers{name: [N,C]})."""
    if cfg.kind in ("debug", "DebugIntegrator"):
        return _integrate_debug(scene, cfg, ray_o, ray_d, ray_valid)
    if cfg.kind == "bidirectional":
        from .bidir import integrate_bidir
        return integrate_bidir(scene, cfg, ray_o, ray_d, ray_valid,
                               pixel_id, sample_idx, ray_time)

    n = ray_o.shape[0]
    num_lights = scene.lights.num_lights
    direct_only = cfg.kind == "directlighting"
    # photon mapping: direct lighting + photon-map density estimates at
    # diffuse hits, specular-only continuation (the non-final-gather mode of
    # integrator_photon_mapping.cc; FG is a later refinement)
    photon_mode = (cfg.kind == "photonmapping"
                   and scene.photons is not None)
    direct_only = direct_only or cfg.kind == "photonmapping"

    radiance = jnp.zeros((n, 3), jnp.float32)
    throughput = jnp.ones((n, 3), jnp.float32)
    alive = ray_valid
    first_hit_t = jnp.full((n,), 1e30, jnp.float32)
    # chromatic dispersion (MonteCarloIntegrator::dispersive branch,
    # integrator_montecarlo.cc:664 + spectrum wl2Rgb): each path carries a
    # wavelength; the first dispersive refraction collapses the path to it
    # and tints the throughput by 3 * wl2rgb(wl) (spectral decomposition)
    path_wl = sampler.rand1(pixel_id, sample_idx, 0, 555)
    if scene.fixed_wavelength is not None:
        # spectral render view (RenderView::getWaveLength): every path uses
        # the view's fixed wavelength instead of per-path sampling
        path_wl = jnp.where(scene.fixed_wavelength > 0.0,
                            scene.fixed_wavelength, path_wl)
    chromatic = jnp.zeros((n,), bool)
    # per-sample shutter time for motion blur (BsTriangle ray.time analogue)
    if ray_time is None and scene.geom.has_motion:
        ray_time = sampler.rand1(pixel_id, sample_idx, 0, 556)
    alpha = jnp.zeros((n,), jnp.float32)
    o, d = ray_o, ray_d
    prev_prim = jnp.full((n,), -1, jnp.int32)
    prev_pdf = jnp.zeros((n,), jnp.float32)
    prev_delta = jnp.ones((n,), bool)  # camera rays count as delta for MIS
    prev_p = ray_o
    aux: Dict[str, Array] = {}
    # accumulated AOV layers (reference layer_definitions.h:36-111; env /
    # shadow / indirect + first-bounce-lobe splits are accumulated DURING
    # integration, not derived from the first hit)
    want_env = "env" in cfg.aov_layers
    want_ind = any(l_ in cfg.aov_layers for l_ in
                   ("indirect", "diffuse-indirect", "glossy-indirect",
                    "adv-indirect", "adv-diffuse-indirect",
                    "adv-glossy-indirect", "adv-trans-indirect",
                    "adv-subsurface-indirect"))
    want_shadow = ("shadow" in cfg.aov_layers
                   or "mat-index-mask-shadow" in cfg.aov_layers
                   or "obj-index-mask-shadow" in cfg.aov_layers)
    # per-BSDF-family + per-technique direct-light splits at the first hit
    # (ColorLayerAccum in doLightEstimation, integrator_montecarlo.cc)
    want_family = any(l_ in cfg.aov_layers for l_ in
                      ("diffuse", "diffuse-noshadow", "adv-glossy",
                       "adv-trans", "adv-subsurface",
                       "debug-light-estimation-light-dirac",
                       "debug-light-estimation-light-sampling"))
    want_matsamp = "debug-light-estimation-mat-sampling" in cfg.aov_layers
    env_acc = jnp.zeros((n, 3), jnp.float32) if (want_env or want_ind) \
        else None
    shadow_acc = jnp.zeros((n, 3), jnp.float32) if want_shadow else None
    fam_acc = ({k: jnp.zeros((n, 3), jnp.float32)
                for k in ("diffuse", "glossy", "trans", "subsurface",
                          "diffuse-noshadow", "light-dirac",
                          "light-sampling")}
               if want_family else None)
    matsamp_acc = jnp.zeros((n, 3), jnp.float32) if want_matsamp else None
    env_d0 = None
    first_lobe = jnp.full((n,), -1, jnp.int32)
    first_mat_id = jnp.zeros((n,), jnp.int32)
    first_obj_id = jnp.zeros((n,), jnp.int32)
    first_valid = jnp.zeros((n,), bool)
    path_kind_all = jnp.zeros((n,), jnp.int32)

    # light pick pdf for the path tracer's uniform pick
    # (estimateOneDirectLight, integrator_montecarlo.cc:70)
    sample_all = direct_only or cfg.sample_all_lights_direct or num_lights <= 2

    # interior volume handlers (reference VolumeHandler 'beer'/'sss',
    # volume/volume.cc:58-59; applied by the path tracer as
    # throughput *= vol->transmittance(segment) for segments inside a
    # Volumetric material, integrator_path_tracer.cc:241-247). Statically
    # gated: scenes without absorbing/scattering dielectrics trace none
    # of this.
    track_medium = ((scene.materials.has_beer or scene.materials.has_sss)
                    and not direct_only)
    if track_medium:
        medium_mat = jnp.full((n,), -1, jnp.int32)

    max_depth = cfg.bounces + 1
    for depth in range(max_depth):
        # dead paths get an EMPTY t-range: the block accelerator clusters
        # them into zero-candidate tiles (accel/blocks.py sort key), so
        # terminated paths cost ~nothing in traversal instead of tracing
        # a stale full-range ray every remaining bounce
        if depth == 0:
            # primary segment: honors camera-invisible area lights
            # (visibility='invisible', the reference arealight semantics)
            hit = I.camera_hit(scene, o, d, scene.ray_min_dist,
                               jnp.where(alive, 1e30, -1.0), time=ray_time)
        else:
            hit = I.closest_hit(scene, o, d, scene.ray_min_dist,
                                jnp.where(alive, 1e30, -1.0),
                                exclude_prim=prev_prim, time=ray_time)
        hit = hit.replace(valid=hit.valid & alive)
        scat = jnp.zeros((n,), bool)
        if track_medium:
            in_med = (medium_mat >= 0) & alive
            mm = jnp.maximum(medium_mat, 0)
            t_seg = jnp.where(hit.valid & in_med, hit.t, 0.0)
            if scene.materials.has_sss:
                # exponential free-path sampling (volumehandler_sss.cc:35):
                # dist = -d_s * ln(u); scatter when it lands inside the
                # segment — the surface interaction is then REPLACED by an
                # isotropic scatter tinted by scatter_col
                u_sc, u_s1, u_s2, _ = jnp.moveaxis(
                    sampler.rand4(pixel_id, sample_idx, depth, 61), -1, 0)
                sdist = scene.materials.sss_dist[mm]
                sc_dist = -sdist * jnp.log(jnp.maximum(u_sc, 1e-12))
                scat = (in_med & (sdist > 0.0) & hit.valid
                        & (sc_dist < hit.t))
                t_seg = jnp.where(scat, sc_dist, t_seg)
                scat_p = o + d * t_seg[..., None]
                cz = 1.0 - 2.0 * u_s1
                szr = jnp.sqrt(jnp.maximum(1.0 - cz * cz, 0.0))
                phi_s = 2.0 * jnp.pi * u_s2
                scat_d = jnp.stack([szr * jnp.cos(phi_s),
                                    szr * jnp.sin(phi_s), cz], -1)
                throughput = jnp.where(
                    scat[..., None],
                    throughput * scene.materials.sss_scatter_col[mm],
                    throughput)
            if scene.materials.has_beer:
                # Beer-law interior transmittance e^(-sigma_a * t)
                beer_tr = jnp.exp(-scene.materials.absorption[mm]
                                  * t_seg[..., None])
                throughput = jnp.where(in_med[..., None],
                                       throughput * beer_tr, throughput)
            hit = hit.replace(valid=hit.valid & ~scat)
        sp = S.make_surface(scene, hit, o, d)
        if depth == 0:
            # primary hits carry a screen-space footprint for mipmap/EWA
            # texture filtering (SurfacePoint differentials analogue)
            sp = S.compute_differentials(scene, sp, d)
        sp = bump_normal(scene, sp)
        wo = -d

        # --- escaped rays: background (+ env-light MIS) ---
        escaped = alive & ~hit.valid & ~scat
        bg_rad = eval_background(scene, d)
        bg_mis = jnp.ones((n,), jnp.float32)
        if scene.lights.bg_light_idx >= 0:
            bpdf = L.background_pdf(scene, d)
            pick = 1.0 if sample_all else 1.0 / max(num_lights, 1)
            bg_mis = jnp.where(prev_delta, 1.0,
                               vec.power_heuristic(prev_pdf, bpdf * pick))
        add_bg = (depth > 0) or not cfg.transp_background
        if add_bg:
            bg_add = jnp.where(
                escaped[..., None], throughput * bg_rad * bg_mis[..., None],
                0.0)
            radiance = radiance + bg_add
            if env_acc is not None:
                env_acc = env_acc + bg_add
        if depth == 0:
            aux = _first_hit_layers(scene, cfg, sp, d)
            first_hit_t = jnp.where(hit.valid, hit.t, first_hit_t)
            first_mat_id = sp.mat_id
            first_obj_id = sp.obj_id
            first_valid = sp.valid
        alpha = jnp.where(hit.valid & (depth == 0), 1.0, alpha)
        # keep alpha 1 for lanes that bounced at least once then escaped
        alpha = jnp.where((depth > 0) & alive, jnp.maximum(alpha, 1.0), alpha)
        alive = alive & hit.valid

        # --- emission at the hit (MIS-weighted vs NEE) ---
        pick_pdf = 1.0 if sample_all else 1.0 / max(num_lights, 1)
        mis_w = common.hit_light_mis_weight(scene, sp, prev_p, prev_pdf,
                                            prev_delta, pick_pdf)
        emit = common.emitted_radiance(scene, sp, wo)
        radiance = radiance + jnp.where(alive[..., None],
                                        throughput * emit * mis_w[..., None], 0.0)
        if want_matsamp and depth > 0:
            # BSDF-sampled (material-sampling) share of the light estimate:
            # emission reached by a sampled non-delta bounce, MIS-weighted
            # (DebugLightEstimationMatSampling, areaLightSampleMaterial)
            matsamp_acc = matsamp_acc + jnp.where(
                (alive & ~prev_delta)[..., None],
                throughput * emit * mis_w[..., None], 0.0)
        # standalone area-light quads (face_obj == -1) are pure emitters: the
        # reference intersects lights separately from scene geometry
        # (AreaLight::intersect, light_area.cc:137) and never scatters off them
        alive = alive & ~((sp.light_id >= 0) & (sp.obj_id < 0))

        # --- next-event estimation ---
        if num_lights > 0 and depth <= cfg.bounces:
            want_si = want_shadow and depth == 0
            want_fs = want_family and depth == 0
            if sample_all:
                nee_iters = []
                for li_static in range(num_lights):
                    # the DIRECT-LIGHT driver honors each light's
                    # requested nSamples (estimateAllDirectLight's
                    # num_samples loop, integrator_montecarlo.cc:156-230,
                    # per-sample MIS like the reference); the path tracer
                    # keeps one NEE sample per bounce (its reference uses
                    # estimateOneDirectLight)
                    ns = 1
                    if direct_only and scene.lights.samples_static:
                        ns = scene.lights.samples_static[li_static]
                    for k in range(ns):
                        u1, u2 = sampler.rand2(
                            pixel_id, sample_idx, depth,
                            10 + 2 * li_static + 100 * k)
                        nee_iters.append(
                            (jnp.full((n,), li_static, jnp.int32),
                             u1, u2, 1.0, 1.0 / ns))
            else:
                ul, u1, u2, _ = jnp.moveaxis(
                    sampler.rand4(pixel_id, sample_idx, depth, 10), -1, 0)
                li = jnp.clip((ul * num_lights).astype(jnp.int32), 0,
                              num_lights - 1)
                nee_iters = [(li, u1, u2, 1.0 / num_lights, 1.0)]
            for li, u1, u2, pick, wt in nee_iters:
                res = common.estimate_one_light(
                    scene, sp, wo, li, u1, u2, cfg.transparent_shadows,
                    pick_pdf=pick, time=ray_time,
                    with_shadow_info=want_si, with_family_split=want_fs)
                fam = None
                c_unsh = None
                if want_si and want_fs:
                    c, c_unsh, fam = res
                elif want_fs:
                    c, fam = res
                elif want_si:
                    c, c_unsh = res
                else:
                    c = res
                radiance = radiance + jnp.where(alive[..., None],
                                                throughput * c * wt, 0.0)
                if want_si:
                    shadow_acc = shadow_acc + jnp.where(
                        alive[..., None], (c_unsh - c) * wt, 0.0)
                if want_fs:
                    for k_ in fam_acc:
                        fam_acc[k_] = fam_acc[k_] + jnp.where(
                            alive[..., None], throughput * fam[k_] * wt, 0.0)

        # --- photon-map estimates at diffuse hits (photonmapping mode) ---
        if photon_mode:
            from .. import photon as PH
            use_fg = cfg.final_gather and scene.photons.radiance is not None
            if use_fg:
                # final gathering: one-bounce gather rays whose hits read the
                # precomputed radiance cache (finalGathering,
                # integrator_photon_mapping.cc:643)
                ind = _final_gather(scene, cfg, sp, wo, pixel_id, sample_idx,
                                    depth)
            else:
                ind = PH.estimate_radiance(scene.photons.diffuse, scene, sp,
                                           wo, scene.photons.n_emitted)
            cau = PH.estimate_radiance(scene.photons.caustic, scene, sp, wo,
                                       scene.photons.n_emitted)
            radiance = radiance + jnp.where(alive[..., None],
                                            throughput * (ind + cau), 0.0)
            if "adv-radiance" in cfg.aov_layers and depth == 0:
                # photon/FG radiance estimate at the primary hit
                # (Type::Radiance layer, the FG cache view)
                aux["adv-radiance"] = jnp.where(alive[..., None], ind, 0.0)

        # --- ambient occlusion (direct-light integrator option) ---
        if cfg.use_ao and depth == 0:
            ao = _sample_ambient_occlusion(scene, cfg, sp, wo, pixel_id,
                                           sample_idx)
            mp = B.resolve_mp(scene, sp)
            radiance = radiance + jnp.where(
                alive[..., None],
                throughput * ao * mp.diffuse_color / jnp.pi * 1.0, 0.0)
            if "ao" in cfg.aov_layers:
                aux["ao"] = jnp.where(alive[..., None], ao, 0.0)
            if "ao-clay" in cfg.aov_layers:
                aux["ao-clay"] = jnp.where(alive[..., None], ao, 0.0)

        if depth == 0:
            # snapshot for the reflect/refract layers: whatever radiance
            # arrives after the first bounce is attributed to the path's
            # first specular branch (ReflectAll/RefractAll layers)
            radiance_d0 = radiance
            if env_acc is not None:
                env_d0 = env_acc

        if depth == max_depth - 1:
            break

        # --- BSDF sampling / continuation ---
        u1, u2, u3, u_rr = jnp.moveaxis(
            sampler.rand4(pixel_id, sample_idx, depth, 2), -1, 0)
        ms = B.sample_bsdf(scene, sp, wo, u1, u2, u3, wl=path_wl)
        if depth == 0:
            transmitted = vec.dot(ms.wi, sp.ng) * vec.dot(wo, sp.ng) < 0.0
            spec0 = alive & ms.valid & ms.is_delta
            path_kind = jnp.where(spec0, jnp.where(transmitted, 2, 1), 0)
            if ms.lobe is not None:
                first_lobe = jnp.where(alive & ms.valid, ms.lobe, -1)
                # ReflectAll/RefractAll classification: any non-diffuse
                # first bounce (delta or microfacet), split by side
                nondiff = alive & ms.valid & (ms.lobe != 3) & (ms.lobe != 4)
                path_kind_all = jnp.where(
                    nondiff, jnp.where(transmitted, 2, 1), 0)
        cont = alive & ms.valid
        if direct_only or cfg.no_recursive:
            # only specular/delta continuation (recursiveRaytrace analogue)
            cont = cont & ms.is_delta
        new_thr = throughput * ms.weight
        first_disperse = ms.dispersed & ~chromatic
        new_thr = jnp.where(first_disperse[..., None],
                            new_thr * C.wl_to_rgb(path_wl) * 3.0, new_thr)
        chromatic = chromatic | ms.dispersed
        if cfg.clamp_indirect > 0.0 and depth > 0:
            mx = jnp.max(new_thr, axis=-1, keepdims=True)
            new_thr = jnp.where(mx > cfg.clamp_indirect,
                                new_thr * cfg.clamp_indirect / jnp.maximum(mx, 1e-9),
                                new_thr)
        # Russian roulette on throughput max (integrator_path_tracer.cc:248-255)
        if depth >= cfg.russian_roulette_min_bounces and not direct_only:
            p_survive = jnp.clip(jnp.max(new_thr, axis=-1), 0.05, 1.0)
            kill = u_rr > p_survive
            new_thr = new_thr / p_survive[..., None]
            cont = cont & ~kill
        throughput = jnp.where(cont[..., None], new_thr, throughput)
        if track_medium:
            # medium crossing on the surviving surface interactions:
            # transmission against the geometric normal enters/leaves the
            # dielectric interior (getVolumeHandler(inside) analogue)
            crossed = cont & (vec.dot(ms.wi, sp.ng) * vec.dot(wo, sp.ng)
                              < 0.0)
            going_in = vec.dot(ms.wi, sp.ng) < 0.0
            medium_mat = jnp.where(
                crossed & going_in, sp.mat_id,
                jnp.where(crossed & ~going_in, -1, medium_mat))
        alive = cont
        prev_p = sp.p
        prev_prim = sp.prim
        prev_pdf = ms.pdf
        prev_delta = ms.is_delta
        o = sp.p + ms.wi * scene.shadow_bias[..., None]
        d = ms.wi
        if track_medium and scene.materials.has_sss:
            # scatter lanes stay alive INSIDE the medium with the redirected
            # isotropic ray (surface interaction skipped this depth)
            alive = alive | scat
            o = jnp.where(scat[..., None], scat_p, o)
            d = jnp.where(scat[..., None], scat_d, d)
            prev_prim = jnp.where(scat, -1, prev_prim)
            prev_delta = jnp.where(scat, True, prev_delta)

    alpha = jnp.clip(alpha, 0.0, 1.0)
    if want_env:
        aux["env"] = env_acc
    if want_shadow:
        aux["shadow"] = shadow_acc
    if want_ind:
        # indirect = everything added after the first-hit pass, minus the
        # background share (combined == radiance_d0 + env_after_d0 +
        # indirect by construction — the layer closure test pins this)
        env_after_d0 = (env_acc - env_d0) if env_acc is not None else 0.0
        indirect = radiance - radiance_d0 - env_after_d0
        if "indirect" in cfg.aov_layers:
            aux["indirect"] = indirect

        def lobe_split(*lobes):
            m_ = jnp.zeros_like(first_lobe, bool)
            for lb in lobes:
                m_ = m_ | (first_lobe == lb)
            return jnp.where(m_[..., None], indirect, 0.0)

        # first-bounce-lobe splits (reference adv-*-indirect layers);
        # lobe ids: 0 delta-reflect, 1 delta-transmit, 2 microfacet,
        # 3 diffuse, 4 translucent
        for name, lobes in (("diffuse-indirect", (3,)),
                            ("adv-diffuse-indirect", (3,)),
                            ("glossy-indirect", (2,)),
                            ("adv-glossy-indirect", (2,)),
                            ("adv-trans-indirect", (1,)),
                            ("adv-subsurface-indirect", (4,)),
                            # Type::Indirect: light arriving via a first
                            # specular/delta bounce (caustic-like paths)
                            ("adv-indirect", (0, 1))):
            if name in cfg.aov_layers:
                aux[name] = lobe_split(*lobes)
    if max_depth > 1 and any(l_ in cfg.aov_layers for l_ in
                             ("reflect", "refract", "adv-reflect",
                              "adv-refract")):
        extra = radiance - radiance_d0
        # reflect/refract = ReflectAll/RefractAll (any non-diffuse first
        # bounce); adv-reflect/adv-refract = the Perfect (delta-only) pair
        if "reflect" in cfg.aov_layers:
            aux["reflect"] = jnp.where((path_kind_all == 1)[..., None],
                                       extra, 0.0)
        if "refract" in cfg.aov_layers:
            aux["refract"] = jnp.where((path_kind_all == 2)[..., None],
                                       extra, 0.0)
        if "adv-reflect" in cfg.aov_layers:
            aux["adv-reflect"] = jnp.where((path_kind == 1)[..., None],
                                           extra, 0.0)
        if "adv-refract" in cfg.aov_layers:
            aux["adv-refract"] = jnp.where((path_kind == 2)[..., None],
                                           extra, 0.0)
    if want_family:
        for src, name in (("diffuse", "diffuse"),
                          ("diffuse-noshadow", "diffuse-noshadow"),
                          ("glossy", "adv-glossy"),
                          ("trans", "adv-trans"),
                          ("subsurface", "adv-subsurface"),
                          ("light-dirac",
                           "debug-light-estimation-light-dirac"),
                          ("light-sampling",
                           "debug-light-estimation-light-sampling")):
            if name in cfg.aov_layers:
                aux[name] = fam_acc[src]
    if want_matsamp:
        aux["debug-light-estimation-mat-sampling"] = matsamp_acc
    # index-mask composites (MatIndexMaskAll/Shadow, generateCommonLayers)
    for prefix, ids, want_idx in (("mat", first_mat_id, cfg.mask_mat_index),
                                  ("obj", first_obj_id, cfg.mask_obj_index)):
        m_all = f"{prefix}-index-mask-all"
        m_sh = f"{prefix}-index-mask-shadow"
        if m_all in cfg.aov_layers or m_sh in cfg.aov_layers:
            msk = first_valid & (ids == want_idx)
            if cfg.mask_invert:
                msk = first_valid & ~msk
            if m_all in cfg.aov_layers:
                aux[m_all] = jnp.where(msk[..., None], radiance, 0.0)
            if m_sh in cfg.aov_layers:
                aux[m_sh] = jnp.where(msk[..., None], shadow_acc, 0.0)
    # volumetric wrap-up over the camera segment (applyVolumetricEffects,
    # integrator_tiled.cc:694): L = T(seg) * L_surface + L_volume(seg)
    want_volparts = any(l_ in cfg.aov_layers for l_ in
                        ("adv-surface-integration", "adv-volume-integration",
                         "adv-volume-transmittance"))
    if want_volparts:
        aux["adv-surface-integration"] = radiance
    if (scene.volumes is not None or cfg.vol_kind == "sky") \
            and cfg.vol_kind != "none":
        from .volume import apply_volumetric
        if want_volparts:
            tr_seg, vol_add = apply_volumetric(
                scene, cfg, radiance, ray_o, ray_d, first_hit_t,
                pixel_id, sample_idx, return_parts=True)
            radiance = tr_seg * radiance + vol_add
            aux["adv-volume-integration"] = vol_add
            aux["adv-volume-transmittance"] = jnp.mean(
                tr_seg * jnp.ones((n, 3)), axis=-1, keepdims=True)
        else:
            radiance = apply_volumetric(scene, cfg, radiance, ray_o, ray_d,
                                        first_hit_t, pixel_id, sample_idx)
    elif want_volparts:
        aux["adv-volume-integration"] = jnp.zeros((n, 3), jnp.float32)
        aux["adv-volume-transmittance"] = jnp.ones((n, 1), jnp.float32)
    return radiance, alpha, aux


def _first_hit_layers(scene, cfg, sp, d) -> Dict[str, Array]:
    """AOV layer values from the primary hit (generateCommonLayers analogue,
    integrator_tiled.cc:410)."""
    out: Dict[str, Array] = {}
    if not cfg.aov_layers:
        return out
    v = sp.valid[..., None]
    for name in cfg.aov_layers:
        if name == "normal-smooth":
            out[name] = jnp.where(v, sp.n * 0.5 + 0.5, 0.0)
        elif name == "normal-geom":
            out[name] = jnp.where(v, sp.ng * 0.5 + 0.5, 0.0)
        elif name == "z-depth-abs":
            out[name] = jnp.where(v, sp.t[..., None], 0.0)
        elif name == "z-depth-norm":
            t = sp.t[..., None]
            out[name] = jnp.where(v, t, 0.0)  # normalized at flush
        elif name == "uv":
            out[name] = jnp.where(v, jnp.concatenate(
                [sp.uv, jnp.zeros_like(sp.uv[..., :1])], -1), 0.0)
        elif name == "albedo":
            mp = B.resolve_mp(scene, sp)
            out[name] = jnp.where(v, mp.diffuse_color, 0.0)
        elif name == "mat-index-abs":
            out[name] = jnp.where(v, sp.mat_id[..., None].astype(jnp.float32), 0.0)
        elif name == "obj-index-abs":
            out[name] = jnp.where(v, sp.obj_id[..., None].astype(jnp.float32), 0.0)
        elif name == "emit":
            out[name] = jnp.where(v, common.emitted_radiance(scene, sp, -d), 0.0)
        elif name == "debug-nu":
            out[name] = jnp.where(v, sp.nu * 0.5 + 0.5, 0.0)
        elif name == "debug-nv":
            out[name] = jnp.where(v, sp.nv * 0.5 + 0.5, 0.0)
        elif name == "debug-dpdu":
            out[name] = jnp.where(v, vec.normalize(sp.dp_du) * 0.5 + 0.5, 0.0)
        elif name == "debug-dpdv":
            out[name] = jnp.where(v, vec.normalize(sp.dp_dv) * 0.5 + 0.5, 0.0)
        elif name == "debug-dpdx" and sp.dp_dx is not None:
            # screen-space position differentials (reference DebugDpdx,
            # layer_definitions.h:46; SurfacePoint differentials)
            out[name] = jnp.where(v, vec.normalize(sp.dp_dx) * 0.5 + 0.5, 0.0)
        elif name == "debug-dpdy" and sp.dp_dy is not None:
            out[name] = jnp.where(v, vec.normalize(sp.dp_dy) * 0.5 + 0.5, 0.0)
        elif name == "debug-dpdxy" and sp.dp_dx is not None:
            out[name] = jnp.where(
                v, vec.normalize(sp.dp_dx + sp.dp_dy) * 0.5 + 0.5, 0.0)
        elif name == "debug-dsdu":
            # shading-space tangents (reference dSdU/dSdV, surface.h): the
            # dp_du projected into the bump-mapped shading frame = nu/nv
            out[name] = jnp.where(v, sp.nu * 0.5 + 0.5, 0.0)
        elif name == "debug-dsdv":
            out[name] = jnp.where(v, sp.nv * 0.5 + 0.5, 0.0)
        elif name == "debug-barycentric-uvw" and sp.bary is not None:
            u_, v_ = sp.bary[..., 0], sp.bary[..., 1]
            out[name] = jnp.where(v, jnp.stack(
                [1.0 - u_ - v_, u_, v_], -1), 0.0)
        elif name == "debug-wireframe" and sp.bary is not None:
            u_, v_ = sp.bary[..., 0], sp.bary[..., 1]
            edge = jnp.minimum(jnp.minimum(u_, v_), 1.0 - u_ - v_)
            wire = jnp.clip(1.0 - edge / 0.02, 0.0, 1.0)[..., None]
            out[name] = jnp.where(v, wire * jnp.ones(3), 0.0)
        elif name == "mist":
            out[name] = jnp.where(v, sp.t[..., None], 0.0)
        elif name == "mat-index-norm":
            m = max(scene.materials.num_materials, 1)
            out[name] = jnp.where(
                v, sp.mat_id[..., None].astype(jnp.float32) / m, 0.0)
        elif name == "obj-index-norm":
            m = jnp.maximum(scene.geom.face_obj.max(), 1).astype(jnp.float32)
            out[name] = jnp.where(
                v, sp.obj_id[..., None].astype(jnp.float32) / m, 0.0)
        elif name in ("mat-index-auto", "mat-index-auto-abs",
                      "obj-index-auto", "obj-index-auto-abs"):
            idx = sp.mat_id if name.startswith("mat") else sp.obj_id
            out[name] = jnp.where(v, _auto_index_color(idx), 0.0)
        elif name in ("mat-index-mask", "obj-index-mask"):
            idx, want = ((sp.mat_id, cfg.mask_mat_index)
                         if name.startswith("mat")
                         else (sp.obj_id, cfg.mask_obj_index))
            m = (idx == want)
            if cfg.mask_invert:
                m = ~m
            out[name] = jnp.where(v & m[..., None], jnp.ones(3),
                                  jnp.zeros(3))
        elif name == "debug-uv":
            out[name] = jnp.where(v, jnp.concatenate(
                [sp.uv, jnp.zeros_like(sp.uv[..., :1])], -1), 0.0)
        elif name == "debug-normal-geom":
            out[name] = jnp.where(v, sp.ng * 0.5 + 0.5, 0.0)
        elif name == "debug-normal-smooth":
            out[name] = jnp.where(v, sp.n * 0.5 + 0.5, 0.0)
        elif name == "adv-diffuse-color":
            mp = B.resolve_mp(scene, sp)
            out[name] = jnp.where(v, mp.diffuse_color, 0.0)
        elif name == "adv-glossy-color":
            mp = B.resolve_mp(scene, sp)
            out[name] = jnp.where(v, mp.glossy_color, 0.0)
        elif name == "adv-trans-color":
            mp = B.resolve_mp(scene, sp)
            out[name] = jnp.where(v, mp.filter_color, 0.0)
        elif name == "adv-subsurface-color":
            mp = B.resolve_mp(scene, sp)
            out[name] = jnp.where(
                v, mp.translucency[..., None] * mp.diffuse_color, 0.0)
        elif name == "debug-sampling-factor":
            sf = scene.materials.sampling_factor[sp.mat_id]
            out[name] = jnp.where(v, sf[..., None], 0.0)
        elif name == "debug-dp-lengths":
            out[name] = jnp.where(v, jnp.stack(
                [vec.length(sp.dp_du), vec.length(sp.dp_dv),
                 jnp.zeros_like(sp.t)], -1), 0.0)
        elif name == "debug-dudx-dvdx" and sp.duv_dx is not None:
            out[name] = jnp.where(v, jnp.concatenate(
                [sp.duv_dx, jnp.zeros_like(sp.duv_dx[..., :1])], -1), 0.0)
        elif name == "debug-dudy-dvdy" and sp.duv_dy is not None:
            out[name] = jnp.where(v, jnp.concatenate(
                [sp.duv_dy, jnp.zeros_like(sp.duv_dy[..., :1])], -1), 0.0)
        elif name == "debug-dudxy-dvdxy" and sp.duv_dx is not None:
            duv = sp.duv_dx + sp.duv_dy
            out[name] = jnp.where(v, jnp.concatenate(
                [duv, jnp.zeros_like(duv[..., :1])], -1), 0.0)
        elif name == "ao-clay":
            pass  # filled by the AO estimate in the main loop when do_AO
    return out


def _auto_index_color(idx) -> Array:
    """Deterministic hash color per index (reference *-index-auto layers)."""
    h = (idx.astype(jnp.uint32) * jnp.uint32(0x9E3779B9))
    r = ((h >> 0) & 0x3FF).astype(jnp.float32) / 1023.0
    g = ((h >> 10) & 0x3FF).astype(jnp.float32) / 1023.0
    b = ((h >> 20) & 0x3FF).astype(jnp.float32) / 1023.0
    return jnp.stack([r, g, b], -1)


def _integrate_debug(scene, cfg, ray_o, ray_d, ray_valid):
    """DebugIntegrator (integrator_debug.cc): render normals as color."""
    hit = I.camera_hit(scene, ray_o, ray_d, scene.ray_min_dist, 1e30)
    hit = hit.replace(valid=hit.valid & ray_valid)
    sp = S.make_surface(scene, hit, ray_o, ray_d)
    rgb = jnp.where(sp.valid[..., None], sp.n * 0.5 + 0.5, 0.0)
    alpha = sp.valid.astype(jnp.float32)
    return rgb, alpha, {}
