"""Render orchestration: pixels -> camera rays -> integrator -> film.

Replaces the reference render driver (Scene::render scene.cc:203-263 +
TiledIntegrator::render/renderPass/renderTile, integrator_tiled.cc:50-358):
no tile queue or thread pool — the whole image (or a shard of it) is one
megabatch of rays per sample pass, jitted once and re-run per pass. Adaptive
AA resampling (ImageFilm::nextPass noise flags, imagefilm.cc:259-445) is a
masked weight on later passes instead of a pixel work-list.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .utils import struct

from . import color as C
from . import film as F
from . import sampler
from .cameras import shoot_rays
from .integrators.mc import IntegratorConfig, integrate
from .scene_types import SceneData

Array = jax.Array


@struct.dataclass
class AAParams:
    """Adaptive-AA settings (Scene::setupSceneRenderParams AA params,
    scene.cc:582-610)."""
    aa_samples: int = struct.field(pytree_node=False, default=1)
    aa_passes: int = struct.field(pytree_node=False, default=1)
    aa_inc_samples: int = struct.field(pytree_node=False, default=1)
    threshold: float = struct.field(pytree_node=False, default=0.05)
    # noise-detection extras (AaNoiseParams, scene.cc:582-610)
    dark_detection_type: str = struct.field(pytree_node=False,
                                            default="none")  # none|linear|curve
    dark_threshold_factor: float = struct.field(pytree_node=False, default=0.0)
    detect_color_noise: bool = struct.field(pytree_node=False, default=False)
    variance_edge_size: int = struct.field(pytree_node=False, default=10)
    variance_pixels: int = struct.field(pytree_node=False, default=0)


def _render_ids(scene: SceneData, cfg: IntegratorConfig, film: F.Film,
                sample_idx: Array, pixel_id: Array, live: Array) -> F.Film:
    """Render one sample for each pixel id in `pixel_id` (uint32 [M]) and
    accumulate into the film; `live` masks padding lanes. Sampling is
    keyed purely by (pixel_id, sample_idx) so a compacted adaptive pass
    produces bit-identical samples to a full pass at the same indices."""
    h, w = film.height, film.width
    cam = scene.camera
    # per-host decorrelated sample stream (adv_base_sampling_offset analogue)
    s_idx = jnp.asarray(sample_idx, jnp.uint32) + jnp.uint32(
        film.base_sampling_offset)
    xx = (pixel_id % jnp.uint32(w)).astype(jnp.int32)
    yy = (pixel_id // jnp.uint32(w)).astype(jnp.int32)

    # pixel jitter: Owen-scrambled (0,2)-sequence per pixel
    scramble = sampler.pcg4d(jnp.stack(
        [pixel_id, jnp.full_like(pixel_id, 0x9E3779B9),
         jnp.full_like(pixel_id, 7), jnp.full_like(pixel_id, 11)], -1))[..., 0]
    ju, jv = sampler.ld02(s_idx, scramble)
    px = xx.astype(jnp.float32) + ju
    py = yy.astype(jnp.float32) + jv
    # lens samples via Halton(3,5) like the reference (integrator_tiled.cc:348)
    lens_u = sampler.rand1(pixel_id, s_idx, 0, 777)
    lens_v = sampler.rand1(pixel_id, s_idx, 0, 778)

    o, d, valid = shoot_rays(cam, px, py, lens_u, lens_v)
    valid = valid & live
    rgb, alpha, aux = integrate(scene, cfg, o, d, valid, pixel_id, s_idx)

    weight = valid.astype(jnp.float32)
    # light-tracing splats (BDPT t=0): separate accumulator, normalized by
    # light-subpath count at resolve rather than by filter weights. The
    # count is the number of lanes that actually traced a light subpath
    # (integrate_bidir masks the light walk by `valid`) — NOT height*width,
    # which under-weighted splats whenever a compacted adaptive pass traced
    # fewer lanes than the full image.
    if "splat_px" in aux:
        film = F.add_splats(film, aux.pop("splat_px"), aux.pop("splat_py"),
                            aux.pop("splat_rgb"),
                            n_paths=jnp.sum(weight))
    layer_vals: Dict[str, Array] = {
        "combined": jnp.concatenate([rgb, alpha[..., None]], axis=-1)}
    for name, val in aux.items():
        layer_vals[name] = val
    # drop aux layers the film doesn't carry
    layer_vals = {k: v for k, v in layer_vals.items() if k in film.layers}
    return F.add_samples(film, px, py, layer_vals, weight)


def render_pass_fn(scene: SceneData, cfg: IntegratorConfig, film: F.Film,
                   sample_idx: Array, resample_mask: Optional[Array] = None
                   ) -> F.Film:
    """Render one sample per (active) pixel and accumulate into the film.
    Pure function of (scene, film, sample_idx) — jit with static cfg."""
    h, w = film.height, film.width
    pixel_id = jnp.arange(h * w, dtype=jnp.uint32)
    live = jnp.ones((h * w,), bool)
    if resample_mask is not None:
        live = live & (resample_mask.reshape(-1) > 0)
    return _render_ids(scene, cfg, film, sample_idx, pixel_id, live)


@functools.partial(jax.jit, static_argnums=(1,), donate_argnums=(2,))
def _render_pass_jit(scene, cfg, film, sample_idx, resample_mask):
    return render_pass_fn(scene, cfg, film, sample_idx, resample_mask)


@functools.partial(jax.jit, static_argnums=(1,), donate_argnums=(2,))
def _render_ids_jit(scene, cfg, film, sample_idx, pixel_id, live):
    return _render_ids(scene, cfg, film, sample_idx, pixel_id, live)


# darkThresholdCurveInterpolate (imagefilm.cc:799-816) as interp knots:
# a piecewise-linear map from pixel brightness to the AA threshold.
# Kept as NUMPY arrays: a module-scope jnp constant would initialize the
# XLA backend at import time, which breaks jax.distributed.initialize()
# in the multi-host entry point (parallel/distributed.py).
_DARK_CURVE_X = np.asarray([0.10, 0.20, 0.30, 0.40, 0.50, 0.60, 0.70,
                            0.80, 0.90, 1.00, 1.20, 1.40, 1.80],
                           np.float32)
_DARK_CURVE_Y = np.asarray([0.0001, 0.0010, 0.0020, 0.0035, 0.0055,
                            0.0075, 0.0100, 0.0150, 0.0250, 0.0400,
                            0.0800, 0.0950, 0.1000], np.float32)


def _shift_edge(img: Array, dy: int, dx: int) -> Array:
    """Shift with edge replication (so border pixels compare against
    themselves -> zero difference, matching the reference's x<width-1
    bounded loops rather than wraparound)."""
    pad = jnp.pad(img, ((1, 1), (1, 1)) + ((0, 0),) * (img.ndim - 2),
                  mode="edge")
    h, w = img.shape[:2]
    return pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def compute_resample_mask(film: F.Film, aa: "AAParams") -> Array:
    """Adaptive-AA noise detection (ImageFilm::nextPass,
    imagefilm.cc:300-426), all three reference criteria vectorized:

    1. per-pixel threshold scaled by brightness — dark detection "linear"
       (thr * ((1-f) + bri*f)) or "curve" (darkThresholdCurveInterpolate);
    2. color difference vs the 4 forward neighbors (x+1,y), (x,y+1),
       (x+1,y+1), (x-1,y+1), flagging both pixels of a noisy pair;
    3. variance window — count row/column neighbor-pair differences over
       threshold inside a variance_edge_size window; if the count reaches
       variance_pixels, flag the whole window.  (The reference evaluates
       every pair against the *center* pixel's scaled threshold; here each
       pair uses its own local threshold — the thresholds vary smoothly so
       the flagged sets match to within a pixel.)

    Unrendered pixels (weight 0 after a film reload) are always flagged.
    """
    img = F.resolve(film, "combined")[..., :3]
    bri = (0.2126 * jnp.abs(img[..., 0]) + 0.7152 * jnp.abs(img[..., 1])
           + 0.0722 * jnp.abs(img[..., 2]))  # Rgb::abscol2Bri
    if aa.dark_detection_type == "linear" and aa.dark_threshold_factor > 0:
        f = aa.dark_threshold_factor
        thr = aa.threshold * ((1.0 - f) + bri * f)
    elif aa.dark_detection_type == "curve":
        thr = jnp.interp(bri, _DARK_CURVE_X, _DARK_CURVE_Y)
    else:
        thr = jnp.full_like(bri, aa.threshold)

    def cdiff(a, b):
        # Rgba::colorDifference (color.h:450-468): luminance difference,
        # optionally maxed with per-channel differences
        la = 0.2126 * a[..., 0] + 0.7152 * a[..., 1] + 0.0722 * a[..., 2]
        lb = 0.2126 * b[..., 0] + 0.7152 * b[..., 1] + 0.0722 * b[..., 2]
        d = jnp.abs(la - lb)
        if aa.detect_color_noise:
            d = jnp.maximum(d, jnp.max(jnp.abs(a - b), axis=-1))
        return d

    mask = film.weights.reshape(img.shape[:2]) <= 0.0
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        nb = _shift_edge(img, dy, dx)
        noisy = cdiff(img, nb) >= thr
        mask = mask | noisy
        # flag the neighbor of each noisy pair too (flags_.set on both)
        mask = mask | (_shift_edge(noisy[..., None].astype(jnp.float32),
                                   -dy, -dx)[..., 0] > 0.5)

    if aa.variance_pixels > 0:
        half = max(aa.variance_edge_size // 2, 1)
        ex = (cdiff(img, _shift_edge(img, 0, 1)) >= thr).astype(jnp.float32)
        ey = (cdiff(img, _shift_edge(img, 1, 0)) >= thr).astype(jnp.float32)
        win = 2 * half - 1
        cnt = (jax.lax.reduce_window(ex, 0.0, jax.lax.add, (1, win), (1, 1),
                                     "SAME")
               + jax.lax.reduce_window(ey, 0.0, jax.lax.add, (win, 1),
                                       (1, 1), "SAME"))
        vflag = cnt >= aa.variance_pixels
        # flag the whole window around each trigger (2*half x 2*half box)
        box = 2 * half
        vflag = jax.lax.reduce_window(vflag.astype(jnp.float32), 0.0,
                                      jax.lax.max, (box, box), (1, 1),
                                      "SAME") > 0.5
        mask = mask | vflag

    return mask.astype(jnp.float32)


def render(scene: SceneData, cfg: IntegratorConfig, width: Optional[int] = None,
           height: Optional[int] = None,
           spp: int = 16, aa: Optional[AAParams] = None,
           layer_names: Tuple[str, ...] = ("combined",),
           flt_kind: str = "box", flt_width: float = 1.0,
           computer_node: int = 0, film: Optional[F.Film] = None,
           start_sample: int = 0,
           progress_cb=None,
           film_path: Optional[str] = None,
           film_load_save_mode: str = "none",
           film_autosave_interval_passes: int = 0,
           photon_maps_processing: str = "generate",
           photon_map_path: Optional[str] = None,
           render_control=None, stats=None) -> F.Film:
    """Multi-pass render loop (TiledIntegrator::render analogue).

    width/height default to the camera's resx/resy; passing a different
    size renders a crop of the camera frame (the film addresses camera
    pixels 1:1, like the reference's region renders)."""
    if width is None:
        width = scene.camera.resx
    if height is None:
        height = scene.camera.resy
    # film resume (reference film_load_save_mode load-save,
    # imagefilm.cc:827-938 + resumed-render offset, integrator_tiled.cc:155)
    if film is None and film_path is not None and film_load_save_mode in (
            "load", "load-save"):
        import os
        if os.path.exists(film_path):
            film, start_sample = F.load_film(film_path)
            if render_control is not None:
                render_control.set_resumed()
    if film is None:
        film = F.make_film(width, height, layer_names, flt_kind, flt_width,
                           computer_node)
    cfg = cfg.replace(aov_layers=tuple(n for n in layer_names
                                       if n not in ("combined",)))
    # photon-map preprocess (SurfaceIntegrator::preprocess analogue,
    # integrator_photon_mapping.cc:242; processing modes generate /
    # generate-save / load / reuse-previous, :790-846)
    # per-light volume attenuation grid cache ("optimize" mode,
    # integrator_single_scatter.cc:35-108)
    if (scene.volumes is not None and cfg.vol_kind == "single_scatter"
            and cfg.vol_optimize and scene.vol_atten is None
            and scene.lights.num_lights > 0):
        from .integrators.volume import build_attenuation_grid
        scene = scene.replace(vol_atten=jax.jit(build_attenuation_grid)(scene))
    if cfg.kind == "photonmapping" and scene.photons is None:
        from . import photon as PH
        from .scene_types import PhotonData
        import os
        if (photon_maps_processing in ("load", "reuse-previous")
                and photon_map_path is not None
                and os.path.exists(photon_map_path)):
            scene = scene.replace(photons=PH.load_maps(photon_map_path))
        else:
            dmap, cmap, rcache, n_emit, _ = jax.jit(
                lambda s: PH.make_maps(s, cfg.n_photons, cfg.n_photons,
                                       cfg.pm_bounces, cfg.pm_radius,
                                       final_gather=cfg.final_gather),
                static_argnums=())(scene)
            scene = scene.replace(photons=PhotonData(
                diffuse=dmap, caustic=cmap, radiance=rcache,
                n_emitted=cfg.n_photons))
            if (photon_maps_processing == "generate-save"
                    and photon_map_path is not None):
                PH.save_maps(scene.photons, photon_map_path)
    if aa is None:
        aa = AAParams(aa_samples=spp, aa_passes=1)
    ones = jnp.ones((height, width), jnp.float32)
    s = start_sample

    def autosave(s_now):
        if (film_path is not None and film_autosave_interval_passes > 0
                and film_load_save_mode in ("save", "load-save")
                and s_now % film_autosave_interval_passes == 0):
            F.save_film(film, film_path, sampling_offset=s_now)

    def canceled():
        return render_control is not None and render_control.canceled

    if render_control is not None:
        render_control.set_started()
    total = aa.aa_samples + (aa.aa_passes - 1) * aa.aa_inc_samples
    if stats is not None:
        stats.start("rendert")
    # pass 1: aa_samples samples everywhere
    for i in range(aa.aa_samples):
        if canceled():
            break
        if stats is not None:
            stats.begin_pass()
        film = _render_pass_jit(scene, cfg, film, jnp.uint32(s), ones)
        if stats is not None:
            jax.block_until_ready(film.weights)
            stats.end_pass(width * height)
        s += 1
        autosave(s)
        if progress_cb:
            progress_cb(s, total)
        if render_control is not None:
            render_control.set_progress(s / max(total, 1))
    # additional adaptive passes resample flagged pixels only. Unlike the
    # reference's per-tile flag checks (imagefilm.cc:259-445) the flagged
    # pixels are COMPACTED into a short wavefront (padded to a power-of-two
    # bucket to bound recompiles), so later passes cost ~ the flagged
    # fraction of a full pass instead of tracing every pixel with a masked
    # weight.
    n_pix = height * width
    for p in range(1, aa.aa_passes):
        if canceled():
            break
        mask = compute_resample_mask(film, aa)
        ids = np.flatnonzero(np.asarray(mask).reshape(-1) > 0)
        n_resample = ids.size
        if n_resample == 0:
            break  # converged: reference stops flagging too
        if n_resample >= n_pix // 2:
            ids_pad = None  # full pass is cheaper than compaction overhead
        else:
            m = 1 << max(int(np.ceil(np.log2(max(n_resample, 1)))), 8)
            m = min(m, n_pix)
            ids_pad = np.zeros((m,), np.uint32)
            ids_pad[:n_resample] = ids
            live = np.zeros((m,), bool)
            live[:n_resample] = True
            ids_dev = jnp.asarray(ids_pad)
            live_dev = jnp.asarray(live)
        for i in range(aa.aa_inc_samples):
            if stats is not None:
                stats.begin_pass()
            if ids_pad is None:
                film = _render_pass_jit(scene, cfg, film, jnp.uint32(s), mask)
            else:
                film = _render_ids_jit(scene, cfg, film, jnp.uint32(s),
                                       ids_dev, live_dev)
            if stats is not None:
                jax.block_until_ready(film.weights)
                stats.end_pass(n_resample)
            s += 1
            autosave(s)
        if progress_cb:
            progress_cb(s, total)
        if render_control is not None:
            render_control.set_progress(s / max(total, 1))
    if (film_path is not None
            and film_load_save_mode in ("save", "load-save")):
        F.save_film(film, film_path, sampling_offset=s)
    if render_control is not None and not canceled():
        render_control.set_finished()
    if stats is not None:
        stats.stop("rendert")
    return film
