"""Multi-device / multi-host scaling: shard_map over a device mesh.

Replacement for the reference's two parallelism layers (SURVEY.md §2.15):

  - tile data-parallelism — N std::thread workers pulling 32-px tiles from a
    mutex work queue (src/integrator/surface/integrator_tiled.cc:246-264,
    src/render/imagefilm.cc:447 `nextArea`): here the *pixel batch axis* is
    sharded over the mesh with `shard_map`; there is no work queue because
    every lane costs the same (masked wavefront, no divergence).
  - render-farm film merge — per-node `.film` files summed on disk
    (imageFilmLoadAllInFolder, imagefilm.cc:940-1008) with per-node
    decorrelated sample offsets (`adv_base_sampling_offset`,
    src/scene/scene.cc:608-609): here the film merge is a `psum` over the
    mesh (the all-reduce *is* the film merge), and stream decorrelation
    comes free from the counter-based sampler keyed on absolute pixel id.

Gradients of scene parameters (inverse rendering) are all-reduced by the
same `psum` — one collective per training step. The mesh is 1-D: the
cards of a host are joined all to all (NVLink), so no device order is
better than another.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .. import film as F
from .. import sampler
from ..cameras import shoot_rays
from ..integrators.mc import IntegratorConfig, integrate
from ..scene_types import SceneData

Array = jax.Array

BATCH_AXIS = "batch"


def make_mesh(n_devices: Optional[int] = None,
              devices=None) -> Mesh:
    """1-D data-parallel mesh over the ray/pixel batch axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (BATCH_AXIS,))


def _pixel_shard_radiance(scene: SceneData, cfg: IntegratorConfig,
                          px: Array, py: Array, pixel_id: Array,
                          sample_idx: Array):
    """Per-shard body: camera rays -> integrator. Pure function of the
    absolute pixel ids, so any shard layout gives identical values."""
    lens_u = sampler.rand1(pixel_id, sample_idx, 0, 777)
    lens_v = sampler.rand1(pixel_id, sample_idx, 0, 778)
    o, d, valid = shoot_rays(scene.camera, px, py, lens_u, lens_v)
    rgb, alpha, _ = integrate(scene, cfg, o, d, valid, pixel_id, sample_idx)
    return rgb, alpha, valid


def render_wavefront_sharded(scene: SceneData, cfg: IntegratorConfig,
                             height: int, width: int, sample_idx: Array,
                             mesh: Mesh) -> Tuple[Array, Array]:
    """One sample per pixel with the pixel batch sharded over the mesh.

    Returns (rgb[H*W,3], alpha[H*W]) fully replicated (all_gather'd by the
    out_specs); callers accumulate into a Film. The pixel count must divide
    by the mesh size — pad the film if needed."""
    n_dev = mesh.shape[BATCH_AXIS]
    n_pix = height * width
    if n_pix % n_dev != 0:
        raise ValueError(f"{n_pix} pixels not divisible by {n_dev} devices")
    yy, xx = jnp.meshgrid(jnp.arange(height), jnp.arange(width), indexing="ij")
    pixel_id = (yy * width + xx).reshape(-1).astype(jnp.uint32)
    scramble = sampler.pcg4d(jnp.stack(
        [pixel_id, jnp.full_like(pixel_id, 0x9E3779B9),
         jnp.full_like(pixel_id, 7), jnp.full_like(pixel_id, 11)], -1))[..., 0]
    s_idx = jnp.asarray(sample_idx, jnp.uint32)
    ju, jv = sampler.ld02(s_idx, scramble)
    px = xx.reshape(-1).astype(jnp.float32) + ju
    py = yy.reshape(-1).astype(jnp.float32) + jv

    spec_scene = jax.tree_util.tree_map(lambda _: P(), scene)
    fn = shard_map(
        lambda scene, px, py, pid, sidx: _pixel_shard_radiance(
            scene, cfg, px, py, pid, sidx),
        mesh=mesh,
        in_specs=(spec_scene, P(BATCH_AXIS), P(BATCH_AXIS), P(BATCH_AXIS), P()),
        out_specs=(P(BATCH_AXIS), P(BATCH_AXIS), P(BATCH_AXIS)),
        check_vma=False,
    )
    rgb, alpha, valid = fn(scene, px, py, pixel_id, s_idx)
    return rgb, alpha


@functools.partial(jax.jit, static_argnums=(1, 3, 4, 5),
                   donate_argnums=(2,))
def _sharded_pass(scene: SceneData, cfg: IntegratorConfig, film: F.Film,
                  height: int, width: int, mesh: Mesh, s: Array) -> F.Film:
    """One sharded sample pass accumulated into the film (jitted once per
    scene structure, config, size and mesh; the scene is an argument, not
    a baked-in constant)."""
    rgb, alpha = render_wavefront_sharded(scene, cfg, height, width, s, mesh)
    img = jnp.concatenate([rgb, alpha[..., None]], -1)
    yy, xx = jnp.meshgrid(jnp.arange(height), jnp.arange(width),
                          indexing="ij")
    return F.add_samples(film, xx.reshape(-1).astype(jnp.float32) + 0.5,
                         yy.reshape(-1).astype(jnp.float32) + 0.5,
                         {"combined": img},
                         jnp.ones((height * width,), jnp.float32))


def render_sharded(scene: SceneData, cfg: IntegratorConfig, width: int,
                   height: int, spp: int, mesh: Mesh,
                   film: Optional[F.Film] = None) -> F.Film:
    """Multi-pass sharded render accumulating into a film (the sharded
    analogue of render.render)."""
    if film is None:
        film = F.make_film(width, height, ("combined",))
    with mesh:
        for s in range(spp):
            film = _sharded_pass(scene, cfg, film, height, width, mesh,
                                 jnp.uint32(s))
    return film


# ---------------------------------------------------------------------------
# Differentiable training step (inverse rendering) over the mesh
# ---------------------------------------------------------------------------

def make_train_step(cfg: IntegratorConfig, height: int, width: int,
                    mesh: Mesh, lr: float = 0.05):
    """Build a jitted SGD step on differentiable material parameters.

    The loss is the image MSE of one rendered sample pass against a target;
    pixels are sharded over the mesh (dp), the scalar loss and the parameter
    gradients are `psum`'d — the gradient all-reduce is the only
    collective. Returns step(scene, params, target, sample_idx) ->
    (params, loss) where params is a dict of MaterialTable field overrides
    (e.g. {"diffuse_color": f32[M,3]})."""

    def loss_shard(params, scene, px, py, pixel_id, target, sample_idx):
        mats = scene.materials.replace(**params)
        scene = scene.replace(materials=mats)
        rgb, _, _ = _pixel_shard_radiance(scene, cfg, px, py, pixel_id,
                                          sample_idx)
        err = jnp.mean((rgb - target) ** 2)
        return jax.lax.pmean(err, BATCH_AXIS)

    spec_rep = P()

    @functools.partial(jax.jit, static_argnames=())
    def step(scene: SceneData, params, target: Array, sample_idx: Array):
        n_pix = height * width
        yy, xx = jnp.meshgrid(jnp.arange(height), jnp.arange(width),
                              indexing="ij")
        pixel_id = (yy * width + xx).reshape(-1).astype(jnp.uint32)
        px = xx.reshape(-1).astype(jnp.float32) + 0.5
        py = yy.reshape(-1).astype(jnp.float32) + 0.5

        spec_scene = jax.tree_util.tree_map(lambda _: P(), scene)
        spec_params = jax.tree_util.tree_map(lambda _: P(), params)

        def shard_body(params, scene, px, py, pid, target, sidx):
            loss, grads = jax.value_and_grad(loss_shard)(
                params, scene, px, py, pid, target, sidx)
            # psum of grads: each shard saw 1/n of the pixels; pmean in the
            # loss already averages, so grads need the mean across shards
            grads = jax.tree_util.tree_map(
                lambda g: jax.lax.pmean(g, BATCH_AXIS), grads)
            return loss, grads

        fn = shard_map(
            shard_body, mesh=mesh,
            in_specs=(spec_params, spec_scene, P(BATCH_AXIS), P(BATCH_AXIS),
                      P(BATCH_AXIS), P(BATCH_AXIS), spec_rep),
            out_specs=(P(), jax.tree_util.tree_map(lambda _: P(), params)),
            check_vma=False,
        )
        loss, grads = fn(params, scene, px, py, pixel_id,
                         target.reshape(n_pix, 3),
                         jnp.asarray(sample_idx, jnp.uint32))
        new_params = jax.tree_util.tree_map(
            lambda p, g: p - lr * g, params, grads)
        return new_params, loss

    return step
