"""Volume regions + integrators support (src/volume/*, factory volume.cc:41-45:
ExpDensityVolume / GridVolume / NoiseVolume / SkyVolume / UniformVolume).

`build_volume_table` freezes staged volume ParamMaps into the SoA VolumeTable;
`sigma_at` / `tau` are the batched density queries used by the volume
integrators (integrators/volume.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..math import vec
from ..scene_types import SceneData, VolumeTable

Array = jax.Array

VOL_UNIFORM = 0
VOL_EXP = 1
VOL_NOISE = 2
VOL_GRID = 3
VOL_SKY = 4

_VOL_BY_NAME = {
    "UniformVolume": VOL_UNIFORM,
    "ExpDensityVolume": VOL_EXP,
    "NoiseVolume": VOL_NOISE,
    "GridVolume": VOL_GRID,
    "SkyVolume": VOL_SKY,
}


def build_volume_table(builder) -> VolumeTable:
    names = sorted(builder.volumes)
    n = len(names)
    z = lambda: np.zeros((n,), np.float32)
    z3 = lambda: np.zeros((n, 3), np.float32)
    cols = dict(vol_type=np.zeros((n,), np.int32), bmin=z3(), bmax=z3(),
                sigma_a=z3(), sigma_s=z3(), emission=z3(), g=z(),
                params_f=np.zeros((n, 8), np.float32),
                noise_tex=np.full((n,), -1, np.int32),
                grid_id=np.full((n,), -1, np.int32))
    grids = []
    for i, name in enumerate(names):
        pm = builder.volumes[name]
        ty = pm.get_string("type", "UniformVolume")
        cols["vol_type"][i] = _VOL_BY_NAME[ty]
        cols["bmin"][i] = (pm.get_float("minX", -1.0), pm.get_float("minY", -1.0),
                           pm.get_float("minZ", -1.0))
        cols["bmax"][i] = (pm.get_float("maxX", 1.0), pm.get_float("maxY", 1.0),
                           pm.get_float("maxZ", 1.0))
        cols["sigma_a"][i] = pm.get_float("sigma_a", 0.1)
        cols["sigma_s"][i] = pm.get_float("sigma_s", 0.1)
        cols["emission"][i] = pm.get_float("l_e", 0.0)
        cols["g"][i] = pm.get_float("g", 0.0)
        if ty == "ExpDensityVolume":
            cols["params_f"][i, 0] = pm.get_float("a", 1.0)
            cols["params_f"][i, 1] = pm.get_float("b", 1.0)
        elif ty == "NoiseVolume":
            cols["params_f"][i, 0] = pm.get_float("sharpness", 1.0)
            cols["params_f"][i, 1] = pm.get_float("cover", 1.0)
            cols["params_f"][i, 2] = pm.get_float("density", 1.0)
            if pm.get_string("texture", "") in builder.texture_order:
                cols["noise_tex"][i] = builder.texture_order.index(
                    pm.get_string("texture"))
        elif ty == "GridVolume":
            grid = pm.get("grid_data")
            if grid is not None:
                cols["grid_id"][i] = len(grids)
                grids.append(np.asarray(grid, np.float32))
    if grids:
        dmax = max(g.shape[0] for g in grids)
        hmax = max(g.shape[1] for g in grids)
        wmax = max(g.shape[2] for g in grids)
        pool = np.zeros((len(grids), dmax, hmax, wmax), np.float32)
        for gi, g in enumerate(grids):
            pool[gi, :g.shape[0], :g.shape[1], :g.shape[2]] = g
    else:
        pool = np.zeros((1, 1, 1, 1), np.float32)
    return VolumeTable(num_volumes=n, grids=jnp.asarray(pool),
                       **{k: jnp.asarray(v) for k, v in cols.items()})


def density(scene: SceneData, p: Array) -> Array:
    """Total (sigma_s + sigma_a) scalar density multiplier per volume at
    points p, summed over volumes containing p. Returns [N, R] per-region
    density factor in [0, inf)."""
    vt = scene.volumes
    inside = jnp.all((p[:, None, :] >= vt.bmin[None]) &
                     (p[:, None, :] <= vt.bmax[None]), axis=-1)
    ty = vt.vol_type[None, :]
    dens = jnp.ones_like(inside, jnp.float32)
    # exp density: a * exp(-b * height_above_floor) (volume_exp_density.cc)
    a = vt.params_f[None, :, 0]
    b = vt.params_f[None, :, 1]
    h = p[:, None, 2] - vt.bmin[None, :, 2]
    dens = jnp.where(ty == VOL_EXP, a * jnp.exp(-b * h), dens)
    if scene.volumes.grids.shape[0] > 0:
        # trilinear grid lookup (volume_grid.cc)
        rel = (p[:, None, :] - vt.bmin[None]) / jnp.maximum(
            vt.bmax[None] - vt.bmin[None], 1e-9)
        gid = jnp.maximum(vt.grid_id, 0)[None, :]
        g = vt.grids
        D, H, W = g.shape[1], g.shape[2], g.shape[3]
        gx = jnp.clip(rel[..., 0] * (W - 1), 0, W - 1)
        gy = jnp.clip(rel[..., 1] * (H - 1), 0, H - 1)
        gz = jnp.clip(rel[..., 2] * (D - 1), 0, D - 1)
        x0 = gx.astype(jnp.int32)
        y0 = gy.astype(jnp.int32)
        z0 = gz.astype(jnp.int32)
        x1 = jnp.minimum(x0 + 1, W - 1)
        y1 = jnp.minimum(y0 + 1, H - 1)
        z1 = jnp.minimum(z0 + 1, D - 1)
        fx = gx - x0
        fy = gy - y0
        fz = gz - z0
        def at(zz, yy, xx):
            return g[gid, zz, yy, xx]
        c00 = at(z0, y0, x0) * (1 - fx) + at(z0, y0, x1) * fx
        c01 = at(z0, y1, x0) * (1 - fx) + at(z0, y1, x1) * fx
        c10 = at(z1, y0, x0) * (1 - fx) + at(z1, y0, x1) * fx
        c11 = at(z1, y1, x0) * (1 - fx) + at(z1, y1, x1) * fx
        c0 = c00 * (1 - fy) + c01 * fy
        c1 = c10 * (1 - fy) + c11 * fy
        tri = c0 * (1 - fz) + c1 * fz
        dens = jnp.where(ty == VOL_GRID, tri, dens)
    if scene.textures is not None:
        ntex = vt.noise_tex[None, :]
        from ..textures import sample_texture
        # noise volume density from texture intensity (volume_noise.cc)
        has = ntex >= 0
        if True:
            sharp = vt.params_f[None, :, 0]
            cover = vt.params_f[None, :, 1]
            dscale = vt.params_f[None, :, 2]
            # evaluate per (lane, region) — flatten
            N, R = inside.shape
            flat_tex = jnp.broadcast_to(ntex, (N, R)).reshape(-1)
            flat_p = jnp.broadcast_to(p[:, None, :], (N, R, 3)).reshape(-1, 3)
            tex_val = sample_texture(scene, jnp.maximum(flat_tex, 0), flat_p,
                                     flat_p[..., :2])
            inten = jnp.mean(tex_val[..., :3], -1).reshape(N, R)
            nval = jnp.power(jnp.maximum(inten, 1e-6), sharp)
            nval = jnp.maximum(nval + cover - 1.0, 0.0) * dscale
            dens = jnp.where((ty == VOL_NOISE) & has, nval, dens)
    return jnp.where(inside, jnp.maximum(dens, 0.0), 0.0)


def sigma_st(scene: SceneData, p: Array):
    """(sigma_s[N,3], sigma_t[N,3], emission[N,3]) at points p."""
    vt = scene.volumes
    d = density(scene, p)  # [N,R]
    ss = jnp.einsum("nr,rc->nc", d, vt.sigma_s,
                    precision=jax.lax.Precision.HIGHEST)
    sa = jnp.einsum("nr,rc->nc", d, vt.sigma_a,
                    precision=jax.lax.Precision.HIGHEST)
    em = jnp.einsum("nr,rc->nc", d, vt.emission,
                    precision=jax.lax.Precision.HIGHEST)
    return ss, ss + sa, em


def ray_aabb_span(scene: SceneData, o: Array, d: Array, t_max: Array):
    """Entry/exit of rays against the union AABB of all volumes."""
    vt = scene.volumes
    bmin = jnp.min(vt.bmin, axis=0)
    bmax = jnp.max(vt.bmax, axis=0)
    from ..math import bound
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    hit, t0, t1 = bound.ray_slab(bmin, bmax, o, inv_d,
                                 jnp.zeros_like(t_max), t_max)
    return hit, jnp.maximum(t0, 0.0), jnp.minimum(t1, t_max)
