"""Pallas (Triton) kernel: fused Möller-Trumbore brute scan for the GPU.

The jnp brute-force intersect (ops/intersect.py `_brute_closest`, the
AcceleratorSimpleTest analogue — src/accelerator/accelerator_simple_test.cc)
materialises [N_rays, chunk] t/u/v per triangle chunk, then an argmin and
three gathers. This kernel gives each ray one lane and walks the whole
triangle table with the best t / prim / u / v in registers: rays are read
once and hit records written once (~40 B/ray in, 16 B/ray out), and no
[N, chunk] intermediate ever reaches device memory.

Layout:
  rays  f32[16, N]: rows 0-2 origin, 3-5 direction, 6 t_min, 7 t_max,
                    8 exclude-prim-id (as f32; exact for ids < 2^24),
                    9 shutter time (motion blur), rest padding.
                    Component-major, so a block's loads are coalesced.
  tris  f32[F, 16]: cols 0-8 v0|v1|v2, col 9 camera-vis, col 10 shadow-vis
                    (0/1 floats), col 11 prim id as f32, cols 12.. unused.
                    Every lane of a block reads the same triangle, so the
                    row is served from L1.
  tris_t1 / tris_t2 (optional) f32[F, 16]: the motion keyframes' vertices
                    (linear lerp with t1 only, the reference's quadratic
                    b-spline with t2 — primitive_triangle_bspline.cc:40-44).

Grid: one program per RAY_BLOCK rays. Triangles are visited in index
order and a hit replaces the best only when strictly closer, so on an
exact t tie the lowest prim id wins — the jnp scan's argmin tie-break.
Shadow (any-hit) queries run the same closest-hit loop: an early exit
once every lane of a block has hit (a while loop with a block-wide
reduction per triangle) measured slower on an H100 (700 W) at both 36 and
2,047 triangles than visiting every triangle.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

RAY_BLOCK = 128     # rays per program: one lane each (4 warps)
NUM_WARPS = 4
NUM_STAGES = 1      # the triangle loop carries no pipelined loads

EPS_DET = 1e-10


def _mt_kernel(rays_ref, tris_ref, *refs, n_tris: int, vis_col: int,
               motion: int):
    """One block of rays against the whole triangle table."""
    tris_t1_ref = refs[0] if motion >= 1 else None
    tris_t2_ref = refs[1] if motion == 2 else None
    t_ref, id_ref, u_ref, v_ref = refs[motion:]
    ox, oy, oz = rays_ref[0, :], rays_ref[1, :], rays_ref[2, :]
    dx, dy, dz = rays_ref[3, :], rays_ref[4, :], rays_ref[5, :]
    t_min, t_max, excl = rays_ref[6, :], rays_ref[7, :], rays_ref[8, :]
    tt = rays_ref[9, :] if motion else None

    def vert(i, j):
        c = tris_ref[i, j]
        if motion == 2:
            tc = 1.0 - tt
            return (c * (tc * tc) + tris_t1_ref[i, j] * (2.0 * tt * tc)
                    + tris_t2_ref[i, j] * (tt * tt))
        if motion == 1:
            return c * (1.0 - tt) + tris_t1_ref[i, j] * tt
        return c

    def test(i, carry):
        best_t, best_id, best_u, best_v = carry
        ax, ay, az = vert(i, 0), vert(i, 1), vert(i, 2)
        e1x, e1y, e1z = vert(i, 3) - ax, vert(i, 4) - ay, vert(i, 5) - az
        e2x, e2y, e2z = vert(i, 6) - ax, vert(i, 7) - ay, vert(i, 8) - az
        vis = tris_ref[i, vis_col]
        pid = tris_ref[i, 11]
        # pvec = d x e2
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        ok = jnp.abs(det) > EPS_DET
        inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
        # tvec = o - v0
        tvx, tvy, tvz = ox - ax, oy - ay, oz - az
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        # qvec = tvec x e1
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > t_min) & (t < best_t) & (vis > 0.5) & (pid != excl))
        return (jnp.where(hit, t, best_t), jnp.where(hit, pid, best_id),
                jnp.where(hit, u, best_u), jnp.where(hit, v, best_v))

    init = (t_max, jnp.full_like(t_max, -1.0), jnp.zeros_like(t_max),
            jnp.zeros_like(t_max))
    best_t, best_id, best_u, best_v = jax.lax.fori_loop(
        0, n_tris, test, init)
    t_ref[:] = best_t
    id_ref[:] = best_id
    u_ref[:] = best_u
    v_ref[:] = best_v


def pack_tris(v0, v1, v2, face_vis):
    """Build the f32[F, 16] triangle table."""
    f = v0.shape[0]
    vis = face_vis.astype(jnp.int32)
    return jnp.concatenate([
        v0, v1, v2,
        ((vis & 1) != 0).astype(jnp.float32)[:, None],
        ((vis & 2) != 0).astype(jnp.float32)[:, None],
        jnp.arange(f, dtype=jnp.float32)[:, None],
        jnp.zeros((f, 4), jnp.float32)], axis=1)


def pack_rays(o, d, t_min, t_max, exclude, time=None):
    """Component-major f32[16, Npad] ray table (Npad a RAY_BLOCK multiple;
    padded rays get an empty t-range)."""
    n = o.shape[0]
    npad = -(-n // RAY_BLOCK) * RAY_BLOCK
    cols = [o.T, d.T, t_min[None], t_max[None],
            exclude.astype(jnp.float32)[None],
            (jnp.zeros((1, n), jnp.float32) if time is None
             else jnp.asarray(time, jnp.float32)[None]),
            jnp.zeros((6, n), jnp.float32)]
    rays = jnp.concatenate(cols, axis=0)
    if npad != n:
        fill = jnp.zeros((16, npad - n), jnp.float32).at[7].set(-1.0)
        rays = jnp.concatenate([rays, fill], axis=1)
    return rays


@functools.partial(jax.jit, static_argnames=("shadow", "interpret"))
def mt_query(tris, o, d, t_min, t_max, exclude, time=None, tris_t1=None,
             tris_t2=None, *, shadow: bool = False, interpret: bool = False):
    """Closest hit of rays against a packed triangle table.

    Args: tris f32[F,16] (pack_tris); o,d f32[N,3]; t_min/t_max/exclude [N];
    optional time f32[N] + tris_t1 (linear motion blur) + tris_t2
    (quadratic b-spline motion blur with 3 control points); `shadow`
    tests the shadow-visibility column instead of the camera one.
    Returns (t f32[N] (t_max on a miss), prim i32[N] (-1 = miss), u, v).
    """
    n = o.shape[0]
    motion = 0
    if time is not None and tris_t1 is not None:
        motion = 2 if tris_t2 is not None else 1
    rays = pack_rays(o, d, t_min, t_max, exclude,
                     time if motion else None)
    npad = rays.shape[1]
    kernel = functools.partial(
        _mt_kernel, n_tris=tris.shape[0], vis_col=10 if shadow else 9,
        motion=motion)
    tables = (tris, tris_t1, tris_t2)[:motion + 1]
    whole = pl.BlockSpec(memory_space=pl.ANY)
    vec_spec = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    vec_shape = jax.ShapeDtypeStruct((npad,), jnp.float32)
    out_t, out_id, out_u, out_v = pl.pallas_call(
        kernel,
        grid=(npad // RAY_BLOCK,),
        in_specs=[pl.BlockSpec((16, RAY_BLOCK), lambda i: (0, i))]
        + [whole] * len(tables),
        out_specs=(vec_spec,) * 4,
        out_shape=(vec_shape,) * 4,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="mt_query",
    )(rays, *tables)
    return out_t[:n], out_id[:n].astype(jnp.int32), out_u[:n], out_v[:n]
