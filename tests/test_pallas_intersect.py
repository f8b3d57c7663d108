"""Pallas (Triton) fused Möller-Trumbore kernel vs the jnp scan reference.

The kernel runs in interpret mode here, so these tests need no card; the
compiled kernel is compared with the scan on the GPU by chip_smoke.py.
ops/intersect.py picks the kernel for computations lowered for CUDA and
the jnp scan everywhere else (no runtime probe, no fallback).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libyafaray_tpu.accel import pallas_intersect as PI
from libyafaray_tpu.accel.pallas_intersect import mt_query, pack_tris
from libyafaray_tpu.ops import intersect as I
from libyafaray_tpu.scene_types import Geometry


def _random_geom(rng, f, motion=False, motion2=False):
    vtx = rng.standard_normal((f * 3, 3)).astype(np.float32)
    faces = np.arange(f * 3, dtype=np.int32).reshape(f, 3)
    vis = np.full(f, 3, np.int32)
    vis[::7] = 2   # camera-invisible
    vis[::11] = 1  # casts no shadow
    z = jnp.zeros

    def key():
        return jnp.asarray(
            vtx + rng.standard_normal(vtx.shape).astype(np.float32) * 0.3)
    return Geometry(
        vertices=jnp.asarray(vtx), normals=jnp.asarray(vtx),
        uvs=z((1, 2)), faces=jnp.asarray(faces),
        face_uvs=z((f, 3), jnp.int32), face_mat=z(f, jnp.int32),
        face_obj=z(f, jnp.int32), face_smooth=z(f, bool),
        face_light=jnp.full(f, -1, jnp.int32),
        sph_center=z((0, 3)), sph_radius=z(0), sph_mat=z(0, jnp.int32),
        sph_obj=z(0, jnp.int32), sph_light=z(0, jnp.int32),
        obj_visibility=z(1, jnp.int32), face_vis=jnp.asarray(vis),
        sph_vis=z(0, jnp.int32),
        vertices_t1=key() if motion else None,
        vertices_t2=key() if motion2 else None,
        num_faces=f, num_spheres=0, has_motion=motion)


def _rays(rng, n):
    o = rng.standard_normal((n, 3)).astype(np.float32) * 2
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _tables(geom):
    fc = geom.faces
    return [pack_tris(vt[fc[:, 0]], vt[fc[:, 1]], vt[fc[:, 2]], geom.face_vis)
            for vt in (geom.vertices, geom.vertices_t1, geom.vertices_t2)
            if vt is not None]


def _check(ref, bt, bp, bu, bv, rtol=1e-5):
    valid = np.asarray(bp >= 0)
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    np.testing.assert_array_equal(np.asarray(bp)[valid],
                                  np.asarray(ref.prim)[valid])
    np.testing.assert_allclose(np.asarray(bt)[valid],
                               np.asarray(ref.t)[valid], rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(
        np.stack([np.asarray(bu), np.asarray(bv)], -1)[valid],
        np.asarray(ref.uv)[valid], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shadow", [False, True])
def test_kernel_matches_scan_oracle(rng, shadow):
    f, n = 300, 2048
    geom = _random_geom(rng, f)
    o, d = _rays(rng, n)
    t_min = jnp.full(n, 1e-4)
    t_max = jnp.full(n, 1e30)
    excl = jnp.full(n, -1, jnp.int32).at[::5].set(7)

    ref = I._brute_closest(geom, o, d, t_min, t_max, excl, shadow=shadow)
    out = mt_query(_tables(geom)[0], o, d, t_min, t_max, excl,
                   shadow=shadow, interpret=True)
    _check(ref, *out)


def test_kernel_tie_break_is_self_consistent():
    """Ray hitting the exact shared edge of two triangles: the kernel must
    return the LOWEST prim id among the tied winners with u/v taken from that
    same triangle (matching the scan oracle's argmin), not a mix."""
    # two triangles in the z=1 plane sharing the edge x=0, y in [-1,1]
    v0 = jnp.asarray([[0.0, -1.0, 1.0], [0.0, -1.0, 1.0]], jnp.float32)
    v1 = jnp.asarray([[0.0, 1.0, 1.0], [1.0, -1.0, 1.0]], jnp.float32)
    v2 = jnp.asarray([[-1.0, -1.0, 1.0], [0.0, 1.0, 1.0]], jnp.float32)
    vis = jnp.asarray([3, 3], jnp.int32)
    tris = pack_tris(v0, v1, v2, vis)
    o = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    t_min = jnp.asarray([1e-4], jnp.float32)
    t_max = jnp.asarray([1e30], jnp.float32)
    excl = jnp.asarray([-1], jnp.int32)
    bt, bp, bu, bv = mt_query(tris, o, d, t_min, t_max, excl,
                              interpret=True)
    assert int(bp[0]) == 0          # lowest index among the tie
    np.testing.assert_allclose(float(bt[0]), 1.0, rtol=1e-6)
    # barycentrics must belong to triangle 0: hit point (0,0,1) in tri 0 has
    # u (towards v1=(0,1,1)) = 0.5, v (towards v2=(-1,-1,1)) = 0.
    np.testing.assert_allclose(float(bu[0]), 0.5, atol=1e-6)
    np.testing.assert_allclose(float(bv[0]), 0.0, atol=1e-6)


@pytest.mark.parametrize("quadratic", [False, True])
def test_kernel_motion_blur_matches_scan(rng, quadratic):
    f, n = 200, 1024
    geom = _random_geom(rng, f, motion=True, motion2=quadratic)
    o, d = _rays(rng, n)
    t_min = jnp.full(n, 1e-4)
    t_max = jnp.full(n, 1e30)
    excl = jnp.full(n, -1, jnp.int32)
    time = jnp.asarray(rng.random(n).astype(np.float32))

    ref = I._brute_closest(geom, o, d, t_min, t_max, excl, time=time)
    tabs = _tables(geom)
    out = mt_query(tabs[0], o, d, t_min, t_max, excl, time=time,
                   tris_t1=tabs[1], tris_t2=tabs[2] if quadratic else None,
                   interpret=True)
    _check(ref, *out, rtol=1e-4)


def test_kernel_padding_and_tmax(rng):
    """A ray count that is not a RAY_BLOCK multiple is padded internally,
    short rays stop at t_max, and dead rays (empty range) never hit."""
    f, n = 150, 777
    assert n % PI.RAY_BLOCK
    geom = _random_geom(rng, f)
    o, d = _rays(rng, n)
    t_min = jnp.full(n, 1e-4)
    t_max = jnp.where(jnp.arange(n) % 9 == 4, -1.0, 0.8)
    excl = jnp.full(n, -1, jnp.int32)

    ref = I._brute_closest(geom, o, d, t_min, t_max, excl)
    bt, bp, bu, bv = mt_query(_tables(geom)[0], o, d, t_min, t_max, excl,
                              interpret=True)
    assert bt.shape == (n,) and bp.dtype == jnp.int32
    assert not np.asarray(bp >= 0)[4::9].any()
    np.testing.assert_array_equal(np.asarray(bt)[np.asarray(bp) < 0],
                                  np.asarray(t_max)[np.asarray(bp) < 0])
    _check(ref, bt, bp, bu, bv)


def test_kernel_exclude_skips_only_that_prim(rng):
    """Excluding each ray's own closest prim (the self-intersection guard
    of a bounce) yields the next surface behind it, exactly as the scan
    oracle does with the same exclusions."""
    f, n = 300, 1024
    geom = _random_geom(rng, f)
    o, d = _rays(rng, n)
    t_min = jnp.full(n, 1e-4)
    t_max = jnp.full(n, 1e30)
    tris = _tables(geom)[0]
    _, first, _, _ = mt_query(tris, o, d, t_min, t_max,
                              jnp.full(n, -1, jnp.int32), interpret=True)
    assert int((first >= 0).sum()) > n // 10
    ref = I._brute_closest(geom, o, d, t_min, t_max, first)
    bt, bp, bu, bv = mt_query(tris, o, d, t_min, t_max, first,
                              interpret=True)
    hit = np.asarray(first) >= 0
    assert not (np.asarray(bp)[hit] == np.asarray(first)[hit]).any()
    _check(ref, bt, bp, bu, bv)


def _triangle_scene_fn(geom, n):
    o = jnp.zeros((n, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 1))

    def fn(verts):
        g = geom.replace(vertices=verts)
        return I._brute_closest(g, o, d, jnp.full((n,), 1e-4),
                                jnp.full((n,), 1e30)).t
    return fn


def test_dispatch_kernel_on_cuda_scan_elsewhere(rng):
    """The brute query's triangle pass is chosen by the lowering platform
    alone: the Triton kernel when lowered for CUDA, the jnp scan when
    lowered for the CPU. No probe runs and nothing falls back."""
    geom = _random_geom(rng, 40)
    fn = _triangle_scene_fn(geom, 256)
    traced = jax.jit(fn).trace(geom.vertices)
    cpu_hlo = traced.lower(lowering_platforms=("cpu",)).as_text()
    cuda_hlo = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" not in cpu_hlo
    assert "mt_query" in cuda_hlo and "triton" in cuda_hlo
    assert not hasattr(PI, "use_pallas") and not hasattr(PI, "_probe")


def test_pack_rays_layout():
    """Component-major ray table: rows in the kernel's order, padded rays
    carry an empty t-range."""
    n = 130
    o = jnp.arange(3 * n, dtype=jnp.float32).reshape(n, 3)
    d = -o
    rays = np.asarray(PI.pack_rays(o, d, jnp.full(n, 0.5), jnp.full(n, 9.0),
                                   jnp.arange(n), jnp.full(n, 0.25)))
    assert rays.shape == (16, 2 * PI.RAY_BLOCK)
    np.testing.assert_array_equal(rays[0:3, :n], np.asarray(o).T)
    np.testing.assert_array_equal(rays[3:6, :n], np.asarray(d).T)
    np.testing.assert_array_equal(rays[8, :n], np.arange(n))
    assert (rays[6, :n] == 0.5).all() and (rays[9, :n] == 0.25).all()
    assert (rays[7, n:] < rays[6, n:]).all()
