"""Block accelerator (jnp block loop, accel/blocks.py) vs the brute scan.

`blocks.query` is the traversal every scene of 2048 or more faces takes on
every backend; the oracle is the jnp brute-force scan
(ops/intersect.py `_brute_closest`, the CPU branch).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from libyafaray_tpu import SceneBuilder
from libyafaray_tpu.accel import blocks as BL
from libyafaray_tpu.accel.blocks import build_blocks
from libyafaray_tpu.ops import intersect as I

from test_pallas_intersect import _random_geom, _rays


def _assert_matches(ref, bt, bp, buv, rtol=1e-4):
    valid = np.asarray(bp) >= 0
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    np.testing.assert_array_equal(np.asarray(bp)[valid],
                                  np.asarray(ref.prim)[valid])
    np.testing.assert_allclose(np.asarray(bt)[valid],
                               np.asarray(ref.t)[valid], rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(np.asarray(buv)[valid],
                               np.asarray(ref.uv)[valid], atol=1e-4)


@pytest.mark.parametrize("shadow", [False, True])
def test_block_loop_matches_scan_oracle(rng, shadow):
    f, n = 700, 2048
    geom = _random_geom(rng, f)
    acc = build_blocks(geom)
    assert acc.num_blocks > 1
    o, d = _rays(rng, n)
    t_min = jnp.full(n, 1e-4)
    t_max = jnp.full(n, 1e30)
    excl = jnp.full(n, -1, jnp.int32).at[::5].set(7)

    ref = I._brute_closest(geom, o, d, t_min, t_max, excl, shadow=shadow)
    bt, bp, buv = BL.query(acc, geom, o, d, t_min, t_max, excl,
                           2 if shadow else 1, False)
    _assert_matches(ref, bt, bp, buv)


def test_block_loop_any_hit(rng):
    f, n = 500, 1024
    geom = _random_geom(rng, f)
    acc = build_blocks(geom)
    o, d = _rays(rng, n)
    t_min = jnp.full(n, 1e-4)
    t_max = jnp.full(n, 1e30)
    excl = jnp.full(n, -1, jnp.int32)

    ref = I._brute_closest(geom, o, d, t_min, t_max, excl, shadow=True)
    _, bp, _ = BL.query(acc, geom, o, d, t_min, t_max, excl, 2, True)
    np.testing.assert_array_equal(np.asarray(bp) >= 0, np.asarray(ref.valid))


def test_block_loop_tmax_and_padding(rng):
    """Short rays terminate (t_max respected) and a ray count that is not a
    chunk multiple is padded internally without corrupting results."""
    f, n = 400, 777
    geom = _random_geom(rng, f)
    acc = build_blocks(geom)
    o, d = _rays(rng, n)
    t_min = jnp.full(n, 1e-4)
    t_max = jnp.full(n, 0.8)   # many rays now stop short
    excl = jnp.full(n, -1, jnp.int32)

    ref = I._brute_closest(geom, o, d, t_min, t_max, excl)
    bt, bp, buv = BL.query(acc, geom, o, d, t_min, t_max, excl, 1, False)
    _assert_matches(ref, bt, bp, buv)


def _instanced_scene(n_inst, mode="auto"):
    """A 128-tri base strip instanced n_inst times over a ground quad —
    enough faces that 'auto' elects TRUE instancing."""
    rng = np.random.default_rng(3)
    b = SceneBuilder()
    b.set_render_params({"instancing": mode})
    b.create_material("m", {"type": "shinydiffusemat"})
    b.set_current_material("m")
    b.create_object("ground")
    q = [b.add_vertex(x, y, 0.0) for x, y in
         ((-9, -9), (9, -9), (9, 9), (-9, 9))]
    b.add_quad(*q)
    b.create_object("strip")
    for k in range(64):
        x = 0.05 * k
        i0 = b.add_vertex(x, 0.0, 0.0)
        i1 = b.add_vertex(x + 0.05, 0.0, 0.1 * np.sin(k))
        i2 = b.add_vertex(x, 0.3, 0.1 * np.cos(k))
        i3 = b.add_vertex(x + 0.05, 0.3, 0.05)
        b.add_triangle(i0, i1, i2)
        b.add_triangle(i1, i3, i2)
    for _ in range(n_inst):
        m = np.eye(4, dtype=np.float32)
        a = rng.uniform(0, 2 * np.pi)
        m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        m[:3, :3] *= rng.uniform(0.5, 1.5)
        m[:3, 3] = [*rng.uniform(-4, 4, 2), rng.uniform(0.1, 1.0)]
        b.add_instance("strip", m)
    b.create_camera("cam", {"type": "perspective", "from": (0, -8, 5),
                            "to": (0, 0, 0), "up": (0, -8, 6),
                            "resx": 16, "resy": 16})
    return b.compile("cam")


def test_instanced_block_loop_matches_baked_scan(rng):
    """Instanced block loop (shared object-space blocks, rays moved
    object<-world per virtual block) vs the brute scan on the baked copy
    of the same scene: same hits, same prims, same distances."""
    sc = _instanced_scene(20)
    sc_bake = _instanced_scene(20, mode="baked")
    acc = sc.blocks
    assert acc.blk_base is not None and sc_bake.geom.inst_mat is None
    n = 2048
    o = np.stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                  rng.uniform(1.5, 3.0, n)], -1).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    t_min = jnp.full(n, 1e-4)
    t_max = jnp.full(n, 1e30)
    excl = jnp.full(n, -1, jnp.int32)

    ref = I._brute_closest(sc_bake.geom, o, d, t_min, t_max, excl)
    bt, bp, buv = BL.query(acc, sc.geom, o, d, t_min, t_max, excl, 1, False)
    assert (np.asarray(bp) >= sc.geom.num_base_faces).any()
    _assert_matches(ref, bt, bp, buv, rtol=1e-5)


def test_block_loop_motion_blur_matches_scan(rng):
    """Motion-blurred traversal through the block loop (per-ray linear
    vertex blend of the gathered block) vs the brute scan oracle."""
    f, n = 600, 1024
    geom = _random_geom(rng, f, motion=True)
    acc = build_blocks(geom)
    assert acc.geo_t1 is not None
    o, d = _rays(rng, n)
    t_min = jnp.full(n, 1e-4)
    t_max = jnp.full(n, 1e30)
    excl = jnp.full(n, -1, jnp.int32)
    time = jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))

    ref = I._brute_closest(geom, o, d, t_min, t_max, excl, time=time)
    bt, bp, buv = BL.query(acc, geom, o, d, t_min, t_max, excl, 1, False,
                           time=time)
    _assert_matches(ref, bt, bp, buv)


def test_query_sorted_path_matches_oracle(rng):
    """blocks.query with n > RAY_CHUNK exercises the variadic-sort ray
    reordering (sort-carry + sort-back, no gathers); must match the scan
    oracle in original ray order, including dead rays (empty t-range)."""
    f, n = 900, 9000
    geom = _random_geom(rng, f)
    acc = build_blocks(geom)
    o, d = _rays(rng, n)
    t_min = jnp.full(n, 1e-4)
    # a scattering of dead rays (terminated paths)
    t_max = jnp.where(jnp.arange(n) % 7 == 3, -1.0, 1e30)
    excl = jnp.full(n, -1, jnp.int32).at[::11].set(3)

    ref = I._brute_closest(geom, o, d, t_min, t_max, excl)
    bt, bp, buv = BL.query(acc, geom, o, d, t_min, t_max, excl, 1, False)
    _assert_matches(ref, bt, bp, buv)


@pytest.mark.parametrize("res,kind", [(64, "brute"), (65, "blocks")])
def test_default_accel_by_face_count(res, kind):
    """Scenes below scene.BRUTE_MAX_FACES faces default to the brute query,
    larger ones to the block loop (2*(res-1)^2 terrain triangles: 7,938
    and 8,192)."""
    from libyafaray_tpu.scene import BRUTE_MAX_FACES
    from scenes import bigmesh_builder
    sc = bigmesh_builder(res, textured=False).compile("cam")
    assert (sc.geom.num_faces >= BRUTE_MAX_FACES) == (kind == "blocks")
    assert sc.accel_kind == kind
    assert (sc.blocks is not None) == (kind == "blocks")
