"""TRUE instancing: virtual faces + per-instance matrices, O(base) memory.

Reference parity: ObjectInstance/PrimitiveInstance
(include/geometry/object/object_instance.h:29-63,
src/geometry/primitive/primitive_instance.cc). The oracle is the baked
path (geometry duplication), which earlier rounds verified against the
brute-force scan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libyafaray_tpu import SceneBuilder, film as F, make_integrator
from libyafaray_tpu.render import render
from libyafaray_tpu.ops import intersect as I
from libyafaray_tpu.ops.intersect import closest_hit


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0],
                     [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)


def _instanced_builder(n_inst=40, mode="auto"):
    """Ground plane + base blob (icosphere-ish fan, 96 tris) instanced
    n_inst times with varied rigid transforms. 96*40 + ground > 2048 so
    'auto' elects TRUE instancing."""
    rng = np.random.default_rng(5)
    b = SceneBuilder()
    if mode != "auto":
        b.set_render_params({"instancing": mode})
    b.create_material("grey", {"type": "shinydiffusemat",
                               "color": (0.7, 0.68, 0.65)})
    b.create_material("red", {"type": "shinydiffusemat",
                              "color": (0.7, 0.2, 0.15)})
    b.create_object("ground")
    b.set_current_material("grey")
    i0 = b.add_vertex(-8, -8, 0)
    i1 = b.add_vertex(8, -8, 0)
    i2 = b.add_vertex(8, 8, 0)
    i3 = b.add_vertex(-8, 8, 0)
    b.add_quad(i0, i1, i2, i3)

    # base blob: triangle fan sphere approximation (8x6 grid)
    b.create_object("blob")
    b.set_current_material("red")
    nu, nv = 8, 6
    idx = np.zeros((nu + 1, nv + 1), np.int32)
    for iu in range(nu + 1):
        for iv in range(nv + 1):
            th = np.pi * iv / nv
            ph = 2 * np.pi * iu / nu
            idx[iu, iv] = b.add_vertex(0.3 * np.sin(th) * np.cos(ph),
                                       0.3 * np.sin(th) * np.sin(ph),
                                       0.3 * np.cos(th))
    for iu in range(nu):
        for iv in range(nv):
            a_, b_, c_, d_ = (idx[iu, iv], idx[iu + 1, iv],
                              idx[iu + 1, iv + 1], idx[iu, iv + 1])
            b.add_triangle(a_, b_, c_)
            b.add_triangle(a_, c_, d_)

    for k in range(n_inst):
        x, y = rng.uniform(-3, 3, 2)
        s = rng.uniform(0.6, 1.6)
        m = _rot_z(rng.uniform(0, 2 * np.pi))
        m[:3, :3] *= s
        m[0, 3], m[1, 3], m[2, 3] = x, y, 0.35 * s
        b.add_instance("blob", m)

    b.create_light("sun", {"type": "sunlight", "direction": (0.4, 0.3, 0.85),
                           "color": (1, 1, 0.95), "power": 2.0})
    b.create_camera("cam", {"type": "perspective",
                            "from": (0, -6.5, 4.0), "to": (0, 0, 0.3),
                            "up": (0, -6.5, 5.0),
                            "resx": 48, "resy": 48, "fov": 55.0})
    b.create_background({"type": "constant", "color": (0.2, 0.25, 0.35)})
    return b


def test_true_instancing_matches_baked():
    """TRUE-instanced render == baked (duplicated geometry) render; both
    on the jnp block path on CPU."""
    sc_true = _instanced_builder().compile("cam")
    sc_bake = _instanced_builder(mode="baked").compile("cam")
    assert sc_true.geom.inst_mat is not None, "expected true instancing"
    assert sc_bake.geom.inst_mat is None
    assert sc_true.accel_kind == "blocks"
    # O(base) memory: physical faces stay tiny vs virtual
    assert sc_true.geom.faces.shape[0] < 200
    assert sc_true.geom.num_faces > 2000
    assert sc_bake.geom.faces.shape[0] == sc_true.geom.num_faces

    cfg = make_integrator({"type": "directlighting"})
    img_t = np.asarray(F.resolve(render(sc_true, cfg, 48, 48, spp=2),
                                 "combined"))
    img_b = np.asarray(F.resolve(render(sc_bake, cfg, 48, 48, spp=2),
                                 "combined"))
    assert np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t, img_b, atol=2e-3)


def test_instanced_block_loop_matches_baked_scan():
    """The instanced jnp block loop (rays moved object<-world per block)
    finds the hits the brute scan finds on the baked (duplicated)
    geometry of the same scene."""
    sc = _instanced_builder(n_inst=24).compile("cam")
    sc_bake = _instanced_builder(n_inst=24, mode="baked").compile("cam")
    assert sc.blocks.blk_base is not None and sc_bake.geom.inst_mat is None
    rng = np.random.default_rng(11)
    n = 1024
    o = np.stack([rng.uniform(-4, 4, n), rng.uniform(-7, 2, n),
                  rng.uniform(0.2, 3.0, n)], -1).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)

    hit = closest_hit(sc, o, d, 1e-4, 1e9)      # instanced block loop
    ref = I._brute_closest(sc_bake.geom, o, d, jnp.full((n,), 1e-4),
                           jnp.full((n,), 1e9))
    rv = np.asarray(ref.valid)
    assert rv.sum() > n // 4
    np.testing.assert_array_equal(np.asarray(hit.valid), rv)
    np.testing.assert_array_equal(np.asarray(hit.prim)[rv],
                                  np.asarray(ref.prim)[rv])
    np.testing.assert_allclose(np.asarray(hit.t)[rv], np.asarray(ref.t)[rv],
                               rtol=1e-4, atol=1e-5)


def test_instance_motion_time_steps():
    """Instance motion blur: two time-step matrices move the instance;
    rays at time 0 and 1 hit it at the corresponding positions (baked
    motion path; the C API's staged time_steps flow here)."""
    b = SceneBuilder()
    b.create_material("m", {"type": "shinydiffusemat", "color": (0.5,) * 3})
    b.create_object("tri")
    b.set_current_material("m")
    i0 = b.add_vertex(-0.5, 0.0, -0.5)
    i1 = b.add_vertex(0.5, 0.0, -0.5)
    i2 = b.add_vertex(0.0, 0.0, 0.5)
    b.add_triangle(i0, i1, i2)
    m0 = np.eye(4, dtype=np.float32)
    m0[0, 3] = 5.0      # at x=+5 at shutter open
    m1 = np.eye(4, dtype=np.float32)
    m1[0, 3] = -5.0     # at x=-5 at shutter close
    b.add_instance("tri", [m0, m1])
    b.create_light("p", {"type": "pointlight", "from": (0, -3, 2),
                         "color": (1, 1, 1), "power": 5.0})
    b.create_camera("cam", {"type": "perspective",
                            "from": (0, -4, 0), "to": (0, 0, 0),
                            "up": (0, -4, 1),
                            "resx": 8, "resy": 8, "fov": 60.0})
    b.create_background({"type": "constant", "color": (0, 0, 0)})
    scene = b.compile("cam")
    assert scene.geom.has_motion

    o = jnp.asarray([[5.0, -4.0, 0.0], [-5.0, -4.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]], jnp.float32)
    for time, want in ((jnp.asarray([0.0, 0.0]), [True, False]),
                       (jnp.asarray([1.0, 1.0]), [False, True])):
        h = closest_hit(scene, o, d, 1e-4, 1e9, time=time)
        np.testing.assert_array_equal(np.asarray(h.valid), want)
