"""Differentiability breadth (BASELINE.md config 4): finite-difference
checked gradients w.r.t. IOR, glossy exponent, light emission, and image
texture texels — through specular/caustic paths and the bilinear texture
sampling chain.  Extends test_render.py's albedo-only gradient test to
the full parameter surface the reference exposes as scene parameters
(the reference itself is non-differentiable; these pin OUR north-star
metric from BASELINE.md)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libyafaray_tpu import make_integrator
from libyafaray_tpu.cameras import shoot_rays
from libyafaray_tpu.integrators.mc import integrate
from libyafaray_tpu.materials.bsdf import MAT_GLASS, MAT_GLOSSY

from scenes import cornell_builder, bigmesh_builder, _box


def _ray_batch(scene, res=8, span=64):
    """Deterministic 8x8 grid of primary rays across the image."""
    n = res * res
    yy, xx = jnp.meshgrid(jnp.arange(res), jnp.arange(res), indexing="ij")
    pid = (yy * res + xx).reshape(-1).astype(jnp.uint32)
    scale = span // res
    px = xx.reshape(-1).astype(jnp.float32) * scale + scale / 2
    py = yy.reshape(-1).astype(jnp.float32) * scale + scale / 2
    o, d, valid = shoot_rays(scene.camera, px, py,
                             jnp.zeros(n) + 0.5, jnp.zeros(n) + 0.5)
    return o, d, valid, pid


def _check_grad(loss, theta, picks, e=1e-3, rel=2e-2, abs_=1e-5):
    """AD gradient vs central finite differences at the picked indices.

    `rel` encodes the expected agreement: shading-linear parameters
    (albedo, emission, texels) must match tightly; parameters that bend
    sampled ray *directions* (IOR, glossy exponent) are checked loosely
    because the framework uses detached sampling (SURVEY.md §7.6 —
    intersection results and sampled directions carry no gradient), so AD
    deliberately excludes the reparameterization term FD measures."""
    g = jax.jit(jax.grad(loss))(theta)
    g = np.asarray(g)
    assert np.isfinite(g).all(), "NaN/inf in gradient"
    loss_j = jax.jit(loss)
    hit = 0
    for idx in picks:
        fd = (float(loss_j(theta.at[idx].add(e)))
              - float(loss_j(theta.at[idx].add(-e)))) / (2 * e)
        assert float(g[idx]) == pytest.approx(fd, rel=rel, abs=abs_), \
            f"grad mismatch at {idx}: ad={float(g[idx])} fd={fd}"
        if abs(fd) > 10 * abs_:
            hit += 1
    assert hit > 0, "all finite differences ~0; test exercises nothing"
    return g


def _glass_cornell():
    b = cornell_builder(extras=[
        ("glass", {"type": "glass", "IOR": 1.5,
                   "filter_color": (0.95, 0.95, 0.95)})])
    b.create_object("slab")
    b.set_current_material("glass")
    _box(b, (0.35, 0.35, 0.2), (0.3, 0.2, 0.35))
    return b.compile("cam")


def test_grad_ior_through_specular_paths():
    """d(image)/d(IOR) through refract+Fresnel chains (config 4: caustic
    paths). The detached-sampling AD gradient carries the Fresnel-weight
    term exactly but not the ray-bending term, so FD agreement is loose
    (sign + magnitude) rather than exact — see _check_grad."""
    scene = _glass_cornell()
    cfg = make_integrator({"type": "pathtracing", "bounces": 5})
    o, d, valid, pid = _ray_batch(scene)
    row = int(np.argmax(np.asarray(scene.materials.mat_type) == MAT_GLASS))

    def loss(ior_col):
        sc = scene.replace(materials=scene.materials.replace(ior=ior_col))
        rgb, _, _ = integrate(sc, cfg, o, d, valid, pid, jnp.uint32(0))
        return jnp.mean(rgb)

    _check_grad(loss, scene.materials.ior, [(row,)], e=3e-3, rel=0.25,
                abs_=1e-6)


def test_grad_glossy_exponent():
    """d(image)/d(Blinn exponent) through the glossy lobe's sampled
    half-vector pdf and eval (material_glossy.cc parameter surface)."""
    b = cornell_builder(extras=[
        ("gl", {"type": "glossy", "exponent": 25.0,
                "glossy_reflect": 0.6, "diffuse_reflect": 0.3,
                "color": (0.7, 0.7, 0.7)})])
    b.create_object("slab")
    b.set_current_material("gl")
    _box(b, (0.35, 0.35, 0.2), (0.3, 0.2, 0.35))
    scene = b.compile("cam")
    cfg = make_integrator({"type": "pathtracing", "bounces": 3})
    o, d, valid, pid = _ray_batch(scene)
    row = int(np.argmax(np.asarray(scene.materials.mat_type) == MAT_GLOSSY))

    def loss(exp_col):
        sc = scene.replace(materials=scene.materials.replace(
            exponent=exp_col, exp_u=exp_col, exp_v=exp_col))
        rgb, _, _ = integrate(sc, cfg, o, d, valid, pid, jnp.uint32(0))
        return jnp.mean(rgb)

    # exponent ~25: larger FD step; loose rel (the exponent also shapes
    # the sampled half-vector distribution, which detached sampling
    # excludes from AD — see _check_grad)
    _check_grad(loss, scene.materials.exponent, [(row,)], e=5e-2,
                rel=0.25, abs_=1e-7)


def test_grad_light_emission():
    """d(image)/d(light color) — linear in emission, so AD must equal FD
    to machine precision (and equal the image's per-channel response)."""
    scene = cornell_builder().compile("cam")
    cfg = make_integrator({"type": "pathtracing", "bounces": 2})
    o, d, valid, pid = _ray_batch(scene)

    def loss(lcol):
        sc = scene.replace(lights=scene.lights.replace(color=lcol))
        rgb, _, _ = integrate(sc, cfg, o, d, valid, pid, jnp.uint32(0))
        return jnp.mean(rgb)

    li = int(np.argmax(np.asarray(scene.lights.color).sum(-1) > 0))
    _check_grad(loss, scene.lights.color, [(li, 0), (li, 2)],
                e=1e-2, rel=1e-3)


def test_grad_texture_texels():
    """d(image)/d(texel values) through uv mapping + bilinear filtering
    (config 4 'albedo textures'): the four texels under a sampled uv get
    the bilinear weights as gradients; FD must agree."""
    b = bigmesh_builder(res=10, textured=True)
    scene = b.compile("cam")
    assert scene.textures is not None
    assert scene.textures.texel_pool.dtype == jnp.float32
    cfg = make_integrator({"type": "pathtracing", "bounces": 1})
    o, d, valid, pid = _ray_batch(scene, span=720)

    def loss(pool):
        sc = scene.replace(textures=scene.textures.replace(texel_pool=pool))
        rgb, _, _ = integrate(sc, cfg, o, d, valid, pid, jnp.uint32(0))
        return jnp.mean(rgb)

    pool = scene.textures.texel_pool
    g = jax.jit(jax.grad(loss))(pool)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    mag = np.abs(g[..., :3]).sum(-1)  # [T] per-texel gradient mass
    assert (mag > 1e-6).sum() >= 4, \
        "expected gradient support over several texels"
    # FD-check the strongest texel's strongest channel
    t = int(np.argmax(mag))
    c = int(np.argmax(np.abs(g[t, :3])))
    loss_j = jax.jit(loss)
    e = 1e-2
    fd = (float(loss_j(pool.at[t, c].add(e)))
          - float(loss_j(pool.at[t, c].add(-e)))) / (2 * e)
    assert float(g[t, c]) == pytest.approx(fd, rel=2e-2, abs=1e-7)


@pytest.mark.parametrize("rows", [5, 1366])
def test_fast_take_gradient_matches_plain_gather(rows):
    """ops/fast_grad.take: tables up to MATMUL_GRAD_ROWS rows get the
    one-hot matmul backward, larger ones the plain gather; either way the
    gradient equals the plain gather's scatter-add VJP."""
    from libyafaray_tpu.ops import fast_grad
    rng = np.random.default_rng(rows)
    tab = jnp.asarray(rng.random((rows, 3)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, rows, 20000), jnp.int32)
    w = jnp.asarray(rng.random((20000, 3)), jnp.float32)
    g_fast = jax.grad(lambda t: jnp.sum(fast_grad.take(t, idx) * w))(tab)
    g_ref = jax.grad(lambda t: jnp.sum(t[idx] * w))(tab)
    np.testing.assert_allclose(np.asarray(g_fast), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-5)
    custom = "custom_vjp" in str(jax.make_jaxpr(
        lambda t: fast_grad.take(t, idx))(tab))
    assert custom == (rows <= fast_grad.MATMUL_GRAD_ROWS)
