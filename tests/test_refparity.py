"""Image parity against the ACTUAL reference renderer (libYafaRay).

The goldens in tests/golden/ are rendered by the reference binary itself —
built from /root/reference (CMake Release, FAST_MATH+FAST_TRIG) and driven
by the C clients in tools/refparity/ (the same C-API sequence as the
reference's own tests/test00/test00.c). They are LINEAR-color-space
Radiance .hdr files, so the comparison happens in radiance units with no
gamma or 8-bit quantization (RGBE shared-exponent mantissa error ~0.4%).

This closes BASELINE.md config 1's "CPU reference render as golden" and is
the one form of correctness evidence internal oracles cannot provide:
the reference binary is the arbiter.

## The pi convention (measured, not assumed)

The reference's diffuse BRDF eval returns rho with NO 1/pi
(material_shiny_diffuse.cc:239 `m_d * diffuse_color`), while its
cosine-hemisphere sample pdf also omits the 1/pi
(material_shiny_diffuse.cc sample: `s.pdf_ = |wi.n| * width`), so
BSDF-sampled bounce throughput is rho — identical to our physically
normalized rho/pi BRDF with the true cos/pi pdf. Light connections do NOT
get that cancellation: illumSample contributions come out exactly pi x the
physical estimator for every light type (arealight additionally stores
color*power*pi, light_area.cc:41, cancelled by the pi in its pdf,
light_area.cc:88; pointlight stores color*power with pdf=d^2,
light_point.cc:34,75). Net: EVERY transport path in the reference carries
exactly ONE extra pi relative to the physical estimator, independent of
depth — a single global scale. Measured on this scene: ours*pi / reference
global ratio 0.9993 (the comparison below asserts it within 1%).
"""
import os

import numpy as np
import pytest

import jax.numpy as jnp

from libyafaray_tpu import SceneBuilder, io as yio, make_integrator, film as F
from libyafaray_tpu.render import render
from scenes import cornell_builder

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _downsample(x, k=4):
    h, w, c = x.shape
    return x.reshape(h // k, k, w // k, k, c).mean(axis=(1, 3))


@pytest.mark.refparity
@pytest.mark.timeout(900)
def test_cornell_direct_matches_reference_render():
    """BASELINE.md config 1: the test00-style Cornell box under the
    directlighting integrator, ours vs the reference renderer's own output.

    Golden: tools/refparity/cornell_ref.c at 256x256, 512 spp x 4 light
    samples (2048 area-light samples/pixel, sigma_rel ~1.5%). Ours:
    96 spp x 1 light sample — geometry-edge noise scales with 1/sqrt(spp)
    (pixel jitter), so high spp beats few-spp-many-light-samples here;
    the per-light `samples` handling itself is covered by
    test_lights.test_per_light_samples_honored_by_direct_lighting.

    Tolerances are set by the MC noise of OUR render (the looser side):
    - global scale (ours*pi / ref) within 1%: pins the estimator
      conventions; a missing pi (314%), a wrong light fold, a cosine or
      area error would all blow far past this.
    - full-res mean relative error < 4%: mean over 65k pixels averages
      per-pixel noise down to <1%; headroom for the ~50 penumbra-edge
      pixels where 96-sample noise peaks.
    - 4x4 box-downsampled p99 < 6%, max < 15%: patch means have 16x the
      samples (sigma ~2.5%); this catches any LOCALIZED disagreement
      (wrong shadow shape, displaced geometry, flipped texture) that the
      global metrics would dilute. Measured on this host: p99 4.3%,
      max 10.6%.
    """
    ref = np.asarray(
        yio.load_hdr(os.path.join(GOLDEN, "cornell_ref_256.hdr")))[..., :3]
    b = cornell_builder()
    # reference arealights are invisible to camera rays (never scene
    # primitives); mirror that so the lamp region compares the ceiling
    b.lights["lamp"]["visibility"] = "invisible"
    b.lights["lamp"]["samples"] = 1
    b.cameras["cam"]["resx"] = 256
    b.cameras["cam"]["resy"] = 256
    scene = b.compile("cam")
    cfg = make_integrator({"type": "directlighting"})
    film = render(scene, cfg, 256, 256, spp=96)
    img = np.asarray(F.resolve(film, "combined"))[..., :3] * np.pi

    assert np.isfinite(img).all()
    scale = img.mean() / ref.mean()
    assert abs(scale - 1.0) < 0.01, f"global radiance scale off: {scale}"

    lit = ref.max(-1) > 0.05
    rel = np.abs(img - ref).max(-1)[lit] / ref.max(-1)[lit]
    assert rel.mean() < 0.04, f"mean relative error {rel.mean():.4f}"

    rd, od = _downsample(ref), _downsample(img)
    litd = rd.max(-1) > 0.05
    reld = np.abs(od - rd).max(-1)[litd] / rd.max(-1)[litd]
    p99 = float(np.percentile(reld, 99))
    assert p99 < 0.06, f"downsampled p99 relative error {p99:.4f}"
    assert reld.max() < 0.15, f"downsampled max relative error {reld.max():.4f}"


def _glossy_builder():
    """Mirror of tools/refparity/glossy_ref.c: uv-textured floor (RAM
    image -> texture_mapper node), analytic glossy sphere, white back
    wall, invisible overhead area light, 3-bounce path tracing."""
    b = SceneBuilder()
    i = np.arange(64)[None, :]
    j = np.arange(64)[:, None]
    img = np.zeros((64, 64, 3), np.float32)
    img[..., 0] = 0.25 + 0.25 * (1 + np.sin(0.35 * i))
    img[..., 1] = 0.25 + 0.25 * (1 + np.sin(0.35 * j))
    img[..., 2] = 0.5
    b.create_texture("TexFloor", {"type": "image"}, image=img)
    b.create_material("floor", {"type": "shinydiffusemat", "color": (1, 1, 1),
                                "diffuse_shader": "map0"},
                      node_list=[{"type": "texture_mapper", "name": "map0",
                                  "texture": "TexFloor", "texco": "uv"}])
    b.create_material("white", {"type": "shinydiffusemat",
                                "color": (0.73, 0.73, 0.73)})
    b.create_material("gloss", {"type": "glossy", "color": (0.8, 0.8, 0.8),
                                "diffuse_color": (0.3, 0.25, 0.2),
                                "glossy_reflect": 0.7, "diffuse_reflect": 1.0,
                                "exponent": 25.0, "as_diffuse": False})
    b.create_object("floorobj")
    b.set_current_material("floor")
    a0 = b.add_vertex(0, 0, 0)
    a1 = b.add_vertex(1, 0, 0)
    a2 = b.add_vertex(1, 1, 0)
    a3 = b.add_vertex(0, 1, 0)
    u0 = b.add_uv(0, 0)
    u1 = b.add_uv(1, 0)
    u2 = b.add_uv(1, 1)
    u3 = b.add_uv(0, 1)
    b.add_triangle(a0, a1, a2, (u0, u1, u2))
    b.add_triangle(a0, a2, a3, (u0, u2, u3))
    b.create_object("back")
    b.set_current_material("white")
    c0 = b.add_vertex(0, 1, 0)
    c1 = b.add_vertex(1, 1, 0)
    c2 = b.add_vertex(1, 1, 1)
    c3 = b.add_vertex(0, 1, 1)
    b.add_quad(c0, c1, c2, c3)
    b.create_object("ball", {"type": "sphere", "center": (0.5, 0.5, 0.3),
                             "radius": 0.25})
    b.set_current_material("gloss")
    b.create_light("lamp", {"type": "arealight", "corner": (0.3, 0.3, 1.2),
                            "point1": (0.3, 0.7, 1.2), "point2": (0.7, 0.3, 1.2),
                            "color": (1.0, 0.95, 0.9), "power": 6.0,
                            "samples": 4, "visibility": "invisible"})
    b.create_background({"type": "constant", "color": (0, 0, 0)})
    b.create_camera("cam", {"type": "perspective", "from": (0.5, -0.9, 0.55),
                            "to": (0.5, 0.5, 0.3), "up": (0.5, -0.9, 1.55),
                            "resx": 128, "resy": 128, "fov": 50.0})
    return b


@pytest.mark.refparity
@pytest.mark.timeout(900)
def test_glossy_textured_matches_reference_render():
    """Textured/glossy scene vs the reference renderer's own output
    (second scene): covers the RAM-image ->
    texture_mapper(uv) shader pipeline, the glossy BSDF, the analytic
    sphere primitive and the multi-bounce path-tracing estimator.

    Golden: tools/refparity/glossy_ref.c at 128x128, 512 spp (note the
    client must pass "width"/"height" to the image factory — the
    reference's own test00.c passes "tex_width"/"tex_height", which
    Image::factory ignores, silently producing a black texture).

    Tolerances per region (the pi fold applies globally; measured at 64
    spp: wall 1.013, floor 1.005, sphere 0.933):
    - back wall and textured floor region means within 5%: direct+GI
      diffuse transport and the full texture pipeline (uv mapping, texel
      order, bilinear fetch) — a flipped axis or wrong texel order moves
      the floor ratio by >20%;
    - sphere region mean within 12%: the reference's Blinn microfacet
      normalization ((e+1) cos^e without the 1/2pi, blinnD
      material_utils_microfacet.h:89-91, folded against its asDivisor)
      differs from our quadrature-pinned energy-normalized lobe by a few
      percent at exponent 25 — documented convention gap, bounded here;
    - global scale within 8%.
    """
    ref = np.asarray(
        yio.load_hdr(os.path.join(GOLDEN, "glossy_ref_128.hdr")))[..., :3]
    scene = _glossy_builder().compile("cam")
    cfg = make_integrator({"type": "pathtracing", "bounces": 3,
                           "russian_roulette_min_bounces": 10})
    film = render(scene, cfg, 128, 128, spp=64)
    img = np.asarray(F.resolve(film, "combined"))[..., :3] * np.pi
    assert np.isfinite(img).all()
    scale = img.mean() / ref.mean()
    assert abs(scale - 1.0) < 0.08, f"global radiance scale off: {scale}"
    regions = {"backwall": np.s_[10:40], "floor": np.s_[95:125],
               "sphere": np.s_[58:82, 40:88]}
    tol = {"backwall": 0.05, "floor": 0.05, "sphere": 0.12}
    for name, sl in regions.items():
        ratio = img[sl].mean() / ref[sl].mean()
        assert abs(ratio - 1.0) < tol[name], f"{name} ratio {ratio:.3f}"
    # texture pattern parity: the floor's horizontal color variation must
    # correlate strongly with the reference's (catches flipped/shifted uv)
    fo = img[100:120, :, 0].mean(0)
    fr = ref[100:120, :, 0].mean(0)
    cc = np.corrcoef(fo, fr)[0, 1]
    assert cc > 0.98, f"floor texture profile correlation {cc:.3f}"


def _instances_builder():
    """Mirror of tools/refparity/instances_ref.c: one is_base_object cube,
    five instances with distinct translation/scale/z-rotation matrices
    over a floor, point light, direct lighting (the reference's
    tests/test02 flow)."""
    b = SceneBuilder()
    b.create_material("white", {"type": "shinydiffusemat",
                                "color": (0.7, 0.7, 0.7)})
    b.create_material("blue", {"type": "shinydiffusemat",
                               "color": (0.3, 0.4, 0.7)})
    b.create_object("floor")
    b.set_current_material("white")
    ids = [b.add_vertex(*p) for p in [(-4, -4, 0), (4, -4, 0),
                                      (4, 4, 0), (-4, 4, 0)]]
    b.add_quad(*ids)
    b.create_object("cube", {"is_base_object": True})
    b.set_current_material("blue")
    p = [b.add_vertex(0.5 if i & 1 else -0.5, 0.5 if i & 2 else -0.5,
                      0.5 if i & 4 else -0.5) for i in range(8)]
    for q in [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4),
              (2, 6, 7, 3), (0, 4, 6, 2), (1, 3, 7, 5)]:
        b.add_quad(*[p[i] for i in q])
    xs = [-2.0, -0.9, 0.3, 1.6, 0.1]
    ys = [-0.6, 0.9, -0.2, 0.6, 2.0]
    ss = [0.8, 1.2, 0.6, 1.0, 0.9]
    for k in range(5):
        s = ss[k]
        a = 0.5 * k
        c = np.cos(a) * s
        sn = np.sin(a) * s
        m = np.array([[c, -sn, 0, xs[k]], [sn, c, 0, ys[k]],
                      [0, 0, s, 0.5 * s], [0, 0, 0, 1]], np.float32)
        b.add_instance("cube", m)
    b.create_light("lamp", {"type": "pointlight", "from": (1.0, -1.5, 4.0),
                            "color": (1, 1, 1), "power": 20.0})
    b.create_background({"type": "constant", "color": (0, 0, 0)})
    b.create_camera("cam", {"type": "perspective", "from": (0.0, -5.5, 3.5),
                            "to": (0.0, 0.0, 0.4), "up": (0.0, -5.5, 4.5),
                            "resx": 160, "resy": 160, "fov": 50.0})
    return b


@pytest.mark.refparity
@pytest.mark.timeout(900)
@pytest.mark.parametrize("mode", ["baked", "true"])
def test_instances_match_reference_render(mode):
    """Instancing vs the reference renderer (tests/test02 flow): five
    instances of an is_base_object cube with mixed translation / scale /
    rotation matrices. Pins the transform conventions (row-major 4x4,
    translation in column 3), the instanced intersection and shading
    frame, and is_base_object exclusion (found missing by this test:
    before r5 the base cube rendered at the origin).

    Both instancing implementations run against the same golden:
    'baked' duplicates transformed geometry (brute/pallas accel);
    'true' keeps O(base) memory with per-block ray transforms in the
    block accelerator. Point-light direct lighting is deterministic, so
    the only noise is pixel jitter: measured global ratio 1.00003,
    4x4-downsampled p99 1.7% at 16 spp — tolerances doubled for margin."""
    ref = np.asarray(
        yio.load_hdr(os.path.join(GOLDEN, "instances_ref_160.hdr")))[..., :3]
    b = _instances_builder()
    if mode == "true":
        b.set_render_params({"instancing": "true",
                             "scene_accelerator": "blocks"})
    scene = b.compile("cam")
    if mode == "true":
        assert scene.geom.inst_mat is not None, "true instancing not active"
    cfg = make_integrator({"type": "directlighting"})
    film = render(scene, cfg, 160, 160, spp=16)
    img = np.asarray(F.resolve(film, "combined"))[..., :3] * np.pi
    assert np.isfinite(img).all()
    scale = img.mean() / ref.mean()
    assert abs(scale - 1.0) < 0.01, f"global radiance scale off: {scale}"
    rd, od = _downsample(ref), _downsample(img)
    lit = rd.max(-1) > 0.02
    reld = np.abs(od - rd).max(-1)[lit] / rd.max(-1)[lit]
    assert reld.mean() < 0.01, f"downsampled mean rel {reld.mean():.4f}"
    p99 = float(np.percentile(reld, 99))
    assert p99 < 0.04, f"downsampled p99 {p99:.4f}"


@pytest.mark.refparity
@pytest.mark.timeout(900)
@pytest.mark.parametrize("camtype,golden,tol_mean,tol_p99", [
    ("orthographic", "cornell_ortho_128.hdr", 0.04, 0.18),
    ("equirectangular", "cornell_equi_128.hdr", 0.03, 0.12),
    ("angular", "cornell_angular_128.hdr", 0.05, 0.14),
    ("architect", "cornell_archi_128.hdr", 0.04, 0.20),
])
def test_alternate_cameras_match_reference_render(camtype, golden,
                                                  tol_mean, tol_p99):
    """Orthographic, equirectangular and angular cameras vs the reference
    binary's own renders of the same Cornell box
    (tools/refparity/cornell_ref.c camera arg). Pins the ray-generation
    conventions externally: this comparison FOUND and fixed two real
    bugs — equirectangular theta was offset by pi/2 (the up pole sat on
    the middle row) with mirrored phi (pre-fix mean rel error 96%,
    post-fix 1.3%), and the angular camera's azimuth lacked the
    reference's x-mirror (u = 1 - 2px/resx, camera_angular.cc shootRay)
    plus the sin(angle) focal factor of its orthographic projection and
    the max_angle/circular/mirrored params (pre-fix 58%, post-fix 2.1%).
    Measured post-fix at 24 spp: ortho scale 0.9990 / mean 1.9% /
    p99 10.5%; equirect 0.9994 / 1.3% / 6.5%; angular 0.990 / 2.1% /
    5.9% — tolerances set ~2x above."""
    import libyafaray_tpu.params as P
    ref = np.asarray(yio.load_hdr(os.path.join(GOLDEN, golden)))[..., :3]
    b = cornell_builder()
    b.lights["lamp"]["visibility"] = "invisible"
    b.lights["lamp"]["samples"] = 1
    cam = {"type": camtype, "resx": 128, "resy": 128}
    if camtype == "orthographic":
        cam.update({"from": (0.5, -1.35, 0.5), "to": (0.5, 0.5, 0.5),
                    "up": (0.5, -1.35, 1.5), "scale": 1.4})
    elif camtype == "angular":
        cam.update({"from": (0.5, -1.35, 0.5), "to": (0.5, 0.5, 0.5),
                    "up": (0.5, -1.35, 1.5), "angle": 90.0,
                    "max_angle": 90.0})
    elif camtype == "architect":
        # tilted UP: the vertical-line-preserving projection is distinct
        # from perspective here (measured mean 1.7% / p99 9.8% at 24 spp)
        cam.update({"from": (0.5, -1.35, 0.2), "to": (0.5, 0.5, 0.8),
                    "up": (0.5, -1.6, 1.1), "fov": 39.0})
    else:
        cam.update({"from": (0.5, 0.5, 0.5), "to": (0.5, 1.5, 0.5),
                    "up": (0.5, 0.5, 1.5)})
    b.cameras["cam"] = P.ParamMap(cam)
    scene = b.compile("cam")
    cfg = make_integrator({"type": "directlighting"})
    film = render(scene, cfg, 128, 128, spp=24)
    img = np.asarray(F.resolve(film, "combined"))[..., :3] * np.pi
    assert np.isfinite(img).all()
    scale = img.mean() / ref.mean()
    assert abs(scale - 1.0) < 0.01, f"global radiance scale off: {scale}"
    rd, od = _downsample(ref), _downsample(img)
    lit = rd.max(-1) > 0.03
    reld = np.abs(od - rd).max(-1)[lit] / rd.max(-1)[lit]
    assert reld.mean() < tol_mean, f"downsampled mean rel {reld.mean():.4f}"
    p99 = float(np.percentile(reld, 99))
    assert p99 < tol_p99, f"downsampled p99 {p99:.4f}"


@pytest.mark.refparity
@pytest.mark.timeout(600)
@pytest.mark.parametrize("bgtype,golden,tol_mean,tol_p99", [
    ("sunsky", "sky_sunsky_128.hdr", 0.02, 0.10),
    ("darksky", "sky_darksky_128.hdr", 0.01, 0.03),
])
def test_sky_backgrounds_match_reference_render(bgtype, golden,
                                                tol_mean, tol_p99):
    """Analytic skies vs the reference binary's own equirect panorama of
    the empty sky (tools/refparity/sky_ref.c) — the image IS the
    background function, so this pins Preetham sunsky and the darksky
    variant point-for-point over the dome. This comparison FOUND and
    fixed real gaps (r5): sunsky lacked the reference's 1/15000
    luminance scale, clampRgb01, below-horizon stretch (theta clamped to
    the horizon incl. the sun angle, smoothstep fade) and the night fade
    — pre-fix mean relative error 86%, post-fix 0.58%; darksky lacked
    the hardcoded gamma encode (v^(1/2.2)) + clamp (its clamp_rgb/
    gamma_enc getParams are commented out in the reference) and the
    double application of `bright` — pre-fix 46%, post-fix 0.27%.
    Residual error is the 4-spp pixel-jitter of both renders;
    tolerances ~3x the measured values. NOTE: backgrounds are compared
    WITHOUT the pi factor — they are camera-ray radiance on both sides
    (no BRDF in the path)."""
    ref = np.asarray(
        yio.load_hdr(os.path.join(GOLDEN, golden)))[..., :3]
    b = SceneBuilder()
    b.create_material("m", {"type": "shinydiffusemat",
                            "color": (0.5, 0.5, 0.5)})
    b.create_object("dummy")
    b.set_current_material("m")
    a0 = b.add_vertex(500, 500, -500)
    a1 = b.add_vertex(501, 500, -500)
    a2 = b.add_vertex(500, 501, -500)
    b.add_triangle(a0, a1, a2)
    bgp = {"type": bgtype, "from": (0.4, 0.3, 0.6), "turbidity": 3.0,
           "power": 1.0, "add_sun": False, "background_light": False}
    if bgtype == "darksky":
        bgp.update({"altitude": 0.0, "night": False, "exposure": 1.0})
    b.create_background(bgp)
    b.create_camera("cam", {"type": "equirectangular", "resx": 128,
                            "resy": 128, "from": (0, 0, 0), "to": (0, 1, 0),
                            "up": (0, 0, 1)})
    scene = b.compile("cam")
    cfg = make_integrator({"type": "directlighting"})
    film = render(scene, cfg, 128, 128, spp=4)
    img = np.asarray(F.resolve(film, "combined"))[..., :3]
    assert np.isfinite(img).all()
    scale = img.mean() / ref.mean()
    assert abs(scale - 1.0) < 0.01, f"global radiance scale off: {scale}"
    lit = ref.max(-1) > 0.01
    rel = np.abs(img - ref).max(-1)[lit] / ref.max(-1)[lit]
    assert rel.mean() < tol_mean, f"mean rel {rel.mean():.4f}"
    p99 = float(np.percentile(rel, 99))
    assert p99 < tol_p99, f"p99 {p99:.4f}"
