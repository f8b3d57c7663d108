"""Benchmark: camera rays/s on one GPU across the BASELINE.md configs.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}

Headline (value/vs_baseline): the flagship wavefront path tracer on the
Cornell box (NEE+MIS, 4 bounces, RR) — each timed step renders one
full-resolution sample pass AND computes the gradient of the pass's image
mean w.r.t. all material diffuse albedos (fwd+bwd, the BASELINE.json
metric). "Rays" counts camera rays (width*height*spp).

`extra` carries the remaining BASELINE.md configs measured on the same
card:
  - bigmesh: config 3 — ~200k-tri textured terrain + env background
    (the large-scene traversal regime: the jnp block loop in
    accel/blocks.py), with the heaviest device ops from the profiler.
  - glossy: config 2 — Cornell + glossy box, 4-bounce PT.
  - caustic: config 4 — dielectric caustics, fwd+bwd with IOR/texel grads.
  - volume: config 5 — homogeneous scattering volume + emissive mesh.

A 'bigmesh_lbvh' config (the bigmesh scene with scene_accelerator='bvh',
i.e. the LBVH per-ray walk) exists but is NOT in the default sweep; run
it with BENCH_CONFIGS=bigmesh_lbvh.

Every entry names the device it ran on: JAX's platform, device kind and
device count, and the card's name and power limit from nvidia-smi. The
benchmark measures the GPU only; on another platform a config fails.

ISOLATION: each config runs in its OWN subprocess (this file re-invoked
with BENCH_CONFIGS=<one config>), one at a time, so a device fault costs
one number. The parent never initialises a JAX backend: a JAX process
reserves most of the card's memory when it first touches it, so only one
process may hold the card at a time. The exit code is non-zero if any
config errored or hit its time cap.

The reference (libYafaRay) publishes no numbers (BASELINE.md), so the
baseline is MEASURED: a C client against the reference library renders the
Cornell scene with the same integrator settings (BASELINE_MEASURED.json,
350,724 rays/s forward-only on the host CPU); vs_baseline = ours / that.
Note ours additionally includes the backward pass.

Env overrides: BENCH_WIDTH/HEIGHT/SPP/BOUNCES, BENCH_BUDGET_S (per-config
time cap), BENCH_MESH_RES, BENCH_CONFIGS (comma list, default all),
BENCH_ISOLATE=0 to run in-process (debugging).
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

ALL_CONFIGS = ("cornell", "bigmesh", "glossy", "caustic", "volume")


def _jax_setup():
    import jax
    from libyafaray_tpu.utils.cache import setup_compile_cache
    setup_compile_cache(min_compile_secs=2.0)
    if jax.devices()[0].platform != "gpu":
        raise RuntimeError(
            f"bench measures the GPU; found {jax.devices()[0].platform}")
    return jax


# ---------------------------------------------------------------- configs


def cornell_fwd_bwd_setup(width: int, height: int, bounces: int = 4,
                          rows_per_chunk: int = 270):
    """The headline step: the Cornell scene, a jitted fwd+bwd chunk step
    (one sample pass over a chunk of pixels plus d(mean rgb)/d(material
    diffuse albedos)) and the pixel chunks (px, py, pid), padded to one
    static shape. Returns (scene, step, chunks); step(scene, px, py, pid,
    sidx) -> (rgb, alpha, grad)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from libyafaray_tpu import make_integrator
    from libyafaray_tpu.cameras import shoot_rays
    from libyafaray_tpu.integrators.mc import integrate
    from libyafaray_tpu import sampler
    from scenes import cornell_builder

    b = cornell_builder()
    b.cameras["cam"]["resx"] = width
    b.cameras["cam"]["resy"] = height
    scene = b.compile("cam")  # brute accel: the fused MT kernel on a GPU
    cfg = make_integrator({"type": "pathtracing", "bounces": bounces})
    n_chunk = min(rows_per_chunk, height) * width

    def chunk_loss(diffuse_color, scene, px, py, pid, sidx):
        sc = scene.replace(
            materials=scene.materials.replace(diffuse_color=diffuse_color))
        lu = sampler.rand1(pid, sidx, 0, 777)
        lv = sampler.rand1(pid, sidx, 0, 778)
        o, d, valid = shoot_rays(sc.camera, px, py, lu, lv)
        rgb, alpha, _ = integrate(sc, cfg, o, d, valid, pid, sidx)
        return jnp.mean(rgb), (rgb, alpha)

    @jax.jit
    def fwd_bwd_chunk(scene, px, py, pid, sidx):
        (loss, (rgb, alpha)), g = jax.value_and_grad(
            chunk_loss, has_aux=True)(scene.materials.diffuse_color, scene,
                                      px, py, pid, sidx)
        return rgb, alpha, g

    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    pid_all = (yy * width + xx).reshape(-1).astype(np.uint32)
    px_all = (xx.reshape(-1) + 0.5).astype(np.float32)
    py_all = (yy.reshape(-1) + 0.5).astype(np.float32)
    n_pix = width * height
    chunks = []
    for c0 in range(0, n_pix, n_chunk):
        c1 = min(c0 + n_chunk, n_pix)
        if c1 - c0 < n_chunk:  # pad to a single static shape
            pad = n_chunk - (c1 - c0)
            sl = np.r_[np.arange(c0, c1), np.full(pad, c0)]
        else:
            sl = np.arange(c0, c1)
        chunks.append((jnp.asarray(px_all[sl]), jnp.asarray(py_all[sl]),
                       jnp.asarray(pid_all[sl])))
    return scene, fwd_bwd_chunk, chunks


def caustic_fwd_bwd_setup(width: int, height: int, bounces: int = 5):
    """BASELINE.md config 4: glass-in-Cornell caustic scene with gradients
    flowing to the glass IOR and a floor albedo texture's texel pool
    (through uv + bilinear sampling). Returns (scene, step, (px, py,
    pid)); step(scene, px, py, pid, sidx) -> (loss, (g_ior, g_texels))."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from libyafaray_tpu import make_integrator
    from libyafaray_tpu.cameras import shoot_rays
    from libyafaray_tpu.integrators.mc import integrate
    from libyafaray_tpu import sampler
    from scenes import caustic_grad_builder

    scene = caustic_grad_builder(width, height).compile("cam")
    cfg = make_integrator({"type": "pathtracing", "bounces": bounces})

    def loss_fn(theta, scene, px, py, pid, sidx):
        ior, texels = theta
        sc = scene.replace(
            materials=scene.materials.replace(ior=ior),
            textures=scene.textures.replace(texel_pool=texels))
        lu = sampler.rand1(pid, sidx, 0, 777)
        lv = sampler.rand1(pid, sidx, 0, 778)
        o, d, valid = shoot_rays(sc.camera, px, py, lu, lv)
        rgb, alpha, _ = integrate(sc, cfg, o, d, valid, pid, sidx)
        return jnp.mean(rgb)

    @jax.jit
    def fwd_bwd(scene, px, py, pid, sidx):
        theta = (scene.materials.ior, scene.textures.texel_pool)
        return jax.value_and_grad(loss_fn)(theta, scene, px, py, pid, sidx)

    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    pid = jnp.asarray((yy * width + xx).reshape(-1).astype(np.uint32))
    px = jnp.asarray((xx.reshape(-1) + 0.5).astype(np.float32))
    py = jnp.asarray((yy.reshape(-1) + 0.5).astype(np.float32))
    return scene, fwd_bwd, (px, py, pid)


def bench_cornell_fwd_bwd(budget_s: float):
    """Headline: fwd+bwd rays/s on the Cornell PT scene."""
    _jax_setup()
    import jax.numpy as jnp

    width = int(os.environ.get("BENCH_WIDTH", 1920))
    height = int(os.environ.get("BENCH_HEIGHT", 1080))
    spp = int(os.environ.get("BENCH_SPP", 16))
    bounces = int(os.environ.get("BENCH_BOUNCES", 4))
    rows_per_chunk = int(os.environ.get("BENCH_CHUNK_ROWS", 270))
    scene, fwd_bwd_chunk, chunks = cornell_fwd_bwd_setup(
        width, height, bounces, rows_per_chunk)
    n_chunk = chunks[0][0].shape[0]

    r, a, g = fwd_bwd_chunk(scene, *chunks[0], jnp.uint32(0))
    r.block_until_ready()

    t0 = time.time()
    done_rays = 0
    done_chunks = 0
    deadline = t0 + budget_s
    for s in range(spp):
        for ch in chunks:
            r, a, g = fwd_bwd_chunk(scene, *ch, jnp.uint32(s))
            done_rays += n_chunk
            done_chunks += 1
        r.block_until_ready()
        if time.time() > deadline:
            break
    r.block_until_ready()
    dt = time.time() - t0
    info = dict(width=width, height=height, bounces=bounces)
    # timing sanity guard (see _bench_render): one fresh re-measured chunk
    # must agree with the loop's per-chunk time
    t1 = time.time()
    r, a, g = fwd_bwd_chunk(scene, *chunks[0], jnp.uint32(spp + 1))
    r.block_until_ready()
    dt_check = (time.time() - t1) * done_chunks
    if dt < 0.25 * dt_check:
        info["timing_suspect"] = f"loop {dt:.3f}s vs check {dt_check:.3f}s"
        dt = dt_check
    return done_rays / dt, info


def bench_caustic_grad(budget_s: float):
    """BASELINE.md config 4, fwd+bwd rays/s (see caustic_fwd_bwd_setup)."""
    _jax_setup()
    import jax.numpy as jnp

    width = height = int(os.environ.get("BENCH_CAUSTIC_RES", 512))
    bounces = 5
    scene, fwd_bwd, (px, py, pid) = caustic_fwd_bwd_setup(width, height,
                                                          bounces)
    n = width * height

    loss, g = fwd_bwd(scene, px, py, pid, jnp.uint32(0))
    loss.block_until_ready()
    g_ior = float(jnp.abs(g[0]).sum())
    g_tex = float(jnp.abs(g[1]).sum())

    t0 = time.time()
    deadline = t0 + budget_s
    done = 0
    s = 1
    while True:
        loss, g = fwd_bwd(scene, px, py, pid, jnp.uint32(s))
        done += n
        s += 1
        if s % 2 == 0:
            loss.block_until_ready()
            if time.time() > deadline or s > 32:
                break
    loss.block_until_ready()
    dt = time.time() - t0
    return done / dt, dict(res=f"{width}x{height}", bounces=bounces,
                           grad_ior_l1=g_ior, grad_texel_l1=g_tex)


def _bench_render(builder, cfg_pm, budget_s: float, spp_target: int = 8,
                  profile: bool = False):
    """Forward rays/s through the public render() loop (film scatter-add,
    adaptive mask off). Returns (rays_per_sec, extras)."""
    jax = _jax_setup()
    import jax.numpy as jnp
    from libyafaray_tpu import make_integrator, film as F
    from libyafaray_tpu.render import _render_pass_jit

    scene = builder.compile("cam")
    cfg = make_integrator(cfg_pm)
    # same preprocess render() runs: per-light volume attenuation grid
    # (single-scatter "optimize" mode, integrator_single_scatter.cc:35-108)
    if (scene.volumes is not None and cfg.vol_kind == "single_scatter"
            and cfg.vol_optimize and scene.vol_atten is None
            and scene.lights.num_lights > 0):
        from libyafaray_tpu.integrators.volume import build_attenuation_grid
        scene = scene.replace(vol_atten=jax.jit(build_attenuation_grid)(scene))
    w = scene.camera.resx
    h = scene.camera.resy
    film = F.make_film(w, h)
    # warmup/compile
    film = _render_pass_jit(scene, cfg, film, jnp.uint32(0), None)
    film.weights.block_until_ready()
    # airtight timing: block after EVERY pass (a queued-but-unfinished
    # dispatch once produced a wildly flattering number when a
    # block_until_ready returned early; per-pass blocking costs <1% at
    # these pass sizes and makes the clock honest)
    t0 = time.time()
    deadline = t0 + budget_s
    passes = 0
    for s in range(1, spp_target + 1):
        film = _render_pass_jit(scene, cfg, film, jnp.uint32(s), None)
        film.weights.block_until_ready()
        passes += 1
        if time.time() > deadline:
            break
    dt = time.time() - t0
    extras = {"res": f"{w}x{h}", "passes": passes}
    # sanity guard (a faulted device can return from block_until_ready
    # at once and produce an impossible reading): re-execute one pass with
    # a fresh timer and require agreement
    t1 = time.time()
    film = _render_pass_jit(scene, cfg, film, jnp.uint32(passes + 1), None)
    film.weights.block_until_ready()
    dt_check = time.time() - t1
    if dt / max(passes, 1) < 0.25 * dt_check:
        extras["timing_suspect"] = (
            f"loop {dt/max(passes,1):.4f}s/pass vs check {dt_check:.4f}s")
        dt = dt_check * passes  # report the conservative number
    if profile:
        import shutil
        from libyafaray_tpu.utils.profiling import device_op_summary
        tdir = os.path.join(REPO, ".bench_trace")
        shutil.rmtree(tdir, ignore_errors=True)
        with jax.profiler.trace(tdir):
            film = _render_pass_jit(scene, cfg, film, jnp.uint32(999), None)
            film.weights.block_until_ready()
        extras["top_device_ops_ms"] = [
            [name[:60], ms] for name, ms, _ in device_op_summary(tdir, top=6)]
    return passes * w * h / dt, extras


def run_one(config: str, budget: float):
    """Run a single config in THIS process; returns its extra dict entry
    (key, payload). The headline config also returns rays/s as payload
    ['rays_per_sec']."""
    if config == "cornell":
        rps, info = bench_cornell_fwd_bwd(budget)
        return "cornell_fwd_bwd", {"rays_per_sec": rps, **info}
    if config == "bigmesh":
        from scenes import bigmesh_builder
        res = int(os.environ.get("BENCH_MESH_RES", 320))
        rps, info = _bench_render(
            bigmesh_builder(res), {"type": "pathtracing", "bounces": 2},
            budget, spp_target=6, profile=True)
        ntris = 2 * (res - 1) * (res - 1)
        return "bigmesh_203k", {"rays_per_sec": rps,
                                "triangles": ntris, **info}
    if config == "bigmesh_lbvh":
        # the bigmesh scene through the LBVH per-ray walk (accel/lbvh.py)
        # instead of the block loop; not in the default sweep
        from scenes import bigmesh_builder
        res = int(os.environ.get("BENCH_MESH_RES", 320))
        b_bvh = bigmesh_builder(res)
        b_bvh.set_render_params({"scene_accelerator": "bvh"})
        rps, info = _bench_render(
            b_bvh, {"type": "pathtracing", "bounces": 2},
            min(budget, 60), spp_target=4)
        return "bigmesh_lbvh", {"rays_per_sec": rps, **info}
    if config == "glossy":
        from scenes import glossy_cornell_builder
        b = glossy_cornell_builder()
        b.cameras["cam"]["resx"] = 512
        b.cameras["cam"]["resy"] = 512
        rps, info = _bench_render(
            b, {"type": "pathtracing", "bounces": 4}, budget, spp_target=16)
        return "glossy_cornell", {"rays_per_sec": rps, **info}
    if config == "caustic":
        rps, info = bench_caustic_grad(budget)
        return "caustic_grad", {"rays_per_sec": rps, **info}
    if config == "volume":
        from scenes import volume_emissive_builder
        b = volume_emissive_builder()
        b.cameras["cam"]["resx"] = 512
        b.cameras["cam"]["resy"] = 512
        # NOT "optimize": for a HOMOGENEOUS volume the analytic sigma
        # march needs no attenuation-grid trilinear gathers; the grid mode
        # is for grid/noise volumes where sigma lookups are themselves
        # gathers (not measured on the GPU)
        rps, info = _bench_render(
            b, {"type": "pathtracing", "bounces": 3}, budget, spp_target=8)
        return "volume_emissive", {"rays_per_sec": rps, **info}
    raise ValueError(f"unknown config {config!r}")


_KEY_BY_CONFIG = {"cornell": "cornell_fwd_bwd", "bigmesh": "bigmesh_203k",
                  "glossy": "glossy_cornell", "caustic": "caustic_grad",
                  "volume": "volume_emissive",
                  "bigmesh_lbvh": "bigmesh_lbvh"}


def _run_in_process(cfg: str, budget: float) -> dict:
    """One config in this process; its payload names the device."""
    from libyafaray_tpu.utils.sysinfo import device_record
    try:
        key, payload = run_one(cfg, budget)
        payload["device"] = device_record()
        return {key: payload}
    except Exception as exc:
        return {_KEY_BY_CONFIG[cfg]: {"error": f"{type(exc).__name__}: "
                                               f"{str(exc)[:400]}"}}


def _run_isolated(cfg: str, budget: float) -> dict:
    """One config in a child process (the parent stays off JAX, so only
    the child holds the card). Children run one at a time."""
    env = dict(os.environ, BENCH_CONFIGS=cfg, BENCH_ISOLATE="0",
               BENCH_EMIT="partial")
    cap = budget * 2 + 900        # compilation included
    try:
        p = subprocess.run([sys.executable, os.path.abspath(__file__)],
                           env=env, capture_output=True, text=True,
                           timeout=cap)
    except subprocess.TimeoutExpired:
        return {_KEY_BY_CONFIG[cfg]: {"error": f"timeout after {cap:.0f}s"}}
    line = next((ln for ln in reversed(p.stdout.strip().splitlines())
                 if ln.startswith("{")), None)
    if line is None:
        return {_KEY_BY_CONFIG[cfg]: {
            "error": f"no JSON (rc={p.returncode}): "
                     + (p.stderr or p.stdout)[-400:]}}
    return json.loads(line)["extra"]


def main() -> int:
    budget = float(os.environ.get("BENCH_BUDGET_S", 150))
    configs = [c for c in os.environ.get(
        "BENCH_CONFIGS", ",".join(ALL_CONFIGS)).split(",") if c]
    isolate = os.environ.get("BENCH_ISOLATE", "1") != "0" and len(configs) > 1

    extra = {}
    for cfg in configs:
        extra.update(_run_isolated(cfg, budget) if isolate
                     else _run_in_process(cfg, budget))
    failed = sorted(k for k, v in extra.items() if "error" in v)

    if os.environ.get("BENCH_EMIT") == "partial":
        print(json.dumps({"extra": extra}))
        return 1 if failed else 0

    rays_per_sec = float(
        extra.get("cornell_fwd_bwd", {}).get("rays_per_sec", 0.0))
    with open(os.path.join(REPO, "BASELINE_MEASURED.json")) as fh:
        base = float(json.load(fh)["baseline_rays_per_sec"])
    device = next((v["device"] for v in extra.values() if "device" in v),
                  None)
    print(json.dumps({
        "metric": "camera rays/sec on one GPU, fwd+bwd, cornell path "
                  "tracing 1920x1080 4b; baseline = measured reference CPU "
                  "fwd-only rays/s; extra: fwd-only rays/s for BASELINE.md "
                  "configs 2 (glossy), 3 (203k-tri mesh + env), 5 (volume + "
                  "emissive mesh), fwd+bwd rays/s for config 4 (caustic + "
                  "IOR/texel gradients)",
        "value": rays_per_sec,
        "unit": "rays/s",
        "vs_baseline": rays_per_sec / base,
        "device": device,
        "failed": failed,
        "extra": extra,
    }))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
