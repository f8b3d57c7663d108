"""On-card smoke test: drives the renderer's main paths once on one NVIDIA
GPU and checks what comes out.

    python chip_smoke.py               # one card (all phases below)
    python chip_smoke.py --four-cards  # only the 4-card sharded path

Phases (one line each; any failure raises and exits non-zero, no phase
catches and continues):
  1. device: a GPU is required (no CPU fallback); prints the device kind,
     the card's name and power limit, the JAX version and the cache dir.
  2. kernels: the Triton Möller-Trumbore kernel vs the jnp scan on the
     same card at 518,400 rays x the Cornell table and x 2,047 random
     triangles (camera, shadow and motion-blurred rays); the block loop vs
     the brute query on the 203k-triangle bigmesh; and the Triton custom
     call present in the compiled render pass.
  3. Cornell 1920x1080, 4-bounce path tracing, 2 spp through render():
     plausibility (red left wall, green right wall) and a 64x64 render of
     the same scene and seed on the GPU (whose square frame sees the lamp:
     max = its radiance 12) vs the CPU backend of this process.
  4. fwd+bwd: the Cornell 1080p chunk step (bench.py's headline) and the
     caustic 512x512 step with IOR and texel gradients: finite non-zero
     losses and gradients, and GPU vs CPU at 64x64.
  5. the 203k-triangle bigmesh at 720x720, 2 passes through render() on
     the block loop: finite output.
Each phase line carries its wall time (compilation included) and, where
rays are traced, the steady-state rays/s beside the card's name and power
limit. The last line is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Tolerances, GPU vs the CPU backend: both run the same counter-based
sampler with the same seeds, so images differ only through float
arithmetic — FMA contraction and other instruction choices, the order of
the atomic film scatter-add, and transcendental implementations. A
rounding difference that flips a Russian-roulette or hit/miss decision
changes that path entirely, so a few pixels may differ by O(1) while the
rest agree to ~1e-6; hence a tolerance on the image mean and on the 99th
percentile of the per-pixel difference, not on the maximum.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

# kernel vs scan on one card (same float32 arithmetic, different order)
KERNEL_T_RTOL = 1e-5
KERNEL_UV_ATOL = 1e-5
# rays whose hit/miss or prim differs by an edge-rounding (a ray through a
# triangle edge or vertex, where two orderings of the same MT arithmetic
# can disagree), as a fraction of all rays
KERNEL_EDGE_FRAC = 1e-4
# GPU vs CPU renders (see module docstring). On an H100, 2.0% of the
# pixels of a 64x64 2-spp Cornell render differ by more than 1e-3 (one
# diverged path in a pixel moves it by O(0.01-0.3) / spp), so the 99th
# percentile sits in that tail: measured 0.0187, image mean rel 2.6e-4.
IMG_MEAN_RTOL = 2e-3
IMG_P99_ATOL = 5e-2
# gradients: albedo and IOR measured 1.5e-3 and 1.9e-3 rel L2; the texel
# gradient 2.4e-2 (each texel sums few pixels, so a diverged path weighs
# more)
GRAD_RTOL = 5e-2
# four cards vs one card: the same GPU code on every pixel; only the
# film scatter order and XLA's per-shape fusion choices differ, which can
# still flip a few paths
SHARD_MEAN_RTOL = 1e-3
SHARD_P99_ATOL = 2e-2

# workload sizes (the card's real widths; a CPU rehearsal shrinks them)
FULL = (1920, 1080)       # Cornell render and fwd+bwd chunk width/height
CHUNK_ROWS = 270          # 270 rows x 1920 = 518,400 rays (bench.py chunk)
RAND_TRIS = 2047          # largest scene the brute query serves
MESH_RES = 320            # bigmesh grid: 2*(320-1)^2 = 203,522 triangles
MESH_IMG = 720
MESH_RAYS = 65536         # per ray kind in the block-loop check
CAUSTIC = 512
SMALL = 64                # GPU vs CPU comparisons

CARD = ""


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.time()
    log(f"[{name}] start")
    info = {}
    yield info
    extra = "".join(f" {k}={v}" for k, v in info.items())
    log(f"[{name}] ok in {time.time() - t0:.1f}s{extra} | card: {CARD}")


def timed(fn, reps: int = 3):
    """Median wall seconds of fn() (which must block), after one warmup."""
    import numpy as np
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def check_image_close(tag, a, b, mean_rtol, p99_atol):
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (tag, a.shape, b.shape)
    assert np.isfinite(a).all() and np.isfinite(b).all(), tag
    diff = np.abs(a - b)
    mean_rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    p99 = float(np.percentile(diff, 99))
    log(f"  {tag}: mean {a.mean():.6g} vs {b.mean():.6g} "
        f"(rel {mean_rel:.3g}, tol {mean_rtol}), p99 |diff| {p99:.3g} "
        f"(tol {p99_atol}), max |diff| {diff.max():.3g}, "
        f"pixels > 1e-3: {(diff.max(axis=-1) > 1e-3).mean():.3%}")
    assert mean_rel <= mean_rtol, f"{tag}: image mean differs {mean_rel}"
    assert p99 <= p99_atol, f"{tag}: p99 pixel difference {p99}"


def check_close(tag, a, b, rtol):
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert np.isfinite(a).all() and np.isfinite(b).all(), tag
    err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
    log(f"  {tag}: rel L2 {err:.3g} (tol {rtol}), |a| {np.abs(a).sum():.6g}"
        f" |b| {np.abs(b).sum():.6g}")
    assert err <= rtol, f"{tag}: GPU vs CPU rel L2 {err}"


# ------------------------------------------------------------------ phase 1

def device_phase():
    global CARD
    import jax
    from libyafaray_tpu.utils.cache import setup_compile_cache
    from libyafaray_tpu.utils.sysinfo import gpu_name_and_power_limit
    with phase("device") as info:
        cache_dir = setup_compile_cache()
        devs = jax.devices()
        if devs[0].platform != "gpu":
            raise SystemExit(
                f"chip_smoke needs a GPU; JAX found {devs[0].platform}")
        CARD = gpu_name_and_power_limit()
        log(CARD)
        info.update(kind=repr(devs[0].device_kind), count=len(devs),
                    jax=jax.__version__, cache=cache_dir)
    return devs


# ------------------------------------------------------------------ phase 2

def kernel_parity(tag, geom, o, d, t_min, t_max, excl, shadow=False,
                  time_=None):
    """Compiled Triton kernel vs the jnp scan, both on the GPU. Returns
    (kernel seconds, scan seconds)."""
    import jax
    import numpy as np
    from libyafaray_tpu.accel.pallas_intersect import mt_query, pack_tris
    from libyafaray_tpu.ops import intersect as I
    fc = geom.faces
    tabs = [pack_tris(vt[fc[:, 0]], vt[fc[:, 1]], vt[fc[:, 2]],
                      geom.face_vis)
            for vt in (geom.vertices, geom.vertices_t1, geom.vertices_t2)
            if vt is not None]
    motion = time_ is not None
    kern = jax.jit(lambda *a: mt_query(
        *a, time=time_ if motion else None,
        tris_t1=tabs[1] if motion else None,
        tris_t2=tabs[2] if motion and len(tabs) > 2 else None,
        shadow=shadow))
    scan = jax.jit(lambda g, *a: I._scan_branch(g, *a, shadow, time_))
    kt, kp, ku, kv = jax.block_until_ready(
        kern(tabs[0], o, d, t_min, t_max, excl))
    st, sp, suv = jax.block_until_ready(scan(geom, o, d, t_min, t_max, excl))
    t_k = timed(lambda: jax.block_until_ready(
        kern(tabs[0], o, d, t_min, t_max, excl)))
    t_s = timed(lambda: jax.block_until_ready(
        scan(geom, o, d, t_min, t_max, excl)))
    kt, kp, ku, kv = (np.asarray(x) for x in (kt, kp, ku, kv))
    st, sp, suv = (np.asarray(x) for x in (st, sp, suv))
    n = kp.shape[0]
    kh, sh = kp >= 0, sp >= 0
    mask_diff = int((kh != sh).sum())
    log(f"  {tag}: n={n} tris={geom.num_faces} hits {int(sh.sum())} "
        f"hit-mask diffs {mask_diff} kernel {t_k*1e3:.3f} ms "
        f"scan {t_s*1e3:.3f} ms ({n/t_k/1e6:.1f} vs {n/t_s/1e6:.1f} "
        f"Mrays/s)")
    edge = KERNEL_EDGE_FRAC * n
    assert mask_diff <= edge, f"{tag}: {mask_diff} hit/miss disagreements"
    both = kh & sh
    same = both & (kp == sp)
    tie = np.abs(kt - st) <= KERNEL_T_RTOL * np.abs(st)
    bad_prim = int((both & (kp != sp) & ~tie).sum())
    t_err = float((np.abs(kt - st) / np.abs(st))[same].max(initial=0.0))
    uv_err = float(np.maximum(np.abs(ku - suv[:, 0]),
                              np.abs(kv - suv[:, 1]))[same].max(initial=0.0))
    log(f"    prim diffs (not ties) {bad_prim}, max t rel err {t_err:.3g}, "
        f"max uv err {uv_err:.3g}")
    assert bad_prim <= edge, f"{tag}: {bad_prim} prim disagreements"
    assert t_err <= KERNEL_T_RTOL, f"{tag}: t rel err {t_err}"
    assert uv_err <= KERNEL_UV_ATOL, f"{tag}: uv err {uv_err}"
    return t_k, t_s


def _random_tri_geom(rng, f, template):
    import jax.numpy as jnp
    import numpy as np
    c = rng.uniform(0.0, 1.0, (f, 1, 3))
    v = (c + rng.normal(0.0, 0.06, (f, 3, 3))).reshape(-1, 3)
    faces = np.arange(3 * f, dtype=np.int32).reshape(f, 3)
    vis = np.full(f, 3, np.int32)
    vis[::13] = 1
    return template.replace(
        vertices=jnp.asarray(v, jnp.float32), faces=jnp.asarray(faces),
        face_vis=jnp.asarray(vis), vertices_t1=None, vertices_t2=None,
        num_faces=f, num_base_faces=f, has_motion=False)


def kernels_phase():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bench import cornell_fwd_bwd_setup
    from libyafaray_tpu import sampler
    from libyafaray_tpu.cameras import shoot_rays
    from libyafaray_tpu.ops import intersect as I
    from libyafaray_tpu.ops.intersect import closest_hit
    from scenes import bigmesh_builder
    with phase("kernels") as info:
        scene, _, chunks = cornell_fwd_bwd_setup(*FULL, 4, CHUNK_ROWS)
        px, py, pid = chunks[0]                 # 518,400 rays
        n = px.shape[0]
        lu = sampler.rand1(pid, jnp.uint32(0), 0, 777)
        o, d, _ = shoot_rays(scene.camera, px, py, lu, lu)
        rng = np.random.default_rng(1)
        ro = jnp.asarray(rng.uniform(0.02, 0.98, (n, 3)), jnp.float32)
        rd = rng.normal(size=(n, 3))
        rd = jnp.asarray(rd / np.linalg.norm(rd, axis=1, keepdims=True),
                         jnp.float32)
        t_min = jnp.full((n,), 1e-4, jnp.float32)
        t_max = jnp.full((n,), 1e30, jnp.float32)
        excl = jnp.asarray(np.where(np.arange(n) % 5 == 0, 3, -1), jnp.int32)
        geom = scene.geom
        times = {}
        times["cornell_closest"] = kernel_parity(
            "cornell closest, camera rays", geom, o, d, t_min, t_max, excl)
        times["cornell_shadow"] = kernel_parity(
            "cornell shadow rays", geom, ro, rd, t_min,
            jnp.full((n,), 0.5, jnp.float32), excl, shadow=True)
        mgeom = geom.replace(
            vertices_t1=geom.vertices + jnp.asarray(
                rng.normal(0.0, 0.02, geom.vertices.shape), jnp.float32),
            has_motion=True)
        tq = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
        kernel_parity("cornell motion blur", mgeom, ro, rd, t_min, t_max,
                      excl, time_=tq)
        rgeom = _random_tri_geom(rng, RAND_TRIS, geom)
        times["random_closest"] = kernel_parity(
            f"{RAND_TRIS} random tris closest", rgeom, ro, rd, t_min, t_max,
            excl)
        times["random_shadow"] = kernel_parity(
            f"{RAND_TRIS} random tris shadow rays", rgeom, ro, rd, t_min,
            jnp.full((n,), 0.3, jnp.float32), excl, shadow=True)

        # block loop vs brute query on the 203k-triangle bigmesh
        big = bigmesh_builder(MESH_RES).compile("cam")
        assert big.accel_kind == "blocks"
        assert big.geom.num_faces == 2 * (MESH_RES - 1) ** 2
        m = MESH_RAYS
        side = int(np.sqrt(m))
        yy, xx = np.meshgrid(np.linspace(0, MESH_IMG - 1, side),
                             np.linspace(0, MESH_IMG - 1, side),
                             indexing="ij")
        bpx = jnp.asarray(xx.reshape(-1) + 0.5, jnp.float32)
        bpy = jnp.asarray(yy.reshape(-1) + 0.5, jnp.float32)
        half = jnp.full((m,), 0.5, jnp.float32)
        po, pd, _ = shoot_rays(big.camera, bpx, bpy, half, half)
        qo = jnp.asarray(np.stack([rng.uniform(0, 4, m), rng.uniform(0, 4, m),
                                   rng.uniform(0.5, 1.5, m)], -1),
                         jnp.float32)
        qd = rng.normal(size=(m, 3))
        qd = jnp.asarray(qd / np.linalg.norm(qd, axis=1, keepdims=True),
                         jnp.float32)
        bo = jnp.concatenate([po, qo])
        bd = jnp.concatenate([pd, qd])
        nb = 2 * m
        blk = jax.jit(lambda sc, o_, d_: closest_hit(sc, o_, d_, 1e-4, 1e30))
        brute = jax.jit(lambda g, o_, d_: I._brute_closest(
            g, o_, d_, jnp.full((nb,), 1e-4), jnp.full((nb,), 1e30)))
        hb = jax.block_until_ready(blk(big, bo, bd))
        hr = jax.block_until_ready(brute(big.geom, bo, bd))
        vb, vr = np.asarray(hb.valid), np.asarray(hr.valid)
        both = vb & vr
        pb, pr = np.asarray(hb.prim), np.asarray(hr.prim)
        tb, tr = np.asarray(hb.t), np.asarray(hr.t)
        tie = np.abs(tb - tr) <= KERNEL_T_RTOL * np.abs(tr)
        mask_diff = int((vb != vr).sum())
        bad = int((both & (pb != pr) & ~tie).sum())
        t_err = float((np.abs(tb - tr) / np.abs(tr))[both & (pb == pr)].max())
        t_blk = timed(lambda: jax.block_until_ready(blk(big, bo, bd)))
        t_brute = timed(lambda: jax.block_until_ready(
            brute(big.geom, bo, bd)), reps=1)
        log(f"  bigmesh blocks vs brute: n={nb} hits {int(vr.sum())} "
            f"hit-mask diffs {mask_diff} prim diffs {bad} t rel err "
            f"{t_err:.3g}; block loop {t_blk*1e3:.1f} ms, brute kernel "
            f"{t_brute*1e3:.1f} ms ({nb/t_blk/1e6:.2f} vs "
            f"{nb/t_brute/1e6:.2f} Mrays/s)")
        assert mask_diff <= KERNEL_EDGE_FRAC * nb and bad <= (
            KERNEL_EDGE_FRAC * nb) and t_err <= KERNEL_T_RTOL

        # the kernel really runs inside the compiled render pass
        from libyafaray_tpu import film as F, make_integrator
        from libyafaray_tpu.render import _render_pass_jit
        cfg = make_integrator({"type": "pathtracing", "bounces": 4})
        hlo = _render_pass_jit.lower(
            _cornell(SMALL), cfg, F.make_film(SMALL, SMALL), jnp.uint32(0),
            jnp.ones((SMALL, SMALL), jnp.float32)).compile().as_text()
        n_calls = hlo.count("triton")
        log(f"  compiled render pass: {n_calls} mention(s) of triton, "
            f"'mt_query' present: {'mt_query' in hlo}")
        assert n_calls > 0 and "mt_query" in hlo
        info["kernel_ms_vs_scan_ms"] = {
            k: (round(a * 1e3, 3), round(s * 1e3, 3))
            for k, (a, s) in times.items()}


def _cornell(w, h=None):
    from scenes import cornell_builder
    b = cornell_builder()
    b.cameras["cam"]["resx"] = w
    b.cameras["cam"]["resy"] = h or w
    return b.compile("cam")


# ------------------------------------------------------------------ phase 3

def cornell_phase():
    import jax
    import numpy as np
    from libyafaray_tpu import film as F, make_integrator
    from libyafaray_tpu.render import render
    cfg = make_integrator({"type": "pathtracing", "bounces": 4})
    w, h = FULL
    with phase("cornell-render") as info:
        scene = _cornell(w, h)
        t0 = time.time()
        film = render(scene, cfg, w, h, spp=2)
        img = np.asarray(F.resolve(film, "combined"))
        t_first = time.time() - t0
        t_run = timed(lambda: np.asarray(F.resolve(
            render(scene, cfg, w, h, spp=2), "combined")), reps=1)
        assert img.shape[:2] == (h, w) and np.isfinite(img).all()
        rgb = img[..., :3]
        left, right = rgb[:, :12].mean((0, 1)), rgb[:, -12:].mean((0, 1))
        log(f"  left wall {left}, right wall {right}, max {rgb.max():.4f}")
        assert left[0] > left[1] and left[0] > left[2], left
        assert right[1] > right[0] and right[1] > right[2], right
        info.update(res=f"{w}x{h}", first_s=round(t_first, 1),
                    rays_per_s=int(2 * w * h / t_run))

        cpu = jax.devices("cpu")[0]
        gpu_img = np.asarray(F.resolve(
            render(_cornell(SMALL), cfg, SMALL, SMALL, spp=2), "combined"))
        with jax.default_device(cpu):
            cpu_img = np.asarray(F.resolve(
                render(_cornell(SMALL), cfg, SMALL, SMALL, spp=2),
                "combined"))
        # the square frame sees the ceiling lamp (the 16:9 one does not):
        # its brightest pixels are the lamp's radiance, 12
        log(f"  small square frame max {gpu_img[..., :3].max():.4f}")
        assert abs(gpu_img[..., :3].max() - 12.0) < 0.05
        check_image_close("cornell small GPU vs CPU", gpu_img, cpu_img,
                          IMG_MEAN_RTOL, IMG_P99_ATOL)


# ------------------------------------------------------------------ phase 4

def fwd_bwd_phase():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bench import caustic_fwd_bwd_setup, cornell_fwd_bwd_setup
    with phase("fwd+bwd") as info:
        scene, step, chunks = cornell_fwd_bwd_setup(*FULL, 4, CHUNK_ROWS)
        rgb, alpha, g = jax.block_until_ready(
            step(scene, *chunks[0], jnp.uint32(0)))
        g = np.asarray(g)
        assert np.isfinite(np.asarray(rgb)).all() and np.isfinite(g).all()
        assert np.abs(g).sum() > 0, "zero albedo gradient"
        t = timed(lambda: jax.block_until_ready(
            step(scene, *chunks[0], jnp.uint32(1))))
        n = chunks[0][0].shape[0]
        log(f"  cornell chunk of {n} rays: loss {float(np.mean(rgb)):.6g} "
            f"|grad| {np.abs(g).sum():.6g}, {t*1e3:.1f} ms/step "
            f"({n/t/1e6:.3f} M camera rays/s fwd+bwd)")
        info["cornell_rays_per_s"] = int(n / t)

        cscene, cstep, cpix = caustic_fwd_bwd_setup(CAUSTIC, CAUSTIC)
        loss, (g_ior, g_tex) = jax.block_until_ready(
            cstep(cscene, *cpix, jnp.uint32(0)))
        for name, x in (("loss", loss), ("ior", g_ior), ("texels", g_tex)):
            x = np.asarray(x)
            assert np.isfinite(x).all() and np.abs(x).sum() > 0, name
        t = timed(lambda: jax.block_until_ready(
            cstep(cscene, *cpix, jnp.uint32(1))))
        nc = CAUSTIC * CAUSTIC
        log(f"  caustic {CAUSTIC}x{CAUSTIC}: loss {float(loss):.6g} |g_ior| "
            f"{float(np.abs(g_ior).sum()):.6g} |g_tex| "
            f"{float(np.abs(g_tex).sum()):.6g}, {t*1e3:.1f} ms/step "
            f"({nc/t/1e6:.3f} M camera rays/s fwd+bwd)")
        info["caustic_rays_per_s"] = int(nc / t)

        cpu = jax.devices("cpu")[0]
        outs = {}
        for dev in ("gpu", "cpu"):
            ctx = (jax.default_device(cpu) if dev == "cpu"
                   else contextlib.nullcontext())
            with ctx:
                sc, st, ch = cornell_fwd_bwd_setup(SMALL, SMALL)
                r, _, gg = st(sc, *ch[0], jnp.uint32(3))
                cs, cst, cp = caustic_fwd_bwd_setup(SMALL, SMALL)
                cl, (gi, gt) = cst(cs, *cp, jnp.uint32(3))
                outs[dev] = [np.asarray(x) for x in (r, gg, cl, gi, gt)]
        gpu, cpu_ = outs["gpu"], outs["cpu"]
        check_image_close("cornell fwd small GPU vs CPU", gpu[0], cpu_[0],
                          IMG_MEAN_RTOL, IMG_P99_ATOL)
        check_close("cornell d/d albedo", gpu[1], cpu_[1], GRAD_RTOL)
        check_close("caustic loss", gpu[2], cpu_[2], IMG_MEAN_RTOL)
        check_close("caustic d/d ior", gpu[3], cpu_[3], GRAD_RTOL)
        check_close("caustic d/d texels", gpu[4], cpu_[4], GRAD_RTOL)


# ------------------------------------------------------------------ phase 5

def bigmesh_phase():
    import numpy as np
    from libyafaray_tpu import film as F, make_integrator
    from libyafaray_tpu.render import render
    from scenes import bigmesh_builder
    r = MESH_IMG
    with phase("bigmesh-render") as info:
        b = bigmesh_builder(MESH_RES)
        b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = r
        scene = b.compile("cam")
        assert scene.accel_kind == "blocks"
        cfg = make_integrator({"type": "pathtracing", "bounces": 2})
        img = np.asarray(F.resolve(render(scene, cfg, r, r, spp=2),
                                   "combined"))
        assert img.shape[:2] == (r, r) and np.isfinite(img).all()
        assert img[..., :3].mean() > 0
        t = timed(lambda: np.asarray(F.resolve(
            render(scene, cfg, r, r, spp=2), "combined")), reps=1)
        info.update(res=f"{r}x{r}", tris=scene.geom.num_faces,
                    rays_per_s=int(2 * r * r / t))


# ------------------------------------------------------------- four cards

def four_cards_phase():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from libyafaray_tpu import film as F, make_integrator
    from libyafaray_tpu.parallel import (make_mesh, make_train_step,
                                         render_sharded)
    with phase("four-cards") as info:
        assert len(jax.devices()) == 4, jax.devices()
        w, h = FULL
        scene = _cornell(w, h)
        cfg = make_integrator({"type": "pathtracing", "bounces": 4})
        mesh4, mesh1 = make_mesh(4), make_mesh(1)
        imgs = {}
        for name, mesh in (("4 cards", mesh4), ("1 card", mesh1)):
            film = render_sharded(scene, cfg, w, h, spp=1, mesh=mesh)
            imgs[name] = np.asarray(F.resolve(film, "combined"))
            t = timed(lambda: render_sharded(
                scene, cfg, w, h, spp=1,
                mesh=mesh).weights.block_until_ready(), reps=2)
            log(f"  render_sharded {w}x{h} on {name}: {t*1e3:.1f} ms/pass "
                f"({w*h/t/1e6:.3f} M camera rays/s)")
            info[f"rays_per_s_{name.replace(' ', '')}"] = int(w * h / t)
        check_image_close(f"cornell {w}x{h} 4 cards vs 1 card",
                          imgs["4 cards"], imgs["1 card"],
                          SHARD_MEAN_RTOL, SHARD_P99_ATOL)
        step = make_train_step(cfg, h, w, mesh4, lr=0.05)
        params = {"diffuse_color": scene.materials.diffuse_color}
        target = jnp.full((h, w, 3), 0.25, jnp.float32)
        with mesh4:
            new, loss = step(scene, params, target, jnp.uint32(0))
        loss = float(loss)
        moved = float(np.abs(np.asarray(new["diffuse_color"])
                             - np.asarray(params["diffuse_color"])).max())
        log(f"  train step on 4 cards: loss {loss:.6g}, max param delta "
            f"{moved:.3g}")
        assert np.isfinite(loss) and moved > 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded render + train step")
    args = ap.parse_args()
    devs = device_phase()
    if args.four_cards:
        four_cards_phase()
    else:
        kernels_phase()
        cornell_phase()
        fwd_bwd_phase()
        bigmesh_phase()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
