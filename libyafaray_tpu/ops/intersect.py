"""Ray-scene intersection: batched Möller-Trumbore + sphere tests.

The brute-force path (`accel_kind="brute"`) is the analogue of the
reference's `AcceleratorSimpleTest`
(src/accelerator/accelerator_simple_test.cc). On a GPU it runs the fused
Pallas (Triton) kernel in accel/pallas_intersect.py; everywhere else a
`lax.scan` over triangle chunks with the full wavefront of rays tested per
chunk — dense [N_rays x CHUNK] work with zero divergence, and the plain
reference the kernel is tested against. Larger scenes dispatch to the
block accelerator (accel/blocks.py) or the LBVH (accel/lbvh.py), replacing
src/accelerator/accelerator_kdtree.cc's pointer-chasing kd-tree.

Triangle test: Möller-Trumbore, same algorithm as the reference's
TrianglePrimitive::intersect (src/geometry/primitive/primitive_triangle.cc:
44-71), vectorized over rays x triangles.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from ..utils import struct

from ..math import vec
from ..scene_types import Geometry, SceneData

Array = jax.Array

MAX_TRI_CHUNK = 512  # upper bound on triangles per scan step


def _tri_chunk(f: int) -> int:
    """Chunk width for the brute-force scan: small scenes pad only to the
    next multiple of 128 instead of a fixed 512 (a 36-tri cornell otherwise
    wastes 14x of its MT tests on padding)."""
    return min(MAX_TRI_CHUNK, max(128, -(-f // 128) * 128))


@struct.dataclass
class Hit:
    """Wavefront hit record (SoA) — minimal intersect result; the full
    shading context (SurfacePoint) is built by `ops.surface.make_surface`."""
    valid: Array      # bool[N]
    t: Array          # f32[N]
    prim: Array       # i32[N] face index, or num_faces+sphere index
    uv: Array         # f32[N,2] barycentrics (triangles) / sphere (u,v)


def _gather_tri_verts(geom: Geometry):
    v = geom.vertices
    f = geom.faces
    return v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]


def moller_trumbore(o: Array, d: Array, v0: Array, v1: Array, v2: Array,
                    t_min, t_max, eps: float = 1e-10):
    """Batched MT: o,d [N,1,3] against v0..v2 [1,C,3] (or any broadcast).
    Returns (hit_mask, t, u, v)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(d, e2)
    det = vec.dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
    tvec = o - v0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = vec.dot(d, qvec) * inv_det
    t = vec.dot(e2, qvec) * inv_det
    hit = ((jnp.abs(det) > eps) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t <= t_max))
    return hit, t, u, v


def intersect_sphere(o: Array, d: Array, center: Array, radius: Array,
                     t_min, t_max):
    """Batched analytic sphere (reference primitive_sphere.cc:33). Returns
    (hit, t) taking the nearest root in range."""
    oc = o - center
    b = vec.dot(oc, d)
    c = vec.dot(oc, oc) - radius * radius
    disc = b * b - c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t0_in = (t0 > t_min) & (t0 <= t_max)
    t1_in = (t1 > t_min) & (t1 <= t_max)
    t = jnp.where(t0_in, t0, t1)
    hit = ok & (t0_in | t1_in)
    return hit, t


def _kernel_branch(geom: Geometry, o, d, t_min, best_t, exclude,
                   shadow: bool, time):
    """Triangle pass of the brute query through the Triton kernel."""
    from ..accel.pallas_intersect import mt_query, pack_tris
    fc = geom.faces
    keys = [geom.vertices]
    if time is not None:     # motion keyframes (none for a static scene)
        keys += [vt for vt in (geom.vertices_t1, geom.vertices_t2)
                 if vt is not None]
    tabs = [pack_tris(vt[fc[:, 0]], vt[fc[:, 1]], vt[fc[:, 2]],
                      geom.face_vis) for vt in keys]
    bt, bp, bu, bv = mt_query(tabs[0], o, d, t_min, best_t, exclude, time,
                              *tabs[1:], shadow=shadow)
    return jnp.where(bp >= 0, bt, best_t), bp, jnp.stack([bu, bv], axis=-1)


def _scan_branch(geom: Geometry, o, d, t_min, best_t, exclude_prim,
                 shadow: bool, time):
    """Triangle pass of the brute query as a jnp scan over triangle chunks
    (every backend but the GPU, and the kernel's plain reference)."""
    n = o.shape[0]
    f = geom.num_faces
    vis_bit = 2 if shadow else 1
    motion = geom.has_motion and time is not None
    best_prim = jnp.full((n,), -1, jnp.int32)
    best_uv = jnp.zeros((n, 2), jnp.float32)
    v0, v1, v2 = _gather_tri_verts(geom)
    motion2 = motion and geom.vertices_t2 is not None
    if motion:
        vb = geom.vertices_t1
        fc = geom.faces
        v0b, v1b, v2b = vb[fc[:, 0]], vb[fc[:, 1]], vb[fc[:, 2]]
        if motion2:
            vc = geom.vertices_t2
            v0c, v1c, v2c = vc[fc[:, 0]], vc[fc[:, 1]], vc[fc[:, 2]]
    fvis = (geom.face_vis & vis_bit) != 0
    chunk = _tri_chunk(f)
    pad = (-f) % chunk
    if pad:
        padv = jnp.full((pad, 3), jnp.nan, jnp.float32)
        v0 = jnp.concatenate([v0, padv])
        v1 = jnp.concatenate([v1, padv])
        v2 = jnp.concatenate([v2, padv])
        if motion:
            v0b = jnp.concatenate([v0b, padv])
            v1b = jnp.concatenate([v1b, padv])
            v2b = jnp.concatenate([v2b, padv])
            if motion2:
                v0c = jnp.concatenate([v0c, padv])
                v1c = jnp.concatenate([v1c, padv])
                v2c = jnp.concatenate([v2c, padv])
        fvis = jnp.concatenate([fvis, jnp.zeros((pad,), bool)])
    steps = (f + pad) // chunk
    v0 = v0.reshape(steps, chunk, 3)
    v1 = v1.reshape(steps, chunk, 3)
    v2 = v2.reshape(steps, chunk, 3)
    if motion:
        v0b = v0b.reshape(steps, chunk, 3)
        v1b = v1b.reshape(steps, chunk, 3)
        v2b = v2b.reshape(steps, chunk, 3)
        if motion2:
            v0c = v0c.reshape(steps, chunk, 3)
            v1c = v1c.reshape(steps, chunk, 3)
            v2c = v2c.reshape(steps, chunk, 3)
        tt_ray = jnp.asarray(time, jnp.float32)[:, None, None]
    fvis = fvis.reshape(steps, chunk)
    base_ids = jnp.arange(chunk, dtype=jnp.int32)
    ob = o[:, None, :]
    db = d[:, None, :]
    tmin_b = jnp.asarray(t_min, jnp.float32)[..., None]

    def step(carry, chunk_in):
        bt, bp, buv = carry
        if motion2:
            (cv0, cv1, cv2, cb0, cb1, cb2, cc0, cc1, cc2, cvis,
             coff) = chunk_in
            # quadratic b-spline over 3 control points (the reference's
            # BsTrianglePrimitive, primitive_triangle_bspline.cc:40-44)
            w0 = (1 - tt_ray) * (1 - tt_ray)
            w1 = 2.0 * tt_ray * (1 - tt_ray)
            w2 = tt_ray * tt_ray
            a0 = cv0[None] * w0 + cb0[None] * w1 + cc0[None] * w2
            a1 = cv1[None] * w0 + cb1[None] * w1 + cc1[None] * w2
            a2 = cv2[None] * w0 + cb2[None] * w1 + cc2[None] * w2
            hit, t, u, v = moller_trumbore(ob, db, a0, a1, a2,
                                           tmin_b, bt[:, None])
        elif motion:
            cv0, cv1, cv2, cb0, cb1, cb2, cvis, coff = chunk_in
            # per-ray shutter time interpolation (BsTrianglePrimitive
            # analogue, 2-keyframe lerp)
            a0 = cv0[None] * (1 - tt_ray) + cb0[None] * tt_ray
            a1 = cv1[None] * (1 - tt_ray) + cb1[None] * tt_ray
            a2 = cv2[None] * (1 - tt_ray) + cb2[None] * tt_ray
            hit, t, u, v = moller_trumbore(ob, db, a0, a1, a2,
                                           tmin_b, bt[:, None])
        else:
            cv0, cv1, cv2, cvis, coff = chunk_in
            hit, t, u, v = moller_trumbore(ob, db, cv0[None], cv1[None],
                                           cv2[None], tmin_b, bt[:, None])
        ids = base_ids[None, :] + coff
        hit = hit & cvis[None, :] & (ids != exclude_prim[:, None])
        t = jnp.where(hit, t, jnp.inf)
        j = jnp.argmin(t, axis=1)
        rows = jnp.arange(n)
        tj = t[rows, j]
        better = tj < bt
        bt = jnp.where(better, tj, bt)
        bp = jnp.where(better, base_ids[j] + coff, bp)
        buv = jnp.where(better[:, None],
                        jnp.stack([u[rows, j], v[rows, j]], axis=-1), buv)
        return (bt, bp, buv), None

    offs = jnp.arange(steps, dtype=jnp.int32) * chunk
    if motion2:
        xs = (v0, v1, v2, v0b, v1b, v2b, v0c, v1c, v2c, fvis, offs)
    elif motion:
        xs = (v0, v1, v2, v0b, v1b, v2b, fvis, offs)
    else:
        xs = (v0, v1, v2, fvis, offs)
    (best_t, best_prim, best_uv), _ = jax.lax.scan(
        step, (best_t, best_prim, best_uv), xs)
    return best_t, best_prim, best_uv


def _brute_closest(geom: Geometry, o: Array, d: Array, t_min: Array,
                   t_max: Array, exclude_prim: Optional[Array] = None,
                   shadow: bool = False,
                   time: Optional[Array] = None) -> Hit:
    """Brute-force query. The triangle pass is chosen by the platform the
    computation is lowered for: the Triton kernel on CUDA, the jnp scan
    elsewhere (no runtime probe, no fallback)."""
    if geom.inst_mat is not None:
        raise NotImplementedError(
            "brute-force intersection does not expand TRUE instances; "
            "instanced scenes compile with the block accelerator "
            "(set instancing: 'baked' to force geometry duplication)")
    n = o.shape[0]
    vis_bit = 2 if shadow else 1
    best_t = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    best_prim = jnp.full((n,), -1, jnp.int32)
    best_uv = jnp.zeros((n, 2), jnp.float32)
    f = geom.num_faces
    if f > 0:
        tmin_v = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
        excl = (exclude_prim if exclude_prim is not None
                else jnp.full((n,), -1, jnp.int32))
        tq = jnp.asarray(time, jnp.float32) if time is not None else None
        best_t, best_prim, best_uv = jax.lax.platform_dependent(
            o, d, tmin_v, best_t, excl,
            cuda=lambda *a: _kernel_branch(geom, *a, shadow, tq),
            default=lambda *a: _scan_branch(geom, *a, shadow, tq))
    s = geom.num_spheres
    if s > 0:
        hit, t = intersect_sphere(
            o[:, None, :], d[:, None, :], geom.sph_center[None],
            geom.sph_radius[None], jnp.asarray(t_min, jnp.float32)[..., None],
            best_t[:, None])
        hit = hit & ((geom.sph_vis[None, :] & vis_bit) != 0)
        sph_ids = f + jnp.arange(s, dtype=jnp.int32)
        if exclude_prim is not None:
            hit = hit & (sph_ids[None, :] != exclude_prim[:, None])
        t = jnp.where(hit, t, jnp.inf)
        j = jnp.argmin(t, axis=1)
        rows = jnp.arange(o.shape[0])
        tj = t[rows, j]
        better = tj < best_t
        best_t = jnp.where(better, tj, best_t)
        best_prim = jnp.where(better, sph_ids[j], best_prim)
        best_uv = jnp.where(better[:, None], jnp.zeros_like(best_uv), best_uv)
    valid = best_prim >= 0
    return Hit(valid=valid, t=best_t, prim=jnp.maximum(best_prim, 0), uv=best_uv)


def _brute_any(geom: Geometry, o: Array, d: Array, t_min: Array,
               t_max: Array, exclude_prim: Optional[Array] = None,
               time: Optional[Array] = None) -> Array:
    """Boolean shadow query (reference Accelerator::intersectS): the
    closest-hit query over shadow-casting primitives (an early exit
    measured slower than the full loop, see accel/pallas_intersect.py)."""
    hit = _brute_closest(geom, o, d, t_min, t_max, exclude_prim, shadow=True,
                         time=time)
    return hit.valid


def _detach_hit(hit: Hit) -> Hit:
    """Detached-sampling gradients: intersection results carry no gradient
    (visibility/geometry discontinuity gradients are out of scope, SURVEY.md
    §7.6) — stop_gradient here prunes the whole intersection scan from the
    backward pass, roughly halving fwd+bwd cost."""
    return Hit(valid=hit.valid, t=jax.lax.stop_gradient(hit.t),
               prim=hit.prim, uv=jax.lax.stop_gradient(hit.uv))


def closest_hit(scene: SceneData, o: Array, d: Array, t_min, t_max,
                exclude_prim: Optional[Array] = None,
                time: Optional[Array] = None) -> Hit:
    """Closest-hit query over the whole scene (Accelerator::intersect).
    Motion-blurred scenes (geom.has_motion) work on every accelerator:
    blocks and LBVH both build AABBs as unions over all motion control
    points and interpolate vertices (lerp / quadratic b-spline) per-ray
    at leaf-test time."""
    # detached sampling applies to inputs too: every hit output is already
    # stop_gradient'ed (see _detach_hit), so detaching the query rays here
    # changes no gradient — but it keeps differentiated bounce directions
    # (e.g. refraction through a learnable IOR) from flowing INTO the
    # Pallas kernel, which has no autodiff rule
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    t_min = jnp.broadcast_to(jax.lax.stop_gradient(
        jnp.asarray(t_min, jnp.float32)), o.shape[:-1])
    t_max = jnp.broadcast_to(jax.lax.stop_gradient(
        jnp.asarray(t_max, jnp.float32)), o.shape[:-1])
    if time is not None:
        time = jax.lax.stop_gradient(time)
    if scene.accel_kind == "blocks" and scene.blocks is not None:
        from ..accel.blocks import blocks_closest
        return _detach_hit(blocks_closest(
            scene, o, d, t_min, t_max, exclude_prim,
            time=time if scene.geom.has_motion else None))
    if scene.accel_kind == "bvh" and scene.bvh is not None:
        return _detach_hit(lbvh_closest(
            scene, o, d, t_min, t_max, exclude_prim,
            time=time if scene.geom.has_motion else None))
    return _detach_hit(_brute_closest(scene.geom, o, d, t_min, t_max,
                                      exclude_prim, time=time))


def camera_hit(scene: SceneData, o: Array, d: Array, t_min, t_max,
               time: Optional[Array] = None) -> Hit:
    """First intersection of CAMERA (primary) rays.

    Identical to closest_hit unless the scene contains primitives flagged
    invisible-to-camera (face_vis bit 4): area lights created with
    visibility='invisible', matching the reference where an `arealight` is
    never a scene primitive — camera rays pass straight through it and its
    radiance enters only via the MIS BSDF-sample completion
    (src/integrator/surface/integrator_montecarlo.cc:323 light->intersect;
    camera rays only query the accelerator, integrator_path_tracer.cc:128).
    Our design bakes light quads into geometry so BOUNCE rays hit them (the
    same MIS role); this helper hides them from the primary segment only.

    Implementation: trace normally, then re-trace past the hit for lanes
    whose first hit is camera-invisible (masked: non-affected lanes get an
    empty t-range and cost nothing in the block accelerator). One step
    suffices — a ray crosses a lamp's plane once, and stacked invisible
    lamps are out of scope."""
    hit = closest_hit(scene, o, d, t_min, t_max, time=time)
    if not scene.has_cam_invisible:
        return hit
    nf = scene.geom.num_faces
    is_tri = hit.prim < nf
    fv = scene.geom.face_vis[jnp.minimum(hit.prim, max(nf - 1, 0))]
    inv = hit.valid & is_tri & ((fv & 4) != 0)
    excl = jnp.where(inv, hit.prim, -1)
    hit2 = closest_hit(scene, o, d, t_min,
                       jnp.where(inv, jnp.broadcast_to(
                           jnp.asarray(t_max, jnp.float32), inv.shape), -1.0),
                       exclude_prim=excl, time=time)
    return Hit(valid=jnp.where(inv, hit2.valid, hit.valid),
               t=jnp.where(inv, hit2.t, hit.t),
               prim=jnp.where(inv, hit2.prim, hit.prim),
               uv=jnp.where(inv[..., None], hit2.uv, hit.uv))


def lbvh_closest(scene, o, d, t_min, t_max, exclude_prim, time=None):
    from ..accel import lbvh
    return lbvh.traverse_closest(scene, o, d, t_min, t_max, exclude_prim,
                                 time=time)


def any_hit(scene: SceneData, o: Array, d: Array, t_min, t_max,
            exclude_prim: Optional[Array] = None,
            time: Optional[Array] = None) -> Array:
    """Binary shadow query (Accelerator::intersectS analogue)."""
    # boolean output: no gradient either way; detach inputs so the Pallas
    # path never sees differentiated rays (see closest_hit)
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    t_min = jnp.broadcast_to(jax.lax.stop_gradient(
        jnp.asarray(t_min, jnp.float32)), o.shape[:-1])
    t_max = jnp.broadcast_to(jax.lax.stop_gradient(
        jnp.asarray(t_max, jnp.float32)), o.shape[:-1])
    if time is not None:
        time = jax.lax.stop_gradient(time)
    if scene.accel_kind == "blocks" and scene.blocks is not None:
        from ..accel.blocks import blocks_any
        return blocks_any(scene, o, d, t_min, t_max, exclude_prim,
                          time=time if scene.geom.has_motion else None)
    if scene.accel_kind == "bvh" and scene.bvh is not None:
        from ..accel import lbvh
        return lbvh.traverse_any(
            scene, o, d, t_min, t_max, exclude_prim,
            time=time if scene.geom.has_motion else None)
    return _brute_any(scene.geom, o, d, t_min, t_max, exclude_prim,
                      time=time)


def shadow_hit_surface(scene: SceneData, o: Array, d: Array, t_min, t_max,
                       exclude_prim: Optional[Array] = None):
    """Closest hit restricted to shadow-visible primitives — building block of
    the transparent-shadow walk (Accelerator::intersectTs analogue in
    ops/shadow.py)."""
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), o.shape[:-1])
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), o.shape[:-1])
    if scene.accel_kind == "blocks" and scene.blocks is not None:
        from ..accel.blocks import blocks_closest
        return _detach_hit(blocks_closest(scene, o, d, t_min, t_max,
                                          exclude_prim, shadow=True))
    if scene.accel_kind == "bvh" and scene.bvh is not None:
        from ..accel import lbvh
        return _detach_hit(lbvh.traverse_closest(scene, o, d, t_min, t_max,
                                                 exclude_prim, shadow=True))
    return _detach_hit(_brute_closest(scene.geom, o, d, t_min, t_max,
                                      exclude_prim, shadow=True))
