"""LBVH: Morton-code linear BVH build + wavefront stack traversal.

Wavefront replacement for the reference's SAH kd-tree accelerators
(src/accelerator/accelerator_kdtree.cc, accelerator_kdtree_multi_thread.cc):
instead of a CPU-recursive SAH build and a pointer-chasing traversal loop
(kdtree hot loop accelerator_kdtree.cc:639-721), we build a Karras-2012
linear BVH entirely on device — Morton-code radix sort (jnp.argsort) +
binary-radix hierarchy emitted in one vectorized pass — and traverse with a
fixed-depth explicit stack held in registers per ray, vmapped over the
wavefront. All gathers are dense array ops; no host round-trips.

Build is O(F log F) fully parallel (the analogue of the reference's
multi-threaded kd build, but embarrassingly parallel instead of
thread-pair-splitting). Refit (for deformed geometry) is a bottom-up
segment pass over the same topology.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..math import vec
from ..scene_types import BVH, Geometry, SceneData
from .morton import morton3d

Array = jax.Array

MAX_STACK = 48  # cf. reference kd_max_stack_=64 (accelerator_kdtree.h:101)


# ---------------------------------------------------------------------------
# Build (Karras 2012: "Maximizing Parallelism in the Construction of BVHs")
# ---------------------------------------------------------------------------

def _delta(codes: Array, i: Array, j: Array, n: int) -> Array:
    """Length of common prefix of the (conceptually 64-bit) keys at sorted
    slots i, j; -1 when j is out of range.

    Keys are morton code (high 32 bits) augmented with the sorted slot index
    (low 32 bits) for uniqueness — the Karras tie-break. jax.numpy has no
    uint64 without x64 mode, so the clz is computed piecewise with exact
    integer clz: on the code xor when codes differ, else 32 + clz(slot xor).
    (Float log2 is NOT exact near 2^24+; int clz is.)"""
    valid = (j >= 0) & (j < n)
    jc = jnp.clip(j, 0, n - 1)
    x = (codes[i] ^ codes[jc]).astype(jnp.int32)
    ix = (i ^ jc).astype(jnp.int32)
    clz = jnp.where(x != 0, jax.lax.clz(x), 32 + jax.lax.clz(ix))
    return jnp.where(valid, clz, -1)


def build_lbvh(geom: Geometry) -> BVH:
    """Build the LBVH over triangles (+ spheres appended as leaves).

    Layout: internal nodes [0, P-2], leaves [P-1, 2P-2] where P is the
    primitive count; node i's children indices point into the same array."""
    f = geom.num_faces
    s = geom.num_spheres
    p = f + s
    if p == 0:
        raise ValueError("empty scene")
    # primitive centroids + bounds
    if f > 0:
        v0 = geom.vertices[geom.faces[:, 0]]
        v1 = geom.vertices[geom.faces[:, 1]]
        v2 = geom.vertices[geom.faces[:, 2]]
        tmin = jnp.minimum(jnp.minimum(v0, v1), v2)
        tmax = jnp.maximum(jnp.maximum(v0, v1), v2)
        # motion: bounds are the union over all control points (the
        # b-spline curve lies inside its control hull), like the block
        # accelerator's motion AABBs
        for vb in (geom.vertices_t1, geom.vertices_t2):
            if vb is not None:
                b0 = vb[geom.faces[:, 0]]
                b1 = vb[geom.faces[:, 1]]
                b2 = vb[geom.faces[:, 2]]
                tmin = jnp.minimum(tmin, jnp.minimum(jnp.minimum(b0, b1), b2))
                tmax = jnp.maximum(tmax, jnp.maximum(jnp.maximum(b0, b1), b2))
    else:
        tmin = jnp.zeros((0, 3), jnp.float32)
        tmax = jnp.zeros((0, 3), jnp.float32)
    if s > 0:
        smin = geom.sph_center - geom.sph_radius[:, None]
        smax = geom.sph_center + geom.sph_radius[:, None]
        pmin = jnp.concatenate([tmin, smin])
        pmax = jnp.concatenate([tmax, smax])
    else:
        pmin, pmax = tmin, tmax
    centroid = 0.5 * (pmin + pmax)
    scene_min = jnp.min(pmin, axis=0)
    scene_max = jnp.max(pmax, axis=0)
    extent = jnp.maximum(scene_max - scene_min, 1e-12)
    rel = (centroid - scene_min) / extent
    codes30 = morton3d(rel)  # uint32, 30 bits
    order = jnp.argsort(codes30, stable=True).astype(jnp.int32)
    codes = codes30[order]  # _delta tie-breaks equal codes by sorted slot

    if p == 1:
        return BVH(node_min=pmin, node_max=pmax,
                   node_left=jnp.zeros((1,), jnp.int32),
                   node_right=jnp.zeros((1,), jnp.int32),
                   node_is_leaf=jnp.ones((1,), bool),
                   prim_order=order, num_nodes=1)

    n_int = p - 1
    i = jnp.arange(n_int, dtype=jnp.int32)

    # Karras: determine range direction and extent per internal node
    d_right = _delta(codes, i, i + 1, p)
    d_left = _delta(codes, i, i - 1, p)
    d = jnp.where(d_right > d_left, 1, -1)
    delta_min = jnp.minimum(d_right, d_left)

    # find upper bound of range length by exponential search (static unroll
    # over the 32 possible doublings, masked — no data-dependent loop)
    lmax = jnp.full((n_int,), 2, jnp.int32)
    for _ in range(31):
        probe = i + lmax * d
        ok = _delta(codes, i, probe, p) > delta_min
        lmax = jnp.where(ok, lmax * 2, lmax)
    # binary search for exact range end
    l = jnp.zeros((n_int,), jnp.int32)
    t = lmax // 2
    for _ in range(32):
        probe = i + (l + t) * d
        ok = _delta(codes, i, probe, p) > delta_min
        l = jnp.where((t > 0) & ok, l + t, l)
        t = t // 2
    j = i + l * d  # other end of the range

    # find split by binary search on prefix length
    delta_node = _delta(codes, i, j, p)
    sstep = jnp.zeros((n_int,), jnp.int32)
    t = _ceil_div_pow2(l)
    for _ in range(32):
        probe = i + (sstep + t) * d
        ok = _delta(codes, i, probe, p) > delta_node
        sstep = jnp.where((t > 0) & ok, sstep + t, sstep)
        t = t // 2
    gamma = i + sstep * d + jnp.minimum(d, 0)

    rng_lo = jnp.minimum(i, j)
    rng_hi = jnp.maximum(i, j)
    # child = leaf if it covers exactly one primitive
    left_is_leaf = rng_lo == gamma
    right_is_leaf = rng_hi == gamma + 1
    left = jnp.where(left_is_leaf, n_int + gamma, gamma)
    right = jnp.where(right_is_leaf, n_int + gamma + 1, gamma + 1)

    node_left = jnp.concatenate([left, jnp.arange(p, dtype=jnp.int32)])
    node_right = jnp.concatenate([right, jnp.arange(p, dtype=jnp.int32)])
    node_is_leaf = jnp.concatenate([jnp.zeros((n_int,), bool),
                                    jnp.ones((p,), bool)])

    # leaf bounds in morton order
    leaf_min = pmin[order]
    leaf_max = pmax[order]
    node_min = jnp.concatenate([jnp.zeros((n_int, 3), jnp.float32), leaf_min])
    node_max = jnp.concatenate([jnp.zeros((n_int, 3), jnp.float32), leaf_max])

    # bottom-up bound propagation: iterate log-depth times a gather pass
    # (internal bounds = union of children). Worst-case LBVH depth on sorted
    # morton codes is O(64) for adversarial input; iterate enough times.
    n_iter = int(jnp.ceil(jnp.log2(p)).item()) + 8 if False else 64

    def refit_once(state):
        nmin, nmax = state
        lmin = nmin[node_left[:n_int]]
        lmaxb = nmax[node_left[:n_int]]
        rmin = nmin[node_right[:n_int]]
        rmaxb = nmax[node_right[:n_int]]
        new_min = jnp.minimum(lmin, rmin)
        new_max = jnp.maximum(lmaxb, rmaxb)
        nmin = nmin.at[:n_int].set(new_min)
        nmax = nmax.at[:n_int].set(new_max)
        return nmin, nmax

    # fixed 2*ceil(log2 p)+4 passes: each pass finalizes at least one more
    # level above the deepest already-correct level
    depth_bound = max(2 * int(jnp.ceil(jnp.log2(jnp.maximum(p, 2)))) + 4, 8)
    depth_bound = min(depth_bound, 64)
    nmin, nmax = node_min, node_max
    for _ in range(depth_bound):
        nmin, nmax = refit_once((nmin, nmax))

    return BVH(node_min=nmin, node_max=nmax, node_left=node_left,
               node_right=node_right, node_is_leaf=node_is_leaf,
               prim_order=order, num_nodes=int(n_int + p))


def _ceil_div_pow2(l: Array) -> Array:
    """Smallest power of two >= l/2, used as the split search start."""
    # next pow2 >= ceil(l/2), via integer clz (exact for any l)
    h = jnp.maximum((l + 1) // 2, 1)
    e = 32 - jax.lax.clz(jnp.maximum(h - 1, 0))
    return jnp.maximum(1 << jnp.clip(e, 0, 30), 1)


# ---------------------------------------------------------------------------
# Traversal: per-ray fixed stack, vmapped over the wavefront
# ---------------------------------------------------------------------------

def _prim_intersect(geom: Geometry, prim: Array, o: Array, d: Array,
                    t_min: Array, t_max: Array, vis_bit: int,
                    exclude: Array, time: Optional[Array] = None):
    """Intersect one primitive id (morton-order resolved) per lane.
    `time` (per-lane shutter time) interpolates motion-blurred vertices:
    2-keyframe lerp or quadratic b-spline over 3 control points
    (primitive_triangle_bspline.cc:40-44)."""
    from ..ops.intersect import intersect_sphere, moller_trumbore
    f = geom.num_faces
    is_tri = prim < f
    tri = jnp.where(is_tri, prim, 0)
    fidx = geom.faces[tri]
    v0 = geom.vertices[fidx[..., 0]]
    v1 = geom.vertices[fidx[..., 1]]
    v2 = geom.vertices[fidx[..., 2]]
    if time is not None and geom.vertices_t1 is not None:
        tm = jnp.asarray(time, jnp.float32)
        b0 = geom.vertices_t1[fidx[..., 0]]
        b1 = geom.vertices_t1[fidx[..., 1]]
        b2 = geom.vertices_t1[fidx[..., 2]]
        if geom.vertices_t2 is not None:
            c0 = geom.vertices_t2[fidx[..., 0]]
            c1 = geom.vertices_t2[fidx[..., 1]]
            c2 = geom.vertices_t2[fidx[..., 2]]
            w0 = (1.0 - tm) * (1.0 - tm)
            w1 = 2.0 * tm * (1.0 - tm)
            w2 = tm * tm
            v0 = v0 * w0 + b0 * w1 + c0 * w2
            v1 = v1 * w0 + b1 * w1 + c1 * w2
            v2 = v2 * w0 + b2 * w1 + c2 * w2
        else:
            v0 = v0 * (1.0 - tm) + b0 * tm
            v1 = v1 * (1.0 - tm) + b1 * tm
            v2 = v2 * (1.0 - tm) + b2 * tm
    hit_t, tt, u, v = moller_trumbore(o, d, v0, v1, v2, t_min, t_max)
    vis = (geom.face_vis[tri] & vis_bit) != 0
    hit_t = hit_t & vis & is_tri
    if geom.num_spheres > 0:
        sp = jnp.where(is_tri, 0, prim - f)
        hs, ts = intersect_sphere(o, d, geom.sph_center[sp],
                                  geom.sph_radius[sp], t_min, t_max)
        svis = (geom.sph_vis[sp] & vis_bit) != 0
        hs = hs & svis & ~is_tri
        hit = hit_t | hs
        t = jnp.where(hit_t, tt, ts)
    else:
        hit = hit_t
        t = tt
    hit = hit & (prim != exclude)
    uv = jnp.stack([jnp.where(hit_t, u, 0.0), jnp.where(hit_t, v, 0.0)], axis=-1)
    return hit, t, uv


def _traverse_one(bvh: BVH, geom: Geometry, o, d, t_min, t_max, exclude,
                  vis_bit: int, any_hit: bool, time=None):
    """Single-ray stack traversal (vmapped). Returns (t, prim, uv, valid)."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                            jnp.where(d < 0, -1e-12, 1e-12), d)
    stack = jnp.zeros((MAX_STACK,), jnp.int32)
    n_int = bvh.node_left.shape[0] - bvh.prim_order.shape[0]

    def slab(node):
        bmin = bvh.node_min[node]
        bmax = bvh.node_max[node]
        t0 = (bmin - o) * inv_d
        t1 = (bmax - o) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1))
        tf = jnp.min(jnp.maximum(t0, t1))
        return tn, tf

    def body(state):
        sp_, stack_, best_t, best_prim, best_uv, done = state
        node = stack_[sp_ - 1]
        sp_ = sp_ - 1
        tn, tf = slab(node)
        hit_box = (tn <= tf) & (tf >= t_min) & (tn <= best_t)
        is_leaf = bvh.node_is_leaf[node]

        # leaf: intersect primitive
        prim_sorted = bvh.node_left[node]  # leaf stores morton slot
        prim = bvh.prim_order[jnp.clip(prim_sorted, 0,
                                       bvh.prim_order.shape[0] - 1)]
        ph, pt, puv = _prim_intersect(
            geom, prim, o, d, t_min, best_t, vis_bit, exclude, time=time)
        do_prim = hit_box & is_leaf
        better = do_prim & ph & (pt < best_t)
        best_t = jnp.where(better, pt, best_t)
        best_prim = jnp.where(better, prim, best_prim)
        best_uv = jnp.where(better, puv, best_uv)
        if any_hit:
            done = done | better

        # internal: push children (near-first ordering by child tn)
        push = hit_box & ~is_leaf
        lc = bvh.node_left[node]
        rc = bvh.node_right[node]
        ltn, _ = slab(lc)
        rtn, _ = slab(rc)
        near = jnp.where(ltn <= rtn, lc, rc)
        far = jnp.where(ltn <= rtn, rc, lc)
        # push far then near so near pops first
        stack_ = jnp.where(push, stack_.at[sp_].set(far), stack_)
        sp1 = jnp.where(push, sp_ + 1, sp_)
        stack_ = jnp.where(push, stack_.at[sp1].set(near), stack_)
        sp_ = jnp.where(push, sp1 + 1, sp_)
        return sp_, stack_, best_t, best_prim, best_uv, done

    def cond(state):
        sp_, _, _, _, _, done = state
        return (sp_ > 0) & ~done

    root = jnp.int32(0) if n_int > 0 else jnp.int32(0)
    init = (jnp.int32(1), stack.at[0].set(root), t_max, jnp.int32(-1),
            jnp.zeros((2,), jnp.float32), jnp.zeros((), bool))
    sp_, _, best_t, best_prim, best_uv, _ = jax.lax.while_loop(cond, body, init)
    return best_t, best_prim, best_uv


@partial(jax.jit, static_argnums=(5, 6))
def _traverse_batch(bvh, geom, o, d, args, vis_bit: int, any_hit_mode: bool):
    t_min, t_max, exclude = args[:3]
    time = args[3] if len(args) > 3 else None
    if time is None:
        f = jax.vmap(lambda oo, dd, tn, tf, ex: _traverse_one(
            bvh, geom, oo, dd, tn, tf, ex, vis_bit, any_hit_mode))
        return f(o, d, t_min, t_max, exclude)
    f = jax.vmap(lambda oo, dd, tn, tf, ex, tm: _traverse_one(
        bvh, geom, oo, dd, tn, tf, ex, vis_bit, any_hit_mode, time=tm))
    return f(o, d, t_min, t_max, exclude,
             jnp.broadcast_to(jnp.asarray(time, jnp.float32), o.shape[:-1]))


def traverse_closest(scene: SceneData, o, d, t_min, t_max,
                     exclude_prim: Optional[Array] = None,
                     shadow: bool = False, time=None):
    from ..ops.intersect import Hit
    n = o.shape[0]
    exclude = (exclude_prim if exclude_prim is not None
               else jnp.full((n,), -1, jnp.int32))
    vis_bit = 2 if shadow else 1
    args = ((t_min, t_max, exclude) if time is None
            else (t_min, t_max, exclude, time))
    bt, bp, buv = _traverse_batch(scene.bvh, scene.geom, o, d,
                                  args, vis_bit, False)
    valid = bp >= 0
    return Hit(valid=valid, t=bt, prim=jnp.maximum(bp, 0), uv=buv)


def traverse_any(scene: SceneData, o, d, t_min, t_max,
                 exclude_prim: Optional[Array] = None, time=None):
    n = o.shape[0]
    exclude = (exclude_prim if exclude_prim is not None
               else jnp.full((n,), -1, jnp.int32))
    args = ((t_min, t_max, exclude) if time is None
            else (t_min, t_max, exclude, time))
    bt, bp, buv = _traverse_batch(scene.bvh, scene.geom, o, d,
                                  args, 2, True)
    return bp >= 0
