"""Block accelerator: morton-sorted triangle blocks + dense AABB culling.

The production replacement for the reference's SAH kd-tree traversal
(src/accelerator/accelerator_kdtree.cc:639-721). Instead of a per-ray
pointer-chasing descent (divergent per-lane scalar gathers in a
wavefront), primitives are morton-sorted and grouped into CONTIGUOUS
blocks of B triangles (spatially coherent by construction); a query then

  1. slab-tests every ray against every block AABB in one dense [N, C]
     pass (pure VPU work, no gathers), and
  2. repeatedly picks each ray's nearest untested candidate block
     (argmin over the [N, C] entry-distance table) and intersects its B
     triangles with one contiguous gather + a dense Möller-Trumbore
     batch, until every ray's nearest remaining block entry exceeds its
     best hit.

Compared to a per-node BVH walk this trades ~B/2 extra triangle tests per
step for B-wide gathers and zero divergence. The block size auto-scales
so the block count stays <= MAX_BLOCKS (the [N, C] table stays small and
argmin cheap).

Spheres are intersected densely after the block loop (scenes carry few
analytic spheres; same treatment as the brute path).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from ..utils import struct

from ..math import vec
from ..scene_types import Geometry
from .morton import morton3d

Array = jax.Array

MAX_BLOCKS = 4096      # cap on C so the per-chunk [N, C] key table is small
MIN_BLOCK = 128        # minimum triangles per block (gather amortization)
RAY_CHUNK = 4096       # rays per lax.map chunk (bounds the key table to
                       # RAY_CHUNK*MAX_BLOCKS*4B = 64 MB)


@struct.dataclass
class BlockAccel:
    """Morton-block tables, laid out [C, B, ...] so a block fetch is ONE
    row-gather of a contiguous slice (a 9*B-float row, not 3*B scalar
    gathers)."""
    geo: Array       # f32[C, B, 9] v0|v1|v2 per triangle (time step 0)
    meta: Array      # i32[C, B, 2] (original face index | -1, visibility)
    bmin: Array      # f32[C, 3] block AABB (union over all time steps)
    bmax: Array      # f32[C, 3]
    # motion blur keyframes (b-spline control points; None when static).
    # Block AABBs are unions over all control points — the b-spline curve
    # lies inside the control hull, so culling stays conservative.
    geo_t1: Optional[Array] = None   # f32[C, B, 9]
    geo_t2: Optional[Array] = None   # f32[C, B, 9] (quadratic only)
    # TRUE instancing (None when the scene has no live instances): the C
    # VIRTUAL blocks indirect into C_phys PHYSICAL table rows. bmin/bmax
    # are per-VIRTUAL-block world AABBs; geo/meta rows are physical
    # (object space for instanced bases) and shared across instances.
    # Rays are transformed object<-world per block at query time.
    blk_base: Optional[Array] = None   # i32[C] physical row of block j
    blk_minv: Optional[Array] = None   # i32[C] row into inv_rows (0 = id)
    id_delta: Optional[Array] = None   # i32[C] virtual - base prim offset
    inv_rows: Optional[Array] = None   # f32[K+1, 12] object<-world 3x4
    block_size: int = struct.field(pytree_node=False, default=MIN_BLOCK)
    num_blocks: int = struct.field(pytree_node=False, default=0)


def _pick_block_size(f: int) -> int:
    b = MIN_BLOCK
    while (f + b - 1) // b > MAX_BLOCKS:
        b *= 2
    return b


def build_blocks(geom: Geometry) -> BlockAccel:
    """Morton-sort the triangles and cut them into contiguous blocks.
    Fully on device; the analogue of the reference's threaded kd build
    (accelerator_kdtree_multi_thread.cc) but embarrassingly parallel.

    With true instancing (geom.inst_mat), physical tables cover the base
    faces plus one morton-blocked copy of each DISTINCT instanced base
    range; virtual blocks replicate the base blocks per instance with
    transformed world AABBs — O(base) geometry memory regardless of the
    instance count (object_instance.h:29-63 analogue)."""
    if geom.inst_mat is not None:
        return _build_blocks_instanced(geom)
    f = geom.num_faces
    if f == 0:
        raise ValueError("block accel needs triangles")
    b = _pick_block_size(f)
    t = _tables_for(geom, None, b)
    return BlockAccel(geo=t["geo"], meta=t["meta"], bmin=t["bmin"],
                      bmax=t["bmax"], geo_t1=t["geo_t1"], geo_t2=t["geo_t2"],
                      block_size=b, num_blocks=t["c"])


def _tables_for(geom: Geometry, face_ids: Optional[Array], b: int,
                vis_value: Optional[int] = None) -> dict:
    """Morton-sorted block tables for a face subset (None = all physical
    faces). Prim ids in meta are the GLOBAL physical face ids.
    `vis_value` overrides the gathered per-face visibility (instance
    tables of an is_base_object base, whose static faces are vis-0)."""
    if face_ids is None:
        faces = geom.faces
        gather_vis = geom.face_vis
        ids = jnp.arange(faces.shape[0], dtype=jnp.int32)
    else:
        ids = jnp.asarray(face_ids, jnp.int32)
        faces = geom.faces[ids]
        gather_vis = (geom.face_vis[ids] if vis_value is None
                      else jnp.full((ids.shape[0],), vis_value,
                                    geom.face_vis.dtype))
    f = faces.shape[0]
    c = (f + b - 1) // b
    v0 = geom.vertices[faces[:, 0]]
    v1 = geom.vertices[faces[:, 1]]
    v2 = geom.vertices[faces[:, 2]]
    tmin = jnp.minimum(jnp.minimum(v0, v1), v2)
    tmax = jnp.maximum(jnp.maximum(v0, v1), v2)
    centroid = 0.5 * (tmin + tmax)
    smin = jnp.min(tmin, axis=0)
    smax = jnp.max(tmax, axis=0)
    rel = (centroid - smin) / jnp.maximum(smax - smin, 1e-12)
    order = jnp.argsort(morton3d(rel), stable=True).astype(jnp.int32)

    pad = c * b - f
    def pad3(x):
        return jnp.concatenate(
            [x[order], jnp.full((pad, 3), jnp.inf, jnp.float32)]) if pad \
            else x[order]
    v0s, v1s, v2s = pad3(v0), pad3(v1), pad3(v2)
    prim = jnp.concatenate([ids[order], jnp.full((pad,), -1, jnp.int32)]) \
        if pad else ids[order]
    vis = jnp.concatenate([gather_vis[order],
                           jnp.zeros((pad,), gather_vis.dtype)]) \
        if pad else gather_vis[order]

    valid = (prim >= 0).reshape(c, b)

    def keyframe_tables(verts):
        k0 = pad3(verts[faces[:, 0]])
        k1 = pad3(verts[faces[:, 1]])
        k2 = pad3(verts[faces[:, 2]])
        geo_k = jnp.concatenate([k0, k1, k2], axis=-1).reshape(c, b, 9)
        kmin = jnp.where(valid[..., None],
                         jnp.minimum(jnp.minimum(k0, k1), k2).reshape(c, b, 3),
                         jnp.inf)
        kmax = jnp.where(valid[..., None],
                         jnp.maximum(jnp.maximum(k0, k1), k2).reshape(c, b, 3),
                         -jnp.inf)
        return geo_k, jnp.min(kmin, axis=1), jnp.max(kmax, axis=1)

    bt_min = jnp.where(valid[..., None],
                       jnp.minimum(jnp.minimum(v0s, v1s), v2s).reshape(c, b, 3),
                       jnp.inf)
    bt_max = jnp.where(valid[..., None],
                       jnp.maximum(jnp.maximum(v0s, v1s), v2s).reshape(c, b, 3),
                       -jnp.inf)
    bmin = jnp.min(bt_min, axis=1)
    bmax = jnp.max(bt_max, axis=1)
    geo = jnp.concatenate([v0s, v1s, v2s], axis=-1).reshape(c, b, 9)
    geo_t1 = geo_t2 = None
    if geom.has_motion and geom.vertices_t1 is not None:
        geo_t1, m1, x1 = keyframe_tables(geom.vertices_t1)
        bmin = jnp.minimum(bmin, m1)
        bmax = jnp.maximum(bmax, x1)
        if geom.vertices_t2 is not None:
            geo_t2, m2, x2 = keyframe_tables(geom.vertices_t2)
            bmin = jnp.minimum(bmin, m2)
            bmax = jnp.maximum(bmax, x2)
    meta = jnp.stack([prim, vis.astype(jnp.int32)], axis=-1).reshape(c, b, 2)
    return dict(geo=geo, meta=meta, bmin=bmin, bmax=bmax, geo_t1=geo_t1,
                geo_t2=geo_t2, c=int(c))


def _build_blocks_instanced(geom: Geometry) -> BlockAccel:
    """Physical tables: all base faces + one blocked copy per DISTINCT
    instanced base range (object space). Virtual blocks: the static blocks
    plus one replica of each base's blocks per instance, with world AABBs
    from the transformed base-block AABB corners and the object<-world
    matrix for ray transformation at query time."""
    import numpy as np
    k_inst = geom.inst_face_base.shape[0]
    f0 = geom.num_base_faces
    b = _pick_block_size(geom.num_faces)
    parts = [_tables_for(geom, None, b)] if f0 > 0 else []

    # distinct instanced base ranges
    base_np = np.asarray(geom.inst_face_base)
    off_np = np.asarray(geom.inst_face_off)
    counts = np.diff(off_np)
    ranges = {}
    phys_at = parts[0]["c"] if parts else 0
    inst_vis_np = (np.asarray(geom.inst_vis)
                   if geom.inst_vis is not None else None)
    for kk in range(k_inst):
        key = (int(base_np[kk]), int(counts[kk]))
        if key not in ranges:
            sub = _tables_for(
                geom, jnp.arange(key[0], key[0] + key[1], dtype=jnp.int32), b,
                vis_value=(int(inst_vis_np[kk])
                           if inst_vis_np is not None else None))
            ranges[key] = (phys_at, sub)
            phys_at += sub["c"]
            parts.append(sub)

    def cat(name):
        vals = [p[name] for p in parts]
        if any(v is None for v in vals):
            return None
        return jnp.concatenate(vals, axis=0)

    geo = cat("geo")
    meta = cat("meta")
    geo_t1, geo_t2 = cat("geo_t1"), cat("geo_t2")
    phys_bmin = jnp.concatenate([p["bmin"] for p in parts], axis=0)
    phys_bmax = jnp.concatenate([p["bmax"] for p in parts], axis=0)

    # virtual block lists
    c_static = parts[0]["c"] if f0 > 0 else 0
    blk_base = [np.arange(c_static, dtype=np.int32)]
    blk_minv = [np.zeros(c_static, np.int32)]
    id_delta = [np.zeros(c_static, np.int32)]
    v_bmin = [np.asarray(phys_bmin[:c_static])]
    v_bmax = [np.asarray(phys_bmax[:c_static])]
    mats = np.asarray(geom.inst_mat)          # [K, 3, 4]
    for kk in range(k_inst):
        key = (int(base_np[kk]), int(counts[kk]))
        p_at, sub = ranges[key]
        cb = sub["c"]
        blk_base.append(np.arange(p_at, p_at + cb, dtype=np.int32))
        blk_minv.append(np.full(cb, kk + 1, np.int32))
        id_delta.append(np.full(cb, int(off_np[kk]) - key[0], np.int32))
        bo = np.asarray(sub["bmin"])
        bx = np.asarray(sub["bmax"])
        # world AABB of each block: transform the 8 object-space corners
        corners = np.stack([
            np.stack([np.where(m & 1, bx[:, 0], bo[:, 0]),
                      np.where(m & 2, bx[:, 1], bo[:, 1]),
                      np.where(m & 4, bx[:, 2], bo[:, 2])], axis=-1)
            for m in range(8)], axis=1)       # [cb, 8, 3]
        r = mats[kk, :, :3]
        tvec = mats[kk, :, 3]
        wc = corners @ r.T + tvec
        v_bmin.append(wc.min(axis=1).astype(np.float32))
        v_bmax.append(wc.max(axis=1).astype(np.float32))
    inv_np = np.concatenate(
        [np.eye(3, 4, dtype=np.float32).reshape(1, 12)[:, :12],
         np.asarray(geom.inst_inv).reshape(k_inst, 12)], axis=0)
    return BlockAccel(
        geo=geo, meta=meta,
        bmin=jnp.asarray(np.concatenate(v_bmin, axis=0)),
        bmax=jnp.asarray(np.concatenate(v_bmax, axis=0)),
        geo_t1=geo_t1, geo_t2=geo_t2,
        blk_base=jnp.asarray(np.concatenate(blk_base)),
        blk_minv=jnp.asarray(np.concatenate(blk_minv)),
        id_delta=jnp.asarray(np.concatenate(id_delta)),
        inv_rows=jnp.asarray(inv_np),
        block_size=b,
        num_blocks=int(sum(len(x) for x in blk_base)))


def _safe_inv(d: Array) -> Array:
    return 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                           jnp.where(d < 0, -1e-12, 1e-12), d)


def _query_chunk(acc: BlockAccel, o, d, t_min, t_max, exclude,
                 vis_bit: int, any_hit: bool, time=None):
    """One ray chunk through the block loop. Returns (t, prim, uv)."""
    from ..ops.intersect import moller_trumbore
    n = o.shape[0]
    c = acc.num_blocks
    b = acc.block_size
    inv_d = _safe_inv(d)

    # dense slab test against every block AABB: [n, c]
    t0 = (acc.bmin[None] - o[:, None]) * inv_d[:, None]
    t1 = (acc.bmax[None] - o[:, None]) * inv_d[:, None]
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit_blk = (tn <= tf) & (tf >= t_min[:, None]) & (tn <= t_max[:, None])
    key = jnp.where(hit_blk, jnp.maximum(tn, t_min[:, None]), jnp.inf)

    # ONE per-ray sort of block entry distances up front, then iterate
    # blocks in sorted order. Replaces per-iteration argmin + scatter-
    # invalidate over the [n, c] key table (2x26MB HBM traffic per step at
    # n=4096, c=1600) with a single sort; the loop body then only reads one
    # [n] column per step. Stored transposed [c, n] so each step's column
    # read is a contiguous row slice.
    skey, order = jax.lax.sort((key, jnp.broadcast_to(
        jnp.arange(c, dtype=jnp.int32), (n, c))), dimension=1, num_keys=1)
    skey_t = skey.T          # f32[c, n] entry distance, ascending per ray
    order_t = order.T        # i32[c, n] block id per sorted position

    rows = jnp.arange(n)

    def cond(st):
        best_t, best_prim, _, it = st
        nxt = jax.lax.dynamic_index_in_dim(skey_t, it, keepdims=False)
        act = nxt <= best_t
        if any_hit:
            act = act & (best_prim < 0)
        return (it < c) & jnp.any(act)

    def body(st):
        best_t, best_prim, best_uv, it = st
        j = jax.lax.dynamic_index_in_dim(order_t, it, keepdims=False)
        nxt = jax.lax.dynamic_index_in_dim(skey_t, it, keepdims=False)
        act = nxt <= best_t
        if any_hit:
            act = act & (best_prim < 0)
        # ONE row-gather per table: [n, b, 9] / [n, b, 2] contiguous slices
        pj = acc.blk_base[j] if acc.blk_base is not None else j
        g = acc.geo[pj]
        m = acc.meta[pj]
        if time is not None and acc.geo_t1 is not None:
            tt = time[:, None, None]
            g1 = acc.geo_t1[pj]
            if acc.geo_t2 is not None:
                # quadratic b-spline (primitive_triangle_bspline.cc:40-44)
                g2 = acc.geo_t2[pj]
                tc = 1.0 - tt
                g = g * (tc * tc) + g1 * (2.0 * tt * tc) + g2 * (tt * tt)
            else:
                g = g * (1.0 - tt) + g1 * tt
        gv0, gv1, gv2 = g[..., 0:3], g[..., 3:6], g[..., 6:9]
        if acc.inv_rows is not None:
            # instanced block: transform the ray object<-world; leaving the
            # direction unnormalized preserves the world t parameterization
            # (elementwise multiply-sums: a batched matvec as a dot may run
            # in TF32 on a GPU, and hit distances need full f32)
            mv = acc.inv_rows[acc.blk_minv[j]].reshape(-1, 3, 4)
            oq = jnp.sum(mv[:, :, :3] * o[:, None, :], axis=-1) + mv[:, :, 3]
            dq = jnp.sum(mv[:, :, :3] * d[:, None, :], axis=-1)
        else:
            oq, dq = o, d
        hit, t, u, v = moller_trumbore(oq[:, None], dq[:, None], gv0, gv1,
                                       gv2, t_min[:, None], best_t[:, None])
        pid = m[..., 0]
        if acc.id_delta is not None:
            pid = jnp.where(pid >= 0, pid + acc.id_delta[j][:, None], pid)
        hit = (hit & ((m[..., 1] & vis_bit) != 0)
               & (pid != exclude[:, None]) & act[:, None])
        t = jnp.where(hit, t, jnp.inf)
        jt = jnp.argmin(t, axis=1)
        tc = t[rows, jt]
        better = tc < best_t
        best_t = jnp.where(better, tc, best_t)
        best_prim = jnp.where(better, pid[rows, jt], best_prim)
        best_uv = jnp.where(better[:, None],
                            jnp.stack([u[rows, jt], v[rows, jt]], -1),
                            best_uv)
        return best_t, best_prim, best_uv, it + 1

    init = (t_max, jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n, 2), jnp.float32), jnp.int32(0))
    best_t, best_prim, best_uv, _ = jax.lax.while_loop(cond, body, init)
    return best_t, best_prim, best_uv


def query(acc: BlockAccel, geom: Geometry, o, d, t_min, t_max, exclude,
          vis_bit: int, any_hit: bool, time=None):
    """Full-wavefront query: pads + reshapes into RAY_CHUNK chunks mapped
    sequentially through the block loop (bounds the [chunk, C] key
    table), then appends the dense sphere pass."""
    n = o.shape[0]
    chunk = min(RAY_CHUNK, max(256, n))
    pad = (-n) % chunk
    sorted_rays = False
    if n > chunk:
        # Sort rays by (direction octant, coarse origin morton, direction
        # morton): each chunk then has BOTH a tight origin box and a tight
        # direction cone, so its rays enter few blocks in common (the
        # wavefront analogue of the packet coherence the reference gets
        # for free from per-pixel recursion order). Direction bits matter
        # most for pinhole cameras — all origins coincide, and without
        # them a chunk is a raster run spanning the full FOV in x.
        smin = jnp.min(acc.bmin, axis=0)
        sinv = 1.0 / jnp.maximum(jnp.max(acc.bmax, axis=0) - smin, 1e-12)
        rel = jnp.clip((o - smin) * sinv, 0.0, 1.0)
        okey = morton3d(rel) >> jnp.uint32(18)          # top 12 bits (16^3)
        dkey = morton3d(0.5 * (d + 1.0)) >> jnp.uint32(15)   # 15 bits (32^3)
        oct_ = ((d[:, 0] >= 0).astype(jnp.uint32)
                | ((d[:, 1] >= 0).astype(jnp.uint32) << 1)
                | ((d[:, 2] >= 0).astype(jnp.uint32) << 2))
        # dead rays (empty t-range, e.g. terminated paths / gated shadow
        # rays) sort to the END: their chunks exit the loop at once
        dead = (t_max < t_min).astype(jnp.uint32)
        key = ((dead << jnp.uint32(30)) | (oct_ << jnp.uint32(27))
               | (okey << jnp.uint32(15)) | dkey)
        # ONE variadic sort carries the whole ray payload with the key
        # (and a second one restores the order), instead of argsort plus
        # ten 1-D gathers each way
        iota = jnp.arange(n, dtype=jnp.int32)
        payload = [iota, o[:, 0], o[:, 1], o[:, 2],
                   d[:, 0], d[:, 1], d[:, 2], t_min, t_max, exclude]
        if time is not None:
            payload.append(time)
        out = jax.lax.sort((key, *payload), dimension=0, num_keys=1)
        orig_idx = out[1]
        o = jnp.stack(out[2:5], axis=-1)
        d = jnp.stack(out[5:8], axis=-1)
        t_min, t_max, exclude = out[8], out[9], out[10]
        if time is not None:
            time = out[11]
        sorted_rays = True

    def unsort(bt, bp, bu, bv):
        """Restore original ray order: a second variadic sort keyed by the
        carried original index (gather-free, see the sort note above)."""
        if not sorted_rays:
            return bt, bp, jnp.stack([bu, bv], axis=-1)
        _, bt, bp, bu, bv = jax.lax.sort(
            (orig_idx, bt, bp, bu, bv), dimension=0, num_keys=1)
        return bt, bp, jnp.stack([bu, bv], axis=-1)

    def padded(x, fill):
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)]) if pad else x
    os_ = padded(o, 0.0).reshape(-1, chunk, 3)
    ds_ = padded(d, 1.0).reshape(-1, chunk, 3)
    tmins = padded(t_min, 0.0).reshape(-1, chunk)
    tmaxs = padded(t_max, -1.0).reshape(-1, chunk)  # padded rays: empty range
    excl = padded(exclude, -1).reshape(-1, chunk)
    times = (padded(time, 0.0).reshape(-1, chunk)
             if time is not None else None)
    if os_.shape[0] == 1:
        bt, bp, buv = _query_chunk(acc, os_[0], ds_[0], tmins[0], tmaxs[0],
                                   excl[0], vis_bit, any_hit,
                                   time=None if times is None else times[0])
    elif times is None:
        bt, bp, buv = jax.lax.map(
            lambda xs: _query_chunk(acc, *xs, vis_bit, any_hit),
            (os_, ds_, tmins, tmaxs, excl))
        bt, bp, buv = bt.reshape(-1), bp.reshape(-1), buv.reshape(-1, 2)
    else:
        bt, bp, buv = jax.lax.map(
            lambda xs: _query_chunk(acc, *xs[:-1], vis_bit, any_hit,
                                    time=xs[-1]),
            (os_, ds_, tmins, tmaxs, excl, times))
        bt, bp, buv = bt.reshape(-1), bp.reshape(-1), buv.reshape(-1, 2)
    bt, bp, buv = bt[:n], bp[:n], buv[:n]
    bt, bp, buv = _sphere_pass(geom, o, d, t_min, t_max, exclude, vis_bit,
                               bt, bp, buv)
    return unsort(bt, bp, buv[..., 0], buv[..., 1])


def _sphere_pass(geom: Geometry, o, d, t_min, t_max, exclude, vis_bit: int,
                 bt, bp, buv):
    """Dense analytic-sphere pass appended after block traversal (scenes
    carry few spheres; same treatment as the brute path)."""
    from ..ops.intersect import intersect_sphere
    s = geom.num_spheres
    if s > 0:
        n = o.shape[0]
        best_t = jnp.where(bp >= 0, bt, t_max)
        hit, t = intersect_sphere(
            o[:, None, :], d[:, None, :], geom.sph_center[None],
            geom.sph_radius[None], t_min[..., None], best_t[:, None])
        hit = hit & ((geom.sph_vis[None, :] & vis_bit) != 0)
        sph_ids = geom.num_faces + jnp.arange(s, dtype=jnp.int32)
        hit = hit & (sph_ids[None, :] != exclude[:, None])
        t = jnp.where(hit, t, jnp.inf)
        j = jnp.argmin(t, axis=1)
        rows = jnp.arange(n)
        tj = t[rows, j]
        better = tj < best_t
        bt = jnp.where(better, tj, bt)
        bp = jnp.where(better, sph_ids[j], bp)
        buv = jnp.where(better[:, None], 0.0, buv)
    return bt, bp, buv


def blocks_closest(scene, o, d, t_min, t_max,
                   exclude_prim: Optional[Array] = None,
                   shadow: bool = False, time=None):
    from ..ops.intersect import Hit
    n = o.shape[0]
    exclude = (exclude_prim if exclude_prim is not None
               else jnp.full((n,), -1, jnp.int32))
    bt, bp, buv = query(scene.blocks, scene.geom, o, d, t_min, t_max,
                        exclude, 2 if shadow else 1, False, time=time)
    valid = bp >= 0
    return Hit(valid=valid, t=jnp.where(valid, bt, t_max),
               prim=jnp.maximum(bp, 0), uv=buv)


def blocks_any(scene, o, d, t_min, t_max,
               exclude_prim: Optional[Array] = None, time=None) -> Array:
    n = o.shape[0]
    exclude = (exclude_prim if exclude_prim is not None
               else jnp.full((n,), -1, jnp.int32))
    _, bp, _ = query(scene.blocks, scene.geom, o, d, t_min, t_max,
                     exclude, 2, True, time=time)
    return bp >= 0
