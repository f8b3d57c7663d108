"""Photon infrastructure: wavefront photon shooting + grid-binned gather.

Replaces src/photon/* (PhotonMap + PointKdTree kNN + HashGrid,
include/photon/photon.h:112-130, pkdtree.h:77-103, hashgrid.h:36-45) and the
threaded photon-shooting workers (integrator_photon_mapping.cc:110,
integrator_montecarlo.cc:614). Wavefront redesign:

  - shooting is one masked wavefront walk: N photons advance through a
    statically-unrolled bounce loop together (no worker threads, no mutex);
  - storage is a dense uniform grid [C, K] of photon slots filled by
    scatter (replacing kd-tree/hash-grid pointer structures): radiance
    queries gather the 27 neighbor cells' slots — bulk gathers, no
    per-lane tree walks. Overflowing cells drop photons (counted, and the
    density estimate divides by the kept fraction to stay unbiased in
    expectation).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .utils import struct

from . import sampler
from .lights import _has
from .materials import bsdf as B
from .math import vec
from .ops import intersect as I
from .ops import surface as S
from .scene_types import (LIGHT_AREA, LIGHT_MESH, LIGHT_POINT, LIGHT_SPHERE,
                          LIGHT_SPOT, SceneData)

Array = jax.Array

GRID_RES = 64          # cells per axis
MAX_PER_CELL = 8       # photon slots per cell


@struct.dataclass
class PhotonMap:
    """Flat photon storage + its uniform-grid index."""
    pos: Array        # f32[P, 3]
    dir: Array        # f32[P, 3] incident direction (toward surface)
    power: Array      # f32[P, 3] flux
    valid: Array      # bool[P]
    # grid index
    cell_slots: Array     # i32[C, K] photon ids (-1 empty)
    cell_counts: Array    # i32[C] total photons mapped to cell (incl. dropped)
    grid_min: Array       # f32[3]
    inv_cell: Array       # f32[3] 1/cell_size
    num_stored: Array     # i32 total valid photons
    radius: Array         # f32 gather radius used for the grid sizing


def _emit_photons(scene: SceneData, n: int, seed: int):
    """Sample emission (Light::emitPhoton analogue) for n photons.
    Returns (origin, direction, power, valid). Light picked uniformly,
    power scaled by num_lights (uniform-pick estimator)."""
    lt = scene.lights
    nl = max(lt.num_lights, 1)
    pid = jnp.arange(n, dtype=jnp.uint32)
    sid = jnp.full((n,), seed, jnp.uint32)
    u = sampler.rand4(pid, sid, 0, 9000)
    ul, u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    u4 = sampler.rand1(pid, sid, 0, 9001)
    li = jnp.clip((ul * nl).astype(jnp.int32), 0, nl - 1)
    ty = lt.light_type[li]
    pos = lt.position[li]
    col = lt.color[li]

    o = jnp.zeros((n, 3), jnp.float32)
    d = jnp.zeros((n, 3), jnp.float32)
    pw = jnp.zeros((n, 3), jnp.float32)
    valid = jnp.zeros((n,), bool)

    # point light: uniform sphere; power = 4*pi*intensity (light_point.cc)
    if _has(lt, LIGHT_POINT):
        m = ty == LIGHT_POINT
        d_pt = vec.uniform_sample_sphere(u1, u2)
        o = jnp.where(m[..., None], pos, o)
        d = jnp.where(m[..., None], d_pt, d)
        pw = jnp.where(m[..., None], col * (4.0 * jnp.pi), pw)
        valid = valid | m

    # spot light: cone (light_spot.cc emitPhoton)
    if _has(lt, LIGHT_SPOT):
        m = ty == LIGHT_SPOT
        axis = lt.direction[li]
        au, av = vec.orthonormal_basis(axis)
        cone = vec.uniform_sample_cone(u1, u2, lt.cos_end[li])
        d_sp = au * cone[..., 0:1] + av * cone[..., 1:2] + axis * cone[..., 2:3]
        omega = 2.0 * jnp.pi * (1.0 - lt.cos_end[li])
        o = jnp.where(m[..., None], pos, o)
        d = jnp.where(m[..., None], d_sp, d)
        pw = jnp.where(m[..., None], col * omega[..., None], pw)
        valid = valid | m

    # area light: corner + u*e1 + v*e2, cosine-hemisphere direction
    # (light_area.cc emitPhoton: ipdf = area, cosine-sampled dir)
    if _has(lt, LIGHT_AREA):
        m = ty == LIGHT_AREA
        lp = pos + lt.edge1[li] * u1[..., None] + lt.edge2[li] * u2[..., None]
        nrm = lt.direction[li]
        nu, nv = vec.orthonormal_basis(nrm)
        dl = vec.cosine_sample_hemisphere(u3, u4)
        d_ar = nu * dl[..., 0:1] + nv * dl[..., 1:2] + nrm * dl[..., 2:3]
        o = jnp.where(m[..., None], lp, o)
        d = jnp.where(m[..., None], d_ar, d)
        # flux = L * area * pi (cosine integral)
        pw = jnp.where(m[..., None], col * (lt.area[li] * jnp.pi)[..., None], pw)
        valid = valid | m

    # sphere light: point on sphere + cosine hemisphere
    if _has(lt, LIGHT_SPHERE):
        m = ty == LIGHT_SPHERE
        sp_n = vec.uniform_sample_sphere(u1, u2)
        sp_p = pos + sp_n * lt.radius[li][..., None]
        su, sv = vec.orthonormal_basis(sp_n)
        dl2 = vec.cosine_sample_hemisphere(u3, u4)
        d_sl = su * dl2[..., 0:1] + sv * dl2[..., 1:2] + sp_n * dl2[..., 2:3]
        o = jnp.where(m[..., None], sp_p, o)
        d = jnp.where(m[..., None], d_sl, d)
        pw = jnp.where(m[..., None], col * (lt.area[li] * jnp.pi)[..., None], pw)
        valid = valid | m

    # mesh light: area-CDF triangle pick + cosine hemisphere
    if scene.geom.num_faces > 0 and _has(lt, LIGHT_MESH):
        from .lights import sample_light_tri
        m = ty == LIGHT_MESH
        g = scene.geom
        tri_i, _ = sample_light_tri(lt, g.num_faces, li, u1)
        fidx = g.faces[tri_i]
        v0 = g.vertices[fidx[:, 0]]
        v1 = g.vertices[fidx[:, 1]]
        v2 = g.vertices[fidx[:, 2]]
        b0, b1 = vec.sample_triangle_uniform(u2, u3)
        lp_m = v0 * b0[..., None] + v1 * b1[..., None] \
            + v2 * (1 - b0 - b1)[..., None]
        nrm_m = vec.normalize(jnp.cross(v1 - v0, v2 - v0))
        mu, mv = vec.orthonormal_basis(nrm_m)
        dl3 = vec.cosine_sample_hemisphere(u4, ul)
        d_m = mu * dl3[..., 0:1] + mv * dl3[..., 1:2] + nrm_m * dl3[..., 2:3]
        o = jnp.where(m[..., None], lp_m, o)
        d = jnp.where(m[..., None], d_m, d)
        pw = jnp.where(m[..., None], col * (lt.area[li] * jnp.pi)[..., None],
                       pw)
        valid = valid | m

    pw = pw * nl  # uniform light pick
    return o, d, pw, valid


def shoot_photons(scene: SceneData, n_photons: int, max_bounces: int = 5,
                  seed: int = 0, caustic_only: bool = False):
    """Walk n photons through the scene; returns per-deposit arrays
    (pos, dir, power, is_caustic, valid) with n_photons*max_bounces rows.

    A deposit happens at every non-delta interaction (reference
    Material::scatterPhoton chain); `is_caustic` marks deposits whose path
    was specular-only since emission (caustic map membership,
    integrator_photon_mapping.cc causticWorker)."""
    o, d, pw, valid = _emit_photons(scene, n_photons, seed)
    pid = jnp.arange(n_photons, dtype=jnp.uint32)
    sid = jnp.full((n_photons,), seed, jnp.uint32)
    bias = scene.shadow_bias

    dep_pos, dep_dir, dep_pw, dep_caus, dep_valid = [], [], [], [], []
    dep_indirect = []
    dep_n, dep_albedo = [], []
    specular_only = jnp.ones((n_photons,), bool)
    prev_prim = jnp.full((n_photons,), -1, jnp.int32)

    for depth in range(max_bounces):
        hit = I.closest_hit(scene, o, d, scene.ray_min_dist, 1e30,
                            exclude_prim=prev_prim)
        hit = hit.replace(valid=hit.valid & valid)
        sp = S.make_surface(scene, hit, o, d)
        wo = -d
        mp = B.resolve_mp(scene, sp)
        cos_wo = jnp.abs(vec.dot(wo, sp.n))
        w_dr, w_dt, w_mf, w_di, w_tl = B.lobe_weights(mp, cos_wo)
        diffuse_here = (w_di + w_tl + w_mf) > 1e-5
        store = hit.valid & diffuse_here
        if caustic_only:
            store = store & specular_only & (depth > 0)
        dep_pos.append(sp.p)
        dep_dir.append(d)
        dep_pw.append(pw)
        dep_caus.append(specular_only & (depth > 0))
        dep_indirect.append(jnp.full((n_photons,), depth > 0, bool))
        dep_valid.append(store)
        dep_n.append(sp.n)
        dep_albedo.append(mp.diffuse_color)

        if depth == max_bounces - 1:
            break
        u1, u2, u3, urr = jnp.moveaxis(
            sampler.rand4(pid, sid, depth, 9100), -1, 0)
        ms = B.sample_bsdf(scene, sp, wo, u1, u2, u3)
        new_pw = pw * ms.weight
        # Russian roulette on power ratio (photon.cc scatter chain)
        p_surv = jnp.clip(jnp.max(new_pw, -1)
                          / jnp.maximum(jnp.max(pw, -1), 1e-12), 0.05, 1.0)
        kill = urr > p_surv
        new_pw = new_pw / p_surv[..., None]
        valid = hit.valid & valid & ms.valid & ~kill
        specular_only = specular_only & ms.is_delta
        pw = jnp.where(valid[..., None], new_pw, pw)
        prev_prim = sp.prim
        o = sp.p + ms.wi * bias[..., None]
        d = ms.wi

    cat = lambda xs: jnp.concatenate(xs, axis=0)
    return (cat(dep_pos), cat(dep_dir), cat(dep_pw), cat(dep_caus),
            cat(dep_indirect), cat(dep_valid), cat(dep_n), cat(dep_albedo))


def build_photon_map(pos: Array, dir: Array, power: Array, valid: Array,
                     radius: float, scene_min, scene_max) -> PhotonMap:
    """Grid-bin the photon soup (PhotonMap::updateTree analogue; dense
    [C, K] slot table instead of a kd-tree)."""
    p = pos.shape[0]
    cell = jnp.asarray(2.0 * radius, jnp.float32)
    gmin = jnp.asarray(scene_min, jnp.float32) - cell
    inv_cell = 1.0 / cell
    res = GRID_RES
    ci = jnp.clip(((pos - gmin) * inv_cell).astype(jnp.int32), 0, res - 1)
    cid = (ci[..., 0] * res + ci[..., 1]) * res + ci[..., 2]
    cid = jnp.where(valid, cid, res ** 3)  # invalid -> overflow bucket
    # slot within cell: rank among photons in the same cell (sort-based)
    order = jnp.argsort(cid, stable=True)
    cid_sorted = cid[order]
    # rank = index - first-occurrence(index of my cell)
    first = jnp.searchsorted(cid_sorted, cid_sorted, side="left")
    rank = jnp.arange(p) - first
    keep = (rank < MAX_PER_CELL) & (cid_sorted < res ** 3)
    slot_ids = jnp.where(keep, cid_sorted * MAX_PER_CELL + rank, res ** 3 * MAX_PER_CELL)
    slots = jnp.full((res ** 3 * MAX_PER_CELL + 1,), -1, jnp.int32)
    slots = slots.at[slot_ids].set(jnp.where(keep, order, -1))
    cell_slots = slots[:-1].reshape(res ** 3, MAX_PER_CELL)
    counts = jax.ops.segment_sum(valid[order].astype(jnp.int32),
                                 jnp.clip(cid_sorted, 0, res ** 3),
                                 num_segments=res ** 3 + 1)[:res ** 3]
    return PhotonMap(pos=pos, dir=dir, power=power, valid=valid,
                     cell_slots=cell_slots, cell_counts=counts,
                     grid_min=gmin, inv_cell=jnp.full((3,), inv_cell),
                     num_stored=valid.sum().astype(jnp.int32),
                     radius=jnp.asarray(radius, jnp.float32))


def gather_flux(pm: PhotonMap, q: Array, n_hemi: Optional[Array] = None,
                r2: Optional[Array] = None) -> Tuple[Array, Array]:
    """Sum photon flux within radius of each query point (27-cell gather).

    Returns (flux_sum[N,3], count[N]). `n_hemi` (optional surface normal)
    rejects photons arriving from behind the surface. `r2` (optional
    f32[N]) gives a PER-QUERY gather radius^2 (SPPM per-pixel shrinking
    radii, integrator_sppm.cc:243-249) — must satisfy r2 <= pm.radius^2
    so the 27-cell neighborhood stays a superset of the gather sphere;
    default is the map radius. One bulk gather per neighbor-cell offset —
    no per-lane tree walks."""
    res = GRID_RES
    ci = jnp.clip(((q - pm.grid_min) * pm.inv_cell).astype(jnp.int32),
                  0, res - 1)
    r2 = (pm.radius * pm.radius if r2 is None else r2[:, None])
    ids_all = []
    scale_all = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cc = jnp.clip(ci + jnp.asarray([dx, dy, dz]), 0, res - 1)
                cell_id = (cc[..., 0] * res + cc[..., 1]) * res + cc[..., 2]
                ids_all.append(pm.cell_slots[cell_id])          # [N, K]
                cnt = pm.cell_counts[cell_id].astype(jnp.float32)
                kept = jnp.minimum(cnt, MAX_PER_CELL)
                scale = jnp.where(kept > 0, cnt / jnp.maximum(kept, 1.0), 1.0)
                scale_all.append(jnp.broadcast_to(scale[:, None],
                                                  cell_id.shape + (MAX_PER_CELL,)))
    ids = jnp.concatenate(ids_all, axis=-1)       # [N, 27K]
    scale = jnp.concatenate(scale_all, axis=-1)   # [N, 27K]
    ok = ids >= 0
    pid = jnp.maximum(ids, 0)
    pp = pm.pos[pid]                              # [N, 27K, 3]
    d2 = jnp.sum((pp - q[:, None, :]) ** 2, -1)
    in_r = ok & (d2 <= r2) & pm.valid[pid]
    if n_hemi is not None:
        front = jnp.sum(-pm.dir[pid] * n_hemi[:, None, :], -1) > 0
        in_r = in_r & front
    flux = jnp.sum(jnp.where(in_r[..., None],
                             pm.power[pid] * scale[..., None], 0.0), axis=1)
    # density-corrected count (f32): cells over MAX_PER_CELL keep a subset
    # of their photons; `scale` = stored/kept makes both the flux AND the
    # count unbiased estimates of the uncapped gather (PM_IRE and the SPPM
    # n-statistics both need the true local density, not the kept subset)
    count = jnp.sum(jnp.where(in_r, scale, 0.0), axis=1)
    return flux, count


def estimate_radiance(pm: PhotonMap, scene: SceneData, sp, wo: Array,
                      n_emitted: int) -> Array:
    """Lambertian kernel density estimate at surface points:
    L = (albedo/pi) * sum phi_p / (pi r^2 N)
    (PhotonIntegrator radiance estimate; SPPM flux/(pi r^2 N),
    integrator_sppm.cc:256)."""
    flux, _ = gather_flux(pm, sp.p, sp.n)
    mp = B.resolve_mp(scene, sp)
    f_diffuse = mp.diffuse_color / jnp.pi
    r2 = pm.radius * pm.radius
    return f_diffuse * flux / (jnp.pi * r2 * n_emitted)


def make_maps(scene: SceneData, n_diffuse: int = 65536,
              n_caustic: int = 65536, max_bounces: int = 5,
              radius: float = 0.05, seed: int = 0,
              final_gather: bool = False
              ) -> Tuple[PhotonMap, PhotonMap, Optional[PhotonMap], int, int]:
    """Shoot and bin the diffuse + caustic maps (PhotonIntegrator::preprocess
    analogue). Returns (diffuse_map, caustic_map, radiance_cache,
    n_diff_emitted, n_caus_emitted). With `final_gather`, also precomputes
    the FG radiance cache (reference "FG Radiance Photon Map",
    integrator_photon_mapping.cc:106-107,353-399)."""
    g = scene.geom
    smin = jnp.min(g.vertices, axis=0)
    smax = jnp.max(g.vertices, axis=0)
    pos, dir_, pw, caus, indirect, valid, dep_n, dep_albedo = shoot_photons(
        scene, n_diffuse, max_bounces, seed)
    # diffuse map: indirect non-caustic deposits only -> combining it with
    # NEE direct lighting does not double count; caustic map: specular-only
    # prefix paths (matches the reference's two-map split,
    # integrator_photon_mapping.cc:106-107)
    dmap = build_photon_map(pos, dir_, pw, valid & indirect & ~caus, radius,
                            smin, smax)
    cmap = build_photon_map(pos, dir_, pw, valid & caus, radius, smin, smax)
    rcache = None
    if final_gather:
        # the gather-ray lookup needs FULL radiance (direct + indirect +
        # caustic) at the gather hit, so the cache is computed from a map of
        # every deposit, then stored at the deposit locations
        gmap = build_photon_map(pos, dir_, pw, valid, radius, smin, smax)
        rcache = build_radiance_cache(gmap, pos, dep_n, dep_albedo, valid,
                                      radius, smin, smax, n_diffuse)
    return dmap, cmap, rcache, n_diffuse, n_diffuse


def build_radiance_cache(gmap: PhotonMap, pos: Array, nrm: Array,
                         albedo: Array, valid: Array, radius: float,
                         scene_min, scene_max, n_emitted: int) -> PhotonMap:
    """Precompute outgoing (Lambertian) radiance at every photon deposit
    (the reference's threaded radiance-map precompute,
    integrator_photon_mapping.cc:353-399 photonMapKdTreeWorker/"FG Radiance
    Photon Map") in one vectorized density-estimate pass over the full map.

    Returned as a PhotonMap whose `dir` holds the surface normal and whose
    `power` holds radiance — the grid index gives O(1) lookups at gather
    hits."""
    flux, _ = gather_flux(gmap, pos, nrm)
    r2 = gmap.radius * gmap.radius
    radiance = (albedo / jnp.pi) * flux / (jnp.pi * r2 * n_emitted)
    return build_photon_map(pos, nrm, radiance, valid, radius,
                            scene_min, scene_max)


def lookup_radiance(cache: PhotonMap, p: Array, n: Array) -> Array:
    """Normal-weighted average of cached radiance entries within the cache
    radius of p (reference: nearest radiance photon with compatible normal;
    here a smooth kernel over the 27-cell neighborhood)."""
    res = GRID_RES
    ci = jnp.clip(((p - cache.grid_min) * cache.inv_cell).astype(jnp.int32),
                  0, res - 1)
    r2 = cache.radius * cache.radius
    ids_all = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cc = jnp.clip(ci + jnp.asarray([dx, dy, dz]), 0, res - 1)
                cell_id = (cc[..., 0] * res + cc[..., 1]) * res + cc[..., 2]
                ids_all.append(cache.cell_slots[cell_id])
    ids = jnp.concatenate(ids_all, axis=-1)        # [N, 27K]
    ok = ids >= 0
    pid = jnp.maximum(ids, 0)
    pp = cache.pos[pid]
    d2 = jnp.sum((pp - p[:, None, :]) ** 2, -1)
    ndot = jnp.sum(cache.dir[pid] * n[:, None, :], -1)
    w = jnp.where(ok & (d2 <= r2) & cache.valid[pid],
                  jnp.maximum(ndot, 0.0) * (1.0 - d2 / r2), 0.0)
    wsum = jnp.sum(w, axis=1)
    rad = jnp.sum(cache.power[pid] * w[..., None], axis=1)
    return jnp.where(wsum[..., None] > 1e-9,
                     rad / jnp.maximum(wsum, 1e-9)[..., None], 0.0)


# ---------------------------------------------------------------------------
# Photon-map persistence (reference PhotonMap::save/load, photon.cc:54-95,
# modes generate / generate-save / load / reuse-previous,
# integrator_photon_mapping.cc:790-846)
# ---------------------------------------------------------------------------

_MAP_MAGIC = "YAF_TPU_PHOTONMAPv1"


def save_maps(photons, path: str) -> None:
    """Serialize PhotonData (diffuse + caustic + optional radiance cache)."""
    arrs = {"magic": np.asarray(_MAP_MAGIC),
            "n_emitted": np.asarray(photons.n_emitted)}

    def put(prefix, pm):
        if pm is None:
            return
        for f in ("pos", "dir", "power", "valid", "cell_slots",
                  "cell_counts", "grid_min", "inv_cell", "num_stored",
                  "radius"):
            arrs[f"{prefix}_{f}"] = np.asarray(getattr(pm, f))

    put("diffuse", photons.diffuse)
    put("caustic", photons.caustic)
    put("radiance", photons.radiance)
    np.savez_compressed(path, **arrs)


def load_maps(path: str):
    """Load PhotonData saved by save_maps."""
    from .scene_types import PhotonData
    z = np.load(path, allow_pickle=False)
    if str(z["magic"]) != _MAP_MAGIC:
        raise ValueError(f"{path}: not a {_MAP_MAGIC} file")

    def get(prefix):
        if f"{prefix}_pos" not in z:
            return None
        kw = {f: jnp.asarray(z[f"{prefix}_{f}"])
              for f in ("pos", "dir", "power", "valid", "cell_slots",
                        "cell_counts", "grid_min", "inv_cell", "num_stored",
                        "radius")}
        return PhotonMap(**kw)

    return PhotonData(diffuse=get("diffuse"), caustic=get("caustic"),
                      radiance=get("radiance"),
                      n_emitted=int(z["n_emitted"]))
