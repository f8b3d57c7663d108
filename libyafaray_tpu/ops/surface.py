"""SurfacePoint construction: gather-and-interpolate shading context.

Replaces the reference's `Primitive::getSurface` (src/geometry/primitive/
primitive_triangle.cc:98-199) and the SurfacePoint struct (include/geometry/
surface.h:54-150) with a batched SoA hit-record builder: one gather per
attribute for the whole wavefront.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..math import vec
from ..scene_types import SceneData
from .intersect import Hit

Array = jax.Array


@struct.dataclass
class SurfacePoint:
    valid: Array    # bool[N]
    p: Array        # f32[N,3] hit position
    n: Array        # f32[N,3] shading normal (bump-mapped later)
    ng: Array       # f32[N,3] geometric normal
    nu: Array       # f32[N,3] shading-frame tangent
    nv: Array       # f32[N,3] shading-frame bitangent
    uv: Array       # f32[N,2] texture coords
    orco: Array     # f32[N,3] object-space original coordinates (p if none)
    dp_du: Array    # f32[N,3]
    dp_dv: Array    # f32[N,3]
    mat_id: Array   # i32[N]
    obj_id: Array   # i32[N]
    light_id: Array # i32[N] area/mesh light covering this prim, or -1
    prim: Array     # i32[N] primitive id (for self-intersection exclusion)
    t: Array        # f32[N] ray parameter of the hit
    bary: Array = None  # f32[N,2] triangle barycentrics (u,v) of the hit
    # screen-space footprint (primary hits only; reference SurfacePoint
    # differentials, surface.h:70,123-133): world-space pixel axes and the
    # corresponding uv-space derivatives for mipmap/EWA texture filtering
    dp_dx: Array = None  # f32[N,3]
    dp_dy: Array = None  # f32[N,3]
    duv_dx: Array = None  # f32[N,2]
    duv_dy: Array = None  # f32[N,2]


def make_surface(scene: SceneData, hit: Hit, ray_o: Array, ray_d: Array
                 ) -> SurfacePoint:
    g = scene.geom
    n_rays = ray_o.shape[0]
    f = g.num_faces
    is_tri = hit.prim < f
    tri = jnp.where(is_tri, hit.prim, 0)
    sph = jnp.clip(hit.prim - f, 0, max(g.num_spheres - 1, 0))

    # Invalid lanes carry t = t_max (possibly 1e30): clamp before forming
    # positions so no inf/huge values enter downstream math — their vjp
    # would poison the gradients of whatever material row the dummy
    # mat_id 0 gather points at (0 * inf = NaN in the chain rule).
    t_safe = jnp.where(hit.valid, hit.t, 1.0)
    p = ray_o + ray_d * t_safe[..., None]

    # --- triangle branch (vectorized, masked) ---
    # true instancing: virtual face ids resolve to (base face, matrix);
    # positions transform world<-object, normals by the inverse-transpose
    # (primitive_instance.cc getGeometricNormal/getSurface analogues)
    from ..scene_types import (resolve_prim, inst_transform_point,
                               inst_transform_normal)
    tri, inst = resolve_prim(g, tri)
    fidx = g.faces[tri]                      # [N,3]
    v0 = g.vertices[fidx[:, 0]]
    v1 = g.vertices[fidx[:, 1]]
    v2 = g.vertices[fidx[:, 2]]
    if inst is not None:
        v0 = inst_transform_point(g, inst, v0)
        v1 = inst_transform_point(g, inst, v1)
        v2 = inst_transform_point(g, inst, v2)
    e1 = v1 - v0
    e2 = v2 - v0
    ng_tri = vec.normalize(jnp.cross(e1, e2))
    u = hit.uv[:, 0]
    v = hit.uv[:, 1]
    w = 1.0 - u - v
    # smooth vertex-normal interpolation (MeshObject::smoothNormals analogue)
    n0 = g.normals[fidx[:, 0]]
    n1 = g.normals[fidx[:, 1]]
    n2 = g.normals[fidx[:, 2]]
    if inst is not None:
        n0 = inst_transform_normal(g, inst, n0)
        n1 = inst_transform_normal(g, inst, n1)
        n2 = inst_transform_normal(g, inst, n2)
    n_smooth = vec.normalize(w[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2)
    smooth = g.face_smooth[tri]
    n_tri = jnp.where(smooth[:, None], n_smooth, ng_tri)
    # orco: barycentric interpolation of streamed object-space coordinates
    # (primitive_triangle.cc getSurface orco branch); p when none streamed
    if g.orcos is not None:
        orco = (w[:, None] * g.orcos[fidx[:, 0]]
                + u[:, None] * g.orcos[fidx[:, 1]]
                + v[:, None] * g.orcos[fidx[:, 2]])
    else:
        orco = p
    # texture uv interpolation
    fuv = g.face_uvs[tri]
    uv0 = g.uvs[fuv[:, 0]]
    uv1 = g.uvs[fuv[:, 1]]
    uv2 = g.uvs[fuv[:, 2]]
    uv_tri = w[:, None] * uv0 + u[:, None] * uv1 + v[:, None] * uv2
    # dp/du, dp/dv from uv parametrization (primitive_triangle.cc:117-150);
    # fall back to an arbitrary frame when the uv mapping is degenerate
    du1 = uv1[:, 0] - uv0[:, 0]
    du2 = uv2[:, 0] - uv0[:, 0]
    dv1 = uv1[:, 1] - uv0[:, 1]
    dv2 = uv2[:, 1] - uv0[:, 1]
    det = du1 * dv2 - dv1 * du2
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    dp_du_t = (dv2 * inv_det)[:, None] * e1 + (-dv1 * inv_det)[:, None] * e2
    dp_dv_t = (-du2 * inv_det)[:, None] * e1 + (du1 * inv_det)[:, None] * e2
    degen = jnp.abs(det) <= 1e-12
    fb_u, fb_v = vec.orthonormal_basis(ng_tri)
    dp_du_t = jnp.where(degen[:, None], fb_u, dp_du_t)
    dp_dv_t = jnp.where(degen[:, None], fb_v, dp_dv_t)
    mat_tri = g.face_mat[tri]
    obj_tri = g.face_obj[tri]
    if inst is not None and g.inst_obj is not None:
        obj_tri = jnp.where(inst >= 0, g.inst_obj[jnp.maximum(inst, 0)],
                            obj_tri)
    light_tri = g.face_light[tri]

    if g.num_spheres > 0:
        # --- sphere branch ---
        c = g.sph_center[sph]
        r = g.sph_radius[sph][:, None]
        n_sph = vec.normalize(p - c)
        theta = jnp.arccos(jnp.clip(n_sph[:, 2], -1.0, 1.0))
        phi = jnp.arctan2(n_sph[:, 1], n_sph[:, 0])
        uv_sph = jnp.stack([(phi / (2 * jnp.pi)) + 0.5, theta / jnp.pi], axis=-1)
        su, sv = vec.orthonormal_basis(n_sph)
        ng = jnp.where(is_tri[:, None], ng_tri, n_sph)
        n = jnp.where(is_tri[:, None], n_tri, n_sph)
        uv = jnp.where(is_tri[:, None], uv_tri, uv_sph)
        dp_du = jnp.where(is_tri[:, None], dp_du_t, su)
        dp_dv = jnp.where(is_tri[:, None], dp_dv_t, sv)
        mat_id = jnp.where(is_tri, mat_tri, g.sph_mat[sph])
        obj_id = jnp.where(is_tri, obj_tri, g.sph_obj[sph])
        light_id = jnp.where(is_tri, light_tri, -1)
        orco = jnp.where(is_tri[:, None], orco, p)
    else:
        ng, n, uv = ng_tri, n_tri, uv_tri
        dp_du, dp_dv = dp_du_t, dp_dv_t
        mat_id, obj_id, light_id = mat_tri, obj_tri, light_tri

    # shading frame: gram-schmidt dp_du against n (surface.h nu/nv)
    nu = vec.normalize(dp_du - n * vec.dot(dp_du, n, keepdims=True))
    nv = jnp.cross(n, nu)

    return SurfacePoint(
        valid=hit.valid, p=p, n=n, ng=ng, nu=nu, nv=nv, uv=uv, orco=orco,
        dp_du=dp_du, dp_dv=dp_dv,
        mat_id=jnp.where(hit.valid, mat_id, 0),
        obj_id=jnp.where(hit.valid, obj_id, 0),
        light_id=jnp.where(hit.valid, light_id, -1),
        prim=jnp.where(hit.valid, hit.prim, -1),
        t=hit.t,
        bary=hit.uv,
    )


def compute_differentials(scene: SceneData, sp: SurfacePoint,
                          d: Array) -> SurfacePoint:
    """Attach screen-space footprint differentials to primary-hit surface
    points (the analogue of the reference's SurfacePoint UV-differential
    computation for mipmapping, surface.h:123-133 / surface.cc).

    Instead of tracing offset rays, the one-pixel footprint is derived
    analytically: radius r = t * pixel_spread in the two directions
    perpendicular to the ray, projected onto the surface tangent plane
    along the ray, then converted to uv space by solving the 2x2
    least-squares system against dp_du/dp_dv (PBRT-style)."""
    if scene.pixel_spread is None:
        return sp
    r = sp.t * scene.pixel_spread
    # orthonormal frame perpendicular to the ray
    e1 = vec.normalize(jnp.cross(d, jnp.where(
        jnp.abs(d[..., 2:3]) < 0.9,
        jnp.array([0.0, 0.0, 1.0]), jnp.array([1.0, 0.0, 0.0]))))
    e2 = jnp.cross(d, e1)
    # project the offset onto the tangent plane along the ray direction
    dn = vec.dot(d, sp.ng, keepdims=True)
    dn = jnp.where(jnp.abs(dn) < 1e-6, jnp.where(dn < 0, -1e-6, 1e-6), dn)
    ax = (e1 - d * (vec.dot(e1, sp.ng, keepdims=True) / dn)) * r[..., None]
    ay = (e2 - d * (vec.dot(e2, sp.ng, keepdims=True) / dn)) * r[..., None]
    # solve [dp_du dp_dv] [du dv]^T = axis for each axis (2x2 normal eqs)
    a11 = vec.dot(sp.dp_du, sp.dp_du)
    a12 = vec.dot(sp.dp_du, sp.dp_dv)
    a22 = vec.dot(sp.dp_dv, sp.dp_dv)
    det = a11 * a22 - a12 * a12
    inv_det = jnp.where(jnp.abs(det) > 1e-18, 1.0 / det, 0.0)

    def solve(axis):
        b1 = vec.dot(axis, sp.dp_du)
        b2 = vec.dot(axis, sp.dp_dv)
        du = (a22 * b1 - a12 * b2) * inv_det
        dv = (a11 * b2 - a12 * b1) * inv_det
        return jnp.stack([du, dv], -1)

    v = sp.valid[..., None]
    return sp.replace(dp_dx=jnp.where(v, ax, 0.0),
                      dp_dy=jnp.where(v, ay, 0.0),
                      duv_dx=jnp.where(v, solve(ax), 0.0),
                      duv_dy=jnp.where(v, solve(ay), 0.0))
