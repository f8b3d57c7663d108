"""Cameras: batched `shoot_rays` per camera kind.

Replaces the reference Camera hierarchy (src/camera/*, factory at
src/camera/camera.cc:43-47: angular / perspective / architect / orthographic /
equirectangular). The camera kind is static per render view, so each kind's
math is traced directly — no masking across kinds.

Convention: pixel coordinates (px, py) are continuous in [0, resx) x [0, resy)
with y down (image row 0 at top), matching the reference's film addressing.
"""
from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import params as P
from ..math import vec
from ..scene_types import Camera

Array = jax.Array


def _build_frame(pos, look, up):
    pos = np.asarray(pos, np.float32)
    look = np.asarray(look, np.float32)
    up = np.asarray(up, np.float32)
    forward = look - pos
    fn = forward / max(np.linalg.norm(forward), 1e-20)
    upv = up - pos
    right = np.cross(fn, upv)
    if np.linalg.norm(right) < 1e-12:  # up parallel to view dir
        right = np.array([1.0, 0.0, 0.0], np.float32)
    right = right / max(np.linalg.norm(right), 1e-20)
    upn = np.cross(right, fn)
    upn = upn / max(np.linalg.norm(upn), 1e-20)
    return pos, right.astype(np.float32), upn.astype(np.float32), fn.astype(np.float32)


def make_camera(pm: P.ParamMap) -> Camera:
    """Build a Camera struct from reference-style params (type/from/to/up/
    resx/resy/fov or scale/aperture/dof_distance/bokeh_type/...)."""
    kind = pm.get_string("type", "perspective")
    resx = pm.get_int("resx", 256)
    resy = pm.get_int("resy", 256)
    pos, right, up, fwd = _build_frame(
        pm.get_vector("from", (0, 0, 0)),
        pm.get_vector("to", (0, 1, 0)),
        pm.get_vector("up", (0, 0, 1)) if "up" in pm else
        np.asarray(pm.get_vector("from", (0, 0, 0)), np.float32) + np.array([0, 0, 1], np.float32),
    )
    aspect = resy / resx * pm.get_float("aspect_ratio_factor", 1.0)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    common = dict(
        origin=f32(pos), cam_x=f32(right), cam_y=f32(up), cam_z=f32(fwd),
        aspect=f32(aspect),
        near_clip=f32(pm.get_float("nearClip", -1.0)),
        far_clip=f32(pm.get_float("farClip", -1.0)),
        resx=resx, resy=resy,
        focal=f32(1.0), aperture=f32(0.0), dof_distance=f32(0.0),
        angle=f32(0.0), ortho_scale=f32(1.0), bokeh_rotation=f32(0.0),
        max_radius=f32(1.0),
    )
    if kind in ("perspective", "architect"):
        # reference: camera_perspective.cc — focal = 0.5 / tan(fov/2) in
        # normalized screen units where screen x spans [-0.5, 0.5)
        fov = pm.get_float("fov", 45.0) * math.pi / 180.0
        common.update(
            focal=f32(0.5 / math.tan(fov * 0.5)),
            aperture=f32(pm.get_float("aperture", 0.0)),
            dof_distance=f32(pm.get_float("dof_distance", 0.0)),
        )
        return Camera(kind=kind, bokeh_kind=pm.get_string("bokeh_type", "disk"),
                      **common)
    if kind == "orthographic":
        common.update(ortho_scale=f32(pm.get_float("scale", 1.0)))
        return Camera(kind=kind, **common)
    if kind == "angular":
        ang = pm.get_float("angle", 90.0)
        common.update(
            angle=f32(ang * math.pi / 180.0),
            # clip radius in image-half-width units (camera_angular.cc:33
            # max_radius_ = max_angle / angle)
            max_radius=f32(pm.get_float("max_angle", ang) / max(ang, 1e-9)))
        proj = pm.get_string("projection", "equidistant")
        return Camera(kind=kind, angular_projection=proj,
                      circular=pm.get_bool("circular", True),
                      mirrored=pm.get_bool("mirrored", False), **common)
    if kind == "equirectangular":
        return Camera(kind=kind, **common)
    raise KeyError(f"camera: unknown type {kind!r}")


_BOKEH_SIDES = {"triangle": 3, "square": 4, "pentagon": 5, "hexagon": 6}


def _sample_bokeh(kind: str, u1: Array, u2: Array, rotation: Array):
    """Aperture point sampling incl. polygonal bokeh (reference
    camera_perspective.h:43-58 bokeh types disk/triangle/square/pentagon/
    hexagon/ring)."""
    if kind in ("disk", "disk1", "disk2"):
        return vec.sample_disk_concentric(u1, u2)
    if kind == "ring":
        ang = 2.0 * jnp.pi * u1
        return jnp.cos(ang), jnp.sin(ang)
    sides = _BOKEH_SIDES.get(kind, 0)
    if sides == 0:
        return vec.sample_disk_concentric(u1, u2)
    # sample a wedge of the regular polygon, uniform over its area
    wedge = jnp.floor(u1 * sides)
    fu = u1 * sides - wedge
    a0 = (wedge / sides) * 2.0 * jnp.pi + rotation
    a1 = ((wedge + 1.0) / sides) * 2.0 * jnp.pi + rotation
    p0 = jnp.stack([jnp.cos(a0), jnp.sin(a0)], axis=-1)
    p1 = jnp.stack([jnp.cos(a1), jnp.sin(a1)], axis=-1)
    b0, b1 = vec.sample_triangle_uniform(fu, u2)
    p = p0 * (1.0 - b0 - b1)[..., None] + p1 * b1[..., None]
    # remaining weight at center (0,0) contributes nothing
    return p[..., 0], p[..., 1]


def shoot_rays(cam: Camera, px: Array, py: Array, lens_u: Array, lens_v: Array
               ) -> Tuple[Array, Array, Array]:
    """Batched Camera::shootRay. Returns (origin[N,3], dir[N,3], valid[N])."""
    resx = jnp.float32(cam.resx)
    resy = jnp.float32(cam.resy)
    # normalized screen coords: x in [-0.5, 0.5), y in [-0.5, 0.5) * aspect
    sx = px / resx - 0.5
    sy = (py / resy - 0.5) * cam.aspect
    kind = cam.kind

    if kind in ("perspective", "architect"):
        if kind == "architect":
            # vertical-line-preserving (two-point) perspective: the image's
            # vertical axis is the WORLD up axis, not the tilted camera up
            # (camera_architect.cc setAxis: vup_ = aspect * (0,0,-1)) —
            # verticals in the scene stay parallel in the image
            v_axis = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0],
                                                  jnp.float32), (3,))
        else:
            v_axis = cam.cam_y
        d = (cam.cam_z * cam.focal + cam.cam_x * sx[..., None]
             - v_axis * sy[..., None])
        d = vec.normalize(d)
        o = jnp.broadcast_to(cam.origin, d.shape)
        has_dof = cam.bokeh_kind is not None
        # DOF: jitter origin on aperture, refocus at dof_distance
        lu, lv = _sample_bokeh(cam.bokeh_kind, lens_u, lens_v, cam.bokeh_rotation)
        focus_t = cam.dof_distance / jnp.maximum(vec.dot(d, cam.cam_z), 1e-6)
        focus_p = o + d * focus_t[..., None]
        offset = (cam.cam_x * lu[..., None] + cam.cam_y * lv[..., None]) * cam.aperture
        use_dof = cam.aperture > 0.0
        o2 = o + offset
        d2 = vec.normalize(focus_p - o2)
        o = jnp.where(use_dof, o2, o)
        d = jnp.where(use_dof, d2, d)
        return o, d, jnp.ones(px.shape, bool)

    if kind == "orthographic":
        o = (cam.origin + cam.cam_x * (sx * cam.ortho_scale)[..., None]
             - cam.cam_y * (sy * cam.ortho_scale)[..., None])
        d = jnp.broadcast_to(cam.cam_z, o.shape)
        return o, d, jnp.ones(px.shape, bool)

    if kind == "angular":
        # reference camera_angular.cc shootRay: u = 1 - 2px/resx (the
        # reference's angular view is x-MIRRORED relative to its other
        # cameras), v row-flipped like the rest of its pipeline; radius
        # -> polar angle via the projection's focal length
        # (camera_angular.cc:38-42), azimuth = atan2(v, u). Pinned by the
        # reference-render parity comparison (r5).
        r = jnp.sqrt(sx * sx + sy * sy) * 2.0
        phi = jnp.arctan2(-sy, sx if cam.mirrored else -sx)
        proj = cam.angular_projection
        if proj == "orthographic":
            # focal = 1/sin(angle): theta = asin(r * sin(angle))
            theta = jnp.arcsin(jnp.clip(r * jnp.sin(cam.angle), -1.0, 1.0))
        elif proj == "stereographic":
            theta = 2.0 * jnp.arctan(r * jnp.tan(cam.angle * 0.5))
        elif proj == "equisolid_angle":
            theta = 2.0 * jnp.arcsin(jnp.clip(r * jnp.sin(cam.angle * 0.5), -1.0, 1.0))
        elif proj == "rectilinear":
            theta = jnp.arctan(r * jnp.tan(cam.angle))
        else:  # equidistant
            theta = r * cam.angle
        st = jnp.sin(theta)
        d = (cam.cam_z * jnp.cos(theta)[..., None]
             + cam.cam_x * (st * jnp.cos(phi))[..., None]
             + cam.cam_y * (st * jnp.sin(phi))[..., None])
        valid = (r <= cam.max_radius) if cam.circular \
            else jnp.ones(px.shape, bool)
        o = jnp.broadcast_to(cam.origin, d.shape)
        return o, vec.normalize(d), valid

    if kind == "equirectangular":
        # reference camera_equirectangular.cc shootRay: u = 2px/resx - 1,
        # v = 2py/resy - 1; phi = pi*u, theta = pi/2*v;
        # dir = cos(theta)*(cos(phi)*cam_z + sin(phi)*cam_x)
        #       + sin(theta)*cam_y.
        # (The pre-r5 version had theta offset by pi/2 — the up pole sat
        # on the MIDDLE row — and phi mirrored; found by the reference-
        # render parity comparison, fixed to match exactly.) Note the
        # reference pipeline feeds shootRay row-flipped py (its
        # perspective camera tilts UP with py yet renders row 0 at the
        # top, matching ours) — so theta is negated here: row 0 = up pole.
        phi = 2.0 * jnp.pi * sx
        theta = -jnp.pi * (sy / jnp.maximum(cam.aspect, 1e-6))
        ct = jnp.cos(theta)
        d = (cam.cam_z * (ct * jnp.cos(phi))[..., None]
             + cam.cam_x * (ct * jnp.sin(phi))[..., None]
             + cam.cam_y * jnp.sin(theta)[..., None])
        o = jnp.broadcast_to(cam.origin, d.shape)
        return o, vec.normalize(d), jnp.ones(px.shape, bool)

    raise KeyError(f"camera kind {kind!r}")


def raster_jacobian(cam: Camera, d: Array) -> Array:
    """|d(raster px,py) / d omega| for a unit direction `d` leaving the
    camera — the measurement importance of light-tracing splats (BDPT
    t=0 strategies, reference connectPathE). Derivation: the image plane
    sits at distance `focal` with extent 1 x aspect in screen units and
    resx x resy in raster units, so d(px,py)/dw = resx*resy*focal^2 /
    (aspect * cos^3 theta)."""
    if cam.kind != "perspective":
        raise NotImplementedError(
            f"raster_jacobian for camera kind {cam.kind!r}")
    cosc = jnp.maximum(vec.dot(d, cam.cam_z), 1e-6)
    return (jnp.float32(cam.resx * cam.resy) * cam.focal * cam.focal
            / (jnp.maximum(cam.aspect, 1e-6) * cosc * cosc * cosc))


def project_lens(cam: Camera, p: Array, lens_u: Array, lens_v: Array):
    """Raster position of world point `p` as seen through a SAMPLED thin-
    lens point — light-tracing splats (BDPT t=0, reference connectPathE)
    for DOF cameras, lifting the pinhole restriction
    (integrator_bidirectional.h:57-58 has none).

    The lens point L = origin + aperture * bokeh(lens_u, lens_v) lies in
    the cam_x/cam_y plane; the ray L->p refocuses through the focal plane
    at dof_distance (the inverse of shoot_rays' DOF model: all lens rays
    through a pixel meet at its focus_p), so the raster position is the
    pinhole projection of F = L + (p-L) * dof_distance/z. With
    aperture == 0 this degenerates exactly to project(). The splat
    estimator keeps the pinhole formula (beta * cos_y/d^2 * jac) with L
    in place of the origin: the uniform-lens pdf 1/A_lens cancels against
    the lens-area factor of the thin-lens importance W_e, exactly as in
    Veach-style thin-lens BDPT.

    Returns (px, py, visible, L)."""
    bu, bv = _sample_bokeh(cam.bokeh_kind, lens_u, lens_v,
                           cam.bokeh_rotation)
    lens = (cam.cam_x * bu[..., None]
            + cam.cam_y * bv[..., None]) * cam.aperture
    lpt = cam.origin + lens
    rel = p - lpt
    z = vec.dot(rel, cam.cam_z)
    use_dof = (cam.aperture > 0.0) & (cam.dof_distance > 0.0)
    # focal-plane point (depth exactly dof_distance along cam_z)
    f_rel = lens + rel * (cam.dof_distance
                          / jnp.maximum(z, 1e-9))[..., None]
    x = vec.dot(f_rel, cam.cam_x) / jnp.maximum(cam.dof_distance, 1e-9) \
        * cam.focal
    y = -vec.dot(f_rel, cam.cam_y) / jnp.maximum(cam.dof_distance, 1e-9) \
        * cam.focal
    pxl = (x + 0.5) * cam.resx
    pyl = (y / cam.aspect + 0.5) * cam.resy
    px0, py0, vis0 = project(cam, p)
    px = jnp.where(use_dof, pxl, px0)
    py = jnp.where(use_dof, pyl, py0)
    visl = (z > 0) & (pxl >= 0) & (pxl < cam.resx) \
        & (pyl >= 0) & (pyl < cam.resy)
    vis = jnp.where(use_dof, visl, vis0)
    lpt = jnp.where(use_dof, lpt, jnp.broadcast_to(cam.origin, lpt.shape))
    return px, py, vis, lpt


def project(cam: Camera, p: Array):
    """World point -> (px, py, visible) — reference Camera::screenproject,
    needed by bidirectional/light-tracing connections."""
    rel = p - cam.origin
    z = vec.dot(rel, cam.cam_z)
    if cam.kind == "perspective":
        x = vec.dot(rel, cam.cam_x) / jnp.maximum(z, 1e-9) * cam.focal
        y = -vec.dot(rel, cam.cam_y) / jnp.maximum(z, 1e-9) * cam.focal
        px = (x + 0.5) * cam.resx
        py = (y / cam.aspect + 0.5) * cam.resy
        vis = (z > 0) & (px >= 0) & (px < cam.resx) & (py >= 0) & (py < cam.resy)
        return px, py, vis
    if cam.kind == "architect":
        # invert dir = s*(cam_z*focal + cam_x*X - ez*Y): solve the 3x3
        # system (the vertical image axis is world Z, generally NOT
        # orthogonal to cam_x/cam_z)
        ez = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
        m = jnp.stack([cam.cam_x, -ez, cam.cam_z * cam.focal],
                      axis=-1)                      # [3,3] columns
        coef = jnp.matmul(rel, jnp.linalg.inv(m).T,   # [N,3] = (a, b, c)
                          precision=jax.lax.Precision.HIGHEST)
        c_ = coef[..., 2]
        x = coef[..., 0] / jnp.where(jnp.abs(c_) > 1e-9, c_, 1e-9)
        y = coef[..., 1] / jnp.where(jnp.abs(c_) > 1e-9, c_, 1e-9)
        px = (x + 0.5) * cam.resx
        py = (y / cam.aspect + 0.5) * cam.resy
        vis = (c_ > 0) & (px >= 0) & (px < cam.resx) \
            & (py >= 0) & (py < cam.resy)
        return px, py, vis
    if cam.kind == "orthographic":
        x = vec.dot(rel, cam.cam_x) / cam.ortho_scale
        y = -vec.dot(rel, cam.cam_y) / cam.ortho_scale
        px = (x + 0.5) * cam.resx
        py = (y / cam.aspect + 0.5) * cam.resy
        vis = (z > 0) & (px >= 0) & (px < cam.resx) & (py >= 0) & (py < cam.resy)
        return px, py, vis
    raise NotImplementedError(f"project for camera kind {cam.kind!r}")
