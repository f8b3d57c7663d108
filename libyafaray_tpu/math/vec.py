"""Vector math over trailing-3 axes.

Wavefront replacement for the reference's `Vec3/Point3` scalar classes
(reference: include/geometry/vector.h, src/geometry/vector.cc). Everything here
operates on batched arrays of shape [..., 3] so the whole wavefront of rays is
processed at once; there is no per-ray scalar code anywhere.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def dot(a: Array, b: Array, keepdims: bool = False) -> Array:
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a: Array, b: Array) -> Array:
    return jnp.cross(a, b)


def length(v: Array, keepdims: bool = False) -> Array:
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 0.0))


def length_sq(v: Array, keepdims: bool = False) -> Array:
    return dot(v, v, keepdims=keepdims)


def normalize(v: Array, eps: float = 1e-20) -> Array:
    return v * jax.lax.rsqrt(jnp.maximum(dot(v, v, keepdims=True), eps))


def reflect(d: Array, n: Array) -> Array:
    """Reflect direction `d` about normal `n` (both unit). Convention: `d`
    points *away* from the surface (i.e. wo); result also points away."""
    return 2.0 * dot(d, n, keepdims=True) * n - d


def refract(wi: Array, n: Array, eta: Array):
    """Refract `wi` (pointing away from surface, unit) through normal `n`
    with relative IOR `eta` = n_inside/n_outside seen from the wi side.

    Returns (wt, total_internal_reflection_mask). Mirrors the reference's
    Vec3::refract (src/geometry/vector.cc) but batched and branchless.
    """
    eta = jnp.asarray(eta)
    if eta.ndim == wi.ndim - 1:
        eta = eta[..., None]
    cos_i = dot(wi, n, keepdims=True)
    inv_eta = 1.0 / eta
    sin2_t = inv_eta * inv_eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 1e-12))
    wt = normalize(-wi * inv_eta + (inv_eta * cos_i - cos_t) * n)
    return wt, tir[..., 0]


def fresnel_dielectric(cos_i: Array, eta: Array) -> Array:
    """Unpolarized Fresnel reflectance for a dielectric; eta = n_t/n_i.

    Reference analogue: `Vec3::fresnel` (include/geometry/vector.h)."""
    cos_i = jnp.clip(jnp.abs(cos_i), 0.0, 1.0)
    sin2_t = jnp.maximum(0.0, 1.0 - cos_i * cos_i) / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 1e-12))
    r_par = (eta * cos_i - cos_t) / (eta * cos_i + cos_t)
    r_perp = (cos_i - eta * cos_t) / (cos_i + eta * cos_t)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return jnp.where(tir, 1.0, fr)


def schlick_fresnel(cos_i: Array, r0: Array) -> Array:
    """Schlick approximation (reference: material_utils_microfacet.h)."""
    m = jnp.clip(1.0 - jnp.abs(cos_i), 0.0, 1.0)
    m2 = m * m
    return r0 + (1.0 - r0) * m2 * m2 * m


def orthonormal_basis(n: Array):
    """Build (u, v) such that (u, v, n) is a right-handed orthonormal frame.

    Branchless Duff et al. / Frisvad construction — replaces the reference's
    `createCS` (src/geometry/vector.cc)."""
    sign = jnp.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    u = jnp.concatenate(
        [1.0 + sign * n[..., 0:1] * n[..., 0:1] * a, sign * b, -sign * n[..., 0:1]],
        axis=-1,
    )
    v = jnp.concatenate(
        [b, sign + n[..., 1:2] * n[..., 1:2] * a, -n[..., 1:2]], axis=-1
    )
    return u, v


def to_local(v: Array, u: Array, w: Array, n: Array) -> Array:
    """World direction -> local shading frame (u, w, n) coordinates."""
    return jnp.stack([dot(v, u), dot(v, w), dot(v, n)], axis=-1)


def from_local(l: Array, u: Array, w: Array, n: Array) -> Array:
    return l[..., 0:1] * u + l[..., 1:2] * w + l[..., 2:3] * n


def spherical_dir(theta: Array, phi: Array) -> Array:
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta)], axis=-1)


def cosine_sample_hemisphere(u1: Array, u2: Array) -> Array:
    """Cosine-weighted hemisphere sample around +z (pdf = cos/pi).

    Reference analogue: sample::cosHemisphere (include/sampler/sample.h)."""
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1))
    return jnp.stack([x, y, z], axis=-1)


def uniform_sample_sphere(u1: Array, u2: Array) -> Array:
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sample_cone(u1: Array, u2: Array, cos_max: Array) -> Array:
    """Uniform direction in a cone around +z with half-angle cos >= cos_max."""
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * jnp.pi * u2
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)


def sample_triangle_uniform(u1: Array, u2: Array):
    """Uniform barycentric coordinates on a triangle (sqrt warp)."""
    su1 = jnp.sqrt(u1)
    b0 = 1.0 - su1
    b1 = u2 * su1
    return b0, b1


def sample_disk_concentric(u1: Array, u2: Array):
    """Concentric (Shirley) disk sample in [-1,1]^2 -> unit disk."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    zero = (jnp.abs(ox) < 1e-12) & (jnp.abs(oy) < 1e-12)
    use_x = jnp.abs(ox) > jnp.abs(oy)
    r = jnp.where(use_x, ox, oy)
    safe_div = jnp.where(use_x, jnp.where(ox == 0, 1.0, oy / jnp.where(ox == 0, 1.0, ox)),
                         jnp.where(oy == 0, 1.0, ox / jnp.where(oy == 0, 1.0, oy)))
    theta = jnp.where(use_x, (jnp.pi / 4.0) * safe_div,
                      (jnp.pi / 2.0) - (jnp.pi / 4.0) * safe_div)
    r = jnp.where(zero, 0.0, r)
    return r * jnp.cos(theta), r * jnp.sin(theta)


def power_heuristic(pdf_a: Array, pdf_b: Array) -> Array:
    """MIS power heuristic (beta=2) — the same weighting the reference uses at
    integrator_montecarlo.cc:227-230 / :341-344 (w = a^2 / (a^2 + b^2))."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return jnp.where(a2 + b2 > 0.0, a2 / jnp.maximum(a2 + b2, 1e-30), 0.0)
