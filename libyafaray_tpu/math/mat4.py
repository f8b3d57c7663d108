"""4x4 affine transforms (batched), replacing reference `Matrix4`
(src/geometry/matrix4.cc). Used for instances, cameras, and texture mappings.

The products are elementwise multiply-sums, not dots: an f32 dot may run
in TF32 on a GPU (about three decimal digits), and a transformed point
feeds ray hit distances, which need full f32.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

IDENTITY = np.eye(4, dtype=np.float32)


def transform_point(m: Array, p: Array) -> Array:
    """Apply affine matrix m [...,4,4] to points p [...,3]."""
    return jnp.sum(m[..., :3, :3] * p[..., None, :], axis=-1) + m[..., :3, 3]


def transform_vector(m: Array, v: Array) -> Array:
    return jnp.sum(m[..., :3, :3] * v[..., None, :], axis=-1)


def transform_normal(m_inv: Array, n: Array) -> Array:
    """Normals transform by the inverse-transpose of the linear part."""
    return jnp.sum(m_inv[..., :3, :3] * n[..., :, None], axis=-2)


def inverse(m: Array) -> Array:
    return jnp.linalg.inv(m)


def translate(t) -> Array:
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(jnp.asarray(t, jnp.float32))


def scale(s) -> Array:
    s = jnp.broadcast_to(jnp.asarray(s, jnp.float32), (3,))
    return jnp.diag(jnp.concatenate([s, jnp.ones((1,), jnp.float32)]))


def rotate_x(a: float) -> Array:
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], jnp.float32
    )


def rotate_y(a: float) -> Array:
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array(
        [[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], jnp.float32
    )


def rotate_z(a: float) -> Array:
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array(
        [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], jnp.float32
    )
