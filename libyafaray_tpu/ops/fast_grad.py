"""Gathers from small f32 tables with a matmul BACKWARD pass.

The VJP XLA derives for a gather is a scatter-add. When a whole wavefront
of lanes gathers from a table of a few rows — the material table, where
every lane reads one of 3-5 materials in the benchmark scenes — that
scatter-add is a pile of atomic adds onto the same few addresses. Expressing the same
reduction as grad[t, c] = sum_n (idx == t) * g[n, c], a chunked one-hot
`dot_general`, avoids the contention. Measured on an H100 (700 W):
the Cornell 1080p fwd+bwd chunk step takes 9.1 ms with this backward
for the material columns and 10.6 ms with the plain scatter-add VJP.

The one-hot cost grows with N * rows, so larger tables keep the plain
gather: on the caustic 512x512 fwd+bwd step, whose texel pool has
1,366 rows, the one-hot backward took 204 ms against 112 ms for the
plain VJP. MATMUL_GRAD_ROWS sits between those two measured table
sizes; it is not a measured crossover.

The dot asks for Precision.HIGHEST: at default precision an f32 dot may
run in TF32 on a GPU, which would round every gradient to ~3 decimal
digits. With it the sums are plain f32 sums (in another order than the
scatter-add's).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

Array = jax.Array

# tables up to this many rows get the matmul backward; larger ones keep
# the standard gather/scatter (see the module docstring)
MATMUL_GRAD_ROWS = 128
_GRAD_CHUNK = 16384


@functools.lru_cache(maxsize=None)
def _take_for(rows: int):
    """`rows` is baked per cached instance because custom_vjp residuals
    must be JAX types (a dtype/shape tuple is not)."""

    @jax.custom_vjp
    def take_(arr, flat_idx):
        return arr[flat_idx]

    def fwd(arr, flat_idx):
        return arr[flat_idx], flat_idx

    def bwd(flat_idx, g):
        n = flat_idx.shape[0]
        npad = -(-n // _GRAD_CHUNK) * _GRAD_CHUNK
        if npad != n:
            # padding lanes index row `rows`: outside arange -> no hit
            flat_idx = jnp.concatenate(
                [flat_idx, jnp.full((npad - n,), rows, flat_idx.dtype)])
            g = jnp.concatenate(
                [g, jnp.zeros((npad - n,) + g.shape[1:], g.dtype)])
        idx = flat_idx.reshape(-1, _GRAD_CHUNK)
        gp = g.reshape(idx.shape[0], _GRAD_CHUNK, *g.shape[1:])

        def chunk(acc, args):
            ic, gc = args
            onehot = (ic[:, None] == jnp.arange(rows)[None, :]
                      ).astype(jnp.float32)
            return acc + jax.lax.dot_general(
                onehot, gc.astype(jnp.float32), (((0,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32), None

        zero = jnp.zeros((rows,) + g.shape[1:], jnp.float32)
        grad, _ = jax.lax.scan(chunk, zero, (idx, gp))
        return grad, None

    take_.defvjp(fwd, bwd)
    return take_


def take(arr: Array, idx: Array) -> Array:
    """arr[idx] with the fast-gradient backward when eligible (f32 table,
    <= MATMUL_GRAD_ROWS rows, 1-D index); plain gather otherwise."""
    if (arr.dtype == jnp.float32 and idx.ndim == 1
            and arr.shape[0] <= MATMUL_GRAD_ROWS):
        return _take_for(arr.shape[0])(arr, idx)
    return arr[idx]
