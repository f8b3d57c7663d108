"""Counter-based sampling for wavefront rendering.

Wavefront replacement for the reference's stateful samplers:
  - Marsaglia multiply-with-carry RNG (include/math/random.h:56-66)
  - incremental Halton (include/sampler/halton.h:30-67)
  - van-der-Corput / Sobol riS / Larcher-Pillichshammer riLp with FNV hash
    scrambling (include/sampler/sample.h:103-151)

Everything here is a pure function of integer counters (pixel id, sample
index, bounce depth, dimension), so any lane of any shard on any host can
compute its sample without communication or carried state. Per-host stream
decorrelation follows the reference's `adv_base_sampling_offset` scheme
(include/render/imagefilm.h:131-136): each host folds a disjoint base offset
into the sample counter.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

_PRIMES = np.array(
    [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
     71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113], dtype=jnp.uint32
)

_INV_U32 = np.float32(2.3283064365386963e-10)  # 1 / 2^32


def pcg4d(v: Array) -> Array:
    """PCG4D hash (Jarzynski & Olano, JCGT 2020): uint32[...,4] -> uint32[...,4].

    Public-domain construction; all lanes independent white noise."""
    v = v.astype(jnp.uint32)
    v = v * jnp.uint32(1664525) + jnp.uint32(1013904223)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return jnp.stack([x, y, z, w], axis=-1)


def _u32_to_unit_float(u: Array) -> Array:
    """uint32 -> float32 in [0, 1)."""
    return jnp.minimum(u.astype(jnp.float32) * _INV_U32, 0.99999994)


def rand4(pixel_id: Array, sample_idx: Array, depth, dim) -> Array:
    """Four independent uniforms in [0,1) keyed on (pixel, sample, depth, dim)."""
    shape = jnp.broadcast_shapes(jnp.shape(pixel_id), jnp.shape(sample_idx))
    key = jnp.stack(
        [
            jnp.broadcast_to(jnp.asarray(pixel_id, jnp.uint32), shape),
            jnp.broadcast_to(jnp.asarray(sample_idx, jnp.uint32), shape),
            jnp.broadcast_to(jnp.asarray(depth, jnp.uint32), shape),
            jnp.broadcast_to(jnp.asarray(dim, jnp.uint32), shape),
        ],
        axis=-1,
    )
    return _u32_to_unit_float(pcg4d(key))


def rand2(pixel_id, sample_idx, depth, dim):
    r = rand4(pixel_id, sample_idx, depth, dim)
    return r[..., 0], r[..., 1]


def rand1(pixel_id, sample_idx, depth, dim):
    return rand4(pixel_id, sample_idx, depth, dim)[..., 0]


# ---------------------------------------------------------------------------
# Low-discrepancy sequences (bitwise, fully vectorized)
# ---------------------------------------------------------------------------

def _reverse_bits32(x: Array) -> Array:
    x = x.astype(jnp.uint32)
    x = ((x >> 16) | (x << 16))
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x & jnp.uint32(0xFF00FF00)) >> 8)
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x & jnp.uint32(0xF0F0F0F0)) >> 4)
    x = ((x & jnp.uint32(0x33333333)) << 2) | ((x & jnp.uint32(0xCCCCCCCC)) >> 2)
    x = ((x & jnp.uint32(0x55555555)) << 1) | ((x & jnp.uint32(0xAAAAAAAA)) >> 1)
    return x


def van_der_corput(n: Array, scramble: Array = np.uint32(0)) -> Array:
    """Base-2 radical inverse with XOR scramble (reference sample.h `riVdC`)."""
    return _u32_to_unit_float(_reverse_bits32(n) ^ jnp.asarray(scramble, jnp.uint32))


def larcher_pillichshammer(n: Array, scramble: Array = np.uint32(0)) -> Array:
    """Larcher-Pillichshammer (0,1)-sequence second component
    (reference sample.h `riLp`), vectorized over the 32 bits."""
    scramble = jnp.asarray(scramble, jnp.uint32)
    shape = jnp.broadcast_shapes(jnp.shape(n), jnp.shape(scramble))
    n = jnp.broadcast_to(_reverse_bits32(jnp.asarray(n, jnp.uint32)), shape)
    r = jnp.broadcast_to(scramble, shape)
    # unrolled static 32-iteration loop: v starts at 1<<31, n shifts left
    v = jnp.uint32(1 << 31)
    for _ in range(32):
        r = jnp.where((n & jnp.uint32(1 << 31)).astype(jnp.bool_), r ^ v, r)
        v = v ^ (v >> 1)
        n = n << 1
    return _u32_to_unit_float(r)


def _owen_hash(x: Array, seed: Array) -> Array:
    """Laine-Karras style hash for Owen-ish scrambling in reversed-bit space."""
    x = x.astype(jnp.uint32)
    seed = jnp.asarray(seed, jnp.uint32)
    x = x + seed
    x = x ^ (x * jnp.uint32(0x6C50B47C))
    x = x ^ (x * jnp.uint32(0xB82F1E52))
    x = x ^ (x * jnp.uint32(0xC7AFE638))
    x = x ^ (x * jnp.uint32(0x8D22F6E6))
    return x


def ld02(sample_idx: Array, scramble_key: Array):
    """Scrambled (0,2)-sequence pair — replaces the reference's Halton(2,3)
    pixel jitter (integrator_tiled.cc:326-335). Owen-scrambled in reversed-bit
    space so power-of-two strata are preserved per pixel, decorrelated across
    pixels via `scramble_key`."""
    n = jnp.asarray(sample_idx, jnp.uint32)
    k = jnp.asarray(scramble_key, jnp.uint32)
    # Burley-2020 formulation: the Laine-Karras permutation operates in
    # bit-reversed space; for the VdC dimension reverse_bits(value) == index,
    # so hash the raw index then bit-reverse into a value.
    u0 = _u32_to_unit_float(_reverse_bits32(_owen_hash(n, k)))
    u1 = larcher_pillichshammer(n, pcg4d(jnp.stack(
        [k, k ^ jnp.uint32(0x9E3779B9), jnp.zeros_like(k), jnp.ones_like(k)],
        axis=-1))[..., 0])
    return u0, u1


def halton(n: Array, base_index) -> Array:
    """Radical inverse in the `base_index`-th prime base (static index).

    Matches reference Halton semantics (include/sampler/halton.h) for lens /
    low-dim sampling; fixed 13-digit unroll covers n < base^13."""
    base = _PRIMES[base_index].astype(jnp.float32)
    inv_base = 1.0 / base
    n = jnp.asarray(n, jnp.uint32).astype(jnp.float32)
    result = jnp.zeros_like(n)
    f = inv_base
    for _ in range(13):
        digit = jnp.floor(n * inv_base)
        result = result + f * (n - digit * base)
        n = digit
        f = f * inv_base
    return jnp.minimum(result, 0.99999994)


def host_sample_offset(host_id, samples_per_host: int = 100_000):
    """Disjoint per-host sample-counter base, mirroring the reference's
    `adv_base_sampling_offset = node_id * 100000` (src/scene/scene.cc:608-609,
    639-640) so multi-host renders draw decorrelated QMC streams."""
    return jnp.asarray(host_id, jnp.uint32) * jnp.uint32(samples_per_host)
