"""Procedural noise generators, batched and differentiable-ish.

Replaces src/texture/noise_generator.cc (Blender-compatible newperlin /
stdperlin / voronoi F1-F4 / cellnoise and the fBm / turbulence combinators).
Hash-based lattice noise instead of permutation tables: a counter-based
integer hash (pcg-style) replaces the table gathers, which keeps the VPU
busy with ALU work instead of random memory access.

All functions take p[..., 3] and return scalars in roughly [0, 1] matching
the reference generators' ranges (the reference normalizes its noise to
[0, 1], noise_generator.cc `newPerlin` output bias/scale).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def _hash3(ix: Array, iy: Array, iz: Array, seed: int = 0) -> Array:
    """Integer lattice hash -> uint32 (replaces the perm-table gather)."""
    h = (ix.astype(jnp.uint32) * jnp.uint32(0x8DA6B343)
         + iy.astype(jnp.uint32) * jnp.uint32(0xD8163841)
         + iz.astype(jnp.uint32) * jnp.uint32(0xCB1AB31F)
         + jnp.uint32((seed * 0x9E3779B9) & 0xFFFFFFFF))
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 16)
    return h


def _hash_unit(ix, iy, iz, seed=0) -> Array:
    """Hash -> float in [0,1)."""
    return _hash3(ix, iy, iz, seed).astype(jnp.float32) * jnp.float32(
        2.3283064365386963e-10)


def _grad_dot(h: Array, fx: Array, fy: Array, fz: Array) -> Array:
    """Gradient dot product from hash low bits (improved-Perlin grad set)."""
    h = (h & jnp.uint32(15)).astype(jnp.int32)
    u = jnp.where(h < 8, fx, fy)
    v = jnp.where(h < 4, fy, jnp.where((h == 12) | (h == 14), fx, fz))
    return (jnp.where(h & 1, -u, u) + jnp.where(h & 2, -v, v))


def _fade(t: Array) -> Array:
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin(p: Array, seed: int = 0) -> Array:
    """Improved Perlin noise ('newperlin'), output in [0, 1]."""
    pf = jnp.floor(p)
    ix = pf[..., 0].astype(jnp.int32)
    iy = pf[..., 1].astype(jnp.int32)
    iz = pf[..., 2].astype(jnp.int32)
    fx = p[..., 0] - pf[..., 0]
    fy = p[..., 1] - pf[..., 1]
    fz = p[..., 2] - pf[..., 2]
    u = _fade(fx)
    v = _fade(fy)
    w = _fade(fz)

    def corner(dx, dy, dz):
        h = _hash3(ix + dx, iy + dy, iz + dz, seed)
        return _grad_dot(h, fx - dx, fy - dy, fz - dz)

    c000 = corner(0, 0, 0)
    c100 = corner(1, 0, 0)
    c010 = corner(0, 1, 0)
    c110 = corner(1, 1, 0)
    c001 = corner(0, 0, 1)
    c101 = corner(1, 0, 1)
    c011 = corner(0, 1, 1)
    c111 = corner(1, 1, 1)
    x00 = c000 + u * (c100 - c000)
    x10 = c010 + u * (c110 - c010)
    x01 = c001 + u * (c101 - c001)
    x11 = c011 + u * (c111 - c011)
    y0 = x00 + v * (x10 - x00)
    y1 = x01 + v * (x11 - x01)
    n = y0 + w * (y1 - y0)
    return jnp.clip(0.5 + 0.5 * n, 0.0, 1.0)


def cellnoise(p: Array, seed: int = 0) -> Array:
    """Constant-per-cell hash noise (reference cellNoise)."""
    pf = jnp.floor(p)
    return _hash_unit(pf[..., 0].astype(jnp.int32),
                      pf[..., 1].astype(jnp.int32),
                      pf[..., 2].astype(jnp.int32), seed)


def value_noise(p: Array, seed: int = 0) -> Array:
    """Trilinearly-interpolated lattice value noise ('stdperlin' stand-in)."""
    pf = jnp.floor(p)
    ix = pf[..., 0].astype(jnp.int32)
    iy = pf[..., 1].astype(jnp.int32)
    iz = pf[..., 2].astype(jnp.int32)
    fx = _fade(p[..., 0] - pf[..., 0])
    fy = _fade(p[..., 1] - pf[..., 1])
    fz = _fade(p[..., 2] - pf[..., 2])

    def c(dx, dy, dz):
        return _hash_unit(ix + dx, iy + dy, iz + dz, seed)

    x00 = c(0, 0, 0) + fx * (c(1, 0, 0) - c(0, 0, 0))
    x10 = c(0, 1, 0) + fx * (c(1, 1, 0) - c(0, 1, 0))
    x01 = c(0, 0, 1) + fx * (c(1, 0, 1) - c(0, 0, 1))
    x11 = c(0, 1, 1) + fx * (c(1, 1, 1) - c(0, 1, 1))
    y0 = x00 + fy * (x10 - x00)
    y1 = x01 + fy * (x11 - x01)
    return y0 + fz * (y1 - y0)


NOISE_NEWPERLIN = 0
NOISE_STDPERLIN = 1
NOISE_CELL = 2
NOISE_VORONOI_F1 = 3
NOISE_VORONOI_F2 = 4
NOISE_VORONOI_F3 = 5
NOISE_VORONOI_F4 = 6
NOISE_VORONOI_F2F1 = 7
NOISE_VORONOI_CRACKLE = 8

_NOISE_BY_NAME = {
    "newperlin": NOISE_NEWPERLIN, "improved_perlin": NOISE_NEWPERLIN,
    "stdperlin": NOISE_STDPERLIN, "original_perlin": NOISE_STDPERLIN,
    "blender": NOISE_STDPERLIN, "blender_original": NOISE_STDPERLIN,
    "cellnoise": NOISE_CELL, "cell_noise": NOISE_CELL,
    "voronoi_f1": NOISE_VORONOI_F1, "voronoi_f2": NOISE_VORONOI_F2,
    "voronoi_f3": NOISE_VORONOI_F3, "voronoi_f4": NOISE_VORONOI_F4,
    "voronoi_f2f1": NOISE_VORONOI_F2F1, "voronoi_crackle": NOISE_VORONOI_CRACKLE,
}


def noise_type_id(name: str) -> int:
    return _NOISE_BY_NAME.get(name, NOISE_NEWPERLIN)


def voronoi_f(p: Array, seed: int = 0):
    """First four distances to hashed feature points in the 3x3x3 cell
    neighborhood (reference voronoi, noise_generator.cc). Returns
    (f1, f2, f3, f4), euclidean distances."""
    pf = jnp.floor(p)
    ix = pf[..., 0].astype(jnp.int32)
    iy = pf[..., 1].astype(jnp.int32)
    iz = pf[..., 2].astype(jnp.int32)
    f1 = jnp.full(p.shape[:-1], 1e10, jnp.float32)
    f2 = jnp.full_like(f1, 1e10)
    f3 = jnp.full_like(f1, 1e10)
    f4 = jnp.full_like(f1, 1e10)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cx = ix + dx
                cy = iy + dy
                cz = iz + dz
                fx = cx.astype(jnp.float32) + _hash_unit(cx, cy, cz, seed)
                fy = cy.astype(jnp.float32) + _hash_unit(cx, cy, cz, seed + 1)
                fz = cz.astype(jnp.float32) + _hash_unit(cx, cy, cz, seed + 2)
                d = jnp.sqrt((p[..., 0] - fx) ** 2 + (p[..., 1] - fy) ** 2
                             + (p[..., 2] - fz) ** 2)
                lt1 = d < f1
                lt2 = d < f2
                lt3 = d < f3
                lt4 = d < f4
                f4 = jnp.where(lt4, jnp.where(lt3, f3, d), f4)
                f3 = jnp.where(lt3, jnp.where(lt2, f2, d), f3)
                f2 = jnp.where(lt2, jnp.where(lt1, f1, d), f2)
                f1 = jnp.where(lt1, d, f1)
    return f1, f2, f3, f4


def basis_noise(kind: Array, p: Array, seed: int = 0) -> Array:
    """Masked dispatch over the noise basis (for per-lane dynamic kind)."""
    n_perlin = perlin(p, seed)
    n_std = value_noise(p, seed)
    n_cell = cellnoise(p, seed)
    f1, f2, f3, f4 = voronoi_f(p, seed)
    out = n_perlin
    out = jnp.where(kind == NOISE_STDPERLIN, n_std, out)
    out = jnp.where(kind == NOISE_CELL, n_cell, out)
    out = jnp.where(kind == NOISE_VORONOI_F1, jnp.clip(f1, 0, 1), out)
    out = jnp.where(kind == NOISE_VORONOI_F2, jnp.clip(f2, 0, 1), out)
    out = jnp.where(kind == NOISE_VORONOI_F3, jnp.clip(f3, 0, 1), out)
    out = jnp.where(kind == NOISE_VORONOI_F4, jnp.clip(f4, 0, 1), out)
    out = jnp.where(kind == NOISE_VORONOI_F2F1, jnp.clip(f2 - f1, 0, 1), out)
    crackle = jnp.clip(1.0 - 0.5 * (f2 - f1), 0.0, 1.0)
    out = jnp.where(kind == NOISE_VORONOI_CRACKLE, crackle, out)
    return out


def static_basis_noise(kind: int, p: Array, seed: int = 0) -> Array:
    """Static-kind basis noise: traces only the selected generator."""
    if kind == NOISE_STDPERLIN:
        return value_noise(p, seed)
    if kind == NOISE_CELL:
        return cellnoise(p, seed)
    if kind in (NOISE_VORONOI_F1, NOISE_VORONOI_F2, NOISE_VORONOI_F3,
                NOISE_VORONOI_F4, NOISE_VORONOI_F2F1, NOISE_VORONOI_CRACKLE):
        f1, f2, f3, f4 = voronoi_f(p, seed)
        if kind == NOISE_VORONOI_F1:
            return jnp.clip(f1, 0, 1)
        if kind == NOISE_VORONOI_F2:
            return jnp.clip(f2, 0, 1)
        if kind == NOISE_VORONOI_F3:
            return jnp.clip(f3, 0, 1)
        if kind == NOISE_VORONOI_F4:
            return jnp.clip(f4, 0, 1)
        if kind == NOISE_VORONOI_F2F1:
            return jnp.clip(f2 - f1, 0, 1)
        return jnp.clip(1.0 - 0.5 * (f2 - f1), 0.0, 1.0)
    return perlin(p, seed)


def turbulence(p: Array, oct_: int, size: Array, hard: bool,
               kind: int = NOISE_NEWPERLIN, seed: int = 0) -> Array:
    """fBm turbulence (reference AbsNoiseT/turbulence): sum of |noise| or
    noise over `oct_` octaves. `oct_` must be static (python int)."""
    amp = 1.0
    freq = 1.0 / jnp.maximum(size, 1e-9)
    total = jnp.zeros(p.shape[:-1], jnp.float32)
    norm = 0.0
    for o in range(max(int(oct_), 1)):
        n = static_basis_noise(kind, p * freq, seed + o)
        n = n * 2.0 - 1.0
        if hard:
            n = jnp.abs(n)
        else:
            n = 0.5 + 0.5 * n
        total = total + amp * n
        norm += amp
        amp *= 0.5
        freq = freq * 2.0
    return total / norm
