"""Per-lane texture evaluation: masked dispatch + ramps + adjustments.

The single entry point behind `textures.sample_texture`: every lane carries
a dynamic texture id; procedural types are evaluated masked (only the types
present in the pool are traced), image lanes gather from the texel pool.
Then the Blender-style color ramp (src/color/color_ramp.cc) and the adj_*
post adjustments (texture.h applyAdjustments) are applied.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..scene_types import SceneData
from . import TEX_IMAGE
from .image import sample_image
from .procedural import eval_procedural

Array = jax.Array


def _rgb_to_hsv(c: Array):
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    mx = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    d = mx - mn
    safe = jnp.maximum(d, 1e-9)
    h = jnp.where(mx == r, ((g - b) / safe) % 6.0,
                  jnp.where(mx == g, (b - r) / safe + 2.0,
                            (r - g) / safe + 4.0)) / 6.0
    h = jnp.where(d <= 1e-9, 0.0, h)
    s = jnp.where(mx > 1e-9, d / jnp.maximum(mx, 1e-9), 0.0)
    return h, s, mx


def _hsv_to_rgb(h: Array, s: Array, v: Array):
    h6 = (h % 1.0) * 6.0
    i = jnp.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(jnp.int32) % 6
    r = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                   [v, q, p, p, t, v])
    g = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                   [t, v, v, q, p, p])
    b = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                   [p, p, t, v, v, q])
    return jnp.stack([r, g, b], -1)


def _rgb_to_hsl(c: Array):
    """Rgb::rgbToHsl analogue (color.h): lightness = (max+min)/2."""
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    mx = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    d = mx - mn
    l_ = 0.5 * (mx + mn)
    safe = jnp.maximum(d, 1e-9)
    h = jnp.where(mx == r, ((g - b) / safe) % 6.0,
                  jnp.where(mx == g, (b - r) / safe + 2.0,
                            (r - g) / safe + 4.0)) / 6.0
    h = jnp.where(d <= 1e-9, 0.0, h)
    denom = jnp.maximum(1.0 - jnp.abs(2.0 * l_ - 1.0), 1e-9)
    s = jnp.where(d <= 1e-9, 0.0, d / denom)
    return h, s, l_


def _hsl_to_rgb(h: Array, s: Array, l_: Array):
    """hslToRgb: chroma construction (exact inverse of _rgb_to_hsl)."""
    c = (1.0 - jnp.abs(2.0 * l_ - 1.0)) * s
    h6 = (h % 1.0) * 6.0
    x = c * (1.0 - jnp.abs(h6 % 2.0 - 1.0))
    i = jnp.floor(h6).astype(jnp.int32) % 6
    z = jnp.zeros_like(c)
    r = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                   [c, x, z, z, x, c])
    g = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                   [x, c, c, x, z, z])
    b = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                   [z, z, x, c, c, x])
    m = l_ - 0.5 * c
    return jnp.stack([r + m, g + m, b + m], -1)


def apply_ramp(pool, tex_id: Array, inten: Array, col: Array) -> Array:
    """Color-ramp remap of the texture intensity (color_ramp.cc:66-110,
    RGB / HSV / true-HSL interpolation, Near hue path)."""
    cnt = pool.ramp_count[tex_id]
    has = cnt > 0
    pos = pool.ramp_pos[tex_id]          # [N, RAMP_MAX]
    cols = pool.ramp_col[tex_id]         # [N, RAMP_MAX, 4]
    R = pos.shape[-1]
    x = inten
    # find segment: largest k with pos[k] <= x  (positions sorted)
    idx = jnp.sum(((pos <= x[..., None])
                   & (jnp.arange(R)[None, :] < cnt[..., None])).astype(jnp.int32),
                  axis=-1) - 1
    i0 = jnp.clip(idx, 0, R - 1)
    i1 = jnp.clip(idx + 1, 0, R - 1)
    i1 = jnp.minimum(i1, jnp.maximum(cnt - 1, 0))

    # per-ray column pick as a one-hot masked sum over the few columns
    # instead of a dynamic second-index gather
    def pick(tab, ii):
        onehot = ii[:, None] == jnp.arange(R)[None, :]
        if tab.ndim == 3:
            onehot = onehot[..., None]
        return jnp.sum(jnp.where(onehot, tab, 0), axis=1)
    p0 = pick(pos, i0)
    p1 = pick(pos, i1)
    c0 = pick(cols, i0)
    c1 = pick(cols, i1)
    t = jnp.clip((x - p0) / jnp.maximum(p1 - p0, 1e-9), 0.0, 1.0)
    t = jnp.where(i0 == i1, 0.0, t)
    lin = c0 + (c1 - c0) * t[..., None]
    # hsv interpolation mode
    h0, s0, v0 = _rgb_to_hsv(c0[..., :3])
    h1, s1, v1 = _rgb_to_hsv(c1[..., :3])
    dh = h1 - h0
    dh = jnp.where(dh > 0.5, dh - 1.0, jnp.where(dh < -0.5, dh + 1.0, dh))
    hsv_rgb = _hsv_to_rgb(h0 + dh * t, s0 + (s1 - s0) * t, v0 + (v1 - v0) * t)
    hsv = jnp.concatenate([hsv_rgb, lin[..., 3:]], -1)
    # true hsl interpolation mode (color_ramp.cc:97-110)
    g0, q0, l0 = _rgb_to_hsl(c0[..., :3])
    g1, q1, l1 = _rgb_to_hsl(c1[..., :3])
    dg = g1 - g0
    dg = jnp.where(dg > 0.5, dg - 1.0, jnp.where(dg < -0.5, dg + 1.0, dg))
    hsl_rgb = _hsl_to_rgb(g0 + dg * t, q0 + (q1 - q0) * t, l0 + (l1 - l0) * t)
    hsl = jnp.concatenate([hsl_rgb, lin[..., 3:]], -1)
    mode = pool.ramp_mode[tex_id]
    ramped = jnp.where((mode == 2)[..., None], hsl,
                       jnp.where((mode == 1)[..., None], hsv, lin))
    return jnp.where(has[..., None], ramped, col)


def apply_adjustments(pool, tex_id: Array, col: Array) -> Array:
    """adj_* multipliers: per-channel scale, intensity, contrast, saturation,
    hue shift, clamp (reference Texture::applyAdjustments)."""
    adj = pool.adj[tex_id]
    rgb = col[..., :3] * adj[..., :3] * adj[..., 3:4]
    rgb = (rgb - 0.5) * adj[..., 4:5] + 0.5
    # saturation / hue in HSV space
    needs_hsv = (adj[..., 5] != 1.0) | (adj[..., 6] != 0.0)
    h, s, v = _rgb_to_hsv(jnp.maximum(rgb, 0.0))
    rgb_hsv = _hsv_to_rgb(h + adj[..., 6], jnp.clip(s * adj[..., 5], 0, 1), v)
    rgb = jnp.where(needs_hsv[..., None], rgb_hsv, rgb)
    rgb = jnp.where((adj[..., 7] > 0)[..., None], jnp.clip(rgb, 0.0, 1.0), rgb)
    return jnp.concatenate([rgb, col[..., 3:]], -1)


def eval_textures(scene: SceneData, tex_id: Array, p: Array, uv: Array,
                  lod: Array = None, duv_dx: Array = None,
                  duv_dy: Array = None) -> Array:
    """rgba per lane for dynamic texture ids."""
    pool = scene.textures
    if pool is None or pool.num_textures == 0:
        return jnp.zeros(p.shape[:-1] + (4,), jnp.float32)
    tex_id = jnp.clip(tex_id, 0, pool.num_textures - 1)
    col, inten = eval_procedural(pool, tex_id, p, pool.used_types,
                                 pool.used_noise, pool.max_octaves)
    if TEX_IMAGE in pool.used_types:
        img = sample_image(pool, tex_id, uv, lod, duv_dx, duv_dy)
        is_img = pool.tex_type[tex_id] == TEX_IMAGE
        col = jnp.where(is_img[..., None], img, col)
        inten = jnp.where(is_img, img[..., :3].mean(-1), inten)
    col = apply_ramp(pool, tex_id, inten, col)
    col = apply_adjustments(pool, tex_id, col)
    return col
