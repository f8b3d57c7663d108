"""Image texture sampling from the flat texel pool.

Replaces src/texture/texture_image.cc (597 LoC): nearest / bilinear /
bicubic (Catmull-Rom) / trilinear-mipmap sampling with repeat / extend /
clip / checker wrap modes, crop windows and mirror tiling. EWA anisotropic
(the reference's quality knob `mipmap_ewa`, texture_image.h:75-100) is
implemented as an 8-tap Gaussian quadrature of trilinear probes placed
along the exact ellipse major axis (see _sample_ewa below) — the same
ellipse as the reference's per-texel enumeration (texture_image.cc:345-443)
integrated with fixed quadrature instead of texel loops, which keeps the
wavefront access pattern regular (bulk gathers).

All gathers are bulk row gathers from the pool (one dynamic-gather per
tap for the whole wavefront).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..scene_types import TexturePool
from ..ops.fast_grad import take as fast_take

Array = jax.Array


def _wrap(coord: Array, n: Array, extend: Array, mirror: Array):
    """Apply wrap mode to integer texel coords. Returns (wrapped, inside)."""
    ns = jnp.maximum(n, 1)
    # repeat (mode 0) with optional mirroring
    period = coord % (2 * ns)
    mirrored = jnp.where(period >= ns, 2 * ns - 1 - period, period)
    rep = jnp.where(mirror > 0, mirrored, coord % ns)
    ext = jnp.clip(coord, 0, ns - 1)
    inside = (coord >= 0) & (coord < ns)
    out = jnp.where(extend == 0, rep, ext)
    # clip (2): outside -> transparent black, handled by `inside`
    # checker (3): like repeat; the tile parity is applied by the caller
    out = jnp.where(extend == 3, coord % ns, out)
    return out, inside


def _fetch(pool: TexturePool, base: Array, w: Array, h: Array,
           xi: Array, yi: Array, extend: Array, mx: Array, my: Array):
    xw, in_x = _wrap(xi, w, extend, mx)
    yw, in_y = _wrap(yi, h, extend, my)
    inside = in_x & in_y
    flat = base + yw * w + xw
    # texel pools above fast_grad.MATMUL_GRAD_ROWS rows keep the plain
    # gather and its scatter-add VJP (ops/fast_grad.py)
    texel = fast_take(pool.texel_pool, flat)
    if texel.dtype == jnp.uint8:
        # compressed pool: dequantize (scale applied by the caller per-tex)
        texel = texel.astype(jnp.float32) * (1.0 / 255.0)
    elif texel.dtype != jnp.float32:
        texel = texel.astype(jnp.float32)   # optimized (f16) pool
    clip = extend == 2
    return jnp.where((clip & ~inside)[..., None], 0.0, texel)


def _sample_level(pool: TexturePool, tex_id: Array, u: Array, v: Array,
                  base: Array, w: Array, h: Array, interp: Array):
    """Sample one mip level at (u, v) in [0,1) with nearest/bilinear/bicubic."""
    pf = pool.params_f[tex_id]
    extend = pool.extend[tex_id]
    mx = pf[..., 6]
    my = pf[..., 7]
    fx = u * w.astype(jnp.float32) - 0.5
    fy = v * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = fx - x0.astype(jnp.float32)
    ty = fy - y0.astype(jnp.float32)

    # nearest
    near = _fetch(pool, base, w, h, jnp.round(fx).astype(jnp.int32),
                  jnp.round(fy).astype(jnp.int32), extend, mx, my)

    # bilinear
    c00 = _fetch(pool, base, w, h, x0, y0, extend, mx, my)
    c10 = _fetch(pool, base, w, h, x0 + 1, y0, extend, mx, my)
    c01 = _fetch(pool, base, w, h, x0, y0 + 1, extend, mx, my)
    c11 = _fetch(pool, base, w, h, x0 + 1, y0 + 1, extend, mx, my)
    txe = tx[..., None]
    tye = ty[..., None]
    bil = ((c00 * (1 - txe) + c10 * txe) * (1 - tye)
           + (c01 * (1 - txe) + c11 * txe) * tye)

    out = jnp.where((interp == 0)[..., None], near, bil)

    if True:  # bicubic Catmull-Rom (interp == 2)
        def cr_w(t):
            t2 = t * t
            t3 = t2 * t
            w0 = -0.5 * t3 + t2 - 0.5 * t
            w1 = 1.5 * t3 - 2.5 * t2 + 1.0
            w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
            w3 = 0.5 * t3 - 0.5 * t2
            return w0, w1, w2, w3

        wx = cr_w(tx)
        wy = cr_w(ty)
        acc = 0.0
        for j in range(4):
            row = 0.0
            for i in range(4):
                c = _fetch(pool, base, w, h, x0 - 1 + i, y0 - 1 + j,
                           extend, mx, my)
                row = row + c * wx[i][..., None]
            acc = acc + row * wy[j][..., None]
        out = jnp.where((interp == 2)[..., None], acc, out)
    return out


def vec_norm2(x):
    return jnp.sqrt(jnp.maximum(jnp.sum(x * x, axis=-1), 1e-20))


EWA_TAPS = 8            # fixed probe count along the ellipse major axis
EWA_MAX_ANISOTROPY = 8.0  # reference default (texture_image.cc:547)


def sample_image(pool: TexturePool, tex_id: Array, uv: Array,
                 lod: Array = None, duv_dx: Array = None,
                 duv_dy: Array = None):
    """Sample image textures at uv (any real values; wrap applies).
    Returns rgba[N,4]. Mip selection: either an explicit per-lane `lod`,
    or uv-space screen derivatives (duv_dx/duv_dy) from which trilinear
    LOD and the EWA anisotropy ellipse are derived. EWA
    (interpolation "mipmap_ewa", texture_image.cc:345-443) is realised as
    EWA_TAPS Gaussian-weighted trilinear probes along the footprint's
    major axis with the mip level picked from the minor axis — the
    fixed-footprint wavefront form of the reference's variable-extent texel
    loop (identical ellipse; quadrature instead of texel enumeration)."""
    pf = pool.params_f[tex_id]
    # crop window + repeat counts (texture_image.cc mapping chain)
    xrep = jnp.maximum(pf[..., 0], 1e-9)
    yrep = jnp.maximum(pf[..., 1], 1e-9)
    u = uv[..., 0] * xrep
    v = (1.0 - uv[..., 1]) * yrep  # image rows are top-down
    cminx, cminy = pf[..., 2], pf[..., 3]
    cmaxx, cmaxy = pf[..., 4], pf[..., 5]
    has_crop = (cminx != 0.0) | (cminy != 0.0) | (cmaxx != 1.0) | (cmaxy != 1.0)
    u = jnp.where(has_crop, cminx + (u % 1.0) * (cmaxx - cminx), u)
    v = jnp.where(has_crop, cminy + (v % 1.0) * (cmaxy - cminy), v)

    interp = pool.interp[tex_id]
    base0 = pool.img_offset[tex_id]
    w0 = pool.img_width[tex_id]
    h0 = pool.img_height[tex_id]

    out = _sample_level(pool, tex_id, u % 1.0, v % 1.0, base0, w0, h0, interp)

    wants_mip = (interp == 3) | (interp == 4)
    # static gating: the trilinear/EWA machinery costs 2 / 17 extra
    # bilinear probes PER LANE (masked, so every lane pays) — trace it
    # only when some texture actually uses mipmap interpolation
    any_mip = 3 in pool.used_interps or 4 in pool.used_interps
    any_ewa = 4 in pool.used_interps

    # per-ray mip rows gathered ONCE as [N, L]; the per-ray LEVEL pick is
    # a one-hot masked sum over the few levels instead of a dynamic column
    # select
    mip_rows = pool.mip_offsets[tex_id] if any_mip else None

    def _pick(level_idx):
        onehot = (level_idx[:, None]
                  == jnp.arange(mip_rows.shape[1])[None, :])
        return jnp.sum(jnp.where(onehot, mip_rows, 0), axis=1)

    def trilinear(uq, vq, lod_c):
        l0 = jnp.floor(lod_c).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, jnp.maximum(pool.num_mips[tex_id] - 1, 0))
        fl = (lod_c - l0.astype(jnp.float32))[..., None]

        def level(li):
            base = _pick(li)
            wl = jnp.maximum(w0 >> li, 1)
            hl = jnp.maximum(h0 >> li, 1)
            return _sample_level(pool, tex_id, uq % 1.0, vq % 1.0,
                                 jnp.maximum(base, 0), wl, hl,
                                 jnp.ones_like(interp))
        return level(l0) * (1 - fl) + level(l1) * fl

    nm_f = jnp.maximum(pool.num_mips[tex_id] - 1, 0).astype(jnp.float32)
    if not any_mip:
        pass
    elif lod is None and duv_dx is not None:
        # uv derivatives were computed in texture space scaled like u,v:
        # account for crop/repeat scaling already applied to u,v above
        sx = jnp.where(has_crop, xrep * (cmaxx - cminx), xrep)
        sy = jnp.where(has_crop, yrep * (cmaxy - cminy), yrep)
        dx = duv_dx * jnp.stack([sx, sy], -1)
        dy = duv_dy * jnp.stack([sx, sy], -1)
        # texel-space lengths of the two screen axes
        tex_scale = jnp.stack([w0.astype(jnp.float32),
                               h0.astype(jnp.float32)], -1)
        lx = vec_norm2(dx * tex_scale)
        ly = vec_norm2(dy * tex_scale)
        major = jnp.maximum(lx, ly)
        minor = jnp.minimum(lx, ly)
        # clamp anisotropy (texture_image.cc:361-368)
        minor = jnp.where(minor * EWA_MAX_ANISOTROPY < major,
                          major / EWA_MAX_ANISOTROPY, minor)
        lod_tri = jnp.clip(jnp.log2(jnp.maximum(major, 1e-9)) + pf[..., 8],
                           0.0, nm_f)
        lod_ewa = jnp.clip(jnp.log2(jnp.maximum(minor, 1e-9)) + pf[..., 8],
                           0.0, nm_f)
        tri = trilinear(u, v, lod_tri)
        out = jnp.where((interp == 3)[..., None], tri, out)
        if any_ewa:
            # EWA: Gaussian-weighted probes along the major axis
            maj_uv = jnp.where((lx >= ly)[..., None], dx, dy)
            ts = jnp.linspace(-0.5, 0.5, EWA_TAPS).astype(jnp.float32)
            wts = jnp.exp(-2.0 * (ts * 2.0) ** 2)
            wts = wts / wts.sum()
            ewa = 0.0
            for k in range(EWA_TAPS):
                ewa = ewa + wts[k] * trilinear(u + ts[k] * maj_uv[..., 0],
                                               v + ts[k] * maj_uv[..., 1],
                                               lod_ewa)
            out = jnp.where((interp == 4)[..., None], ewa, out)
    elif lod is not None:
        lod_c = jnp.clip(lod + pf[..., 8], 0.0, nm_f)
        tri = trilinear(u, v, lod_c)
        out = jnp.where(wants_mip[..., None], tri, out)

    # checker mode: odd tiles off -> transparent (even/odd tile toggles)
    extend = pool.extend[tex_id]
    parity = ((jnp.floor(u).astype(jnp.int32)
               + jnp.floor(v).astype(jnp.int32)) % 2)
    checker_off = (extend == 3) & (parity == 1)
    out = jnp.where(checker_off[..., None], 0.0, out)
    if pool.texel_pool.dtype == jnp.uint8:
        # compressed pool: per-texture dequantization scale (HDR-safe)
        out = out * pool.texel_scale[tex_id][..., None]
    return out
