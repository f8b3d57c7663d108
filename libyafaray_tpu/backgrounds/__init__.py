"""Backgrounds: constant / gradient / sunsky / darksky / texture (IBL).

Replaces src/background/* (factory src/background/background.cc:40-44). The
background kind is static per scene, so `eval_background` traces only the
active kind's math. Texture backgrounds sample the TexturePool; sunsky uses
the Preetham analytic model (background_sunsky.cc credits Preetham/Shirley/
Smits) re-derived as batched closed-form math.
"""
from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from .. import params as P
from ..math import vec
from ..scene_types import Background

Array = jax.Array


@struct.dataclass
class SunSky:
    """Preetham sky coefficients, precomputed host-side from turbidity +
    sun direction (reference background_sunsky.cc)."""
    sun_dir: Array        # f32[3] unit, toward sun
    theta_s: Array        # f32 sun zenith angle
    zenith_Y: Array       # f32
    zenith_x: Array       # f32
    zenith_y: Array       # f32
    perez_Y: Array        # f32[5]
    perez_x: Array        # f32[5]
    perez_y: Array        # f32[5]
    power: Array          # f32
    night: bool = struct.field(pytree_node=False, default=False)


def _perez(coef, cos_theta, gamma, cos_gamma):
    A, B, C, D, E = coef[0], coef[1], coef[2], coef[3], coef[4]
    ct = jnp.maximum(cos_theta, 0.01)
    return ((1.0 + A * jnp.exp(B / ct))
            * (1.0 + C * jnp.exp(D * gamma) + E * cos_gamma * cos_gamma))


def make_sunsky(pm: P.ParamMap, dark: bool = False) -> SunSky:
    sd = np.asarray(pm.get_vector("from", (0.0, 0.0, 1.0)), np.float64)
    sd = sd / max(np.linalg.norm(sd), 1e-12)
    turb = pm.get_float("turbidity", 3.0)
    theta_s = math.acos(max(min(sd[2], 1.0), -1.0))
    t2 = theta_s * theta_s
    t3 = t2 * theta_s
    T = turb
    T2 = T * T
    chi = (4.0 / 9.0 - T / 120.0) * (math.pi - 2.0 * theta_s)
    zenith_Y = (4.0453 * T - 4.9710) * math.tan(chi) - 0.2155 * T + 2.4192
    zenith_Y = max(zenith_Y * 1000.0, 1e-3)  # cd/m2 -> arbitrary linear
    zenith_x = ((0.00165 * t3 - 0.00375 * t2 + 0.00209 * theta_s) * T2
                + (-0.02903 * t3 + 0.06377 * t2 - 0.03202 * theta_s + 0.00394) * T
                + (0.11693 * t3 - 0.21196 * t2 + 0.06052 * theta_s + 0.25886))
    zenith_y = ((0.00275 * t3 - 0.00610 * t2 + 0.00317 * theta_s) * T2
                + (-0.04214 * t3 + 0.08970 * t2 - 0.04153 * theta_s + 0.00516) * T
                + (0.15346 * t3 - 0.26756 * t2 + 0.06670 * theta_s + 0.26688))
    perez_Y = [0.17872 * T - 1.46303, -0.35540 * T + 0.42749,
               -0.02266 * T + 5.32505, 0.12064 * T - 2.57705,
               -0.06696 * T + 0.37027]
    perez_x = [-0.01925 * T - 0.25922, -0.06651 * T + 0.00081,
               -0.00041 * T + 0.21247, -0.06409 * T - 0.89887,
               -0.00325 * T + 0.04517]
    perez_y = [-0.01669 * T - 0.26078, -0.09495 * T + 0.00921,
               -0.00792 * T + 0.21023, -0.04405 * T - 1.65369,
               -0.01092 * T + 0.05291]
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    return SunSky(
        sun_dir=f32(sd), theta_s=f32(theta_s),
        zenith_Y=f32(zenith_Y), zenith_x=f32(zenith_x), zenith_y=f32(zenith_y),
        perez_Y=f32(perez_Y), perez_x=f32(perez_x), perez_y=f32(perez_y),
        power=f32(pm.get_float("power", 1.0)), night=dark and theta_s > math.pi / 2,
    )


def _eval_sunsky(ss: SunSky, d: Array) -> Array:
    """Preetham sky matching the reference getSkyCol point-for-point
    (background_sunsky.cc:115-165, verified against the reference
    binary's own equirect sky render, r5): below-horizon directions are
    evaluated AT the horizon (theta clamped to pi/2, including the
    sun-angle gamma) with a smoothstep fade to black; a night fade
    applies when the sun itself is below the horizon; luminance is
    scaled by 1/15000 and the RGB is clamped to [0,1] BEFORE power."""
    z = jnp.clip(d[..., 2], -1.0, 1.0)
    theta_raw = jnp.arccos(z)
    half_pi = jnp.float32(0.5 * jnp.pi)
    below = theta_raw > half_pi
    # horizon stretch + smoothstep fade (hfade)
    hf = 1.0 - (theta_raw / jnp.pi - 0.5) * 2.0
    hfade = jnp.where(below, hf * hf * (3.0 - 2.0 * hf), 1.0)
    theta = jnp.minimum(theta_raw, half_pi)
    cos_theta = jnp.cos(theta)
    # night fade (sun below horizon) toward the zenith
    nf = (1.0 - (0.5 - theta / jnp.pi) * 2.0) \
        * (1.0 - (ss.theta_s / jnp.pi - 0.5) * 2.0)
    nfade = jnp.where(ss.theta_s > half_pi,
                      jnp.clip(nf, 0.0, 1.0) ** 2
                      * (3.0 - 2.0 * jnp.clip(nf, 0.0, 1.0)), 1.0)
    # gamma from the CLAMPED theta (angleBetween(theta, phi))
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    phi_s = jnp.arctan2(ss.sun_dir[1], ss.sun_dir[0])
    sin_ts = jnp.sin(ss.theta_s)
    cos_ts = jnp.cos(ss.theta_s)
    cos_gamma = jnp.clip(jnp.sin(theta) * sin_ts * jnp.cos(phi_s - phi)
                         + cos_theta * cos_ts, -1.0, 1.0)
    gamma = jnp.arccos(cos_gamma)

    # relative Perez values vs zenith-normalization at gamma=theta_s, theta=0
    def rel(coef):
        num = _perez(coef, cos_theta, gamma, cos_gamma)
        den = _perez(coef, jnp.ones_like(cos_theta),
                     jnp.broadcast_to(ss.theta_s, cos_theta.shape),
                     jnp.broadcast_to(cos_ts, cos_theta.shape))
        return num / jnp.maximum(den, 1e-9)

    # luminance scale 1/15000 (background_sunsky.cc:151)
    Y = (ss.zenith_Y * rel(ss.perez_Y)
         * jnp.float32(6.666666667e-5) * nfade * hfade)
    x = ss.zenith_x * rel(ss.perez_x)
    y = ss.zenith_y * rel(ss.perez_y)
    # xyY -> XYZ -> linear RGB
    y_safe = jnp.maximum(y, 1e-6)
    X = x / y_safe * Y
    Z = (1.0 - x - y) / y_safe * Y
    from .. import color as C
    rgb = C.xyz_to_linear(jnp.stack([X, Y, Z], axis=-1))
    # clampRgb01 BEFORE power, like the reference
    rgb = jnp.clip(rgb, 0.0, 1.0) * ss.power
    return rgb


@struct.dataclass
class DarkSky:
    """Extended Preetham model of the reference DarkSkyBackground
    (src/background/background_darksky.cc:10-160): altitude shift, a..e
    Perez variance knobs, sun-normalized prePerez, exposure curve
    Y -> exp(Y*exp)-1, selectable RGB color space, and night mode."""
    sun_dir: Array        # f32[3] unit, toward sun (altitude-shifted)
    theta_s: Array        # f32
    zenith_Y: Array       # f32 (cd/m^2)
    zenith_x: Array       # f32
    zenith_y: Array       # f32
    perez_Y: Array        # f32[6] (A..E + prePerez norm)
    perez_x: Array        # f32[6]
    perez_y: Array        # f32[6]
    power: Array          # f32 power * bright
    alt: Array            # f32 altitude shift added to dir.z
    exposure: Array       # f32 (0 disables the exposure curve)
    night: bool = struct.field(pytree_node=False, default=False)
    color_space: str = struct.field(pytree_node=False, default="cie-e")


# XYZ -> linear RGB, CIE RGB with equal-energy (E) white — the reference
# darksky default color space (color_conversion.h CieRgbECs)
_CIE_E_MAT = np.array([[2.3706743, -0.9000405, -0.4706338],
                       [-0.5138850, 1.4253036, 0.0885814],
                       [0.0052982, -0.0146949, 1.0093968]], np.float32)


def make_darksky(pm: P.ParamMap) -> DarkSky:
    sd = np.asarray(pm.get_vector("from", (1.0, 1.0, 1.0)), np.float64)
    alt = pm.get_float("altitude", 0.0)
    sd[2] += alt
    sd = sd / max(np.linalg.norm(sd), 1e-12)
    turb = pm.get_float("turbidity", 4.0)
    theta_s = math.acos(max(min(sd[2], 1.0), -1.0))
    t2, t3 = theta_s * theta_s, theta_s ** 3
    T = turb
    T2 = T * T
    cos_ts = math.cos(theta_s)
    chi = (4.0 / 9.0 - T / 120.0) * (math.pi - 2.0 * theta_s)
    zenith_Y = ((4.0453 * T - 4.9710) * math.tan(chi)
                - 0.2155 * T + 2.4192) * 1000.0
    zenith_x = ((0.00165 * t3 - 0.00374 * t2 + 0.00209 * theta_s) * T2
                + (-0.02902 * t3 + 0.06377 * t2 - 0.03202 * theta_s
                   + 0.00394) * T
                + (0.11693 * t3 - 0.21196 * t2 + 0.06052 * theta_s + 0.25885))
    zenith_y = ((0.00275 * t3 - 0.00610 * t2 + 0.00316 * theta_s) * T2
                + (-0.04214 * t3 + 0.08970 * t2 - 0.04153 * theta_s
                   + 0.00515) * T
                + (0.15346 * t3 - 0.26756 * t2 + 0.06669 * theta_s + 0.26688))
    av = pm.get_float("a_var", 1.0)
    bv = pm.get_float("b_var", 1.0)
    cv = pm.get_float("c_var", 1.0)
    dv = pm.get_float("d_var", 1.0)
    ev = pm.get_float("e_var", 1.0)

    def pre(c):
        num = ((1.0 + c[0] * math.exp(c[1]))
               * (1.0 + c[2] * math.exp(c[3] * theta_s) + c[4] * cos_ts ** 2))
        return 0.0 if num == 0.0 else 1.0 / num

    perez_Y = [(0.17872 * T - 1.46303) * av, (-0.35540 * T + 0.42749) * bv,
               (-0.02266 * T + 5.32505) * cv, (0.12064 * T - 2.57705) * dv,
               (-0.06696 * T + 0.37027) * ev]
    perez_x = [-0.01925 * T - 0.25922, -0.06651 * T + 0.00081,
               -0.00041 * T + 0.21247, -0.06409 * T - 0.89887,
               -0.00325 * T + 0.04517]
    perez_y = [-0.01669 * T - 0.26078, -0.09495 * T + 0.00921,
               -0.00792 * T + 0.21023, -0.04405 * T - 1.65369,
               -0.01092 * T + 0.05291]
    perez_Y.append(pre(perez_Y))
    perez_x.append(pre(perez_x))
    perez_y.append(pre(perez_y))
    cs = pm.get_string("color_space", "CIE (E)")
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    return DarkSky(
        sun_dir=f32(sd), theta_s=f32(theta_s), zenith_Y=f32(zenith_Y),
        zenith_x=f32(zenith_x), zenith_y=f32(zenith_y),
        perez_Y=f32(perez_Y), perez_x=f32(perez_x), perez_y=f32(perez_y),
        # the reference applies `bright` TWICE: getSkyCol multiplies by
        # sky_brightness_ and eval() multiplies by power_ = power*bright
        # (background_darksky.cc:2,48,196-199) — mirrored here
        power=f32(pm.get_float("power", 1.0)
                  * pm.get_float("bright", 1.0) ** 2
                  * (0.5 ** 2 if pm.get_bool("night", False) else 1.0)),
        alt=f32(alt), exposure=f32(pm.get_float("exposure", 1.0)),
        night=pm.get_bool("night", False),
        color_space="srgb" if cs.startswith("sRGB") else "cie-e")


def _eval_darksky(ds: DarkSky, d: Array) -> Array:
    iw = d + jnp.asarray([0.0, 0.0, 1.0], jnp.float32) * ds.alt
    iw = iw / jnp.maximum(
        jnp.sqrt(jnp.sum(iw * iw, -1, keepdims=True)), 1e-12)
    cos_theta = jnp.maximum(iw[..., 2], 1e-6)
    cos_gamma = jnp.clip(vec.dot(iw, ds.sun_dir), -1.0, 1.0)
    cos_gamma2 = cos_gamma * cos_gamma
    gamma = jnp.arccos(cos_gamma)

    def perez(lam, lvz):
        num = ((1.0 + lam[0] * jnp.exp(lam[1] / cos_theta))
               * (1.0 + lam[2] * jnp.exp(lam[3] * gamma)
                  + lam[4] * cos_gamma2))
        return lvz * num * lam[5]

    x = perez(ds.perez_x, ds.zenith_x)
    y = perez(ds.perez_y, ds.zenith_y)
    Y = perez(ds.perez_Y, ds.zenith_Y) * 6.66666667e-5
    # exposure curve (color_conversion.h fromxyY2Xyz: Y = e^(Y*exp) - 1)
    Y = jnp.where(ds.exposure > 0.0,
                  jnp.exp(Y * ds.exposure) - 1.0, Y)
    y_safe = jnp.maximum(y, 1e-6)
    X = x / y_safe * Y
    Z = (1.0 - x - y) / y_safe * Y
    xyz = jnp.stack([X, Y, Z], axis=-1)
    if ds.color_space == "srgb":
        from .. import color as C
        rgb = C.xyz_to_linear(xyz)
    else:
        rgb = jnp.matmul(xyz, jnp.asarray(_CIE_E_MAT).T,
                         precision=jax.lax.Precision.HIGHEST)
    # the reference darksky HARDCODES gamma encoding (v^(1/2.2)) and
    # clampRgb01 in its ColorConv — the clamp_rgb/gamma_enc getParams are
    # commented out (background_darksky.cc:230-232, color_conversion.h:85)
    rgb = jnp.clip(jnp.power(jnp.maximum(rgb, 0.0),
                             jnp.float32(1.0 / 2.2)), 0.0, 1.0)
    if ds.night:
        # night mode keeps a faint blue sky instead of black
        # (background_darksky.cc getSkyCol night branch)
        rgb = rgb * jnp.asarray([0.05, 0.05, 0.08], jnp.float32)
    return rgb * ds.power


def eval_background(scene, d: Array, use_ibl_blur: bool = False) -> Array:
    """Background::operator()(dir) for the whole wavefront; `scene` is
    SceneData (needs .background and .textures)."""
    bg: Background = scene.background
    kind = bg.kind
    if kind == "none":
        return jnp.zeros(d.shape[:-1] + (3,), jnp.float32)
    if kind == "constant":
        return jnp.broadcast_to(bg.color * bg.power, d.shape[:-1] + (3,))
    if kind == "gradient":
        # reference background_gradient.cc: blend zenith/horizon above,
        # ground colors below
        z = d[..., 2:3]
        above = jnp.clip(z, 0.0, 1.0)
        below = jnp.clip(-z, 0.0, 1.0)
        sky = bg.horizon_color + (bg.zenith_color - bg.horizon_color) * above
        ground = (bg.ground_horizon_color
                  + (bg.ground_zenith_color - bg.ground_horizon_color) * below)
        return jnp.where(z >= 0, sky, ground) * bg.power
    if kind == "darksky":
        return _eval_darksky(bg.sunsky, d)
    if kind == "sunsky":
        return _eval_sunsky(bg.sunsky, d)
    if kind == "texture":
        from ..textures import sample_env
        return sample_env(scene, d, bg) * bg.power
    raise KeyError(f"background kind {kind!r}")


def make_background(pm: P.ParamMap, tex_id: int = -1) -> Background:
    kind = pm.get_string("type", "constant")
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    power = f32(pm.get_float("power", 1.0))
    if kind in ("constant",):
        return Background(kind="constant", color=f32(pm.get_color("color", (1, 1, 1))[:3]),
                          power=power)
    if kind in ("gradientback", "gradient"):
        h = f32(pm.get_color("horizon_color", (0.8, 0.9, 1.0))[:3])
        z = f32(pm.get_color("zenith_color", (0.4, 0.5, 1.0))[:3])
        gh = f32(pm.get_color("horizon_ground_color", (0.2, 0.2, 0.2))[:3])
        gz = f32(pm.get_color("zenith_ground_color", (0.1, 0.1, 0.1))[:3])
        return Background(kind="gradient", horizon_color=h, zenith_color=z,
                          ground_horizon_color=gh, ground_zenith_color=gz,
                          power=power)
    if kind == "darksky":
        return Background(kind="darksky", sunsky=make_darksky(pm),
                          power=power)
    if kind == "sunsky":
        return Background(kind="sunsky", sunsky=make_sunsky(pm), power=power)
    if kind in ("textureback", "texture"):
        return Background(kind="texture", tex_id=tex_id,
                          rotation=f32(pm.get_float("rotation", 0.0) * math.pi / 180.0),
                          mapping=pm.get_string("mapping", "sphere"),
                          power=power,
                          ibl_blur=f32(pm.get_float("smartibl_blur", 0.0)))
    raise KeyError(f"background: unknown type {kind!r}")
