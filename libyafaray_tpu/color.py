"""Color spaces and spectra, batched over [..., 3] / [..., 4] arrays.

Replaces reference `Rgb/Rgba` + color-space conversions
(include/color/color.h:35-133,345) and the wavelength->RGB CIE fit used for
dispersion (include/color/spectrum.h:31-44, src/color/spectrum.cc).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

# color space ids (mirrors reference ColorSpace enum semantics)
RAW_MANUAL_GAMMA = 0
LINEAR_RGB = 1
SRGB = 2
XYZ_D65 = 3

COLOR_SPACE_NAMES = {
    "RawManualGamma": RAW_MANUAL_GAMMA,
    "LinearRGB": LINEAR_RGB,
    "sRGB": SRGB,
    "XYZ": XYZ_D65,
}


def luminance(rgb: Array) -> Array:
    """Rec.709 luma — reference Rgb::col2bri uses (R+G+B)/3 in places and
    energy() elsewhere; we standardize on CIE Y for perceptual weighting."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def energy(rgb: Array) -> Array:
    return jnp.mean(rgb, axis=-1)


def max_component(rgb: Array) -> Array:
    return jnp.max(rgb, axis=-1)


def linear_to_srgb(c: Array) -> Array:
    c = jnp.maximum(c, 0.0)
    return jnp.where(c <= 0.0031308, 12.92 * c, 1.055 * jnp.power(c, 1.0 / 2.4) - 0.055)


def srgb_to_linear(c: Array) -> Array:
    c = jnp.maximum(c, 0.0)
    return jnp.where(c <= 0.04045, c / 12.92, jnp.power((c + 0.055) / 1.055, 2.4))


_RGB_TO_XYZ = np.array(
    [[0.4124564, 0.3575761, 0.1804375],
     [0.2126729, 0.7151522, 0.0721750],
     [0.0193339, 0.1191920, 0.9503041]], jnp.float32)
_XYZ_TO_RGB = np.array(
    [[3.2404542, -1.5371385, -0.4985314],
     [-0.9692660, 1.8760108, 0.0415560],
     [0.0556434, -0.2040259, 1.0572252]], jnp.float32)


def linear_to_xyz(rgb: Array) -> Array:
    return jnp.einsum("ij,...j->...i", _RGB_TO_XYZ, rgb,
                      precision=jax.lax.Precision.HIGHEST)


def xyz_to_linear(xyz: Array) -> Array:
    return jnp.einsum("ij,...j->...i", _XYZ_TO_RGB, xyz,
                      precision=jax.lax.Precision.HIGHEST)


def to_output_space(rgb: Array, color_space: int, gamma: float = 1.0) -> Array:
    """Linear render output -> named color space (reference image_output path)."""
    if color_space == SRGB:
        return linear_to_srgb(rgb)
    if color_space == XYZ_D65:
        return linear_to_xyz(rgb)
    if color_space == RAW_MANUAL_GAMMA and gamma != 1.0:
        return jnp.power(jnp.maximum(rgb, 0.0), 1.0 / gamma)
    return rgb


def from_input_space(rgb: Array, color_space: int, gamma: float = 1.0) -> Array:
    """Texture/image input -> linear working space (reference texture load)."""
    if color_space == SRGB:
        return srgb_to_linear(rgb)
    if color_space == XYZ_D65:
        return xyz_to_linear(rgb)
    if color_space == RAW_MANUAL_GAMMA and gamma != 1.0:
        return jnp.power(jnp.maximum(rgb, 0.0), gamma)
    return rgb


def color_difference(a: Array, b: Array) -> Array:
    """Perceptual-ish color difference used by adaptive AA noise detection
    (reference Rgb::colorDifference, used at src/render/imagefilm.cc:337)."""
    diff = jnp.abs(a - b)
    # emphasize green (eye sensitivity) like the reference
    w = jnp.array([0.25, 0.5, 0.25], jnp.float32)
    return jnp.sum(diff[..., :3] * w, axis=-1)


def wl_to_rgb(wl01: Array) -> Array:
    """Map wavelength parameter in [0,1] (380..720nm) to linear RGB.

    Smooth analytic fit replacing the reference's CIE table interpolation
    (spectrum::wl2Rgb, src/color/spectrum.cc); normalized so that integrating
    over wl in [0,1] gives ~(1,1,1) white, which is what the dispersion
    estimator needs (integrator_montecarlo.cc `dispersive`).
    """
    wl = 380.0 + wl01 * 340.0
    # Gaussian-mixture fit of CIE-ish response, cheap on the VPU
    def g(x, mu, s1, s2):
        s = jnp.where(x < mu, s1, s2)
        t = (x - mu) / s
        return jnp.exp(-0.5 * t * t)

    r = 1.056 * g(wl, 599.8, 37.9, 31.0) + 0.362 * g(wl, 442.0, 16.0, 26.7) \
        - 0.065 * g(wl, 501.1, 20.4, 26.2)
    gch = 0.821 * g(wl, 568.8, 46.9, 40.5) + 0.286 * g(wl, 530.9, 16.3, 31.1)
    b = 1.217 * g(wl, 437.0, 11.8, 36.0) + 0.681 * g(wl, 459.0, 26.0, 13.8)
    rgb = jnp.stack([r, gch, b], axis=-1)
    # normalize: mean over a uniform wl grid is ~ (0.335, 0.335, 0.335)
    return jnp.maximum(rgb, 0.0) * 2.985


def premultiply_alpha(rgba: Array) -> Array:
    return jnp.concatenate([rgba[..., :3] * rgba[..., 3:4], rgba[..., 3:4]], axis=-1)
