"""Branchless vectorized BSDF table: eval / sample / pdf / emit / transparency.

Wavefront replacement for the reference Material class hierarchy
(src/material/material_*.cc, interface include/material/material.h:94-154).
Instead of virtual dispatch per hit, every material model is expressed as a
combination of five *lobes* evaluated with masks over the whole wavefront:

    lobe 0  delta reflect   (mirror, glass reflect, coated-glossy coat)
    lobe 1  delta transmit  (glass refract, shiny-diffuse transparency)
    lobe 2  microfacet      (Blinn / Ashikhmin-Shirley / GGX reflect+refract)
    lobe 3  diffuse reflect (Lambert or Oren-Nayar)
    lobe 4  diffuse transmit(translucency)

Per-lane lobe weights reproduce each reference material's component
accounting (e.g. ShinyDiffuse's Fresnel-weighted accumulation,
material_shiny_diffuse.cc:102-130). Blend materials (material_blend.cc)
resolve both sub-material parameter rows and lerp eval/pdf; mask materials
(material_mask.cc) select the effective row per lane before the gather.

All math uses the local shading frame (z = n); conversions via SurfacePoint
nu/nv/n. Every parameter is differentiable.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from ..utils import struct

from ..ops.fast_grad import take as fast_take

from ..math import vec
from ..scene_types import (
    MAT_BLEND, MAT_COATED_GLOSSY, MAT_GLASS, MAT_GLOSSY, MAT_LIGHT, MAT_MASK,
    MAT_MIRROR, MAT_NULL, MAT_ROUGH_GLASS, MAT_SHINY_DIFFUSE, MaterialTable,
    SceneData,
)
from . import microfacet as mf

Array = jax.Array

# mat_flags bits
FLAG_FRESNEL = 1
FLAG_ANISOTROPIC = 2
FLAG_AS_DIFFUSE = 4
FLAG_FAKE_SHADOWS = 8
FLAG_NO_RECV_SHADOWS = 16


@struct.dataclass
class MP:
    """Per-lane resolved material parameters (post node/texture overrides)."""
    mat_type: Array
    diffuse_color: Array
    glossy_color: Array
    mirror_color: Array
    filter_color: Array
    absorption: Array
    emit_color: Array
    specular_refl: Array
    transparency: Array
    translucency: Array
    diffuse_reflect: Array
    glossy_reflect: Array
    exponent: Array
    exp_u: Array
    exp_v: Array
    alpha: Array
    ior: Array
    mat_flags: Array
    sigma: Array
    blend_value: Array
    # static trace-time hints copied from the MaterialTable (see
    # scene_types.py): which material families exist, whether any row uses
    # Oren-Nayar / anisotropic microfacets / fresnel weighting. Lobe math
    # for absent families is not traced at all.
    present: tuple = struct.field(pytree_node=False, default=())
    has_oren: bool = struct.field(pytree_node=False, default=True)
    has_aniso: bool = struct.field(pytree_node=False, default=True)
    has_fresnel: bool = struct.field(pytree_node=False, default=True)

    def has(self, ty: int) -> bool:
        return (not self.present) or (ty in self.present)


def gather_mp(mats: MaterialTable, mat_id: Array) -> MP:
    # fast-gradient gathers: parameter gradients reduce onto the small
    # material table via one-hot matmuls instead of per-column
    # scatter-adds onto a few rows (ops/fast_grad.py)
    return MP(
        present=mats.present_types, has_oren=mats.has_oren,
        has_aniso=mats.has_aniso, has_fresnel=mats.has_fresnel,
        mat_type=mats.mat_type[mat_id],
        diffuse_color=fast_take(mats.diffuse_color, mat_id),
        glossy_color=fast_take(mats.glossy_color, mat_id),
        mirror_color=fast_take(mats.mirror_color, mat_id),
        filter_color=fast_take(mats.filter_color, mat_id),
        absorption=fast_take(mats.absorption, mat_id),
        emit_color=fast_take(mats.emit_color, mat_id),
        specular_refl=fast_take(mats.specular_refl, mat_id),
        transparency=fast_take(mats.transparency, mat_id),
        translucency=fast_take(mats.translucency, mat_id),
        diffuse_reflect=fast_take(mats.diffuse_reflect, mat_id),
        glossy_reflect=fast_take(mats.glossy_reflect, mat_id),
        exponent=fast_take(mats.exponent, mat_id),
        exp_u=fast_take(mats.exp_u, mat_id),
        exp_v=fast_take(mats.exp_v, mat_id),
        alpha=fast_take(mats.alpha, mat_id),
        ior=fast_take(mats.ior, mat_id),
        mat_flags=mats.mat_flags[mat_id],
        sigma=fast_take(mats.sigma, mat_id),
        blend_value=fast_take(mats.blend_value, mat_id),
    )


def _flag(mp_flags: Array, bit: int) -> Array:
    return (mp_flags & bit) != 0


def lobe_weights(mp: MP, cos_wo: Array):
    """Per-lane weights of the five lobes, summing to <= 1.

    Mirrors ShinyDiffuse's cumulative component accumulation
    (material_shiny_diffuse.cc `accumulate`) and each material's own split."""
    ty = mp.mat_type
    # dielectric fresnel at normal-ish incidence for fresnel-weighted mirror
    need_kr = (mp.has_fresnel or mp.has(MAT_COATED_GLOSSY)
               or mp.has(MAT_GLASS))
    kr_ior = vec.fresnel_dielectric(cos_wo, mp.ior) if need_kr else None

    w_dr = jnp.zeros_like(cos_wo)   # delta reflect
    w_dt = jnp.zeros_like(cos_wo)   # delta transmit
    w_mf = jnp.zeros_like(cos_wo)   # microfacet
    w_di = jnp.zeros_like(cos_wo)   # diffuse reflect
    w_tl = jnp.zeros_like(cos_wo)   # diffuse transmit

    if mp.has(MAT_SHINY_DIFFUSE):
        if mp.has_fresnel:
            use_fresnel = _flag(mp.mat_flags, FLAG_FRESNEL)
            m = mp.specular_refl * jnp.where(use_fresnel, kr_ior, 1.0)
        else:
            m = mp.specular_refl
        acc = 1.0 - m
        t = mp.transparency * acc
        acc = acc * (1.0 - mp.transparency)
        tl = mp.translucency * acc
        acc = acc * (1.0 - mp.translucency)
        di = mp.diffuse_reflect * acc
        is_sd = ty == MAT_SHINY_DIFFUSE
        w_dr = jnp.where(is_sd, m, w_dr)
        w_dt = jnp.where(is_sd, t, w_dt)
        w_tl = jnp.where(is_sd, tl, w_tl)
        w_di = jnp.where(is_sd, di, w_di)

    if mp.has(MAT_GLOSSY):
        is_gl = ty == MAT_GLOSSY
        w_mf = jnp.where(is_gl, mp.glossy_reflect, w_mf)
        w_di = jnp.where(is_gl, mp.diffuse_reflect * (1.0 - mp.glossy_reflect),
                         w_di)

    if mp.has(MAT_COATED_GLOSSY):
        # delta coat by dielectric fresnel + glossy + diffuse
        is_cg = ty == MAT_COATED_GLOSSY
        w_dr = jnp.where(is_cg, kr_ior, w_dr)
        w_mf = jnp.where(is_cg, (1.0 - kr_ior) * mp.glossy_reflect, w_mf)
        w_di = jnp.where(is_cg, (1.0 - kr_ior) * mp.diffuse_reflect
                         * (1.0 - mp.glossy_reflect), w_di)

    if mp.has(MAT_GLASS):
        # fresnel split between delta reflect / delta transmit
        is_gs = ty == MAT_GLASS
        w_dr = jnp.where(is_gs, kr_ior, w_dr)
        w_dt = jnp.where(is_gs, 1.0 - kr_ior, w_dt)

    if mp.has(MAT_ROUGH_GLASS):
        # single microfacet lobe (reflect/refract inside)
        is_rg = ty == MAT_ROUGH_GLASS
        w_mf = jnp.where(is_rg, 1.0, w_mf)

    if mp.has(MAT_MIRROR):
        is_mi = ty == MAT_MIRROR
        w_dr = jnp.where(is_mi, mp.specular_refl, w_dr)

    # NULL / LIGHT: no scattering
    return w_dr, w_dt, w_mf, w_di, w_tl


def _oren_nayar_factor(sigma: Array, wo_l: Array, wi_l: Array) -> Array:
    """Oren-Nayar correction (reference material_glossy.cc OrenNayar path)."""
    s2 = sigma * sigma
    a = 1.0 - 0.5 * s2 / (s2 + 0.33)
    b = 0.45 * s2 / (s2 + 0.09)
    cos_to = jnp.clip(jnp.abs(wo_l[..., 2]), 0.0, 1.0)
    cos_ti = jnp.clip(jnp.abs(wi_l[..., 2]), 0.0, 1.0)
    sin_to = jnp.sqrt(jnp.maximum(1e-12, 1.0 - cos_to * cos_to))
    sin_ti = jnp.sqrt(jnp.maximum(1e-12, 1.0 - cos_ti * cos_ti))
    # cos(phi_i - phi_o) via projected directions
    po = wo_l[..., :2] * jax.lax.rsqrt(jnp.maximum(
        jnp.sum(wo_l[..., :2] ** 2, -1, keepdims=True), 1e-12))
    pi_ = wi_l[..., :2] * jax.lax.rsqrt(jnp.maximum(
        jnp.sum(wi_l[..., :2] ** 2, -1, keepdims=True), 1e-12))
    cos_dphi = jnp.maximum(jnp.sum(po * pi_, -1), 0.0)
    sin_alpha = jnp.maximum(sin_to, sin_ti)
    tan_beta = jnp.minimum(sin_to / jnp.maximum(cos_to, 1e-6),
                           sin_ti / jnp.maximum(cos_ti, 1e-6))
    return a + b * cos_dphi * sin_alpha * tan_beta


def _glossy_f(mp: MP, wo_l: Array, wi_l: Array):
    """Microfacet reflection lobe f and half-vector pdf for glossy/coated
    (Ashikhmin-Shirley normalization, material_glossy.cc:130-215)."""
    h = vec.normalize(wo_l + wi_l)
    cos_wo_h = jnp.abs(vec.dot(wo_l, h))
    cos_no = jnp.abs(wo_l[..., 2])
    cos_ni = jnp.abs(wi_l[..., 2])
    aniso = _flag(mp.mat_flags, FLAG_ANISOTROPIC)
    d = jnp.where(aniso, mf.as_aniso_d(h, mp.exp_u, mp.exp_v),
                  mf.blinn_d(h[..., 2], mp.exponent))
    pdf_h = jnp.where(aniso, mf.as_aniso_pdf_h(h, mp.exp_u, mp.exp_v),
                      mf.blinn_pdf_h(h[..., 2], mp.exponent))
    fres = vec.schlick_fresnel(cos_wo_h, mp.glossy_reflect)
    denom = 4.0 * jnp.maximum(cos_wo_h, 1e-6) * jnp.maximum(
        jnp.maximum(cos_no, cos_ni), 1e-6)
    f_scalar = d * fres / denom
    f = f_scalar[..., None] * mp.glossy_color
    # pdf of wi when sampling h then reflecting: pdf_h / (4 |wo.h|)
    pdf_wi = pdf_h / jnp.maximum(4.0 * cos_wo_h, 1e-6)
    same_hemi = (wo_l[..., 2] * wi_l[..., 2]) > 0.0
    f = jnp.where(same_hemi[..., None], f, 0.0)
    pdf_wi = jnp.where(same_hemi, pdf_wi, 0.0)
    return f, pdf_wi


def _rough_glass_f(mp: MP, wo_l: Array, wi_l: Array):
    """Walter-2007 GGX rough dielectric eval (material_rough_glass.cc)."""
    a2 = mp.alpha * mp.alpha
    eta = jnp.where(wo_l[..., 2] > 0, mp.ior, 1.0 / mp.ior)
    reflecting = (wo_l[..., 2] * wi_l[..., 2]) > 0.0
    # half vectors
    h_r = vec.normalize(jnp.sign(wo_l[..., 2:3]) * (wo_l + wi_l))
    h_t = vec.normalize(-(wo_l + wi_l * eta[..., None]))
    h_t = h_t * jnp.sign(h_t[..., 2:3])
    h = jnp.where(reflecting[..., None], h_r, h_t)
    cos_wo_h = vec.dot(wo_l, h)
    cos_wi_h = vec.dot(wi_l, h)
    d = mf.ggx_d(h[..., 2], a2)
    g = mf.ggx_g(wi_l[..., 2], wo_l[..., 2], a2)
    fres = vec.fresnel_dielectric(cos_wo_h, jnp.where(wo_l[..., 2] > 0, mp.ior,
                                                      1.0 / mp.ior))
    cos_no = jnp.abs(wo_l[..., 2])
    cos_ni = jnp.abs(wi_l[..., 2])
    # reflection term
    f_r = fres * d * g / jnp.maximum(4.0 * cos_no * cos_ni, 1e-7)
    pdf_r = mf.ggx_pdf_h(h[..., 2], a2) / jnp.maximum(
        4.0 * jnp.abs(cos_wo_h), 1e-7) * fres
    # transmission term (Walter eq. 21)
    sqrt_denom = cos_wo_h + eta * cos_wi_h
    ft_num = (jnp.abs(cos_wo_h) * jnp.abs(cos_wi_h) * eta * eta
              * d * g * (1.0 - fres))
    f_t = ft_num / jnp.maximum(cos_no * cos_ni * sqrt_denom * sqrt_denom, 1e-7)
    dwh_dwi = eta * eta * jnp.abs(cos_wi_h) / jnp.maximum(
        sqrt_denom * sqrt_denom, 1e-7)
    pdf_t = mf.ggx_pdf_h(h[..., 2], a2) * dwh_dwi * (1.0 - fres)
    f_scalar = jnp.where(reflecting, f_r, f_t)
    pdf = jnp.where(reflecting, pdf_r, pdf_t)
    col = jnp.where(reflecting[..., None], mp.mirror_color, mp.filter_color)
    return f_scalar[..., None] * col, pdf


def _to_local(sp, w):
    return vec.to_local(w, sp.nu, sp.nv, sp.n)


def _from_local(sp, l):
    return vec.from_local(l, sp.nu, sp.nv, sp.n)


def _eval_single(mp: MP, wo_l: Array, wi_l: Array, split: bool = False):
    """Non-delta f and solid-angle pdf for one parameter row per lane.
    split=True adds per-family components (see eval_bsdf)."""
    cos_wo = jnp.abs(wo_l[..., 2])
    w_dr, w_dt, w_mf, w_di, w_tl = lobe_weights(mp, cos_wo)
    same_hemi = (wo_l[..., 2] * wi_l[..., 2]) > 0.0
    cos_wi = jnp.abs(wi_l[..., 2])
    inv_pi = 1.0 / jnp.pi

    # diffuse reflect
    if mp.has_oren:
        on = jnp.where(mp.sigma > 0.0,
                       _oren_nayar_factor(mp.sigma, wo_l, wi_l), 1.0)
    else:
        on = 1.0
    f_di = (w_di * on * inv_pi)[..., None] * mp.diffuse_color
    f_di = jnp.where(same_hemi[..., None], f_di, 0.0)
    pdf_di = jnp.where(same_hemi, cos_wi * inv_pi, 0.0)

    # diffuse transmit (translucency)
    f_tl = (w_tl * inv_pi)[..., None] * mp.diffuse_color
    f_tl = jnp.where(same_hemi[..., None], 0.0, f_tl)
    pdf_tl = jnp.where(same_hemi, 0.0, cos_wi * inv_pi)

    # microfacet — trace only the families present in the scene
    ty = mp.mat_type
    has_gl = mp.has(MAT_GLOSSY) or mp.has(MAT_COATED_GLOSSY)
    has_rg = mp.has(MAT_ROUGH_GLASS)
    if has_gl and has_rg:
        is_rg = ty == MAT_ROUGH_GLASS
        f_gl, pdf_gl = _glossy_f(mp, wo_l, wi_l)
        f_rg, pdf_rg = _rough_glass_f(mp, wo_l, wi_l)
        f_mf = jnp.where(is_rg[..., None], f_rg, f_gl)
        pdf_mf = jnp.where(is_rg, pdf_rg, pdf_gl)
    elif has_rg:
        f_mf, pdf_mf = _rough_glass_f(mp, wo_l, wi_l)
    elif has_gl:
        f_mf, pdf_mf = _glossy_f(mp, wo_l, wi_l)
    else:
        f_mf = jnp.zeros_like(mp.diffuse_color)
        pdf_mf = jnp.zeros_like(cos_wi)
    # coated glossy: scale glossy lobe by (1 - coat fresnel) is already in w_mf
    f_mf = w_mf[..., None] * f_mf

    f = f_di + f_tl + f_mf
    w_sum = w_dr + w_dt + w_mf + w_di + w_tl
    pdf = (w_di * pdf_di + w_tl * pdf_tl + w_mf * pdf_mf) / jnp.maximum(w_sum, 1e-6)
    if split:
        # per-BSDF-family components for the adv-* AOV layers
        # (doLightEstimation's ColorLayerAccum splits, integrator_montecarlo.cc)
        is_rg = (ty == MAT_ROUGH_GLASS)[..., None] if has_rg \
            else jnp.zeros_like(f[..., :1], bool)
        fam = {"diffuse": f_di,
               "glossy": jnp.where(is_rg, 0.0, f_mf),
               "trans": jnp.where(is_rg, f_mf, 0.0),
               "subsurface": f_tl}
        return f, pdf, fam
    return f, pdf


def eval_bsdf(scene: SceneData, sp, wo: Array, wi: Array, split: bool = False):
    """f(wo, wi) of non-delta lobes + solid-angle pdf (Material::eval/pdf).
    With split=True additionally returns per-family components
    (diffuse/glossy/trans/subsurface) for the adv-* AOV layers."""
    mats = scene.materials
    mp = resolve_mp(scene, sp)
    wo_l = _to_local(sp, wo)
    wi_l = _to_local(sp, wi)
    if split:
        f, pdf, fam = _eval_single(mp, wo_l, wi_l, split=True)
    else:
        f, pdf = _eval_single(mp, wo_l, wi_l)
        fam = None
    if mats.has_blend:
        bl = blend_factor(scene, sp)
        is_blend = mp.mat_type == MAT_BLEND
        mp_a = resolve_mp(scene, sp, mats.blend_a[sp.mat_id])
        mp_b = resolve_mp(scene, sp, mats.blend_b[sp.mat_id])
        if split:
            f_a, pdf_a, fam_a = _eval_single(mp_a, wo_l, wi_l, split=True)
            f_b, pdf_b, fam_b = _eval_single(mp_b, wo_l, wi_l, split=True)
            for k in fam:
                fam[k] = jnp.where(
                    is_blend[..., None],
                    fam_a[k] * (1.0 - bl[..., None]) + fam_b[k] * bl[..., None],
                    fam[k])
        else:
            f_a, pdf_a = _eval_single(mp_a, wo_l, wi_l)
            f_b, pdf_b = _eval_single(mp_b, wo_l, wi_l)
        f = jnp.where(is_blend[..., None],
                      f_a * (1.0 - bl[..., None]) + f_b * bl[..., None], f)
        pdf = jnp.where(is_blend, pdf_a * (1.0 - bl) + pdf_b * bl, pdf)
    if split:
        return f, pdf, fam
    return f, pdf


@struct.dataclass
class MatSample:
    wi: Array          # f32[N,3] sampled world direction
    weight: Array      # f32[N,3] throughput multiplier f*|cos|/pdf (or delta color)
    pdf: Array         # f32[N] solid-angle pdf (0 for delta lobes)
    is_delta: Array    # bool[N]
    is_transmit: Array # bool[N] crossed to the other side of the surface
    valid: Array       # bool[N] sample produced any contribution
    dispersed: Array = None  # bool[N] chromatic refraction event (glass
                             # with dispersion_power > 0; integrator tints
                             # the path by wl2rgb on the first one)
    lobe: Array = None       # i32[N] sampled lobe: 0 delta-reflect,
                             # 1 delta-transmit, 2 microfacet, 3 diffuse,
                             # 4 translucent (AOV diffuse/glossy splits)


def _sample_single(mp: MP, sp, wo_l: Array, u1: Array, u2: Array, u3: Array
                   ) -> MatSample:
    cos_wo = jnp.abs(wo_l[..., 2])
    w_dr, w_dt, w_mf, w_di, w_tl = lobe_weights(mp, cos_wo)
    w_sum = w_dr + w_dt + w_mf + w_di + w_tl
    valid = w_sum > 1e-6
    inv_sum = 1.0 / jnp.maximum(w_sum, 1e-6)
    p_dr = w_dr * inv_sum
    p_dt = w_dt * inv_sum
    p_mf = w_mf * inv_sum
    p_di = w_di * inv_sum
    c0 = p_dr
    c1 = c0 + p_dt
    c2 = c1 + p_mf
    c3 = c2 + p_di
    pick_dr = u3 < c0
    pick_dt = (~pick_dr) & (u3 < c1)
    pick_mf = (~pick_dr) & (~pick_dt) & (u3 < c2)
    pick_di = (~pick_dr) & (~pick_dt) & (~pick_mf) & (u3 < c3)
    pick_tl = (~pick_dr) & (~pick_dt) & (~pick_mf) & (~pick_di)

    ty = mp.mat_type
    sgn_wo = jnp.sign(wo_l[..., 2:3])
    sgn_wo = jnp.where(sgn_wo == 0, 1.0, sgn_wo)

    has_glass = mp.has(MAT_GLASS)
    has_rg = mp.has(MAT_ROUGH_GLASS)
    has_gl = mp.has(MAT_GLOSSY) or mp.has(MAT_COATED_GLOSSY)
    has_delta_t = has_glass or mp.has(MAT_SHINY_DIFFUSE) or mp.has(MAT_NULL)

    # ---- delta reflect: mirror about local z
    wi_dr = jnp.stack([-wo_l[..., 0], -wo_l[..., 1], wo_l[..., 2]], axis=-1)
    col_dr = mp.mirror_color

    eta_rel = (jnp.where(wo_l[..., 2] > 0, mp.ior, 1.0 / mp.ior)
               if (has_glass or has_rg) else None)

    # ---- delta transmit
    if has_delta_t:
        # glass refract through local normal; shinydiffuse passes straight
        # through
        if has_glass:
            n_l = jnp.concatenate([jnp.zeros_like(wo_l[..., :2]), sgn_wo],
                                  axis=-1)
            wt, tir = vec.refract(wo_l, n_l, eta_rel)
            is_glass = ty == MAT_GLASS
            wi_dt = jnp.where(is_glass[..., None], wt, -wo_l)
            # TIR: glass transmit lobe flips to reflection
            wi_dt = jnp.where((is_glass & tir)[..., None], wi_dr, wi_dt)
            # glass transmits its filter color; shiny-diffuse transparency
            # passes straight through unfiltered (the filter applies to shadow
            # rays via `transparency()` below, material_shiny_diffuse.cc)
            col_dt = jnp.where(is_glass[..., None], mp.filter_color,
                               jnp.ones_like(mp.filter_color))
            col_dt = jnp.where((is_glass & tir)[..., None], mp.mirror_color,
                               col_dt)
        else:
            wi_dt = -wo_l
            col_dt = jnp.ones_like(mp.filter_color)
    else:
        wi_dt = -wo_l
        col_dt = jnp.ones_like(mp.filter_color)

    # ---- microfacet lobe (trace only the present families)
    if has_gl or has_rg:
        if has_gl:
            if mp.has_aniso:
                aniso = _flag(mp.mat_flags, FLAG_ANISOTROPIC)
                h_gl = jnp.where(aniso[..., None],
                                 mf.as_aniso_sample_h(u1, u2, mp.exp_u,
                                                      mp.exp_v),
                                 mf.blinn_sample_h(u1, u2, mp.exponent))
            else:
                h_gl = mf.blinn_sample_h(u1, u2, mp.exponent)
        if has_rg:
            h_ggx = mf.ggx_sample_h(u1, u2, mp.alpha)
        if has_gl and has_rg:
            is_rg = ty == MAT_ROUGH_GLASS
            h = jnp.where(is_rg[..., None], h_ggx, h_gl)
        elif has_rg:
            h = h_ggx
        else:
            h = h_gl
        h = h * sgn_wo  # half-vector on wo's side
        cos_wo_h = vec.dot(wo_l, h)
        wi_refl = vec.normalize(2.0 * cos_wo_h[..., None] * h - wo_l)
        if has_rg:
            # rough glass: choose reflect/refract at the microfacet by
            # fresnel (u3 reuse is biased; derive a fresh uniform from u1,u2)
            fres_h = vec.fresnel_dielectric(cos_wo_h, eta_rel)
            u4 = (u1 * 7919.0 + u2 * 104729.0) % 1.0
            wt_h, tir_h = vec.refract(wo_l, h, eta_rel)
            choose_refl = (u4 < fres_h) | tir_h
            wi_mf = jnp.where(choose_refl[..., None], wi_refl, wt_h)
            if has_gl:
                wi_mf = jnp.where((ty == MAT_ROUGH_GLASS)[..., None],
                                  wi_mf, wi_refl)
        else:
            wi_mf = wi_refl
    else:
        wi_mf = wi_dr

    # ---- diffuse lobes
    d_loc = vec.cosine_sample_hemisphere(u1, u2)
    wi_di = d_loc * sgn_wo   # same hemisphere as wo
    wi_tl = -d_loc * sgn_wo  # opposite hemisphere

    wi_l = jnp.where(pick_dr[..., None], wi_dr,
            jnp.where(pick_dt[..., None], wi_dt,
             jnp.where(pick_mf[..., None], wi_mf,
              jnp.where(pick_di[..., None], wi_di, wi_tl))))

    # --- combined eval at sampled wi for MIS-correct weight/pdf ---
    f, pdf_nd = _eval_single(mp, wo_l, wi_l)
    cos_wi = jnp.abs(wi_l[..., 2])

    picked_delta = pick_dr | pick_dt
    # delta weights: color * lobe_weight / p_lobe  (cos cancels for delta)
    p_lobe_delta = jnp.where(pick_dr, p_dr, p_dt)
    w_lobe_delta = jnp.where(pick_dr, w_dr, w_dt)
    col_delta = jnp.where(pick_dr[..., None], col_dr, col_dt)
    weight_delta = col_delta * (w_lobe_delta / jnp.maximum(p_lobe_delta, 1e-9)
                                )[..., None]
    # glass refraction radiance scaling (eta^2) omitted: symmetric transport
    # for unidirectional path tracing from camera uses radiance scaling 1/eta^2
    # on refraction *into* denser medium and eta^2 out; they cancel over a full
    # through-path. The reference also omits it (material_glass.cc).

    # non-delta weight: f * cos / pdf with pdf from combined estimator
    pdf_safe = jnp.maximum(pdf_nd, 1e-9)
    weight_nd = f * (cos_wi / pdf_safe)[..., None]
    weight = jnp.where(picked_delta[..., None], weight_delta, weight_nd)
    pdf_out = jnp.where(picked_delta, 0.0, pdf_nd)
    valid = valid & jnp.where(picked_delta, True, pdf_nd > 1e-9)
    is_transmit = (wi_l[..., 2] * wo_l[..., 2]) < 0.0
    lobe = jnp.where(pick_dr, 0, jnp.where(pick_dt, 1, jnp.where(
        pick_mf, 2, jnp.where(pick_di, 3, 4)))).astype(jnp.int32)
    return MatSample(wi=wi_l, weight=weight, pdf=pdf_out,
                     is_delta=picked_delta, is_transmit=is_transmit,
                     valid=valid, lobe=lobe)


def blend_factor(scene: SceneData, sp) -> Array:
    """Blend value per lane (constant or node-driven); materials/nodes.py
    overrides this when a blend node is bound."""
    val = scene.materials.blend_value[sp.mat_id]
    if scene.nodes is not None and scene.nodes.num_nodes > 0:
        from . import nodes as node_mod
        node_id = scene.materials.node_blend[sp.mat_id]
        node_val = node_mod.eval_scalar_slot(scene, sp, node_id)
        val = jnp.where(node_id >= 0, node_val, val)
    return val


def resolve_mp(scene: SceneData, sp, mat_id: Optional[Array] = None) -> MP:
    """Gather per-lane params, applying mask-material indirection and
    shader-node channel overrides."""
    mats = scene.materials
    if mat_id is None:
        mat_id = sp.mat_id
    if mats.has_mask:
        is_mask = mats.mat_type[mat_id] == MAT_MASK
        bl = blend_factor(scene, sp)
        thr = mats.blend_value[mat_id]
        # mask: node value > threshold selects material 2 (material_mask.cc)
        eff = jnp.where(bl > thr, mats.blend_b[mat_id], mats.blend_a[mat_id])
        mat_id = jnp.where(is_mask, eff, mat_id)
    mp = gather_mp(mats, mat_id)
    if scene.nodes is not None and scene.nodes.num_nodes > 0:
        from . import nodes as node_mod
        mp = node_mod.apply_overrides(scene, sp, mat_id, mp)
    return mp


def sample_bsdf(scene: SceneData, sp, wo: Array, u1, u2, u3,
                wl: Optional[Array] = None) -> MatSample:
    """Material::sample analogue for the whole wavefront.

    `wl` (optional, [N] in [0,1]) is the path's chromatic wavelength for
    dispersive glass: the per-lane IOR shifts linearly with (wl - 0.5) *
    dispersion_power — a linearized Cauchy model of the reference's
    CauchyCoefficients (material_glass.cc dispersion branch +
    include/color/spectrum.h)."""
    mats = scene.materials
    mp = resolve_mp(scene, sp)
    if wl is not None:
        disp = mats.dispersion[sp.mat_id]
        mp = mp.replace(ior=mp.ior + disp * (wl - 0.5))
    wo_l = _to_local(sp, wo)
    if mats.has_blend:
        # stochastically select a sub-material for blends, lerp eval/pdf
        bl = blend_factor(scene, sp)
        is_blend = mp.mat_type == MAT_BLEND
        sub = jnp.where(u3 < bl, mats.blend_b[sp.mat_id], mats.blend_a[sp.mat_id])
        eff_id = jnp.where(is_blend, sub, sp.mat_id)
        # re-stretch u3 within the chosen branch for reuse
        u3b = jnp.where(is_blend, jnp.where(u3 < bl,
                                            u3 / jnp.maximum(bl, 1e-9),
                                            (u3 - bl) / jnp.maximum(1 - bl, 1e-9)),
                        u3)
        mp_eff = resolve_mp(scene, sp, eff_id)
        s = _sample_single(mp_eff, sp, wo_l, u1, u2, u3b)
    else:
        s = _sample_single(mp, sp, wo_l, u1, u2, u3)
    wi_world = _from_local(sp, s.wi)
    disp = mats.dispersion[sp.mat_id]
    dispersed = s.is_delta & s.is_transmit & (disp > 0.0)
    return s.replace(wi=wi_world, dispersed=dispersed)


def emit(scene: SceneData, sp, wo: Array) -> Array:
    """Material emission toward wo (Material::emit): light_mat + shiny-diffuse
    emit param. One-sided: emits from the front face (ng . wo > 0)."""
    mp = resolve_mp(scene, sp)
    front = vec.dot(wo, sp.ng) > 0.0
    e = mp.emit_color
    return jnp.where((front & sp.valid)[..., None], e, 0.0)


def transparency(scene: SceneData, sp, wo: Array) -> Array:
    """Filter color for transparent-shadow rays (Material::getTransparency).

    shinydiffuse: transparency strength times its (possibly textured) color;
    glass with fake_shadows: filter color; null: fully transparent."""
    mp = resolve_mp(scene, sp)
    ty = mp.mat_type
    sd = (mp.transparency[..., None]
          * jnp.where(jnp.any(mp.filter_color > 0, -1, keepdims=True),
                      mp.filter_color, jnp.ones_like(mp.filter_color)))
    out = jnp.zeros_like(mp.diffuse_color)
    out = jnp.where((ty == MAT_SHINY_DIFFUSE)[..., None], sd, out)
    fake = _flag(mp.mat_flags, FLAG_FAKE_SHADOWS)
    out = jnp.where(((ty == MAT_GLASS) & fake)[..., None],
                    mp.filter_color, out)
    out = jnp.where((ty == MAT_NULL)[..., None], jnp.ones_like(out), out)
    return out
