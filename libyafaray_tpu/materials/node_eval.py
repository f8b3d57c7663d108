"""Shader-node program evaluator (trace-time static loop).

Replaces NodeMaterial::evalNodes + per-node eval virtuals (src/material/
material_node.cc:96-102, src/shader/shader_node_basic.cc,
shader_node_layer.cc). The node count and dataflow are static (compiled by
node_build.py), so a python loop emits a fixed vectorized op sequence per
node; XLA fuses the whole DAG — nothing is interpreted per hit.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..math import vec
from ..scene_types import SceneData
from .node_build import NODE_LAYER, NODE_MIX, NODE_TEXMAP, NODE_VALUE

Array = jax.Array


def _tex_coords(scene: SceneData, sp, i: int, p: Array = None):
    """Texture-mapper input point (TextureMapperNode coords + projection,
    shader_node_basic.cc doMapping). `p` overrides sp.p for bump offsets."""
    prog = scene.nodes
    imeta = prog.imeta[i]
    coords = imeta[0]
    proj = imeta[1]
    pf = prog.params_f[i]
    pos = sp.p if p is None else p
    if coords == 0:      # uv: [0,1]x[0,1] -> [-1,1] texture space
        pt = jnp.stack([2.0 * sp.uv[..., 0] - 1.0,
                        2.0 * sp.uv[..., 1] - 1.0,
                        jnp.zeros_like(sp.uv[..., 0])], -1)
    elif coords == 2:    # orco
        pt = sp.orco
    elif coords == 4:    # normal
        pt = sp.n
    elif coords == 5:    # reflect
        pt = sp.n  # approximation: proper reflect needs wo; rarely used
    else:                # global / window / transformed
        pt = pos
    mtx = pf[:16].reshape(4, 4)
    pt = jnp.matmul(pt, mtx[:3, :3].T,
                    precision=jax.lax.Precision.HIGHEST) + mtx[:3, 3]
    # axis remap proj_x/y/z in {0=none,1=x,2=y,3=z}
    axes = []
    for k in (2, 3, 4):
        m = imeta[k]
        axes.append(jnp.zeros_like(pt[..., 0]) if m == 0 else pt[..., m - 1])
    pt = jnp.stack(axes, -1)
    pt = pt * pf[16:19] + pf[19:22]
    if proj == 1:    # cube: project along dominant normal axis
        an = jnp.abs(sp.ng)
        dom = jnp.argmax(an, axis=-1)
        px = jnp.where(dom == 0, pt[..., 1], pt[..., 0])
        py = jnp.where(dom == 2, pt[..., 1], pt[..., 2])
        pt = jnp.stack([px, py, jnp.zeros_like(px)], -1)
    elif proj == 2:  # tube
        u = (jnp.arctan2(pt[..., 1], pt[..., 0]) / (2 * jnp.pi)) + 0.5
        pt = jnp.stack([2 * u - 1, pt[..., 2], jnp.zeros_like(u)], -1)
    elif proj == 3:  # sphere
        r = jnp.maximum(vec.length(pt), 1e-9)
        u = (jnp.arctan2(pt[..., 1], pt[..., 0]) / (2 * jnp.pi)) + 0.5
        v = 1.0 - jnp.arccos(jnp.clip(pt[..., 2] / r, -1, 1)) / jnp.pi
        pt = jnp.stack([2 * u - 1, 2 * v - 1, jnp.zeros_like(u)], -1)
    return pt


def _blend(mode: int, tex: Array, out: Array, fact: Array):
    """textureRgbBlend / textureValueBlend (shader_node_layer.cc:195-300)."""
    f1 = 1.0 - fact
    if mode == 1:    # add
        return out + fact * tex
    if mode == 2:    # mult
        return (f1 + fact * tex) * out
    if mode == 3:    # sub
        return out - fact * tex
    if mode == 4:    # screen
        return 1.0 - (f1 + fact * (1.0 - tex)) * (1.0 - out)
    if mode == 5:    # divide
        return f1 * out + fact * out / jnp.maximum(tex, 1e-6)
    if mode == 6:    # difference
        return f1 * out + fact * jnp.abs(tex - out)
    if mode == 7:    # darken
        return jnp.minimum(tex * fact + out * f1, out)
    if mode == 8:    # lighten
        return jnp.maximum(tex * fact, out)
    if mode == 9:    # overlay
        lo = out * (f1 + 2.0 * fact * tex)
        hi = 1.0 - (f1 + 2.0 * fact * (1.0 - tex)) * (1.0 - out)
        return jnp.where(out < 0.5, lo, hi)
    return f1 * out + fact * tex  # mix


def _eval_node(scene: SceneData, sp, i: int, cols, vals, p=None):
    """Emit ops for node i, appending to the slot lists."""
    from ..textures import sample_texture
    prog = scene.nodes
    ty, in_a, in_b, in_fac, tex_id = prog.meta[i]
    n = sp.p.shape[0]
    if ty == NODE_TEXMAP:
        pt = _tex_coords(scene, sp, i, p)
        uv = jnp.stack([0.5 * (pt[..., 0] + 1.0),
                        0.5 * (pt[..., 1] + 1.0)], -1)
        tid = jnp.full((n,), tex_id, jnp.int32)
        duv_dx = duv_dy = None
        if sp.duv_dx is not None and p is None:
            # footprint through the full mapping chain: re-run _tex_coords
            # at the uv-offset surface point (exact for the linear uv
            # mappings; first-order for the projections)
            pt_x = _tex_coords(scene, sp.replace(
                uv=sp.uv + sp.duv_dx,
                p=sp.p + sp.dp_dx, orco=sp.orco + sp.dp_dx), i)
            pt_y = _tex_coords(scene, sp.replace(
                uv=sp.uv + sp.duv_dy,
                p=sp.p + sp.dp_dy, orco=sp.orco + sp.dp_dy), i)
            duv_dx = 0.5 * (pt_x[..., :2] - pt[..., :2])
            duv_dy = 0.5 * (pt_y[..., :2] - pt[..., :2])
        rgba = sample_texture(scene, tid, pt, uv, duv_dx, duv_dy)
        val = rgba[..., :3].mean(-1)
        cols.append(rgba)
        vals.append(val)
    elif ty == NODE_VALUE:
        cols.append(jnp.broadcast_to(prog.const_a[i], (n, 4)))
        vals.append(jnp.broadcast_to(prog.const_fac[i], (n,)))
    elif ty == NODE_MIX:
        ca = cols[in_a] if in_a >= 0 else jnp.broadcast_to(prog.const_a[i], (n, 4))
        cb = cols[in_b] if in_b >= 0 else jnp.broadcast_to(prog.const_b[i], (n, 4))
        va = vals[in_a] if in_a >= 0 else jnp.broadcast_to(
            prog.const_a[i, :3].mean(), (n,))
        vb = vals[in_b] if in_b >= 0 else jnp.broadcast_to(
            prog.const_b[i, :3].mean(), (n,))
        f = vals[in_fac] if in_fac >= 0 else jnp.broadcast_to(
            prog.const_fac[i], (n,))
        mode = prog.imeta[i][0]
        cols.append(_blend(mode, cb, ca, f[..., None]))
        vals.append(_blend(mode, vb, va, f))
    elif ty == NODE_LAYER:
        # LayerNode::eval (shader_node_layer.cc:30-110)
        tex = cols[in_a]
        tin = vals[in_a]
        flags = prog.imeta[i][1]
        mode = prog.imeta[i][0]
        do_color = prog.imeta[i][2]
        if in_b >= 0:
            rcol = cols[in_b]
            rval = vals[in_b]
            stencil_tin = cols[in_b][..., 3]
        else:
            rcol = jnp.broadcast_to(prog.const_b[i], (n, 4))
            rval = jnp.broadcast_to(prog.params_f[i, 3], (n,))
            stencil_tin = jnp.ones((n,), jnp.float32)
        texcol = tex[..., :3]
        ta = tex[..., 3]
        if flags & 4:  # noRGB: use intensity instead of rgb
            texcol = jnp.broadcast_to(tin[..., None], texcol.shape)
        if flags & 2:  # negative
            texcol = 1.0 - texcol
            tin = 1.0 - tin
        use_alpha_fact = ta  # stencil uses texture alpha as factor
        if flags & 1:  # stencil
            stencil_tin = stencil_tin * tin
        colfac = prog.params_f[i, 0]
        valfac = prog.params_f[i, 1]
        if do_color:
            fac = (stencil_tin * colfac)[..., None]
            out_rgb = _blend(mode, texcol, rcol[..., :3], fac)
        else:
            out_rgb = rcol[..., :3]
        out_val = _blend(mode, tin, rval, stencil_tin * valfac)
        cols.append(jnp.concatenate([out_rgb, stencil_tin[..., None]], -1))
        vals.append(out_val)
    else:
        cols.append(jnp.zeros((n, 4), jnp.float32))
        vals.append(jnp.zeros((n,), jnp.float32))


def run_program(scene: SceneData, sp, p=None) -> Tuple[Array, Array]:
    """Evaluate all nodes; returns (colors[N, Nn, 4], floats[N, Nn])."""
    prog = scene.nodes
    cols, vals = [], []
    for i in range(prog.num_nodes):
        _eval_node(scene, sp, i, cols, vals, p)
    return jnp.stack(cols, axis=1), jnp.stack(vals, axis=1)


def eval_bump(scene: SceneData, sp):
    """Bump mapping: finite-difference the bump node's scalar output along
    the surface tangents and tilt the shading normal
    (TextureMapperNode::evalDerivative analogue, shader_node_basic.cc)."""
    if not scene.nodes.has_bump:
        return sp
    mats = scene.materials
    nb = mats.node_bump[sp.mat_id]
    has = nb >= 0
    eps = 1e-4
    _, v0 = run_program(scene, sp)
    _, vu = run_program(scene, sp, p=sp.p + eps * sp.nu)
    _, vv = run_program(scene, sp, p=sp.p + eps * sp.nv)
    idx = jnp.maximum(nb, 0)
    from .nodes import _pick_col
    du = (_pick_col(vu, idx) - _pick_col(v0, idx)) / eps
    dv = (_pick_col(vv, idx) - _pick_col(v0, idx)) / eps
    # bump strength is a per-node static param; gather dynamically
    bs = scene.nodes.params_f[idx, 22]
    n_new = vec.normalize(sp.n - bs[..., None] * (du[..., None] * sp.nu
                                                  + dv[..., None] * sp.nv))
    n_out = jnp.where(has[..., None], n_new, sp.n)
    nu = vec.normalize(sp.dp_du - n_out * vec.dot(sp.dp_du, n_out,
                                                  keepdims=True))
    nv = jnp.cross(n_out, nu)
    return sp.replace(n=n_out, nu=jnp.where(has[..., None], nu, sp.nu),
                      nv=jnp.where(has[..., None], nv, sp.nv))
