"""Shader-node DAG compiler + trace-time evaluator.

Replaces the reference's per-hit interpreted ShaderNode DAG
(src/shader/shader_node.cc, src/material/material_node.cc:55-102
loadNodes/solveNodesOrder/evalNodes): the builder topologically sorts every
material's node list into one global NodeProgram; at trace time a *static*
python loop over the (static-count) node table emits vectorized ops for the
whole wavefront, so the DAG is compiled by XLA rather than interpreted per
hit. See materials/node_eval.py for the per-node-type math.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..scene_types import NodeProgram, SceneData

Array = jax.Array


def build_node_program(builder, mat_table):
    """Compile staged shader-node stacks into a NodeProgram and rewrite the
    material table's node_* binding columns. Returns (program|None, table)."""
    if not getattr(builder, "_shader_stacks", None):
        return None, mat_table
    from .node_build import compile_nodes
    return compile_nodes(builder, mat_table)


def eval_program(scene: SceneData, sp) -> Tuple[Array, Array]:
    """Run the node program for all lanes; returns (colors[N,Nn,4],
    floats[N,Nn]) output slots for every node."""
    from .node_eval import run_program
    return run_program(scene, sp)


_CACHE_KEY = "_node_slots"


def _slots(scene: SceneData, sp):
    # NodeProgram outputs depend only on (scene, sp); memoize per-trace via
    # object identity on sp (safe: sp is a fresh pytree per shading batch)
    return eval_program(scene, sp)


def _pick_col(tab: Array, idx: Array) -> Array:
    """Per-lane column pick from [N, S(, C)] as a one-hot masked sum:
    the node-slot count S is small, so the dense masked sum costs a few
    elementwise ops per lane instead of a dynamic second-index gather."""
    onehot = idx[:, None] == jnp.arange(tab.shape[1])[None, :]
    if tab.ndim == 3:
        onehot = onehot[..., None]
    return jnp.sum(jnp.where(onehot, tab, 0), axis=1)


def eval_color_slot(scene: SceneData, sp, node_id: Array) -> Array:
    cols, _ = _slots(scene, sp)
    return _pick_col(cols, jnp.maximum(node_id, 0))


def eval_scalar_slot(scene: SceneData, sp, node_id: Array) -> Array:
    _, floats = _slots(scene, sp)
    return _pick_col(floats, jnp.maximum(node_id, 0))


def apply_overrides(scene: SceneData, sp, mat_id: Array, mp):
    """Override MP channels whose node binding is >= 0 with evaluated node
    outputs (NodeMaterial::getShaderColor analogue)."""
    mats = scene.materials
    cols, floats = _slots(scene, sp)

    def col_override(node_col, cur):
        nid = node_col[mat_id]
        val = _pick_col(cols, jnp.maximum(nid, 0))[..., :3]
        return jnp.where((nid >= 0)[..., None], val, cur)

    def f_override(node_col, cur):
        nid = node_col[mat_id]
        val = _pick_col(floats, jnp.maximum(nid, 0))
        return jnp.where(nid >= 0, val, cur)

    return mp.replace(
        diffuse_color=col_override(mats.node_diffuse, mp.diffuse_color),
        glossy_color=col_override(mats.node_glossy, mp.glossy_color),
        mirror_color=col_override(mats.node_mirror, mp.mirror_color),
        filter_color=col_override(mats.node_filter_color, mp.filter_color),
        specular_refl=f_override(mats.node_mirror_strength, mp.specular_refl),
        transparency=f_override(mats.node_transparency, mp.transparency),
        translucency=f_override(mats.node_translucency, mp.translucency),
        diffuse_reflect=f_override(mats.node_diffuse_reflect, mp.diffuse_reflect),
        glossy_reflect=f_override(mats.node_glossy_reflect, mp.glossy_reflect),
        sigma=f_override(mats.node_sigma_oren, mp.sigma),
        exponent=f_override(mats.node_exponent, mp.exponent),
        ior=f_override(mats.node_ior, mp.ior),
    )


def bump_normal(scene: SceneData, sp):
    """Perturb the shading normal from bump-node derivatives
    (TextureMapperNode::evalDerivative analogue); returns updated sp."""
    mats = scene.materials
    if scene.nodes is None or scene.nodes.num_nodes == 0:
        return sp
    from .node_eval import eval_bump
    return eval_bump(scene, sp)
