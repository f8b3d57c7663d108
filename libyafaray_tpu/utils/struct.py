"""Frozen dataclasses that are JAX pytrees.

`dataclass` turns a class into a frozen `dataclasses.dataclass` registered
with `jax.tree_util.register_dataclass`, and gives it a `.replace(**kw)`
method. Fields declared with `field(pytree_node=False)` are static: they
are not leaves, they are part of the treedef, so `jax.jit` specialises
on their values (trace-time flags such as `MP.present` or
`BlockAccel.block_size`) and they must be hashable.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """`dataclasses.field` with a `pytree_node` flag (False = static)."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def _replace(self, **updates):
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    """Frozen dataclass + pytree registration (data/static split)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
