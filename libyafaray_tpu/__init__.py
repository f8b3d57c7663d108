"""libyafaray_tpu: a wavefront differentiable Monte Carlo path tracer.

A brand-new JAX/XLA/Pallas framework with the capabilities of libYafaRay
(see SURVEY.md) — wavefront integrators over
SoA scene tables, LBVH ray traversal, masked vectorized BSDF/light tables,
counter-based QMC sampling, scatter-add film, shard_map multi-device scaling,
and differentiable rendering throughout.
"""
from . import color, film, io, params, sampler
from .integrators.mc import IntegratorConfig, make_integrator
from .render import AAParams, render, render_pass_fn
from .scene import SceneBuilder
from .scene_types import SceneData

__version__ = "0.1.0"

__all__ = [
    "SceneBuilder", "SceneData", "IntegratorConfig", "make_integrator",
    "render", "render_pass_fn", "AAParams", "color", "film", "io", "params",
    "sampler",
]
