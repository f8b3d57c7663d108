"""Multi-host entry point: process-level distribution over DCN.

The analogue of the reference's render farm
(SURVEY.md par.2.15): N yafaray processes each render with a
decorrelated sample stream and their films are summed
(imageFilmLoadAllInFolder, src/render/imagefilm.cc:940-1008). Here:

  - `init_distributed()` wraps `jax.distributed.initialize` so every
    process sees the global device set (each process owning its own
    card); in-process scaling then uses the mesh collectives
    (parallel.render_sharded), while
    cross-host film aggregation rides either a psum over the global mesh
    or the film-folder merge below (the DCN fallback that also covers
    heterogeneous / failure-prone farm setups).
  - `render_node_film()` renders this process's decorrelated share
    (film.computer_node seeds the per-node sampling offset, the
    adv_base_sampling_offset analogue, src/scene/scene.cc:608-609) and
    saves a film checkpoint; any process can later merge the folder with
    film.load_all_in_folder — associative sums, so order is irrelevant.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import jax

# NOTE: renderer modules are imported lazily inside render_node_film —
# jax.distributed.initialize() must run before anything touches the XLA
# backend, and importing the renderer builds device constants.


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Initialize JAX's multi-process runtime. Arguments left out are read
    from JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID;
    nothing is auto-detected, so a cluster names its coordinator (e.g.
    `localhost:<port>` on one host). Each process owns the cards it can
    see (one per process, e.g. through CUDA_VISIBLE_DEVICES): a JAX
    process reserves most of a card's memory, so two cannot share one.
    Returns (process_index, process_count). Call once per process before
    any computation."""
    kwargs = {}
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
    return jax.process_index(), jax.process_count()


def render_node_film(scene, cfg, width: int, height: int, spp: int,
                     node: int, out_dir: Optional[str] = None,
                     layer_names=("combined",)) -> F.Film:
    """Render this node's decorrelated share of the image and (optionally)
    checkpoint it into `out_dir` for the folder merge. The per-node
    sampling offset guarantees nodes draw disjoint sample streams for the
    same pixels, so the merged film equals a single-node render at
    aggregate spp (deterministic counter-based RNG)."""
    from .. import film as F
    from ..render import render
    film = F.make_film(width, height, layer_names, computer_node=node)
    film = render(scene, cfg, width, height, spp=spp, film=film)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        F.save_film(film, os.path.join(out_dir, f"node{node:04d}.film.npz"),
                    sampling_offset=film.base_sampling_offset + spp)
    return film
