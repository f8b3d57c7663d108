"""Image film: weighted sample accumulation, reconstruction filters, AOVs.

Replaces the reference `ImageFilm` (src/render/imagefilm.cc): per-layer color
accumulators + weight buffer, Box/Mitchell/Gauss/Lanczos reconstruction
filters (imagefilm.cc:133-162 builds a lookup table; we evaluate the kernels
directly per tap — cheap on the VPU), and film checkpoint/merge. Splatting is
a deterministic `scatter-add` over the whole wavefront instead of the
reference's mutex-hazard per-thread splat (imagefilm.cc:677-721); multi-chip
film merge is a `psum` (the device-mesh analogue of imageFilmLoadAllInFolder's
weight+color summation, imagefilm.cc:940-1008).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .utils import struct

Array = jax.Array

FILM_HEADER = "YAF_TPU_FILM_v1"

# layer name -> channel count; a practical subset of the reference's ~75
# layer types (include/common/layer_definitions.h:36-111)
LAYER_CHANNELS = {
    "combined": 4,
    "diffuse": 3,
    "emit": 3,
    "env": 3,
    "indirect": 3,
    "shadow": 3,
    "ao": 3,
    "z-depth-norm": 1,
    "z-depth-abs": 1,
    "normal-geom": 3,
    "normal-smooth": 3,
    "albedo": 3,
    "uv": 3,
    "mat-index-abs": 1,
    "obj-index-abs": 1,
    "debug-nu": 3,
    "debug-nv": 3,
    "debug-dpdu": 3,
    "debug-dpdv": 3,
    "debug-dsdu": 3,
    "debug-dsdv": 3,
    "debug-dpdx": 3,
    "debug-dpdy": 3,
    "debug-dpdxy": 3,
    "debug-barycentric-uvw": 3,
    "debug-wireframe": 3,
    "mist": 1,
    "mat-index-norm": 1,
    "obj-index-norm": 1,
    "mat-index-auto": 3,
    "obj-index-auto": 3,
    "mat-index-auto-abs": 3,
    "obj-index-auto-abs": 3,
    "mat-index-mask": 3,
    "obj-index-mask": 3,
    "diffuse-noshadow": 3,
    "diffuse-indirect": 3,
    "glossy-indirect": 3,
    "ao-clay": 3,
    "debug-aa-samples": 1,
    "debug-faces-edges": 3,
    "debug-objects-edges": 3,
    "toon": 3,
    "reflect": 3,
    "refract": 3,
    # adv-* layers (layer_definitions.cc:53-98): per-BSDF-family direct
    # splits, first-bounce-lobe indirect splits, photon radiance, perfect
    # specular pair, volume decomposition
    "adv-diffuse-color": 3,
    "adv-diffuse-indirect": 3,
    "adv-glossy": 3,
    "adv-glossy-color": 3,
    "adv-glossy-indirect": 3,
    "adv-indirect": 3,
    "adv-radiance": 3,
    "adv-reflect": 3,
    "adv-refract": 3,
    "adv-subsurface": 3,
    "adv-subsurface-color": 3,
    "adv-subsurface-indirect": 3,
    "adv-surface-integration": 3,
    "adv-trans": 3,
    "adv-trans-color": 3,
    "adv-trans-indirect": 3,
    "adv-volume-integration": 3,
    "adv-volume-transmittance": 1,
    # index-mask composites
    "mat-index-mask-all": 3,
    "mat-index-mask-shadow": 3,
    "obj-index-mask-all": 3,
    "obj-index-mask-shadow": 3,
    # debug layers (layer_definitions.cc:29-52)
    "debug-dp-lengths": 3,
    "debug-dudx-dvdx": 3,
    "debug-dudy-dvdy": 3,
    "debug-dudxy-dvdxy": 3,
    "debug-light-estimation-light-dirac": 3,
    "debug-light-estimation-light-sampling": 3,
    "debug-light-estimation-mat-sampling": 3,
    "debug-sampling-factor": 1,
    # reference-name aliases for layers whose short names predate them
    "debug-uv": 3,
    "debug-normal-geom": 3,
    "debug-normal-smooth": 3,
}


@struct.dataclass
class Film:
    weights: Array                  # f32[H, W]
    layers: Dict[str, Array]        # name -> f32[H, W, C]
    # light-tracing splat accumulator (BDPT t=0 strategies): raw sums of
    # camera splats + the number of light subpaths traced; resolved as
    # combined += splat / paths (the reference splats into the film under
    # a mutex, imagefilm.cc:677-721 — here it's a scatter-add)
    splat: Optional[Array] = None         # f32[H, W, 3]
    splat_paths: Optional[Array] = None   # f32[] count of light subpaths
    flt_kind: str = struct.field(pytree_node=False, default="box")
    flt_width: float = struct.field(pytree_node=False, default=1.0)
    base_sampling_offset: int = struct.field(pytree_node=False, default=0)
    computer_node: int = struct.field(pytree_node=False, default=0)

    @property
    def height(self) -> int:
        return self.weights.shape[0]

    @property
    def width(self) -> int:
        return self.weights.shape[1]


def make_film(width: int, height: int, layer_names=("combined",),
              flt_kind: str = "box", flt_width: float = 1.0,
              computer_node: int = 0) -> Film:
    layers = {}
    for name in layer_names:
        c = LAYER_CHANNELS[name]
        layers[name] = jnp.zeros((height, width, c), jnp.float32)
    return Film(weights=jnp.zeros((height, width), jnp.float32), layers=layers,
                splat=jnp.zeros((height, width, 3), jnp.float32),
                splat_paths=jnp.zeros((), jnp.float32),
                flt_kind=flt_kind, flt_width=float(flt_width),
                computer_node=computer_node,
                base_sampling_offset=computer_node * 100_000)


# --- reconstruction filter kernels (include/math/filter.h) ---

def _mitchell(x: Array) -> Array:
    """Mitchell-Netravali B=C=1/3 on |x| in [0,2]."""
    x = jnp.abs(2.0 * x)  # reference normalizes to filter width
    x2 = x * x
    x3 = x2 * x
    b = c = 1.0 / 3.0
    inner = ((12.0 - 9.0 * b - 6.0 * c) * x3
             + (-18.0 + 12.0 * b + 6.0 * c) * x2 + (6.0 - 2.0 * b)) / 6.0
    outer = ((-b - 6.0 * c) * x3 + (6.0 * b + 30.0 * c) * x2
             + (-12.0 * b - 48.0 * c) * x + (8.0 * b + 24.0 * c)) / 6.0
    return jnp.where(x < 1.0, inner, jnp.where(x < 2.0, outer, 0.0))


def _gauss(x: Array) -> Array:
    alpha = 2.0
    x = jnp.abs(2.0 * x)
    return jnp.maximum(jnp.exp(-alpha * x * x) - jnp.exp(-alpha * 4.0), 0.0)


def _lanczos(x: Array) -> Array:
    x = jnp.abs(2.0 * x)
    px = jnp.pi * x
    s = jnp.where(x > 1e-5, jnp.sin(px) / jnp.maximum(px, 1e-9), 1.0)
    s2 = jnp.where(x > 1e-5, jnp.sin(px * 0.5) / jnp.maximum(px * 0.5, 1e-9), 1.0)
    return jnp.where(x < 2.0, s * s2, 0.0)


def filter_weight(kind: str, dx: Array, dy: Array, width: float) -> Array:
    """Normalized 2D separable filter value at offset (dx, dy), |d| <= width."""
    if kind == "box":
        return jnp.ones_like(dx)
    r = {"mitchell": _mitchell, "gauss": _gauss, "lanczos": _lanczos}[kind]
    return r(dx / width * 0.5) * r(dy / width * 0.5)


def _tap_offsets(kind: str, width: float):
    if kind == "box" or width <= 0.5:
        return [(0, 0)]
    n = int(np.ceil(width - 0.5))
    return [(dy, dx) for dy in range(-n, n + 1) for dx in range(-n, n + 1)]


def add_samples(film: Film, px: Array, py: Array,
                layer_values: Dict[str, Array], weight: Array) -> Film:
    """Splat a wavefront of samples at continuous pixel coords (px, py).

    ImageFilm::addSample analogue: for each filter tap, scatter-add
    w*value into the layer buffers and w into the weight buffer. `weight`
    additionally masks dead lanes (0 weight)."""
    h, w = film.height, film.width
    ix = jnp.floor(px).astype(jnp.int32)
    iy = jnp.floor(py).astype(jnp.int32)
    fx = px - ix.astype(jnp.float32) - 0.5
    fy = py - iy.astype(jnp.float32) - 0.5

    weights = film.weights
    layers = dict(film.layers)
    for (dy, dx) in _tap_offsets(film.flt_kind, film.flt_width):
        tx = ix + dx
        ty = iy + dy
        in_img = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
        fw = filter_weight(film.flt_kind, dx - fx, dy - fy, film.flt_width)
        wgt = jnp.where(in_img, fw * weight, 0.0)
        txc = jnp.clip(tx, 0, w - 1)
        tyc = jnp.clip(ty, 0, h - 1)
        weights = weights.at[tyc, txc].add(wgt)
        for name, val in layer_values.items():
            layers[name] = layers[name].at[tyc, txc].add(val * wgt[..., None])
    return film.replace(weights=weights, layers=layers)


# layers computed at flush from other layers / the weight buffer rather
# than accumulated per sample (ImageFilm::flush edge/toon post,
# image_manipulation.cc:103-113; debug-aa-samples from the sample counts)
FLUSH_LAYERS = ("debug-aa-samples", "debug-faces-edges",
                "debug-objects-edges", "toon")


def resolve(film: Film, layer: str = "combined") -> Array:
    """Normalize accumulated layer by weights (ImageFilm::flush normalize).
    A few debug layers are derived at flush instead of accumulated."""
    w = jnp.maximum(film.weights, 1e-12)[..., None]
    if layer == "debug-aa-samples":
        return film.weights[..., None]
    if layer in ("debug-faces-edges", "debug-objects-edges", "toon"):
        import numpy as np
        from .io import postprocess as PP
        if layer == "debug-objects-edges" and "obj-index-abs" in film.layers:
            src = np.asarray(film.layers["obj-index-abs"] / w)
            e = PP.sobel_edges(np.repeat(src, 3, axis=-1), 1e-4)
            return jnp.asarray(np.repeat(e[..., None], 3, axis=-1))
        base = "normal-geom" if "normal-geom" in film.layers else "combined"
        src = np.asarray(film.layers[base] / w)[..., :3]
        if layer == "toon":
            return jnp.asarray(PP.toon(src))
        e = PP.sobel_edges(src, 0.3)
        return jnp.asarray(np.repeat(e[..., None], 3, axis=-1))
    out = film.layers[layer] / w
    if (layer == "combined" and film.splat is not None
            and film.splat_paths is not None):
        # light-tracing splats: mean over traced light subpaths
        out = out.at[..., :3].add(
            film.splat / jnp.maximum(film.splat_paths, 1.0))
    return out


def add_splats(film: Film, px: Array, py: Array, rgb: Array,
               n_paths) -> Film:
    """Scatter light-tracing camera splats (BDPT t=0 strategies) into the
    splat accumulator. Unlike add_samples these carry no filter weight —
    they are normalized by the TOTAL number of light subpaths at resolve."""
    if film.splat is None:
        return film
    h, w = film.height, film.width
    ix = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, w - 1)
    iy = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, h - 1)
    return film.replace(
        splat=film.splat.at[iy, ix].add(rgb),
        splat_paths=film.splat_paths + jnp.float32(n_paths))


def merge(films) -> Film:
    """Sum weights + accumulators across films — the in-memory analogue of the
    reference's multi-node film-folder merge (imageFilmLoadAllInFolder)."""
    out = films[0]
    for f in films[1:]:
        out = out.replace(
            weights=out.weights + f.weights,
            layers={k: out.layers[k] + f.layers[k] for k in out.layers},
            splat=(out.splat + f.splat if out.splat is not None
                   and f.splat is not None else out.splat),
            splat_paths=(out.splat_paths + f.splat_paths
                         if out.splat_paths is not None
                         and f.splat_paths is not None else out.splat_paths),
        )
    return out


def psum_merge(film: Film, axis_name: str) -> Film:
    """Cross-device film merge inside shard_map/pjit: the all-reduce *is* the
    film merge (SURVEY.md par.2.15)."""
    return film.replace(
        weights=jax.lax.psum(film.weights, axis_name),
        layers={k: jax.lax.psum(v, axis_name) for k, v in film.layers.items()},
        splat=(jax.lax.psum(film.splat, axis_name)
               if film.splat is not None else None),
        splat_paths=(jax.lax.psum(film.splat_paths, axis_name)
                     if film.splat_paths is not None else None),
    )


# --- film checkpoint/resume (reference .film files, imagefilm.cc:827-1020) ---

def save_film(film: Film, path: str, sampling_offset: int = 0) -> None:
    arrs = {"__weights__": np.asarray(film.weights)}
    if film.splat is not None:
        arrs["__splat__"] = np.asarray(film.splat)
        arrs["__splat_paths__"] = np.asarray(film.splat_paths)
    for k, v in film.layers.items():
        arrs[f"layer.{k}"] = np.asarray(v)
    np.savez_compressed(
        path, __header__=FILM_HEADER, __node__=film.computer_node,
        __sampling_offset__=sampling_offset,
        __flt__=f"{film.flt_kind}:{film.flt_width}", **arrs)


def load_film(path: str) -> Tuple[Film, int]:
    data = np.load(path, allow_pickle=False)
    if str(data["__header__"]) != FILM_HEADER:
        raise ValueError(f"bad film header in {path}")
    flt_kind, flt_width = str(data["__flt__"]).split(":")
    layers = {}
    for k in data.files:
        if k.startswith("layer."):
            layers[k[len("layer."):]] = jnp.asarray(data[k])
    film = Film(weights=jnp.asarray(data["__weights__"]), layers=layers,
                splat=(jnp.asarray(data["__splat__"])
                       if "__splat__" in data.files else None),
                splat_paths=(jnp.asarray(data["__splat_paths__"])
                             if "__splat_paths__" in data.files else None),
                flt_kind=flt_kind, flt_width=float(flt_width),
                computer_node=int(data["__node__"]))
    return film, int(data["__sampling_offset__"])


def load_all_in_folder(folder: str) -> Tuple[Film, int]:
    """Merge every film checkpoint in `folder` (render-farm node outputs),
    mirroring imageFilmLoadAllInFolder:940-1008."""
    import glob
    import os
    films = []
    offset = 0
    for p in sorted(glob.glob(os.path.join(folder, "*.film.npz"))):
        f, off = load_film(p)
        films.append(f)
        offset = max(offset, off)
    if not films:
        raise FileNotFoundError(f"no *.film.npz in {folder}")
    return merge(films), offset
