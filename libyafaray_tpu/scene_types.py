"""Device-side scene representation: frozen struct-of-arrays pytrees.

This is the wavefront replacement for the reference's pointer-based scene
graph (include/scene/scene.h:64-219 and the Object/Primitive/Material/Light
class hierarchies). Host-side the `SceneBuilder` (scene.py) keeps the same
named-entity registries as the reference; `compile()` freezes everything into
these flat arrays so the whole wavefront of rays can be shaded with masked
vectorized table lookups — no virtual dispatch, no pointer chasing.

Static (non-traced) configuration lives in fields marked `pytree_node=False`
so JAX retraces only when the scene *structure* changes, not its parameters —
which also makes every numeric field a differentiable leaf for inverse
rendering.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from .utils import struct

Array = jax.Array

# --- material type enum (factory strings: src/material/material.cc:52-60) ---
MAT_SHINY_DIFFUSE = 0   # "shinydiffusemat"
MAT_GLOSSY = 1          # "glossy"
MAT_COATED_GLOSSY = 2   # "coated_glossy"
MAT_GLASS = 3           # "glass"
MAT_ROUGH_GLASS = 4     # "rough_glass"
MAT_MIRROR = 5          # "mirror"
MAT_NULL = 6            # "null"
MAT_LIGHT = 7           # "light_mat"
MAT_BLEND = 8           # "blend_mat"
MAT_MASK = 9            # "mask_mat"

# --- light type enum (factory strings: src/light/light.cc:46-55) ---
LIGHT_POINT = 0         # "pointlight"
LIGHT_SPHERE = 1        # "spherelight"
LIGHT_SPOT = 2          # "spotlight"
LIGHT_AREA = 3          # "arealight"
LIGHT_SUN = 4           # "sunlight"
LIGHT_DIRECTIONAL = 5   # "directional"
LIGHT_BACKGROUND = 6    # "bglight"
LIGHT_MESH = 7          # "meshlight"/"objectlight"
LIGHT_IES = 8           # "ieslight"
LIGHT_BGPORTAL = 9      # "bgPortalLight"

# --- BSDF component flags (include/material/material.h:44-63) ---
BSDF_NONE = 0
BSDF_SPECULAR = 1 << 0
BSDF_GLOSSY = 1 << 1
BSDF_DIFFUSE = 1 << 2
BSDF_DISPERSIVE = 1 << 3
BSDF_REFLECT = 1 << 4
BSDF_TRANSMIT = 1 << 5
BSDF_FILTER = 1 << 6
BSDF_EMIT = 1 << 7
BSDF_VOLUMETRIC = 1 << 8

# --- object visibility (reference: Visibility enum in geometry) ---
VIS_NORMAL = 0
VIS_INVISIBLE = 1
VIS_SHADOW_ONLY = 2
VIS_NO_SHADOWS = 3


@struct.dataclass
class Geometry:
    """Flat triangle soup + spheres; instances baked at compile time.

    Replaces MeshObject/TrianglePrimitive/SpherePrimitive/ObjectInstance
    (src/geometry/object/*, src/geometry/primitive/*). Per-face attribute
    arrays keep the wavefront's gathers coalesced.
    """
    vertices: Array        # f32[V, 3]
    normals: Array         # f32[V, 3] per-vertex smooth normals
    uvs: Array             # f32[U, 2] uv pool ([1,2] zero if unused)
    faces: Array           # i32[F, 3] vertex indices
    face_uvs: Array        # i32[F, 3] uv indices (0 if unused)
    face_mat: Array        # i32[F] material id
    face_obj: Array        # i32[F] object id
    face_smooth: Array     # bool[F] use smooth normals
    face_light: Array      # i32[F] area/mesh light id or -1
    # spheres: analytic primitives (object "sphere", primitive_sphere.cc:33)
    sph_center: Array      # f32[S, 3]
    sph_radius: Array      # f32[S]
    sph_mat: Array         # i32[S]
    sph_obj: Array         # i32[S]
    sph_light: Array       # i32[S] sphere light id or -1
    obj_visibility: Array  # i32[O]
    # per-primitive visibility bitmask: bit0 = visible to camera/bounce rays,
    # bit1 = casts shadows (derived from the reference Visibility enum)
    face_vis: Array        # i32[F]
    sph_vis: Array         # i32[S]
    # motion blur: extra vertex keyframes; rays carry a time in [0,1].
    # With one extra keyframe (vertices_t1 only) triangles interpolate
    # linearly; with two, positions follow the reference's 3-control-point
    # quadratic b-spline (primitive_triangle_bspline.cc:40-44:
    # p(t) = (1-t)^2 p0 + 2t(1-t) p1 + t^2 p2). None when static.
    vertices_t1: Optional[Array] = None   # f32[V, 3]
    vertices_t2: Optional[Array] = None   # f32[V, 3] (quadratic only)
    # object-space "original coordinates" per vertex (reference
    # addVertexWithOrco / SurfacePoint::orco, surface.h:54-150); None when no
    # mesh streamed them — SurfacePoint then falls back to untransformed
    # object-space positions baked in at compile.
    orcos: Optional[Array] = None         # f32[V, 3]
    # TRUE instancing (reference ObjectInstance/PrimitiveInstance,
    # include/geometry/object/object_instance.h:29-63): per-face arrays
    # above cover only the F0 = num_base_faces PHYSICAL faces; instances
    # contribute VIRTUAL face ids in [F0, num_faces) that resolve to
    # (base face, instance matrix) via resolve_prim(). Geometry memory
    # stays O(base). None/absent when every instance is baked.
    inst_mat: Optional[Array] = None        # f32[K, 3, 4] world<-object
    inst_inv: Optional[Array] = None        # f32[K, 3, 4] object<-world
    inst_nrm: Optional[Array] = None        # f32[K, 3, 3] inv-transpose rot
    inst_face_base: Optional[Array] = None  # i32[K] base face range start
    inst_face_off: Optional[Array] = None   # i32[K+1] virtual offsets,
                                            # off[0] = F0, cumulative
    inst_obj: Optional[Array] = None        # i32[K] instance object id
    # visibility bits of each INSTANCE copy (the static faces of an
    # is_base_object base are vis-0; instances carry the real bits)
    inst_vis: Optional[Array] = None        # i32[K]
    num_faces: int = struct.field(pytree_node=False, default=0)
    num_spheres: int = struct.field(pytree_node=False, default=0)
    has_motion: bool = struct.field(pytree_node=False, default=False)
    # physical per-face array length (== num_faces unless true instancing)
    num_base_faces: int = struct.field(pytree_node=False, default=0)


def resolve_prim(geom: "Geometry", prim: Array):
    """Virtual face id -> (base face id, instance id | -1).

    The analogue of PrimitiveInstance's base-primitive indirection
    (src/geometry/primitive/primitive_instance.cc) for flat SoA ids."""
    if geom.inst_mat is None:
        return prim, None
    f0 = geom.num_base_faces
    is_inst = prim >= f0
    k = jnp.searchsorted(geom.inst_face_off[1:], prim, side="right")
    k = jnp.clip(k, 0, geom.inst_face_base.shape[0] - 1).astype(jnp.int32)
    base = jnp.where(
        is_inst, geom.inst_face_base[k] + prim - geom.inst_face_off[k],
        prim)
    inst = jnp.where(is_inst, k, -1)
    return base, inst


def inst_transform_point(geom: "Geometry", inst: Array, p: Array) -> Array:
    """Apply instance matrix (world <- object) to points where inst >= 0."""
    m = geom.inst_mat[jnp.maximum(inst, 0)]             # [N, 3, 4]
    # elementwise multiply-sum, not a dot: full f32 on every backend
    q = jnp.sum(m[:, :, :3] * p[:, None, :], axis=-1) + m[:, :, 3]
    return jnp.where((inst >= 0)[..., None], q, p)


def inst_transform_normal(geom: "Geometry", inst: Array, n: Array) -> Array:
    """Rotate normals by the instance's inverse-transpose; renormalized."""
    m = geom.inst_nrm[jnp.maximum(inst, 0)]             # [N, 3, 3]
    q = jnp.sum(m * n[:, None, :], axis=-1)
    q = q / jnp.maximum(
        jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-20)
    return jnp.where((inst >= 0)[..., None], q, n)


@struct.dataclass
class MaterialTable:
    """SoA material parameter table; one row per named material.

    All BSDF models read the same named columns with per-type meaning
    documented in materials/. Every float column is differentiable.
    Replaces the Material class hierarchy (src/material/*).
    """
    mat_type: Array          # i32[M]
    bsdf_flags: Array        # i32[M] static capability flags
    diffuse_color: Array     # f32[M,3] diffuse/base color
    glossy_color: Array      # f32[M,3] glossy reflection color
    mirror_color: Array      # f32[M,3] specular reflection color
    filter_color: Array      # f32[M,3] glass transmission filter
    absorption: Array        # f32[M,3] glass Beer absorption sigma_a
    emit_color: Array        # f32[M,3] emission radiance
    specular_refl: Array     # f32[M] shiny-diffuse mirror strength
    transparency: Array      # f32[M] shiny-diffuse transparency
    translucency: Array      # f32[M] shiny-diffuse translucency
    diffuse_reflect: Array   # f32[M] diffuse weight
    glossy_reflect: Array    # f32[M] glossy weight
    exponent: Array          # f32[M] Blinn exponent
    exp_u: Array             # f32[M] anisotropic exponent u
    exp_v: Array             # f32[M] anisotropic exponent v
    alpha: Array             # f32[M] GGX roughness alpha (rough glass)
    ior: Array               # f32[M] index of refraction
    dispersion: Array        # f32[M] dispersion power (glass)
    mat_flags: Array         # i32[M] bit0 fresnel_effect, bit1 anisotropic,
                             #        bit2 as_diffuse, bit3 fake_shadows,
                             #        bit4 receive_shadows off
    sigma: Array             # f32[M] Oren-Nayar sigma (glossy diffuse)
    wireframe: Array         # f32[M,3]+thickness packed: [M,4] unused->0
    blend_a: Array           # i32[M] blend/mask submaterial 1
    blend_b: Array           # i32[M] blend/mask submaterial 2
    blend_value: Array       # f32[M] blend factor / mask threshold
    sampling_factor: Array   # f32[M]
    # shader-node bindings: node-program output slot driving each channel,
    # -1 = use the constant column above (reference NodeMaterial, material_node.cc)
    node_diffuse: Array      # i32[M]
    node_glossy: Array       # i32[M]
    node_mirror: Array       # i32[M]
    node_bump: Array         # i32[M]
    node_transparency: Array # i32[M]
    node_translucency: Array # i32[M]
    node_mirror_strength: Array  # i32[M]
    node_sigma_oren: Array   # i32[M]
    node_diffuse_reflect: Array  # i32[M]
    node_glossy_reflect: Array   # i32[M]
    node_blend: Array        # i32[M] blend-factor node (blend_mat)
    node_exponent: Array     # i32[M]
    node_ior: Array          # i32[M]
    node_filter_color: Array # i32[M]
    num_materials: int = struct.field(pytree_node=False, default=0)
    # static capability hints so blend/mask machinery traces only when used
    has_blend: bool = struct.field(pytree_node=False, default=False)
    has_mask: bool = struct.field(pytree_node=False, default=False)
    # trace-time specialization: the set of mat_type values present in the
    # scene (empty tuple = unknown -> assume all). Lobe math for absent
    # material families is never traced, so e.g. an all-diffuse scene pays
    # no GGX/Blinn/refract VPU work per bounce.
    present_types: tuple = struct.field(pytree_node=False, default=())
    # any row with Oren-Nayar sigma > 0 (or a sigma node bound)
    has_oren: bool = struct.field(pytree_node=False, default=True)
    # any row with the anisotropic flag
    has_aniso: bool = struct.field(pytree_node=False, default=True)
    # any row with fresnel_effect set (shiny-diffuse fresnel mirror weight)
    has_fresnel: bool = struct.field(pytree_node=False, default=True)
    # interior volume handlers (reference VolumeHandler factory
    # volume/volume.cc:58-59: 'beer' Beer-law absorption, 'sss'
    # single-scatter): per-material scatter color + mean free path;
    # sss_dist 0 = no interior scattering. Static flags gate the
    # bounce-loop medium tracking so scenes without dielectric interiors
    # pay nothing.
    sss_scatter_col: Optional[Array] = None  # f32[M,3]
    sss_dist: Optional[Array] = None         # f32[M]
    has_beer: bool = struct.field(pytree_node=False, default=False)
    has_sss: bool = struct.field(pytree_node=False, default=False)


@struct.dataclass
class LightTable:
    """SoA light table. Replaces the Light class hierarchy (src/light/*)."""
    light_type: Array       # i32[L]
    position: Array         # f32[L,3] (area light corner; point/sphere/spot pos)
    direction: Array        # f32[L,3] (spot/sun/directional dir; area normal)
    color: Array            # f32[L,3] radiance/intensity premultiplied by power
    edge1: Array            # f32[L,3] area light edge vectors
    edge2: Array            # f32[L,3]
    radius: Array           # f32[L] sphere/sun/directional radius
    cos_start: Array        # f32[L] spot inner cone cos / sun cos_angle
    cos_end: Array          # f32[L] spot outer cone cos
    falloff: Array          # f32[L] spot falloff exponent
    area: Array             # f32[L] precomputed light area
    flags: Array            # i32[L] bit0 cast_shadows, bit1 light_enabled,
                            #        bit2 photon_only, bit3 double_sided
    samples: Array          # i32[L] requested nSamples
    obj_id: Array           # i32[L] mesh-light source object (-1)
    tri_start: Array        # i32[L] first face index of mesh light
    tri_count: Array        # i32[L]
    ies_id: Array           # i32[L] IES profile index into ies_pool (-1)
    ies_pool: Array         # f32[P, IES_RES_H, IES_RES] candela grids
                            # (periodic horizontal x clamped vertical)
    # per-face normalized cumulative triangle areas within each mesh/portal
    # light's face range (area-CDF pick, light_object_light.cc Pdf1D);
    # f32[num_faces] aligned with geom.faces, 0 outside light ranges.
    tri_cdf: Optional[Array] = None
    num_lights: int = struct.field(pytree_node=False, default=0)
    # background light (importance-sampled env) is flagged by type; its
    # distribution tables live in Background
    bg_light_idx: int = struct.field(pytree_node=False, default=-1)
    # static copy of per-light `samples` so integrators can unroll the
    # per-light NEE loops (reference Light::nSamples, honored by
    # estimateAllDirectLight's num_samples loop,
    # integrator_montecarlo.cc:156-230); empty = 1 sample per light
    samples_static: tuple = struct.field(pytree_node=False, default=())
    # trace-time specialization: light_type values present in the scene
    # (empty tuple = unknown -> assume all); sample/pdf math for absent
    # light families is never traced.
    present_types: tuple = struct.field(pytree_node=False, default=())


@struct.dataclass
class Background:
    """Tagged background. `kind` is static: the active background's eval is
    traced directly (no masking across background types — there is only one
    per scene, like the reference's single Scene background).
    Replaces src/background/* (constant/gradient/sunsky/darksky/textureback).
    """
    kind: str = struct.field(pytree_node=False, default="constant")
    color: Array = None            # f32[3] constant color * power
    horizon_color: Array = None    # gradient
    zenith_color: Array = None
    ground_horizon_color: Array = None
    ground_zenith_color: Array = None
    # texture background
    tex_id: int = struct.field(pytree_node=False, default=-1)
    rotation: Array = None         # f32 rotation around z (radians)
    mapping: str = struct.field(pytree_node=False, default="sphere")  # or "angular"
    power: Array = None            # f32 multiplier
    # sunsky params (Preetham): precomputed coefficient vectors
    sunsky: Any = None             # optional SunSky struct
    # env importance-sampling tables (built for bglight): alias method
    env_alias_prob: Array = None   # f32[H*W]
    env_alias_idx: Array = None    # i32[H*W]
    env_pdf: Array = None          # f32[H*W] solid-angle pdf per texel
    env_shape: Tuple[int, int] = struct.field(pytree_node=False, default=(0, 0))
    ibl_blur: Array = None         # f32 mipmap-lod style blur amount


@struct.dataclass
class Camera:
    """Tagged camera; `kind` static ("perspective"/"architect"/"orthographic"/
    "angular"/"equirectangular"), replaces src/camera/* hierarchy."""
    kind: str = struct.field(pytree_node=False, default="perspective")
    origin: Array = None         # f32[3]
    cam_x: Array = None          # f32[3] right
    cam_y: Array = None          # f32[3] up
    cam_z: Array = None          # f32[3] forward (look dir, unit)
    focal: Array = None          # f32 focal distance in screen units
    aperture: Array = None       # f32 DOF aperture radius
    dof_distance: Array = None   # f32 focus distance
    aspect: Array = None         # f32 aspect ratio factor
    angle: Array = None          # f32 angular-camera angle (radians)
    # angular camera extras (camera_angular.cc): clip radius in units of
    # the image half-width (max_angle/angle), circular mask, x-mirror
    max_radius: Array = None     # f32
    circular: bool = struct.field(pytree_node=False, default=True)
    mirrored: bool = struct.field(pytree_node=False, default=False)
    ortho_scale: Array = None    # f32
    near_clip: Array = None      # f32
    far_clip: Array = None       # f32
    bokeh_kind: str = struct.field(pytree_node=False, default="disk")
    bokeh_rotation: Array = None # f32
    angular_projection: str = struct.field(pytree_node=False, default="equidistant")
    resx: int = struct.field(pytree_node=False, default=256)
    resy: int = struct.field(pytree_node=False, default=256)


@struct.dataclass
class TexturePool:
    """All image textures flattened into one texel pool (with mip chains),
    plus SoA parameter tables for procedural textures. Replaces src/texture/*.

    Image texture t occupies texels [img_offset[t], img_offset[t]+W*H) per mip
    level, row-major; mip level l of texture t starts at mip_offset[t, l].
    """
    # texel storage dtype implements the reference's image_optimization
    # levels (include/image/image.h:47-48): "none" -> f32, "optimized" ->
    # f16 (half RAM), "compressed" -> u8 quantized with per-texture scale
    # (quarter RAM). The weakest optimization requested by any image
    # texture wins so nothing is stored below its requested precision.
    texel_pool: Array          # f32|f16|u8[T_total, 4] rgba linear
    texel_scale: Array         # f32[T] dequant scale (1.0 unless u8 pool)
    img_offset: Array          # i32[T] base offset of mip 0
    img_width: Array           # i32[T]
    img_height: Array          # i32[T]
    mip_offsets: Array         # i32[T, MAX_MIPS] offsets of each mip (-1 none)
    num_mips: Array            # i32[T]
    # unified per-texture parameter table (procedural + image)
    tex_type: Array            # i32[T] TEX_* enum (textures/__init__)
    params_f: Array            # f32[T, 16] type-specific scalar params
    params_c: Array            # f32[T, 2, 4] two RGBA colors (color1/color2)
    ramp_pos: Array            # f32[T, RAMP_MAX] color-ramp positions
    ramp_col: Array            # f32[T, RAMP_MAX, 4]
    ramp_count: Array          # i32[T] 0 = no ramp
    ramp_mode: Array           # i32[T] 0 rgb,1 hsv,2 hsl interpolation
    interp: Array              # i32[T] 0 none,1 bilinear,2 bicubic,3 trilinear,4 EWA
    extend: Array              # i32[T] 0 repeat,1 extend/clamp,2 clip,3 checker
    gamma_applied: Array       # already-linearized marker (informational)
    # post adjustments (reference adj_* params, texture.h applyAdjustments):
    # [mult_r, mult_g, mult_b, intensity, contrast, saturation, hue, clamp]
    adj: Array = None          # f32[T, 8]
    num_textures: int = struct.field(pytree_node=False, default=0)
    # static info so eval traces only the texture types / noise bases present
    used_types: Tuple[int, ...] = struct.field(pytree_node=False, default=())
    used_noise: Tuple[int, ...] = struct.field(pytree_node=False, default=())
    max_octaves: int = struct.field(pytree_node=False, default=2)
    # the set of image-interpolation modes present (keys of _INTERP):
    # sample_image traces the trilinear/EWA machinery (2 / 17 extra
    # bilinear probes per lane) only when a texture actually uses it
    used_interps: Tuple[int, ...] = struct.field(pytree_node=False,
                                                 default=(0, 1, 2, 3, 4))


@struct.dataclass
class NodeProgram:
    """Topologically-sorted shader-node DAG compiled to a flat instruction
    table, executed by a static python loop at trace time (materials/nodes.py).
    Replaces ShaderNode/NodeMaterial interpretation (src/shader/*,
    src/material/material_node.cc:55-102)."""
    node_type: Array    # i32[N] NODE_* enum
    tex_id: Array       # i32[N] texture for texture_mapper nodes (-1)
    in_a: Array         # i32[N] input node slot (-1 -> constant)
    in_b: Array         # i32[N]
    in_fac: Array       # i32[N] factor input node
    const_a: Array      # f32[N, 4] constant color A
    const_b: Array      # f32[N, 4]
    const_fac: Array    # f32[N]
    params_f: Array     # f32[N, 24] mapper params (matrix, scale, offset, ...)
    params_i: Array     # i32[N, 8]  mapper enums (coords, projection, blend mode)
    num_nodes: int = struct.field(pytree_node=False, default=0)
    # static copies of the dataflow-controlling columns so the evaluator's
    # python loop specializes per node at trace time:
    # meta[i] = (node_type, in_a, in_b, in_fac, tex_id)
    meta: Tuple[Tuple[int, int, int, int, int], ...] = struct.field(
        pytree_node=False, default=())
    # imeta[i] = tuple(params_i[i]) (coords/projection/blend-mode/flags)
    imeta: Tuple[Tuple[int, ...], ...] = struct.field(
        pytree_node=False, default=())
    # static: does any material bind a bump node? (skips the 2 extra
    # program evaluations of eval_bump when false)
    has_bump: bool = struct.field(pytree_node=False, default=False)


@struct.dataclass
class VolumeTable:
    """SoA volume regions (src/volume/*): uniform/exp/noise/grid density in an
    AABB + per-material Beer/SSS handlers."""
    vol_type: Array      # i32[R] 0 uniform,1 expdensity,2 noise,3 grid,4 sky
    bmin: Array          # f32[R,3]
    bmax: Array          # f32[R,3]
    sigma_a: Array       # f32[R,3]
    sigma_s: Array       # f32[R,3]
    emission: Array      # f32[R,3]
    g: Array             # f32[R] phase asymmetry
    params_f: Array      # f32[R, 8] (a, b for exp; sharpness/cover for noise)
    noise_tex: Array     # i32[R] texture id for noise volume (-1)
    grid_id: Array       # i32[R] density grid index (-1)
    grids: Array         # f32[G, D, H, W] density grids (zero-size if unused)
    att_grid_scale: int = struct.field(pytree_node=False, default=1)
    num_volumes: int = struct.field(pytree_node=False, default=0)


@struct.dataclass
class BVH:
    """LBVH arrays (accel/lbvh.py): 2*F-1 nodes, leaves reference the
    morton-sorted primitive order. Replaces the SAH kd-tree
    (src/accelerator/accelerator_kdtree.cc) with a GPU-classic
    Karras-style linear BVH."""
    node_min: Array      # f32[NN, 3]
    node_max: Array      # f32[NN, 3]
    node_left: Array     # i32[NN]  (internal: child idx; leaf: prim idx)
    node_right: Array    # i32[NN]
    node_is_leaf: Array  # bool[NN]
    prim_order: Array    # i32[F] morton-sorted primitive ids
    num_nodes: int = struct.field(pytree_node=False, default=0)


@struct.dataclass
class PhotonData:
    """Preprocessed photon maps (PhotonIntegrator::preprocess output):
    diffuse (indirect, non-caustic) + caustic maps, photon.PhotonMap each;
    `radiance` is the precomputed final-gather radiance cache (the "FG
    Radiance Photon Map", integrator_photon_mapping.cc:106-107,353-399) —
    a PhotonMap whose dir=surface normal and power=outgoing radiance."""
    diffuse: Any
    caustic: Any
    radiance: Any = None
    n_emitted: int = struct.field(pytree_node=False, default=0)


@struct.dataclass
class SceneData:
    """Everything the integrator needs, as one frozen pytree."""
    geom: Geometry
    materials: MaterialTable
    lights: LightTable
    background: Background
    camera: Camera
    textures: Optional[TexturePool] = None
    nodes: Optional[NodeProgram] = None
    volumes: Optional[VolumeTable] = None
    bvh: Optional[BVH] = None
    blocks: Any = None  # accel.blocks.BlockAccel (morton-block tables)
    photons: Optional[PhotonData] = None
    # which accelerator the intersect ops use: "blocks" | "bvh" | "brute"
    accel_kind: str = struct.field(pytree_node=False, default="brute")
    # any primitive flagged invisible-to-camera (face_vis bit 4 — area
    # lights with visibility='invisible', the reference's arealight
    # semantics where lights are never scene primitives)? Static so
    # ordinary scenes trace no extra code (ops.intersect.camera_hit).
    has_cam_invisible: bool = struct.field(pytree_node=False, default=False)
    shadow_bias: Array = None   # f32 scalar
    ray_min_dist: Array = None  # f32 scalar
    # per-view fixed spectral wavelength in [0,1]; 0 = sample per path
    # (RenderView::isSpectral, render_view.h:47-48)
    fixed_wavelength: Array = None  # f32 scalar
    # angular size of one pixel (for primary-hit texture footprints /
    # mipmap LOD; the reference carries ray differentials instead)
    pixel_spread: Array = None  # f32 scalar
    # per-light volume attenuation cache (atten[L,G,G,G,3], bmin, bmax);
    # SingleScatterIntegrator "optimize" grid (integrator_single_scatter.cc)
    vol_atten: Any = None
