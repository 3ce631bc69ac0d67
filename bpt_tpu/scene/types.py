"""Frozen device-array scene representation.

The reference's pointer-based object graph (hittable/material shared_ptr webs,
src/objects/hittable.h, src/materials/material.h) is flattened once on host
into SoA arrays; the render loop only ever sees these frozen pytrees.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

# Material type ids (reference classes, src/materials/material.h:42-172)
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_LIGHT = 3
MAT_ISOTROPIC = 4

# Texture kinds (reference classes, src/materials/textures/texture.h:14-87)
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3


def _register(cls, meta_fields=()):
    data_fields = [
        f.name for f in dataclasses.fields(cls) if f.name not in meta_fields
    ]
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=list(meta_fields)
    )
    return cls


@dataclass(frozen=True)
class TextureTable:
    """Texture parameter SoA (src/materials/textures/texture.h:7-87).

    kind[K] selects solid/checker/image/noise; unused params are zero.
    Image texels live in a padded atlas ``images[I, Hmax, Wmax, 3]`` (uint8
    values as float, 0..255) with per-image true dims — fetch is the
    reference's clamped nearest-neighbor lookup (texture.h:57-73).
    Perlin lattice tables (texture.h:76-87, perlin.h) are baked at build.
    """

    kind: jax.Array  # [K] int32
    color0: jax.Array  # [K,3] solid color / checker even
    color1: jax.Array  # [K,3] checker odd
    scale: jax.Array  # [K] checker scale (world units) or noise scale
    img_id: jax.Array  # [K] int32 index into images (or 0)
    images: jax.Array  # [I, Hmax, Wmax, 3] float, 0..255
    img_h: jax.Array  # [I] int32
    img_w: jax.Array  # [I] int32
    perlin_randvec: jax.Array  # [256, 3]
    perlin_perm: jax.Array  # [3, 256] int32 (x, y, z permutations)


_register(TextureTable)


@dataclass(frozen=True)
class MaterialTable:
    """Branchless material parameter table.

    Replaces virtual dispatch on ``material`` subclasses
    (src/materials/material.h:16-40) with per-lane type ids + masked eval.
    ``albedo`` doubles as emission for MAT_LIGHT.  ``tex_id`` < 0 means the
    solid ``albedo`` column; >= 0 indexes the TextureTable.
    """

    mtype: jax.Array  # [M] int32
    albedo: jax.Array  # [M,3]
    fuzz: jax.Array  # [M]  (metal)
    ior: jax.Array  # [M]  (dielectric)
    tex_id: jax.Array  # [M] int32


_register(MaterialTable)


@dataclass(frozen=True)
class SceneArrays:
    """Flattened triangle scene + BVH + light tables.

    Triangles are stored in BVH-sorted order so leaves reference contiguous
    ranges.  The BVH mirrors the reference build policy exactly (median split
    on longest axis, sort by bbox-min; src/acceleration/bvh.h:20-48) but is
    threaded in DFS order with skip links so device traversal needs no stack:
    at node i, an AABB hit descends to i+1, a miss jumps to skip[i] — the
    visit order and t-max shrinking match bvh_node::hit (bvh.h:50-59).
    """

    # triangle SoA (src/objects/primatives/triangle.h:19-39)
    v0: jax.Array  # [T,3]
    e1: jax.Array  # [T,3]
    e2: jax.Array  # [T,3]
    normal: jax.Array  # [T,3] geometric unit normal
    area: jax.Array  # [T]
    mat_id: jax.Array  # [T] int32
    tri_uv: jax.Array  # [T,6] per-vertex texture UVs; default reproduces
    # barycentric passthrough (hit u,v unchanged)

    # threaded-DFS BVH
    bvh_min: jax.Array  # [N,3]
    bvh_max: jax.Array  # [N,3]
    bvh_skip: jax.Array  # [N] int32
    bvh_first: jax.Array  # [N] int32 (leaf: first triangle)
    bvh_count: jax.Array  # [N] int32 (0 = internal)

    # lights (sample_surface CDF, triangle.h:199-224 made O(log L));
    # light triangle SoA duplicated for gather-free sampling/pdf eval
    light_idx: jax.Array  # [L] int32 indices into triangle arrays
    light_cdf: jax.Array  # [L] inclusive prefix sum of light areas
    light_total_area: jax.Array  # [] scalar
    light_v0: jax.Array  # [L,3]
    light_e1: jax.Array  # [L,3]
    light_e2: jax.Array  # [L,3]
    light_normal: jax.Array  # [L,3]
    light_area: jax.Array  # [L]
    light_mat: jax.Array  # [L] int32

    materials: MaterialTable
    textures: TextureTable
    background: jax.Array  # [3]

    # constant-density volumes (constant_medium, src/materials/volumes/
    # constant_medium.h): boundary triangle soup kept OUT of the surface
    # arrays (rays pass through; interaction is sampled exponentially)
    vol_v0: jax.Array  # [VT,3]
    vol_e1: jax.Array  # [VT,3]
    vol_e2: jax.Array  # [VT,3]
    vol_tri_vol: jax.Array  # [VT] int32 — owning volume id
    vol_neg_inv_density: jax.Array  # [V] = -1/density
    vol_mat: jax.Array  # [V] int32 — isotropic phase material id

    # static metadata
    num_tris: int = field(metadata=dict(static=True), default=0)
    num_lights: int = field(metadata=dict(static=True), default=0)
    num_volumes: int = field(metadata=dict(static=True), default=0)
    use_bvh: bool = field(metadata=dict(static=True), default=True)
    has_textures: bool = field(metadata=dict(static=True), default=False)
    has_noise: bool = field(metadata=dict(static=True), default=False)
    lights_are_world: bool = field(metadata=dict(static=True), default=False)

    @property
    def dtype(self):
        return self.v0.dtype


_register(
    SceneArrays,
    meta_fields=(
        "num_tris",
        "num_lights",
        "num_volumes",
        "use_bvh",
        "has_textures",
        "has_noise",
        "lights_are_world",
    ),
)


@dataclass(frozen=True)
class CameraConfig:
    """Host-side camera config — mirror of the reference's public camera
    fields (src/camera.h:26-41). All static; derived device constants come
    from :func:`bpt_tpu.models.camera.camera_constants`."""

    aspect_ratio: float = 1.0
    image_width: int = 100
    samples_per_pixel: int = 50
    max_depth: int = 10
    background: tuple = (0.0, 0.0, 0.0)
    vfov: float = 90.0
    lookfrom: tuple = (0.0, 0.0, 0.0)
    lookat: tuple = (0.0, 0.0, -1.0)
    vup: tuple = (0.0, 1.0, 0.0)
    defocus_angle: float = 0.0
    focus_dist: float = 10.0
    file_name: str = "image.png"
    integrator: str = "bdpt"  # reference de-facto default (camera.h:245-253)
    # Emulate the reference binary's shadow-ray endpoint artifact: its
    # visible() (camera.h:425-438) puts the connection endpoint exactly at
    # max_t, and the inclusive interval test resolves "occluded" for ~86%
    # of genuinely-unoccluded connections (measured 13.6% acceptance,
    # floor->light, the shipped -O3 build; docs/PARITY.md).  Default off:
    # we implement the intended semantics (endpoint excluded).  Turn on
    # for apples-to-apples comparisons with the reference binary's BDPT
    # output (jnp wavefront only; f32 kernels have a different fp tie
    # profile, so the emulation forces the jnp path).
    ref_vis: bool = False

    @property
    def image_height(self) -> int:
        # src/camera.h:161-162
        h = int(self.image_width / self.aspect_ratio)
        return max(h, 1)

    @property
    def sqrt_spp(self) -> int:
        # src/camera.h:164 — effective spp is floor(sqrt(spp))^2
        return max(1, int(np.sqrt(self.samples_per_pixel)))

    @property
    def effective_spp(self) -> int:
        return self.sqrt_spp * self.sqrt_spp
