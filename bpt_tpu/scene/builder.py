"""Programmatic scene construction -> frozen SceneArrays.

This is the device-array analog of the reference's triangle_collection +
helper constructors (src/objects/primatives/triangle.h:135-309): triangles
accumulate host-side in float64, transforms are baked at add time (as the
reference's add_box_triangles already does), and ``build()`` flattens
everything — BVH, material table, light CDF — into device arrays once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dfield
from typing import Optional

import jax.numpy as jnp
import numpy as np

from bpt_tpu.scene import bvh as bvh_mod
from bpt_tpu.scene.textures import TextureSpec, build_texture_table
from bpt_tpu.scene.types import (
    MAT_DIELECTRIC,
    MAT_ISOTROPIC,
    MAT_LAMBERTIAN,
    MAT_LIGHT,
    MAT_METAL,
    TEX_NOISE,
    MaterialTable,
    SceneArrays,
)

PI = math.pi


@dataclass(frozen=True)
class MaterialSpec:
    """Host-side material description (one reference material subclass each,
    src/materials/material.h:42-172)."""

    mtype: int
    albedo: tuple = (0.0, 0.0, 0.0)  # lambertian/metal/isotropic albedo; light emission
    fuzz: float = 0.0
    ior: float = 1.5
    texture: Optional[TextureSpec] = None

    @staticmethod
    def lambertian(albedo=(0.0, 0.0, 0.0), texture=None):
        return MaterialSpec(MAT_LAMBERTIAN, tuple(albedo), texture=texture)

    @staticmethod
    def metal(albedo, fuzz=0.0):
        # fuzz clamp (material.h:71)
        return MaterialSpec(MAT_METAL, tuple(albedo), fuzz=min(float(fuzz), 1.0))

    @staticmethod
    def dielectric(ior):
        return MaterialSpec(MAT_DIELECTRIC, ior=float(ior))

    @staticmethod
    def diffuse_light(emission=(0.0, 0.0, 0.0), texture=None):
        return MaterialSpec(MAT_LIGHT, tuple(emission), texture=texture)

    @staticmethod
    def isotropic(albedo=(0.0, 0.0, 0.0), texture=None):
        return MaterialSpec(MAT_ISOTROPIC, tuple(albedo), texture=texture)


def rotate_y_point(p, sin_t, cos_t):
    """src/objects/primatives/triangle.h:243-249."""
    return (
        cos_t * p[0] + sin_t * p[2],
        p[1],
        -sin_t * p[0] + cos_t * p[2],
    )


def _bake_xform(p, rotate_y_degrees, translate):
    """Bake the reference's instancing wrappers (rotate_y then translate,
    src/objects/hittable.h:46-120) into a vertex, exactly the way
    add_box_triangles does for boxes (triangle.h:243-249 + offset)."""
    p = np.asarray(p, np.float64)
    if rotate_y_degrees != 0.0:
        rad = rotate_y_degrees * PI / 180.0
        p = np.array(rotate_y_point(p, math.sin(rad), math.cos(rad)))
    t = np.asarray(translate, np.float64)
    if t.any():
        p = p + t
    return p


class SceneBuilder:
    def __init__(self):
        self._tris: list[tuple] = []  # (v0, v1, v2, mat_index)
        self._materials: list[MaterialSpec] = []
        self._mat_index: dict[int, int] = {}  # id(spec) -> index
        self._vol_tris: list[tuple] = []  # (v0, v1, v2, volume_index)
        self._volumes: list[tuple] = []  # (density, phase_mat_index)
        self.background = (0.0, 0.0, 0.0)

    # ------------------------------------------------------------ materials

    def material(self, spec: MaterialSpec) -> int:
        key = id(spec)
        if key not in self._mat_index:
            self._mat_index[key] = len(self._materials)
            self._materials.append(spec)
        return self._mat_index[key]

    # ------------------------------------------------------------ geometry

    def add_triangle(self, v0, v1, v2, mat: MaterialSpec, uvs=None,
                     rotate_y_degrees=0.0, translate=(0, 0, 0)):
        """uvs: optional ((u0,v0),(u1,v1),(u2,v2)) texture coords per vertex.
        Default ((0,0),(1,0),(0,1)) makes the interpolated hit (u,v) equal the
        barycentric (u,v) — exactly the reference's hit_record semantics.
        rotate_y_degrees/translate bake the reference's instancing wrappers
        (src/objects/hittable.h:46-120) at add time; UVs are untouched (the
        texture rides the rotated object, as the ray-space wrappers do)."""
        if rotate_y_degrees != 0.0 or any(translate):
            v0 = _bake_xform(v0, rotate_y_degrees, translate)
            v1 = _bake_xform(v1, rotate_y_degrees, translate)
            v2 = _bake_xform(v2, rotate_y_degrees, translate)
        mid = self.material(mat)
        self._tris.append((tuple(v0), tuple(v1), tuple(v2), mid, uvs))

    def add_quad(self, q, u, v, mat: MaterialSpec,
                 rotate_y_degrees=0.0, translate=(0, 0, 0)):
        """add_quad_triangles (triangle.h:232-241): (q, q+u, q+v) and
        (q+u, q+u+v, q+v)."""
        q = np.asarray(q, np.float64)
        u = np.asarray(u, np.float64)
        v = np.asarray(v, np.float64)
        xf = dict(rotate_y_degrees=rotate_y_degrees, translate=translate)
        self.add_triangle(q, q + u, q + v, mat, **xf)
        self.add_triangle(q + u, q + u + v, q + v, mat, **xf)

    def add_box(self, a, b, mat: MaterialSpec, rotate_y_degrees=0.0, translate=(0, 0, 0)):
        """add_box_triangles (triangle.h:251-309): 12 tris with baked
        Y-rotation + translation."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        v = {}
        for ix in (0, 1):
            for iy in (0, 1):
                for iz in (0, 1):
                    v[(ix, iy, iz)] = np.array(
                        [
                            mx[0] if ix else mn[0],
                            mx[1] if iy else mn[1],
                            mx[2] if iz else mn[2],
                        ]
                    )
        faces = [
            (v[0, 0, 1], v[1, 0, 1], v[1, 1, 1]), (v[0, 0, 1], v[1, 1, 1], v[0, 1, 1]),  # +Z
            (v[0, 0, 0], v[0, 1, 0], v[1, 1, 0]), (v[0, 0, 0], v[1, 1, 0], v[1, 0, 0]),  # -Z
            (v[0, 0, 0], v[0, 0, 1], v[0, 1, 1]), (v[0, 0, 0], v[0, 1, 1], v[0, 1, 0]),  # -X
            (v[1, 0, 1], v[1, 0, 0], v[1, 1, 0]), (v[1, 0, 1], v[1, 1, 0], v[1, 1, 1]),  # +X
            (v[0, 1, 1], v[1, 1, 1], v[1, 1, 0]), (v[0, 1, 1], v[1, 1, 0], v[0, 1, 0]),  # +Y
            (v[0, 0, 0], v[1, 0, 0], v[1, 0, 1]), (v[0, 0, 0], v[1, 0, 1], v[0, 0, 1]),  # -Y
        ]
        rad = rotate_y_degrees * PI / 180.0
        s, c = math.sin(rad), math.cos(rad)
        t = np.asarray(translate, np.float64)
        for p0, p1, p2 in faces:
            if rotate_y_degrees != 0.0:
                p0 = np.array(rotate_y_point(p0, s, c))
                p1 = np.array(rotate_y_point(p1, s, c))
                p2 = np.array(rotate_y_point(p2, s, c))
            self.add_triangle(p0 + t, p1 + t, p2 + t, mat)

    def add_uv_sphere(self, center, radius, mat: MaterialSpec, lat_steps=16,
                      lon_steps=32, rotate_y_degrees=0.0, translate=(0, 0, 0)):
        """add_uv_sphere (scene_loader.h:212-242): 16x32 tessellation, pole
        caps emit a single triangle per quad.  rotate_y_degrees/translate
        bake at add time; UVs come from the UNROTATED parametrization (the
        texture rotates with the sphere, matching the reference's ray-space
        rotate_y wrapper, hittable.h:76-120)."""
        center = np.asarray(center, np.float64)
        xf = dict(rotate_y_degrees=rotate_y_degrees, translate=translate)

        def pt(theta, phi):
            st = math.sin(theta)
            return center + radius * np.array(
                [st * math.cos(phi), math.cos(theta), st * math.sin(phi)]
            )

        def uv(theta, phi):
            # spherical UVs (extension: the reference's tessellation has
            # none, so image textures were unusable on YAML spheres there)
            return (phi / (2.0 * PI), 1.0 - theta / PI)

        for lat in range(lat_steps):
            th0 = PI * lat / lat_steps
            th1 = PI * (lat + 1) / lat_steps
            for lon in range(lon_steps):
                ph0 = 2.0 * PI * lon / lon_steps
                ph1 = 2.0 * PI * (lon + 1) / lon_steps
                p00, p01 = pt(th0, ph0), pt(th0, ph1)
                p10, p11 = pt(th1, ph0), pt(th1, ph1)
                if lat > 0:
                    self.add_triangle(p00, p10, p11, mat,
                                      uvs=(uv(th0, ph0), uv(th1, ph0), uv(th1, ph1)),
                                      **xf)
                if lat < lat_steps - 1:
                    self.add_triangle(p00, p11, p01, mat,
                                      uvs=(uv(th0, ph0), uv(th1, ph1), uv(th0, ph1)),
                                      **xf)

    def add_obj(self, path, mat: MaterialSpec,
                rotate_y_degrees=0.0, translate=(0, 0, 0)):
        from bpt_tpu.scene.obj import parse_obj

        for v0, v1, v2 in parse_obj(path):
            self.add_triangle(v0, v1, v2, mat,
                              rotate_y_degrees=rotate_y_degrees,
                              translate=translate)

    # ------------------------------------------------------------- volumes

    def add_volume(self, boundary_tris, density, albedo=(1.0, 1.0, 1.0),
                   texture=None) -> int:
        """constant_medium (src/materials/volumes/constant_medium.h:8-61):
        homogeneous volume with an isotropic phase function.  The boundary
        triangle soup is kept out of the surface arrays — rays pass through
        it and interact via exponential free-flight sampling.

        boundary_tris: iterable of (v0, v1, v2).
        """
        phase = MaterialSpec.isotropic(tuple(albedo), texture=texture)
        vid = len(self._volumes)
        self._volumes.append((float(density), self.material(phase)))
        for v0, v1, v2 in boundary_tris:
            self._vol_tris.append((tuple(v0), tuple(v1), tuple(v2), vid))
        return vid

    def add_volume_box(self, a, b, density, albedo=(1.0, 1.0, 1.0),
                       rotate_y_degrees=0.0, translate=(0, 0, 0),
                       texture=None) -> int:
        tmp = SceneBuilder()
        tmp.add_box(a, b, MaterialSpec.lambertian(), rotate_y_degrees, translate)
        return self.add_volume([t[:3] for t in tmp._tris], density, albedo,
                               texture=texture)

    def add_volume_sphere(self, center, radius, density, albedo=(1.0, 1.0, 1.0),
                          lat_steps=16, lon_steps=32, texture=None) -> int:
        tmp = SceneBuilder()
        tmp.add_uv_sphere(center, radius, MaterialSpec.lambertian(),
                          lat_steps, lon_steps)
        return self.add_volume([t[:3] for t in tmp._tris], density, albedo,
                               texture=texture)

    # -------------------------------------------------------------- build

    @property
    def num_tris(self) -> int:
        return len(self._tris)

    def build(
        self,
        dtype=jnp.float32,
        background=None,
        use_bvh: Optional[bool] = None,
        light_fallback_to_world: bool = True,
        brute_force_threshold: int = 256,
        perlin_seed: int = 0,
    ) -> SceneArrays:
        if not self._tris:
            raise ValueError("empty scene")
        if background is None:
            background = self.background

        verts = np.array(
            [(t[0], t[1], t[2]) for t in self._tris], np.float64
        )  # [T,3,3]
        mat_id = np.array([t[3] for t in self._tris], np.int32)
        T = verts.shape[0]
        tri_uv = np.tile(np.array([0.0, 0.0, 1.0, 0.0, 0.0, 1.0]), (T, 1))
        for k, t in enumerate(self._tris):
            if len(t) > 4 and t[4] is not None:
                tri_uv[k] = np.asarray(t[4], np.float64).reshape(6)

        # triangle precompute (triangle.h:21-38)
        v0 = verts[:, 0]
        e1 = verts[:, 1] - v0
        e2 = verts[:, 2] - v0
        n = np.cross(e1, e2)
        nlen = np.linalg.norm(n, axis=-1)
        area = 0.5 * nlen
        safe = np.where(nlen > 0, nlen, 1.0)
        normal = n / safe[:, None]

        tri_min = verts.min(axis=1)
        tri_max = verts.max(axis=1)
        tree = bvh_mod.build_bvh(tri_min, tri_max)
        order = tree["order"]

        v0, e1, e2 = v0[order], e1[order], e2[order]
        normal, area, mat_id = normal[order], area[order], mat_id[order]
        tri_uv = tri_uv[order]

        # material table
        mats = self._materials
        tex_specs: list[TextureSpec] = []
        tex_ids = []
        for m in mats:
            if m.texture is not None:
                tex_ids.append(len(tex_specs))
                tex_specs.append(m.texture)
            else:
                tex_ids.append(-1)
        materials = MaterialTable(
            mtype=jnp.asarray([m.mtype for m in mats], jnp.int32),
            albedo=jnp.asarray([m.albedo for m in mats], dtype),
            fuzz=jnp.asarray([m.fuzz for m in mats], dtype),
            ior=jnp.asarray([m.ior for m in mats], dtype),
            tex_id=jnp.asarray(tex_ids, jnp.int32),
        )
        textures = build_texture_table(tex_specs, dtype=dtype, perlin_seed=perlin_seed)
        has_noise = any(s.kind == TEX_NOISE for s in tex_specs)

        # lights: emissive triangles (add_triangle_with_lights,
        # scene_loader.h:190-202); empty -> whole world (main.cpp:67)
        mtypes = np.array([m.mtype for m in mats], np.int32)
        is_light_tri = mtypes[mat_id] == MAT_LIGHT
        light_idx = np.nonzero(is_light_tri)[0].astype(np.int32)
        lights_are_world = False
        if light_idx.size == 0 and light_fallback_to_world:
            light_idx = np.arange(T, dtype=np.int32)
            lights_are_world = True
        if light_idx.size == 0:
            light_idx = np.zeros((1,), np.int32)
            light_cdf = np.zeros((1,))
            total_area = 0.0
        else:
            areas = area[light_idx]
            light_cdf = np.cumsum(areas)
            total_area = float(light_cdf[-1]) if light_cdf.size else 0.0

        if use_bvh is None:
            use_bvh = T > brute_force_threshold

        # volumes
        if self._vol_tris:
            vverts = np.array([(t[0], t[1], t[2]) for t in self._vol_tris], np.float64)
            vv0 = vverts[:, 0]
            ve1 = vverts[:, 1] - vv0
            ve2 = vverts[:, 2] - vv0
            vol_tri_vol = np.array([t[3] for t in self._vol_tris], np.int32)
        else:
            vv0 = ve1 = ve2 = np.zeros((1, 3))
            vol_tri_vol = np.zeros((1,), np.int32)
        vol_density = np.array([v[0] for v in self._volumes] or [1.0], np.float64)
        vol_mat = np.array([v[1] for v in self._volumes] or [0], np.int32)

        return SceneArrays(
            v0=jnp.asarray(v0, dtype),
            e1=jnp.asarray(e1, dtype),
            e2=jnp.asarray(e2, dtype),
            normal=jnp.asarray(normal, dtype),
            area=jnp.asarray(area, dtype),
            mat_id=jnp.asarray(mat_id),
            tri_uv=jnp.asarray(tri_uv, dtype),
            bvh_min=jnp.asarray(tree["bvh_min"], dtype),
            bvh_max=jnp.asarray(tree["bvh_max"], dtype),
            bvh_skip=jnp.asarray(tree["bvh_skip"]),
            bvh_first=jnp.asarray(tree["bvh_first"]),
            bvh_count=jnp.asarray(tree["bvh_count"]),
            light_idx=jnp.asarray(light_idx),
            light_cdf=jnp.asarray(light_cdf, dtype),
            light_total_area=jnp.asarray(total_area, dtype),
            light_v0=jnp.asarray(v0[light_idx], dtype),
            light_e1=jnp.asarray(e1[light_idx], dtype),
            light_e2=jnp.asarray(e2[light_idx], dtype),
            light_normal=jnp.asarray(normal[light_idx], dtype),
            light_area=jnp.asarray(area[light_idx], dtype),
            light_mat=jnp.asarray(mat_id[light_idx]),
            materials=materials,
            textures=textures,
            background=jnp.asarray(background, dtype),
            vol_v0=jnp.asarray(vv0, dtype),
            vol_e1=jnp.asarray(ve1, dtype),
            vol_e2=jnp.asarray(ve2, dtype),
            vol_tri_vol=jnp.asarray(vol_tri_vol),
            vol_neg_inv_density=jnp.asarray(-1.0 / vol_density, dtype),
            vol_mat=jnp.asarray(vol_mat),
            num_volumes=len(self._volumes),
            num_tris=T,
            num_lights=int(light_idx.size),
            use_bvh=bool(use_bvh),
            has_textures=bool(tex_specs),
            has_noise=has_noise,
            lights_are_world=lights_are_world,
        )
