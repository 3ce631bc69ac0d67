"""Scene builder + YAML/OBJ loader tests: every surface type, material
synonym, and heuristic from the reference loader."""

import os
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

from bpt_tpu.scene.builder import MaterialSpec, SceneBuilder
from bpt_tpu.scene.loader import (
    build_material,
    load_camera,
    load_scene_from_yaml,
    read_color_scaled,
)
from bpt_tpu.scene.obj import parse_obj
from bpt_tpu.scene.presets import cornell_box
from bpt_tpu.scene.types import (
    MAT_DIELECTRIC,
    MAT_LAMBERTIAN,
    MAT_LIGHT,
    MAT_METAL,
)


class TestBuilder:
    def test_cornell_counts(self):
        scene = cornell_box(dtype=jnp.float64)
        assert scene.num_tris == 24  # 5 walls*2 + light*2 + box*12
        assert scene.num_lights == 2
        assert not scene.lights_are_world

    def test_quad_winding(self):
        b = SceneBuilder()
        b.add_quad((0, 0, 0), (1, 0, 0), (0, 1, 0), MaterialSpec.lambertian((1, 1, 1)))
        s = b.build(dtype=jnp.float64, light_fallback_to_world=False)
        # both tris share the +z normal
        n = np.asarray(s.normal)
        assert np.allclose(n, [[0, 0, 1], [0, 0, 1]])
        assert np.allclose(np.asarray(s.area).sum(), 1.0)

    def test_box_transform_baked(self):
        b = SceneBuilder()
        b.add_box((0, 0, 0), (1, 2, 3), MaterialSpec.lambertian((1, 1, 1)),
                  rotate_y_degrees=90.0, translate=(10, 0, 0))
        s = b.build(dtype=jnp.float64, light_fallback_to_world=False)
        assert s.num_tris == 12
        v0 = np.asarray(s.v0)
        e1 = np.asarray(s.e1)
        e2 = np.asarray(s.e2)
        pts = np.concatenate([v0, v0 + e1, v0 + e2])
        # rotate_y(90): (x,z) -> (z, -x); box [0,1]x[0,3] -> x in [0,3], z in [-1,0]
        assert np.isclose(pts[:, 0].min(), 10.0, atol=1e-9)
        assert np.isclose(pts[:, 0].max(), 13.0, atol=1e-9)
        assert np.isclose(pts[:, 2].min(), -1.0, atol=1e-9)
        assert np.isclose(pts[:, 2].max(), 0.0, atol=1e-9)

    def test_uv_sphere_tessellation_count(self):
        b = SceneBuilder()
        b.add_uv_sphere((0, 0, 0), 1.0, MaterialSpec.lambertian((1, 1, 1)))
        # 16 lat x 32 lon: poles emit 1 tri/quad, middle 2 -> 2*16*32 - 2*32
        assert b.num_tris == 2 * 16 * 32 - 2 * 32

    def test_light_fallback_to_world(self):
        b = SceneBuilder()
        b.add_quad((0, 0, 0), (1, 0, 0), (0, 1, 0), MaterialSpec.lambertian((1, 1, 1)))
        s = b.build(dtype=jnp.float64, light_fallback_to_world=True)
        assert s.lights_are_world
        assert s.num_lights == s.num_tris

    def test_area_cdf(self):
        b = SceneBuilder()
        light = MaterialSpec.diffuse_light((5, 5, 5))
        b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), light)  # area 0.5
        b.add_triangle((0, 0, 5), (2, 0, 5), (0, 2, 5), light)  # area 2
        s = b.build(dtype=jnp.float64)
        assert np.isclose(float(s.light_total_area), 2.5)
        assert np.allclose(np.asarray(s.light_cdf), [0.5, 2.5])


class TestMaterialSchema:
    def test_color_autoscale(self):
        assert read_color_scaled([255, 97, 3], (0, 0, 0)) == pytest.approx(
            (255 / 255, 97 / 255, 3 / 255)
        )
        assert read_color_scaled([0.5, 0.5, 0.5], (0, 0, 0)) == (0.5, 0.5, 0.5)
        # > 255 stays unscaled
        assert read_color_scaled([300, 0, 0], (0, 0, 0)) == (300, 0, 0)

    def test_typed_materials(self):
        m = build_material({"type": "lambertian", "color": [147, 147, 147]})
        assert m.mtype == MAT_LAMBERTIAN
        assert m.albedo == pytest.approx((147 / 255,) * 3)

        m = build_material({"type": "metal", "color": [0.8, 0.8, 0.8], "roughness": 2.0})
        assert m.mtype == MAT_METAL and m.fuzz == 1.0  # clamped

        m = build_material({"type": "glass", "ior": 0.763})
        assert m.mtype == MAT_DIELECTRIC and m.ior == pytest.approx(0.763)

        m = build_material({"type": "dielectric", "ior": -1})
        assert m.ior == 1.5  # invalid -> default

        # light emission is linear HDR, never autoscaled
        m = build_material({"type": "light", "emission": [15.9155, 27.0563, 31.831]})
        assert m.mtype == MAT_LIGHT
        assert m.albedo == pytest.approx((15.9155, 27.0563, 31.831))

    def test_albedo_synonyms(self):
        for key in ("color", "albedo", "base_color", "base_colour"):
            m = build_material({"type": "lambertian", key: [0.1, 0.2, 0.3]})
            assert m.albedo == pytest.approx((0.1, 0.2, 0.3))

    def test_legacy_mapping(self):
        # emission clamp to max-component 50 (scene_loader.h:147-153)
        m = build_material({"emission": [1000, 500, 250]})
        assert m.mtype == MAT_LIGHT
        # autoscale does not apply (1000 > 255), then clamp scales by 50/1000
        assert m.albedo == pytest.approx((50.0, 25.0, 12.5))

        # emission in 0-255 range IS autoscaled first
        m = build_material({"emission": [200, 100, 50]})
        assert m.albedo == pytest.approx((200 / 255, 100 / 255, 50 / 255))

        m = build_material({"transmission": 0.9, "ior": 1.33})
        assert m.mtype == MAT_DIELECTRIC and m.ior == pytest.approx(1.33)

        m = build_material({"spec_trans": 0.5})
        assert m.mtype == MAT_DIELECTRIC

        m = build_material({"metallic": 0.8, "base_color": [0.9, 0.9, 0.9], "roughness": 0.3})
        assert m.mtype == MAT_METAL and m.fuzz == pytest.approx(0.3)

        m = build_material({"metallic": 0.4, "base_color": [0.9, 0.9, 0.9]})
        assert m.mtype == MAT_LAMBERTIAN  # metallic <= 0.5 -> diffuse

        m = build_material({"base_colour": [0.2, 0.4, 0.6]})
        assert m.mtype == MAT_LAMBERTIAN
        assert m.albedo == pytest.approx((0.2, 0.4, 0.6))

    def test_unknown_type_falls_through_to_legacy(self):
        m = build_material({"type": "weird", "metallic": 1.0, "base_color": [1, 1, 1]})
        assert m.mtype == MAT_METAL


class TestCamera:
    def test_parse(self):
        cfg = load_camera(
            {
                "resolution": [1280, 720],
                "fov": 35,
                "aperture_radius": 5,  # parsed then ignored
                "location": [1, 2, 3],
                "look_at": [0, 0, 0],
                "samples_per_pixel": 400,
                "max_depth": 80,
                "output": "x.png",
            }
        )
        assert cfg.image_width == 1280
        assert cfg.image_height == 720
        assert cfg.vfov == 35
        assert cfg.defocus_angle == 0.0  # force-disabled
        assert cfg.samples_per_pixel == 400
        assert cfg.sqrt_spp == 20
        assert cfg.max_depth == 80
        assert cfg.file_name == "x.png"

    def test_fov_clamp(self):
        assert load_camera({"resolution": [10, 10], "fov": 0.2}).vfov == 1.0
        assert load_camera({"resolution": [10, 10], "fov": 400}).vfov == 179.0

    def test_missing_resolution_raises(self):
        with pytest.raises(ValueError):
            load_camera({"fov": 30})

    def test_effective_spp(self):
        cfg = load_camera({"resolution": [8, 8], "samples_per_pixel": 5})
        assert cfg.sqrt_spp == 2 and cfg.effective_spp == 4  # floor(sqrt(5))^2


class TestYamlScenes:
    def _write(self, tmp_path, text):
        p = tmp_path / "scene.yaml"
        p.write_text(textwrap.dedent(text))
        return str(p)

    def test_trimesh_and_lights(self, tmp_path):
        path = self._write(
            tmp_path,
            """
            camera:
              resolution: [16, 16]
              fov: 40
            surfaces:
              - type: TriMesh
                material: {type: lambertian, color: [200, 200, 200]}
                data:
                  vertices: [0,0,0, 1,0,0, 0,1,0,  0,0,1, 1,0,1, 0,1,1]
              - type: TriMesh
                material: {type: light, emission: [10, 10, 10]}
                data:
                  vertices: [5,5,5, 6,5,5, 5,6,5]
            """,
        )
        loaded = load_scene_from_yaml(path, dtype=jnp.float64, verbose=False)
        assert loaded.scene.num_tris == 3
        assert loaded.scene.num_lights == 1
        assert not loaded.scene.lights_are_world

    def test_sphere_surface(self, tmp_path):
        path = self._write(
            tmp_path,
            """
            camera: {resolution: [8, 8]}
            surfaces:
              - type: Sphere
                material: {type: lambertian, color: [0.5, 0.5, 0.5]}
                data: {center: [0, 0, 0], radius: 2}
            """,
        )
        loaded = load_scene_from_yaml(path, dtype=jnp.float64, verbose=False)
        assert loaded.scene.num_tris == 2 * 16 * 32 - 2 * 32

    def test_indexed_mesh_with_named_material(self, tmp_path):
        path = self._write(
            tmp_path,
            """
            camera: {resolution: [8, 8]}
            materials:
              Light: {type: light, emission: [245, 245, 245]}
            surfaces:
              - type: mesh
                vertices: [[0,0,0], [1,0,0], [1,1,0], [0,1,0]]
                triangles: [[0,1,2], [0,2,3]]
                material: Light
            """,
        )
        loaded = load_scene_from_yaml(path, dtype=jnp.float64, verbose=False)
        assert loaded.scene.num_tris == 2
        assert loaded.scene.num_lights == 2
        # emission not autoscaled on typed light path
        assert np.allclose(
            np.asarray(loaded.scene.materials.albedo)[
                np.asarray(loaded.scene.light_mat)[0]
            ],
            [245, 245, 245],
        )

    def test_unknown_surface_warns_and_skips(self, tmp_path, capsys):
        path = self._write(
            tmp_path,
            """
            camera: {resolution: [8, 8]}
            surfaces:
              - type: Blob
              - type: TriMesh
                material: {type: lambertian, color: [1, 1, 1]}
                data: {vertices: [0,0,0, 1,0,0, 0,1,0]}
            """,
        )
        loaded = load_scene_from_yaml(path, dtype=jnp.float64, verbose=False)
        assert loaded.scene.num_tris == 1
        assert "Unknown mesh type: Blob" in capsys.readouterr().err

    def test_scene_legacy_key(self, tmp_path):
        path = self._write(
            tmp_path,
            """
            camera: {resolution: [8, 8]}
            scene:
              - type: TriMesh
                material: {type: lambertian, color: [1, 1, 1]}
                data: {vertices: [0,0,0, 1,0,0, 0,1,0]}
            """,
        )
        loaded = load_scene_from_yaml(path, dtype=jnp.float64, verbose=False)
        assert loaded.scene.num_tris == 1

    def test_object_obj_file(self, tmp_path):
        obj = tmp_path / "mesh.obj"
        obj.write_text(
            "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
            "f 1 2 3 4\n"  # quad -> fan -> 2 tris
            "f -4//1 -3/2/1 -2\n"  # negative + slashed forms -> 1 tri
        )
        path = self._write(
            tmp_path,
            """
            camera: {resolution: [8, 8]}
            materials:
              M: {type: lambertian, color: [0.5, 0.5, 0.5]}
            surfaces:
              - type: object
                smooth: true
                file: mesh.obj
                material: M
            """,
        )
        loaded = load_scene_from_yaml(path, dtype=jnp.float64, verbose=False)
        assert loaded.scene.num_tris == 3


class TestObjParser:
    def test_forms(self, tmp_path):
        p = tmp_path / "t.obj"
        p.write_text(
            "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 1\n"
            "vn 0 0 1\nvt 0 0\n"  # ignored
            "f 1/1/1 2//1 3\n"
            "f 1 2 3 4\n"
            "f 1 junk 3\n"  # malformed token skipped -> only 2 valid -> no tri
        )
        tris = parse_obj(str(p))
        assert len(tris) == 1 + 2  # single + fan of quad
        assert tris[0] == ((0, 0, 0), (1, 0, 0), (0, 1, 0))

    def test_negative_indices(self, tmp_path):
        p = tmp_path / "t.obj"
        p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
        tris = parse_obj(str(p))
        assert tris == [((0, 0, 0), (1, 0, 0), (0, 1, 0))]


class TestVolumeYaml:
    def test_volume_box_and_sphere(self, tmp_path):
        """YAML extension: volume_box / volume_sphere -> constant_medium
        (loader._load_volume; the reference exposes constant_medium.h only
        from C++)."""
        y = tmp_path / "v.yaml"
        y.write_text(
            "camera:\n  resolution: [8, 8]\n"
            "surfaces:\n"
            "  - type: TriMesh\n"
            "    material: {type: diffuse_light, emission: [7, 7, 7]}\n"
            "    data:\n"
            "      vertices: [0,5,0, 1,5,0, 1,5,1]\n"
            "  - type: volume_box\n"
            "    density: 0.01\n"
            "    albedo: [0, 0, 0]\n"
            "    data: {min: [0, 0, 0], max: [2, 2, 2], rotate_y: -18}\n"
            "  - type: volume_sphere\n"
            "    density: 0.005\n"
            "    data: {center: [4, 1, 0], radius: 1}\n"
        )
        from bpt_tpu.scene.loader import load_scene_from_yaml

        ls = load_scene_from_yaml(str(y), verbose=False)
        s = ls.scene
        assert s.num_volumes == 2
        np.testing.assert_allclose(
            np.asarray(s.vol_neg_inv_density), [-100.0, -200.0])
        # box contributes 12 boundary tris, 16x32 sphere the rest
        assert int(s.vol_v0.shape[0]) > 12
        assert int(np.asarray(s.vol_tri_vol).max()) == 1

    def test_volume_texture_key(self, tmp_path):
        """Round 4: optional ``texture:`` on YAML volumes — the textured
        isotropic phase (constant_medium(b, d, tex),
        constant_medium.h:13-17)."""
        y = tmp_path / "vt.yaml"
        y.write_text(
            "camera:\n  resolution: [8, 8]\n"
            "surfaces:\n"
            "  - type: TriMesh\n"
            "    material: {type: diffuse_light, emission: [7, 7, 7]}\n"
            "    data:\n"
            "      vertices: [0,5,0, 1,5,0, 1,5,1]\n"
            "  - type: volume_box\n"
            "    density: 0.01\n"
            "    data: {min: [0, 0, 0], max: [2, 2, 2]}\n"
            "    texture: {type: checker, scale: 0.5,\n"
            "              color1: [0.9, 0.2, 0.1], color2: [0.1, 0.2, 0.9]}\n"
        )
        from bpt_tpu.scene.loader import load_scene_from_yaml

        ls = load_scene_from_yaml(str(y), verbose=False)
        s = ls.scene
        assert s.num_volumes == 1 and s.has_textures
        vmat = int(np.asarray(s.vol_mat)[0])
        assert int(np.asarray(s.materials.tex_id)[vmat]) >= 0

    def test_volume_invalid_density_raises(self, tmp_path):
        y = tmp_path / "v.yaml"
        y.write_text(
            "camera:\n  resolution: [8, 8]\n"
            "surfaces:\n"
            "  - type: volume_box\n"
            "    data: {min: [0,0,0], max: [1,1,1]}\n"
        )
        from bpt_tpu.scene.loader import load_scene_from_yaml

        with pytest.raises(ValueError, match="density"):
            load_scene_from_yaml(str(y), verbose=False)

    def test_cornell_smoke_scene_file(self):
        from bpt_tpu.scene.loader import load_scene_from_yaml

        path = os.path.join(os.path.dirname(__file__), "..", "scenes",
                            "cornell_smoke.yaml")
        ls = load_scene_from_yaml(path, verbose=False)
        assert ls.scene.num_volumes == 2
        assert ls.scene.num_tris == 12
        assert ls.scene.vol_v0.shape[0] == 24


class TestBuilderTransforms:
    """Generic rotate_y/translate instancing baked at
    build for every builder primitive (the reference wraps ANY hittable,
    src/objects/hittable.h:46-120; we bake like add_box always did)."""

    OBJ = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\nf 1 3 4\nf 2 3 4\n"

    def test_obj_rotation_matches_prerotated(self, tmp_path):
        import math

        import numpy as np

        from bpt_tpu.scene.builder import (
            MaterialSpec, SceneBuilder, rotate_y_point)

        p = tmp_path / "m.obj"
        p.write_text(self.OBJ)
        mat = MaterialSpec.lambertian((0.5, 0.5, 0.5))
        deg, tr = 37.0, (1.0, 2.0, 3.0)

        a = SceneBuilder()
        a.add_obj(str(p), mat, rotate_y_degrees=deg, translate=tr)
        sa = a.build(dtype=jnp.float32, use_bvh=False)

        rad = deg * math.pi / 180.0
        s, c = math.sin(rad), math.cos(rad)
        b = SceneBuilder()
        for v0, v1, v2 in parse_obj(str(p)):
            v0, v1, v2 = (
                np.array(rotate_y_point(np.asarray(v, np.float64), s, c))
                + np.asarray(tr, np.float64)
                for v in (v0, v1, v2))
            b.add_triangle(v0, v1, v2, mat)
        sb = b.build(dtype=jnp.float32, use_bvh=False)

        for f in ("v0", "e1", "e2", "normal", "area"):
            assert np.array_equal(np.asarray(getattr(sa, f)),
                                  np.asarray(getattr(sb, f))), f

    def test_quad_and_sphere_transforms(self):
        import numpy as np

        from bpt_tpu.scene.builder import MaterialSpec, SceneBuilder

        mat = MaterialSpec.lambertian((0.5, 0.5, 0.5))
        q = SceneBuilder()
        q.add_quad((0, 0, 0), (1, 0, 0), (0, 1, 0), mat,
                   rotate_y_degrees=90.0, translate=(0, 5, 0))
        # quad (0,0,0)-(1,0,0)x(0,1,0) rotated 90 about Y maps x->-z;
        # translated +5 in y: all z in [-1, 0], y in [5, 6]
        quad_pts = np.array([t[:3] for t in q._tris], np.float64)
        assert quad_pts[..., 2].min() >= -1.0 - 1e-6
        assert quad_pts[..., 2].max() <= 1e-6
        assert quad_pts[..., 1].min() >= 5.0 - 1e-6
        a = SceneBuilder()
        a.add_uv_sphere((2, 0, 0), 1.0, mat, lat_steps=4, lon_steps=4,
                        rotate_y_degrees=90.0)
        # sphere center (2,0,0) rotated 90 about Y -> (0,0,-2): all
        # vertices within radius 1 of it
        sph = np.array([t[:3] for t in a._tris], np.float64)
        d = np.linalg.norm(sph - np.array([0.0, 0.0, -2.0]), axis=-1)
        assert (d <= 1.0 + 1e-6).all()
        # UVs are the unrotated parametrization (texture rides the
        # object); compare as multisets — build() reorders triangles by
        # BVH order, which differs between the two geometries
        sa = a.build(dtype=jnp.float32, use_bvh=False)
        b = SceneBuilder()
        b.add_uv_sphere((2, 0, 0), 1.0, mat, lat_steps=4, lon_steps=4)
        sb = b.build(dtype=jnp.float32, use_bvh=False)

        def rows_sorted(x):
            x = np.asarray(x)
            return x[np.lexsort(x.T[::-1])]

        assert np.array_equal(rows_sorted(sa.tri_uv), rows_sorted(sb.tri_uv))

    def test_yaml_transform_extension(self, tmp_path):
        import numpy as np

        text = """
camera:
  resolution: [16, 16]
  location: [0, 1, 5]
  look_at: [0, 1, 0]
surfaces:
  - type: TriMesh
    material: {type: lambertian, color: [0.5, 0.5, 0.5]}
    transform: {rotate_y: 90, translate: [0, 5, 0]}
    data:
      vertices: [0,0,0, 1,0,0, 0,1,0]
  - type: light
    material: {type: light, emission: [5, 5, 5]}
    data:
      vertices: [0,9,0, 1,9,0, 0,9,1]
"""
        # reuse the 'light' synonym? TriMesh only: write valid schema
        text = text.replace("type: light\n    material: {type: light",
                            "type: TriMesh\n    material: {type: light")
        p = tmp_path / "scene.yaml"
        p.write_text(text)
        ls = load_scene_from_yaml(str(p), verbose=False)
        v0 = np.asarray(ls.scene.v0, np.float64)
        tri0 = v0[np.asarray(ls.scene.mat_id) == 0]
        # rotated+translated triangle: y >= 0 plane moved to y>=5, x->-z
        assert tri0[:, 1].min() >= 0.0
        assert (np.abs(tri0[:, 2]) <= 1.0 + 1e-9).all()
