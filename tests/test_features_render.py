"""Textures, textured lights, textured volumes and volumes through the
whole render (the jnp wavefront: the path every platform runs), for PT,
BDPT and BDPT-MIS.

The NumPy oracle has no texture stage, so the texel path is pinned two
ways: a SOLID texture whose colour equals the material's albedo (or
emission) must render exactly like the untextured scene, and a CHECKER
scene must be invariant under chunking, stratum resume and pixel
sharding, like every other render."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from bpt_tpu.models.render import render
from bpt_tpu.parallel.mesh import make_mesh, render_distributed
from bpt_tpu.scene.builder import MaterialSpec as M
from bpt_tpu.scene.builder import SceneBuilder
from bpt_tpu.scene.presets import cornell_box_camera
from bpt_tpu.scene.textures import TextureSpec

INTEGRATORS = ["pt", "bdpt", "bdpt-mis"]
FEATURES = ["surface", "light", "volume"]

ALBEDO = (0.7, 0.3, 0.2)
EMISSION = (9.0, 8.0, 7.0)
FOG = (0.8, 0.8, 0.9)


def _scene(textured=(), solid=True, use_bvh=None):
    """Sphere + floor + area light + fog box.  ``textured`` names the
    materials that carry a texture: a solid one equal to the untextured
    colour, or a checker."""

    def tex(feature, color):
        if feature not in textured:
            return None
        if solid:
            return TextureSpec.solid(color)
        return TextureSpec.checker(0.5, color, (0.1, 0.2, 0.3))

    b = SceneBuilder()
    b.add_uv_sphere((0, 1, 0), 1.0,
                    M.lambertian(ALBEDO, texture=tex("surface", ALBEDO)),
                    lat_steps=6, lon_steps=12)
    b.add_quad((-6, 0, -6), (12, 0, 0), (0, 0, 12),
               M.lambertian((0.6, 0.6, 0.6)))
    b.add_quad((-1, 5, -1), (2, 0, 0), (0, 0, 2),
               M.diffuse_light(EMISSION, texture=tex("light", EMISSION)))
    b.add_volume_box((1.2, 0.0, -1.0), (2.4, 1.5, 0.5), density=0.6,
                     albedo=FOG, texture=tex("volume", FOG))
    return b.build(dtype=jnp.float32, use_bvh=use_bvh)


def _cfg(integrator, **kw):
    base = dict(image_width=8, aspect_ratio=1.0, samples_per_pixel=4,
                max_depth=3, integrator=integrator,
                lookfrom=(0.0, 2.0, 6.0), lookat=(0.5, 1.0, 0.0), vfov=45.0)
    base.update(kw)
    return dataclasses.replace(cornell_box_camera(), **base)


@pytest.mark.parametrize("feature", FEATURES)
@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_solid_texture_renders_like_untextured(integrator, feature):
    plain = _scene()
    solid = _scene(textured=(feature,))
    assert solid.has_textures and not plain.has_textures
    cfg = _cfg(integrator, samples_per_pixel=1)
    a = render(plain, cfg, seed=2)
    b = render(solid, cfg, seed=2)
    np.testing.assert_array_equal(a.framebuffer_sum, b.framebuffer_sum)
    assert a.stats.rays_traced == b.stats.rays_traced


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_checker_textures_change_the_image(integrator):
    """The checker texel stage reaches surfaces, lights and volumes:
    each textured scene differs from the untextured one."""
    cfg = _cfg(integrator, samples_per_pixel=1)
    plain = render(_scene(), cfg, seed=2).framebuffer_sum
    for feature in FEATURES:
        tex = render(_scene(textured=(feature,), solid=False), cfg,
                     seed=2).framebuffer_sum
        assert np.isfinite(tex).all()
        assert not np.array_equal(tex, plain), feature


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_textured_volume_scene_chunk_resume_and_shard_invariance(integrator):
    """Checker surface + textured light + textured fog on a BVH scene:
    chunked, resumed and pixel-sharded renders equal the straight
    single-device render bit for bit."""
    scene = _scene(textured=FEATURES, solid=False, use_bvh=True)
    cfg = _cfg(integrator)
    ref = render(scene, cfg, seed=7)
    assert np.isfinite(ref.framebuffer_sum).all()
    chunked = render(scene, cfg, seed=7, chunk_size=24)
    np.testing.assert_array_equal(chunked.framebuffer_sum,
                                  ref.framebuffer_sum)
    states = []
    render(scene, cfg, seed=7,
           stratum_callback=lambda s: states.append(dict(s)))
    resumed = render(scene, cfg, seed=7, resume=states[2])
    np.testing.assert_array_equal(resumed.framebuffer_sum,
                                  ref.framebuffer_sum)
    fb, _ = render_distributed(scene, cfg, mesh=make_mesh(4), seed=7)
    np.testing.assert_array_equal(fb, ref.framebuffer_sum)
