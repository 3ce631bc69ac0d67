"""Distributed tests on a virtual 8-device CPU mesh (no cluster needed):
sharded render == single-device render."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bpt_tpu.models.render import render
from bpt_tpu.parallel.mesh import (
    make_mesh,
    render_distributed,
    render_spp_sharded_step,
)
from bpt_tpu.models.camera import camera_constants
from bpt_tpu.scene.presets import cornell_box, cornell_box_camera


@pytest.fixture(scope="module")
def scene():
    return cornell_box(dtype=jnp.float32)


def _cfg(**kw):
    base = dict(image_width=16, samples_per_pixel=4, max_depth=3, integrator="pt")
    base.update(kw)
    return dataclasses.replace(cornell_box_camera(), **base)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_pixel_sharded_matches_single_device(scene):
    cfg = _cfg()
    single = render(scene, cfg, seed=11)
    mesh = make_mesh(8)
    fb, spp = render_distributed(scene, cfg, mesh=mesh, seed=11)
    assert spp == 4
    # pixel sharding: no collective, per-pixel op order identical -> exact
    np.testing.assert_array_equal(fb, single.framebuffer_sum)


def test_pixel_sharded_mesh_shape_invariance(scene):
    cfg = _cfg()
    fb2, _ = render_distributed(scene, cfg, mesh=make_mesh(2), seed=5)
    fb8, _ = render_distributed(scene, cfg, mesh=make_mesh(8), seed=5)
    np.testing.assert_array_equal(fb2, fb8)


def test_spp_sharded_psum_matches_serial(scene):
    cfg = _cfg()
    mesh = make_mesh(4)
    cc = camera_constants(cfg, scene.dtype)
    npix = cc.width * cc.height
    step = render_spp_sharded_step(mesh, "pt", cfg.max_depth, cfg.sqrt_spp, npix)
    key = jax.random.PRNGKey(11)
    fb = np.asarray(step(scene, cc, key, jnp.int32(0)))  # strata 0..3 via psum
    single = render(scene, cfg, seed=11)
    np.testing.assert_allclose(
        fb.reshape(cc.height, cc.width, 3), single.framebuffer_sum,
        rtol=1e-5, atol=1e-6,
    )


def test_bdpt_distributed(scene):
    cfg = _cfg(integrator="bdpt", image_width=8, samples_per_pixel=1)
    single = render(scene, cfg, seed=2)
    fb, _ = render_distributed(scene, cfg, mesh=make_mesh(8), seed=2)
    np.testing.assert_array_equal(fb, single.framebuffer_sum)


def test_host_chip_2d_mesh_matches_single_device(scene):
    """Multi-host-SHAPED ('host','chip') mesh: pixels shard over the
    chip (ICI) axis, strata over the host (DCN) axis with one psum per
    stratum batch.  Matches the single-device render up to the float
    addition order of the strata."""
    from bpt_tpu.parallel.mesh import make_mesh_2d, render_distributed_2d

    cfg = _cfg()
    single = render(scene, cfg, seed=13)
    mesh = make_mesh_2d(2, 4)
    fb, spp = render_distributed_2d(scene, cfg, mesh=mesh, seed=13)
    assert spp == 4
    np.testing.assert_allclose(fb, single.framebuffer_sum,
                               rtol=1e-5, atol=1e-6)


def test_host_chip_2d_mesh_shape_invariance(scene):
    """(2 hosts x 4 chips) vs (4 hosts x 2 chips): same image up to
    stratum addition order."""
    from bpt_tpu.parallel.mesh import make_mesh_2d, render_distributed_2d

    cfg = _cfg()
    fb24, _ = render_distributed_2d(scene, cfg, mesh=make_mesh_2d(2, 4),
                                    seed=3)
    fb42, _ = render_distributed_2d(scene, cfg, mesh=make_mesh_2d(4, 2),
                                    seed=3)
    np.testing.assert_allclose(fb24, fb42, rtol=1e-5, atol=1e-6)


def test_bdpt_mis_distributed_matches_single_device(scene):
    """Regression: render_distributed with integrator='bdpt-mis' must
    apply the MIS weights (round 2 fixed a silent fallback to unweighted
    BDPT in _radiance_for)."""
    cfg = _cfg(integrator="bdpt-mis", samples_per_pixel=4, image_width=8,
               max_depth=3)
    single = render(scene, cfg, seed=17)
    fb, _ = render_distributed(scene, cfg, mesh=make_mesh(4), seed=17)
    np.testing.assert_array_equal(fb, single.framebuffer_sum)


def _bvh_scene():
    """A BVH scene (past the brute-force threshold) with a metal sphere:
    the traversal the coffee cells run, at test size."""
    from bpt_tpu.scene.builder import MaterialSpec as M, SceneBuilder

    b = SceneBuilder()
    b.add_uv_sphere((0, 1, 0), 1.0, M.lambertian((0.7, 0.3, 0.2)),
                    lat_steps=12, lon_steps=24)
    b.add_uv_sphere((-2, 0.7, 1), 0.7, M.metal((0.8, 0.8, 0.9), 0.05),
                    lat_steps=8, lon_steps=16)
    b.add_quad((-6, 0, -6), (12, 0, 0), (0, 0, 12),
               M.lambertian((0.6, 0.6, 0.6)))
    b.add_quad((-1, 5, -1), (2, 0, 0), (0, 0, 2),
               M.diffuse_light((9, 9, 9)))
    big = b.build(dtype=jnp.float32)
    assert big.use_bvh
    return big


def _bvh_cfg(**kw):
    base = dict(image_width=12, aspect_ratio=1.0, samples_per_pixel=4,
                max_depth=3, integrator="pt", lookfrom=(0.0, 2.0, 6.0),
                lookat=(0.0, 1.0, 0.0), vfov=40.0)
    base.update(kw)
    return dataclasses.replace(cornell_box_camera(), **base)


@pytest.mark.parametrize("integrator", ["pt", "bdpt", "bdpt-mis"])
def test_bvh_scene_pixel_sharded_matches_single_device(integrator):
    """Pixel sharding on a BVH scene is bit-identical to render() and
    mesh-shape invariant: absolute ray ids drive every draw and no
    collective runs inside the estimator."""
    big = _bvh_scene()
    cfg = _bvh_cfg(integrator=integrator)
    ref = render(big, cfg, seed=5)
    fb8, spp = render_distributed(big, cfg, mesh=make_mesh(8), seed=5)
    assert spp == 4
    np.testing.assert_array_equal(fb8, ref.framebuffer_sum)
    fb3, _ = render_distributed(big, cfg, mesh=make_mesh(3), seed=5)
    np.testing.assert_array_equal(fb8, fb3)


@pytest.mark.parametrize("integrator", ["pt", "bdpt-mis"])
def test_bvh_scene_spp_sharded_psum_matches_serial(integrator):
    big = _bvh_scene()
    cfg = _bvh_cfg(integrator=integrator)
    mesh = make_mesh(4)
    cc = camera_constants(cfg, big.dtype)
    npix = cc.width * cc.height
    step = render_spp_sharded_step(mesh, integrator, cfg.max_depth,
                                   cfg.sqrt_spp, npix)
    fb = np.asarray(step(big, cc, jax.random.PRNGKey(9), jnp.int32(0)))
    single = render(big, cfg, seed=9)
    np.testing.assert_allclose(
        fb.reshape(cc.height, cc.width, 3), single.framebuffer_sum,
        rtol=1e-5, atol=1e-6)


def test_distributed_defocus_runs_and_blurs(scene):
    """Defocus (camera.h:230-234) under pixel sharding: the disk draws
    reach generate_rays (the image differs from the pinhole render), the
    energy stays put, and the result is mesh-shape invariant and equal
    to render()."""
    cfg = _cfg(aspect_ratio=1.0, defocus_angle=8.0, focus_dist=300.0)
    fb8, _ = render_distributed(scene, cfg, mesh=make_mesh(8), seed=3)
    fb4, _ = render_distributed(scene, cfg, mesh=make_mesh(4), seed=3)
    np.testing.assert_array_equal(fb8, fb4)
    np.testing.assert_array_equal(fb8, render(scene, cfg,
                                              seed=3).framebuffer_sum)
    pin = dataclasses.replace(cfg, defocus_angle=0.0)
    fb_pin, _ = render_distributed(scene, pin, mesh=make_mesh(8), seed=3)
    assert not np.array_equal(fb8, fb_pin)
    assert np.isfinite(fb8).all()
    assert abs(fb8.mean() / max(fb_pin.mean(), 1e-9) - 1.0) < 0.25


def test_shard_step_cache_keys_on_traversal_route(monkeypatch, scene):
    """The mesh step cache keys on soa.use_traversal_kernel: a changed
    route gets its own step instead of reusing one traced for the other."""
    from bpt_tpu.ops import soa
    from bpt_tpu.parallel import mesh as mesh_mod

    cfg = _cfg(image_width=8, samples_per_pixel=1)
    mesh = make_mesh(2)
    render_distributed(scene, cfg, mesh=mesh, seed=0)
    n0 = mesh_mod.shard_step.cache_info().currsize
    monkeypatch.setattr(soa, "use_traversal_kernel", lambda s, dt: True)
    render_distributed(scene, cfg, mesh=mesh, seed=0)  # brute scene: no
    # kernel call is traced, but the step is still a new cache entry
    assert mesh_mod.shard_step.cache_info().currsize == n0 + 1
