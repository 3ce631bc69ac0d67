"""End-to-end render driver tests: determinism, chunk invariance,
resume/checkpoint equivalence."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from bpt_tpu.models.render import render
from bpt_tpu.scene.presets import cornell_box, cornell_box_camera


@pytest.fixture(scope="module")
def small_scene():
    return cornell_box(dtype=jnp.float32)


def _cfg(**kw):
    base = dict(image_width=16, samples_per_pixel=4, max_depth=3, integrator="pt")
    base.update(kw)
    return dataclasses.replace(cornell_box_camera(), **base)


def test_same_seed_same_image(small_scene):
    r1 = render(small_scene, _cfg(), seed=7)
    r2 = render(small_scene, _cfg(), seed=7)
    assert np.array_equal(r1.framebuffer_sum, r2.framebuffer_sum)


def test_different_seed_differs(small_scene):
    r1 = render(small_scene, _cfg(), seed=7)
    r2 = render(small_scene, _cfg(), seed=8)
    assert not np.array_equal(r1.framebuffer_sum, r2.framebuffer_sum)


def test_chunk_size_invariance(small_scene):
    r1 = render(small_scene, _cfg(), seed=3, chunk_size=256)
    r2 = render(small_scene, _cfg(), seed=3, chunk_size=100)  # padded tail
    np.testing.assert_allclose(r1.framebuffer_sum, r2.framebuffer_sum, atol=1e-5)


def test_resume_matches_straight_run(small_scene):
    cfg = _cfg()
    states = []
    full = render(small_scene, cfg, seed=5,
                  stratum_callback=lambda s: states.append(s))
    assert len(states) == cfg.effective_spp
    mid = states[1]  # after 2 of 4 strata
    resumed = render(small_scene, cfg, seed=5, resume=mid)
    np.testing.assert_allclose(
        full.framebuffer_sum, resumed.framebuffer_sum, atol=1e-5
    )


def test_bdpt_runs_and_is_deterministic(small_scene):
    cfg = _cfg(integrator="bdpt", image_width=8, samples_per_pixel=1)
    r1 = render(small_scene, cfg, seed=1)
    r2 = render(small_scene, cfg, seed=1)
    assert np.array_equal(r1.framebuffer_sum, r2.framebuffer_sum)
    assert r1.stats.shadow_rays > 0
    assert np.isfinite(r1.framebuffer_sum).all()


def test_stats_populated(small_scene):
    r = render(small_scene, _cfg(), seed=0)
    assert r.stats.rays_traced > 0
    assert r.stats.triangle_tests > 0
    assert r.stats.wall_seconds > 0
    npix = 16 * 16
    # every primary ray enters at least once
    assert r.stats.rays_traced >= npix * 4


def test_rgb8_shape_and_range(small_scene):
    r = render(small_scene, _cfg(), seed=0)
    img = r.rgb8()
    assert img.shape == (16, 16, 3)
    assert img.dtype == np.uint8


def test_checkpoint_roundtrip(tmp_path, small_scene):
    from bpt_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

    state = dict(
        framebuffer_sum=np.ones((4, 4, 3), np.float32) * 2.5,
        strata_done=3,
        seed=9,
    )
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, state)
    back = load_checkpoint(p)
    assert back["strata_done"] == 3 and back["seed"] == 9
    np.testing.assert_array_equal(back["framebuffer_sum"], state["framebuffer_sum"])


def test_checkpoint_records_chunk_size_and_stream(tmp_path):
    from bpt_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, dict(framebuffer_sum=np.zeros((2, 2, 3)),
                            units_done=1, unit_kind="chunk",
                            chunk_size=4096, seed=1))
    back = load_checkpoint(p)
    assert back["chunk_size"] == 4096
    save_checkpoint(p, dict(framebuffer_sum=np.zeros((2, 2, 3)),
                            units_done=2, unit_kind="stratum",
                            stream="jnp", seed=1))
    assert load_checkpoint(p)["stream"] == "jnp"


def test_chunk_resume_rejects_mismatched_chunk_size(small_scene):
    """Chunk-kind checkpoints came from the removed fused path; resuming
    one (here with another chunk size) must raise, not render."""
    resume = dict(framebuffer_sum=np.zeros((16, 16, 3), np.float32),
                  strata_done=1, units_done=1, unit_kind="chunk",
                  chunk_size=128, seed=0)
    with pytest.raises(ValueError):
        render(small_scene, _cfg(), seed=0, resume=resume, chunk_size=64)


def test_stratum_resume_rejects_foreign_stream(small_scene):
    """A stratum checkpoint written by another RNG stream must not
    silently continue on the jnp wavefront loop (the streams differ;
    mixing breaks bitwise-identical resume)."""
    resume = dict(framebuffer_sum=np.zeros((16, 16, 3), np.float32),
                  strata_done=1, units_done=1, unit_kind="stratum",
                  stream="wave", seed=0)
    with pytest.raises(ValueError, match="stream"):
        render(small_scene, _cfg(), seed=0, resume=resume)


@pytest.mark.parametrize("kind,stream", [("chunk", ""), ("chunk", "jnp"),
                                         ("stratum", "fused"),
                                         ("pixel", "jnp")])
def test_resume_of_removed_checkpoint_kind_raises(small_scene, kind, stream):
    resume = dict(framebuffer_sum=np.zeros((16, 16, 3), np.float32),
                  strata_done=2, units_done=2, unit_kind=kind, seed=0)
    if stream:
        resume["stream"] = stream
    with pytest.raises(ValueError, match="no longer has"):
        render(small_scene, _cfg(), seed=0, resume=resume)


def test_resume_without_stream_field_is_jnp_stratum(small_scene):
    """Stratum checkpoints predating the ``stream`` field were written by
    the jnp loop and still resume to the straight run's image."""
    cfg = _cfg()
    states = []
    full = render(small_scene, cfg, seed=5,
                  stratum_callback=lambda s: states.append(dict(s)))
    mid = dict(states[1])
    del mid["stream"], mid["unit_kind"]
    resumed = render(small_scene, cfg, seed=5, resume=mid)
    np.testing.assert_allclose(full.framebuffer_sum, resumed.framebuffer_sum,
                               atol=1e-5)


def test_ref_vis_mode_dims_connections(small_scene):
    """CameraConfig.ref_vis emulates the reference binary's endpoint
    artifact (docs/PARITY.md dev. 2): connection transport must drop
    substantially versus the default estimator, and the emission-only
    strategies must be unaffected (identical RNG stream)."""
    cfg = _cfg(integrator="bdpt", image_width=8, samples_per_pixel=4)
    base = render(small_scene, cfg, seed=0).framebuffer_sum
    emul = render(small_scene, dataclasses.replace(cfg, ref_vis=True),
                  seed=0).framebuffer_sum
    assert np.isfinite(emul).all()
    # globally dimmer by a large factor on this connection-dominated scene
    assert emul.sum() < 0.8 * base.sum()


def test_render_resilient_resumes_after_failure():
    """Elastic render (SURVEY §5 failure-detection analog): a failure
    mid-render resumes from the last completed stratum and the final
    image is bitwise identical to an uninterrupted render."""
    import dataclasses

    from bpt_tpu.models.render import render, render_resilient
    from bpt_tpu.scene.presets import cornell_box, cornell_box_camera

    scene = cornell_box(dtype=jnp.float32)
    cfg = dataclasses.replace(cornell_box_camera(), image_width=12,
                              samples_per_pixel=9, max_depth=3,
                              integrator="pt")
    clean = render(scene, cfg, seed=21)

    fails = {"left": 2}
    seen = []

    def flaky_cb(snap):
        seen.append(int(snap["units_done"]))
        if fails["left"] > 0 and snap["units_done"] == 2:
            fails["left"] -= 1
            raise RuntimeError("injected device failure")

    r = render_resilient(scene, cfg, seed=21, retries=3,
                         stratum_callback=flaky_cb)
    np.testing.assert_array_equal(r.framebuffer_sum, clean.framebuffer_sum)
    # the injected failure fired exactly once (at unit 2) and the resume
    # continued AFTER the completed unit — no unit was re-rendered
    assert fails["left"] == 1
    assert seen == sorted(seen) and seen.count(2) == 1


def test_render_resilient_survives_many_spaced_failures():
    """The retry budget resets whenever progress was made, so a long
    render survives arbitrarily many WIDELY-SPACED transient failures
    (one per stratum here) with retries=1."""
    import dataclasses

    from bpt_tpu.models.render import render, render_resilient
    from bpt_tpu.scene.presets import cornell_box, cornell_box_camera

    scene = cornell_box(dtype=jnp.float32)
    cfg = dataclasses.replace(cornell_box_camera(), image_width=8,
                              samples_per_pixel=16, max_depth=2,
                              integrator="pt")
    clean = render(scene, cfg, seed=5)
    raised = set()

    def fail_once_per_unit(snap):
        u = int(snap["units_done"])
        if u not in raised:
            raised.add(u)
            raise RuntimeError("transient")

    r = render_resilient(scene, cfg, seed=5, retries=1,
                         stratum_callback=fail_once_per_unit)
    np.testing.assert_array_equal(r.framebuffer_sum, clean.framebuffer_sum)
    assert len(raised) == 16  # every stratum failed once, all recovered


def test_render_resilient_exhausts_retries(monkeypatch):
    """Failures with NO recorded progress exhaust the budget and raise."""
    import dataclasses

    import bpt_tpu.models.render as R
    from bpt_tpu.scene.presets import cornell_box, cornell_box_camera

    scene = cornell_box(dtype=jnp.float32)
    cfg = dataclasses.replace(cornell_box_camera(), image_width=8,
                              samples_per_pixel=4, max_depth=2,
                              integrator="pt")
    calls = {"n": 0}

    def bad_render(*a, **k):
        calls["n"] += 1
        raise RuntimeError("boom")

    monkeypatch.setattr(R, "render", bad_render)
    with pytest.raises(RuntimeError):
        R.render_resilient(scene, cfg, seed=1, retries=2)
    # no checkpoint state ever existed -> immediate raise, no retry loop
    assert calls["n"] == 1


def _bvh_scene():
    from bpt_tpu.scene.builder import MaterialSpec as M
    from bpt_tpu.scene.builder import SceneBuilder

    b = SceneBuilder()
    b.add_uv_sphere((0, 1, 0), 1.0, M.lambertian((0.6, 0.5, 0.4)))
    b.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20),
               M.lambertian((0.6, 0.6, 0.6)))
    b.add_quad((-2, 6, -2), (4, 0, 0), (0, 0, 4),
               M.diffuse_light((10, 10, 10)))
    return b.build(dtype=jnp.float32)


def _bvh_cfg(**kw):
    base = dict(image_width=12, aspect_ratio=1.0, samples_per_pixel=4,
                max_depth=3, integrator="pt", lookfrom=(0.0, 2.0, 6.0),
                lookat=(0.0, 1.0, 0.0), vfov=40.0)
    base.update(kw)
    return dataclasses.replace(cornell_box_camera(), **base)


@pytest.mark.parametrize("integrator", ["pt", "bdpt", "bdpt-mis"])
def test_render_bvh_scene_populates_traversal_stats(integrator):
    """BVH scenes report every traversal counter (node visits, AABB
    hits, triangle tests and hits) next to the ray counts."""
    scene = _bvh_scene()
    assert scene.use_bvh
    res = render(scene, _bvh_cfg(integrator=integrator, samples_per_pixel=1),
                 seed=3)
    assert res.stats.rays_traced > 0
    assert res.stats.bvh_node_visits > 0
    assert res.stats.aabb_hits > 0
    assert res.stats.triangle_tests > 0
    assert res.stats.triangle_hits > 0
    assert res.stats.bvh_nodes_built == scene.bvh_skip.shape[0]
    if integrator != "pt":
        assert res.stats.shadow_rays > 0


@pytest.mark.parametrize("integrator", ["bdpt", "bdpt-mis"])
def test_bvh_scene_chunk_and_resume_invariance(integrator):
    """On the BVH scene, chunking and a mid-render stratum resume give
    the straight run's image bit for bit (absolute ray ids drive every
    draw)."""
    scene = _bvh_scene()
    cfg = _bvh_cfg(integrator=integrator)
    ref = render(scene, cfg, seed=11)
    chunked = render(scene, cfg, seed=11, chunk_size=50)
    np.testing.assert_array_equal(ref.framebuffer_sum,
                                  chunked.framebuffer_sum)
    states = []
    render(scene, cfg, seed=11,
           stratum_callback=lambda s: states.append(dict(s)))
    resumed = render(scene, cfg, seed=11, resume=states[1])
    np.testing.assert_array_equal(ref.framebuffer_sum,
                                  resumed.framebuffer_sum)


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("limit,want", [
    (None, 256 << 20),                       # CPU: no device limit
    (80 << 30, (80 << 30) // 16),            # card: a 1/16 share
    (16 << 30, (16 << 30) // 16),
])
def test_vertex_budget_follows_device_memory(monkeypatch, limit, want):
    import bpt_tpu.models.render as R

    stats = None if limit is None else {"bytes_limit": limit}
    monkeypatch.setattr(R.jax, "devices", lambda: [_FakeDevice(stats)])
    assert R._vertex_budget_bytes() == want


def test_default_chunk_size_scales_with_device_memory(monkeypatch):
    import bpt_tpu.models.render as R

    def chunk(limit, integrator="bdpt-mis", depth=10, npix=512 * 512):
        monkeypatch.setattr(R.jax, "devices", lambda: [_FakeDevice(
            {"bytes_limit": limit})])
        return R.default_chunk_size(integrator, depth, npix)

    # d10 bdpt-mis: 6,880 bytes of vertex/MIS storage per ray
    assert chunk(1 << 30) == (1 << 30) // 16 // 6880
    assert chunk(80 << 30) == 1 << 18   # capped at one 512^2 stratum
    assert chunk(80 << 30, npix=100) == 1024  # floor
    assert chunk(1 << 30, integrator="pt") == 1 << 18
    assert chunk(16 << 30, depth=80) < chunk(16 << 30, depth=10)
