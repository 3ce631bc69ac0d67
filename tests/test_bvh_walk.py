"""The per-ray BVH traversal kernel (ops/pallas/bvh_walk.py) against the
jnp walks it replaces on the GPU (soa.bvh_closest / bvh_any) and brute
force.  Here the kernel runs in Pallas interpret mode, where its
arithmetic is the jnp walks' own: results and traversal counters must
agree bit for bit.  The ``gpu`` cases compile it for the card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bpt_tpu.core import vec3 as v3
from bpt_tpu.ops import soa
from bpt_tpu.ops.intersect import T_MIN
from bpt_tpu.ops.pallas import bvh_walk
from bpt_tpu.scene.builder import MaterialSpec as M
from bpt_tpu.scene.builder import SceneBuilder


def _soup(n_tris, seed):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mat = M.lambertian((0.5, 0.5, 0.5))
    for c in rng.uniform(-4, 4, size=(n_tris, 3)):
        ofs = rng.normal(size=(3, 3)) * rng.uniform(0.05, 1.0)
        b.add_triangle(c + ofs[0], c + ofs[1], c + ofs[2], mat)
    return b.build(dtype=jnp.float32, use_bvh=True,
                   light_fallback_to_world=False)


def _sphere_floor():
    b = SceneBuilder()
    b.add_uv_sphere((0, 1, 0), 1.0, M.lambertian((0.7, 0.3, 0.2)),
                    lat_steps=8, lon_steps=16)
    b.add_quad((-6, 0, -6), (12, 0, 0), (0, 0, 12),
               M.lambertian((0.6, 0.6, 0.6)))
    return b.build(dtype=jnp.float32, use_bvh=True)


def _boxes():
    """Axis-aligned quads: flat node boxes (padded to 1e-4) and rays
    parallel to their planes — the slab test's NaN/inf lanes."""
    b = SceneBuilder()
    m = M.lambertian((0.5, 0.5, 0.5))
    for k in range(4):
        b.add_quad((k, 0, -1), (0.8, 0, 0), (0, 0, 2), m)
        b.add_quad((k, 0, -1), (0, 1, 0), (0, 0, 2), m)
    return b.build(dtype=jnp.float32, use_bvh=True)


SCENES = {
    "soup17": lambda: _soup(17, 1),
    "soup200": lambda: _soup(200, 2),
    "sphere_floor": _sphere_floor,
    "boxes": _boxes,
}


@functools.lru_cache(maxsize=None)
def _scene(name):
    return SCENES[name]()


def _rays(scene, B, seed, axis_aligned=False):
    rng = np.random.default_rng(seed)
    lo = np.asarray(scene.bvh_min[0]) - 1.0
    hi = np.asarray(scene.bvh_max[0]) + 1.0
    o = rng.uniform(lo, hi, (B, 3))
    d = rng.normal(size=(B, 3))
    if axis_aligned:
        # every third ray runs along an axis (zero direction components)
        d[::3] = np.eye(3)[rng.integers(0, 3, size=d[::3].shape[0])]
        o[1::6, 1] = 0.0  # some start exactly on the quads' plane
    return (v3.from_array(jnp.asarray(o, jnp.float32)),
            v3.from_array(jnp.asarray(d, jnp.float32)))


def _tmax(B, seed, masked):
    tmax = np.full((B,), np.inf, np.float32)
    if masked:
        tmax[np.random.default_rng(seed).uniform(size=B) < 0.4] = 0.0
    return jnp.asarray(tmax)


def _assert_closest_equal(got, ref):
    t, tri, u, v, counters = got
    hit = np.asarray(tri) >= 0
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_array_equal(np.asarray(t)[hit], np.asarray(ref.t)[hit])
    np.testing.assert_array_equal(np.asarray(tri)[hit],
                                  np.asarray(ref.tri)[hit])
    np.testing.assert_array_equal(np.asarray(u)[hit], np.asarray(ref.u)[hit])
    np.testing.assert_array_equal(np.asarray(v)[hit], np.asarray(ref.v)[hit])
    assert [int(np.sum(c)) for c in counters] == [
        int(ref.node_visits), int(ref.aabb_hits), int(ref.tri_tests),
        int(ref.tri_hits)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B", [1, 63, 130])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_closest_matches_jnp_walk(name, B, masked):
    """Same hits, t, barycentrics and counters as soa.bvh_closest, for
    waves that are not a multiple of the block (padding lanes must
    neither hit nor count)."""
    scene = _scene(name)
    o, d = _rays(scene, B, seed=B, axis_aligned=(name == "boxes"))
    tmax = _tmax(B, B, masked)
    got = bvh_walk.closest(scene, o, d, T_MIN, tmax, interpret=True)
    ref = soa.bvh_closest(scene, o, d, T_MIN, tmax)
    _assert_closest_equal(got, ref)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_any_matches_jnp_walk_and_brute(name, masked):
    scene = _scene(name)
    B = 97
    o, d = _rays(scene, B, seed=7, axis_aligned=(name == "boxes"))
    rng = np.random.default_rng(11)
    tmax = rng.uniform(0.2, 6.0, B).astype(np.float32)
    if masked:
        tmax[rng.uniform(size=B) < 0.4] = 0.0
    tmax = jnp.asarray(tmax)
    tmin = jnp.full((B,), T_MIN, jnp.float32)
    got = np.asarray(bvh_walk.any_hit(scene, o, d, T_MIN, tmax,
                                      interpret=True))
    np.testing.assert_array_equal(
        got, np.asarray(soa.bvh_any(scene, o, d, tmin, tmax)))
    np.testing.assert_array_equal(
        got, np.asarray(soa.brute_any(scene, o, d, tmin, tmax)))


@pytest.mark.parametrize("tmin,tmax", [(T_MIN, 2.5), (0.5, np.inf),
                                       (1.0, 3.0)])
def test_closest_interval_matches_brute(tmin, tmax):
    """(tmin, tmax] on the kernel == the brute-force [T, B] broadcast."""
    scene = _scene("soup200")
    B = 80
    o, d = _rays(scene, B, seed=3)
    t, tri, u, v, _ = bvh_walk.closest(scene, o, d, tmin, tmax,
                                       interpret=True)
    bf = soa.brute_closest(scene, o, d, jnp.full((B,), tmin, jnp.float32),
                           jnp.full((B,), tmax, jnp.float32))
    hit = np.asarray(tri) >= 0
    np.testing.assert_array_equal(hit, np.asarray(bf.hit))
    np.testing.assert_allclose(np.asarray(t)[hit], np.asarray(bf.t)[hit],
                               rtol=1e-6)


def test_per_lane_intervals():
    """tmin and tmax may be per-lane arrays (connection waves)."""
    scene = _scene("sphere_floor")
    B = 70
    o, d = _rays(scene, B, seed=5)
    rng = np.random.default_rng(5)
    tmin = jnp.asarray(rng.uniform(1e-3, 0.5, B), jnp.float32)
    tmax = jnp.asarray(rng.uniform(0.5, 8.0, B), jnp.float32)
    got = bvh_walk.closest(scene, o, d, tmin, tmax, interpret=True)
    _assert_closest_equal(got, soa.bvh_closest(scene, o, d, tmin, tmax))
    np.testing.assert_array_equal(
        np.asarray(bvh_walk.any_hit(scene, o, d, tmin, tmax,
                                    interpret=True)),
        np.asarray(soa.bvh_any(scene, o, d, tmin, tmax)))


def test_pack_tables_layout():
    scene = _scene("soup17")
    nf, ni, tf = bvh_walk.pack_tables(scene)
    n = scene.bvh_skip.shape[0]
    assert nf.dtype == jnp.float32 and tf.dtype == jnp.float32
    assert ni.dtype == jnp.int32
    nf = np.asarray(nf).reshape(n, 8)
    ni = np.asarray(ni).reshape(n, 4)
    np.testing.assert_array_equal(nf[:, :3], np.asarray(scene.bvh_min))
    np.testing.assert_array_equal(nf[:, 3:6], np.asarray(scene.bvh_max))
    np.testing.assert_array_equal(ni[:, 0], np.asarray(scene.bvh_skip))
    np.testing.assert_array_equal(ni[:, 1], np.asarray(scene.bvh_first))
    np.testing.assert_array_equal(ni[:, 2], np.asarray(scene.bvh_count))
    tf = np.asarray(tf).reshape(scene.num_tris, 9)
    np.testing.assert_array_equal(tf[:, 3:6], np.asarray(scene.e1))


def test_inputs_are_cast_to_float32():
    """Under x64 the wrapper still launches a float32 kernel."""
    scene = _scene("soup17")
    o, d = _rays(scene, 5, seed=1)
    o64 = v3.Vec3(*(c.astype(jnp.float64) for c in o))
    d64 = v3.Vec3(*(c.astype(jnp.float64) for c in d))
    t, tri, u, v, _ = bvh_walk.closest(scene, o64, d64, T_MIN, jnp.inf,
                                       interpret=True)
    assert t.dtype == jnp.float32 and tri.dtype == jnp.int32
    ref = bvh_walk.closest(scene, o, d, T_MIN, jnp.inf, interpret=True)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(ref[0]))


@pytest.mark.parametrize("entry", ["closest", "any_hit"])
def test_kernel_lowers_to_triton_for_cuda(entry):
    """The Triton route accepts the kernel: lowering for CUDA runs on the
    host, so an unsupported primitive fails here, not on the card."""
    scene = _scene("soup17")
    o, d = _rays(scene, 64, seed=2)
    fn = getattr(bvh_walk, entry)
    lowered = jax.jit(lambda s, o, d: fn(s, o, d, T_MIN, 5.0)).trace(
        scene, o, d).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "triton" in text
    assert ("bvh_closest" if entry == "closest" else "bvh_any") in text


# ------------------------------------------------------------- routing


@pytest.mark.parametrize(
    "backend,use_bvh,dtype,want",
    [("gpu", True, jnp.float32, True),
     ("cpu", True, jnp.float32, False),
     ("gpu", False, jnp.float32, False),
     ("gpu", True, jnp.float64, False)])
def test_routing(monkeypatch, backend, use_bvh, dtype, want):
    import dataclasses

    scene = dataclasses.replace(_scene("soup17"), use_bvh=use_bvh)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert soa.use_traversal_kernel(scene, dtype) is want


def _route_kernel_interpret(monkeypatch):
    monkeypatch.setattr(soa, "use_traversal_kernel", lambda s, dt: True)
    monkeypatch.setattr(
        soa.bvh_walk, "closest",
        functools.partial(bvh_walk.closest, interpret=True))
    monkeypatch.setattr(
        soa.bvh_walk, "any_hit",
        functools.partial(bvh_walk.any_hit, interpret=True))


def test_dispatch_kernel_route_matches_jnp_route(monkeypatch):
    """soa.closest_hit / any_hit through the kernel route == the jnp
    route, masks and the culled-lane counter correction included."""
    scene = _scene("sphere_floor")
    B = 90
    o, d = _rays(scene, B, seed=9)
    mask = jnp.asarray(np.random.default_rng(9).uniform(size=B) < 0.7)
    ref_c = soa.closest_hit(scene, o, d, T_MIN, jnp.inf, mask=mask)
    ref_a = soa.any_hit(scene, o, d, T_MIN, 3.0, mask=mask)
    _route_kernel_interpret(monkeypatch)
    got_c = soa.closest_hit(scene, o, d, T_MIN, jnp.inf, mask=mask)
    got_a = soa.any_hit(scene, o, d, T_MIN, 3.0, mask=mask)
    for a, b in zip(got_c, ref_c):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(got_a), np.asarray(ref_a))


@pytest.mark.parametrize("integrator", ["pt", "bdpt", "bdpt-mis"])
def test_render_kernel_route_matches_jnp_route(monkeypatch, integrator):
    """A whole render through the kernel route (interpret mode) is
    bit-identical to the jnp route, and the step cache keys on the route
    (the second render must not reuse the first route's step)."""
    import dataclasses

    from bpt_tpu.models.render import render
    from bpt_tpu.scene.presets import cornell_box_camera

    scene = _scene("sphere_floor")
    cfg = dataclasses.replace(
        cornell_box_camera(), image_width=6, aspect_ratio=1.0,
        samples_per_pixel=1, max_depth=2, integrator=integrator,
        lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0), vfov=40.0)
    ref = render(scene, cfg, seed=4)
    _route_kernel_interpret(monkeypatch)
    got = render(scene, cfg, seed=4)
    np.testing.assert_array_equal(got.framebuffer_sum, ref.framebuffer_sum)
    assert got.stats.rays_traced == ref.stats.rays_traced
    assert got.stats.bvh_node_visits == ref.stats.bvh_node_visits


# ----------------------------------------------------------------- card


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run: JAX_PLATFORMS=cuda python -m "
                    "pytest tests/test_bvh_walk.py -m gpu)")
    return jax.devices()[0]


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_gpu_kernel_matches_jnp_walk(gpu, masked):
    """Compiled for the card: hit/miss identical; t, u, v within 1e-6
    relative (FMA contraction may differ from XLA's); tri identical
    except where two triangles tie in t."""
    scene = _scene("sphere_floor")
    B = 4096
    o, d = _rays(scene, B, seed=21)
    tmax = _tmax(B, 21, masked)
    t, tri, u, v, _ = bvh_walk.closest(scene, o, d, T_MIN, tmax)
    ref = soa.bvh_closest(scene, o, d, T_MIN, tmax)
    hit = np.asarray(tri) >= 0
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_allclose(np.asarray(t)[hit], np.asarray(ref.t)[hit],
                               rtol=1e-6)
    diff = np.asarray(tri)[hit] != np.asarray(ref.tri)[hit]
    assert (np.abs(np.asarray(t)[hit][diff] - np.asarray(ref.t)[hit][diff])
            <= 1e-6 * np.asarray(ref.t)[hit][diff]).all()
    tmin = jnp.full((B,), T_MIN, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(bvh_walk.any_hit(scene, o, d, T_MIN, jnp.minimum(tmax, 3.0))),
        np.asarray(soa.bvh_any(scene, o, d, tmin, jnp.minimum(tmax, 3.0))))
