"""Intersection + BVH tests: Möller–Trumbore cases, slab tests, and the
BVH == brute-force property test on random triangle soups."""

import jax.numpy as jnp
import numpy as np
import pytest

from bpt_tpu.ops.intersect import (
    brute_force_any,
    brute_force_closest,
    moller_trumbore,
    slab_test,
)
from bpt_tpu.ops.traverse import any_hit, closest_hit
from bpt_tpu.scene.builder import MaterialSpec, SceneBuilder


def _tri(v0, v1, v2, dtype=jnp.float64):
    v0 = jnp.asarray(v0, dtype)
    v1 = jnp.asarray(v1, dtype)
    v2 = jnp.asarray(v2, dtype)
    return v0, v1 - v0, v2 - v0


class TestMollerTrumbore:
    def test_hit_center(self):
        v0, e1, e2 = _tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
        o = jnp.array([0.25, 0.25, 1.0], jnp.float64)
        d = jnp.array([0.0, 0.0, -1.0], jnp.float64)
        ok, t, u, v = moller_trumbore(o, d, v0, e1, e2, 1e-3, jnp.inf)
        assert bool(ok) and np.isclose(float(t), 1.0)
        assert np.isclose(float(u), 0.25) and np.isclose(float(v), 0.25)

    def test_miss_outside(self):
        v0, e1, e2 = _tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
        o = jnp.array([0.8, 0.8, 1.0], jnp.float64)  # u+v > 1
        d = jnp.array([0.0, 0.0, -1.0], jnp.float64)
        ok, *_ = moller_trumbore(o, d, v0, e1, e2, 1e-3, jnp.inf)
        assert not bool(ok)

    def test_parallel_ray(self):
        v0, e1, e2 = _tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
        o = jnp.array([0.0, 0.0, 1.0], jnp.float64)
        d = jnp.array([1.0, 0.0, 0.0], jnp.float64)  # det ~ 0
        ok, *_ = moller_trumbore(o, d, v0, e1, e2, 1e-3, jnp.inf)
        assert not bool(ok)

    def test_edge_hit(self):
        v0, e1, e2 = _tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
        o = jnp.array([0.5, 0.0, 1.0], jnp.float64)  # on v=0 edge
        d = jnp.array([0.0, 0.0, -1.0], jnp.float64)
        ok, _, u, v = moller_trumbore(o, d, v0, e1, e2, 1e-3, jnp.inf)
        assert bool(ok) and np.isclose(float(v), 0.0)

    def test_tmin_excludes(self):
        v0, e1, e2 = _tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
        o = jnp.array([0.25, 0.25, 0.0005], jnp.float64)
        d = jnp.array([0.0, 0.0, -1.0], jnp.float64)
        ok, *_ = moller_trumbore(o, d, v0, e1, e2, 1e-3, jnp.inf)
        assert not bool(ok)  # t = 0.0005 < 1e-3

    def test_unnormalized_direction_t_scaling(self):
        v0, e1, e2 = _tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
        o = jnp.array([0.25, 0.25, 2.0], jnp.float64)
        d = jnp.array([0.0, 0.0, -4.0], jnp.float64)
        ok, t, _, _ = moller_trumbore(o, d, v0, e1, e2, 1e-3, jnp.inf)
        assert bool(ok) and np.isclose(float(t), 0.5)


class TestSlab:
    def test_hit_and_miss(self):
        bmin = jnp.array([0.0, 0.0, 0.0], jnp.float64)
        bmax = jnp.array([1.0, 1.0, 1.0], jnp.float64)
        o = jnp.array([0.5, 0.5, -1.0], jnp.float64)
        assert bool(slab_test(o, jnp.array([0.0, 0.0, 1.0], jnp.float64), bmin, bmax, 1e-3, jnp.inf))
        assert not bool(slab_test(o, jnp.array([0.0, 0.0, -1.0], jnp.float64), bmin, bmax, 1e-3, jnp.inf))

    def test_negative_direction(self):
        bmin = jnp.array([0.0, 0.0, 0.0], jnp.float64)
        bmax = jnp.array([1.0, 1.0, 1.0], jnp.float64)
        o = jnp.array([0.5, 0.5, 2.0], jnp.float64)
        d = jnp.array([0.0, 0.0, -1.0], jnp.float64)
        assert bool(slab_test(o, d, bmin, bmax, 1e-3, jnp.inf))

    def test_zero_component_inside_slab(self):
        bmin = jnp.array([0.0, 0.0, 0.0], jnp.float64)
        bmax = jnp.array([1.0, 1.0, 1.0], jnp.float64)
        o = jnp.array([0.5, 0.5, -1.0], jnp.float64)
        d = jnp.array([0.0, 0.0, 1.0], jnp.float64)  # dx = dy = 0, inside slabs
        assert bool(slab_test(o, d, bmin, bmax, 1e-3, jnp.inf))
        # outside the x slab with dx = 0 -> never hits
        o2 = jnp.array([2.0, 0.5, -1.0], jnp.float64)
        assert not bool(slab_test(o2, d, bmin, bmax, 1e-3, jnp.inf))

    def test_tmax_limits(self):
        bmin = jnp.array([0.0, 0.0, 0.0], jnp.float64)
        bmax = jnp.array([1.0, 1.0, 1.0], jnp.float64)
        o = jnp.array([0.5, 0.5, -2.0], jnp.float64)
        d = jnp.array([0.0, 0.0, 1.0], jnp.float64)
        assert not bool(slab_test(o, d, bmin, bmax, 1e-3, 1.0))  # box at t in [2,3]


def _random_soup_scene(n_tris, seed, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mat = MaterialSpec.lambertian((0.5, 0.5, 0.5))
    centers = rng.uniform(-5, 5, size=(n_tris, 3))
    for c in centers:
        ofs = rng.normal(size=(3, 3)) * rng.uniform(0.05, 1.0)
        b.add_triangle(c + ofs[0], c + ofs[1], c + ofs[2], mat)
    return b.build(dtype=dtype, use_bvh=True, light_fallback_to_world=False)


@pytest.mark.parametrize("n_tris,seed", [(3, 0), (17, 1), (64, 2), (257, 3)])
def test_bvh_matches_brute_force(n_tris, seed):
    scene = _random_soup_scene(n_tris, seed)
    rng = np.random.default_rng(seed + 100)
    B = 256
    o = jnp.asarray(rng.uniform(-8, 8, size=(B, 3)), jnp.float64)
    d = jnp.asarray(rng.normal(size=(B, 3)), jnp.float64)

    bvh_hit, _ = closest_hit(scene, o, d, 1e-3, jnp.inf)
    brute = brute_force_closest(scene.v0, scene.e1, scene.e2, o, d,
                                jnp.full((B,), 1e-3), jnp.full((B,), jnp.inf))

    assert np.array_equal(np.asarray(bvh_hit.hit), np.asarray(brute.hit))
    m = np.asarray(brute.hit)
    assert np.allclose(np.asarray(bvh_hit.t)[m], np.asarray(brute.t)[m], rtol=1e-12)
    assert np.array_equal(np.asarray(bvh_hit.tri)[m], np.asarray(brute.tri)[m])
    assert np.allclose(np.asarray(bvh_hit.u)[m], np.asarray(brute.u)[m], rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_any_hit_matches_brute(seed):
    scene = _random_soup_scene(40, seed)
    rng = np.random.default_rng(seed + 7)
    B = 256
    o = jnp.asarray(rng.uniform(-8, 8, size=(B, 3)), jnp.float64)
    d = jnp.asarray(rng.normal(size=(B, 3)), jnp.float64)
    tmax = jnp.asarray(rng.uniform(0.5, 20.0, size=(B,)), jnp.float64)

    a = any_hit(scene, o, d, 1e-3, tmax)
    bf = brute_force_any(scene.v0, scene.e1, scene.e2, o, d,
                         jnp.full((B,), 1e-3), tmax)
    assert np.array_equal(np.asarray(a), np.asarray(bf))


def test_bvh_structure_invariants():
    scene = _random_soup_scene(100, 5)
    skip = np.asarray(scene.bvh_skip)
    count = np.asarray(scene.bvh_count)
    first = np.asarray(scene.bvh_first)
    N = len(skip)
    # skip links monotone and in range
    idx = np.arange(N)
    assert (skip > idx).all() and (skip <= N).all()
    # leaves cover all triangles exactly once, in order
    leaves = count > 0
    spans = [(f, f + c) for f, c in zip(first[leaves], count[leaves])]
    spans.sort()
    covered = []
    for a, b in spans:
        covered.extend(range(a, b))
    assert covered == list(range(scene.num_tris))
    # node bboxes contain their leaf triangles
    v0 = np.asarray(scene.v0)
    e1 = np.asarray(scene.e1)
    e2 = np.asarray(scene.e2)
    bmin = np.asarray(scene.bvh_min)
    bmax = np.asarray(scene.bvh_max)
    for ni in np.nonzero(leaves)[0]:
        for ti in range(first[ni], first[ni] + count[ni]):
            pts = np.stack([v0[ti], v0[ti] + e1[ti], v0[ti] + e2[ti]])
            assert (pts >= bmin[ni] - 1e-9).all()
            assert (pts <= bmax[ni] + 1e-9).all()
