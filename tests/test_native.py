"""Native (C++) host runtime vs the Python fallbacks: exact equality."""

import numpy as np
import pytest

from bpt_tpu import native
from bpt_tpu.scene.bvh import build_bvh
from bpt_tpu.scene.obj import parse_obj

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib unavailable (no g++?)"
)


@pytest.mark.parametrize("n", [1, 2, 3, 17, 256, 5000])
def test_native_bvh_matches_python(n):
    rng = np.random.default_rng(n)
    c = rng.uniform(-10, 10, (n, 3))
    ext = rng.uniform(0.01, 2.0, (n, 3))
    tri_min = c - ext
    tri_max = c + ext
    a = build_bvh(tri_min, tri_max, use_native=False)
    b = native.build_bvh_native(tri_min, tri_max)
    for k in ("bvh_skip", "bvh_first", "bvh_count", "order"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("bvh_min", "bvh_max"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_native_obj_matches_python(tmp_path):
    p = tmp_path / "t.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 1\nv 0.5 -2.25 3e-2\n"
        "vn 0 0 1\nvt 0 0\n"
        "f 1/1/1 2//1 3\n"
        "f 1 2 3 4\n"
        "f -5 -4 -3\n"
        "f 1 junk 3\n"
    )
    a = parse_obj(str(p), use_native=False)
    b = native.parse_obj_native(str(p))
    assert len(a) == len(b)
    np.testing.assert_array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))


def test_native_obj_missing_file():
    with pytest.raises(FileNotFoundError):
        native.parse_obj_native("/nonexistent/path.obj")


def test_build_speed_sanity():
    # not a benchmark — just exercises a big build through the native path
    rng = np.random.default_rng(0)
    n = 20000
    c = rng.uniform(-10, 10, (n, 3))
    tri_min = c - 0.1
    tri_max = c + 0.1
    out = native.build_bvh_native(tri_min, tri_max)
    assert out["order"].shape == (n,)
    skip = out["bvh_skip"]
    assert (skip > np.arange(len(skip))).all()


def _subtree_tris(skip, count):
    """Triangles under each node of a preorder/skip-link BVH."""
    pre = np.zeros(len(skip) + 1, np.int64)
    pre[1:] = np.cumsum(count)
    return pre[np.asarray(skip)] - pre[:-1]


def test_packed_splits_fill_streaming_blocks():
    """The 32-multiple split (scene/bvh.py rec + the native builder): on a
    balanced mesh of a 32-multiple size every maximal <=32-tri subtree is
    full and every leaf holds 2 triangles — the fewer nodes the GPU
    traversal kernel walks (PERF.md)."""
    from bpt_tpu.scene import bvh as bvh_mod

    rng = np.random.default_rng(5)
    T = 4096
    c = rng.uniform(0, 10, (T, 3))
    h = rng.uniform(0.01, 0.05, (T, 3))
    tree = bvh_mod.build_bvh(c - h, c + h)
    skip, count = tree["bvh_skip"], tree["bvh_count"]
    tris = _subtree_tris(skip, count)
    sizes, pos = [], 0
    while pos < len(skip):  # maximal subtrees of <= 32 triangles
        if tris[pos] <= 32:
            sizes.append(int(tris[pos]))
            pos = int(skip[pos])
        else:
            pos += 1
    assert sum(sizes) == T and set(sizes) == {32}
    assert (count[count > 0] == 2).all()
    assert len(skip) == T - 1

    # the numpy and native builders agree on the packed policy too
    tree_py = bvh_mod.build_bvh(c - h, c + h, use_native=False)
    np.testing.assert_array_equal(tree["bvh_skip"], tree_py["bvh_skip"])
    np.testing.assert_array_equal(tree["order"], tree_py["order"])


@pytest.mark.parametrize("n", [33, 97, 1000])
def test_split_stays_within_16_of_the_median(n):
    """Every internal node splits within 16 triangles of its median, so
    box quality matches the reference's span/2 split at depth."""
    from bpt_tpu.scene import bvh as bvh_mod

    rng = np.random.default_rng(n)
    c = rng.uniform(0, 10, (n, 3))
    tree = bvh_mod.build_bvh(c - 0.05, c + 0.05)
    skip, count = tree["bvh_skip"], tree["bvh_count"]
    tris = _subtree_tris(skip, count)
    for i in np.nonzero(count == 0)[0]:
        left = tris[i + 1]
        assert abs(int(left) - int(tris[i]) // 2) <= 16
