"""Multi-controller runtime tests: REAL separate OS processes wired by
jax.distributed (gloo collectives on CPU — the DCN analog), not just a
virtual in-process mesh.  Pixel sharding's determinism contract extends
across process counts: 2 processes x 4 devices == 1 process x 8 devices
== the in-process single-device render, bit-for-bit.

Reference analog: the thread-pool render loop (src/camera.h:57-134)
scaled past one process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bpt_tpu.models.render import render
from bpt_tpu.parallel.multiprocess import launch_local
from bpt_tpu.scene.presets import cornell_box, cornell_box_camera

SIZE = "24x24"
SPP = 4
DEPTH = 3


def _run(tmp_path, nproc, local_devices):
    out = tmp_path / f"fb_{nproc}.npy"
    launch_local(
        nproc,
        ["--size", SIZE, "--spp", str(SPP), "--max-depth", str(DEPTH),
         "--seed", "7", "--output", str(out)],
        local_device_count=local_devices,
        timeout=540.0,
    )
    return np.load(out)


def test_two_processes_match_one_process_and_local(tmp_path):
    fb2 = _run(tmp_path, 2, 4)   # 2 procs x 4 devices
    fb1 = _run(tmp_path, 1, 8)   # 1 proc x 8 devices
    np.testing.assert_array_equal(fb2, fb1)

    scene = cornell_box(dtype=jnp.float32)
    cfg = dataclasses.replace(
        cornell_box_camera(), image_width=24, aspect_ratio=1.0,
        samples_per_pixel=SPP, max_depth=DEPTH, integrator="pt")
    local = render(scene, cfg, seed=7)
    np.testing.assert_array_equal(fb2, local.framebuffer_sum)


def _run_cfg(tmp_path, nproc, local_devices, extra, tag):
    out = tmp_path / f"fb_{tag}.npy"
    launch_local(
        nproc,
        ["--size", "16x16", "--spp", str(SPP), "--max-depth", str(DEPTH),
         "--seed", "7", "--output", str(out)] + extra,
        local_device_count=local_devices,
        timeout=540.0,
    )
    return np.load(out)


def _inprocess_distributed(integrator):
    from bpt_tpu.parallel.mesh import make_mesh, render_distributed

    scene = cornell_box(dtype=jnp.float32)
    cfg = dataclasses.replace(
        cornell_box_camera(), image_width=16, aspect_ratio=1.0,
        samples_per_pixel=SPP, max_depth=DEPTH, integrator=integrator)
    mesh = make_mesh(devices=jax.devices())
    fb, _spp = render_distributed(scene, cfg, mesh=mesh, seed=7)
    return scene, cfg, fb


def test_multiprocess_bdpt_mis_matches_inprocess_and_local(tmp_path):
    """The multi-controller runtime on the
    de-facto reference integrator — 2-process bdpt-mis over the global
    mesh == the in-process mesh render bit-for-bit (the gloo allgather
    composed with the per-stratum bdpt shard step; pixel sharding is
    mesh-shape invariant), and == the single-device render within fp
    reassociation noise (XLA fuses the shard step differently than the
    local loop: one element at ~4e-9 on this config)."""
    fb = _run_cfg(tmp_path, 2, 2, ["--integrator", "bdpt-mis"], "mis")
    scene, cfg, fb_ref = _inprocess_distributed("bdpt-mis")
    np.testing.assert_array_equal(fb, fb_ref)
    local = render(scene, cfg, seed=7)
    np.testing.assert_allclose(fb, local.framebuffer_sum,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("process_id", [0, 3])
def test_card_workers_each_see_one_card(process_id):
    """On a GPU host (no virtual devices) worker I sees only card I, so
    no worker reserves memory on another worker's card."""
    from bpt_tpu.parallel.multiprocess import worker_env

    env = worker_env({"XLA_FLAGS": "--foo", "PATH": "/bin",
                      "CUDA_VISIBLE_DEVICES": "0,1,2,3"}, process_id, 0)
    assert env["CUDA_VISIBLE_DEVICES"] == str(process_id)
    assert "XLA_FLAGS" not in env and env["PATH"] == "/bin"


def test_virtual_device_workers_leave_card_choice_alone():
    from bpt_tpu.parallel.multiprocess import worker_env

    env = worker_env({"XLA_FLAGS": "--foo"}, 1, 4)
    assert "CUDA_VISIBLE_DEVICES" not in env and "XLA_FLAGS" not in env


def test_launch_local_surfaces_worker_failure(tmp_path):
    with pytest.raises(RuntimeError, match="worker .* exited"):
        launch_local(1, ["--size", "notasize", "--output",
                         str(tmp_path / "x.npy")],
                     local_device_count=2, timeout=240.0)
