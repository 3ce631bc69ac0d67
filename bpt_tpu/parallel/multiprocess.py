"""True multi-controller (multi-process) rendering runtime.

The reference's parallelism is a single-process thread pool with an
atomic row queue (src/camera.h:57-134); scaling past one machine would
mean one OS process per node.  The JAX analog is multi-controller SPMD:
one Python process per host (or per card), `jax.distributed.initialize`
wiring the processes into one runtime, a GLOBAL `Mesh` spanning every
process's devices, and the exact pixel-sharded render of
`parallel/mesh.py` — each process computes only its addressable
framebuffer shard, and cross-process data movement happens once, at the
final framebuffer gather (gloo collectives on CPU, NCCL between GPUs —
same program either way).

Pieces:

* `init_multiprocess(...)` — process-side runtime bring-up (the
  distributed service handshake, plus virtual CPU devices for
  single-machine test runs or one card per process on a GPU host).
* `render_multiprocess(...)` — global-mesh render; returns the fully
  gathered framebuffer on every process.
* `launch_local(...)` / `python -m bpt_tpu.parallel.launch` — the
  single-machine N-process launcher (torchrun analog) used by tests and
  the CLI; real clusters start one worker per host instead.

Determinism contract: identical to `render_distributed` — pixel
sharding is bit-identical to the single-device render at any process
count (absolute ray ids drive the RNG; tests assert equality).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_multiprocess(
    process_id: int,
    num_processes: int,
    coordinator: str = "localhost:29500",
    local_device_count: Optional[int] = None,
) -> None:
    """Bring up this process's slice of the global JAX runtime.

    Must run before any other JAX API touches the backend.
    ``local_device_count`` forces that many virtual CPU devices (the
    single-machine test topology); leave None on real hardware, where
    the launcher has already limited the process to its own card
    (``CUDA_VISIBLE_DEVICES``) or a cluster scheduler did.
    """
    import jax

    if local_device_count:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{local_device_count}").strip()
        jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def render_multiprocess(scene, cfg, seed: int = 0,
                        integrator: Optional[str] = None):
    """Pixel-sharded render over the GLOBAL device mesh (all processes).

    Every process must call this collectively (SPMD).  Returns
    ``(framebuffer_sum [H, W, 3] np.ndarray, spp_eff)`` — fully
    gathered, identical on every process.
    """
    import jax

    from bpt_tpu.parallel.mesh import make_mesh, render_distributed

    mesh = make_mesh(devices=jax.devices())
    return render_distributed(scene, cfg, mesh=mesh, seed=seed,
                              integrator=integrator)


def launch_local(num_processes: int, worker_args: Sequence[str],
                 local_device_count: int = 4,
                 timeout: float = 600.0) -> list[str]:
    """Spawn ``num_processes`` worker processes on this machine (the
    torchrun analog) and wait for completion.  Each worker runs

        python -m bpt_tpu.parallel.worker --process-id I \
            --num-processes N --coordinator localhost:PORT \
            --local-devices K <worker_args...>

    ``local_device_count`` > 0 gives every worker K virtual CPU devices
    (the test topology).  0 runs on the host's cards: worker I sees only
    card I (``CUDA_VISIBLE_DEVICES=I``), so no worker opens — or
    reserves memory on — another worker's card.

    Returns each worker's stdout+stderr; raises RuntimeError (with the
    failing worker's output) on any non-zero exit.

    free_port() closes its probe socket before the coordinator binds the
    port, so another process can grab it in between (TOCTOU); a failed
    coordinator bind is retried on a fresh port instead of failing the
    whole launch.
    """
    last_exc = None
    for _attempt in range(3):
        try:
            return _launch_local_once(num_processes, worker_args,
                                      local_device_count, timeout)
        except RuntimeError as e:
            msg = str(e)
            if ("bind" not in msg.lower()
                    and "address already in use" not in msg.lower()):
                raise
            last_exc = e
    raise last_exc


def worker_env(base_env, process_id: int, local_device_count: int) -> dict:
    """Environment of worker ``process_id``: virtual-CPU workers set
    their own platform and device count; card workers get exactly one
    card each."""
    env = dict(base_env)
    env.pop("XLA_FLAGS", None)
    if not local_device_count:
        env["CUDA_VISIBLE_DEVICES"] = str(process_id)
    return env


def _launch_local_once(num_processes, worker_args, local_device_count,
                       timeout):
    port = free_port()
    procs = []
    for i in range(num_processes):
        cmd = [
            sys.executable, "-m", "bpt_tpu.parallel.worker",
            "--process-id", str(i),
            "--num-processes", str(num_processes),
            "--coordinator", f"localhost:{port}",
            "--local-devices", str(local_device_count),
            *worker_args,
        ]
        env = worker_env(os.environ, i, local_device_count)
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))))
    outs = []
    fail = None
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            fail = fail or (i, -9, out.decode(errors="replace"))
            continue
        outs.append(out.decode(errors="replace"))
        if p.returncode != 0 and fail is None:
            fail = (i, p.returncode, outs[-1])
    if fail is not None:
        i, rc, out = fail
        raise RuntimeError(
            f"worker {i} exited {rc}:\n{out[-4000:]}")
    return outs
