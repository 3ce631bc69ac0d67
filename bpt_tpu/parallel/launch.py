"""Single-machine multi-process launcher (torchrun analog).

    python -m bpt_tpu.parallel.launch -n 2 [--local-devices 4] -- \
        --size 64x64 --spp 16 --output out.npy

Everything after ``--`` is forwarded to every `bpt_tpu.parallel.worker`
(see that module for the render flags).  ``--local-devices 0`` runs one
worker per card of this host, each seeing only its own card.  On a real
cluster, skip this launcher and start one worker per host with a shared
--coordinator.
"""

from __future__ import annotations

import argparse
import sys

from bpt_tpu.parallel.multiprocess import launch_local


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, worker_args = argv[:split], argv[split + 1:]
    else:
        worker_args = []
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--num-processes", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    outs = launch_local(args.num_processes, worker_args,
                        local_device_count=args.local_devices,
                        timeout=args.timeout)
    for o in outs:
        sys.stdout.write(o)
    return 0


if __name__ == "__main__":
    sys.exit(main())
