"""Multi-process render worker: one instance per process/host.

Started by `bpt_tpu.parallel.multiprocess.launch_local` (or one per
host on a real cluster).  Brings up the distributed runtime, renders
the scene pixel-sharded over the GLOBAL mesh, and lets process 0 write
the gathered framebuffer (.npy of the raw sample sum — bit-comparable
across process counts — or a tonemapped .png).

    python -m bpt_tpu.parallel.worker --process-id 0 --num-processes 2 \
        --coordinator localhost:29500 --local-devices 4 \
        --size 32x32 --spp 4 --max-depth 3 --output /tmp/fb.npy
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", default="localhost:29500")
    ap.add_argument("--local-devices", type=int, default=0,
                    help="force N virtual CPU devices (0 = the cards this "
                         "process may see; the launcher gives each worker "
                         "one)")
    ap.add_argument("--scene", default="cornell",
                    help="scene YAML path, or 'cornell' for the preset")
    ap.add_argument("--size", default="32x32")
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=3)
    ap.add_argument("--integrator", default="pt",
                    choices=["pt", "bdpt", "bdpt-mis"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--output", default="",
                    help=".npy (raw sample sum) or .png (tonemapped); "
                         "written by process 0")
    args = ap.parse_args(argv)

    from bpt_tpu.parallel.multiprocess import init_multiprocess

    init_multiprocess(
        args.process_id, args.num_processes,
        coordinator=args.coordinator,
        local_device_count=args.local_devices or None,
    )

    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from bpt_tpu.parallel.multiprocess import render_multiprocess

    if args.scene == "cornell":
        from bpt_tpu.scene.presets import cornell_box, cornell_box_camera

        scene = cornell_box(dtype=jnp.float32)
        cfg = cornell_box_camera()
    else:
        from bpt_tpu.scene.loader import load_scene_from_yaml

        ls = load_scene_from_yaml(args.scene)
        scene, cfg = ls.scene, ls.camera
    w, h = (int(v) for v in args.size.lower().split("x"))
    cfg = dataclasses.replace(
        cfg, image_width=w, aspect_ratio=w / h,
        samples_per_pixel=args.spp, max_depth=args.max_depth,
        integrator=args.integrator)

    fb, spp = render_multiprocess(scene, cfg, seed=args.seed)
    print(f"[worker {args.process_id}/{args.num_processes}] "
          f"devices={jax.device_count()} (local {jax.local_device_count()}) "
          f"fb={fb.shape} spp={spp}", flush=True)

    if args.output and jax.process_index() == 0:
        if args.output.endswith(".npy"):
            np.save(args.output, fb)
        else:
            from bpt_tpu.ops.film import to_rgb8
            from bpt_tpu.utils.png import write_png

            write_png(args.output, np.asarray(to_rgb8(fb, spp)))
        print(f"[worker 0] wrote {args.output}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
