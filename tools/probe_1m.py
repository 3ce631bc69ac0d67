"""Render a generated ~1M-triangle scene (any speed): a dense uv-sphere
(lat x lon tessellation) over a floor under an area light.  On the GPU
its BVH walks run in the traversal kernel (ops/pallas/bvh_walk.py).

Usage: python tools/probe_1m.py [lat [size [spp]]]   (default 500 -> ~1M)
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from bpt_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp

from bpt_tpu.models.render import render
from bpt_tpu.scene.types import CameraConfig
from bpt_tpu.scene.builder import MaterialSpec as M
from bpt_tpu.scene.builder import SceneBuilder


def main():
    lat = int(sys.argv[1]) if len(sys.argv) > 1 else 500
    size = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    spp = int(sys.argv[3]) if len(sys.argv) > 3 else 1

    t0 = time.time()
    b = SceneBuilder()
    b.add_uv_sphere((0, 1, 0), 1.0, M.lambertian((0.7, 0.3, 0.2)),
                    lat_steps=lat, lon_steps=2 * lat)
    b.add_quad((-6, 0, -6), (12, 0, 0), (0, 0, 12),
               M.lambertian((0.6, 0.6, 0.6)))
    b.add_quad((-2, 6, -2), (4, 0, 0), (0, 0, 4),
               M.diffuse_light((9, 9, 9)))
    scene = b.build(dtype=jnp.float32)
    print(f"tris={scene.num_tris} nodes={scene.bvh_skip.shape[0]} "
          f"build={time.time() - t0:.1f}s", flush=True)

    cfg = CameraConfig(
        image_width=size, aspect_ratio=1.0, samples_per_pixel=spp,
        max_depth=3, vfov=40.0, lookfrom=(0.0, 2.0, 6.0),
        lookat=(0.0, 1.0, 0.0), integrator="pt",
    )
    r = render(scene, cfg, seed=0)
    mr = r.stats.rays_traced / max(r.stats.wall_seconds, 1e-9) / 1e6
    print(f"1M-tri render: {mr:.4f} Mrays/s wall={r.stats.wall_seconds:.1f}s "
          f"rays={r.stats.rays_traced} "
          f"mean={float(r.rgb8().mean()):.2f}", flush=True)


if __name__ == "__main__":
    main()
