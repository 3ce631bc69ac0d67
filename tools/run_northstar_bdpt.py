"""Run the FULL BDPT north-star configs for real.

Glass stand-in (scenes/glass/glass_standin.yaml, 510 tris) at
1920x1080, max_depth 80, 1024 spp — pt (reference point), bdpt, and
bdpt-mis, recording measured walls + Mrays/s, plus 8x8-downsampled
tonemapped RMSE of each BDPT variant vs the PT render (bdpt is
~2x brighter BY DESIGN — no MIS overcounting, PARITY dev. 7; bdpt-mis
is the consistent estimator and should sit near PT).

Chip time on the GPU: not measured.  Usage:
python tools/run_northstar_bdpt.py [spp]
"""
from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from bpt_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import numpy as np

from bpt_tpu.models.render import render
from bpt_tpu.scene.loader import load_scene_from_yaml


def down(img, f=8):
    h, w, c = img.shape
    return img[: h // f * f, : w // f * f].reshape(
        h // f, f, w // f, f, c).mean((1, 3))


def main():
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    ls = load_scene_from_yaml(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..",
        "scenes", "glass", "glass_standin.yaml"))
    base = dataclasses.replace(
        ls.camera, image_width=1920, aspect_ratio=16 / 9,
        samples_per_pixel=spp, max_depth=80)

    images = {}
    for integ in ("pt", "bdpt", "bdpt-mis"):
        cfg = dataclasses.replace(base, integrator=integ)
        r = render(ls.scene, cfg, seed=0)
        mr = r.stats.rays_traced / max(r.stats.wall_seconds, 1e-9) / 1e6
        images[integ] = r.rgb8().astype(np.float64) / 255.0
        print(f"{integ}: wall={r.stats.wall_seconds:.1f}s "
              f"rays={r.stats.rays_traced} ({mr:.2f} Mrays/s ext) "
              f"shadow={r.stats.shadow_rays} mean={images[integ].mean():.4f}",
              flush=True)

    pt_ds = down(images["pt"])
    for integ in ("bdpt", "bdpt-mis"):
        d = down(images[integ]) - pt_ds
        rmse = float(np.sqrt(np.mean(d * d)))
        print(f"rmse_ds {integ} vs pt: {rmse:.4f} "
              f"(mean ratio {images[integ].mean() / images['pt'].mean():.3f})",
              flush=True)


if __name__ == "__main__":
    main()
