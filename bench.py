"""Benchmark: steady-state ray throughput on one chip vs the measured
C++ reference baseline.

Config: cornell box (the reference's built-in scene, src/main.cpp:14-60) at
512x512, 16 effective spp, depth 10 — both integrators, measured warm (one
full render compiles + warms caches, then a timed render).

The reference publishes no numbers (BASELINE.md); the baseline here is
the reference's own CPU rate, MEASURED by compiling its headers
(benchmarks/ref_bench.cpp) on a single CPU core in f64:
    pt   1.143 Mrays/s   (512x512, 16 spp, depth 10)
    bdpt 0.393 Mrays/s   (same)
vs_baseline = ours / reference on the same scene+config+estimator.

Accounting note: the reference's BDPT counter increments only in
path_trace_color/trace_path (src/camera.h:256,334) — its visible() shadow
rays (camera.h:425-438) are UNCOUNTED.  To stay apples-to-apples our BDPT
Mrays/s therefore divides rays_traced only (subpath extension rays, the
same events the reference counts), NOT rays_traced + shadow_rays.

Every config is timed RUNS times, round-robin interleaved across configs
(a slow window hits all configs alike), and the headline value is the
per-config median; min/max spread is recorded in detail.  render() stops
its clock only after the device has finished (block_until_ready).

Single process: one JAX process per card.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mrays/s", "vs_baseline": N/ref}
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys

RUNS = 3  # timed renders per config (median reported)

# the reference binary's CPU rates (benchmarks/ref_bench.cpp, one core)
REF_PT_MRAYS = 1.143
REF_BDPT_MRAYS = 0.393
# coffee stand-in (91,540 tris), 512x512 16 spp depth 10 — the reference
# binary's CPU rate (benchmarks/ref_coffee_bench.cpp, one CPU core)
REF_COFFEE_PT_MRAYS = 0.014  # 11.35M rays / 807.5 s (exclusive run)
REF_COFFEE_BDPT_MRAYS = 0.013  # 16.88M ext rays / 1348.7 s (BASELINE.md)


def texture_coffee(scene):
    """Checker-texture the coffee stand-in's first lambertian: exercises
    the texel stage on the 91k-tri scene class."""
    import dataclasses as dc

    import jax.numpy as jnp
    import numpy as np

    from bpt_tpu.scene.textures import TextureSpec, build_texture_table

    tt = build_texture_table(
        [TextureSpec.checker(0.02, (0.9, 0.4, 0.05), (0.1, 0.1, 0.1))],
        dtype=np.float32)
    mats = scene.materials
    tex_id = np.asarray(mats.tex_id).copy()
    first = int(np.argmax(np.asarray(mats.mtype) == 0))  # MAT_LAMBERTIAN
    tex_id[first] = 0
    mats2 = (mats._replace(tex_id=jnp.asarray(tex_id))
             if hasattr(mats, "_replace")
             else dc.replace(mats, tex_id=jnp.asarray(tex_id)))
    return dc.replace(scene, materials=mats2, textures=tt, has_textures=True)


def _timed(scene, cfg):
    from bpt_tpu.models.render import render

    result = render(scene, cfg, seed=0)
    s = result.stats
    # rays_traced only: matches the reference's counter, which excludes
    # its visible() shadow rays (src/camera.h:256,334 vs 425-438)
    return s.rays_traced / max(s.wall_seconds, 1e-9) / 1e6, s


def _measure(configs):
    """configs: list of (name, scene, cfg).  Warm every config once
    (compile + post-compile warmup artifact), then RUNS timed renders
    each, ROUND-ROBIN interleaved so a chip-degradation window cannot
    bias one config.  Returns {name: (median, lo, hi, stats)}."""
    from bpt_tpu.models.render import render

    for _name, scene, cfg in configs:
        render(scene, cfg, seed=7)  # warm-up (distinct seed)
    samples = {name: [] for name, _, _ in configs}
    stats = {}
    for _r in range(RUNS):
        for name, scene, cfg in configs:
            mrays, s = _timed(scene, cfg)
            samples[name].append(mrays)
            stats[name] = s  # same seed: rays identical across runs
    out = {}
    for name, vals in samples.items():
        out[name] = (statistics.median(vals), min(vals), max(vals),
                     stats[name])
    return out


def main():
    from bpt_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    from bpt_tpu.scene.presets import cornell_box, cornell_box_camera

    scene = cornell_box()
    base = dataclasses.replace(
        cornell_box_camera(), image_width=512, samples_per_pixel=16, max_depth=10
    )

    # large-scene class: the 91k-tri coffee stand-in, vs the reference
    # binary on the SAME scene/config (benchmarks/ref_coffee_bench.cpp —
    # its per-ray BVH collapses on real meshes: 0.014 Mrays/s measured)
    import contextlib
    import os

    from bpt_tpu.scene.loader import load_scene_from_yaml

    with contextlib.redirect_stdout(sys.stderr):
        # the loader's reference-parity "Triangles: N" print must not
        # break this script's one-JSON-line stdout contract
        ls = load_scene_from_yaml(os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "scenes", "coffee", "coffee_standin.yaml"))
    coffee_cfg = dataclasses.replace(
        ls.camera, image_width=512, aspect_ratio=1.0,
        samples_per_pixel=16, max_depth=10, integrator="pt")
    # large-scene BDPT: the reference's de-facto integrator on the
    # flagship scene class (both main.cpp call sites dispatch BDPT,
    # camera.h:245-253)
    cmis_cfg = dataclasses.replace(coffee_cfg, samples_per_pixel=4,
                                   integrator="bdpt-mis")
    # textured large scene: the coffee mesh with a checker on its first
    # lambertian — the reference evaluates
    # textures inline at ~zero marginal CPU cost, so its untextured
    # coffee rate is the honest denominator
    tex_scene = texture_coffee(ls.scene)
    tex_cfg = dataclasses.replace(coffee_cfg, samples_per_pixel=4)

    m = _measure([
        ("pt", scene, dataclasses.replace(base, integrator="pt")),
        ("bdpt", scene, dataclasses.replace(base, integrator="bdpt")),
        ("bdpt_mis", scene, dataclasses.replace(base, integrator="bdpt-mis")),
        ("coffee_91k_pt", ls.scene, coffee_cfg),
        ("coffee_91k_bdpt_mis", ls.scene, cmis_cfg),
        ("coffee_91k_tex_pt", tex_scene, tex_cfg),
    ])
    pt_mrays, pt_lo, pt_hi, pt_s = m["pt"]
    bdpt_mrays, bdpt_lo, bdpt_hi, bdpt_s = m["bdpt"]
    mis_mrays, mis_lo, mis_hi, mis_s = m["bdpt_mis"]
    coffee_mrays, coffee_lo, coffee_hi, coffee_s = m["coffee_91k_pt"]
    cmis_mrays, cmis_lo, cmis_hi, cmis_s = m["coffee_91k_bdpt_mis"]
    tex_mrays, tex_lo, tex_hi, tex_s = m["coffee_91k_tex_pt"]

    def spread(lo, hi):
        return [round(lo, 3), round(hi, 3)]

    print(
        json.dumps(
            {
                "metric": "cornell_512x512_16spp_d10_pt_vs_reference_cpu",
                "value": round(pt_mrays, 3),
                "unit": "Mrays/s",
                "vs_baseline": round(pt_mrays / REF_PT_MRAYS, 2),
                "runs_per_config": RUNS,  # interleaved; mrays = median
                "detail": {
                    "pt": {
                        "mrays": round(pt_mrays, 3),
                        "spread": spread(pt_lo, pt_hi),
                        "rays": pt_s.rays_traced,
                        "wall_s": round(pt_s.wall_seconds, 3),
                        "ref_mrays": REF_PT_MRAYS,
                    },
                    "bdpt": {
                        "mrays": round(bdpt_mrays, 3),
                        "spread": spread(bdpt_lo, bdpt_hi),
                        "rays": bdpt_s.rays_traced,
                        "shadow_rays_untimed": bdpt_s.shadow_rays,
                        "wall_s": round(bdpt_s.wall_seconds, 3),
                        "ref_mrays": REF_BDPT_MRAYS,
                        "vs_baseline": round(bdpt_mrays / REF_BDPT_MRAYS, 2),
                    },
                    # our consistency upgrade over the reference estimator
                    # (power-heuristic MIS; no reference counterpart —
                    # baselined against its unweighted BDPT wall)
                    "bdpt_mis": {
                        "mrays": round(mis_mrays, 3),
                        "spread": spread(mis_lo, mis_hi),
                        "rays": mis_s.rays_traced,
                        "shadow_rays_untimed": mis_s.shadow_rays,
                        "wall_s": round(mis_s.wall_seconds, 3),
                        "ref_mrays": REF_BDPT_MRAYS,
                        "vs_baseline": round(mis_mrays / REF_BDPT_MRAYS, 2),
                    },
                    "coffee_91k_pt": {
                        "mrays": round(coffee_mrays, 3),
                        "spread": spread(coffee_lo, coffee_hi),
                        "rays": coffee_s.rays_traced,
                        "wall_s": round(coffee_s.wall_seconds, 3),
                        "ref_mrays": REF_COFFEE_PT_MRAYS,
                        "vs_baseline": round(
                            coffee_mrays / REF_COFFEE_PT_MRAYS, 1),
                    },
                    # the 4 spp coffee configs
                    "coffee_91k_bdpt_mis": {
                        "mrays": round(cmis_mrays, 3),
                        "spread": spread(cmis_lo, cmis_hi),
                        "rays": cmis_s.rays_traced,
                        "shadow_rays_untimed": cmis_s.shadow_rays,
                        "wall_s": round(cmis_s.wall_seconds, 3),
                        "ref_mrays": REF_COFFEE_BDPT_MRAYS,
                        "vs_baseline": round(
                            cmis_mrays / REF_COFFEE_BDPT_MRAYS, 1),
                    },
                    "coffee_91k_tex_pt": {
                        "mrays": round(tex_mrays, 3),
                        "spread": spread(tex_lo, tex_hi),
                        "rays": tex_s.rays_traced,
                        "wall_s": round(tex_s.wall_seconds, 3),
                        "ref_mrays": REF_COFFEE_PT_MRAYS,
                        "vs_baseline": round(
                            tex_mrays / REF_COFFEE_PT_MRAYS, 1),
                    },
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
