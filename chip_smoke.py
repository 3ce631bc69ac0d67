#!/usr/bin/env python3
"""On-card smoke test: the renderer's main path on one NVIDIA GPU.

    python chip_smoke.py           # one card: device, traversal, renders, golden
    python chip_smoke.py --four    # four cards: pixel- and spp-sharded render

One process drives the card (a JAX process reserves most of its memory).
Phases, each printing its own lines; any failure exits non-zero:

1. device     platform must be ``gpu`` (no CPU fallback); name and power
              limit from nvidia-smi.
2. traversal  the BVH traversal kernel compiled at real widths (coffee
              scene, 2^18 camera and random-direction rays, masked and
              unmasked) against the jnp walks it replaces.
3. compile    every render step below compiled up front, concurrently.
4. renders    cornell pt/bdpt/bdpt-mis and coffee pt/bdpt-mis/checker-pt
              through ``bpt_tpu.render.main`` and ``render()``; a cut
              coffee configuration also runs on the jnp traversal route,
              which must trace the same rays.
5. golden     small cornell renders against the CPU goldens.

The last line of stdout is the result as one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
COFFEE = os.path.join(ROOT, "scenes", "coffee", "coffee_standin.yaml")
SIZE = 512  # image side of every render cell (the bench's 512x512)

# Traversal tolerance (float32, no matrix products, so TF32 never enters):
# hit/miss and any-hit identical; tri identical except where two triangles
# tie in t; t, u, v within a relative 1e-6 for FMA contraction.
RTOL = 1e-6

# Golden images are CPU renders.  The card runs the same estimator on the
# same random numbers, but its float rounding (FMA contraction, its own
# sin/cos/log/sqrt) can flip a branch of a sample path, so a pixel may
# differ by a sample's contribution.  The bound is the 8-bit RMSE.
GOLDEN_RMSE = 0.02


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling since reset()."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, secs, **_):
        if name.startswith("/jax/core/compile/"):
            self.total += secs

    def reset(self) -> None:
        self.total = 0.0


def coffee():
    import contextlib

    from bpt_tpu.scene.loader import load_scene_from_yaml

    with contextlib.redirect_stdout(sys.stderr):
        return load_scene_from_yaml(COFFEE)


# ------------------------------------------------------------- traversal


def phase_traversal(clock) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bpt_tpu.core import vec3 as v3
    from bpt_tpu.models.camera import camera_constants, generate_rays
    from bpt_tpu.ops import soa
    from bpt_tpu.ops.intersect import T_MIN
    from bpt_tpu.ops.pallas import bvh_walk

    loaded = coffee()
    scene = loaded.scene
    wave = SIZE * SIZE  # one stratum of a SIZE x SIZE image
    log("traversal", f"coffee: {scene.num_tris} triangles, "
        f"{scene.bvh_skip.shape[0]} BVH nodes, wave {wave} rays")
    cfg = dataclasses.replace(loaded.camera, image_width=SIZE,
                              aspect_ratio=1.0)
    cc = camera_constants(cfg, jnp.float32)
    pix = jnp.arange(wave, dtype=jnp.int32)
    i = (pix % SIZE).astype(jnp.float32)
    j = (pix // SIZE).astype(jnp.float32)
    jitter = jax.random.uniform(jax.random.PRNGKey(1), (wave, 4))
    o3, d3 = generate_rays(cc, i, j, i * 0, j * 0, jitter)
    rng = np.random.default_rng(0)
    lo = np.asarray(scene.bvh_min[0])
    hi = np.asarray(scene.bvh_max[0])
    waves = {
        "camera": (v3.from_array(o3), v3.from_array(d3)),
        "random": (v3.from_array(jnp.asarray(rng.uniform(lo, hi, (wave, 3)),
                                              jnp.float32)),
                   v3.from_array(jnp.asarray(rng.normal(size=(wave, 3)),
                                              jnp.float32))),
    }
    live = jnp.asarray(rng.uniform(size=wave) < 0.3)

    k_closest = jax.jit(lambda s, o, d, tm: bvh_walk.closest(
        s, o, d, T_MIN, tm))
    x_closest = jax.jit(lambda s, o, d, tm: soa.bvh_closest(
        s, o, d, T_MIN, tm))
    k_any = jax.jit(lambda s, o, d, tm: bvh_walk.any_hit(
        s, o, d, T_MIN, tm))
    x_any = jax.jit(lambda s, o, d, tm: soa.bvh_any(
        s, o, d, jnp.full(tm.shape, T_MIN, jnp.float32), tm))

    def timed(fn, *args):
        out = jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return out, sorted(ts)[2] * 1e3

    first = True
    for wname, (o, d) in waves.items():
        for masked in (False, True):
            tag = f"{wname}{' masked' if masked else ''}"
            inf = jnp.full((wave,), jnp.inf, jnp.float32)
            tmax = jnp.where(live, inf, 0.0) if masked else inf
            if first:
                clock.reset()
                compiled = k_closest.lower(scene, o, d, tmax).compile()
                log("traversal", f"closest kernel compiled in "
                    f"{clock.total:.2f} s; memory_analysis: "
                    f"{compiled.memory_analysis()}")
                first = False
            (t, tri, u, v, _), k_ms = timed(k_closest, scene, o, d, tmax)
            ref, x_ms = timed(x_closest, scene, o, d, tmax)
            hit = np.asarray(tri) >= 0
            ref_hit = np.asarray(ref.hit)
            if not np.array_equal(hit, ref_hit):
                raise AssertionError(
                    f"{tag}: hit/miss differs on "
                    f"{int((hit != ref_hit).sum())} rays")
            t, u, v = (np.asarray(a)[hit] for a in (t, u, v))
            rt, ru, rv = (np.asarray(a)[hit] for a in (ref.t, ref.u, ref.v))
            tie = np.asarray(tri)[hit] != np.asarray(ref.tri)[hit]
            if (np.abs(t[tie] - rt[tie]) > RTOL * np.abs(rt[tie])).any():
                raise AssertionError(f"{tag}: tri differs off a t-tie")
            for name, a, b in (("t", t, rt), ("u", u[~tie], ru[~tie]),
                               ("v", v[~tie], rv[~tie])):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=0,
                                           err_msg=f"{tag} {name}")
            log("traversal", f"closest {tag}: {int(hit.sum())} hits, "
                f"{int(tie.sum())} t-tie tri differences; kernel "
                f"{k_ms:.3f} ms vs jnp walk {x_ms:.3f} ms (median of 5)")
            tany = jnp.where(live, 2.0, 0.0) if masked else jnp.full(
                (wave,), 0.3, jnp.float32)
            found, ka_ms = timed(k_any, scene, o, d, tany)
            ref_found, xa_ms = timed(x_any, scene, o, d, tany)
            if not np.array_equal(np.asarray(found), np.asarray(ref_found)):
                raise AssertionError(f"{tag}: any-hit differs")
            log("traversal", f"any {tag}: {int(np.sum(found))} occluded, "
                f"identical; kernel {ka_ms:.3f} ms vs jnp walk "
                f"{xa_ms:.3f} ms")
    log("traversal", f"tolerance: hit/miss and any identical; t/u/v rtol "
        f"{RTOL}; tri identical except t-ties")


# --------------------------------------------------------------- renders


def _cells():
    """Every render of the renders and golden phases, as (name, scene,
    camera config, route) with route "kernel" (the default routing) or
    "jnp" (BVH walks forced onto the jnp route)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import gen_goldens

    from bench import texture_coffee
    from bpt_tpu.scene.presets import cornell_box, cornell_box_camera

    base = dataclasses.replace(cornell_box_camera(), image_width=SIZE,
                               aspect_ratio=1.0, samples_per_pixel=16,
                               max_depth=10)
    box = cornell_box()
    cells = [(f"cornell {i}", box, dataclasses.replace(base, integrator=i),
              "kernel") for i in ("pt", "bdpt", "bdpt-mis")]
    loaded = coffee()
    cam = dataclasses.replace(loaded.camera, image_width=SIZE,
                              aspect_ratio=1.0, max_depth=10)
    # coffee at the bench's 512x512 d10, spp cut to fit the time limit
    # (bench cells: pt 16, bdpt-mis 4, checker pt 4)
    cells += [
        ("coffee pt", loaded.scene,
         dataclasses.replace(cam, integrator="pt", samples_per_pixel=4),
         "kernel"),
        ("coffee bdpt-mis", loaded.scene,
         dataclasses.replace(cam, integrator="bdpt-mis",
                             samples_per_pixel=1), "kernel"),
        ("coffee checker pt", texture_coffee(loaded.scene),
         dataclasses.replace(cam, integrator="pt", samples_per_pixel=4),
         "kernel"),
    ]
    # both traversal routes must trace the same rays: compared at a cut
    # configuration, since the jnp route's lockstep walk is 35-60x slower
    small = dataclasses.replace(cam, image_width=SIZE // 2, max_depth=4,
                                samples_per_pixel=1)
    for integ in ("pt", "bdpt-mis"):
        for route in ("kernel", "jnp"):
            cells.append((f"route {integ}", loaded.scene,
                          dataclasses.replace(small, integrator=integ),
                          route))
    for name, kind, integ, width, spp, depth in gen_goldens.CONFIGS:
        if kind == "cornell":
            scene, cfg = gen_goldens.build_scene(kind)
            cells.append((f"golden {name}", scene, dataclasses.replace(
                cfg, image_width=width, aspect_ratio=1.0,
                samples_per_pixel=spp, max_depth=depth, integrator=integ),
                "kernel"))
    return cells


class _JnpRoute:
    """Route every BVH walk onto the jnp lockstep walk (the kernel's
    reference) while the block runs."""

    def __enter__(self):
        from bpt_tpu.ops import soa

        self._soa, self._route = soa, soa.use_traversal_kernel
        soa.use_traversal_kernel = lambda scene, dtype: False

    def __exit__(self, *exc):
        self._soa.use_traversal_kernel = self._route


def _route(route):
    import contextlib

    return _JnpRoute() if route == "jnp" else contextlib.nullcontext()


def phase_compile(cells) -> None:
    """Compile every cell's render step up front, many at once (XLA's
    compiler runs on the host's cores; cold, one depth-10 BDPT step takes
    minutes).  render() then reuses the executables."""
    from concurrent.futures import ThreadPoolExecutor

    from bpt_tpu.models.render import compile_render

    def one(cell):
        t0 = time.perf_counter()
        compile_render(cell[1], cell[2])
        return time.perf_counter() - t0

    for route in ("kernel", "jnp"):  # the route is process-wide state
        batch = [c for c in cells if c[3] == route]
        t0 = time.perf_counter()
        with _route(route), ThreadPoolExecutor(len(batch)) as pool:
            secs = list(pool.map(one, batch))
        for cell, sec in zip(batch, secs):
            log("compile", f"{cell[0]} [{route}]: {sec:.2f} s")
        log("compile", f"{len(batch)} {route}-route steps compiled "
            f"concurrently in {time.perf_counter() - t0:.2f} s")


def _render(clock, cell, smi):
    """Render a cell twice: the first call reports what compile was left,
    the second is the timed one.  Both must agree bit for bit."""
    import numpy as np

    from bpt_tpu.models.render import render

    name, scene, cfg, route = cell
    with _route(route):
        clock.reset()
        first = render(scene, cfg, seed=0)
        compile_s = clock.total
        res = render(scene, cfg, seed=0)
    wall = res.stats.wall_seconds
    if not np.isfinite(res.framebuffer_sum).all():
        raise AssertionError(f"{name}: non-finite pixels")
    if not np.array_equal(res.framebuffer_sum, first.framebuffer_sum):
        raise AssertionError(f"{name}: second render differs from first")
    log("renders", f"{name} [{route}]: {cfg.image_width}x{cfg.image_height}"
        f" {cfg.effective_spp} spp d{cfg.max_depth}: compile left "
        f"{compile_s:.2f} s, wall {wall:.3f} s, rays "
        f"{res.stats.rays_traced}, {res.stats.rays_traced / wall / 1e6:.3f}"
        f" Mrays/s [{smi}]")
    return res


def phase_renders(clock, cells, smi) -> None:
    import numpy as np

    from bpt_tpu import render as cli
    from bpt_tpu.ops import soa

    out_dir = os.path.join(ROOT, "chiprun_out", "smoke")
    clock.reset()
    t0 = time.perf_counter()
    rc = cli.main(["--size", f"{SIZE}x{SIZE}", "--spp", "16",
                   "--max-depth", "10", "--integrator", "pt",
                   "--output", "cornell_cli.png", "--output-dir", out_dir,
                   "--no-progress"])
    if rc != 0 or not os.path.exists(os.path.join(out_dir, "cornell_cli.png")):
        raise AssertionError(f"CLI exited {rc} or wrote no PNG")
    log("renders", f"CLI cornell {SIZE}x{SIZE} 16 spp d10 pt: "
        f"{time.perf_counter() - t0:.2f} s (compile {clock.total:.2f} s), "
        f"wrote {out_dir}/cornell_cli.png")

    results = {}
    for cell in cells:
        name, scene, _, route = cell
        if name.startswith("golden"):
            continue
        if name.startswith("coffee") and not soa.use_traversal_kernel(
                scene, scene.dtype):
            raise AssertionError("coffee does not take the kernel route")
        results[(name, route)] = _render(clock, cell, smi)
    for integ in ("pt", "bdpt-mis"):
        k = results[(f"route {integ}", "kernel")]
        j = results[(f"route {integ}", "jnp")]
        if k.stats.rays_traced != j.stats.rays_traced:
            raise AssertionError(
                f"{integ}: rays_traced {k.stats.rays_traced} (kernel) != "
                f"{j.stats.rays_traced} (jnp walk)")
        diff = np.abs(k.framebuffer_sum - j.framebuffer_sum).max()
        log("renders", f"route {integ}: both traversal routes trace "
            f"{k.stats.rays_traced} rays; max |pixel diff| {diff:.3e}")


def phase_golden() -> None:
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import gen_goldens

    from bpt_tpu.utils.png import read_png

    for cfg in gen_goldens.CONFIGS:
        name, kind, integ, width, spp, depth = cfg
        if kind != "cornell":
            continue
        golden = read_png(os.path.join(ROOT, "tests", "golden",
                                       f"{name}.png"))
        img = np.asarray(gen_goldens.render_config(*cfg))
        rmse = float(np.sqrt(np.mean(
            (img.astype(np.float64) / 255 - golden.astype(np.float64) / 255)
            ** 2)))
        ok = img.shape == golden.shape and rmse < GOLDEN_RMSE
        log("golden", f"{name} ({width}x{width} {spp} spp d{depth} {integ}) "
            f"vs CPU golden: RMSE {rmse:.5f} (bound {GOLDEN_RMSE})")
        if not ok:
            raise AssertionError(f"{name}: RMSE {rmse} >= {GOLDEN_RMSE}")


# ------------------------------------------------------------ four cards


def phase_four() -> None:
    """Pixel sharding over four cards must be bit-equal to the one-card
    render (parallel/mesh.py's contract); the spp-sharded psum agrees
    within rtol 1e-5 (it only changes the order of the strata sum).  The
    three renders compile and run concurrently; only their results are
    compared."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    import numpy as np

    from bpt_tpu.models.camera import camera_constants
    from bpt_tpu.models.render import render
    from bpt_tpu.parallel.mesh import (make_mesh, render_distributed,
                                       render_spp_sharded_step)

    if len(jax.devices()) != 4:
        raise AssertionError(f"--four needs 4 cards, found {jax.devices()}")
    scene = coffee().scene
    cfg = dataclasses.replace(coffee().camera, image_width=SIZE,
                              aspect_ratio=1.0, samples_per_pixel=4,
                              max_depth=3, integrator="pt")
    mesh = make_mesh(4)  # one axis: the cards reach each other all to all
    cc = camera_constants(cfg, scene.dtype)
    npix = cc.width * cc.height

    def single():
        return render(scene, cfg, seed=3).framebuffer_sum

    def pixel_sharded():
        return render_distributed(scene, cfg, mesh=mesh, seed=3)[0]

    def spp_sharded():
        step = render_spp_sharded_step(mesh, "pt", cfg.max_depth,
                                       cfg.sqrt_spp, npix)
        fb = step(scene, cc, jax.random.PRNGKey(3), jnp.int32(0))
        return np.asarray(fb).reshape(cc.height, cc.width, 3)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(3) as pool:
        (one, t1), (pix, t2), (psum, t3) = pool.map(
            timed, (single, pixel_sharded, spp_sharded))
    log("four", f"coffee {SIZE}x{SIZE} {cfg.effective_spp} spp "
        f"d{cfg.max_depth} pt on {mesh.devices.size} cards "
        f"({[d.device_kind for d in mesh.devices.flat]}); one card "
        f"{t1:.1f} s, pixel-sharded {t2:.1f} s, spp-sharded {t3:.1f} s "
        f"(compile included, concurrent)")
    if not np.array_equal(pix, one):
        raise AssertionError(
            f"pixel sharding is not bit-equal to one card: max diff "
            f"{np.abs(pix - one).max():.3e}")
    log("four", "pixel-sharded framebuffer is bit-equal to the one-card "
        "render")
    err = np.abs(psum - one) / np.maximum(np.abs(one), 1e-6)
    log("four", f"spp-sharded psum (4 strata, one per card) vs one card: "
        f"max rel diff {float(err.max()):.3e} (rtol 1e-5)")
    np.testing.assert_allclose(psum, one, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded render check")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    log("device", f"jax {jax.__version__}; devices {devices}; kind "
        f"{dev.device_kind}")
    if dev.platform != "gpu":
        print(f"[device] FAILED: platform {dev.platform!r}, need a GPU",
              file=sys.stderr)
        return 2
    smi = nvidia_smi()
    log("device", f"nvidia-smi: {smi}")
    try:
        from bpt_tpu.utils.cache import enable_compile_cache
    except ImportError as e:
        print(f"[device] FAILED: repository not importable: {e}",
              file=sys.stderr)
        return 3
    enable_compile_cache()
    clock = CompileClock()

    if args.four:
        phases = [("four", phase_four)]
    else:
        cells = []

        def compile_all():
            cells.extend(_cells())
            phase_compile(cells)

        phases = [("traversal", lambda: phase_traversal(clock)),
                  ("compile", compile_all),
                  ("renders", lambda: phase_renders(clock, cells, smi)),
                  ("golden", phase_golden)]
    failed = []
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            log(name, f"ok in {time.perf_counter() - t0:.1f} s")
        except Exception:
            traceback.print_exc()
            log(name, "FAILED")
            failed.append(name)
    log("device", f"total {time.perf_counter() - t_all:.1f} s")
    print(smi, flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
