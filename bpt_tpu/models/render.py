"""Render driver: chunked wavefront loop over (pixel, stratum) grids.

The reference's thread pool + atomic row queue (src/camera.h:43-145) becomes
a host loop over sample strata and pixel chunks, each chunk one jit call on
a fixed shape (no recompiles; the tail chunk is padded + masked).  Stratum-
major ordering makes the framebuffer a pure running sum, which gives free
checkpoint/resume at stratum granularity.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from bpt_tpu.core import rng as rng_mod
from bpt_tpu.models import bdpt as bdpt_mod
from bpt_tpu.models import pt as pt_mod
from bpt_tpu.models.camera import CameraConstants, camera_constants, generate_rays
from bpt_tpu.ops import soa
from bpt_tpu.ops.film import to_rgb8
from bpt_tpu.scene.types import CameraConfig, SceneArrays
from bpt_tpu.utils.stats import RenderStats

# RNG stream tags (fold_in indices off the render key)
STREAM_RAYGEN = 0
STREAM_PT = 1
STREAM_CAM_TRACE = 2
STREAM_LIGHT_START = 3
STREAM_LIGHT_TRACE = 4


@dataclass
class RenderResult:
    framebuffer_sum: np.ndarray  # [H,W,3] sum of per-sample radiance
    samples_per_pixel: int
    stats: RenderStats
    width: int
    height: int

    def rgb8(self, nan_scrub: bool = True) -> np.ndarray:
        return np.asarray(
            to_rgb8(jnp.asarray(self.framebuffer_sum), self.samples_per_pixel, nan_scrub)
        )


# On-device stats accumulator slots (read back once per render, not per
# chunk: a readback is a device sync).
_S_RAYS, _S_SHADOW, _S_NODES, _S_AABB, _S_TRI_TESTS, _S_TRI_HITS = range(6)
_NSTATS = 6


@lru_cache(maxsize=64)
def _make_step(integrator: str, max_depth: int, sqrt_spp: int, width: int,
               npix: int, chunk: int, ref_vis: bool, kernel: bool):
    """One jitted (stratum x pixel chunk) step.  ``kernel`` is the
    traversal route (soa.use_traversal_kernel) the step is traced under;
    it keys the cache so a step is never reused across routes."""
    del kernel
    spp_eff = sqrt_spp * sqrt_spp

    @partial(jax.jit, donate_argnums=(2, 3))
    def step(scene: SceneArrays, cc: CameraConstants, fb, stats_acc, key, pix0, s_lin):
        dtype = fb.dtype
        pix = pix0 + jnp.arange(chunk, dtype=jnp.int32)
        in_range = pix < npix
        pixc = jnp.minimum(pix, npix - 1)
        i = (pixc % width).astype(dtype)
        j = (pixc // width).astype(dtype)
        s_i = (s_lin % sqrt_spp).astype(dtype)
        s_j = (s_lin // sqrt_spp).astype(dtype)
        ray_ids = pixc * spp_eff + s_lin  # absolute: chunking-invariant RNG

        if integrator == "pt":
            rad, stats = pt_mod.path_trace_pixels_fast(
                scene, i, j,
                jnp.broadcast_to(s_i, i.shape), jnp.broadcast_to(s_j, j.shape),
                jnp.where(in_range, ray_ids, -1), cc, key, max_depth,
            )
        elif integrator in ("bdpt", "bdpt-mis"):
            k_gen = jax.random.fold_in(key, STREAM_RAYGEN)
            u_gen = rng_mod.wave_uniforms(k_gen, ray_ids, 0, 4, dtype=dtype)
            o, d = generate_rays(cc, i, j, jnp.broadcast_to(s_i, i.shape),
                                 jnp.broadcast_to(s_j, j.shape), u_gen)
            rad, stats = bdpt_mod.bdpt_fast(
                scene, o, d, jnp.where(in_range, ray_ids, -1), key, max_depth,
                mis=(integrator == "bdpt-mis"), ref_vis=ref_vis,
            )
        else:
            raise ValueError(f"unknown integrator: {integrator}")

        rad = jnp.where(in_range[..., None], rad, 0.0)
        fb = fb.at[pixc].add(rad)

        d = stats._asdict()
        inc = jnp.stack(
            [
                d.get("rays_traced", jnp.int32(0)).astype(jnp.float32),
                d.get("shadow_rays", jnp.int32(0)).astype(jnp.float32),
                d.get("node_visits", jnp.int32(0)).astype(jnp.float32),
                d.get("aabb_hits", jnp.int32(0)).astype(jnp.float32),
                d.get("tri_tests", jnp.int32(0)).astype(jnp.float32),
                d.get("tri_hits", jnp.int32(0)).astype(jnp.float32),
            ]
        )
        return fb, stats_acc + inc

    return step


def _check_resume(resume) -> None:
    """Only stratum checkpoints of the jnp wavefront's RNG stream resume.
    Checkpoint kinds and streams written by removed render paths raise
    instead of continuing on a different sample sequence."""
    if not resume or int(resume.get("units_done",
                                    resume.get("strata_done", 0))) == 0:
        return  # fresh render
    kind = resume.get("unit_kind", "stratum")
    stream = resume.get("stream", "jnp")
    if kind != "stratum" or stream != "jnp":
        raise ValueError(
            f"checkpoint kind {kind!r} / RNG stream {stream!r} was written "
            "by a render path this version no longer has; only stratum "
            "checkpoints of the 'jnp' stream resume — restart the render")


# Share of the device's memory limit that BDPT vertex and MIS storage may
# take per chunk.  The per-ray estimate below counts only the stored
# subpath vertices and strategy tables; the step's temporaries (shading,
# per-slot connection waves) take several times more, so the budget stays
# a small fraction of the card.
_VERTEX_BUDGET_FRACTION = 1 / 16
_HOST_VERTEX_BUDGET = 256 << 20  # CPU backend: no device memory limit


def _vertex_budget_bytes() -> int:
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return _HOST_VERTEX_BUDGET
    return int(limit * _VERTEX_BUDGET_FRACTION)


def default_chunk_size(integrator: str, max_depth: int, npix: int) -> int:
    """Pixels per chunk: BDPT chunks are sized so their vertex storage
    stays within the device budget above; PT carries no vertex storage."""
    if integrator in ("bdpt", "bdpt-mis"):
        # ~46 floats/vertex-slot * 2 subpaths * depth; MIS adds two
        # [depth, depth, B] strategy tables
        per_ray = 46 * 4 * 2 * max(1, max_depth)
        if integrator == "bdpt-mis":
            per_ray += 8 * 4 * max(1, max_depth) ** 2
        c = _vertex_budget_bytes() // per_ray
    else:
        c = 1 << 18
    c = int(min(c, 1 << 18))
    c = max(1024, c)
    return int(min(c, max(1024, npix)))


def _plan(scene: SceneArrays, cfg: CameraConfig, integrator, chunk_size):
    """(camera constants, chunk size, jitted step) of a render."""
    integrator = integrator or cfg.integrator
    cc = camera_constants(cfg, scene.dtype)
    npix = cc.width * cc.height
    if chunk_size is None:
        chunk_size = default_chunk_size(integrator, cfg.max_depth, npix)
    chunk_size = min(chunk_size, npix)
    step = _make_step(integrator, cfg.max_depth, cfg.sqrt_spp, cc.width,
                      npix, chunk_size, getattr(cfg, "ref_vis", False),
                      soa.use_traversal_kernel(scene, scene.dtype))
    return cc, chunk_size, step


def compile_render(scene: SceneArrays, cfg: CameraConfig,
                   integrator: Optional[str] = None,
                   chunk_size: Optional[int] = None) -> None:
    """Compile render()'s step for this scene and camera without running
    it.  With the persistent compile cache on (utils/cache.py), a later
    render() of the same configuration loads the executable instead of
    compiling it, and several configurations can compile at once from
    threads."""
    cc, _, step = _plan(scene, cfg, integrator, chunk_size)
    i32 = jax.ShapeDtypeStruct((), jnp.int32)
    step.lower(
        scene, cc,
        jax.ShapeDtypeStruct((cc.width * cc.height, 3), scene.dtype),
        jax.ShapeDtypeStruct((_NSTATS,), jnp.float32),
        jax.random.PRNGKey(0), i32, i32,
    ).compile()


def render_resilient(
    scene: SceneArrays,
    cfg: CameraConfig,
    seed: int = 0,
    retries: int = 2,
    stratum_callback=None,
    **kw,
) -> RenderResult:
    """Elastic render: on a device failure mid-render, resume from the
    last completed checkpoint unit instead of restarting (the SURVEY §5
    failure-detection analog — the reference's atomic row queue simply
    loses the whole job on a crash).  Completed work is never redone and
    the stratum-resume bitwise-invariance guarantees the final image is
    identical to an uninterrupted render.  Device failures that poison the
    client still need a process restart + on-disk checkpoint
    (utils/checkpoint.py); this covers transient per-call failures."""
    last: dict = {}

    def cb(snap):
        last.clear()
        last.update(snap)
        if stratum_callback is not None:
            stratum_callback(snap)

    caller_resume = kw.pop("resume", None)
    attempt = 0
    done_at_last_failure = -1
    while True:
        try:
            return render(scene, cfg, seed=seed,
                          resume=dict(last) if last else caller_resume,
                          stratum_callback=cb, **kw)
        except Exception:
            done = int(last.get("units_done", 0)) if last else 0
            if done > done_at_last_failure:
                attempt = 0  # progress since the previous failure:
                # a long render survives any number of WIDELY-SPACED
                # transient failures; only repeated failures with no
                # progress exhaust the budget
            done_at_last_failure = done
            attempt += 1
            if attempt > retries or not last:
                raise


def render(
    scene: SceneArrays,
    cfg: CameraConfig,
    seed: int = 0,
    integrator: Optional[str] = None,
    chunk_size: Optional[int] = None,
    progress: bool = False,
    resume: Optional[dict] = None,
    stratum_callback=None,
) -> RenderResult:
    """camera::render (src/camera.h:43-145) minus the PNG write.

    ``resume``: optional dict(framebuffer_sum, strata_done) to continue an
    interrupted render (the estimator is a pure running sum, camera.h:117-124).
    ``stratum_callback(state_dict)`` fires after each completed stratum —
    checkpoint hook.
    """
    cc, chunk_size, step = _plan(scene, cfg, integrator, chunk_size)
    W, H = cc.width, cc.height
    npix = W * H
    spp_eff = cfg.sqrt_spp * cfg.sqrt_spp
    n_chunks = int(np.ceil(npix / chunk_size))
    _check_resume(resume)

    key = jax.random.PRNGKey(seed)
    stats = RenderStats()
    stats.bvh_nodes_built = int(scene.bvh_skip.shape[0]) if scene.use_bvh else 0

    strata_done = 0
    if resume:
        fb = jnp.asarray(resume["framebuffer_sum"].reshape(npix, 3), scene.dtype)
        strata_done = int(resume["strata_done"])
    else:
        fb = jnp.zeros((npix, 3), scene.dtype)

    bar = None
    if progress:
        from bpt_tpu.utils.progress import ProgressBar

        bar = ProgressBar((spp_eff - strata_done) * n_chunks)

    stats_acc = jnp.zeros((_NSTATS,), jnp.float32)
    t0 = time.monotonic()
    for s_lin in range(strata_done, spp_eff):
        for c in range(n_chunks):
            fb, stats_acc = step(
                scene, cc, fb, stats_acc, key,
                jnp.int32(c * chunk_size), jnp.int32(s_lin),
            )
            if bar:
                bar.update()
        if stratum_callback is not None:
            stratum_callback(
                dict(
                    framebuffer_sum=np.asarray(fb).reshape(H, W, 3),
                    strata_done=s_lin + 1,
                    units_done=s_lin + 1,
                    unit_kind="stratum",
                    seed=seed,
                    stream="jnp",
                )
            )
    jax.block_until_ready((fb, stats_acc))
    stats.wall_seconds = time.monotonic() - t0
    acc = np.asarray(stats_acc)
    stats.rays_traced += int(acc[_S_RAYS])
    stats.shadow_rays += int(acc[_S_SHADOW])
    stats.bvh_node_visits += int(acc[_S_NODES])
    stats.aabb_hits += int(acc[_S_AABB])
    stats.triangle_tests += int(acc[_S_TRI_TESTS])
    stats.triangle_hits += int(acc[_S_TRI_HITS])
    if bar:
        bar.finish()

    return RenderResult(
        framebuffer_sum=np.asarray(fb).reshape(H, W, 3),
        samples_per_pixel=spp_eff,
        stats=stats,
        width=W,
        height=H,
    )
