"""Multi-device rendering via jax.sharding + shard_map.

The reference's only parallelism is a shared-memory thread pool with an
atomic row queue (src/camera.h:57-134).  Here the image becomes data
parallelism over a one-axis device mesh (the cards of a host reach each
other all to all, so the mesh follows the algorithm alone), two ways:

* **pixel sharding** (default): each device owns a contiguous pixel shard
  of the framebuffer; no collective is needed and the result is
  *bit-identical* to the single-device render (absolute ray ids drive the
  RNG, so each pixel's sample sequence is device-placement invariant).
* **sample (spp) sharding**: each device renders the full image for a
  subset of sample strata; partial framebuffers reduce with one psum.
  Exact up to float addition order.

Scenes are small relative to device memory, so scene arrays are replicated
(SURVEY section 5: comm backend).  Traversal inside each shard takes the
route ``ops.soa.use_traversal_kernel`` picks, like the single-device
render; that route keys the step caches below.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from bpt_tpu.core import rng as rng_mod
from bpt_tpu.models import bdpt as bdpt_mod
from bpt_tpu.models import pt as pt_mod
from bpt_tpu.models.camera import camera_constants, generate_rays
from bpt_tpu.ops import soa
from bpt_tpu.scene.types import CameraConfig, SceneArrays

AXIS = "devices"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (AXIS,))


def _radiance_for(scene, cc, integrator, max_depth, sqrt_spp, key, pix, s_lin, dtype):
    """Shared per-shard radiance computation (mirrors models.render)."""
    spp_eff = sqrt_spp * sqrt_spp
    width = cc.width
    i = (pix % width).astype(dtype)
    j = (pix // width).astype(dtype)
    s_i = (s_lin % sqrt_spp).astype(dtype)
    s_j = (s_lin // sqrt_spp).astype(dtype)
    ray_ids = pix * spp_eff + s_lin

    k_gen = jax.random.fold_in(key, 0)
    u_gen = rng_mod.wave_uniforms(k_gen, ray_ids, 0, 4, dtype=dtype)
    o, d = generate_rays(cc, i, j, jnp.broadcast_to(s_i, i.shape),
                         jnp.broadcast_to(s_j, j.shape), u_gen)

    if integrator == "pt":
        k_pt = jax.random.fold_in(key, 1)
        rad, _ = pt_mod.path_trace_radiance(
            scene, o, d, max_depth, pt_mod.default_uniforms_fn(k_pt, ray_ids, dtype)
        )
    else:
        k_cam = jax.random.fold_in(key, 2)
        k_ls = jax.random.fold_in(key, 3)
        k_lt = jax.random.fold_in(key, 4)
        ls_u = rng_mod.wave_uniforms(k_ls, ray_ids, 0, bdpt_mod.NLS, dtype=dtype)
        rad, _ = bdpt_mod.bdpt_radiance(
            scene, o, d, max_depth,
            pt_mod.default_uniforms_fn(k_cam, ray_ids, dtype),
            ls_u,
            pt_mod.default_uniforms_fn(k_lt, ray_ids, dtype),
            mis=(integrator == "bdpt-mis"),
        )
    return rad


def _route(scene) -> bool:
    return soa.use_traversal_kernel(scene, scene.dtype)


@lru_cache(maxsize=32)
def shard_step(mesh: Mesh, integrator: str, max_depth: int, sqrt_spp: int,
               npix: int, kernel: bool = False):
    """One stratum over the whole image, pixels sharded across the mesh.

    Returned jitted fn: (scene, cc, fb [npix,3] sharded, key, s_lin) -> fb.
    npix must be a multiple of the mesh size (caller pads).  ``kernel``
    (the traversal route) only keys the cache.
    """

    def local(scene, cc, fb_local, key, s_lin):
        # fb_local: [npix/n, 3] — this device's contiguous pixel shard
        n_local = fb_local.shape[0]
        dev = jax.lax.axis_index(AXIS)
        pix = dev * n_local + jnp.arange(n_local, dtype=jnp.int32)
        in_range = pix < npix
        pixc = jnp.minimum(pix, npix - 1)
        rad = _radiance_for(scene, cc, integrator, max_depth, sqrt_spp,
                            key, pixc, s_lin, fb_local.dtype)
        rad = jnp.where(in_range[..., None], rad, 0.0)
        return fb_local + rad

    smapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS), P(), P()),
        out_specs=P(AXIS),
        check_vma=False,
    )
    return jax.jit(smapped, donate_argnums=(2,))


@lru_cache(maxsize=32)
def render_spp_sharded_step(mesh: Mesh, integrator: str, max_depth: int,
                            sqrt_spp: int, npix: int, kernel: bool = False):
    """Sample-axis sharding: device d renders stratum (s0 + d) over all
    pixels; partial framebuffers psum-reduce across the mesh (the renderer's
    analog of gradient all-reduce).  ``kernel`` only keys the cache.

    Returned jitted fn: (scene, cc, key, s0) -> fb_sum [npix, 3] replicated.
    """

    def local(scene, cc, key, s0):
        dev = jax.lax.axis_index(AXIS)
        s_lin = s0 + dev
        spp_eff = sqrt_spp * sqrt_spp
        pix = jnp.arange(npix, dtype=jnp.int32)
        rad = _radiance_for(scene, cc, integrator, max_depth, sqrt_spp,
                            key, pix, s_lin, scene.v0.dtype)
        rad = jnp.where(s_lin < spp_eff, rad, jnp.zeros_like(rad))
        return jax.lax.psum(rad, AXIS)

    smapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(smapped)


HOST_AXIS = "host"
CHIP_AXIS = "chip"


def make_mesh_2d(n_hosts: int, chips_per_host: int, devices=None) -> Mesh:
    """('host', 'chip') mesh — the multi-host SHAPE: the chip axis maps
    to the cards within a host, the host axis to the network between
    hosts.  Both axes may be cut from one local device list; the
    sharding/collective layout is what a real multi-host mesh compiles."""
    if devices is None:
        devices = jax.devices()
    n = n_hosts * chips_per_host
    return Mesh(np.array(devices[:n]).reshape(n_hosts, chips_per_host),
                (HOST_AXIS, CHIP_AXIS))


@lru_cache(maxsize=16)
def shard_step_2d(mesh: Mesh, integrator: str, max_depth: int,
                  sqrt_spp: int, npix: int, kernel: bool = False):
    """Multi-host-shaped step: pixels shard over the CHIP axis — no
    collective needed, framebuffer shards stay put — and spp strata
    shard over the HOST axis, reduced with ONE psum over 'host' per call
    (SURVEY §5 comm-backend plan: one framebuffer reduction across
    hosts).  ``kernel`` only keys the cache.

    Returned jitted fn: (scene, cc, fb [npad,3] chip-sharded, key, s0)
    -> fb.  Renders strata s0+h for every host index h."""

    def local(scene, cc, fb_local, key, s0):
        n_local = fb_local.shape[0]
        chip = jax.lax.axis_index(CHIP_AXIS)
        host = jax.lax.axis_index(HOST_AXIS)
        s_lin = s0 + host
        spp_eff = sqrt_spp * sqrt_spp
        pix = chip * n_local + jnp.arange(n_local, dtype=jnp.int32)
        in_range = pix < npix
        pixc = jnp.minimum(pix, npix - 1)
        rad = _radiance_for(scene, cc, integrator, max_depth, sqrt_spp,
                            key, pixc, s_lin, fb_local.dtype)
        rad = jnp.where(in_range[..., None] & (s_lin < spp_eff), rad, 0.0)
        # one framebuffer reduction across hosts; the chip axis needs
        # no collective at all
        rad = jax.lax.psum(rad, HOST_AXIS)
        return fb_local + rad

    smapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(CHIP_AXIS), P(), P()),
        out_specs=P(CHIP_AXIS),
        check_vma=False,
    )
    return jax.jit(smapped, donate_argnums=(2,))


def render_distributed_2d(scene: SceneArrays, cfg: CameraConfig,
                          mesh: Mesh, seed: int = 0,
                          integrator: Optional[str] = None):
    """Full render over a ('host', 'chip') mesh: pixel shards per chip,
    strata batches per host, one psum over the host axis per
    batch.  Matches render_distributed's pixel-sharded result up to
    float addition order of the strata (the psum changes the reduction
    tree)."""
    integrator = integrator or cfg.integrator
    n_hosts, n_chips = (mesh.devices.shape[0], mesh.devices.shape[1])
    cc = camera_constants(cfg, scene.dtype)
    npix = cc.width * cc.height
    npad = int(np.ceil(npix / n_chips) * n_chips)
    S = cfg.sqrt_spp
    spp_eff = S * S

    # fb is chip-sharded, host-replicated
    sharding = NamedSharding(mesh, P(CHIP_AXIS))
    fb = jax.device_put(jnp.zeros((npad, 3), scene.dtype), sharding)
    key = jax.random.PRNGKey(seed)
    step = shard_step_2d(mesh, integrator, cfg.max_depth, S, npix,
                         _route(scene))
    for s0 in range(0, spp_eff, n_hosts):
        fb = step(scene, cc, fb, key, jnp.int32(s0))
    fb = np.asarray(fb)[:npix].reshape(cc.height, cc.width, 3)
    return fb, spp_eff


def render_distributed(
    scene: SceneArrays,
    cfg: CameraConfig,
    mesh: Optional[Mesh] = None,
    seed: int = 0,
    integrator: Optional[str] = None,
):
    """Full distributed render, pixel-sharded: one jitted step per
    stratum over the whole image.  Bit-identical to
    models.render.render on one device."""
    if mesh is None:
        mesh = make_mesh()
    integrator = integrator or cfg.integrator
    n = mesh.devices.size
    cc = camera_constants(cfg, scene.dtype)
    npix = cc.width * cc.height
    npad = int(np.ceil(npix / n) * n)
    S = cfg.sqrt_spp
    spp_eff = S * S

    sharding = NamedSharding(mesh, P(AXIS))
    fb = jax.device_put(jnp.zeros((npad, 3), scene.dtype), sharding)
    key = jax.random.PRNGKey(seed)
    step = shard_step(mesh, integrator, cfg.max_depth, S, npix,
                      _route(scene))
    for s_lin in range(spp_eff):
        fb = step(scene, cc, fb, key, jnp.int32(s_lin))
    if jax.process_count() > 1:
        # multi-controller run (parallel/multiprocess.py): the global
        # array is only partially addressable here — one collective
        # gather assembles the framebuffer on every process
        from jax.experimental import multihost_utils

        fb = multihost_utils.process_allgather(fb, tiled=True)
    fb = np.asarray(fb)[:npix].reshape(cc.height, cc.width, 3)
    return fb, spp_eff
