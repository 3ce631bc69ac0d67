"""Unidirectional path tracer with next-event estimation — wavefront form of
the reference's recursive path_trace_color (src/camera.h:255-292).

Per bounce, the whole ray batch moves through: intersect wave -> emission ->
delta-follow or 50/50 light/BSDF mixture sampling -> throughput update.
Dead lanes are masked (their traversal collapses via tmax = 0).  Estimator
semantics match the reference exactly: no Russian roulette, hard max_depth
cutoff, single-sample (attenuation * scattering_pdf * L) / mixture_pdf
estimator, emission dropped on delta bounces (skip_pdf early return,
camera.h:273-275).

Layout: the whole loop runs on component-SoA [B] arrays (see core.vec3);
[B,3] conversion happens only at the chunk boundary.  Randomness enters only
through ``uniforms_fn(bounce, n) -> n rows of [B]`` so tests can inject a
fixed tensor and compare against the NumPy oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bpt_tpu.core import rng as rng_mod
from bpt_tpu.core import vec3 as v3
from bpt_tpu.core.vec3 import Vec3
from bpt_tpu.ops import shade_soa as sh
from bpt_tpu.ops import soa
from bpt_tpu.ops.intersect import T_MIN
from bpt_tpu.scene.types import MAT_LIGHT, SceneArrays

# uniform slot layout per bounce
U_MIX = 0  # mixture_pdf 50/50 choice (pdf.h:82-86)
U_LPICK = 1  # light triangle pick (triangle.h:187)
U_LU = 2  # light barycentric u
U_LV = 3  # light barycentric v
U_B1 = 4  # bsdf dir sample
U_B2 = 5
U_DIEL = 6  # dielectric reflect/refract choice (material.h:109)
U_FZ1 = 7  # metal fuzz sphere dir
U_FZ2 = 8
NU = 9


class PTStats(NamedTuple):
    rays_traced: jnp.ndarray  # scalar int32 — reference-parity counter
    node_visits: jnp.ndarray
    aabb_hits: jnp.ndarray
    tri_tests: jnp.ndarray
    tri_hits: jnp.ndarray


def path_trace_fast(scene: SceneArrays, origins, dirs, ray_ids, key, max_depth: int):
    """The jnp wavefront on the render's RNG streams.  ray_ids < 0 marks
    inactive lanes (padding)."""
    active = ray_ids >= 0
    rad, stats = path_trace_radiance(
        scene, origins, dirs, max_depth,
        default_uniforms_fn(key, jnp.maximum(ray_ids, 0), origins.dtype),
    )
    return jnp.where(active[..., None], rad, 0.0), stats


def path_trace_pixels_fast(scene: SceneArrays, i, j, sx, sy, ray_ids,
                           cc, key, max_depth: int):
    """Ray generation + PT trace for pixel coordinates.  cc:
    CameraConstants.  key: the BASE render key (stream 0 jitters the
    camera ray, stream 1 drives the bounces)."""
    from bpt_tpu.models.camera import generate_rays

    ids = jnp.maximum(ray_ids, 0)
    k_gen = jax.random.fold_in(key, 0)
    u_gen = rng_mod.wave_uniforms(k_gen, ids, 0, 4, dtype=i.dtype)
    o, d = generate_rays(cc, i, j, sx, sy, u_gen)
    k_pt = jax.random.fold_in(key, 1)
    return path_trace_fast(scene, o, d, ray_ids, k_pt, max_depth)


def default_uniforms_fn(key, ray_ids, dtype):
    def fn(bounce, n):
        return rng_mod.uniform_rows(key, ray_ids, bounce, n, dtype=dtype)

    return fn


def array_uniforms_fn(uniforms):
    """uniforms: [B, D, NU] — the oracle-test injection path."""
    rows_all = jnp.moveaxis(uniforms, 0, -1)  # [D, NU, B]

    def fn(bounce, n):
        step = jax.lax.dynamic_index_in_dim(rows_all, bounce, axis=0,
                                            keepdims=False)  # [NU, B]
        return [step[i] for i in range(n)]

    return fn


def path_trace_radiance(
    scene: SceneArrays,
    origins,
    dirs,
    max_depth: int,
    uniforms_fn,
):
    """Radiance for a batch of primary rays. origins/dirs: [B,3].

    Returns (radiance [B,3], PTStats).
    """
    B = origins.shape[0]
    dtype = origins.dtype
    o0 = v3.from_array(origins)
    d0 = v3.from_array(dirs)
    bg = Vec3(scene.background[0], scene.background[1], scene.background[2])

    nu_total = NU + scene.num_volumes

    def body(b, state):
        o, d, thr, rad, alive, stats = state
        u = uniforms_fn(b, nu_total)

        h = soa.closest_hit(scene, o, d, T_MIN, jnp.inf, mask=alive)
        rec = soa.complete_hit(scene, o, d, h)
        if scene.num_volumes:
            rec = soa.apply_volumes(scene, o, d, rec, u[NU:], alive)
        mtype = scene.materials.mtype[rec.mat]

        miss = alive & ~rec.hit
        rad = v3.scale_add(rad, miss, thr * bg)

        live_hit = alive & rec.hit
        emission = sh.emitted(scene, rec.mat, rec.front_face, rec.u, rec.v, rec.p)
        delta = sh.is_delta(mtype)
        can_scatter = mtype != MAT_LIGHT

        # non-delta lanes add emission (skip_pdf lanes drop it, camera.h:273)
        rad = v3.scale_add(rad, live_hit & ~delta, thr * emission)

        atten = sh.attenuation(scene, rec.mat, mtype, rec.u, rec.v, rec.p)

        # delta continuation (camera.h:273-275)
        d_delta = sh.delta_scatter_dir(
            scene, rec.mat, mtype, d, rec.normal, rec.front_face,
            u[U_DIEL], u[U_FZ1], u[U_FZ2],
        )

        # mixture sampling (camera.h:277-289)
        light_dir = sh.sample_light_dir(scene, rec.p, u[U_LPICK], u[U_LU], u[U_LV])
        bsdf_dir = sh.sample_bsdf_dir(scene, mtype, rec.normal,
                                      u[U_B1], u[U_B2])
        pick_light = u[U_MIX] < 0.5
        d_diff = v3.where(pick_light, light_dir, bsdf_dir)

        pdf_val = 0.5 * sh.light_pdf_value(scene, rec.p, d_diff) + \
            0.5 * sh.bsdf_pdf_value(mtype, rec.normal, d_diff)
        scat_pdf = sh.scattering_pdf(mtype, rec.normal, d_diff)

        diffuse_ok = live_hit & can_scatter & ~delta & (pdf_val > 0.0)
        delta_ok = live_hit & can_scatter & delta

        w = jnp.where(pdf_val > 0.0, scat_pdf / jnp.where(pdf_val > 0.0, pdf_val, 1.0), 0.0)
        thr = v3.where(
            delta_ok,
            thr * atten,
            v3.where(diffuse_ok, thr * atten * w, thr),
        )

        alive_new = delta_ok | diffuse_ok
        o = v3.where(alive_new, rec.p, o)
        d = v3.where(alive_new, v3.where(delta_ok, d_delta, d_diff), d)

        stats = PTStats(
            rays_traced=stats.rays_traced + jnp.sum(alive, dtype=jnp.int32),
            node_visits=stats.node_visits + h.node_visits,
            aabb_hits=stats.aabb_hits + h.aabb_hits,
            tri_tests=stats.tri_tests + h.tri_tests,
            tri_hits=stats.tri_hits + h.tri_hits,
        )
        return (o, d, thr, rad, alive_new, stats)

    ones = jnp.ones((B,), dtype)
    zeros = jnp.zeros((B,), dtype)
    stats0 = PTStats(*(jnp.int32(0) for _ in range(5)))
    init = (
        o0, d0,
        Vec3(ones, ones, ones),
        Vec3(zeros, zeros, zeros),
        jnp.ones((B,), bool),
        stats0,
    )
    from bpt_tpu.models.bdpt import _loop

    o, d, thr, rad, alive, stats = _loop(max_depth, body, init)
    # depth-exhausted entry still bumps rays_traced (camera.h:256 runs before
    # the depth<=0 check)
    stats = stats._replace(
        rays_traced=stats.rays_traced + jnp.sum(alive, dtype=jnp.int32)
    )
    return v3.to_array(rad), stats
