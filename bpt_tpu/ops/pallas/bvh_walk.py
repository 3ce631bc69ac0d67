"""Per-ray stackless BVH traversal for the GPU (Pallas, Triton route).

Each lane of a program carries one ray through the threaded-DFS BVH the
scene builder emits (``bvh_min``/``bvh_max``/``bvh_skip``/``bvh_first``/
``bvh_count``): an AABB hit at internal node i continues at i+1, a miss
or a finished leaf jumps to ``skip[i]``.  It is the walk of
``ops.soa.bvh_closest`` / ``bvh_any`` with the same visit order, the
same t-shrink and the same Möller–Trumbore arithmetic, but the loop runs
inside one kernel: a program iterates until its own ``BLOCK`` lanes are
done, instead of the whole wave stepping in lockstep until its slowest
ray finishes, and no loop predicate goes back to the host.

Nodes and triangles are read with per-lane gathers through L1/L2 (a
91k-triangle scene's tables are ~10 MB, well inside an H100's 50 MB L2).

``interpret=True`` runs the same kernel body on the CPU; that is how the
tests pin it against the jnp walks.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from bpt_tpu.ops.intersect import MT_EPSILON

# Rays per program (one warp, one ray per thread): the lockstep unit of
# the per-program loop.  On an H100 (coffee, 2^18 camera rays) closest
# hit took 6.7 / 8.9 / 11.0 ms at 32 / 64 / 128 rays per program.
BLOCK = 32
NUM_WARPS = 1

# packed table strides (floats / ints per node, floats per triangle)
_NF = 8  # bmin xyz, bmax xyz, 2 pad (32-byte rows)
_NI = 4  # skip, first, count, pad
_TF = 9  # v0 xyz, e1 xyz, e2 xyz


def pack_tables(scene):
    """Scene BVH + triangles as three flat gather tables (f32, i32, f32)."""
    n = scene.bvh_skip.shape[0]
    f32 = jnp.float32
    nf = jnp.concatenate(
        [scene.bvh_min.astype(f32), scene.bvh_max.astype(f32),
         jnp.zeros((n, _NF - 6), f32)], axis=1).reshape(-1)
    ni = jnp.stack(
        [scene.bvh_skip, scene.bvh_first, scene.bvh_count,
         jnp.zeros((n,), jnp.int32)], axis=1).astype(jnp.int32).reshape(-1)
    tf = jnp.concatenate(
        [scene.v0, scene.e1, scene.e2], axis=1).astype(f32).reshape(-1)
    return nf, ni, tf


def _nan_to(val, x):
    return jnp.where(x != x, jnp.float32(val), x)


def _slab(nf_ref, ic, mask, o, inv, lo, hi):
    """Ray/AABB overlap on (lo, hi) — soa.bvh_closest's slab, NaN-safe."""
    base = ic * _NF

    def g(k):
        return plgpu.load(nf_ref.at[base + k], mask=mask, other=0.0)

    t0x = (g(0) - o[0]) * inv[0]
    t1x = (g(3) - o[0]) * inv[0]
    t0y = (g(1) - o[1]) * inv[1]
    t1y = (g(4) - o[1]) * inv[1]
    t0z = (g(2) - o[2]) * inv[2]
    t1z = (g(5) - o[2]) * inv[2]
    inf = float("inf")
    enter = jnp.maximum(
        jnp.maximum(_nan_to(-inf, jnp.minimum(t0x, t1x)),
                    _nan_to(-inf, jnp.minimum(t0y, t1y))),
        jnp.maximum(_nan_to(-inf, jnp.minimum(t0z, t1z)), lo))
    exit_ = jnp.minimum(
        jnp.minimum(_nan_to(inf, jnp.maximum(t0x, t1x)),
                    _nan_to(inf, jnp.maximum(t0y, t1y))),
        jnp.minimum(_nan_to(inf, jnp.maximum(t0z, t1z)), hi))
    return (exit_ > enter) & mask


def _moller_trumbore(tf_ref, ti, mask, o, d):
    """soa._mt_one for one triangle per lane: (det, t, u, v)."""
    base = ti * _TF

    def g(k):
        return plgpu.load(tf_ref.at[base + k], mask=mask, other=0.0)

    v0 = (g(0), g(1), g(2))
    e1 = (g(3), g(4), g(5))
    e2 = (g(6), g(7), g(8))
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    inv = 1.0 / det
    tx = o[0] - v0[0]
    ty = o[1] - v0[1]
    tz = o[2] - v0[2]
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv
    return det, t, u, v


def _mt_valid(det, t, u, v, tmin, tmax):
    return ((jnp.abs(det) >= MT_EPSILON)
            & (u >= 0.0) & (u <= 1.0)
            & (v >= 0.0) & (u + v <= 1.0)
            & (t >= tmin) & (t <= tmax))


def _load_rays(ray_refs):
    ox, oy, oz, dx, dy, dz, tmin, tmax = (r[...] for r in ray_refs)
    o = (ox, oy, oz)
    d = (dx, dy, dz)
    inv = (1.0 / dx, 1.0 / dy, 1.0 / dz)
    return o, d, inv, tmin, tmax


def _any_lane(mask):
    return jnp.max(mask.astype(jnp.int32)) > 0


def _closest_kernel(nf_ref, ni_ref, tf_ref, *refs):
    ray_refs, (t_ref, u_ref, v_ref, tri_ref, nv_ref, ah_ref, tt_ref,
               th_ref) = refs[:8], refs[8:]
    n_nodes = ni_ref.shape[0] // _NI
    n_tris = tf_ref.shape[0] // _TF
    o, d, inv, tmin, tmax = _load_rays(ray_refs)
    zi = jnp.zeros(tmin.shape, jnp.int32)
    zf = jnp.zeros(tmin.shape, jnp.float32)

    def cond(c):
        return _any_lane(c[0] < n_nodes)

    def body(c):
        i, t_best, tri, ub, vb, nv, ah, tt, th = c
        active = i < n_nodes
        ic = jnp.minimum(i, n_nodes - 1)
        box = _slab(nf_ref, ic, active, o, inv, tmin, t_best)
        base = ic * _NI
        skip = plgpu.load(ni_ref.at[base], mask=active, other=0)
        first = plgpu.load(ni_ref.at[base + 1], mask=box, other=0)
        cnt = plgpu.load(ni_ref.at[base + 2], mask=box, other=0)
        leaf = box & (cnt > 0)
        for k in range(2):  # leaves hold 1-2 triangles (scene.bvh)
            lane = leaf & (cnt > k)
            ti = jnp.minimum(first + k, n_tris - 1)
            det, t, u, v = _moller_trumbore(tf_ref, ti, lane, o, d)
            # replace on t <= t_best: the reference's interval.contains
            ok = lane & _mt_valid(det, t, u, v, tmin, t_best)
            tt = tt + lane.astype(jnp.int32)
            th = th + ok.astype(jnp.int32)
            t_best = jnp.where(ok, t, t_best)
            tri = jnp.where(ok, ti, tri)
            ub = jnp.where(ok, u, ub)
            vb = jnp.where(ok, v, vb)
        nv = nv + active.astype(jnp.int32)
        ah = ah + box.astype(jnp.int32)
        nxt = jnp.where(box & (cnt == 0), ic + 1, skip)
        i = jnp.where(active, nxt, i)
        return i, t_best, tri, ub, vb, nv, ah, tt, th

    init = (zi, tmax, zi - 1, zf, zf, zi, zi, zi, zi)
    _, t_best, tri, ub, vb, nv, ah, tt, th = jax.lax.while_loop(
        cond, body, init)
    t_ref[...] = t_best
    tri_ref[...] = tri
    u_ref[...] = ub
    v_ref[...] = vb
    nv_ref[...] = nv
    ah_ref[...] = ah
    tt_ref[...] = tt
    th_ref[...] = th


def _any_kernel(nf_ref, ni_ref, tf_ref, *refs):
    ray_refs, found_ref = refs[:8], refs[8]
    n_nodes = ni_ref.shape[0] // _NI
    n_tris = tf_ref.shape[0] // _TF
    o, d, inv, tmin, tmax = _load_rays(ray_refs)
    zi = jnp.zeros(tmin.shape, jnp.int32)

    def live(c):
        i, found = c
        return (i < n_nodes) & (found == 0)

    def body(c):
        i, found = c
        active = live(c)
        ic = jnp.minimum(i, n_nodes - 1)
        box = _slab(nf_ref, ic, active, o, inv, tmin, tmax)
        base = ic * _NI
        skip = plgpu.load(ni_ref.at[base], mask=active, other=0)
        first = plgpu.load(ni_ref.at[base + 1], mask=box, other=0)
        cnt = plgpu.load(ni_ref.at[base + 2], mask=box, other=0)
        leaf = box & (cnt > 0)
        hit = jnp.zeros_like(leaf)
        for k in range(2):
            lane = leaf & (cnt > k)
            ti = jnp.minimum(first + k, n_tris - 1)
            det, t, u, v = _moller_trumbore(tf_ref, ti, lane, o, d)
            hit = hit | (lane & _mt_valid(det, t, u, v, tmin, tmax))
        found = found | hit.astype(jnp.int32)
        nxt = jnp.where(box & (cnt == 0), ic + 1, skip)
        i = jnp.where(active, nxt, i)
        return i, found

    _, found = jax.lax.while_loop(lambda c: _any_lane(live(c)), body,
                                  (zi, zi))
    found_ref[...] = found


def _launch(kernel, name, n_out_f32, n_out_i32, tables, rays, interpret):
    """Pad the wave to a BLOCK multiple (padding lanes get tmax = 0, so
    they fail the root test and retire at once) and launch one program
    per BLOCK rays."""
    B = rays[0].shape[0]
    Bp = -(-B // BLOCK) * BLOCK
    pad = Bp - B

    def prep(x, fill):
        x = x.astype(jnp.float32)
        return jnp.pad(x, (0, pad), constant_values=fill) if pad else x

    # (ox, oy, oz, dx, dy, dz, tmin, tmax); padded lanes: d = +x, tmax = 0
    fills = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0)
    rays = [prep(x, f) for x, f in zip(rays, fills)]
    lane = pl.BlockSpec((BLOCK,), lambda b: (b,))
    out_shape = ([jax.ShapeDtypeStruct((Bp,), jnp.float32)] * n_out_f32
                 + [jax.ShapeDtypeStruct((Bp,), jnp.int32)] * n_out_i32)
    out = pl.pallas_call(
        kernel,
        grid=(Bp // BLOCK,),
        in_specs=[pl.no_block_spec] * 3 + [lane] * 8,
        out_specs=[lane] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=name,
    )(*tables, *rays)
    return [x[:B] for x in out]


def _ray_args(o, d, tmin, tmax):
    B = o.x.shape[0]
    return (o.x, o.y, o.z, d.x, d.y, d.z,
            jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (B,)),
            jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (B,)))


@partial(jax.jit, static_argnames=("interpret",))
def closest(scene, o, d, tmin, tmax, interpret: bool = False):
    """Closest hit on (tmin, tmax] per lane.  Returns (t, tri, u, v) with
    tri = -1 on a miss, and per-lane traversal counters (node visits,
    AABB hits, triangle tests, triangle hits) with soa.bvh_closest's
    meaning."""
    t, u, v, tri, nv, ah, tt, th = _launch(
        _closest_kernel, "bvh_closest", 3, 5, pack_tables(scene),
        _ray_args(o, d, tmin, tmax), interpret)
    return t, tri, u, v, (nv, ah, tt, th)


@partial(jax.jit, static_argnames=("interpret",))
def any_hit(scene, o, d, tmin, tmax, interpret: bool = False):
    """Any hit on (tmin, tmax] per lane (bool [B])."""
    (found,) = _launch(_any_kernel, "bvh_any", 0, 1, pack_tables(scene),
                       _ray_args(o, d, tmin, tmax), interpret)
    return found > 0
