"""SoA hot-path intersection: brute-force closest hit and threaded-BVH
traversal over component arrays.

Semantically identical to ops.intersect / ops.traverse (the oracle tests pin
both), but every per-ray quantity is a flat [B] array, and the BVH walk is a
single batched while_loop (all lanes step in lockstep; finished lanes idle at
i == num_nodes).  On the GPU, BVH scenes walk per ray in the Pallas kernel of
ops/pallas/bvh_walk instead (``use_traversal_kernel``); these jnp walks are
its reference and the CPU path.

Scene data is accessed through column views (loop-invariant slices of the
[T,3] arrays — XLA hoists them out of the loops).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bpt_tpu.core import vec3 as v3
from bpt_tpu.core.vec3 import Vec3
from bpt_tpu.ops.intersect import MT_EPSILON, T_MIN  # noqa: F401
from bpt_tpu.ops.pallas import bvh_walk
from bpt_tpu.scene.types import SceneArrays


class HitSoA(NamedTuple):
    hit: jnp.ndarray  # [B] bool
    t: jnp.ndarray  # [B] (inf when miss)
    tri: jnp.ndarray  # [B] int32
    u: jnp.ndarray  # [B]
    v: jnp.ndarray  # [B]
    # reference BvhStats counters, summed over the wave
    node_visits: jnp.ndarray  # scalar int32
    aabb_hits: jnp.ndarray
    tri_tests: jnp.ndarray
    tri_hits: jnp.ndarray


def _tri_columns(scene: SceneArrays):
    return (
        v3.from_array(scene.v0),
        v3.from_array(scene.e1),
        v3.from_array(scene.e2),
    )


def _mt_one(v0c: Vec3, e1c: Vec3, e2c: Vec3, ti, o: Vec3, d: Vec3):
    """Möller–Trumbore of the whole wave against triangle(s) ti ([B] or
    scalar index). Returns (det, t, u, v) — caller applies the validity
    predicate (triangle.h:41-74)."""
    tv0 = Vec3(v0c.x[ti], v0c.y[ti], v0c.z[ti])
    te1 = Vec3(e1c.x[ti], e1c.y[ti], e1c.z[ti])
    te2 = Vec3(e2c.x[ti], e2c.y[ti], e2c.z[ti])
    pvec = v3.cross(d, te2)
    det = v3.dot(te1, pvec)
    inv = 1.0 / det
    tvec = o - tv0
    u = v3.dot(tvec, pvec) * inv
    qvec = v3.cross(tvec, te1)
    v = v3.dot(d, qvec) * inv
    t = v3.dot(te2, qvec) * inv
    return det, t, u, v


def _mt_valid(det, t, u, v, tmin, tmax):
    return (
        (jnp.abs(det) >= MT_EPSILON)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t >= tmin) & (t <= tmax)
    )


def _col2(a, k):
    """[T,3] column k as a [T,1] operand."""
    return a[:, k][:, None]


def _mt_all(v0a, e1a, e2a, o: Vec3, d: Vec3):
    """Möller–Trumbore of every ray against every triangle as one [T, B]
    broadcast — no loops, no gathers; XLA fuses it with the reduction."""
    dx, dy, dz = d.x[None], d.y[None], d.z[None]  # [1,B]
    ox, oy, oz = o.x[None], o.y[None], o.z[None]
    e2x, e2y, e2z = _col2(e2a, 0), _col2(e2a, 1), _col2(e2a, 2)  # [T,1]
    e1x, e1y, e1z = _col2(e1a, 0), _col2(e1a, 1), _col2(e1a, 2)
    v0x, v0y, v0z = _col2(v0a, 0), _col2(v0a, 1), _col2(v0a, 2)

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / det
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    return det, t, u, v  # all [T, B]


def brute_closest(scene: SceneArrays, o: Vec3, d: Vec3, tmin, tmax) -> HitSoA:
    """Closest hit over all triangles via one [T,B] broadcast; argmin over
    the T axis (first-hit-wins on exact ties)."""
    T = scene.num_tris
    det, t, u, v = _mt_all(scene.v0, scene.e1, scene.e2, o, d)
    valid = _mt_valid(det, t, u, v, tmin[None], tmax[None])
    t_masked = jnp.where(valid, t, jnp.inf)
    tri = jnp.argmin(t_masked, axis=0).astype(jnp.int32)  # [B]
    t_best = jnp.min(t_masked, axis=0)
    hit = jnp.isfinite(t_best)
    ub = jnp.take_along_axis(u, tri[None], axis=0)[0]
    vb = jnp.take_along_axis(v, tri[None], axis=0)[0]
    B = o.x.shape[0]
    return HitSoA(
        hit=hit, t=t_best, tri=tri, u=ub, v=vb,
        node_visits=jnp.int32(0),
        aabb_hits=jnp.int32(0),
        tri_tests=jnp.int32(T) * B,
        tri_hits=jnp.sum(hit, dtype=jnp.int32),
    )


def brute_any(scene: SceneArrays, o: Vec3, d: Vec3, tmin, tmax):
    """Any-hit over all triangles via one [T,B] broadcast."""
    det, t, u, v = _mt_all(scene.v0, scene.e1, scene.e2, o, d)
    valid = _mt_valid(det, t, u, v, tmin[None], tmax[None])
    return jnp.any(valid, axis=0)


def bvh_closest(scene: SceneArrays, o: Vec3, d: Vec3, tmin, tmax) -> HitSoA:
    """Batched threaded-DFS traversal (same visit order and t-shrink as
    bvh_node::hit, src/acceleration/bvh.h:50-59)."""
    N = scene.bvh_skip.shape[0]
    B = o.x.shape[0]
    dtype = o.x.dtype

    bminc = v3.from_array(scene.bvh_min)
    bmaxc = v3.from_array(scene.bvh_max)
    skip = scene.bvh_skip
    first = scene.bvh_first
    count = scene.bvh_count
    v0c, e1c, e2c = _tri_columns(scene)

    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)

    def slab(ic, lo, hi):
        t0x = (bminc.x[ic] - o.x) * inv.x
        t1x = (bmaxc.x[ic] - o.x) * inv.x
        t0y = (bminc.y[ic] - o.y) * inv.y
        t1y = (bmaxc.y[ic] - o.y) * inv.y
        t0z = (bminc.z[ic] - o.z) * inv.z
        t1z = (bmaxc.z[ic] - o.z) * inv.z
        lox = jnp.minimum(t0x, t1x)
        hix = jnp.maximum(t0x, t1x)
        loy = jnp.minimum(t0y, t1y)
        hiy = jnp.maximum(t0y, t1y)
        loz = jnp.minimum(t0z, t1z)
        hiz = jnp.maximum(t0z, t1z)
        # NaN (o on slab, d == 0): treat axis as unconstrained (see
        # ops.intersect.slab_test)
        enter = jnp.maximum(
            jnp.maximum(_nan_to(-jnp.inf, lox), _nan_to(-jnp.inf, loy)),
            jnp.maximum(_nan_to(-jnp.inf, loz), lo),
        )
        exit_ = jnp.minimum(
            jnp.minimum(_nan_to(jnp.inf, hix), _nan_to(jnp.inf, hiy)),
            jnp.minimum(_nan_to(jnp.inf, hiz), hi),
        )
        return exit_ > enter

    def cond(state):
        return jnp.any(state[0] < N)

    def body(state):
        i, t_best, tri, ub, vb, nv, ah, tt, th = state
        active = i < N
        ic = jnp.minimum(i, N - 1)
        box_hit = slab(ic, tmin, t_best) & active
        cnt = count[ic]
        is_leaf = cnt > 0
        f0 = first[ic]

        do_leaf = box_hit & is_leaf

        def leaf_test(ti, active_l, t_best, tri, ub, vb, tt, th):
            det, t, u, v = _mt_one(v0c, e1c, e2c, ti, o, d)
            # replace on t <= t_best: reference interval.contains semantics
            ok = active_l & _mt_valid(det, t, u, v, tmin, t_best)
            tt = tt + jnp.sum(active_l, dtype=jnp.int32)
            th = th + jnp.sum(ok, dtype=jnp.int32)
            t_best = jnp.where(ok, t, t_best)
            tri = jnp.where(ok, ti, tri)
            ub = jnp.where(ok, u, ub)
            vb = jnp.where(ok, v, vb)
            return t_best, tri, ub, vb, tt, th

        T = scene.num_tris
        ti0 = jnp.minimum(f0, T - 1)
        ti1 = jnp.minimum(f0 + 1, T - 1)
        t_best, tri, ub, vb, tt, th = leaf_test(ti0, do_leaf, t_best, tri, ub, vb, tt, th)
        t_best, tri, ub, vb, tt, th = leaf_test(
            ti1, do_leaf & (cnt > 1), t_best, tri, ub, vb, tt, th
        )

        nv = nv + jnp.sum(active, dtype=jnp.int32)
        ah = ah + jnp.sum(box_hit, dtype=jnp.int32)
        nxt = jnp.where(box_hit & ~is_leaf, ic + 1, skip[ic])
        i = jnp.where(active, nxt, i)
        return (i, t_best, tri, ub, vb, nv, ah, tt, th)

    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, dtype), (B,))
    init = (
        jnp.zeros((B,), jnp.int32),
        tmax_b,
        jnp.full((B,), -1, jnp.int32),
        jnp.zeros((B,), dtype),
        jnp.zeros((B,), dtype),
        jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0),
    )
    i, t_best, tri, ub, vb, nv, ah, tt, th = jax.lax.while_loop(cond, body, init)
    hit = tri >= 0
    return HitSoA(
        hit=hit,
        t=jnp.where(hit, t_best, jnp.inf),
        tri=jnp.maximum(tri, 0),
        u=ub, v=vb,
        node_visits=nv, aabb_hits=ah, tri_tests=tt, tri_hits=th,
    )


def _nan_to(val, x):
    return jnp.where(jnp.isnan(x), x.dtype.type(val), x)


def bvh_any(scene: SceneArrays, o: Vec3, d: Vec3, tmin, tmax):
    """Batched any-hit traversal with whole-wave early exit."""
    N = scene.bvh_skip.shape[0]
    B = o.x.shape[0]
    dtype = o.x.dtype

    bminc = v3.from_array(scene.bvh_min)
    bmaxc = v3.from_array(scene.bvh_max)
    skip = scene.bvh_skip
    first = scene.bvh_first
    count = scene.bvh_count
    v0c, e1c, e2c = _tri_columns(scene)
    T = scene.num_tris

    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, dtype), (B,))
    tmin_b = jnp.broadcast_to(jnp.asarray(tmin, dtype), (B,))

    def slab(ic, active):
        t0x = (bminc.x[ic] - o.x) * inv.x
        t1x = (bmaxc.x[ic] - o.x) * inv.x
        t0y = (bminc.y[ic] - o.y) * inv.y
        t1y = (bmaxc.y[ic] - o.y) * inv.y
        t0z = (bminc.z[ic] - o.z) * inv.z
        t1z = (bmaxc.z[ic] - o.z) * inv.z
        enter = jnp.maximum(
            jnp.maximum(
                _nan_to(-jnp.inf, jnp.minimum(t0x, t1x)),
                _nan_to(-jnp.inf, jnp.minimum(t0y, t1y)),
            ),
            jnp.maximum(_nan_to(-jnp.inf, jnp.minimum(t0z, t1z)), tmin_b),
        )
        exit_ = jnp.minimum(
            jnp.minimum(
                _nan_to(jnp.inf, jnp.maximum(t0x, t1x)),
                _nan_to(jnp.inf, jnp.maximum(t0y, t1y)),
            ),
            jnp.minimum(_nan_to(jnp.inf, jnp.maximum(t0z, t1z)), tmax_b),
        )
        return (exit_ > enter) & active

    def cond(state):
        i, found = state
        return jnp.any((i < N) & ~found)

    def body(state):
        i, found = state
        active = (i < N) & ~found
        ic = jnp.minimum(i, N - 1)
        box_hit = slab(ic, active)
        cnt = count[ic]
        is_leaf = cnt > 0
        f0 = first[ic]
        do_leaf = box_hit & is_leaf

        det, t, u, v = _mt_one(v0c, e1c, e2c, jnp.minimum(f0, T - 1), o, d)
        h0 = _mt_valid(det, t, u, v, tmin_b, tmax_b)
        det, t, u, v = _mt_one(v0c, e1c, e2c, jnp.minimum(f0 + 1, T - 1), o, d)
        h1 = _mt_valid(det, t, u, v, tmin_b, tmax_b) & (cnt > 1)
        found = found | (do_leaf & (h0 | h1))

        nxt = jnp.where(box_hit & ~is_leaf, ic + 1, skip[ic])
        i = jnp.where(active, nxt, i)
        return (i, found)

    _, found = jax.lax.while_loop(
        cond, body, (jnp.zeros((B,), jnp.int32), jnp.zeros((B,), bool))
    )
    return found


# ----------------------------------------------------------------- dispatch


def use_traversal_kernel(scene: SceneArrays, dtype) -> bool:
    """The one traversal routing decision: BVH scenes in float32 on the
    GPU walk the BVH in the per-ray Pallas kernel (ops/pallas/bvh_walk);
    everything else runs the jnp walks above."""
    return (jax.default_backend() == "gpu" and bool(scene.use_bvh)
            and dtype == jnp.float32)


def _kernel_closest(scene, o, d, tmin, tmax_b) -> HitSoA:
    t, tri, u, v, counters = bvh_walk.closest(scene, o, d, tmin, tmax_b)
    hit = tri >= 0
    nv, ah, tt, th = (jnp.sum(c, dtype=jnp.int32) for c in counters)
    return HitSoA(
        hit=hit, t=jnp.where(hit, t, jnp.inf), tri=jnp.maximum(tri, 0),
        u=u, v=v, node_visits=nv, aabb_hits=ah, tri_tests=tt, tri_hits=th)


def closest_hit(scene: SceneArrays, o: Vec3, d: Vec3, tmin, tmax, mask=None) -> HitSoA:
    """mask: optional [B] bool — lanes with mask=False are culled (their
    tmax collapses to 0 so BVH traversal exits after the root test) and
    excluded from the stats counters."""
    B = o.x.shape[0]
    dtype = o.x.dtype
    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, dtype), (B,))
    if mask is not None:
        tmax_b = jnp.where(mask, tmax_b, 0.0)
    if scene.use_bvh:
        if use_traversal_kernel(scene, dtype):
            h = _kernel_closest(scene, o, d, tmin, tmax_b)
        else:
            h = bvh_closest(scene, o, d, tmin, tmax_b)
        if mask is not None:
            # culled lanes still "visit" the root before exiting; uncount
            h = h._replace(
                node_visits=h.node_visits - jnp.sum(~mask, dtype=jnp.int32)
            )
        return h
    tmin_b = jnp.broadcast_to(jnp.asarray(tmin, dtype), (B,))
    h = brute_closest(scene, o, d, tmin_b, tmax_b)
    if mask is not None:
        h = h._replace(
            tri_tests=jnp.sum(mask, dtype=jnp.int32) * scene.num_tris,
            tri_hits=jnp.sum(h.hit & mask, dtype=jnp.int32),
        )
    return h


def any_hit(scene: SceneArrays, o: Vec3, d: Vec3, tmin, tmax, mask=None):
    B = o.x.shape[0]
    tmin_b = jnp.broadcast_to(jnp.asarray(tmin, o.x.dtype), (B,))
    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, o.x.dtype), (B,))
    if mask is not None:
        tmax_b = jnp.where(mask, tmax_b, 0.0)
    if not scene.use_bvh:
        return brute_any(scene, o, d, tmin_b, tmax_b)
    if use_traversal_kernel(scene, o.x.dtype):
        return bvh_walk.any_hit(scene, o, d, tmin_b, tmax_b)
    return bvh_any(scene, o, d, tmin_b, tmax_b)


# ------------------------------------------------------------------ volumes


def _vol_closest(scene, vid, o: Vec3, d: Vec3, tmin, tmax):
    """Closest boundary hit of volume ``vid`` in (tmin, tmax) — the interval
    may be (-inf, inf): constant_medium probes with interval::universe
    (constant_medium.h:31-34).  [VT,B] broadcast, min over VT."""
    det, t, u, v = _mt_all(scene.vol_v0, scene.vol_e1, scene.vol_e2, o, d)
    owner = (scene.vol_tri_vol == vid)[:, None]
    valid = (
        owner
        & (jnp.abs(det) >= MT_EPSILON)
        & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t >= tmin) & (t <= tmax)
    )
    return jnp.min(jnp.where(valid, t, jnp.inf), axis=0)


def volume_interaction(scene, o: Vec3, d: Vec3, tmin, t_surf, u_rows, active):
    """constant_medium::hit (constant_medium.h:24-56) for every volume.

    t_surf: [B] — current closest surface t (the reference's closest_so_far
    shrink; volumes behave as if appended last to the hittable list).
    u_rows: V uniforms rows of [B] (one exponential free-flight draw each).
    Returns (hit [B], t [B], mat [B] int32).
    """
    B = o.x.shape[0]
    dtype = o.x.dtype
    d_len = v3.length(d)

    t_best = t_surf
    hit = jnp.zeros((B,), bool)
    mat = jnp.zeros((B,), jnp.int32)

    for vid in range(scene.num_volumes):
        t1 = _vol_closest(scene, vid, o, d, -jnp.inf, jnp.inf)
        h1 = jnp.isfinite(t1)
        t2 = _vol_closest(scene, vid, o, d, t1 + 1e-4, jnp.inf)
        h2 = jnp.isfinite(t2)

        tt1 = jnp.maximum(t1, jnp.asarray(tmin, dtype))
        tt2 = jnp.minimum(t2, t_best)
        ok = active & h1 & h2 & (tt1 < tt2)
        tt1 = jnp.maximum(tt1, 0.0)

        dist_inside = (tt2 - tt1) * d_len
        hd = scene.vol_neg_inv_density[vid] * jnp.log(u_rows[vid])
        ok = ok & (hd <= dist_inside)
        tv = tt1 + hd / d_len

        t_best = jnp.where(ok, tv, t_best)
        hit = jnp.where(ok, True, hit)
        mat = jnp.where(ok, scene.vol_mat[vid], mat)

    return hit, t_best, mat


def apply_volumes(scene, o: Vec3, d: Vec3, rec: "HitRecSoA", u_rows, active):
    """Override the surface hit record where a volume interaction comes
    first.  Volume hits get the reference's arbitrary normal (1,0,0),
    front_face=true (constant_medium.h:48-49), u=v=0."""
    t_surf = jnp.where(rec.hit, rec.t, jnp.inf)
    vhit, t_new, vmat = volume_interaction(scene, o, d, T_MIN, t_surf, u_rows, active)
    hit = rec.hit | vhit
    t = jnp.where(vhit, t_new, rec.t)
    t_safe = jnp.where(hit, t, 0.0)
    p = Vec3(o.x + t_safe * d.x, o.y + t_safe * d.y, o.z + t_safe * d.z)
    one = jnp.ones_like(t)
    zero = jnp.zeros_like(t)
    normal = v3.where(vhit, Vec3(one, zero, zero), rec.normal)
    return HitRecSoA(
        hit=hit,
        t=t,
        p=p,
        normal=normal,
        front_face=jnp.where(vhit, True, rec.front_face),
        tri=rec.tri,
        mat=jnp.where(vhit, vmat, rec.mat),
        u=jnp.where(vhit, 0.0, rec.u),
        v=jnp.where(vhit, 0.0, rec.v),
    )


class HitRecSoA(NamedTuple):
    hit: jnp.ndarray
    t: jnp.ndarray
    p: Vec3
    normal: Vec3  # flipped (set_face_normal, hittable.h:20-26)
    front_face: jnp.ndarray
    tri: jnp.ndarray
    mat: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray


def complete_hit(scene: SceneArrays, o: Vec3, d: Vec3, h: HitSoA) -> HitRecSoA:
    t_safe = jnp.where(h.hit, h.t, 0.0)
    p = Vec3(o.x + t_safe * d.x, o.y + t_safe * d.y, o.z + t_safe * d.z)
    nrm = v3.gather(scene.normal, h.tri)
    front = v3.dot(d, nrm) < 0.0
    normal = v3.where(front, nrm, -nrm)
    u, v = h.u, h.v
    if scene.has_textures:
        # per-vertex UV interpolation; the default table reproduces the
        # barycentric passthrough exactly (uv0=(0,0) uv1=(1,0) uv2=(0,1))
        uvt = scene.tri_uv[h.tri]
        u = uvt[:, 0] + u * (uvt[:, 2] - uvt[:, 0]) + v * (uvt[:, 4] - uvt[:, 0])
        v = uvt[:, 1] + h.u * (uvt[:, 3] - uvt[:, 1]) + h.v * (uvt[:, 5] - uvt[:, 1])
    return HitRecSoA(
        hit=h.hit, t=h.t, p=p, normal=normal, front_face=front,
        tri=h.tri, mat=scene.mat_id[h.tri], u=u, v=v,
    )
