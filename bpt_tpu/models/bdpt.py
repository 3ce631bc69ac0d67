"""Bidirectional integrator — wavefront form of bidirectional_color
(src/camera.h:294-475), component-SoA layout throughout.

Three stages, each a full-batch wave:

1. camera subpath: trace_path (camera.h:325-370) storing a vertex SoA with
   slot-major [S, B] arrays (slot rows are contiguous for the connection
   loop); per-vertex emission accumulates for non-delta vertices
   (camera.h:305-309) plus background on miss (camera.h:336-339).
2. light subpath: area-weighted emitter sample (camera.h:381-405; CDF
   searchsorted), throughput 1/max(pdf_area, 1e-8), cosine exit direction
   with throughput emission * cos / max(cos/pi, 1e-8) (camera.h:407-415),
   then the same trace for depth-1 more vertices.
3. connections: the (s, t) outer product evaluated blockwise — a fori loop
   over camera-vertex slots, each step a [S_l * B] wave of shadow rays —
   with the reference's exact rules: skip delta vertices, geometry term
   cos_c * cos_l / d^2, visibility epsilon 0.001 at both ends, light vertex
   contributes raw emission when it is an emitter (camera.h:440-475).
   NO MIS weights — faithful to the reference's (biased) all-pairs sum.

Randomness is injected via uniforms_fn callables for oracle testing.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bpt_tpu.core import vec3 as v3
from bpt_tpu.core.vec3 import Vec3
from bpt_tpu.ops import shade_soa as sh
from bpt_tpu.ops import soa
from bpt_tpu.ops.intersect import T_MIN
from bpt_tpu.scene.types import MAT_LIGHT, SceneArrays

# per-bounce uniform slots for trace_subpath
TU_B1 = 0  # bsdf dir sample
TU_B2 = 1
TU_DIEL = 2  # dielectric reflect choice
TU_FZ1 = 3  # metal fuzz sphere dir
TU_FZ2 = 4
NT = 5

# light-start uniform slots (one draw per sample)
LS_PICK = 0
LS_U = 1
LS_V = 2
LS_D1 = 3  # cosine exit dir
LS_D2 = 4
NLS = 5

# relative endpoint margin for connection visibility: the reference advances
# the shadow origin by 0.001*du AND sets max_t = dist - 0.001, which puts the
# emitter plane exactly at max_t — occlusion then flips on fp rounding. We
# shrink the range so the endpoint is excluded deterministically.
SHADOW_EPS_REL = 1e-4

# Bounce/slot loops unroll into straight-line XLA up to this depth.
# Measured on an H100 (80 GB HBM3, 400 W limit), cornell bdpt-mis at
# 512x512, 1 spp, depth 10: unrolled, 14.4 ms per warm step after a
# 112 s cold compile; as fori_loop, 27.0 ms per step after 12 s.  The
# step time is what a render pays per stratum, so the loops stay
# unrolled; past this depth (depth-80 configs) the graph size itself
# becomes the compile hazard, so the dynamic loop returns.
UNROLL_MAX = 32


def _loop(steps: int, body, state):
    """fori_loop semantics, unrolled for small static trip counts."""
    if steps <= UNROLL_MAX:
        for b in range(steps):
            state = body(b, state)
        return state
    return jax.lax.fori_loop(0, steps, body, state)


class Vertices(NamedTuple):
    """path_vertex SoA (camera.h:236-243); arrays are [S, B] (slot-major)."""

    valid: jnp.ndarray
    p: Vec3
    normal: Vec3
    wi: Vec3
    thr: Vec3
    emit: Vec3
    mat: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    delta: jnp.ndarray
    is_light: jnp.ndarray


class MisInfo(NamedTuple):
    """Per-slot MIS bookkeeping ([S, B] each, slot-major like Vertices).

    pfwd: area pdf of generating vertex i from vertex i-1 along the subpath
        (0 for delta-sampled segments; remapped to 1 in ratios, the standard
        deltas-cancel treatment).  Camera slot 0 stores 0 (the camera ray is
        common to every strategy and cancels); light slot 0 stores the
        emitter-area pdf.
    rat2: squared ratio (remap(pdf_rev(x_{i-1})) / remap(pfwd(x_{i-1})))^2
        linking slot i to slot i-1, where pdf_rev(x_{i-1}) is the area pdf
        of generating x_{i-1} from x_i via x_i's (incoming-independent)
        scattering pdf.  Slot 0 is unused.
    valid: 1.0 where strategy cut between slot i-1 and i is connectable
        (both endpoints non-delta); light slot 0 is always 1 (area light).
    """

    pfwd: jnp.ndarray
    rat2: jnp.ndarray
    valid: jnp.ndarray


def _remap0(x):
    """Veach remap: pdf 0 (delta) contributes ratio factor 1."""
    return jnp.where(x > 0.0, x, 1.0)


def mis_strategy_table(info: MisInfo):
    """[S, S, B] table P[m, i] = valid[i] * prod_{q=i+1..m} rat2[q]:
    the junction-independent part of the power-heuristic term for moving
    the path cut from slot m down to slot i (strategy keeping i subpath
    vertices on this side).  Built by an unrolled scan over slots."""
    S, B = info.valid.shape
    dtype = info.rat2.dtype
    rows = []
    prev = None
    for m in range(S):
        if m == 0:
            row = jnp.zeros((S, B), dtype).at[0].set(info.valid[0])
        else:
            row = (prev * info.rat2[m][None]).at[m].set(info.valid[m])
        rows.append(row)
        prev = row
    return jnp.stack(rows)  # [S(m), S(i), B]


class BDPTStats(NamedTuple):
    rays_traced: jnp.ndarray  # reference-parity (trace_path entries only)
    shadow_rays: jnp.ndarray
    node_visits: jnp.ndarray
    aabb_hits: jnp.ndarray
    tri_tests: jnp.ndarray
    tri_hits: jnp.ndarray


def _zv3(S, B, dtype):
    z = jnp.zeros((S, B), dtype)
    return Vec3(z, z, z)


def _empty_vertices(S, B, dtype):
    return Vertices(
        valid=jnp.zeros((S, B), bool),
        p=_zv3(S, B, dtype),
        normal=_zv3(S, B, dtype),
        wi=_zv3(S, B, dtype),
        thr=_zv3(S, B, dtype),
        emit=_zv3(S, B, dtype),
        mat=jnp.zeros((S, B), jnp.int32),
        u=jnp.zeros((S, B), dtype),
        v=jnp.zeros((S, B), dtype),
        delta=jnp.zeros((S, B), bool),
        is_light=jnp.zeros((S, B), bool),
    )


def _dyn_row(arr, s):
    return jax.lax.dynamic_index_in_dim(arr, s, axis=0, keepdims=False)


def _dyn_row3(vv: Vec3, s) -> Vec3:
    return Vec3(_dyn_row(vv.x, s), _dyn_row(vv.y, s), _dyn_row(vv.z, s))


def trace_subpath(
    scene: SceneArrays,
    o: Vec3,
    d: Vec3,
    thr0: Vec3,
    alive0,
    steps: int,
    uniforms_fn,
    collect_background: bool,
    mis_prev=None,
):
    """trace_path (camera.h:325-370) for ``steps`` bounces.

    Returns (Vertices [steps, B], background_contrib Vec3 [B], stats[, mis]).

    ``mis_prev`` (optional) enables per-vertex MIS pdf bookkeeping —
    a dict describing the vertex PRECEDING the first traced one:
      n (Vec3 [B]): its normal; delta (bool [B]); mtype (int32 [B]);
      pfwd ([B]): its own forward area pdf (1.0 for the camera, emitter
      area pdf for a light start).
    When given, a 4th return value MisInfo [steps, B] is appended.
    The bookkeeping exploits that every scattering pdf in the material
    set (cosine lambertian / uniform-sphere isotropic / cos-pi emitter
    exit) is independent of the incoming direction, so reverse pdfs of
    interior vertices are fixed at trace time.
    """
    B = o.x.shape[0]
    dtype = o.x.dtype
    verts = _empty_vertices(steps, B, dtype)
    zeros = jnp.zeros((B,), dtype)
    bg_acc = Vec3(zeros, zeros, zeros)
    bg = Vec3(scene.background[0], scene.background[1], scene.background[2])
    stats = BDPTStats(*(jnp.int32(0) for _ in range(6)))
    mis = (
        MisInfo(
            pfwd=jnp.zeros((steps, B), dtype),
            rat2=jnp.zeros((steps, B), dtype),
            valid=jnp.zeros((steps, B), dtype),
        )
        if mis_prev is not None
        else None
    )

    def set_row(arr, b, mask, val):
        return arr.at[b].set(jnp.where(mask, val, arr[b]))

    def set_row3(vv: Vec3, b, mask, val: Vec3) -> Vec3:
        return Vec3(
            set_row(vv.x, b, mask, val.x),
            set_row(vv.y, b, mask, val.y),
            set_row(vv.z, b, mask, val.z),
        )

    nt_total = NT + scene.num_volumes

    def body(b, state):
        o, d, thr, alive, verts, bg_acc, stats, mis, prev = state
        u = uniforms_fn(b, nt_total)

        h = soa.closest_hit(scene, o, d, T_MIN, jnp.inf, mask=alive)
        rec = soa.complete_hit(scene, o, d, h)
        if scene.num_volumes:
            rec = soa.apply_volumes(scene, o, d, rec, u[NT:], alive)
        mtype = scene.materials.mtype[rec.mat]

        miss = alive & ~rec.hit
        if collect_background:
            bg_acc = v3.scale_add(bg_acc, miss, thr * bg)

        valid_v = alive & rec.hit
        delta = sh.is_delta(mtype)
        emission = sh.emitted(scene, rec.mat, rec.front_face, rec.u, rec.v, rec.p)
        wi = v3.normalize_safe(-d)

        verts = Vertices(
            valid=set_row(verts.valid, b, valid_v, True),
            p=set_row3(verts.p, b, valid_v, rec.p),
            normal=set_row3(verts.normal, b, valid_v, rec.normal),
            wi=set_row3(verts.wi, b, valid_v, wi),
            thr=set_row3(verts.thr, b, valid_v, thr),
            emit=set_row3(verts.emit, b, valid_v, emission),
            mat=set_row(verts.mat, b, valid_v, rec.mat),
            u=set_row(verts.u, b, valid_v, rec.u),
            v=set_row(verts.v, b, valid_v, rec.v),
            delta=set_row(verts.delta, b, valid_v, delta),
            is_light=set_row(verts.is_light, b, valid_v, mtype == MAT_LIGHT),
        )

        if mis is not None:
            pp, pn, pdelta, pmtype, ppfwd = prev
            seg = Vec3(rec.p.x - pp.x, rec.p.y - pp.y, rec.p.z - pp.z)
            dist2 = jnp.maximum(v3.length_squared(seg), 1e-30)
            du = v3.normalize_safe(seg)
            cos_cur = jnp.abs(v3.dot(rec.normal, du))
            cos_prev = jnp.abs(v3.dot(pn, du))
            # forward: prev vertex's scattering pdf toward us, area measure
            pdf_sa_f = jnp.where(pdelta, 0.0,
                                 sh.bsdf_pdf_value(pmtype, pn, du))
            pfwd_cur = pdf_sa_f * cos_cur / dist2
            # reverse: OUR scattering pdf back toward prev, area measure.
            # Delta vertices contribute factor 1 (the delta pdfs cancel
            # across strategies); a GENUINE zero (backside cos) stays 0 —
            # those reverse strategies are impossible.
            prev_rev = jnp.where(
                delta, 1.0,
                sh.bsdf_pdf_value(mtype, rec.normal, -du) * cos_prev / dist2,
            )
            rat = prev_rev / _remap0(ppfwd)
            valid_cut = (~delta & ~pdelta).astype(dtype)
            mis = MisInfo(
                pfwd=set_row(mis.pfwd, b, valid_v, pfwd_cur),
                rat2=set_row(mis.rat2, b, valid_v, rat * rat),
                valid=set_row(mis.valid, b, valid_v, valid_cut),
            )
            prev = (
                v3.where(valid_v, rec.p, pp),
                v3.where(valid_v, rec.normal, pn),
                jnp.where(valid_v, delta, pdelta),
                jnp.where(valid_v, mtype, pmtype),
                jnp.where(valid_v, pfwd_cur, ppfwd),
            )

        can_scatter = mtype != MAT_LIGHT
        atten = sh.attenuation(scene, rec.mat, mtype, rec.u, rec.v, rec.p)

        d_delta = sh.delta_scatter_dir(
            scene, rec.mat, mtype, d, rec.normal, rec.front_face,
            u[TU_DIEL], u[TU_FZ1], u[TU_FZ2],
        )
        d_bsdf = sh.sample_bsdf_dir(scene, mtype, rec.normal, u[TU_B1], u[TU_B2])
        pdf_val = sh.bsdf_pdf_value(mtype, rec.normal, d_bsdf)
        scat_pdf = sh.scattering_pdf(mtype, rec.normal, d_bsdf)

        delta_ok = valid_v & can_scatter & delta
        diff_ok = valid_v & can_scatter & ~delta & (pdf_val > 0.0)
        w = jnp.where(pdf_val > 0.0, scat_pdf / jnp.where(pdf_val > 0.0, pdf_val, 1.0), 0.0)

        thr = v3.where(delta_ok, thr * atten,
                       v3.where(diff_ok, thr * atten * w, thr))
        alive_new = delta_ok | diff_ok
        o = v3.where(alive_new, rec.p, o)
        d = v3.where(alive_new, v3.where(delta_ok, d_delta, d_bsdf), d)

        stats = BDPTStats(
            rays_traced=stats.rays_traced + jnp.sum(alive, dtype=jnp.int32),
            shadow_rays=stats.shadow_rays,
            node_visits=stats.node_visits + h.node_visits,
            aabb_hits=stats.aabb_hits + h.aabb_hits,
            tri_tests=stats.tri_tests + h.tri_tests,
            tri_hits=stats.tri_hits + h.tri_hits,
        )
        return (o, d, thr, alive_new, verts, bg_acc, stats, mis, prev)

    if mis_prev is not None:
        prev0 = (mis_prev["p"], mis_prev["n"], mis_prev["delta"],
                 mis_prev["mtype"], mis_prev["pfwd"])
    else:
        prev0 = None
    if steps > 0:
        state = (o, d, thr0, alive0, verts, bg_acc, stats, mis, prev0)
        state = _loop(steps, body, state)
        _, _, _, _, verts, bg_acc, stats, mis, _ = state
    if mis_prev is not None:
        return verts, bg_acc, stats, mis
    return verts, bg_acc, stats


def build_light_subpath(scene: SceneArrays, B, max_depth: int, start_u,
                        uniforms_fn, dtype, mis: bool = False):
    """build_light_path (camera.h:372-418). start_u: NLS rows of [B].
    With ``mis`` a MisInfo for the FULL light path (emitter slot included)
    is returned as a 5th value."""
    s = sh.sample_surface(scene, start_u[LS_PICK], start_u[LS_U], start_u[LS_V])

    # emitter emission: forced front_face=true, u=v=0 (camera.h:385-394)
    zeros = jnp.zeros((B,), dtype)
    emission = sh.emitted(scene, s.mat, jnp.ones((B,), bool), zeros, zeros, s.position)
    path_ok = s.valid & (v3.length_squared(emission) > 0.0)

    inv_pdf = 1.0 / jnp.maximum(s.pdf, 1e-8)
    thr0 = Vec3(inv_pdf, inv_pdf, inv_pdf)

    def as_slot(x):
        return x[None]

    emitter = Vertices(
        valid=as_slot(path_ok),
        p=Vec3(*(as_slot(c) for c in s.position)),
        normal=Vec3(*(as_slot(c) for c in s.normal)),
        wi=Vec3(*(as_slot(c) for c in s.normal)),  # camera.h:401
        thr=Vec3(*(as_slot(c) for c in thr0)),
        emit=Vec3(*(as_slot(c) for c in emission)),
        mat=as_slot(s.mat),
        u=as_slot(zeros),
        v=as_slot(zeros),
        delta=as_slot(jnp.zeros((B,), bool)),
        is_light=as_slot(path_ok),
    )

    # cosine exit (camera.h:407-415)
    dir_unit = v3.normalize_safe(
        sh.cosine_direction_world(s.normal, start_u[LS_D1], start_u[LS_D2])
    )
    cos_theta = jnp.maximum(0.0, v3.dot(s.normal, dir_unit))
    exit_ok = path_ok & (cos_theta > 0.0)
    pdf_dir = jnp.maximum(cos_theta / sh.PI, 1e-8)
    scale = cos_theta / pdf_dir
    thr = Vec3(
        thr0.x * emission.x * scale,
        thr0.y * emission.y * scale,
        thr0.z * emission.z * scale,
    )
    o = Vec3(
        s.position.x + 0.001 * s.normal.x,
        s.position.y + 0.001 * s.normal.y,
        s.position.z + 0.001 * s.normal.z,
    )

    mis_prev = None
    if mis:
        mis_prev = dict(
            p=s.position,
            n=s.normal,
            delta=jnp.zeros((B,), bool),
            mtype=scene.materials.mtype[s.mat],  # MAT_LIGHT: cos/pi exit pdf
            pfwd=s.pdf.astype(dtype),
        )
    out = trace_subpath(
        scene, o, dir_unit, thr, exit_ok, max_depth - 1, uniforms_fn,
        collect_background=False, mis_prev=mis_prev,
    )
    if mis:
        traced, _, stats, mis_tail = out
        ones = jnp.ones((1, B), dtype)
        mis_full = MisInfo(
            pfwd=jnp.concatenate([s.pdf.astype(dtype)[None], mis_tail.pfwd]),
            rat2=jnp.concatenate([jnp.zeros((1, B), dtype), mis_tail.rat2]),
            valid=jnp.concatenate([ones, mis_tail.valid]),  # area light
        )
        return emitter, traced, path_ok, stats, mis_full
    traced, _, stats = out
    return emitter, traced, path_ok, stats


def _concat_vertices(a: Vertices, b: Vertices) -> Vertices:
    def cat(x, y):
        if isinstance(x, Vec3):
            return Vec3(*(jnp.concatenate([cx, cy], axis=0) for cx, cy in zip(x, y)))
        return jnp.concatenate([x, y], axis=0)

    return Vertices(*(cat(x, y) for x, y in zip(a, b)))


def connect_paths(scene: SceneArrays, cam: Vertices, light: Vertices,
                  mis_c: MisInfo = None, mis_l: MisInfo = None,
                  max_depth: int = 0, ref_vis: bool = False):
    """All-pairs connect_vertices (camera.h:316-320, 440-475), blockwise over
    camera slots; one [S_l*B] shadow wave per slot.

    When mis_c/mis_l are given each (s, t) contribution is weighted by the
    power heuristic (beta=2) over every strategy of the same path length
    that the estimator realizes (t' in [max(1, k-max_depth), min(k,
    max_depth)], k = s+t) — a deviation from the reference, which sums
    all pairs unweighted (docs/PARITY.md).

    ``ref_vis`` emulates the reference binary's endpoint artifact: the
    shadow range ends EXACTLY at the connection endpoint's surface
    (max_t, inclusive), so fp rounding of the Möller–Trumbore t rejects
    ~86% of genuinely-visible connections (measured; docs/PARITY.md).
    Meaningful in f64 where our M-T acceptance rate tracks the
    reference's (12.6% vs 13.6% on the cornell floor->light ensemble)."""
    S_c, B = cam.valid.shape
    S_l = light.valid.shape[0]
    dtype = cam.p.x.dtype
    mis = mis_c is not None
    if mis:
        P_c = mis_strategy_table(mis_c)  # [S_c, S_c, B]
        P_l = mis_strategy_table(mis_l)  # [S_l, S_l, B]
        lmt_all = scene.materials.mtype[light.mat.reshape(-1)].reshape(S_l, B)
        l_delta_f = light.delta.astype(dtype)
        n_idx = jnp.arange(S_l, dtype=jnp.int32)
        j_idx = jnp.arange(S_l, dtype=jnp.int32)
        i_idx = jnp.arange(S_c, dtype=jnp.int32)
        # light-side sums are junction-(m)-dependent only through the
        # realizability clamp t' = k - s' <= max_depth, i.e. j >= k - D
        # (k = m + n + 2); precompute per-n tables below inside the loop

    # light-side factors, independent of s (evaluate once)
    lmat = light.mat.reshape(-1)
    lmtype = scene.materials.mtype[lmat]
    f_light_bsdf = sh.evaluate_bsdf(
        scene, lmat, lmtype, light.u.reshape(-1), light.v.reshape(-1),
        Vec3(*(c.reshape(-1) for c in light.p)),
    )
    f_light_bsdf = Vec3(*(c.reshape(S_l, B) for c in f_light_bsdf))
    # emitter vertices use raw emission as their "BSDF" (camera.h:462-467)
    f_light = v3.where(light.is_light, light.emit, f_light_bsdf)
    light_factor = light.thr * f_light  # [S_l, B]
    light_ok = light.valid & ~light.delta & (v3.length_squared(f_light) > 0.0)

    def slot_terms(s):
        """Geometry + (MIS-weighted) contribution of camera slot ``s``
        against every light slot — everything EXCEPT the visibility
        test.  Returns (pair_ok [S_l,B] pre-occlusion, so Vec3, du Vec3,
        t_vis, contrib Vec3) — the caller applies occlusion and sums."""
        row = _dyn_row
        row3 = _dyn_row3
        cp = row3(cam.p, s)
        cn = row3(cam.normal, s)
        cthr = row3(cam.thr, s)
        cmat = row(cam.mat, s)
        cu = row(cam.u, s)
        cv = row(cam.v, s)
        c_ok = row(cam.valid, s) & ~row(cam.delta, s)

        cmtype = scene.materials.mtype[cmat]
        f_cam = sh.evaluate_bsdf(scene, cmat, cmtype, cu, cv, cp)  # [B]
        c_ok = c_ok & (v3.length_squared(f_cam) > 0.0)
        cam_factor = cthr * f_cam  # Vec3 [B]

        # broadcast cam row against light slots: [S_l, B]
        diff = Vec3(
            light.p.x - cp.x[None],
            light.p.y - cp.y[None],
            light.p.z - cp.z[None],
        )
        dist2 = v3.length_squared(diff)
        pair_ok = c_ok[None] & light_ok & (dist2 > 0.0)

        dist = jnp.sqrt(jnp.maximum(dist2, 1e-30))
        if ref_vis:
            # the reference divides per-component (camera.h:429); in the
            # endpoint-tie regime the reciprocal-multiply form shifts the
            # fp acceptance rate (14.8% vs the binary's 13.6% measured)
            du = Vec3(diff.x / dist, diff.y / dist, diff.z / dist)
        else:
            inv_dist = 1.0 / dist
            du = Vec3(diff.x * inv_dist, diff.y * inv_dist, diff.z * inv_dist)
        sgn_cam = du.x * cn.x[None] + du.y * cn.y[None] + du.z * cn.z[None]
        sgn_light = v3.dot(light.normal, -du)
        cos_cam = jnp.abs(sgn_cam)
        cos_light = jnp.abs(sgn_light)
        pair_ok = pair_ok & (cos_cam > 0.0) & (cos_light > 0.0)
        if mis:
            # one-sided connections: the reference's abs() cosines transport
            # light through the BACK of one-sided lambertian surfaces
            # (camera.h:455-456) — paths the forward strategies can never
            # sample, which no weighting can repair.  bdpt-mis therefore
            # requires same-hemisphere connections (isotropic scatterers
            # stay two-sided, matching their spherical pdf).
            from bpt_tpu.scene.types import MAT_ISOTROPIC

            iso_c = cmtype == MAT_ISOTROPIC
            iso_l = lmt_all == MAT_ISOTROPIC
            pair_ok = pair_ok & (iso_c[None] | (sgn_cam > 0.0))
            pair_ok = pair_ok & (iso_l | (sgn_light > 0.0))

        # visible(a, b) (camera.h:425-438) with the endpoint margin;
        # the occlusion test itself is the caller's
        max_t = dist - 0.001
        pair_ok = pair_ok & (max_t > 0.0)
        so = Vec3(
            cp.x[None] + 0.001 * du.x,
            cp.y[None] + 0.001 * du.y,
            cp.z[None] + 0.001 * du.z,
        )
        t_vis = max_t if ref_vis else max_t * (1.0 - SHADOW_EPS_REL)

        g = (cos_cam * cos_light) / jnp.maximum(dist2, 1e-30)
        contrib = Vec3(
            cam_factor.x[None] * light_factor.x * g,
            cam_factor.y[None] * light_factor.y * g,
            cam_factor.z[None] * light_factor.z * g,
        )
        if mis:
            d2s = jnp.maximum(dist2, 1e-30)
            # reverse pdf of the camera junction vertex: light junction's
            # scattering pdf toward it (emitter slot: cos/pi exit pdf via
            # MAT_LIGHT), area measure
            rev_c = jnp.where(
                l_delta_f > 0.5, 0.0,
                sh.bsdf_pdf_value(lmt_all, light.normal, -du),
            ) * cos_cam / d2s  # [S_l, B]
            # reverse pdf of the light junction vertex: camera junction's
            # scattering pdf toward it
            rev_l = jnp.where(
                row(cam.delta, s)[None], 0.0,
                sh.bsdf_pdf_value(cmtype[None], Vec3(cn.x[None], cn.y[None],
                                                     cn.z[None]), du),
            ) * cos_light / d2s  # [S_l, B]
            # junction endpoints are non-delta wherever the pair
            # contributes, so zero reverse pdfs here are genuine (backside
            # cos) and must NOT be remapped — they zero those strategies
            pf_c = _remap0(row(mis_c.pfwd, s))  # [B]
            rc_ratio = rev_c / pf_c[None]
            rl_ratio = rev_l / _remap0(mis_l.pfwd)
            # realizability clamp: strategies keeping i camera vertices
            # need the light side k - i <= max_depth, so i >= k - D with
            # k = (s+1) + (n+1); symmetric for the light side
            k_tot = s + n_idx + 2  # [S_l]
            cmask = (i_idx[None, :] >= (k_tot - max_depth)[:, None]).astype(dtype)
            Pm = row(P_c, s)  # [S_c, B]
            # HIGHEST: a float32 product may otherwise run in TF32 on the
            # GPU (~3 decimal digits), which would bias the
            # power-heuristic weights
            sum_c = rc_ratio * rc_ratio * jnp.einsum(
                "ni,ib->nb", cmask, Pm,
                precision=jax.lax.Precision.HIGHEST)
            lmask = (j_idx[None, :] >= (k_tot - max_depth)[:, None]).astype(dtype)
            sum_l = rl_ratio * rl_ratio * jnp.einsum(
                "nj,njb->nb", lmask * (j_idx[None, :] <= n_idx[:, None]), P_l,
                precision=jax.lax.Precision.HIGHEST)
            w_mis = 1.0 / (1.0 + sum_c + sum_l)
            contrib = Vec3(contrib.x * w_mis, contrib.y * w_mis,
                           contrib.z * w_mis)
        return pair_ok, so, du, t_vis, contrib

    def accumulate(acc, pair_ok, contrib):
        """Occlusion already folded into pair_ok."""
        total, n_shadow = acc
        masked = v3.where(pair_ok, contrib, _zv3(S_l, B, dtype))
        total = Vec3(
            total.x + jnp.sum(masked.x, axis=0),
            total.y + jnp.sum(masked.y, axis=0),
            total.z + jnp.sum(masked.z, axis=0),
        )
        return (total, n_shadow + jnp.sum(pair_ok, dtype=jnp.int32))

    zeros = jnp.zeros((B,), dtype)
    acc0 = (Vec3(zeros, zeros, zeros), jnp.int32(0))

    def body(s, acc):
        pair_ok, so, du, t_vis, contrib = slot_terms(s)
        so_f = Vec3(*(c.reshape(-1) for c in so))
        du_f = Vec3(*(c.reshape(-1) for c in du))
        occluded = soa.any_hit(
            scene, so_f, du_f, T_MIN, t_vis.reshape(-1),
            mask=pair_ok.reshape(-1),
        ).reshape(S_l, B)
        return accumulate(acc, pair_ok & ~occluded, contrib)

    total, n_shadow = _loop(S_c, body, acc0)
    return total, n_shadow


def bdpt_fast(scene: SceneArrays, origins, dirs, ray_ids, key, max_depth: int,
              mis: bool = False, ref_vis: bool = False):
    """The jnp wavefront on the render's RNG streams.  ``key`` is the
    base render key (streams 2/3/4 fold internally); ray_ids < 0 =
    inactive."""
    from bpt_tpu.core import rng as rng_mod
    from bpt_tpu.models import pt as pt_mod

    active = ray_ids >= 0
    ids = jnp.maximum(ray_ids, 0)
    dtype = origins.dtype
    k_cam = jax.random.fold_in(key, 2)
    k_ls = jax.random.fold_in(key, 3)
    k_lt = jax.random.fold_in(key, 4)
    ls_u = rng_mod.wave_uniforms(k_ls, ids, 0, NLS, dtype=dtype)
    rad, stats = bdpt_radiance(
        scene, origins, dirs, max_depth,
        pt_mod.default_uniforms_fn(k_cam, ids, dtype),
        ls_u,
        pt_mod.default_uniforms_fn(k_lt, ids, dtype),
        mis=mis, ref_vis=ref_vis,
    )
    return jnp.where(active[..., None], rad, 0.0), stats


def bdpt_radiance(
    scene: SceneArrays,
    origins,
    dirs,
    max_depth: int,
    cam_uniforms_fn,
    light_start_u,
    light_uniforms_fn,
    mis: bool = False,
    ref_vis: bool = False,
):
    """bidirectional_color (camera.h:294-323) for a batch of primary rays.

    light_start_u: [B, NLS] array (or NLS rows of [B]).
    ``mis`` switches on power-heuristic multiple importance sampling over
    the (s, t) strategies — OUR upgrade, not in the reference (which
    overcounts by summing all pairs unweighted, camera.h:316-320).
    """
    B = origins.shape[0]
    dtype = origins.dtype
    o0 = v3.from_array(origins)
    d0 = v3.from_array(dirs)
    ones = jnp.ones((B,), dtype)

    if not isinstance(light_start_u, (list, tuple)):
        light_start_u = [light_start_u[:, i] for i in range(NLS)]

    mis_prev_cam = None
    if mis:
        mis_prev_cam = dict(
            p=o0,
            n=v3.normalize_safe(d0),
            delta=jnp.ones((B,), bool),  # camera: pfwd[0] -> 0 -> remap 1
            mtype=jnp.zeros((B,), jnp.int32),
            pfwd=ones,
        )
    cam_out = trace_subpath(
        scene, o0, d0, Vec3(ones, ones, ones), jnp.ones((B,), bool),
        max_depth, cam_uniforms_fn, collect_background=True,
        mis_prev=mis_prev_cam,
    )
    if mis:
        cam, bg_acc, stats_c, mis_c = cam_out
    else:
        cam, bg_acc, stats_c = cam_out
        mis_c = None

    # camera-vertex emission (camera.h:305-309); strategy (s=0, t) under MIS
    emit_mask = cam.valid & ~cam.delta
    ve = v3.where(emit_mask, cam.thr * cam.emit, _zv3(max_depth, B, dtype))
    if mis:
        # reverse pdf of the emitting vertex under the s>=1 strategies:
        # the emitter-area pdf of sample_surface (area-weighted pick ->
        # 1/total_area anywhere on any light, shade_soa.sample_surface)
        inv_area = jnp.where(
            scene.light_total_area > 0.0,
            1.0 / jnp.maximum(scene.light_total_area, 1e-30), 0.0,
        ).astype(dtype)
        P_c = mis_strategy_table(mis_c)  # [S, S, B]
        sums = jnp.sum(P_c, axis=1)  # [S, B]; k = m+1 <= D: no clamp needed
        r_em = inv_area / _remap0(mis_c.pfwd)
        w_em = 1.0 / (1.0 + r_em * r_em * sums)
        ve = Vec3(ve.x * w_em, ve.y * w_em, ve.z * w_em)
    result = Vec3(
        bg_acc.x + jnp.sum(ve.x, axis=0),
        bg_acc.y + jnp.sum(ve.y, axis=0),
        bg_acc.z + jnp.sum(ve.z, axis=0),
    )

    light_out = build_light_subpath(
        scene, B, max_depth, light_start_u, light_uniforms_fn, dtype, mis=mis
    )
    if mis:
        emitter, traced, path_ok, stats_l, mis_l = light_out
    else:
        emitter, traced, path_ok, stats_l = light_out
        mis_l = None
    light = _concat_vertices(emitter, traced) if max_depth > 1 else emitter

    connect, n_shadow = connect_paths(scene, cam, light, mis_c=mis_c,
                                      mis_l=mis_l, max_depth=max_depth,
                                      ref_vis=ref_vis)
    result = Vec3(
        result.x + connect.x, result.y + connect.y, result.z + connect.z
    )

    stats = BDPTStats(
        rays_traced=stats_c.rays_traced + stats_l.rays_traced,
        shadow_rays=n_shadow,
        node_visits=stats_c.node_visits + stats_l.node_visits,
        aabb_hits=stats_c.aabb_hits + stats_l.aabb_hits,
        tri_tests=stats_c.tri_tests + stats_l.tri_tests,
        tri_hits=stats_c.tri_hits + stats_l.tri_hits,
    )
    return v3.to_array(result), stats
