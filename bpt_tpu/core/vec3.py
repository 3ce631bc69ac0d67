"""Component-SoA 3-vectors: x/y/z as separate [B] arrays.

Keeping each component a flat [B] array makes every elementwise op a
contiguous, unit-stride wave (no [B,3] minor-dimension shuffles).  This
module is the hot-path vector algebra; the [..., 3] API in core.vecmath
remains for boundaries and tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Vec3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # elementwise arithmetic (scalar or Vec3 operands)
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def from_array(a) -> Vec3:
    """[..., 3] -> Vec3 of [...] components (boundary conversion)."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def to_array(v: Vec3):
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def splat(a, like=None) -> Vec3:
    """Length-3 constant vector -> broadcastable Vec3."""
    return Vec3(a[0], a[1], a[2])


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length_squared(v: Vec3):
    return dot(v, v)


def length(v: Vec3):
    return jnp.sqrt(length_squared(v))


def unit(v: Vec3) -> Vec3:
    inv = 1.0 / length(v)
    return Vec3(v.x * inv, v.y * inv, v.z * inv)


def normalize_safe(v: Vec3, eps=1e-20) -> Vec3:
    """Matches vecmath.normalize_safe exactly (oracle parity)."""
    n2 = length_squared(v)
    inv = jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, eps)), 0.0)
    return Vec3(v.x * inv, v.y * inv, v.z * inv)


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    """mask: [B] bool (no [..., None] broadcasting needed)."""
    return Vec3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def scale_add(acc: Vec3, mask, term: Vec3) -> Vec3:
    """acc + (mask ? term : 0) — the radiance-accumulate idiom."""
    return Vec3(
        acc.x + jnp.where(mask, term.x, 0.0),
        acc.y + jnp.where(mask, term.y, 0.0),
        acc.z + jnp.where(mask, term.z, 0.0),
    )


def reflect(v: Vec3, n: Vec3) -> Vec3:
    d = dot(v, n)
    return Vec3(v.x - 2.0 * d * n.x, v.y - 2.0 * d * n.y, v.z - 2.0 * d * n.z)


def refract(uv: Vec3, n: Vec3, eta) -> Vec3:
    """Snell refraction of a unit vector (vec3.h:142-147); eta: [B]."""
    cos_t = jnp.minimum(dot(-uv, n), 1.0)
    perp = Vec3(
        eta * (uv.x + cos_t * n.x),
        eta * (uv.y + cos_t * n.y),
        eta * (uv.z + cos_t * n.z),
    )
    par = -jnp.sqrt(jnp.abs(1.0 - length_squared(perp)))
    return Vec3(perp.x + par * n.x, perp.y + par * n.y, perp.z + par * n.z)


def broadcast_to(v: Vec3, shape) -> Vec3:
    return Vec3(
        jnp.broadcast_to(v.x, shape),
        jnp.broadcast_to(v.y, shape),
        jnp.broadcast_to(v.z, shape),
    )


def full_like(ref, vals, dtype=None) -> Vec3:
    dtype = dtype or ref.dtype
    return Vec3(
        jnp.full(ref.shape, vals[0], dtype),
        jnp.full(ref.shape, vals[1], dtype),
        jnp.full(ref.shape, vals[2], dtype),
    )


def gather(table, idx) -> Vec3:
    """table: [N,3] array; idx: [B] int -> Vec3 of [B]."""
    return Vec3(table[idx, 0], table[idx, 1], table[idx, 2])


def onb_from_w(n: Vec3):
    """Reference ONB construction (onb.h:4-14), SoA."""
    w = unit(n)
    pick = jnp.abs(w.x) > 0.9
    ax = jnp.where(pick, 0.0, 1.0)
    ay = jnp.where(pick, 1.0, 0.0)
    a = Vec3(ax, ay, jnp.zeros_like(ax))
    v = unit(cross(w, a))
    u = cross(w, v)
    return u, v, w


def onb_transform(u: Vec3, v: Vec3, w: Vec3, lx, ly, lz) -> Vec3:
    return Vec3(
        lx * u.x + ly * v.x + lz * w.x,
        lx * u.y + ly * v.y + lz * w.y,
        lx * u.z + ly * v.z + lz * w.z,
    )
