"""Batched 3-vector algebra on ``[..., 3]`` arrays.

Batched equivalent of the reference's scalar ``vec3`` class
(reference: src/core/vec3.h:1-161).  Every op is a pure jnp function over
stacked arrays; rejection-sampling loops in the
reference become analytic (polar) sampling in :mod:`bpt_tpu.core.sampling`.
"""

from __future__ import annotations

import jax.numpy as jnp

PI = 3.1415926535897932385  # reference: src/main.h:20
INFINITY = float("inf")


def dot(u, v):
    """Batched dot product over the trailing axis (src/core/vec3.h:97-101)."""
    return jnp.sum(u * v, axis=-1)


def cross(u, v):
    """Batched cross product (src/core/vec3.h:103-107)."""
    return jnp.cross(u, v)


def length_squared(v):
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_squared(v))


def unit_vector(v):
    """v / |v| (src/core/vec3.h:109-111). No epsilon — faithful to reference."""
    return v / length(v)[..., None]


def normalize_safe(v, eps=1e-20):
    """Division-safe normalize for lanes that may hold dead rays."""
    n2 = length_squared(v)
    inv = jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, eps)), 0.0)
    return v * inv[..., None]


def near_zero(v, s=1e-8):
    """True when all components are tiny (src/core/vec3.h:48-52)."""
    return jnp.all(jnp.abs(v) < s, axis=-1)


def reflect(v, n):
    """Mirror reflection v - 2(v.n)n (src/core/vec3.h:138-140)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction of a *unit* vector (src/core/vec3.h:142-147).

    ``etai_over_etat`` may be a batched scalar ``[...]``.
    """
    eta = jnp.asarray(etai_over_etat)[..., None]
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)[..., None]
    r_out_perp = eta * (uv + cos_theta * n)
    r_out_parallel = (
        -jnp.sqrt(jnp.abs(1.0 - length_squared(r_out_perp)))[..., None] * n
    )
    return r_out_perp + r_out_parallel


def schlick_reflectance(cosine, refraction_index):
    """Schlick's approximation (src/materials/material.h:125-130)."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def degrees_to_radians(deg):
    return deg * PI / 180.0


def vec(x, y, z, dtype=jnp.float32):
    return jnp.array([x, y, z], dtype=dtype)
