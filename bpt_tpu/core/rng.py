"""Threefry key discipline.

The reference has a *shared, unsynchronized* ``static std::mt19937``
(src/main.h:28-32) — a data race under its thread pool, making its renders
non-reproducible.  Here every random draw derives from
``fold_in(render_key, bounce)`` + the absolute ray id, so an image is
bit-identical across runs, chunk sizes, and device-mesh shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def ray_keys(key: jax.Array, ray_ids: jax.Array) -> jax.Array:
    """Derive one key per absolute ray id. ray_ids: int32 [N] -> keys [N]."""
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(ray_ids)


def wave_uniforms(key: jax.Array, ray_ids: jax.Array, bounce, n: int, dtype=jnp.float32):
    """[N, n] uniforms in [0,1) for one wavefront step.

    Deterministic in (key, bounce, absolute ray id) — independent of how rays
    are chunked or sharded across devices.
    """
    kb = jax.random.fold_in(key, bounce)
    keys = ray_keys(kb, ray_ids)
    return jax.vmap(lambda k: jax.random.uniform(k, (n,), dtype=dtype))(keys)


def uniform_rows(key: jax.Array, ray_ids: jax.Array, bounce, n: int, dtype=jnp.float32):
    """Same stream as wave_uniforms, but returned as n separate [B] rows —
    the layout of the SoA hot path, where every per-ray quantity is a flat
    [B] array.  The transpose happens once per wave on a tiny array."""
    u = wave_uniforms(key, ray_ids, bounce, n, dtype=dtype)  # [B, n]
    ut = u.T  # [n, B]
    return [ut[i] for i in range(n)]
