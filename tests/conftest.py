"""Test environment: CPU backend with 8 virtual devices (distributed tests
without a cluster) and x64 enabled (oracle comparisons in f64).

The ``gpu`` tests run on the card with ``JAX_PLATFORMS=cuda``; elsewhere
they skip (each decides in a fixture, never at import time)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
