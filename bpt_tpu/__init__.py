"""bpt_tpu — a wavefront bidirectional path tracer in JAX.

A ground-up JAX/XLA/Pallas re-design with the full capability surface of the
C++ reference (teehee567/Bidirectional-Path-Tracer): triangle scenes, median
split BVH, unidirectional PT with next-event estimation, naive all-pairs BDPT,
YAML scene loading with OBJ import, stratified sampling, and gamma-2 PNG out.

The recursive pointer-chasing CPU design of the reference becomes:
  host scene compiler -> frozen SoA device arrays -> jit wavefront loop
  -> batched intersection / branchless BSDFs -> sharded accumulation.
"""

__version__ = "0.1.0"

from bpt_tpu.scene.types import SceneArrays, MaterialTable, CameraConfig  # noqa: F401
