"""swift_subtask_dev_tpu_torch — the PyTorch/CUDA port of swift_subtask_dev_tpu.

The JAX package beside this one is the reference; this package runs its
main path (one-species SPHENIX SPH + P3M self-gravity on the flat column
grid) with plain PyTorch around one hand-written CUDA pair kernel
(``csrc/pair_flat.cu``).  It imports torch and numpy, never jax, and no
module of the JAX package.

Subpackages mirror the reference layout:

- ``utils``  : the integer timeline (host-side, numpy).
- ``grid``   : the column grid and z-sorted bucketing.
- ``models`` : SPHENIX SPH, the ideal-gas EOS, the P3M gravity solver.
- ``ops``    : the flat pair engine (kernel + plain version), the SPH and
  P2P loops on it, and the PM mesh.
- ``engine`` : the host driver (timeline, KDK step, split mesh step).
"""
