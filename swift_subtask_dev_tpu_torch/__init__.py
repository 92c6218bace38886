"""swift_subtask_dev_tpu_torch — the PyTorch/CUDA port of swift_subtask_dev_tpu.

The JAX package beside this one is the reference; this package runs its
main path (one-species SPHENIX SPH + P3M self-gravity on the flat column
grid) and the Sedov blast with hierarchical time-steps with plain PyTorch
around hand-written CUDA kernels (``csrc/``: the flat, packed and
ring-buffer pair kernels and the FP32 probe).  It imports torch and numpy,
never jax, and no module of the JAX package.

Subpackages mirror the reference layout:

- ``utils``  : the integer timeline (host-side, numpy).
- ``grid``   : the column and 27-cell grids and their bucketing.
- ``models`` : SPHENIX SPH, the ideal-gas EOS, the P3M gravity solver.
- ``ops``    : the pair engines (kernel + plain version each), the SPH,
  P2P and limiter loops on them, and the PM mesh.
- ``engine`` : the host driver (timeline, KDK step, split mesh step).
- ``examples``: the Sedov blast.
- ``probes`` : the FP32 throughput probe and the flat kernel's cost probe.
"""
