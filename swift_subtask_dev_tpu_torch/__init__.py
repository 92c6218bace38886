"""swift_subtask_dev_tpu_torch — the PyTorch/CUDA port of swift_subtask_dev_tpu.

The JAX package beside this one is the reference; this package runs its
main path (one-species SPHENIX SPH + P3M self-gravity on the flat column
grid), the Sedov blast with hierarchical time-steps and the cosmological
volumes (gas + dark matter; gas + dark matter + stars with the EAGLE
subgrid models) with plain PyTorch around hand-written CUDA kernels
(``csrc/``: the flat, packed and ring-buffer pair kernels and the FP32
probe).  It imports torch and numpy,
never jax, and no module of the JAX package.

Subpackages mirror the reference layout:

- ``utils``  : the integer timeline, units, constants, parameter
  lookups and the counter RNG.
- ``grid``   : the column and 27-cell grids and their bucketing.
- ``models`` : SPHENIX SPH, the ideal-gas EOS, the P3M gravity solver,
  cosmology.
- ``subgrid``: cooling, the entropy floor, chemistry, star formation,
  feedback and enrichment.
- ``ops``    : the pair engines (kernel + plain version each), the SPH,
  P2P, limiter and chemistry loops on them, the star loops, the stars'
  ghost and the PM mesh.
- ``engine`` : the host driver (timeline, KDK step, split mesh step);
  ``engine_multi``: the multi-species engine.
- ``examples``: the Sedov blast, the SmallCosmoVolume, the EAGLE volume.
- ``probes`` : the FP32 throughput probe and the flat kernel's cost probe.
"""
