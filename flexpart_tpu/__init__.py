"""flexpart_tpu — a JAX Lagrangian particle dispersion framework.

A from-scratch JAX/XLA re-design with the capabilities of the
reference FLEXPART (MeteoSwiss/flexpart, Fortran+MPI): stochastic
trajectories of air-parcel particles through gridded NWP wind fields with
boundary-layer turbulence, convection, deposition, decay and chemistry,
accumulated onto output grids — forward or backward in time.

Design (vs. the reference architecture, see SURVEY.md):
  * particle state = fixed-capacity SoA arrays in a JAX pytree, alive-masked;
  * the whole per-lsynctime update is ONE jitted, vectorized kernel
    (the reference's per-particle `advance` loop, timemanager.f90:531-712);
  * counter-based `jax.random` RNG keyed on (seed, step, slot);
  * met fields live on device as stacked arrays, double-buffered in time;
  * multi-chip = particles sharded over a `jax.sharding.Mesh`, grids reduced
    with `psum` (replaces mpi_mod.f90).
"""

__version__ = "0.1.0"
