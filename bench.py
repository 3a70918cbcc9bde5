"""Headline benchmark: particle-steps/s of the full per-step hot path.

Each timed step runs BOTH halves of the reference's inner loop
(timemanager.f90:531-712): the vectorized advance kernel (PBL Langevin +
free-troposphere + mesoscale + Petterssen corrector + BCs, stock-COMMAND
config: CTL<0 fixed step, ifine=1) AND the conccalc scatter-add into the
7-D output accumulator (conccalc.f90, sampled every sync step like the
stock loutsample=lsynctime), on ~10.5M particles on one chip.  REF1-like
setup (README_PARALLEL.md:108-118): global met grid, 0.5-deg 720x360
output grid.  Prints ONE JSON line naming the device it ran on; refuses
to run (exit non-zero) when JAX finds no GPU.

vs_baseline is measured against 1.0e6 particle-steps/s, an optimistic
single-node estimate for the Fortran reference (the repo publishes no
absolute throughput — README_PARALLEL.md only gives MPI speedups; typical
published FLEXPART figures are O(1e5-1e6) particle-steps/s/core and the
reference is getfields-bound at 70% CPU already at 1M particles,
README_PARALLEL.md:134-137).
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

FORTRAN_BASELINE_PSTEPS_PER_S = 1.0e6
N_PARTICLES = 10 * 2 ** 20          # ~10.5M (chunked advance)
N_STEPS = 10


def device_info() -> dict:
    """The device every result is measured on; no CPU fallback."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"bench: no GPU found (JAX platform "
                         f"'{d.platform}'); timings are taken on a GPU only")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main():
    from flexpart_tpu.config import OutGrid
    from flexpart_tpu.core import StepConfig, StepParams, advance_chunked
    from flexpart_tpu.core.state import empty_particles
    from flexpart_tpu.grid.conccalc import (ConcConfig, kernel_possible_at,
                                            make_conccalc)
    from flexpart_tpu.grid.outgrid import (OutputGridGeometry,
                                           zero_accumulators)
    from flexpart_tpu.met import (calcpar, compute_heights, make_grid,
                                  process_eta, uniform_wind_met)

    from flexpart_tpu.utils.compile_cache import enable_compile_cache

    device = device_info()
    enable_compile_cache()
    # global-scale met grid (reference REF1: 360x720 global grid)
    grid = make_grid(nx=361, ny=181, nlev=30, dx=1.0, dy=1.0,
                     xlon0=-180.0, ylat0=-90.0, xglobal=True)
    met = uniform_wind_met(grid, u=10.0, v=1.0)
    eta = met.fetch(0.0)
    height = compute_heights(grid, eta)
    z0 = process_eta(grid, eta, height)
    z0 = calcpar(grid, eta, z0)

    n = N_PARTICLES
    key = jax.random.PRNGKey(0)
    kx, ky, kz = jax.random.split(key, 3)
    p = empty_particles(n)
    p = p._replace(
        x_hi=jax.random.uniform(kx, (n,), minval=30.0, maxval=330.0),
        y_hi=jax.random.uniform(ky, (n,), minval=30.0, maxval=150.0),
        z=jax.random.uniform(kz, (n,), minval=10.0, maxval=8000.0),
        active=jnp.ones(n, bool), itra=jnp.zeros(n, jnp.int32),
        mass=jnp.full((n, 1), 1.0 / n),
    )

    cfg = StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                     xglobal=True, ldirect=1, turbswitch=False, ifine=1,
                     method=0)
    prm = StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                          dxconst=grid.dxconst, dyconst=grid.dyconst,
                          lsynctime=900, fine=1.0)

    # REF1 output grid: global 0.5 deg, 3 layers
    og = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=720,
                 numygrid=360, dxout=0.5, dyout=0.5,
                 outheights=(100.0, 1000.0, 50000.0))
    geo = OutputGridGeometry(og, grid)
    ccfg = ConcConfig(nxg=geo.nxg, nyg=geo.nyg, nzg=geo.nzg,
                      npointspec=1, nclassunc=1, nage=1,
                      dxout=og.dxout, dyout=og.dyout,
                      xoutshift=geo.xoutshift, youtshift=geo.youtshift,
                      dx_met=grid.dx, dy_met=grid.dy, ind_samp=0)
    conccalc = make_conccalc(og.outheights)
    acc = zero_accumulators(geo, 1, 1, 1, 1)
    lage = jnp.asarray(np.asarray([999999999], np.int32))

    n_chunks = max(1, n // (2 ** 19))

    def step(p, acc, itime, k, it_host):
        newp, diag = advance_chunked(p, z0, z0, itime, jnp.int32(0),
                                     jnp.int32(86400), k, cfg, prm, n_chunks)
        # same host-side rule the production scheduler applies
        # (Simulation._ccfg_at): single-index sampling until the plume
        # can be 3 h old, 4-point kernel after
        cc = ccfg._replace(
            kernel_possible=kernel_possible_at(it_host + 900, 0))
        acc = conccalc(acc, newp, z0, itime + 900, lage,
                       jnp.float32(1.0), cc)
        return newp, acc, diag

    # warmup/compile
    p1, acc1, diag = step(p, acc, jnp.int32(0), jax.random.PRNGKey(1), 0)
    jax.block_until_ready((p1, acc1))

    t0 = time.perf_counter()
    pc = p
    for i in range(N_STEPS):
        pc, acc, diag = step(pc, acc, jnp.int32(i * 900),
                             jax.random.fold_in(jax.random.PRNGKey(2), i),
                             i * 900)
    jax.block_until_ready((pc, acc))
    dt = time.perf_counter() - t0

    psteps = n * N_STEPS / dt
    print(json.dumps({
        "metric": "particle_steps_per_s_per_chip",
        "value": round(psteps, 1),
        "unit": "particle-steps/s",
        "vs_baseline": round(psteps / FORTRAN_BASELINE_PSTEPS_PER_S, 2),
        "device": device,
    }))


if __name__ == "__main__":
    main()
