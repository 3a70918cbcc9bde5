"""Labeled benchmark suite: one JSON line per config, same schema as
bench.py, each naming the device.  `python bench_suite.py [names...]`.
All configs run in one process (one process per card) and share JAX's
persistent compilation cache.

Configs:
  hotpath_stock    — bench.py's headline: fixed-step stock COMMAND
                     (CTL<0, ifine=1) advance + conccalc at ~10.5M.
  hotpath_physics  — the VALIDATED physics-heavy config the matched
                     suite pins: CTL=5 adaptive, ifine=4, turbswitch,
                     wet scavenging + dry deposition + decay mass
                     updates every step (timemanager.f90 full inner
                     loop), ~10.5M particles.
  e2e_simulation   — sustained Simulation.run() throughput with real
                     wind-field updates flowing through the prefetch
                     pipeline (the getfields axis the reference is
                     bound by, README_PARALLEL.md:134-137) at 1M
                     particles over 12 h.
  domainfill_100m  — BASELINE config 4 scale probe: 100M-particle
                     global domain-fill (column-mass-proportional fill
                     drawn on device) advancing on one chip, with HBM
                     headroom reported.

vs_baseline for the hotpath rows divides by the same 1.0e6 psteps/s
single-core Fortran estimate bench.py documents; e2e and domainfill
rows report vs_baseline against that same estimate for comparability.
"""
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

FORTRAN_BASELINE = 1.0e6


def _emit(name, psteps, extra=None):
    import bench
    row = {"metric": name, "value": round(psteps, 1),
           "unit": "particle-steps/s",
           "vs_baseline": round(psteps / FORTRAN_BASELINE, 2),
           "device": bench.device_info()}
    if extra:
        row.update(extra)
    print(json.dumps(row), flush=True)


def _ref1_met():
    from flexpart_tpu.met import (calcpar, compute_heights, make_grid,
                                  process_eta)
    from flexpart_tpu.met.synthetic import SyntheticMet
    grid = make_grid(nx=361, ny=181, nlev=30, dx=1.0, dy=1.0,
                     xlon0=-180.0, ylat0=-90.0, xglobal=True)
    met = SyntheticMet(grid)
    eta = met.fetch(0.0)
    height = compute_heights(grid, eta)
    z0 = calcpar(grid, eta, process_eta(grid, eta, height))
    eta1 = met.fetch(10800.0)
    z1 = calcpar(grid, eta1, process_eta(grid, eta1, height))
    return grid, z0, z1


def hotpath_stock():
    import bench
    bench.main()


def hotpath_physics():
    """CTL=5/ifine=4/turbswitch + wet+dry deposition + decay — the
    configuration the 48-h matched validation runs."""
    from flexpart_tpu.core import StepConfig, StepParams, advance_chunked
    from flexpart_tpu.core.state import empty_particles
    from flexpart_tpu.physics import MassSpecies, WetSpecies, apply_wetdepo
    from flexpart_tpu.physics.massupdate import apply_decay_drydep
    from flexpart_tpu.physics.wetdepo import wetscav_all

    grid, z0, z1 = _ref1_met()
    # 4.2M particles, sized for a 16-GiB device (the adaptive
    # while-loop's buffers + the wet-scavenging working set)
    n = 4 * 2 ** 20
    key = jax.random.PRNGKey(0)
    kx, ky, kz = jax.random.split(key, 3)
    p = empty_particles(n)
    p = p._replace(
        x_hi=jax.random.uniform(kx, (n,), minval=30.0, maxval=330.0),
        y_hi=jax.random.uniform(ky, (n,), minval=30.0, maxval=150.0),
        z=jax.random.uniform(kz, (n,), minval=10.0, maxval=3000.0),
        active=jnp.ones(n, bool), itra=jnp.zeros(n, jnp.int32),
        mass=jnp.full((n, 1), 1.0 / n), mass0=jnp.full((n, 1), 1.0 / n))
    cfg = StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=True,
                     ldirect=1, turbswitch=True, ifine=4, method=1)
    prm = StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                          dxconst=grid.dxconst, dyconst=grid.dyconst,
                          lsynctime=900, fine=0.25, ctl=5.0,
                          lwindinterv=10800)
    wsp = (WetSpecies(wetdep=True, is_aerosol=True, weta_gas=-9.9e-10,
                      wetb_gas=-9.9, crain_aero=1.0, csnow_aero=1.0,
                      ccn_aero=0.9, in_aero=0.1, henry=-9.9e-10,
                      dquer=0.4),)
    msp = MassSpecies(decay=(2.6e-6,), drydep=(True,), minmass=1e-10)
    vdep = jnp.full((1, grid.ny, grid.nx), 0.008, jnp.float32)
    n_chunks = max(1, n // (2 ** 19))

    def step(p, i):
        itime = jnp.int32(i * 900)
        lam, grf = wetscav_all(p, z0, itime, jnp.int32(900), wsp, False)
        p, _ = apply_wetdepo(p, lam, grf, jnp.int32(900), jnp.int32(0),
                             msp)
        p, diag = advance_chunked(p, z0, z1, itime, jnp.int32(0),
                                  jnp.int32(10800),
                                  jax.random.fold_in(key, i), cfg, prm,
                                  n_chunks)
        p, _ = apply_decay_drydep(p, vdep, jnp.int32(900), jnp.int32(0),
                                  msp, has_vdep=True,
                                  t_below=diag.t_below)
        return p

    p1 = step(p, 0)
    jax.block_until_ready(p1)
    nsteps = 5
    t0 = time.perf_counter()
    pc = p
    for i in range(nsteps):
        pc = step(pc, i)
    jax.block_until_ready(pc)
    dt = time.perf_counter() - t0
    _emit("particle_steps_per_s_physics_heavy", n * nsteps / dt)


def e2e_simulation():
    """Sustained Simulation.run() with wind updates through the
    prefetch pipeline on the REF1-scale grid."""
    import tempfile

    from flexpart_tpu.config import (Command, OutGrid, ReleaseBox,
                                     Releases, Species)
    from flexpart_tpu.met import SyntheticMet, make_grid
    from flexpart_tpu.run.simulation import Simulation

    grid = make_grid(nx=361, ny=181, nlev=30, dx=1.0, dy=1.0,
                     xlon0=-180.0, ylat0=-90.0)
    n = 4 * 2 ** 20      # 4.2M: advance-bound regime (at ~1M the run is
    #                      reader-bound like the reference's 1M-particle
    #                      row, README_PARALLEL.md:134-137)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101,
                  ietime=120000, lsynctime=900, loutstep=10800,
                  loutaver=10800, loutsample=900, lconvection=0)
    box = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                     itime2=0, lon1=-120.0, lon2=60.0, lat1=-50.0,
                     lat2=50.0, z1=50.0, z2=3000.0, mass=(1.0,), parts=n)
    og = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=720,
                 numygrid=360, dxout=0.5, dyout=0.5,
                 outheights=(100.0, 1000.0, 50000.0))
    import dataclasses as _dc

    def build(outdir, ietime):
        return Simulation(cmd=_dc.replace(cmd, ietime=ietime),
                          releases=Releases(species=(Species(),),
                                            boxes=(box,)),
                          grid=grid, met_backend=SyntheticMet(grid),
                          outgrid=og, outdir=outdir,
                          wind_interval=3600, write_netcdf=False,
                          write_npz=False)

    # warmup run with identical shapes: the one-time XLA compiles of
    # the met pipeline and the advance kernel land here and are cached
    # in-process, so the measured run reports STEADY-STATE end-to-end
    # throughput (startup compile is amortized over multi-day runs)
    with tempfile.TemporaryDirectory(prefix="bench_e2e_") as d:
        build(f"{d}/warm", 20000).run()
        sim = build(f"{d}/out", 120000)
        sim.run()
    psteps = sim.timings["particle_steps"] / sim.timings["wall"]
    _emit("particle_steps_per_s_e2e_simulation", psteps, extra={
        "wall_s": round(sim.timings["wall"], 1),
        "sections": {k: round(v, 1) for k, v in sim.timings.items()
                     if isinstance(v, float)},
        "prefetch_failures": sim._prefetch_failures})


def domainfill_100m():
    """100M-particle global domain-fill on one chip: column-mass
    categorical fill drawn ON DEVICE (the deterministic host fill of
    core/domainfill.py is validated separately at smaller N; the
    device draw keeps the 8-GB particle state off the host path),
    fixed-step advance, HBM headroom from device memory_stats."""
    from flexpart_tpu.core import StepConfig, StepParams, advance_chunked
    from flexpart_tpu.core.state import empty_particles
    from flexpart_tpu.met.fields import F3_RHO, F3_TT
    from flexpart_tpu.constants import GA, R_AIR

    import os
    grid, z0, z1 = _ref1_met()
    n = int(os.environ.get("FLEX_DOMAINFILL_N", 100_000_000))
    key = jax.random.PRNGKey(1)

    # column mass (init_domainfill.f90:92-98) -> categorical column draw
    pp = z0.f3d[F3_RHO] * R_AIR * z0.f3d[F3_TT]
    lat = (jnp.arange(grid.ny) * grid.dy + grid.ylat0)
    area = jnp.cos(jnp.deg2rad(lat))
    colmass = (pp[0] - pp[-1]) / GA * area[:, None]      # (ny, nx)
    colmass = colmass[:, : grid.nx - 1]
    logits = jnp.log(jnp.maximum(colmass, 1e-30)).ravel()

    p = empty_particles(n)
    nf_chunk = 10_000_000            # (nz, chunk) profile gather < 1.2 GiB

    @jax.jit
    def fill_chunk(kc, kx, ky, ku):
        m = nf_chunk
        col = jax.random.categorical(kc, logits, shape=(m,))
        jy = (col // (grid.nx - 1)).astype(jnp.int32)
        ix = (col % (grid.nx - 1)).astype(jnp.int32)
        x = ix.astype(jnp.float32) + jax.random.uniform(kx, (m,))
        y = jnp.clip(jy.astype(jnp.float32) - 0.5
                     + jax.random.uniform(ky, (m,)), 0.0,
                     grid.ny - 1 - 1e-4)
        # uniform-in-pressure z via the column profile
        u = jax.random.uniform(ku, (m,))
        pp1 = pp[0, jy, ix]
        ppn = pp[-1, jy, ix]
        pnew = pp1 - u * (pp1 - ppn)
        prof = pp[:, jy, ix]                              # (nz, m)
        kz = jnp.clip(jnp.sum((prof >= pnew[None]).astype(jnp.int32),
                              axis=0) - 1, 0, grid.nlev - 2)
        dz1 = prof[kz, jnp.arange(m)] - pnew
        dz2 = pnew - prof[kz + 1, jnp.arange(m)]
        dz = 1.0 / jnp.maximum(dz1 + dz2, 1e-10)
        z = (z0.height[kz] * dz2 + z0.height[kz + 1] * dz1) * dz
        return x, y, jnp.minimum(z, z0.height[-1] - 0.5)

    xs, ys, zs = [], [], []
    for c in range(n // nf_chunk):
        kc, kx, ky, ku = jax.random.split(jax.random.fold_in(key, c), 4)
        xc, yc, zc = fill_chunk(kc, kx, ky, ku)
        xs.append(xc)
        ys.append(yc)
        zs.append(zc)
    x = jnp.concatenate(xs)
    y = jnp.concatenate(ys)
    z = jnp.concatenate(zs)
    p = p._replace(x_hi=x, y_hi=y, z=z, active=jnp.ones(n, bool),
                   itra=jnp.zeros(n, jnp.int32),
                   mass=jnp.full((n, 1), 5.1e18 / n))
    jax.block_until_ready(p)

    cfg = StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=True,
                     ldirect=1, turbswitch=False, ifine=1, method=0)
    prm = StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                          dxconst=grid.dxconst, dyconst=grid.dyconst,
                          lsynctime=900, fine=1.0)
    n_chunks = max(1, n // 1_000_000)   # 1M-particle chunks divide n

    import functools
    from flexpart_tpu.core import advance_all
    from flexpart_tpu.core.interp import build_step_tables_quad
    from jax import lax

    b = n // n_chunks
    tw0 = tw1 = None   # fixed met: time weights fold into the tables

    tables = build_step_tables_quad(
        z0, z1, jnp.float32(1.0), jnp.float32(0.0),
        jnp.float32(1.0), jnp.float32(0.0), dtype=jnp.bfloat16)

    # Per-chunk jit with the FULL state donated: XLA aliases the 8.8-GB
    # buffers in place and the compiled program stays chunk-sized.  Met
    # fields/tables are explicit arguments, not closed-over constants
    # embedded in the program.
    @functools.partial(jax.jit, donate_argnums=(0,))
    def chunk_step(p, zA, zB, tb, c, i):
        sl = lambda a: lax.dynamic_slice_in_dim(a, c * b, b, 0)
        pc = jax.tree.map(sl, p)
        newc, _ = advance_all(pc, zA, zB, jnp.int32(0), jnp.int32(0),
                              jnp.int32(10800),
                              jax.random.fold_in(jax.random.fold_in(key, i), c),
                              cfg, prm, tables=tb)
        wr = lambda a, u: lax.dynamic_update_slice_in_dim(a, u, c * b, 0)
        return jax.tree.map(wr, p, newc)

    def step(p, i):
        for c in range(n_chunks):
            p = chunk_step(p, z0, z1, tables, jnp.int32(c),
                           jnp.int32(i))
        return p

    p1 = step(p, 0)
    jax.block_until_ready(p1)
    stats = jax.local_devices()[0].memory_stats() or {}
    hbm_used = stats.get("bytes_in_use", 0) / 2 ** 30
    hbm_cap = stats.get("bytes_limit", 0) / 2 ** 30
    nsteps = 3
    t0 = time.perf_counter()
    pc = p
    for i in range(nsteps):
        pc = step(pc, i)
    jax.block_until_ready(pc)
    dt = time.perf_counter() - t0
    _emit("particle_steps_per_s_domainfill_100m", n * nsteps / dt,
          extra={"n_particles": n,
                 "hbm_used_gib": round(hbm_used, 2),
                 "hbm_limit_gib": round(hbm_cap, 2)})


ALL = {
    "hotpath_stock": hotpath_stock,
    "hotpath_physics": hotpath_physics,
    "e2e_simulation": e2e_simulation,
    "domainfill_100m": domainfill_100m,
}

if __name__ == "__main__":
    from flexpart_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    names = sys.argv[1:] or list(ALL)
    for nm in names:
        ALL[nm]()
