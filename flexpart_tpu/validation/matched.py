"""Matched-RNG validation: the advance kernel vs the scalar oracle.

The oracle (validation.oracle) is a line-by-line host-side transcription
of the reference's advance.f90 + initialize.f90 (no Fortran toolchain is
assumed, so the oracle is the executable form of the reference's
arithmetic).  Both sides consume the SAME rannumb gaussian table
(random_mod.f90:93-139 ported exactly in validation.legacy_rng) with the
SAME per-particle `nrand` index chase in reference consumption order, so
every random draw is bitwise identical; any drift between kernel and
oracle is a physics/arithmetic discrepancy, not stochastic spread.

Each `case_*` function runs one branch of the matrix (turbulence on/off,
ifine substeps, settling, adaptive stepping, met-buffer swaps, skewed
CBL with the NaN-reinit retry) on both sides and returns a
`MatchedRun`; `compare` checks it at the case's tolerance and returns
the largest deviation.  The pytest suite and the on-device smoke test
share these, so both hold the kernel to the same criterion.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import StepConfig, StepParams, advance_all
from ..core.advance import LegacyRnd
from ..core.state import empty_particles
from ..met import calcpar, compute_heights, make_grid, process_eta
from ..met.synthetic import SyntheticMet
from .legacy_rng import MAXRAND, NrandStream, make_rannumb
from .oracle import OracleParams, _Interp, run_oracle

SEED = -7
LSYNC = 900
MEMTIME = (0, 10800)
# per-step position tolerances: grid units in x/y, metres in z
ATOL_XY, ATOL_Z = 5e-3, 2.0
# adaptive stepping and wind-interval swaps run many more f32 operations
ATOL_XY_LONG, ATOL_Z_LONG = 2e-2, 5.0


class NpZ:
    """Numpy view of a ZFields for the scalar oracle."""

    def __init__(self, zf):
        self.f3d = np.asarray(zf.f3d)
        self.f2d = np.asarray(zf.f2d)
        self.height = np.asarray(zf.height)


class MatchedRun(NamedTuple):
    pk: object             # kernel particles after the last step
    traj_k: list           # per-step (N, 3) kernel positions (f64)
    states: list           # oracle particle states after the last step
    nstops: list           # oracle termination flags
    trace_o: list          # per-step (N, 3) oracle positions (f64)
    atol_xy: float
    atol_z: float


def met_setup():
    """(grid, z0, z1, height): a limited-area synthetic grid and its two
    processed time levels at MEMTIME."""
    grid = make_grid(nx=61, ny=31, nlev=20, dx=1.0, dy=1.0,
                     xlon0=0.0, ylat0=10.0, xglobal=False)
    met = SyntheticMet(grid)
    height = compute_heights(grid, met.fetch(0.0))
    zs = []
    for t in (0.0, float(MEMTIME[1])):
        eta = met.fetch(t)
        z = process_eta(grid, eta, height)
        z = calcpar(grid, eta, z)
        zs.append(z)
    return grid, zs[0], zs[1], height


def start_positions(n):
    """Positions spread over the domain; z spans PBL / troposphere /
    tropopause transition / stratosphere, away from branch boundaries."""
    rs = np.random.RandomState(42)
    x = rs.uniform(8.0, 50.0, n)
    y = rs.uniform(5.0, 25.0, n)
    z = np.concatenate([
        rs.uniform(20.0, 400.0, n - 3 * (n // 4)),     # PBL-ish
        rs.uniform(3000.0, 7000.0, n // 4),            # troposphere
        rs.uniform(11300.0, 11700.0, n // 4),          # transition band
        rs.uniform(16000.0, 19000.0, n // 4),          # stratosphere
    ])
    return x, y, z


def run_kernel_legacy(grid, z0, z1, x, y, z, nsteps, cfg, prm,
                      seed=SEED, memtime=MEMTIME, itime0=0, stream=None,
                      p=None, first=True, cbl_probe=None):
    """Drive advance_all in legacy-RNG mode, drawing the per-particle
    nrand bases host-side in the reference's consumption order
    (timemanager.f90:553-611: per particle, initialize-then-advance at
    the release step, advance only afterwards).  Pass stream/p back in
    to continue across wind intervals.

    cbl_probe: OracleParams for cblflag runs — the harness then mirrors
    initialize_cbl_vel.f90's dcas/dcas1 chain draws for fresh particles
    in strongly convective PBL columns (the branch condition is probed
    host-side with the oracle's interpolator on the same met)."""
    n = len(x)
    if p is None:
        p = empty_particles(n, nspec=cfg.nspec)
        p = p._replace(x_hi=jnp.asarray(x, jnp.float32),
                       y_hi=jnp.asarray(y, jnp.float32),
                       z=jnp.asarray(z, jnp.float32),
                       itra=jnp.zeros(n, jnp.int32),
                       itramem=jnp.full(n, -1, jnp.int32),
                       mass=jnp.ones((n, cfg.nspec), jnp.float32),
                       active=jnp.ones(n, bool))
    table = jnp.asarray(make_rannumb(MAXRAND, seed))
    if stream is None:
        stream = NrandStream(seed, MAXRAND)
    key = jax.random.PRNGKey(0)          # unused in legacy mode
    traj = []
    for kk in range(nsteps):
        k = kk if first else kk + 1      # k==0 gates the init draws
        itime = itime0 + kk * LSYNC
        active = np.asarray(p.active)
        ni = np.ones(n, np.int64)
        na = np.ones(n, np.int64)
        dcas = np.zeros(n, np.float32)
        dcas1 = np.zeros(n, np.float32)
        if cbl_probe is not None and k == 0:
            itp0 = _Interp(cbl_probe, NpZ(z0), NpZ(z1), itime0, memtime)
        xs, ys, zs = (np.asarray(p.x_hi, np.float64),
                      np.asarray(p.y_hi, np.float64),
                      np.asarray(p.z, np.float64))
        for j in range(n):
            if not active[j]:
                continue                  # terminated: consumes nothing
            if k == 0:
                ni[j] = stream.next_nrand()
                if cbl_probe is not None:
                    # initialize.f90:142-149 chain consumption mirror
                    ix, jy, ixp, jyp, _, _, _ = itp0.corners(xs[j], ys[j])
                    h = max(itp0.hmix_max(ix, jy, ixp, jyp), 1.0)
                    if zs[j] / h <= 1.0:
                        _, _, ol, _, _, _, _ = itp0.profiles(
                            xs[j], ys[j], np.float32(zs[j]))
                        if -h / ol > 5.0:
                            dcas[j] = stream.uniform()
                            dcas1[j] = stream.gasdev()
            na[j] = stream.next_nrand()
        leg = LegacyRnd(table=table,
                        nrand_init=jnp.asarray(ni, jnp.int32),
                        nrand=jnp.asarray(na, jnp.int32),
                        cbl_dcas=(jnp.asarray(dcas)
                                  if cbl_probe is not None else None),
                        cbl_dcas1=(jnp.asarray(dcas1)
                                   if cbl_probe is not None else None))
        p, diag = advance_all(p, z0, z1, jnp.int32(itime),
                              jnp.int32(memtime[0]), jnp.int32(memtime[1]),
                              key, cfg, prm, leg=leg)
        traj.append(np.stack([
            np.float64(p.x_hi) + np.float64(p.x_lo),
            np.float64(p.y_hi) + np.float64(p.y_lo),
            np.float64(p.z)], 1))
    return p, traj


def run_oracle_positions(z0, z1, x, y, z, nsteps, oprm, seed=SEED):
    parts = [dict(xt=np.float64(x[j]), yt=np.float64(y[j]),
                  zt=np.float32(z[j])) for j in range(len(x))]
    states, nstops, trace = run_oracle(
        oprm, NpZ(z0), NpZ(z1), MEMTIME, parts, nsteps,
        itime0=0, seed=seed)
    return states, nstops, [np.asarray(t, np.float64) for t in trace]


def params(grid, turbswitch, ifine, settling=False, method=0, ctl=-5.0,
           **sp):
    """(StepConfig, StepParams, OracleParams) for one matched case."""
    cfg = StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                     xglobal=grid.xglobal, ldirect=1,
                     turbswitch=turbswitch, ifine=ifine, method=method,
                     settling=settling)
    prm = StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                          dxconst=grid.dxconst, dyconst=grid.dyconst,
                          lsynctime=LSYNC, fine=1.0 / ifine, ctl=ctl,
                          lwindinterv=abs(MEMTIME[1] - MEMTIME[0]), **sp)
    oprm = OracleParams(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                        xglobal=grid.xglobal, ldirect=1,
                        turbswitch=turbswitch, ifine=ifine,
                        lsynctime=LSYNC, method=method, ctl=ctl,
                        lwindinterv=abs(MEMTIME[1] - MEMTIME[0]),
                        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                        dxconst=float(grid.dxconst),
                        dyconst=float(grid.dyconst),
                        settling=settling,
                        sp_density=sp.get("sp_density", -1.0),
                        sp_dquer=sp.get("sp_dquer", 0.0),
                        sp_cunningham=sp.get("sp_cunningham", 0.0),
                        sp_vsetaver=sp.get("sp_vsetaver", 0.0))
    return cfg, prm, oprm


def max_deviation(traj_k, trace_o, nstops):
    """Largest |kernel - oracle| over all steps of the live particles:
    (x, y) in grid units, z in metres."""
    alive = np.asarray(nstops) == 0
    d = np.zeros(3)
    for ok, oo in zip(traj_k, trace_o):
        d = np.maximum(d, np.abs(ok[alive] - oo[alive]).max(axis=0))
    return float(d[0]), float(d[1]), float(d[2])


def compare(run: MatchedRun):
    """Per-step position comparison at the run's tolerance; terminated
    particles are compared up to their last live step only.  Returns
    the largest deviation (x, y, z)."""
    alive = np.asarray(run.nstops) == 0
    for k, (ok, oo) in enumerate(zip(run.traj_k, run.trace_o)):
        np.testing.assert_allclose(ok[alive, 0], oo[alive, 0],
                                   atol=run.atol_xy, rtol=0,
                                   err_msg=f"x step {k}")
        np.testing.assert_allclose(ok[alive, 1], oo[alive, 1],
                                   atol=run.atol_xy, rtol=0,
                                   err_msg=f"y step {k}")
        np.testing.assert_allclose(ok[alive, 2], oo[alive, 2],
                                   atol=run.atol_z, rtol=1e-4,
                                   err_msg=f"z step {k}")
    return max_deviation(run.traj_k, run.trace_o, run.nstops)


def _case(setup, cfg, prm, oprm, x, y, z, nsteps, atol_xy=ATOL_XY,
          atol_z=ATOL_Z, cbl=False):
    grid, z0, z1, _ = setup
    pk, traj_k = run_kernel_legacy(grid, z0, z1, x, y, z, nsteps, cfg,
                                   prm, cbl_probe=oprm if cbl else None)
    states, nstops, trace_o = run_oracle_positions(z0, z1, x, y, z,
                                                   nsteps, oprm)
    return MatchedRun(pk, traj_k, states, nstops, trace_o, atol_xy,
                      atol_z)


def case_positions(setup, turbswitch, ifine):
    """Fixed-step PBL/FT/stratosphere advance, 4 sync steps."""
    cfg, prm, oprm = params(setup[0], turbswitch, ifine)
    x, y, z = start_positions(28)
    return _case(setup, cfg, prm, oprm, x, y, z, 4)


def case_settling(setup):
    """Heavy-aerosol settling active (get_settling.f90 iteration)."""
    sp = dict(sp_density=2500.0, sp_dquer=10.0, sp_cunningham=1.02,
              sp_vsetaver=-0.02)
    cfg, prm, oprm = params(setup[0], True, 1, settling=True, **sp)
    x, y, z = start_positions(20)
    z = np.clip(z, 50.0, 9000.0)     # keep away from the strat branches
    return _case(setup, cfg, prm, oprm, x, y, z, 4)


def case_adaptive(setup):
    """Adaptive per-particle time stepping (method=1, ctl=5, ifine=2 —
    the Chernobyl-style CTL>=0.1 configuration)."""
    cfg, prm, oprm = params(setup[0], True, 2, method=1, ctl=5.0)
    x, y, z = start_positions(24)
    return _case(setup, cfg, prm, oprm, x, y, z, 4, ATOL_XY_LONG,
                 ATOL_Z_LONG)


def case_concentrations(setup):
    """A 60-particle plume over 12 sync steps; returns the run and the
    relative L1 between kernel and oracle near-surface gridded counts
    (conccalc.f90's uniform-kernel nearest-cell rule for young plumes)."""
    grid = setup[0]
    cfg, prm, oprm = params(grid, True, 1)
    n = 60
    rs = np.random.RandomState(7)
    x = rs.uniform(20.0, 30.0, n)
    y = rs.uniform(12.0, 18.0, n)
    z = rs.uniform(20.0, 600.0, n)
    run = _case(setup, cfg, prm, oprm, x, y, z, 12)

    def gridded(traj):
        acc = np.zeros((grid.ny, grid.nx))
        for step in traj:
            ix = np.clip(np.round(step[:, 0]).astype(int), 0, grid.nx - 1)
            iy = np.clip(np.round(step[:, 1]).astype(int), 0, grid.ny - 1)
            low = step[:, 2] < 3000.0
            np.add.at(acc, (iy[low], ix[low]), 1.0 / n)
        return acc

    ck = gridded(run.traj_k)
    co = gridded(run.trace_o)
    return run, float(np.abs(ck - co).sum() / max(co.sum(), 1e-12))


def case_wind_intervals(setup):
    """Two 3-h wind intervals (24 sync steps) across a getfields buffer
    swap: the ran3 chain, the turbulence memory and the interpolation
    time weights must all carry over (timemanager.f90:311-346)."""
    grid, z0, z1, _ = setup
    # third time level: reuse z0 (fields differ between z0/z1 so the
    # temporal interpolation is still exercised in both intervals)
    z2 = z0
    cfg, prm, oprm = params(grid, True, 1)
    n = 16
    x, y, z = start_positions(n)
    per = MEMTIME[1] // LSYNC            # steps per interval

    pk, traj1 = run_kernel_legacy(grid, z0, z1, x, y, z, per, cfg, prm)
    # rebuild the host stream state by replay, then continue interval 2
    stream_k = NrandStream(SEED, MAXRAND)
    for _ in range(2 * n + (per - 1) * n):   # init+advance, then advance
        stream_k.next_nrand()
    pk, traj2 = run_kernel_legacy(grid, z1, z2, x, y, z, per, cfg, prm,
                                  memtime=(MEMTIME[1], 2 * MEMTIME[1]),
                                  itime0=MEMTIME[1], stream=stream_k,
                                  p=pk, first=False)

    parts = [dict(xt=np.float64(x[j]), yt=np.float64(y[j]),
                  zt=np.float32(z[j])) for j in range(n)]
    stream_o = NrandStream(SEED, MAXRAND)
    states, nstops, trace1 = run_oracle(
        oprm, NpZ(z0), NpZ(z1), MEMTIME, parts, per, itime0=0,
        seed=SEED, stream=stream_o)
    states, nstops, trace2 = run_oracle(
        oprm, NpZ(z1), NpZ(z2), (MEMTIME[1], 2 * MEMTIME[1]), states,
        per, itime0=MEMTIME[1], seed=SEED, stream=stream_o,
        nstops=nstops, do_init=False)
    return MatchedRun(pk, traj1 + traj2, states, nstops,
                      [np.asarray(t, np.float64) for t in trace1 + trace2],
                      ATOL_XY_LONG, ATOL_Z_LONG)


def make_convective(zf, split_x=30):
    """Patch the 2-D diagnostics to a strong-CBL state: hmix=1500 m,
    wstar=1.8 m/s, L=-25 m (-h/L=60, skewed branch) east of x=split_x
    and L=-1200 m (-h/L=1.25, weak-Gaussian branch) west of it."""
    from ..met.fields import F2_HMIX, F2_OLI, F2_WSTAR
    f2 = np.array(np.asarray(zf.f2d))
    ny, nx = f2.shape[-2:]
    oli = np.full((ny, nx), 1.0 / -1200.0, np.float32)
    oli[:, split_x:] = 1.0 / -25.0
    f2[F2_HMIX] = 1500.0
    f2[F2_WSTAR] = 1.8
    f2[F2_OLI] = oli
    return zf._replace(f2d=jnp.asarray(f2))


def case_cbl(setup):
    """Skewed CBL scheme (CBLFLAG=1): masked bi-Gaussian drift +
    re_initialize retry loop + weak-zone Gaussian branch against the
    scalar cbl.f90/re_initialize_particle.f90 oracle."""
    grid, z0, z1, height = setup
    conv = (grid, make_convective(z0), make_convective(z1), height)
    # ifine=8 -> dtf=112 s: particles near the PBL top (tlw ~ 270 s)
    # take the skewed dtftlw<0.5 path, lower ones (tlw <= 220 s) the
    # reference's dtftlw>=0.5 normalized-update quirk branch — real CBL
    # runs mix both, so the matched case does too
    cfg, prm, oprm = params(grid, True, 8)
    cfg = cfg._replace(cblflag=True)
    oprm.cblflag = True
    n = 24
    rs = np.random.RandomState(11)
    # half in the weak-Gaussian west, half in the skewed east; z spans
    # quirk-branch (low) and skewed-branch (near PBL top) regimes
    x = np.concatenate([rs.uniform(12.0, 26.0, n // 2),
                        rs.uniform(34.0, 50.0, n // 2)])
    y = rs.uniform(6.0, 24.0, n)
    z = np.concatenate([rs.uniform(100.0, 1100.0, n // 2),
                        rs.uniform(1300.0, 1450.0, n // 2)])
    return _case(conv, cfg, prm, oprm, x, y, z, 4, cbl=True)
