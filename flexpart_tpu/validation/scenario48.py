"""The 48-h Chernobyl-style deposition scenario (CTL=5 adaptive or fixed
stepping, ifine=4, turbswitch, wet+dry deposition and a 3-day-half-life
decay on an aerosol species) on a global-in-x synthetic grid over the
storm band.

Two studies run it:

* `matched_chernobyl` — the kernels against the scalar reference oracles
  under bitwise-identical rannumb/ran3 streams, with release positions
  drawn through the reference's exact ran1 order
  (releaseparticles.f90:147-193) and the final gridded concentrations
  compared through the real grid/conccalc.py kernel.  Every mass-path
  term (wet scavenging coefficient, grid fraction, exponential removal,
  decay factor, dry-deposition probability window, minmass bookkeeping)
  feeds the comparison.
* `bf16_run` — the production advance with threefry draws, met_bf16 on
  or off, so the bfloat16 table default can be bounded at the
  gridded-concentration level.

The pytest suite and the on-device smoke test share these.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import OutGrid
from ..core import StepConfig, StepParams, advance_all
from ..core.advance import LegacyRnd
from ..core.state import empty_particles
from ..grid.conccalc import ConcConfig, make_conccalc
from ..grid.outgrid import OutputGridGeometry, zero_accumulators
from ..met import calcpar, compute_heights, make_grid, process_eta
from ..met.synthetic import SyntheticMet
from ..physics import MassSpecies, WetSpecies, apply_wetdepo
from ..physics.massupdate import apply_decay_drydep
from ..physics.wetdepo import wetscav_all
from .depo_oracle import (legacy_release, oracle_drydecay_mass,
                          oracle_wetdepo_mass, oracle_wetscav)
from .legacy_rng import MAXRAND, NrandStream, make_rannumb
from .oracle import OracleParams, run_oracle

SEED = -7
LSYNC = 900
WIND_IV = 10800                  # 3-h met interval
HOURS = 48
NSTEPS = HOURS * 3600 // LSYNC   # 192
N_MATCHED = 36
DRYVEL = 0.008                   # prescribed vdep [m/s]
DECAY = 0.693147 / (3.0 * 86400.0)   # 3-day half-life: visible decay

SP = dict(is_aerosol=True, dquer=0.4, crain_aero=1.0, csnow_aero=1.0,
          ccn_aero=0.9, in_aero=0.1, weta_gas=-9.9e-10, wetb_gas=-9.9,
          henry=-9.9e-10)


class _NpZ:
    def __init__(self, zf):
        self.f3d = np.asarray(zf.f3d)
        self.f2d = np.asarray(zf.f2d)
        self.clouds = np.asarray(zf.clouds)
        self.height = np.asarray(zf.height)


def setup48():
    """(grid, fields): global-in-x grid over the synthetic storm band
    (|lat|~50) and its processed 3-hourly fields for 48 h."""
    grid = make_grid(nx=61, ny=31, nlev=20, dx=6.0, dy=1.0,
                     xlon0=-180.0, ylat0=35.0, xglobal=True)
    met = SyntheticMet(grid)
    height = compute_heights(grid, met.fetch(0.0))
    fields = []
    for k in range(HOURS * 3600 // WIND_IV + 1):
        eta = met.fetch(float(k * WIND_IV))
        fields.append(calcpar(grid, eta, process_eta(grid, eta, height)))
    return grid, fields


def _wet_species():
    return (WetSpecies(wetdep=True, is_aerosol=True, weta_gas=-9.9e-10,
                       wetb_gas=-9.9, crain_aero=1.0, csnow_aero=1.0,
                       ccn_aero=0.9, in_aero=0.1, henry=-9.9e-10,
                       dquer=0.4),)


def _wet_field(fields, itime):
    """Nearest-time field for the wet deposition over the interval
    ending at itime (timemanager.f90:164-169)."""
    interp_t = itime - LSYNC // 2
    ivw = interp_t // WIND_IV
    use0 = abs(ivw * WIND_IV - interp_t) \
        < abs((ivw + 1) * WIND_IV - interp_t)
    return ivw if use0 else ivw + 1


def _conccalc_final(grid, zlast, po):
    """Final-time concentrations of particles `po` through the real
    conccalc kernel."""
    og = OutGrid(outlon0=-180.0, outlat0=35.0, numxgrid=90, numygrid=15,
                 dxout=4.0, dyout=2.0, outheights=(500.0, 2000.0, 20000.0))
    geo = OutputGridGeometry(og, grid)
    ccfg = ConcConfig(nxg=geo.nxg, nyg=geo.nyg, nzg=geo.nzg,
                      npointspec=1, nclassunc=1, nage=1,
                      dxout=og.dxout, dyout=og.dyout,
                      xoutshift=geo.xoutshift, youtshift=geo.youtshift,
                      dx_met=grid.dx, dy_met=grid.dy, ind_samp=0)
    conccalc = make_conccalc(og.outheights)
    lage = jnp.asarray([999999999], jnp.int32)
    acc = zero_accumulators(geo, 1, 1, 1, 1)
    acc = conccalc(acc, po, zlast, jnp.int32(NSTEPS * LSYNC), lage,
                   jnp.float32(1.0), ccfg)
    return np.asarray(acc.gridunc)


def _gridded(grid, zlast, n, xs, ys, zs, masses):
    """Concentrations of bare final positions and masses."""
    po = empty_particles(n)
    po = po._replace(
        x_hi=jnp.asarray(xs, jnp.float32),
        y_hi=jnp.asarray(ys, jnp.float32),
        z=jnp.asarray(zs, jnp.float32),
        itra=jnp.full(n, NSTEPS * LSYNC, jnp.int32),
        itramem=jnp.full(n, -1, jnp.int32),
        mass=jnp.asarray(masses, jnp.float32)[:, None],
        active=jnp.ones(n, bool))
    return _conccalc_final(grid, zlast, po)


class ChernobylRun(NamedTuple):
    kernel_active: bool      # no kernel particle terminated
    oracle_nstops: list
    mass_k_steps: list       # per-step (N,) kernel particle masses
    mass_o_steps: list       # per-step (N,) oracle particle masses
    gk: np.ndarray           # kernel gridded concentrations
    go: np.ndarray           # oracle gridded concentrations


def matched_chernobyl(grid, fields) -> ChernobylRun:
    n = N_MATCHED
    cfg = StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                     xglobal=True, ldirect=1, turbswitch=True,
                     ifine=4, method=1)
    prm = StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                          dxconst=grid.dxconst, dyconst=grid.dyconst,
                          lsynctime=LSYNC, fine=0.25, ctl=5.0,
                          lwindinterv=WIND_IV)
    oprm = OracleParams(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                        xglobal=True, ldirect=1, turbswitch=True,
                        ifine=4, lsynctime=LSYNC, lwindinterv=WIND_IV,
                        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                        dxconst=float(grid.dxconst),
                        dyconst=float(grid.dyconst),
                        method=1, ctl=5.0, vdep=DRYVEL)

    # release through the reference's ran1 draw order
    box = dict(lon1=-30.0, lon2=-20.0, lat1=48.0, lat2=52.0,
               z1=20.0, z2=1500.0)
    x0, y0, nclass0, zrel = legacy_release(
        box, n, nclassunc=1, xlon0=grid.xlon0, ylat0=grid.ylat0,
        dx=grid.dx, dy=grid.dy, seed=SEED)

    # ---------------- kernel side ----------------
    p = empty_particles(n)
    p = p._replace(x_hi=jnp.asarray(x0, jnp.float32),
                   y_hi=jnp.asarray(y0, jnp.float32),
                   z=jnp.asarray(zrel),
                   itra=jnp.zeros(n, jnp.int32),
                   itramem=jnp.full(n, -1, jnp.int32),
                   mass=jnp.ones((n, 1), jnp.float32),
                   mass0=jnp.ones((n, 1), jnp.float32),
                   active=jnp.ones(n, bool))
    table = jnp.asarray(make_rannumb(MAXRAND, SEED))
    stream = NrandStream(SEED, MAXRAND)
    key = jax.random.PRNGKey(0)
    msp = MassSpecies(decay=(DECAY,), drydep=(True,), minmass=1e-4)
    wsp = _wet_species()
    vdep_field = jnp.full((1, grid.ny, grid.nx), DRYVEL, jnp.float32)
    mass_k_steps = []
    for k in range(NSTEPS):
        itime = k * LSYNC
        iv = itime // WIND_IV
        mt0, mt1 = iv * WIND_IV, (iv + 1) * WIND_IV
        zA, zB = fields[iv], fields[iv + 1]
        if k > 0:
            zw = fields[_wet_field(fields, itime)]
            lam, grfrac = wetscav_all(p, zw, jnp.int32(itime),
                                      jnp.int32(LSYNC), wsp, False)
            p, _wdep = apply_wetdepo(p, lam, grfrac, jnp.int32(LSYNC),
                                     jnp.int32(0), msp)
        active = np.asarray(p.active)
        ni = np.ones(n, np.int64)
        na = np.ones(n, np.int64)
        for j in range(n):
            if not active[j]:
                continue
            if k == 0:
                ni[j] = stream.next_nrand()
            na[j] = stream.next_nrand()
        leg = LegacyRnd(table=table,
                        nrand_init=jnp.asarray(ni, jnp.int32),
                        nrand=jnp.asarray(na, jnp.int32))
        p, diag = advance_all(p, zA, zB, jnp.int32(itime),
                              jnp.int32(mt0), jnp.int32(mt1), key, cfg,
                              prm, leg=leg)
        # decay + dry deposition with the in-kernel t_below window
        p, _ddep = apply_decay_drydep(p, vdep_field, jnp.int32(LSYNC),
                                      jnp.int32(0), msp, has_vdep=True,
                                      t_below=diag.t_below)
        mass_k_steps.append(np.asarray(p.mass[:, 0]).copy())

    # ---------------- oracle side ----------------
    parts = [dict(xt=np.float64(x0[j]), yt=np.float64(y0[j]),
                  zt=np.float32(zrel[j]), mass=np.float32(1.0))
             for j in range(n)]
    stream_o = NrandStream(SEED, MAXRAND)
    states = [dict(s) for s in parts]
    nstops = [0] * n
    mass_o_steps = []
    trace_o = []
    for k in range(NSTEPS):
        itime = k * LSYNC
        iv = itime // WIND_IV
        mt0, mt1 = iv * WIND_IV, (iv + 1) * WIND_IV
        zA, zB = _NpZ(fields[iv]), _NpZ(fields[iv + 1])
        if k > 0:
            zw = _NpZ(fields[_wet_field(fields, itime)])
            for j, s in enumerate(states):
                if nstops[j]:
                    continue
                lam, grf = oracle_wetscav(zw, float(s["xt"]),
                                          float(s["yt"]),
                                          float(s["zt"]), SP)
                s["mass"], _dep = oracle_wetdepo_mass(
                    s["mass"], lam, grf, LSYNC, 0, DECAY)
        # one advance step for all particles (shares run_oracle's
        # per-step ordering)
        states, nstops, tr = run_oracle(
            oprm, zA, zB, (mt0, mt1), states, 1, itime0=itime,
            seed=SEED, stream=stream_o, nstops=nstops,
            do_init=(k == 0))
        trace_o.append(np.asarray(tr[0], np.float64))
        for j, s in enumerate(states):
            if nstops[j]:
                continue
            s["mass"], _dd = oracle_drydecay_mass(
                s["mass"], s.get("prob", 0.0), LSYNC, 0, DECAY, True)
        mass_o_steps.append(np.asarray([s["mass"] for s in states]))

    zlast = fields[-1]
    gk = _gridded(grid, zlast, n, np.asarray(p.x), np.asarray(p.y),
                  np.asarray(p.z), mass_k_steps[-1])
    go = _gridded(grid, zlast, n, trace_o[-1][:, 0], trace_o[-1][:, 1],
                  trace_o[-1][:, 2], mass_o_steps[-1])
    return ChernobylRun(bool(np.all(np.asarray(p.active))), nstops,
                        mass_k_steps, mass_o_steps, gk, go)


def chernobyl_mass_match(run: ChernobylRun, rtol=5e-3, atol=1e-7):
    """[(step, matched fraction, ensemble-mass rel. drift)] at four
    checkpoints: the share of particles whose masses agree within
    rtol/atol, and the relative difference of the ensemble mass."""
    out = []
    for k in (0, NSTEPS // 4, NSTEPS // 2, NSTEPS - 1):
        mk, mo = run.mass_k_steps[k], run.mass_o_steps[k]
        close = np.isclose(mk, mo, rtol=rtol, atol=atol)
        out.append((k, float(close.mean()),
                    float(abs(mk.sum() - mo.sum()) / mo.sum())))
    return out


def bf16_run(grid, fields, met_bf16: bool, n=10000):
    """The scenario with fixed ifine=4 stepping and threefry draws;
    returns (gridded concentrations, ensemble mass, active count)."""
    wsp = _wet_species()
    msp = MassSpecies(decay=(DECAY,), drydep=(True,), minmass=1e-4)
    vdep_field = jnp.full((1, grid.ny, grid.nx), DRYVEL, jnp.float32)
    rs = np.random.RandomState(5)
    x0 = rs.uniform(24.0, 27.0, n)
    y0 = rs.uniform(13.0, 17.0, n)
    z0r = rs.uniform(20.0, 1500.0, n)
    cfg = StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=True,
                     ldirect=1, turbswitch=True, ifine=4, method=0,
                     met_bf16=met_bf16)
    prm = StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                          dxconst=grid.dxconst, dyconst=grid.dyconst,
                          lsynctime=LSYNC, fine=0.25, ctl=-5.0,
                          lwindinterv=WIND_IV)
    p = empty_particles(n)
    p = p._replace(x_hi=jnp.asarray(x0, jnp.float32),
                   y_hi=jnp.asarray(y0, jnp.float32),
                   z=jnp.asarray(z0r, jnp.float32),
                   itra=jnp.zeros(n, jnp.int32),
                   itramem=jnp.full(n, -1, jnp.int32),
                   mass=jnp.ones((n, 1), jnp.float32),
                   mass0=jnp.ones((n, 1), jnp.float32),
                   active=jnp.ones(n, bool))
    key = jax.random.PRNGKey(7)
    for k in range(NSTEPS):
        itime = k * LSYNC
        iv = itime // WIND_IV
        zA, zB = fields[iv], fields[iv + 1]
        if k > 0:
            zw = fields[_wet_field(fields, itime)]
            lam, grfrac = wetscav_all(p, zw, jnp.int32(itime),
                                      jnp.int32(LSYNC), wsp, False)
            p, _ = apply_wetdepo(p, lam, grfrac, jnp.int32(LSYNC),
                                 jnp.int32(0), msp)
        kk = jax.random.fold_in(key, k)
        p, diag = advance_all(p, zA, zB, jnp.int32(itime),
                              jnp.int32(iv * WIND_IV),
                              jnp.int32((iv + 1) * WIND_IV), kk, cfg, prm)
        p, _ = apply_decay_drydep(p, vdep_field, jnp.int32(LSYNC),
                                  jnp.int32(0), msp, has_vdep=True,
                                  t_below=diag.t_below)
    g = _conccalc_final(grid, fields[-1], p._replace(
        itra=jnp.full(n, NSTEPS * LSYNC, jnp.int32)))
    return (g, float(np.asarray(p.mass).sum()),
            int(np.asarray(p.active).sum()))
