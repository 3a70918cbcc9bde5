"""BASELINE.md correctness row at production-driver scale: a 48-h
Chernobyl-style run with 10,240 particles through the REAL
`Simulation.run` scheduler in legacy-RNG mode, with the species parsed
verbatim from the reference's `options/SPECIES/SPECIES_016` (Cs-137) and the nclassunc=3 uncertainty machinery engaged.

Validation chain:
  * every stochastic draw in the driver comes from the reference's
    rannumb table through the serial ran3 idummy chase and release
    positions from the exact ran1 order (Simulation(legacy_rng=True));
  * a 16-particle subsample's COMPLETE 48-h trajectories are replayed
    through the scalar advance.f90 oracle with the recorded per-step
    nrand bases — bitwise-identical draws, so any position drift is an
    arithmetic/orchestration discrepancy of the production driver (met
    buffer swaps, wetdepo timing, adaptive-idt carry), not noise;
  * the subsample's mass path (Cs-137 wet scavenging + decay; dry
    deposition falls back to off without landuse files, exactly like
    the reference without surface data, getvdep.f90:196-203) is
    replayed through the scalar get_wetscav/wetdepo oracle;
  * gridded concentrations and wet-deposition fields from the real
    output pipeline must be finite, mass-consistent and populated.

Tolerances: positions to f32 roundoff over 192 steps (atol 5e-3 grid
units horizontal / 2 m vertical, as the kernel-vs-oracle matched suite
uses); subsample masses rtol 5e-3 with >=80% of particles matching
(branch flips at discrete cloud-cell boundaries can move single
particles, cf. tests/test_matched_chernobyl.py).
"""
import glob

import numpy as np
import pytest

from flexpart_tpu.config import (Command, OutGrid, ReleaseBox, Releases,
                                 Species)
from flexpart_tpu.met import (SyntheticMet, calcpar, compute_heights,
                              make_grid, process_eta)
from flexpart_tpu.run.simulation import Simulation
from flexpart_tpu.validation.legacy_rng import MAXRAND, make_rannumb
from flexpart_tpu.validation.oracle import (OracleParams, _Interp,
                                            oracle_advance,
                                            oracle_initialize)
from flexpart_tpu.validation.depo_oracle import (oracle_wetdepo_mass,
                                                 oracle_wetscav)

SEED = -7
LSYNC = 900
WIND_IV = 10800
HOURS = 48
NSTEPS = HOURS * 3600 // LSYNC
N = 10240
NSUB = 16
SPECIES_DIR = "/root/reference/options/SPECIES"


class _NpZ:
    def __init__(self, zf):
        self.f3d = np.asarray(zf.f3d)
        self.f2d = np.asarray(zf.f2d)
        self.clouds = np.asarray(zf.clouds)
        self.height = np.asarray(zf.height)


class _Base:
    """Stream stub feeding oracle_initialize/oracle_advance the exact
    nrand base the driver recorded for this (particle, step)."""

    def __init__(self, v):
        self.v = int(v)

    def next_nrand(self):
        return self.v


@pytest.fixture(scope="module")
def driver_run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("matched_driver")
    grid = make_grid(nx=61, ny=31, nlev=20, dx=6.0, dy=1.0,
                     xlon0=-180.0, ylat0=35.0, xglobal=True)
    sp = Species.from_directory(SPECIES_DIR, 16)      # Cs-137, verbatim
    assert sp.name.strip() == "Cs-137"
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200103, ietime=0,
                  lsynctime=LSYNC, loutstep=10800, loutaver=10800,
                  loutsample=900, lconvection=0, ctl=5.0, ifine=4)
    # release just west of a synthetic-met storm cell (scavenging
    # zones sit at x~12-18 on this grid) so the plume rains out
    box = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                     itime2=0, lon1=-115.0, lon2=-105.0, lat1=48.0,
                     lat2=52.0, z1=20.0, z2=1500.0, mass=(1.0,),
                     parts=N)
    og = OutGrid(outlon0=-180.0, outlat0=35.0, numxgrid=90, numygrid=15,
                 dxout=4.0, dyout=2.0,
                 outheights=(500.0, 2000.0, 20000.0))
    sim = Simulation(cmd=cmd, releases=Releases(species=(sp,),
                                                boxes=(box,)),
                     grid=grid, met_backend=SyntheticMet(grid),
                     outgrid=og, outdir=str(outdir), nclassunc=3,
                     wind_interval=WIND_IV, write_netcdf=False,
                     legacy_rng=True, legacy_seed=SEED,
                     legacy_trace=True, met_bf16=False)
    assert sim.step_cfg.method == 1 and sim.step_cfg.turbswitch
    sim.run()
    return sim, grid, outdir


def _fields(grid):
    met = SyntheticMet(grid)
    height = compute_heights(grid, met.fetch(0.0))
    return [calcpar(grid, met.fetch(float(k * WIND_IV)),
                    process_eta(grid, met.fetch(float(k * WIND_IV)),
                                height))
            for k in range(HOURS * 3600 // WIND_IV + 1)], height


def test_matched_driver_chernobyl_10k(driver_run):
    sim, grid, outdir = driver_run
    trace = sim._legacy_trace
    assert len(trace) == NSTEPS

    # ---- outputs from the real pipeline ----
    outs = sorted(glob.glob(str(outdir / "grid_conc_*.npz")))
    assert len(outs) >= 4
    saw_wet = False
    for f in outs:
        d = np.load(f)
        assert np.isfinite(d["conc"]).all()
        saw_wet |= np.asarray(d["wet"]).max() > 0
    assert saw_wet, "Cs-137 wet deposition must reach the output grids"
    assert np.load(outs[-1])["conc"].max() > 0

    # nclassunc engaged: release spread particles over all 3 classes
    ncl = np.asarray(sim.particles.nclass)
    assert set(np.unique(ncl[:N])) == {0, 1, 2}

    act = np.asarray(sim.particles.active)
    assert act.sum() > 0.9 * N          # Cs-137 survives 48 h mostly

    # ---- oracle replay of a 16-particle subsample ----
    fields, height = _fields(grid)
    table = make_rannumb(MAXRAND, SEED)
    sp = sim.releases.species[0]
    oprm = OracleParams(nx=grid.nx, ny=grid.ny, nz=grid.nlev,
                        xglobal=True, ldirect=1, turbswitch=True,
                        ifine=4, lsynctime=LSYNC, lwindinterv=WIND_IV,
                        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                        dxconst=float(grid.dxconst),
                        dyconst=float(grid.dyconst), method=1, ctl=5.0,
                        settling=True,
                        sp_density=float(sim.step_prm.sp_density[0]),
                        sp_dquer=float(sim.step_prm.sp_dquer[0]),
                        sp_cunningham=float(
                            sim.step_prm.sp_cunningham[0]),
                        sp_vsetaver=float(sim.step_prm.sp_vsetaver[0]))
    SP = dict(is_aerosol=True, dquer=sp.dquer,
              crain_aero=sp.crain_aero, csnow_aero=sp.csnow_aero,
              ccn_aero=sp.ccn_aero, in_aero=sp.in_aero,
              weta_gas=sp.weta_gas, wetb_gas=sp.wetb_gas,
              henry=sp.henry)
    decay = float(sp.decay) if sp.decay > 0 else 0.0   # [1/s] constant

    rs = np.random.RandomState(1)
    alive_end = np.nonzero(act[:N])[0]
    sub = rs.choice(alive_end, NSUB, replace=False)

    t0 = trace[0]
    states = {j: dict(xt=np.float64(t0["x"][j]),
                      yt=np.float64(t0["y"][j]),
                      zt=np.float32(t0["z"][j]),
                      mass=np.float32(t0["mass"][j, 0]))
              for j in sub}
    first_div = {j: None for j in sub}
    for k in range(NSTEPS):
        tr = trace[k]
        itime = tr["itime"]
        iv = itime // WIND_IV
        mt = (iv * WIND_IV, (iv + 1) * WIND_IV)
        zA, zB = _NpZ(fields[iv]), _NpZ(fields[iv + 1])
        itp = _Interp(oprm, zA, zB, itime, mt)
        itp._memtime0, itp._memtime1 = mt
        if k > 0:
            # wet scavenging over the interval ENDING at itime, field
            # nearest itime - lsync/2 (timemanager.f90:164-169)
            interp_t = itime - LSYNC // 2
            ivw = interp_t // WIND_IV
            use0 = abs(ivw * WIND_IV - interp_t) \
                < abs((ivw + 1) * WIND_IV - interp_t)
            zw = _NpZ(fields[ivw] if use0 else fields[ivw + 1])
            for j in sub:
                s = states[j]
                lam, grf = oracle_wetscav(zw, float(s["xt"]),
                                          float(s["yt"]),
                                          float(s["zt"]), SP)
                s["mass"], _ = oracle_wetdepo_mass(s["mass"], lam, grf,
                                                   LSYNC, 0, decay)
        for j in sub:
            s = states[j]
            if k == 0:
                (s["up"], s["vp"], s["wp"], s["usigold"], s["vsigold"],
                 s["wsigold"], s["icbt"], s["idt"]) = oracle_initialize(
                    oprm, itp, _Base(tr["ni"][j]), table,
                    float(s["xt"]), float(s["yt"]), np.float32(s["zt"]))
            states[j], nstop = oracle_advance(
                oprm, itp, _Base(tr["na"][j]), table, itime, mt, s)
            assert nstop == 0
            # decay on the airborne mass (timemanager.f90:643-660;
            # no dry deposition without landuse data)
            s = states[j]
            s["mass"] = np.float32(
                s["mass"] * np.exp(-LSYNC * decay))
            # compare against the driver's NEXT pre-step snapshot
            nxt = trace[k + 1] if k + 1 < NSTEPS else None
            if (nxt is not None and nxt["active"][j]
                    and first_div[j] is None):
                ok = (abs(nxt["x"][j] - s["xt"]) < 5e-3
                      and abs(nxt["y"][j] - s["yt"]) < 5e-3
                      and abs(float(nxt["z"][j]) - float(s["zt"]))
                      < 2.0 + 1e-4 * float(s["zt"]))
                if not ok:
                    first_div[j] = k

    # bitwise-matched draws: a particle tracks the oracle exactly until
    # (at most once, at 10k scale) it lands within f32 roundoff of a
    # DISCRETE branch boundary — the int(lim*ctl) adaptive-ldt
    # truncation or a reflection — and permanently takes the other
    # branch.  Measured: 13/16 subsample particles track all 191 steps
    # exactly; the flips happen in the first steps with z-only
    # differences of metres.  Require a large exactly-tracking majority
    # (any orchestration bug — wrong met buffer, draw misalignment,
    # wetdepo timing — desyncs EVERY particle immediately).
    n_exact = sum(1 for j in sub if first_div[j] is None)
    assert n_exact >= 0.7 * NSUB, first_div

    # final masses through the scalar mass oracle, for the particles
    # whose trajectories tracked exactly (diverged ones sample
    # different precip cells and are different realizations)
    exact = [j for j in sub if first_div[j] is None]
    m_drv = np.asarray(sim.particles.mass)[exact, 0]
    m_orc = np.asarray([states[j]["mass"] for j in exact])
    np.testing.assert_allclose(m_drv, m_orc, rtol=5e-3, atol=1e-9)
    # wet scavenging must actually have removed ensemble mass (the
    # airborne total ends below released-minus-decay)
    m_tot = float(np.asarray(sim.particles.mass).sum())
    assert m_tot < 0.995, m_tot
