"""End-to-end CLI test: full reference input layout (pathnames + options/
+ AVAILABLE + met archive) driven through `python -m flexpart_tpu`,
asserting the success banner and output files — the analog of the
reference's utils/test/test_flexpart.py:54-89 e2e contract."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

COMMAND = """&COMMAND
 LDIRECT=1,
 IBDATE=20200101, IBTIME=000000,
 IEDATE=20200101, IETIME=030000,
 LOUTSTEP=3600, LOUTAVER=3600, LOUTSAMPLE=900,
 ITSPLIT=99999999, LSYNCTIME=900,
 CTL=-5.0, IFINE=4, IOUT=1, IPOUT=2, LSUBGRID=0, LCONVECTION=1,
 LAGESPECTRA=0, IPIN=0, IOUTPUTFOREACHRELEASE=1, IFLUX=0, MDOMAINFILL=0,
 IND_SOURCE=1, IND_RECEPTOR=1, MQUASILAG=0, NESTED_OUTPUT=0,
 LINIT_COND=0, SURF_ONLY=0, CBLFLAG=0,
 /
"""

RELEASES = """&RELEASES_CTRL
 NSPEC=1, SPECNUM_REL=24,
 /
&RELEASE
 IDATE1=20200101, ITIME1=000000, IDATE2=20200101, ITIME2=000000,
 LON1=-50.0, LON2=-48.0, LAT1=42.0, LAT2=44.0,
 Z1=100.0, Z2=500.0, ZKIND=1, MASS=1.0, PARTS=800,
 COMMENT="E2E",
 /
"""

SPECIES_024 = """&SPECIES_PARAMS
 PSPECIES="AIRTRACER", PWEIGHTMOLAR=29.0,
 /
"""

OUTGRID = """&OUTGRID
 OUTLON0=-180.0, OUTLAT0=-90.0, NUMXGRID=72, NUMYGRID=36,
 DXOUT=5.0, DYOUT=5.0, OUTHEIGHTS=500.0,2000.0,50000.0,
 /
"""


@pytest.fixture(scope="module")
def jobdir(tmp_path_factory):
    """Assemble a reference-layout job dir with synthetic met as the
    .npz archive the NpzMet backend reads."""
    job = tmp_path_factory.mktemp("job")
    opts = job / "options"
    (opts / "SPECIES").mkdir(parents=True)
    out = job / "output"
    out.mkdir()
    met = job / "metdata"
    met.mkdir()
    (opts / "COMMAND").write_text(COMMAND)
    (opts / "RELEASES").write_text(RELEASES)
    (opts / "SPECIES" / "SPECIES_024").write_text(SPECIES_024)
    (opts / "OUTGRID").write_text(OUTGRID)

    # met archive: synthetic atmosphere dumped to npz + AVAILABLE index
    from flexpart_tpu.met import SyntheticMet, make_grid
    from flexpart_tpu.met.npzmet import save_eta_npz
    grid = make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    backend = SyntheticMet(grid)
    lines = ["header", "header", "header"]
    for h in range(0, 5):
        fname = f"EN20200101{h:02d}"
        save_eta_npz(met / (fname + ".npz"), backend.fetch(h * 3600.0),
                     grid)
        lines.append(f"20200101 {h:02d}0000      {fname}.npz"
                     "      ON DISC")
    (job / "AVAILABLE").write_text("\n".join(lines) + "\n")
    (job / "pathnames").write_text(
        f"{opts}/\n{out}/\n{met}/\n{job / 'AVAILABLE'}\n")
    return job


@pytest.fixture(scope="module")
def cli_run(jobdir):
    """One `python -m flexpart_tpu` run of the job; the tests that read
    its outputs depend on this fixture, so each xdist worker has them."""
    return subprocess.run(
        [sys.executable, "-m", "flexpart_tpu", str(jobdir / "pathnames"),
         "-v"],
        capture_output=True, text=True, timeout=560, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": str(REPO)})


def test_cli_end_to_end(jobdir, cli_run):
    res = cli_run
    assert res.returncode == 0, res.stderr[-2000:]
    assert ("CONGRATULATIONS: YOU HAVE SUCCESSFULLY COMPLETED A "
            "FLEXPART MODEL RUN!") in res.stdout
    out = jobdir / "output"
    npz = sorted(out.glob("grid_conc_*.npz"))
    assert len(npz) >= 2
    assert (out / "dates").exists()
    assert (out / "partposit_end").exists()
    d = np.load(npz[-1])
    assert np.isfinite(d["conc"]).all()
    assert d["conc"].max() > 0.0


def test_cli_release_outside_window_rejected(jobdir):
    """Probe: COMMAND window not covering the release must fail loudly
    (readreleases.f90 consistency checks)."""
    bad = jobdir / "options" / "COMMAND_BAD"
    bad.write_text(COMMAND.replace("IBDATE=20200101", "IBDATE=20200102")
                   .replace("IEDATE=20200101", "IEDATE=20200102"))
    orig = (jobdir / "options" / "COMMAND").read_text()
    (jobdir / "options" / "COMMAND").write_text(bad.read_text())
    try:
        res = subprocess.run(
            [sys.executable, "-m", "flexpart_tpu",
             str(jobdir / "pathnames")],
            capture_output=True, text=True, timeout=300, cwd=REPO,
            env={**os.environ, "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": str(REPO)})
        assert res.returncode != 0
    finally:
        (jobdir / "options" / "COMMAND").write_text(orig)


def test_cli_warm_start_ipin(jobdir, cli_run):
    """IPIN=1 resumes from the previous run's partposit_end
    (FLEXPART.f90:322-333): the new Simulation must carry the dumped
    particles in addition to its own scheduled releases."""
    from flexpart_tpu.main import build_simulation

    dump = jobdir / "output" / "partposit_end"
    assert dump.exists(), cli_run.stderr[-2000:]
    opts = jobdir / "options"
    orig = (opts / "COMMAND").read_text()
    (opts / "COMMAND").write_text(orig.replace("IPIN=0", "IPIN=1"))
    try:
        sim = build_simulation(str(jobdir / "pathnames"))
        assert sim.cmd.ipin == 1
        # 800 scheduled (instantaneous release) + the dumped survivors
        n_dumped = sim.particles.capacity - 800
        assert n_dumped > 0
        import jax.numpy as jnp
        # warm particles activate at itime=0 alongside the release
        from flexpart_tpu.core import activate
        p = activate(sim.particles, jnp.int32(0))
        assert int(np.sum(np.asarray(p.active))) == 800 + n_dumped
        # original release times preserved for age classes
        itm = np.asarray(sim.particles.itramem[800:])
        assert (itm <= 0).all()
        sim.close()
    finally:
        (opts / "COMMAND").write_text(orig)


def test_cli_receptors_and_nested_outgrid(jobdir):
    """RECEPTORS and OUTGRID_NEST files in options/ must reach the
    Simulation (FLEXPART.f90:247-304 read order)."""
    from flexpart_tpu.main import build_simulation

    opts = jobdir / "options"
    (opts / "RECEPTORS").write_text(
        "&RECEPTORS RECEPTOR=\"STATION A\", LON=-40.0, LAT=43.0, /\n"
        "&RECEPTORS RECEPTOR=\"STATION B\", LON=-30.0, LAT=45.0, /\n")
    (opts / "OUTGRID_NEST").write_text(
        "&OUTGRIDN OUTLON0N=-60.0, OUTLAT0N=30.0, NUMXGRIDN=20,"
        " NUMYGRIDN=20, DXOUTN=1.0, DYOUTN=1.0, /\n")
    orig = (opts / "COMMAND").read_text()
    (opts / "COMMAND").write_text(
        orig.replace("NESTED_OUTPUT=0", "NESTED_OUTPUT=1"))
    try:
        sim = build_simulation(str(jobdir / "pathnames"))
        assert list(sim.receptor_names) == ["STATION A", "STATION B"]
        assert sim.use_nested_output
        assert sim.outgrid_nest.numxgrid == 20
        sim.close()
    finally:
        (opts / "COMMAND").write_text(orig)
        (opts / "RECEPTORS").unlink()
        (opts / "OUTGRID_NEST").unlink()
