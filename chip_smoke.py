#!/usr/bin/env python3
"""On-device smoke test of the dispersion model on NVIDIA GPUs.

    python chip_smoke.py                # P1-P4 on one GPU
    python chip_smoke.py --four-cards   # P5a-P5b on four GPUs
    python chip_smoke.py --phases p3    # a subset of P1-P4

One process drives every phase on the card(s), through the entry points
users call, and checks each against the repo's own references:

  P1  matched RNG: the advance kernel vs the scalar advance.f90 oracle
      over the branch matrix (validation.matched), per-step positions
      within 5e-3 grid units / 2 m (2e-2 / 5 m for adaptive stepping and
      wind-interval swaps).
  P2  48-h scenarios (validation.scenario48): the matched Chernobyl run
      (particle masses rtol 5e-3 / atol 1e-7, >= 90% / 80% of particles;
      ensemble mass within 2%; gridded L1 < 5%) and bf16 vs f32 tables
      (ensemble mass within 0.5%, gridded L1 within 2%).
  P3  REF1's 10M-particle row through Simulation.run: global 1-degree
      361x181x30 synthetic met through the prefetch reader, 10,485,760
      particles, 0.5-degree 720x360 output, 6 simulated hours.
  P4  the CLI (flexpart_tpu.main.main), in-process.
  P5a the multi-device dry runs of __graft_entry__ on 4 cards (dp and
      tiles against serial).
  P5b dp(4) at 41,943,040 particles (REF1's 40M row) against a serial
      run of the same size on card 0, 2 simulated hours.

It never falls back to the CPU: with no GPU it exits non-zero at once.
Every number is printed with the card's name and power limit.  The last
line of standard output, printed only when every phase passed, is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REF1_PARTICLES = 10 * 2 ** 20          # 10,485,760: REF1's 10M row
REF1_DP_PARTICLES = 40 * 2 ** 20       # 41,943,040: REF1's 40M row

CARD = "card unknown"


def card_label() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` as one line."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]
    return "; ".join(lines) if lines else "nvidia-smi gave no cards"


def require_gpu(devices) -> None:
    """Refuse anything but a GPU platform (no CPU fallback)."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX platform "
                         f"'{platform}'); this test runs only on a GPU")


def report(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}  ({CARD})", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ----------------------------------------------------------------- P1
def phase_matched_rng():
    from flexpart_tpu.validation import matched

    setup = matched.met_setup()
    cases = [
        ("turb ifine=1", lambda: matched.case_positions(setup, True, 1)),
        ("no-turb ifine=1", lambda: matched.case_positions(setup, False,
                                                           1)),
        ("turb ifine=4", lambda: matched.case_positions(setup, True, 4)),
        ("settling", lambda: matched.case_settling(setup)),
        ("adaptive ctl=5", lambda: matched.case_adaptive(setup)),
        ("wind intervals", lambda: matched.case_wind_intervals(setup)),
        ("cbl + NaN retry", lambda: matched.case_cbl(setup)),
    ]
    for name, fn in cases:
        run = fn()
        check(all(s == 0 for s in run.nstops), f"{name}: oracle exits")
        check(bool(np.all(np.asarray(run.pk.active))),
              f"{name}: kernel lost particles")
        dx, dy, dz = matched.compare(run)
        report("P1", f"{name}: max |dx| {dx:.3e} |dy| {dy:.3e} "
                     f"(atol {run.atol_xy:g} grid units), max |dz| "
                     f"{dz:.3e} m (atol {run.atol_z:g} m)")
        if name.startswith("adaptive"):
            idt_k = np.asarray(run.pk.idt)
            idt_o = np.asarray([s["idt"] for s in run.states])
            frac = float((idt_k == idt_o).mean())
            check(frac > 0.8, f"adaptive idt agreement {frac}")
            report("P1", f"{name}: next-step idt agreement {frac:.3f} "
                         f"(> 0.8)")
    run, l1 = matched.case_concentrations(setup)
    check(all(s == 0 for s in run.nstops), "concentrations: oracle exits")
    check(l1 < 0.02, f"gridded L1 {l1}")
    report("P1", f"gridded concentrations: relative L1 {l1:.3e} (< 0.02)")


# ----------------------------------------------------------------- P2
def phase_scenarios():
    from flexpart_tpu.validation import scenario48 as sc

    grid, fields = sc.setup48()
    run = sc.matched_chernobyl(grid, fields)
    check(run.kernel_active, "Chernobyl: kernel lost particles")
    check(all(s == 0 for s in run.oracle_nstops),
          "Chernobyl: oracle lost particles")
    for k, frac, drift in sc.chernobyl_mass_match(run):
        min_frac = 0.9 if k < sc.NSTEPS // 2 else 0.8
        report("P2", f"Chernobyl 48 h step {k}: {frac:.3f} of particle "
                     f"masses within rtol 5e-3/atol 1e-7 (>= {min_frac}), "
                     f"ensemble mass drift {drift:.3e} (<= 0.02)")
        check(frac >= min_frac, f"step {k}: matched fraction {frac}")
        check(drift <= 0.02, f"step {k}: ensemble drift {drift}")
    check(run.mass_k_steps[-1].sum() < 0.7 * sc.N_MATCHED,
          "deposition/decay did not act")
    l1 = float(np.abs(run.gk - run.go).sum() / max(run.go.sum(), 1e-12))
    check(l1 < 0.05 and run.go.sum() > 0, f"Chernobyl gridded L1 {l1}")
    report("P2", f"Chernobyl gridded concentrations: relative L1 "
                 f"{l1:.3e} (< 0.05)")

    n = 10000
    g32, m32, a32 = sc.bf16_run(grid, fields, met_bf16=False, n=n)
    g16, m16, a16 = sc.bf16_run(grid, fields, met_bf16=True, n=n)
    check(a32 == n and a16 == n, f"bf16 study lost particles {a32} {a16}")
    check(m32 < 0.7 * n, "bf16 study: deposition did not act")
    rel_mass = abs(m16 - m32) / m32
    l1 = float(np.abs(g16 - g32).sum() / g32.sum())
    report("P2", f"bf16 vs f32 tables: ensemble mass rel. diff "
                 f"{rel_mass:.3e} (< 5e-3), gridded L1 {l1:.3e} (< 0.02)")
    check(rel_mass < 0.005, f"bf16 ensemble mass rel diff {rel_mass}")
    check(l1 < 0.02, f"bf16 gridded L1 {l1}")


# ------------------------------------------------------------ P3 / P5b
def ref1_simulation(n_particles: int, hours: int, loutstep: int,
                    outdir: str, distributed=None, n_devices=None):
    """REF1-scale run: global 1-degree 361x181x30 synthetic met with
    hourly fields through the prefetch reader, one release box at time
    0, global 0.5-degree 720x360 output, npz only."""
    from flexpart_tpu.config import (Command, OutGrid, ReleaseBox,
                                     Releases, Species)
    from flexpart_tpu.met import SyntheticMet, make_grid
    from flexpart_tpu.run.simulation import Simulation

    grid = make_grid(nx=361, ny=181, nlev=30, dx=1.0, dy=1.0,
                     xlon0=-180.0, ylat0=-90.0, xglobal=True)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101,
                  ietime=hours * 10000, lsynctime=900, loutstep=loutstep,
                  loutaver=loutstep, loutsample=900, lconvection=0)
    box = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                     itime2=0, lon1=-120.0, lon2=60.0, lat1=-50.0,
                     lat2=50.0, z1=50.0, z2=3000.0, mass=(1.0,),
                     parts=n_particles)
    og = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=720,
                 numygrid=360, dxout=0.5, dyout=0.5,
                 outheights=(100.0, 1000.0, 50000.0))
    return Simulation(cmd=cmd,
                      releases=Releases(species=(Species(),), boxes=(box,)),
                      grid=grid, met_backend=SyntheticMet(grid),
                      outgrid=og, outdir=outdir, wind_interval=3600,
                      write_netcdf=False, write_npz=True,
                      distributed=distributed, n_devices=n_devices)


def steady_rate(sim) -> float:
    """Particle-steps/s of Simulation.run after its first step."""
    t = sim.timings
    return ((t["particle_steps"] - t["first_step_particle_steps"])
            / (t["wall"] - t["first_step_wall_s"]))


def check_outputs(outdir: str, sim) -> float:
    """Every output finite; returns the released-mass fraction recovered
    by the last concentration field integrated over the output volume."""
    files = sorted(glob.glob(f"{outdir}/grid_conc_*.npz"))
    check(len(files) >= 1, f"outputs {files}")
    for f in files:
        d = np.load(f)
        for k in d.files:
            a = d[k]
            if a.dtype.kind == "f":
                check(np.isfinite(a).all(), f"{f}:{k} not finite")
    conc = np.load(files[-1])["conc"]
    # conc is mass per volume x 1e12 (concoutput.f90 units); release 1 kg
    return float((conc[0, 0, 0] * sim.geo.volume).sum() / 1e12)


def phase_ref1(n_particles=REF1_PARTICLES, hours=6):
    import jax

    with tempfile.TemporaryDirectory(prefix="smoke_ref1_") as out:
        sim = ref1_simulation(n_particles, hours, 10800, out)
        sim.run()
        n_act = int(np.sum(np.asarray(sim.particles.active)))
        check(n_act == n_particles, f"active {n_act} != {n_particles}")
        check(sim._prefetch_failures == 0,
              f"prefetch failures {sim._prefetch_failures}")
        frac = check_outputs(out, sim)
        check(abs(frac - 1.0) <= 0.02, f"recovered mass fraction {frac}")
    t = sim.timings
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    report("P3", f"{n_particles} particles, {hours} h: all active, "
                 f"prefetch failures 0, outputs finite, recovered mass "
                 f"fraction {frac:.5f} (within 0.02 of 1)")
    report("P3", f"first advance step (compile) {t['advance_first_s']} s; "
                 f"wall {t['wall']:.2f} s; steady-state "
                 f"{steady_rate(sim):.6g} particle-steps/s after the first "
                 f"step; peak_bytes_in_use {peak}")


# ----------------------------------------------------------------- P4
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
 COMMENT="SMOKE",
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
BANNER = ("CONGRATULATIONS: YOU HAVE SUCCESSFULLY COMPLETED A FLEXPART "
          "MODEL RUN!")


def write_job(job: Path) -> Path:
    """A reference-layout options tree; returns its pathnames file."""
    opts, out, met = job / "options", job / "output", job / "metdata"
    (opts / "SPECIES").mkdir(parents=True)
    out.mkdir()
    met.mkdir()
    (opts / "COMMAND").write_text(COMMAND)
    (opts / "RELEASES").write_text(RELEASES)
    (opts / "SPECIES" / "SPECIES_024").write_text(SPECIES_024)
    (opts / "OUTGRID").write_text(OUTGRID)
    (job / "AVAILABLE").write_text("header\nheader\nheader\n")
    (job / "pathnames").write_text(
        f"{opts}/\n{out}/\n{met}/\n{job / 'AVAILABLE'}\n")
    return job / "pathnames"


def phase_cli():
    from flexpart_tpu.main import main

    with tempfile.TemporaryDirectory(prefix="smoke_cli_") as d:
        job = Path(d)
        pathnames = write_job(job)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([str(pathnames), "--met", "synthetic"])
        text = buf.getvalue()
        check(rc == 0, f"CLI returned {rc}")
        check(BANNER in text, f"no success banner in {text[-500:]!r}")
        out = job / "output"
        names = sorted(p.name for p in out.iterdir())
        npz = sorted(out.glob("grid_conc_*.npz"))
        check(len(npz) >= 2 and (out / "dates").exists()
              and (out / "partposit_end").exists(), f"outputs {names}")
        conc = np.load(npz[-1])["conc"]
        check(np.isfinite(conc).all() and conc.max() > 0.0,
              "CLI concentrations not finite/positive")
    report("P4", f"CLI: banner printed, {len(npz)} grid_conc npz + dates "
                 f"+ partposit_end written; {text.splitlines()[0]}")


# ---------------------------------------------------------------- P5
def phase_dryrun_4():
    import __graft_entry__

    with tempfile.TemporaryDirectory(prefix="smoke_dryrun_") as d:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            __graft_entry__.dryrun_multichip(4, root=d)
    for line in buf.getvalue().splitlines():
        report("P5a", line)


def phase_dp_ref1(n_particles=REF1_DP_PARTICLES, hours=2):
    with tempfile.TemporaryDirectory(prefix="smoke_dp_") as d:
        rates, files = {}, {}
        for mode in (None, "dp"):
            out = f"{d}/{mode or 'serial'}"
            sim = ref1_simulation(n_particles, hours, 3600, out,
                                  distributed=mode,
                                  n_devices=4 if mode else None)
            sim.run()
            n_act = int(np.sum(np.asarray(sim.particles.active)))
            check(n_act == n_particles, f"{mode}: active {n_act}")
            check(sim._prefetch_failures == 0, f"{mode}: prefetch failed")
            frac = check_outputs(out, sim)
            check(abs(frac - 1.0) <= 0.02, f"{mode}: mass fraction {frac}")
            rates[mode or "serial"] = (steady_rate(sim),
                                       sim.timings["advance_first_s"])
            files[mode or "serial"] = sorted(
                glob.glob(f"{out}/grid_conc_*.npz"))
            del sim
        worst = 0.0
        for a, b in zip(files["serial"], files["dp"]):
            cs, cd = np.load(a)["conc"], np.load(b)["conc"]
            # only the f32 scatter-add order differs (slot-keyed draws)
            atol = 1e-6 * float(np.abs(cs).max())
            np.testing.assert_allclose(cd, cs, rtol=1e-3, atol=atol)
            big = np.abs(cs) > atol
            worst = max(worst, float(np.max(
                np.abs(cd[big] - cs[big]) / np.abs(cs[big]))))
    report("P5b", f"dp(4) vs serial at {n_particles} particles, {hours} h: "
                  f"{len(files['dp'])} outputs match, worst cell rel. diff "
                  f"{worst:.3e} (rtol 1e-3, atol 1e-6 x max)")
    for mode, (rate, first) in rates.items():
        report("P5b", f"{mode}: steady-state {rate:.6g} particle-steps/s "
                      f"after the first step; first advance step "
                      f"(compile) {first} s")


PHASES = {"p1": phase_matched_rng, "p2": phase_scenarios,
          "p3": phase_ref1, "p4": phase_cli}
FOUR_CARD_PHASES = {"p5a": phase_dryrun_4, "p5b": phase_dp_ref1}


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the 4-card phases (P5a, P5b) only")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the one-card phases")
    args = ap.parse_args(argv)

    CARD = card_label()
    print(f"card: {CARD}", flush=True)
    import jax
    try:
        devices = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: no GPU found ({e})")
    require_gpu(devices)
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        raise SystemExit(f"chip_smoke: needs {need} GPUs, found "
                         f"{len(devices)}")

    from flexpart_tpu.utils.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    print(f"jax {jax.__version__}, {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)

    if args.four_cards:
        phases = FOUR_CARD_PHASES
    else:
        names = [p.strip().lower() for p in args.phases.split(",")]
        unknown = set(names) - set(PHASES)
        if unknown:
            ap.error(f"unknown phases {sorted(unknown)}")
        phases = {k: PHASES[k] for k in names}
    failed = []
    for name, fn in phases.items():
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            report(name.upper(), "FAILED")
        else:
            report(name.upper(), f"passed in "
                                 f"{time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: phases failed: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
