"""Weak-scaling harness (reference scaling study
README_PARALLEL.md:108-142): particle-steps/s at 1/2/4 devices for
both distributed modes, holding PARTICLES PER DEVICE constant (weak
scaling).  Emits one JSON line per (mode, n_devices) point and a
summary line with the efficiency vs the 1-device run.

    python scripts/bench_scaling.py [--devices 1,2,4] [--modes dp,tiles]
                                    [--per-device 131072] [--platform gpu]

On GPUs each point sees only its first n cards (CUDA_VISIBLE_DEVICES)
and reports weak-scaling efficiency (the >=85% north-star row of
BASELINE.md).  `--platform cpu` runs the same points on a virtual CPU
mesh (--xla_force_host_platform_device_count) whose "devices" share the
host cores: that checks sharding logic only and measures no scaling.

Each point runs in a SUBPROCESS because the device count must be fixed
before jax initializes; the parent never imports jax, so one process at
a time holds the cards.  Any failed point makes the script exit
non-zero.
"""
import argparse
import json
import os
import subprocess
import sys


def run_point(ndev: int, mode: str, per_device: int, platform: str):
    """One (mode, ndev) measurement in this process.  Prints JSON."""
    import tempfile

    import jax
    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU found: {jax.devices()}")

    from flexpart_tpu.config import (Command, OutGrid, ReleaseBox,
                                     Releases, Species)
    from flexpart_tpu.met import SyntheticMet, make_grid
    from flexpart_tpu.run.simulation import Simulation

    if len(jax.devices()) < ndev:
        raise SystemExit(f"need {ndev} devices, have {jax.devices()}")
    n = per_device * ndev
    grid = make_grid(nx=73, ny=36, nlev=20, dx=5.0, dy=5.0)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101,
                  ietime=20000, lsynctime=900, loutstep=3600,
                  loutaver=3600, loutsample=900, lconvection=0)
    sp = Species(density=1900.0, dquer=0.5, dsigma=1.5, crain_aero=1.0,
                 csnow_aero=1.0, ccn_aero=0.9, in_aero=0.1, dryvel=0.01)
    box = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                     itime2=0, lon1=-150.0, lon2=120.0, lat1=-60.0,
                     lat2=60.0, z1=10.0, z2=3000.0, mass=(1.0,), parts=n)
    og = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=72,
                 numygrid=36, dxout=5.0, dyout=5.0,
                 outheights=(500.0, 2000.0, 50000.0))
    outdir = tempfile.mkdtemp(prefix=f"bench_scaling_{mode}_{ndev}_")
    sim = Simulation(cmd=cmd, releases=Releases(species=(sp,),
                                                boxes=(box,)),
                     grid=grid, met_backend=SyntheticMet(grid),
                     outgrid=og, outdir=outdir,
                     distributed=None if ndev == 1 else mode,
                     n_devices=None if ndev == 1 else ndev,
                     write_netcdf=False, write_npz=False)
    # warm: run once to compile, then measure a fresh run
    sim.run()
    psteps = sim.timings["particle_steps"] / sim.timings["wall"]
    print(json.dumps({
        "metric": f"scaling_{mode}", "n_devices": ndev,
        "particles": n, "value": round(psteps, 1),
        "unit": "particle-steps/s",
        "advance_s": round(sim.timings.get("advance", 0.0), 2),
        "wall_s": round(sim.timings["wall"], 2)}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="1,2,4")
    ap.add_argument("--modes", default="dp,tiles")
    ap.add_argument("--per-device", type=int, default=131072)
    ap.add_argument("--platform", default="gpu",
                    choices=("gpu", "cpu"))
    ap.add_argument("--single", nargs=2, metavar=("NDEV", "MODE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.single:
        run_point(int(args.single[0]), args.single[1], args.per_device,
                  args.platform)
        return

    devices = [int(d) for d in args.devices.split(",")]
    modes = args.modes.split(",")
    results = {}
    failed = []
    for mode in modes:
        for nd in devices:
            env = dict(os.environ)
            repo = os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))
            env["PYTHONPATH"] = (repo + os.pathsep
                                 + env.get("PYTHONPATH", ""))
            if args.platform == "cpu":
                env["XLA_FLAGS"] = (
                    env.get("XLA_FLAGS", "")
                    + f" --xla_force_host_platform_device_count={nd}")
            else:
                env["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, range(nd)))
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--single", str(nd), mode,
                 "--per-device", str(args.per_device),
                 "--platform", args.platform],
                env=env, capture_output=True, text=True,
                cwd=os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))))
            line = [ln for ln in out.stdout.splitlines()
                    if ln.startswith("{")]
            if out.returncode != 0 or not line:
                print(json.dumps({"metric": f"scaling_{mode}",
                                  "n_devices": nd, "error":
                                  out.stderr.strip()[-400:]}),
                      flush=True)
                failed.append((mode, nd))
                continue
            row = json.loads(line[-1])
            print(line[-1], flush=True)
            results[(mode, nd)] = row["value"]
    for mode in modes:
        base = results.get((mode, devices[0]))
        if not base:
            continue
        eff = {nd: round(results[(mode, nd)] / (base * nd / devices[0]),
                         3)
               for nd in devices if (mode, nd) in results}
        print(json.dumps({"metric": f"scaling_{mode}_efficiency",
                          "per_device_baseline": base,
                          "efficiency_vs_linear": eff,
                          "note": ("virtual CPU mesh: logic/overhead "
                                   "only, not hardware scaling"
                                   if args.platform == "cpu" else
                                   "hardware weak scaling")}),
              flush=True)
    if failed:
        sys.exit(f"failed points: {failed}")


if __name__ == "__main__":
    main()
