"""ctypes binding for the native GRIB decoder (native/gribdec).

High-level API: iterate a GRIB file's messages with metadata, decode
fields into numpy arrays — the replacement for the reference's eccodes
dependency (readwind_ecmwf.f90:50).  The shared library is built from
`native/gribdec/gribdec.cpp` with `make -C native/gribdec` at first use.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC_DIR = Path(__file__).resolve().parents[2] / "native" / "gribdec"
_LIB_PATH = _SRC_DIR / "libgribdec.so"


def _build_lib() -> None:
    """`make -C native/gribdec` into a private name, then an atomic rename:
    concurrent first users (test workers) never load a half-written file."""
    tmp = f".libgribdec.{os.getpid()}.so"
    cmd = ["make", "-s", "-B", "-C", str(_SRC_DIR), f"OUT={tmp}", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise OSError(
            f"building libgribdec.so failed: `{' '.join(cmd)}` (needs make "
            f"and g++; libaec optional for CCSDS-packed GRIB2): "
            f"{detail.strip()}") from e
    os.replace(_SRC_DIR / tmp, _LIB_PATH)


@functools.lru_cache(maxsize=1)
def _lib():
    src = _SRC_DIR / "gribdec.cpp"
    if (not _LIB_PATH.exists()
            or _LIB_PATH.stat().st_mtime < src.stat().st_mtime):
        _build_lib()
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.gribdec_scan.restype = ctypes.c_long
    lib.gribdec_scan.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_long),
                                 ctypes.POINTER(ctypes.c_long),
                                 ctypes.c_long]
    lib.gribdec_info.restype = ctypes.c_long
    lib.gribdec_info.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                 ctypes.c_long,
                                 ctypes.POINTER(ctypes.c_longlong),
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.c_long]
    lib.gribdec_decode.restype = ctypes.c_long
    lib.gribdec_decode.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                   ctypes.c_long,
                                   ctypes.POINTER(ctypes.c_double),
                                   ctypes.c_long]
    return lib


@dataclasses.dataclass
class GribMessage:
    path: str
    offset: int
    length: int
    edition: int
    param: int            # GRIB1: indicatorOfParameter;
                          # GRIB2: discipline*1000000+category*1000+number
    level_type: int
    level: int
    nx: int
    ny: int
    lat1: float
    lon1: float
    lat2: float
    lon2: float
    dlat: float
    dlon: float
    pv: np.ndarray        # hybrid coefficients (may be empty)
    date: int
    time: int
    step: int

    def values(self) -> np.ndarray:
        """Decode the field, (ny, nx), north-south order as stored."""
        lib = _lib()
        n = self.nx * self.ny
        out = np.empty(n, np.float64)
        rc = lib.gribdec_decode(
            self.path.encode(), self.offset, self.length,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
        if rc < 0:
            raise ValueError(f"gribdec_decode failed ({rc}) for "
                             f"param {self.param} in {self.path}")
        return out.reshape(self.ny, self.nx)


def scan(path, max_messages: int = 8192) -> list[GribMessage]:
    """All messages of a GRIB file with metadata (no data decode)."""
    lib = _lib()
    offs = np.empty(max_messages, np.int64)
    lens = np.empty(max_messages, np.int64)
    n = lib.gribdec_scan(
        str(path).encode(),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        max_messages)
    msgs = []
    ivals = (ctypes.c_longlong * 10)()
    dvals = (ctypes.c_double * 6)()
    pvbuf = np.empty(1024, np.float64)
    for i in range(n):
        npv = lib.gribdec_info(
            str(path).encode(), int(offs[i]), int(lens[i]), ivals, dvals,
            pvbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 1024)
        if npv < 0:
            continue
        msgs.append(GribMessage(
            path=str(path), offset=int(offs[i]), length=int(lens[i]),
            edition=ivals[0], param=ivals[1], level_type=ivals[2],
            level=ivals[3], nx=ivals[4], ny=ivals[5],
            lat1=dvals[0], lon1=dvals[1], lat2=dvals[2], lon2=dvals[3],
            dlat=dvals[4], dlon=dvals[5],
            pv=pvbuf[:npv].copy(), date=ivals[7], time=ivals[8],
            step=ivals[9]))
    return msgs
