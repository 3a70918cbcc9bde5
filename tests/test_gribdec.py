"""Native GRIB decoder round-trip tests against messages synthesized
bit-by-bit from the WMO spec (no eccodes anywhere)."""
import struct

import numpy as np
import pytest

from flexpart_tpu.io import gribio


def _s16(v):
    """GRIB sign-magnitude 16-bit."""
    a = abs(int(v))
    if v < 0:
        a |= 0x8000
    return struct.pack(">H", a)


def _s32(v):
    a = abs(int(v))
    if v < 0:
        a |= 0x80000000
    return struct.pack(">I", a)


def _pack_bits(values, nbits):
    out = bytearray()
    acc = 0
    na = 0
    for v in values:
        acc = (acc << nbits) | int(v)
        na += nbits
        while na >= 8:
            out.append((acc >> (na - 8)) & 0xFF)
            na -= 8
    if na:
        out.append((acc << (8 - na)) & 0xFF)
    return bytes(out)


def encode_grib2_simple(field, lat1, lon1, dlat, dlon, disc, cat, num,
                        level_type, level, pv=(), nbits=16):
    """Minimal GRIB2 message: sections 0,1,3(3.0),4(4.0),5(5.0),6,7."""
    ny, nx = field.shape
    npts = nx * ny
    fmin = float(field.min())
    e_scale = 0
    rng = float(field.max()) - fmin
    scale = (2 ** nbits - 1) / rng if rng > 0 else 1.0
    # choose binary scale so ints fit in nbits
    import math
    e_scale = -int(math.floor(math.log2(scale))) if rng > 0 else 0
    ints = np.round((field.ravel() - fmin) / (2.0 ** e_scale)).astype(
        np.int64)
    ints = np.clip(ints, 0, 2 ** nbits - 1)

    def sec(num_, payload):
        return struct.pack(">IB", len(payload) + 5, num_) + payload

    s1 = sec(1, struct.pack(">HHBBBHBBBBB", 98, 0, 2, 1, 1, 2020, 1, 1,
                            0, 0, 0) + b"\x00\x01\x00")
    # section 3: grid definition template 3.0
    g = struct.pack(">BIBBH", 0, npts, 0, 0, 0)       # up to octet 14
    g += b"\x06" + b"\x00" * 15
    g += struct.pack(">II", nx, ny)
    g += struct.pack(">II", 0, 0)
    g += _s32(int(lat1 * 1e6))
    g += _s32(int(lon1 * 1e6))
    g += b"\x30"
    g += _s32(int((lat1 + (ny - 1) * dlat) * 1e6))
    g += _s32(int((lon1 + (nx - 1) * dlon) * 1e6))
    g += struct.pack(">I", int(dlon * 1e6))
    g += struct.pack(">I", int(dlat * 1e6))
    g += b"\x00"                                       # scanning mode
    s3 = sec(3, g)
    # section 4: product definition template 4.0 + pv
    p = struct.pack(">HH", len(pv), 0)
    p += struct.pack(">BB", cat, num)
    p += struct.pack(">BBBHBB", 0, 0, 0, 0, 0, 1)      # octets 12-18
    p += struct.pack(">I", 0)                          # forecast time
    p += struct.pack(">BBI", level_type, 0, level)
    p += struct.pack(">BBI", 255, 0, 0)                # second surface
    for v in pv:
        p += struct.pack(">f", v)
    s4 = sec(4, p)
    # section 5: template 5.0
    d = struct.pack(">IH", npts, 0)
    d += struct.pack(">f", fmin)
    d += _s16(e_scale) + _s16(0) + struct.pack(">BB", nbits, 0)
    s5 = sec(5, d)
    s6 = sec(6, b"\xff")                               # no bitmap
    s7 = sec(7, _pack_bits(ints, nbits))
    body = s1 + s3 + s4 + s5 + s6 + s7
    total = 16 + len(body) + 4
    s0 = b"GRIB" + b"\x00\x00" + bytes([disc, 2]) + struct.pack(">Q",
                                                                total)
    return s0 + body + b"7777"


def encode_grib1_simple(field, lat1, lon1, dlat, dlon, param, level_type,
                        level, pv=(), nbits=16):
    ny, nx = field.shape
    fmin = float(field.min())
    rng = float(field.max()) - fmin
    import math
    e_scale = -int(math.floor(math.log2((2 ** nbits - 1) / rng))) \
        if rng > 0 else 0
    ints = np.clip(np.round((field.ravel() - fmin) / 2.0 ** e_scale),
                   0, 2 ** nbits - 1).astype(np.int64)

    def ibm32(x):
        if x == 0:
            return b"\x00" * 4
        sign = 0x80000000 if x < 0 else 0
        x = abs(x)
        e = 64
        while x >= 1.0:
            x /= 16.0
            e += 1
        while x < 1.0 / 16.0:
            x *= 16.0
            e -= 1
        mant = int(x * 16777216.0)
        return struct.pack(">I", sign | (e << 24) | mant)

    pds = struct.pack(">BBBBBBBH", 128, 98, 1, 255, 0x80, param,
                      level_type, level)
    pds += bytes([20, 1, 1, 0, 0, 1, 0, 0, 0])         # date/time/range
    pds += b"\x00\x00\x00"                             # octets 22-24
    pds += bytes([21])                                 # century
    pds += b"\x00" + _s16(0)                           # subcentre, D
    pds = struct.pack(">I", len(pds) + 3)[1:] + pds

    gds = struct.pack(">BB", len(pv), 33 if pv else 255)
    gds += b"\x00"                                     # type 0 latlon
    gds += struct.pack(">HH", nx, ny)
    def s3b(v):
        a = int(round(abs(v) * 1000))
        if v < 0:
            a |= 0x800000
        return struct.pack(">I", a)[1:]
    gds += s3b(lat1) + s3b(lon1) + b"\x80"
    gds += s3b(lat1 + (ny - 1) * dlat) + s3b(lon1 + (nx - 1) * dlon)
    gds += struct.pack(">HH", int(dlon * 1000), int(dlat * 1000))
    gds += b"\x00" + b"\x00" * 4                       # scan + reserved
    for v in pv:
        gds += ibm32(v)
    gds = struct.pack(">I", len(gds) + 3)[1:] + gds

    data_bits = _pack_bits(ints, nbits)
    bds = struct.pack(">B", 0) + _s16(e_scale) \
        + ibm32(fmin) + bytes([nbits]) + data_bits
    if len(bds) % 2:
        bds += b"\x00"
    bds = struct.pack(">I", len(bds) + 3)[1:] + bds

    body = pds + gds + bds + b"7777"
    total = 8 + len(body)
    head = b"GRIB" + struct.pack(">I", total)[1:] + b"\x01"
    return head + body


@pytest.fixture(scope="module")
def field():
    ny, nx = 19, 36
    y, x = np.mgrid[0:ny, 0:nx]
    return (280.0 + 20.0 * np.sin(x / 5.0) * np.cos(y / 3.0)).astype(
        np.float64)


def test_grib2_roundtrip(tmp_path, field):
    pv = [0.0, 5000.0, 10000.0, 1.0, 0.6, 0.1]
    msg = encode_grib2_simple(field, lat1=-90.0, lon1=0.0, dlat=10.0,
                              dlon=10.0, disc=0, cat=0, num=0,
                              level_type=105, level=3, pv=pv)
    p = tmp_path / "t.grib2"
    p.write_bytes(msg + msg)      # two messages in one file
    msgs = gribio.scan(p)
    assert len(msgs) == 2
    m = msgs[0]
    assert m.edition == 2
    assert m.param == 0           # discipline 0, cat 0, num 0 = T
    assert (m.nx, m.ny) == (36, 19)
    assert m.level_type == 105 and m.level == 3
    np.testing.assert_allclose(m.pv, pv, rtol=1e-6)
    vals = m.values()
    np.testing.assert_allclose(vals, field, atol=2e-3)


def test_grib1_roundtrip(tmp_path, field):
    pv = [0.0, 3000.0, 1.0, 0.5]
    msg = encode_grib1_simple(field, lat1=-90.0, lon1=0.0, dlat=10.0,
                              dlon=10.0, param=130, level_type=109,
                              level=5, pv=pv)
    p = tmp_path / "t.grib1"
    p.write_bytes(msg)
    msgs = gribio.scan(p)
    assert len(msgs) == 1
    m = msgs[0]
    assert m.edition == 1
    assert m.param == 130         # T in ECMWF table 128
    assert m.level_type == 109 and m.level == 5
    assert (m.nx, m.ny) == (36, 19)
    np.testing.assert_allclose(m.pv, pv, rtol=1e-6)
    vals = m.values()
    np.testing.assert_allclose(vals, field, atol=2e-3)


def _full_windfield_grib(path, tsec, nx=36, ny=19, nlev=8):
    """Synthesize a COMPLETE ECMWF-style wind-field GRIB2 file: T/u/v/q/
    etadot on all model levels + the full surface set."""
    from flexpart_tpu.met.grid import hybrid_coefficients
    akm, bkm = hybrid_coefficients(nlev + 1)
    # GRIB pv is top-down
    pv = list(akm[::-1]) + list(bkm[::-1])
    y, x = np.mgrid[0:ny, 0:nx]
    lat = -90.0 + y * 10.0
    blobs = []

    def ml(disc, cat, num, lev, f):
        blobs.append(encode_grib2_simple(
            f, lat1=-90.0, lon1=0.0, dlat=10.0, dlon=10.0, disc=disc,
            cat=cat, num=num, level_type=105, level=lev, pv=pv))

    for lev in range(1, nlev + 1):       # GRIB level 1 = top
        zfrac = 1.0 - (lev - 1) / nlev
        ml(0, 0, 0, lev, 288.0 - 60.0 * zfrac
           - 30.0 * np.sin(np.deg2rad(lat)) ** 2)                 # T
        ml(0, 2, 2, lev, 10.0 * zfrac + 0.0 * x)                  # U
        ml(0, 2, 3, lev, 1.0 + 0.0 * x)                           # V
        ml(0, 1, 0, lev, 0.005 * (1 - zfrac) + 0.0 * x)           # Q
        ml(0, 2, 32, lev, 0.0 * x)                                # etadot

    def sfc(disc, cat, num, level_type, f):
        blobs.append(encode_grib2_simple(
            f, lat1=-90.0, lon1=0.0, dlat=10.0, dlon=10.0, disc=disc,
            cat=cat, num=num, level_type=level_type, level=0))

    ps = 101325.0 - 100.0 * np.sin(np.deg2rad(lat)) ** 2
    sfc(0, 3, 0, 1, ps)                                           # SP
    sfc(0, 0, 0, 103, 288.0 - 30.0 * np.sin(np.deg2rad(lat)) ** 2)  # 2T
    sfc(0, 0, 6, 103, 283.0 - 30.0 * np.sin(np.deg2rad(lat)) ** 2)  # 2D
    sfc(0, 2, 2, 103, 4.0 + 0.0 * x)                              # 10U
    sfc(0, 2, 3, 103, 0.5 + 0.0 * x)                              # 10V
    sfc(0, 0, 11, 1, -100000.0 + 0.0 * x)                         # SSHF J/m2
    sfc(0, 4, 9, 1, 720000.0 + 0.0 * x)                           # SSR
    sfc(0, 1, 9, 1, 0.0005 + 0.0 * x)                             # LSP [m]
    sfc(0, 1, 10, 1, 0.0002 + 0.0 * x)                            # CP
    sfc(0, 6, 1, 1, 0.5 + 0.0 * x)                                # TCC
    sfc(0, 1, 11, 1, 0.0 * x)                                     # SDE
    sfc(0, 3, 4, 1, 981.0 + 0.0 * x)                              # ORO*g
    sfc(0, 3, 7, 1, 50.0 + 0.0 * x)                               # SDO
    sfc(2, 0, 0, 1, (np.sin(np.deg2rad(lat)) > 0.3) * 1.0)        # LSM
    sfc(0, 2, 38, 1, 360.0 + 0.0 * x)                             # EWSS
    sfc(0, 2, 37, 1, 36.0 + 0.0 * x)                              # NSSS
    path.write_bytes(b"".join(blobs))


def test_grib_met_backend_end_to_end(tmp_path):
    """Full chain: synthesized GRIB archive -> native decoder -> GribMet
    -> Simulation run."""
    from flexpart_tpu.config import (Command, OutGrid, ReleaseBox,
                                     Releases, Species, WindFieldEntry)
    from flexpart_tpu.met.gribmet import GribMet
    from flexpart_tpu.run.simulation import Simulation
    from datetime import datetime
    import jax.numpy as jnp

    met = tmp_path / "met"
    met.mkdir()
    entries = []
    for h in range(4):
        f = met / f"EN2020010100{h}"
        _full_windfield_grib(f, h * 3600)
        entries.append(WindFieldEntry(
            time=datetime(2020, 1, 1, h), filename=f.name))
    backend = GribMet(metdata=met, entries=tuple(entries),
                      bdate=datetime(2020, 1, 1))
    grid = backend.grid()
    assert grid.nlev == 9 and grid.ny == 19
    eta = backend.fetch(0.0)
    assert float(eta.ps.max()) > 1.0e5
    assert abs(float(eta.tth[1].mean()) - float(eta.tt2.mean())) < 30.0
    # u increases downward-to-upward per construction (zfrac)
    assert float(eta.uuh[1].mean()) < float(eta.uuh[-1].mean())

    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101,
                  ietime=20000, lsynctime=900, loutstep=3600,
                  loutaver=3600, loutsample=900, lconvection=0)
    box = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                     itime2=0, lon1=100.0, lon2=110.0, lat1=-10.0,
                     lat2=0.0, z1=100.0, z2=500.0, mass=(1.0,),
                     parts=300)
    og = OutGrid(outlon0=0.0, outlat0=-90.0, numxgrid=36, numygrid=18,
                 dxout=10.0, dyout=10.0,
                 outheights=(500.0, 2000.0, 50000.0))
    sim = Simulation(cmd=cmd, releases=Releases(species=(Species(),),
                                                boxes=(box,)),
                     grid=grid, met_backend=backend, outgrid=og,
                     outdir=str(tmp_path / "out"), write_netcdf=False,
                     wind_interval=backend.wind_interval, seed=2)
    sim.run()
    act = np.asarray(sim.particles.active)
    assert act.sum() == 300
    assert np.isfinite(np.asarray(sim.particles.z)).all()
    assert float(jnp.sum(sim.particles.mass)) == pytest.approx(1.0,
                                                               rel=1e-3)


def test_nxshift_rotation(tmp_path):
    """nxshift rotates the grid origin (shift_field.f90): the value at a
    fixed GEOGRAPHIC longitude must be identical however the seam is
    placed."""
    from flexpart_tpu.met.gribmet import eta_from_grib, grid_from_grib

    f = tmp_path / "EN20200101000000"
    _full_windfield_grib(f, 0)
    g0 = grid_from_grib(f)
    g9 = grid_from_grib(f, nxshift=9)      # 90 deg east
    assert g9.xlon0 == g0.xlon0 + 90.0
    e0 = eta_from_grib(f, g0)
    e9 = eta_from_grib(f, g9, nxshift=9)
    t0 = np.asarray(e0.tth[2])
    t9 = np.asarray(e9.tth[2])
    nxf = g0.nx - 1
    for lon in (0.0, 120.0, 250.0):
        j0 = int((lon - g0.xlon0) / g0.dx) % nxf
        j9 = int((lon - g9.xlon0 + 360.0) / g9.dx) % nxf
        np.testing.assert_allclose(t9[:, j9], t0[:, j0], rtol=1e-6)
    # cyclic duplicate column still consistent
    np.testing.assert_allclose(t9[:, -1], t9[:, 0])


def test_build_failure_names_the_command(monkeypatch):
    """libgribdec.so is built from source at first use; when the tool
    chain is missing the error says which command to run."""
    def no_make(*a, **k):
        raise FileNotFoundError("make")
    monkeypatch.setattr(gribio.subprocess, "run", no_make)
    with pytest.raises(OSError, match=r"make -s -B -C .*native/gribdec"):
        gribio._build_lib()
