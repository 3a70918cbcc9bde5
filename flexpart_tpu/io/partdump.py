"""Particle dumps + warm start + full checkpointing.

Two layers:
  * reference-compatible `partposit_*` files (Fortran unformatted
    little-endian records, exactly partoutput.f90:160-168's layout:
    itime record, then one record per live particle with
    (npoint, lon, lat, z, itramem, topo, pv, qv, rho, hmix, tropo, T,
    mass...), sentinel -99999 record) — readable by FLEXPART
    post-processing tools, and readable back for IPIN=1 warm starts
    (readpartpositions.f90:88-131), including dumps produced by the
    reference binary itself;
  * a native full checkpoint (.npz) carrying the complete SoA particle
    state, RNG key, accumulators and convective CBMF memory — resume is
    bit-exact, strictly stronger than the reference's warm start which
    loses turbulence memory and accumulated grids (SURVEY.md §5).
"""

from __future__ import annotations

import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ..core.interp import (horiz_weights, interp_2d, vert_weights)
from ..core.state import ITRA_INACTIVE, Particles, empty_particles
from ..met.fields import (F2_HMIX, F2_ORO, F2_TROPO, F3_PV, F3_QV, F3_RHO,
                          F3_TT, F3_U, F3_V)


@jax.jit
def particle_diagnostics(p: Particles, z0, z1, tw0, tw1):
    """Met quantities at each particle for the dump record
    (partoutput.f90:90-158): topo, pv, qv, rho, hmix, tropopause, T."""
    ny, nx = z0.f2d.shape[1], z0.f2d.shape[2]
    hw = horiz_weights(p.x, p.y, nx, ny, False)
    f2_0 = interp_2d(z0.f2d, (F2_ORO, F2_HMIX, F2_TROPO), hw)
    f2_1 = interp_2d(z1.f2d, (F2_ORO, F2_HMIX, F2_TROPO), hw)
    topo, hmix, tropo = f2_0 * tw0 + f2_1 * tw1
    indz, dz1 = vert_weights(p.z, z0.height)

    def interp3(zf, fid):
        flat = zf.f3d[fid].reshape(zf.f3d.shape[1], -1)
        # f32 HIGHEST: a default-precision dot may run in TF32 on Hopper
        prec = jax.lax.Precision.HIGHEST
        lo = jnp.einsum("nc,nc->n", flat[indz[:, None], hw.idx4], hw.p4,
                        precision=prec)
        hi = jnp.einsum("nc,nc->n", flat[indz[:, None] + 1, hw.idx4], hw.p4,
                        precision=prec)
        return lo * (1.0 - dz1) + hi * dz1

    pv = interp3(z0, F3_PV) * tw0 + interp3(z1, F3_PV) * tw1
    qv = interp3(z0, F3_QV) * tw0 + interp3(z1, F3_QV) * tw1
    rho = interp3(z0, F3_RHO) * tw0 + interp3(z1, F3_RHO) * tw1
    tt = interp3(z0, F3_TT) * tw0 + interp3(z1, F3_TT) * tw1
    return topo, pv, qv, rho, hmix, tropo, tt


def write_partposit(path, itime: int, p: Particles, grid, diag,
                    only_current: bool = True):
    """Write one reference-format particle dump.  diag = output of
    particle_diagnostics (host numpy ok)."""
    topo, pv, qv, rho, hmix, tropo, tt = (np.asarray(d) for d in diag)
    live = np.asarray(p.active)
    if only_current:
        live = live & (np.asarray(p.itra) == itime)
    x = np.asarray(p.x)
    y = np.asarray(p.y)
    z = np.asarray(p.z)
    npoint = np.asarray(p.npoint)
    itramem = np.asarray(p.itramem)
    mass = np.asarray(p.mass)
    nspec = mass.shape[1]

    def rec(payload: bytes):
        return struct.pack("<i", len(payload)) + payload \
            + struct.pack("<i", len(payload))

    with open(path, "wb") as f:
        f.write(rec(struct.pack("<i", int(itime))))
        idx = np.nonzero(live)[0]
        lon = grid.xlon0 + x * grid.dx
        lat = grid.ylat0 + y * grid.dy
        for i in idx:
            vals = [int(npoint[i]) + 1, float(lon[i]), float(lat[i]),
                    float(z[i]), int(itramem[i]), float(topo[i]),
                    float(pv[i]), float(qv[i]), float(rho[i]),
                    float(hmix[i]), float(tropo[i]), float(tt[i])] \
                + [float(m) for m in mass[i]]
            payload = struct.pack("<ifffi", *vals[:5]) \
                + struct.pack("<%df" % (7 + nspec), *vals[5:])
            f.write(rec(payload))
        sent = struct.pack("<ifffi", -99999, -9999.9, -9999.9, -9999.9,
                           -99999) \
            + struct.pack("<%df" % (7 + nspec), *([-9999.9] * (7 + nspec)))
        f.write(rec(sent))


def read_partposit(path, nspec: int):
    """Parse a partposit file (ours or the reference binary's).
    Returns (itime, dict of arrays)."""
    data = Path(path).read_bytes()
    off = 0

    def rec():
        nonlocal off
        (n,) = struct.unpack_from("<i", data, off)
        payload = data[off + 4: off + 4 + n]
        off += 8 + n
        return payload

    itime = struct.unpack("<i", rec())[0]
    rows = []
    while off < len(data):
        payload = rec()
        head = struct.unpack_from("<ifffi", payload, 0)
        if head[0] == -99999:
            break
        rest = struct.unpack_from("<%df" % (7 + nspec), payload, 20)
        rows.append(head + rest)
    if not rows:
        return itime, {}
    a = np.array(rows)
    return itime, dict(
        npoint=a[:, 0].astype(np.int32) - 1, lon=a[:, 1], lat=a[:, 2],
        z=a[:, 3], itramem=a[:, 4].astype(np.int32),
        mass=a[:, 12:12 + nspec])


def particles_from_partposit(path, nspec: int, grid, capacity: int,
                             nclassunc: int = 1, seed: int = 7):
    """Warm start (IPIN=1): rebuild the SoA particle state from a dump
    (readpartpositions.f90:100-131).  Turbulence memory restarts at zero
    (the reference re-draws it via `initialize`)."""
    itime, d = read_partposit(path, nspec)
    n = len(d["z"]) if d else 0
    if capacity < n:
        raise ValueError(f"capacity {capacity} < dumped particles {n}")
    p = empty_particles(capacity, nspec)
    if n == 0:
        return itime, p
    rng = np.random.default_rng(seed)
    x = (d["lon"] - grid.xlon0) / grid.dx
    y = (d["lat"] - grid.ylat0) / grid.dy
    idx = np.arange(n)
    return itime, p._replace(
        x_hi=p.x_hi.at[idx].set(x.astype(np.float32)),
        y_hi=p.y_hi.at[idx].set(y.astype(np.float32)),
        z=p.z.at[idx].set(d["z"].astype(np.float32)),
        itra=p.itra.at[idx].set(0),
        itramem=p.itramem.at[idx].set(d["itramem"]),
        npoint=p.npoint.at[idx].set(d["npoint"]),
        nclass=p.nclass.at[idx].set(
            rng.integers(0, nclassunc, size=n).astype(np.int32)),
        mass=p.mass.at[idx].set(d["mass"].astype(np.float32)),
        mass0=p.mass0.at[idx].set(d["mass"].astype(np.float32)),
        active=p.active.at[idx].set(True),
    )


# ---------------------------------------------------------------------------
# native full checkpoint
# ---------------------------------------------------------------------------

def save_checkpoint(path, sim, itime: int):
    """Full state: particles + accumulators + RNG + CBMF (SURVEY.md §5:
    strictly better than the reference warm start)."""
    state = {"itime": np.int64(itime),
             "key": np.asarray(sim._key)}
    for name, arr in sim.particles._asdict().items():
        state["p_" + name] = np.asarray(arr)
    for name, arr in sim.acc._asdict().items():
        state["acc_" + name] = np.asarray(arr)
    if getattr(sim, "use_convection", False):
        state["cbmf"] = np.asarray(sim.cbmf)
    if sim._height is not None:
        # the fixed vertical grid is derived from the FIRST met field
        # seen (verttransform_ecmwf.f90:153-165 one-time init); persist
        # it so a resumed run interpolates on the identical grid
        state["height"] = np.asarray(sim._height)
    if getattr(sim, "_boundary", None) is not None:
        # regional domain-fill boundary state: geometry + accumulated
        # inflow mass (the reference's unitboundcond dump,
        # init_domainfill.f90:400-410)
        for name, arr in sim._boundary._asdict().items():
            state["bnd_" + name] = np.asarray(arr)
    np.savez_compressed(path, **state)


def load_checkpoint(path, sim):
    """Restore a checkpoint into a Simulation; returns resume itime."""
    d = np.load(path)
    sim.particles = Particles(**{
        name: jnp.asarray(d["p_" + name])
        for name in Particles._fields})
    from ..grid.outgrid import Accumulators
    sim.acc = Accumulators(**{
        name: jnp.asarray(d["acc_" + name])
        for name in Accumulators._fields})
    sim._key = jnp.asarray(d["key"])
    if "height" in d:
        sim._height = jnp.asarray(d["height"])
    if "cbmf" in d and getattr(sim, "use_convection", False):
        sim.cbmf = jnp.asarray(d["cbmf"])
    if "bnd_acc" in d:
        from ..core.domainfill import BoundaryState
        sim._boundary = BoundaryState(**{
            name: jnp.asarray(d["bnd_" + name])
            for name in BoundaryState._fields})
    return int(d["itime"])


def write_shortposit(path, itime: int, p: Particles, grid, topo,
                     region=(-140.0, 60.0, 10.0, 90.0)):
    """Quasilagrangian compressed dump (partoutput_short.f90:95-135):
    int16-packed (lon*180, lat*360, z+topo) + int32 npoint per particle,
    for particles inside `region` (the reference hardcodes the extended
    North Atlantic (-140..60 E, >10 N); parametrized here) with mass>0."""
    live = np.asarray(p.active) & (np.asarray(p.itra) == itime)
    lon = grid.xlon0 + np.asarray(p.x) * grid.dx
    lon = np.where(lon > 180.0, lon - 360.0, lon)
    lon = np.where(lon < -180.0, lon + 360.0, lon)
    lat = grid.ylat0 + np.asarray(p.y) * grid.dy
    topo = np.asarray(topo)
    x1, x2, y1, y2 = region
    sel = (live & (lon > x1) & (lon < x2) & (lat > y1) & (lat < y2)
           & (np.asarray(p.mass[:, 0]) > 0.0))
    idx = np.nonzero(sel)[0]
    n = len(idx)
    i2 = np.empty((n, 3), "<i2")
    i2[:, 0] = np.rint(lon[idx] * 180.0)
    i2[:, 1] = np.rint(lat[idx] * 360.0)
    i2[:, 2] = np.rint(np.minimum(np.asarray(p.z)[idx] + topo[idx],
                                  32766.0))
    i4 = (np.asarray(p.npoint)[idx] + 1).astype("<i4")

    def rec(payload: bytes) -> bytes:
        return struct.pack("<i", len(payload)) + payload \
            + struct.pack("<i", len(payload))

    # third record interleaves (i4, 3xi2) per particle (one write stmt)
    body = b"".join(i4[k].tobytes() + i2[k].tobytes() for k in range(n))
    with open(path, "wb") as f:
        f.write(rec(struct.pack("<i", int(itime))))
        f.write(rec(struct.pack("<i", n)))
        f.write(rec(body))


@jax.jit
def averaging_sample(p: Particles, z0, z1, tw0, tw1, dx, dy, xlon0, ylat0):
    """One accumulation step for ipout=3 time-averaged particle output
    (partpos_average.f90): returns the (13, N) per-particle sample
    [cartx, carty, cartz, z, topo, pv, qv, tt, uu, vv, rho, tropo, hmix]
    (positions averaged on the Cartesian unit sphere so means don't wrap
    through the dateline) and the live mask."""
    ny, nx = z0.f2d.shape[1], z0.f2d.shape[2]
    hw = horiz_weights(p.x, p.y, nx, ny, False)
    f2_0 = interp_2d(z0.f2d, (F2_ORO, F2_HMIX, F2_TROPO), hw)
    f2_1 = interp_2d(z1.f2d, (F2_ORO, F2_HMIX, F2_TROPO), hw)
    topo, hmix, tropo = f2_0 * tw0 + f2_1 * tw1
    indz, dz1 = vert_weights(p.z, z0.height)

    def interp3(zf, fid):
        flat = zf.f3d[fid].reshape(zf.f3d.shape[1], -1)
        # f32 HIGHEST: a default-precision dot may run in TF32 on Hopper
        prec = jax.lax.Precision.HIGHEST
        lo = jnp.einsum("nc,nc->n", flat[indz[:, None], hw.idx4], hw.p4,
                        precision=prec)
        hi = jnp.einsum("nc,nc->n", flat[indz[:, None] + 1, hw.idx4],
                        hw.p4, precision=prec)
        return lo * (1.0 - dz1) + hi * dz1

    def t3(fid):
        return interp3(z0, fid) * tw0 + interp3(z1, fid) * tw1

    pv, qv, tt, uu, vv, rho = (t3(f) for f in
                               (F3_PV, F3_QV, F3_TT, F3_U, F3_V, F3_RHO))
    lon = (xlon0 + p.x * dx) * jnp.pi / 180.0
    lat = (ylat0 + p.y * dy) * jnp.pi / 180.0
    cosla = jnp.cos(lat)
    cartx, carty, cartz = (cosla * jnp.sin(lon), -cosla * jnp.cos(lon),
                           jnp.sin(lat))
    sample = jnp.stack([cartx, carty, cartz, p.z, topo, pv, qv, tt,
                        uu, vv, rho, tropo, hmix])
    return sample, p.active


def write_partposit_average(path, itime: int, p: Particles, sums,
                            counts):
    """ipout=3 compressed averaged dump (partoutput_average.f90:61-198):
    24-byte direct-access records, one per particle slot, of 12 int16:
    lon*180, lat*360, 2z-32000, 2topo-32000, 2tropo-32000, 2hmix-32000,
    20000rho-32000, 1e6qv-32000, 100pv, 300(T-273.15), 200u, 200v."""
    sums = np.asarray(sums)
    counts = np.maximum(np.asarray(counts, np.float32), 1.0)
    avg = sums / counts
    live = np.asarray(p.active) & (np.asarray(p.itra) == itime)
    (cartx, carty, cartz, z, topo, pv, qv, tt, uu, vv, rho, tropo,
     hmix) = avg
    lon = np.degrees(np.arctan2(cartx, -carty))
    lat = np.degrees(np.arctan2(cartz, np.hypot(cartx, carty)))
    lon = np.where(lon > 180.0, lon - 360.0, lon)
    lon = np.where(lon < -180.0, lon + 360.0, lon)

    def clip16(v):
        return np.clip(np.rint(v), -32766, 32766).astype("<i2")

    recs = np.zeros((len(lon), 12), "<i2")
    recs[:, 0] = clip16(lon * 180.0)
    recs[:, 1] = clip16(lat * 360.0)
    recs[:, 2] = clip16(z * 2.0 - 32000.0)
    recs[:, 3] = clip16(topo * 2.0 - 32000.0)
    recs[:, 4] = clip16(tropo * 2.0 - 32000.0)
    recs[:, 5] = clip16(hmix * 2.0 - 32000.0)
    recs[:, 6] = clip16(rho * 20000.0 - 32000.0)
    recs[:, 7] = clip16(qv * 1.0e6 - 32000.0)
    recs[:, 8] = clip16(pv * 100.0)
    recs[:, 9] = clip16((tt - 273.15) * 300.0)
    recs[:, 10] = clip16(uu * 200.0)
    recs[:, 11] = clip16(vv * 200.0)
    recs[~live] = 0   # direct-access file: dead slots stay zeroed
    Path(path).write_bytes(recs.tobytes())
