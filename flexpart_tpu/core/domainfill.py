"""Domain-filling mode (MDOMAINFILL=1/2).

Re-design of init_domainfill.f90: the (global or windowed) domain is
filled with particles of equal air mass, distributed horizontally
proportional to the air column mass and vertically uniform in pressure;
MDOMAINFILL=2 keeps only stratospheric particles (z > 3 km, |PV| >
pvcrit) and weights their mass by the PV-based ozone proxy.  The
reference's triple nested loop with per-particle goto bookkeeping
becomes a handful of vectorized numpy passes (runs once at init,
host-side).

REGIONAL domain-filling adds boundary conditions
(boundcond_domainfill.f90): particles crossing the window edge are
destroyed, and air-mass flux through every boundary-column layer is
accumulated each step; whenever a layer's accumulated inflow reaches one
particle-mass, a particle is created on the boundary face.  Vectorized
re-design: the boundary geometry (layer thicknesses, face areas,
vertical interpolation indices at the fixed zcolumn heights) is
time-invariant, so it is flattened once at init into a static "site
table"; the per-step work is then a single jitted kernel — two gathers
from the met stack, the flux/accumulator update, and prefix-sum free-
slot allocation (same pattern as core/split.py) with a small fixed
number of emission rounds per step (overflow stays in the accumulator
and is emitted next step, preserving mass exactly).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GA, PI, PI180, R_AIR, R_EARTH
from ..met.fields import F3_PV, F3_RHO, F3_TT, F3_U, F3_V
from .state import ITRA_INACTIVE, Particles, empty_particles

PVCRIT = 2.0           # par_mod pvcrit [pvu]
OZONESCALE = 60.0      # ng O3 / m3 / pvu (par_mod)
M_PER_DEG = 111198.5   # metres per degree latitude (boundcond:77-81)
KMAX_EMIT = 4          # max particles emitted per site per step


def _gridarea(grid) -> np.ndarray:
    """Cell areas per latitude row (init_domainfill.f90:44-85), with the
    pole-cap rows treated as spherical caps."""
    jy = np.arange(grid.ny)
    ylat = grid.ylat0 + jy * grid.dy
    ylatp = np.minimum(ylat + 0.5 * grid.dy, 90.0)
    ylatm = np.maximum(ylat - 0.5 * grid.dy, -90.0)
    cosp = np.cos(np.deg2rad(ylatp)) * R_EARTH
    cosm = np.cos(np.deg2rad(ylatm)) * R_EARTH
    opposite = (ylatm < 0.0) & (ylatp > 0.0)
    hzone = np.where(
        opposite,
        R_EARTH * np.deg2rad(grid.dy),
        np.abs(np.sqrt(np.maximum(R_EARTH ** 2 - cosp ** 2, 0.0))
               - np.sqrt(np.maximum(R_EARTH ** 2 - cosm ** 2, 0.0))))
    return 2.0 * PI * R_EARTH * hzone * grid.dx / 360.0


def init_domainfill(grid, zf, npart: int, mdomainfill: int = 1,
                    nclassunc: int = 1, seed: int = 17,
                    capacity: int | None = None, window=None):
    """Build the filled-domain particle population from the first wind
    field.  Returns (Particles, total_air_mass_kg, BoundaryState|None).

    ``window`` = (x1, x2, y1, y2) in mother-grid units (the release box,
    init_domainfill.f90:54-57).  When it covers the whole domain the run
    is global (gdomainfill) and no boundary state is needed; otherwise
    the fill is restricted to the window and a BoundaryState for
    boundcond_domainfill is returned."""
    rho = np.asarray(zf.f3d[F3_RHO])          # (nz, ny, nx)
    tt = np.asarray(zf.f3d[F3_TT])
    pv = np.asarray(zf.f3d[F3_PV])
    height = np.asarray(zf.height)
    nz, ny, nx = rho.shape
    nxm = nx - 1 if grid.xglobal else nx      # skip duplicated column
    rng = np.random.default_rng(seed)

    # regional window (init_domainfill.f90:54-78)
    nx_we = [0, nxm - 1]
    ny_sn = [0, ny - 1]
    gdomainfill = True
    if window is not None:
        x1, x2, y1, y2 = window
        nx_we = [max(int(x1), 0), min(int(x2) + 1, nx - 1)]
        ny_sn = [max(int(y1), 0), min(int(y2) + 1, ny - 1)]
        if grid.xglobal:
            nx_we[1] = min(nx_we[1], nx - 2)
        gdomainfill = (nx_we == [0, nx - 2 if grid.xglobal else nx - 1]
                       and ny_sn == [0, ny - 1])
        if gdomainfill:
            nx_we = [0, nxm - 1]

    # pseudo-pressure profile p(kz) = rho*R*T (init_domainfill.f90:92-98)
    pp = rho * R_AIR * tt                      # (nz, ny, nx)
    area = _gridarea(grid)                     # (ny,)
    colmass = (pp[0] - pp[-1]) / GA * area[:, None]      # (ny, nx)
    colmass = colmass[:, :nxm]
    if not gdomainfill:
        inwin = np.zeros((ny, nxm), bool)
        inwin[ny_sn[0]:ny_sn[1] + 1, nx_we[0]:nx_we[1] + 1] = True
        colmass = np.where(inwin, colmass, 0.0)
    total = float(colmass.sum())

    ncolumn = np.rint(0.999 * npart * colmass / total).astype(np.int64)
    n_total = int(ncolumn.sum())

    # expand to per-particle column indices
    flat_cols = np.nonzero(ncolumn.ravel())[0]
    counts = ncolumn.ravel()[flat_cols]
    col_of = np.repeat(flat_cols, counts)              # (N,)
    jy = (col_of // nxm).astype(np.int64)
    ix = (col_of % nxm).astype(np.int64)
    # index-within-column 0..ncolumn-1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    j_in = np.arange(n_total) - np.repeat(starts, counts)

    pp1 = pp[0, jy, ix]
    ppn = pp[-1, jy, ix]
    ncol_p = np.repeat(counts, counts).astype(np.float64)
    deltacol = (pp1 - ppn) / ncol_p
    # regular pressure spacing for populous columns, random for sparse
    # ones (init_domainfill.f90:120-128)
    pnew_reg = pp1 - (j_in + 0.5) * deltacol
    pnew_rnd = pp1 - rng.random(n_total) * (pp1 - ppn)
    pnew = np.where(ncol_p > 20, pnew_reg, pnew_rnd)

    # vertical interpolation of pnew in the column profile
    prof = pp[:, jy, ix]                               # (nz, N)
    kz = np.clip((prof >= pnew[None, :]).sum(axis=0) - 1, 0, nz - 2)
    idx = np.arange(n_total)
    dz1 = prof[kz, idx] - pnew
    dz2 = pnew - prof[kz + 1, idx]
    dz = 1.0 / np.maximum(dz1 + dz2, 1e-10)
    z = (height[kz] * dz2 + height[kz + 1] * dz1) * dz
    z = np.minimum(z, height[-1] - 0.5)

    x = ix - 0.5 + rng.random(n_total)
    x = np.where(ix == 0, rng.random(n_total), x)
    x = np.where(ix == nxm - 1, nxm - 1 - rng.random(n_total), x)
    y = jy - 0.5 + rng.random(n_total)
    y = np.clip(y, 0.0, ny - 1 - 1e-4)

    mass = (colmass[jy, ix] / ncol_p).astype(np.float32)

    keep = np.ones(n_total, bool)
    if mdomainfill == 2:
        # stratospheric ozone proxy (init_domainfill.f90:186-203)
        pvf = pv[:, jy, ix]
        pvpart = (pvf[kz, idx] * dz2 + pvf[kz + 1, idx] * dz1) * dz
        ylat = grid.ylat0 + y * grid.dy
        pvpart = np.where(ylat < 0.0, -pvpart, pvpart)
        keep = (z > 3000.0) & (pvpart > PVCRIT)
        mass = mass * pvpart * 48.0 / 29.0 * OZONESCALE / 1.0e9

    n_keep = int(keep.sum())
    if capacity is None:
        capacity = n_keep
    p = empty_particles(capacity, 1)
    sl = np.nonzero(keep)[0]
    out = np.arange(n_keep)
    m2 = mass[sl][:, None]
    parts = p._replace(
        x_hi=p.x_hi.at[out].set(x[sl].astype(np.float32)),
        y_hi=p.y_hi.at[out].set(y[sl].astype(np.float32)),
        z=p.z.at[out].set(z[sl].astype(np.float32)),
        itra=p.itra.at[out].set(0),
        itramem=p.itramem.at[out].set(0),
        npoint=p.npoint.at[out].set(0),
        nclass=p.nclass.at[out].set(
            rng.integers(0, nclassunc, size=n_keep).astype(np.int32)),
        mass=p.mass.at[out].set(m2),
        mass0=p.mass0.at[out].set(m2),
        active=p.active.at[out].set(False),  # activated at itime=0
    )
    boundary = None
    if not gdomainfill:
        xmassperparticle = total / max(n_total, 1)
        boundary = _init_boundary(grid, height, nx_we, ny_sn, ncolumn,
                                  jy, ix, j_in, z, xmassperparticle)
    return parts, total, boundary


class BoundaryState(NamedTuple):
    """Static site table + flux accumulator for regional domain-filling
    boundary conditions (boundcond_domainfill.f90).  One "site" is one
    vertical layer of one boundary column; all geometry is fixed at init
    (zcolumn never changes), only ``acc`` evolves."""
    acc: jnp.ndarray        # (S,) accumulated inflow air mass [kg]
    col_flat: jnp.ndarray   # (S,) i32 jy*nx+ix of the boundary column
    is_we: jnp.ndarray      # (S,) bool: west/east face (sample u) vs s/n (v)
    sgn: jnp.ndarray        # (S,) +1 if inflow means positive wind comp.
    area: jnp.ndarray       # (S,) face area [m2]
    kz: jnp.ndarray         # (S,) i32 lower height-grid level at zcolumn
    wlo: jnp.ndarray        # (S,) weight of level kz
    whi: jnp.ndarray        # (S,) weight of level kz+1
    x_base: jnp.ndarray     # emission position parameterization:
    x_span: jnp.ndarray     # pos = base + uniform * span
    y_base: jnp.ndarray
    y_span: jnp.ndarray
    z_base: jnp.ndarray
    z_span: jnp.ndarray
    valid: jnp.ndarray      # (S,) bool
    xpp: jnp.ndarray        # scalar: air mass per particle [kg]
    xlim: jnp.ndarray       # (2,) window [x_lo, x_hi] in grid units
    ylim: jnp.ndarray       # (2,)


def _init_boundary(grid, height, nx_we, ny_sn, ncolumn, jy, ix, j_in, z,
                   xmassperparticle) -> BoundaryState:
    """Build the flattened site table from the initialized particle
    population (init_domainfill.f90:324-372 records zcolumn_we/sn)."""
    ny = grid.ny
    nx = grid.nx
    nz = height.shape[0]

    # per-boundary-column sorted particle heights = zcolumn
    def column_z(jj, ii):
        zs = np.sort(z[(jy == jj) & (ix == ii)])
        return zs

    sites = []   # (col_flat, is_we, sgn, jcol, zcol, corner, row_or_col)
    for k, ixb in enumerate(nx_we):
        for jj in range(ny_sn[0], ny_sn[1] + 1):
            zc = column_z(jj, ixb)
            corner = jj in (ny_sn[0], ny_sn[1])
            sites.append(("we", k, ixb, jj, zc, corner))
    for k, jjb in enumerate(ny_sn):
        for ii in range(nx_we[0], nx_we[1] + 1):
            zc = column_z(jjb, ii)
            corner = ii in (nx_we[0], nx_we[1])
            sites.append(("sn", k, ii, jjb, zc, corner))

    rows = []
    ztop = float(height[-1])
    for strip, k, ii_or_ixb, jj, zc, corner in sites:
        J = len(zc)
        if strip == "we":
            ixb, jjr = ii_or_ixb, jj
            lat_fact = 1.0
            width_deg = grid.dy
        else:
            ii, jjb = ii_or_ixb, jj
            ixb, jjr = ii, jjb
            lat_fact = float(np.cos((grid.ylat0 + jjb * grid.dy) * PI180))
            width_deg = grid.dx
        for j in range(J):
            if j == 0:
                deltaz = (zc[1] + zc[0]) / 2.0 if J > 1 else 2.0 * zc[0]
                z_base, z_span = (zc[0] + ((zc[1] - zc[0]) / 4.0
                                           if J > 1 else 0.0)), 0.0
            elif j == J - 1:
                deltaz = ((zc[J - 1] - zc[J - 3]) / 2.0 if J >= 3
                          else zc[1] - zc[0])
                z_base = (2.0 * zc[j] + zc[j - 1] + ztop) / 4.0
                z_span = 0.0
            else:
                deltaz = (zc[j + 1] - zc[j - 1]) / 2.0
                z_base = zc[j - 1]
                z_span = zc[j + 1] - zc[j - 1]
            area = max(deltaz, 0.0) * M_PER_DEG * width_deg * lat_fact
            if corner:
                area *= 0.5
            # emission position (boundcond_domainfill.f90:150-167)
            if strip == "we":
                x_base, x_span = float(ixb), 0.0
                if jjr == ny_sn[0]:
                    y_base, y_span = float(jjr), 0.5
                elif jjr == ny_sn[1]:
                    y_base, y_span = float(jjr), -0.5
                else:
                    y_base, y_span = jjr - 0.5, 1.0
                sgn = 1.0 if k == 0 else -1.0     # inflow: u>0 west face
                is_we = True
            else:
                y_base, y_span = float(jjr), 0.0
                if ixb == nx_we[0]:
                    x_base, x_span = float(ixb), 0.5
                elif ixb == nx_we[1]:
                    x_base, x_span = float(ixb), -0.5
                else:
                    x_base, x_span = ixb - 0.5, 1.0
                sgn = 1.0 if k == 0 else -1.0     # inflow: v>0 south face
                is_we = False
            kz = int(np.clip(np.searchsorted(height, zc[j]), 1, nz - 1))
            dz1 = zc[j] - height[kz - 1]
            dz2 = height[kz] - zc[j]
            dzi = 1.0 / max(dz1 + dz2, 1e-6)
            rows.append((jjr * nx + ixb, is_we, sgn, area, kz - 1,
                         dz2 * dzi, dz1 * dzi, x_base, x_span, y_base,
                         y_span, z_base, z_span, True))

    if not rows:
        rows = [(0, True, 1.0, 0.0, 0, 0.5, 0.5,
                 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, False)]
    cols = list(zip(*rows))
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    return BoundaryState(
        acc=jnp.zeros(len(rows), jnp.float32),
        col_flat=jnp.asarray(np.asarray(cols[0], np.int32)),
        is_we=jnp.asarray(np.asarray(cols[1], bool)),
        sgn=f32(cols[2]), area=f32(cols[3]),
        kz=jnp.asarray(np.asarray(cols[4], np.int32)),
        wlo=f32(cols[5]), whi=f32(cols[6]),
        x_base=f32(cols[7]), x_span=f32(cols[8]),
        y_base=f32(cols[9]), y_span=f32(cols[10]),
        z_base=f32(cols[11]), z_span=f32(cols[12]),
        valid=jnp.asarray(np.asarray(cols[13], bool)),
        xpp=jnp.float32(xmassperparticle),
        xlim=f32([nx_we[0], nx_we[1]]),
        ylim=f32([ny_sn[0], ny_sn[1]]),
    )


@functools.partial(jax.jit, static_argnames=("mdomainfill", "ldirect",
                                             "check_x"))
def boundcond_domainfill(p: Particles, bs: BoundaryState, z0, z1,
                         itime, mt0, mt1, key, lsynctime, itsplit,
                         ylat0, dy, mdomainfill: int = 1,
                         ldirect: int = 1, nclassunc: int = 1,
                         check_x: bool = True):
    """One boundary-condition step (boundcond_domainfill.f90): destroy
    particles outside the window, accumulate boundary-layer mass inflow,
    and emit new particles where a particle-mass has accumulated."""
    # ---- terminate out-of-window particles (:36-47) ----
    x = p.x
    y = p.y
    outside = (y < bs.ylim[0]) | (y > bs.ylim[1])
    if check_x:
        outside = outside | (x < bs.xlim[0]) | (x > bs.xlim[1])
    kill = p.active & outside
    p = p._replace(active=p.active & ~kill,
                   itra=jnp.where(kill, ITRA_INACTIVE, p.itra))

    # ---- mass flux through every boundary site (:49-130) ----
    dt1 = jnp.float32(itime - mt0)
    dt2 = jnp.float32(mt1 - itime)
    w0 = dt2 / (dt1 + dt2)
    w1 = dt1 / (dt1 + dt2)
    nf3, nz, ny, nx = z0.f3d.shape
    fidx = jnp.where(bs.is_we, F3_U, F3_V).astype(jnp.int32)

    def sample(zf, field_idx, klev):
        flat = zf.f3d.reshape(-1)
        lin = (field_idx * nz + klev) * (ny * nx) + bs.col_flat
        return flat[lin]

    def at_sites(zf, field_idx):
        lo = sample(zf, field_idx, bs.kz)
        hi = sample(zf, field_idx, bs.kz + 1)
        return bs.wlo * lo + bs.whi * hi

    windx = w0 * at_sites(z0, fidx) + w1 * at_sites(z1, fidx)
    rho_idx = jnp.full_like(fidx, F3_RHO)
    rhox = w0 * at_sites(z0, rho_idx) + w1 * at_sites(z1, rho_idx)

    flux = bs.sgn * windx * rhox * bs.area * jnp.float32(lsynctime)
    acc = jnp.where(flux >= 0.0, bs.acc + flux, 0.0)
    acc = jnp.where(bs.valid, acc, 0.0)

    # ---- integer particle emission count (:135-142) ----
    half = bs.xpp * 0.5
    mmass = jnp.where(acc >= half,
                      jnp.floor((acc + half) / bs.xpp), 0.0)
    acc = acc - mmass * bs.xpp
    emit = jnp.minimum(mmass, float(KMAX_EMIT))
    acc = acc + (mmass - emit) * bs.xpp     # overflow re-queued

    # ---- emission rounds: k-th eligible site -> k-th free slot ----
    height = z0.height
    for r in range(KMAX_EMIT):
        rk = jax.random.fold_in(key, r)
        u1 = jax.random.uniform(rk, bs.acc.shape)
        u2 = jax.random.uniform(jax.random.fold_in(rk, 1), bs.acc.shape)
        xnew = bs.x_base + u1 * bs.x_span
        ynew = bs.y_base + u1 * bs.y_span
        znew = bs.z_base + u2 * bs.z_span
        want = bs.valid & (emit > r)
        mass_new = jnp.broadcast_to(bs.xpp, bs.acc.shape)
        if mdomainfill == 2:
            # stratospheric ozone proxy: sample PV at the site column
            # (the reference interpolates bilinearly at the particle;
            # the column profile differs only at second order here)
            kzp = jnp.clip(jnp.searchsorted(height, znew), 1, nz - 1)
            dz1p = znew - height[kzp - 1]
            dz2p = height[kzp] - znew
            dzi = 1.0 / jnp.maximum(dz1p + dz2p, 1e-6)
            pv_idx = jnp.full_like(fidx, F3_PV)
            pvlo = sample(z0, pv_idx, kzp - 1) * w0 \
                + sample(z1, pv_idx, kzp - 1) * w1
            pvhi = sample(z0, pv_idx, kzp) * w0 \
                + sample(z1, pv_idx, kzp) * w1
            pvpart = (pvlo * dz2p + pvhi * dz1p) * dzi
            lat = ylat0 + ynew * dy
            pvpart = jnp.where(lat < 0.0, -pvpart, pvpart)
            want = want & (znew > 3000.0) & (pvpart > PVCRIT)
            mass_new = (bs.xpp * pvpart * 48.0 / 29.0 * OZONESCALE
                        / 1.0e9)

        n = p.capacity
        free = (~p.active) & ((p.itra == ITRA_INACTIVE)
                              | (p.itra != p.itramem))
        free_rank = jnp.cumsum(free) - 1
        n_free = free_rank[-1] + 1
        slot_of_rank = jnp.full(n, n, jnp.int32).at[
            jnp.where(free, free_rank, n)].set(
                jnp.arange(n, dtype=jnp.int32), mode="drop")
        want_rank = jnp.cumsum(want) - 1
        granted = want & (want_rank < n_free)
        slot = jnp.where(granted,
                         slot_of_rank[jnp.clip(want_rank, 0, n - 1)], n)

        iti = jnp.int32(itime)
        f32z = jnp.zeros_like(xnew)
        ncls = jax.random.randint(jax.random.fold_in(rk, 2),
                                  bs.acc.shape, 0, nclassunc)
        m2 = mass_new[:, None]
        p = p._replace(
            x_hi=p.x_hi.at[slot].set(xnew, mode="drop"),
            x_lo=p.x_lo.at[slot].set(f32z, mode="drop"),
            y_hi=p.y_hi.at[slot].set(ynew, mode="drop"),
            y_lo=p.y_lo.at[slot].set(f32z, mode="drop"),
            z=p.z.at[slot].set(znew, mode="drop"),
            itra=p.itra.at[slot].set(iti, mode="drop"),
            itramem=p.itramem.at[slot].set(iti, mode="drop"),
            itrasplit=p.itrasplit.at[slot].set(
                iti + ldirect * jnp.int32(itsplit), mode="drop"),
            npoint=p.npoint.at[slot].set(0, mode="drop"),
            nclass=p.nclass.at[slot].set(ncls.astype(jnp.int32),
                                         mode="drop"),
            idt=p.idt.at[slot].set(0, mode="drop"),
            up=p.up.at[slot].set(f32z, mode="drop"),
            vp=p.vp.at[slot].set(f32z, mode="drop"),
            wp=p.wp.at[slot].set(f32z, mode="drop"),
            usig=p.usig.at[slot].set(f32z, mode="drop"),
            vsig=p.vsig.at[slot].set(f32z, mode="drop"),
            wsig=p.wsig.at[slot].set(f32z, mode="drop"),
            cbt=p.cbt.at[slot].set(1, mode="drop"),
            mass=p.mass.at[slot].set(m2, mode="drop"),
            mass0=p.mass0.at[slot].set(m2, mode="drop"),
            active=p.active.at[slot].set(True, mode="drop"),
        )
    return p, bs._replace(acc=acc)
