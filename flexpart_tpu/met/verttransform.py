"""Vertical transform: hybrid-eta fields -> fixed-height-grid fields.

Fully vectorized re-design of
/root/reference/src/verttransform_ecmwf.f90: instead of triple-nested column
loops with stateful level searches, whole-grid cumulative integrations and a
vmapped searchsorted produce the same terrain-following-metre fields in a few
fused XLA ops.  Cloud classification for wet scavenging follows both reference
methods (clwc-based "readclouds" path, verttransform_ecmwf.f90:606-675, and
the rh>80% fallback, :681-724).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import R_AIR
from .fields import (EtaFields, ZFields, F3_U, F3_V, F3_W, F3_RHO, F3_DRHODZ,
                     F3_TT, F3_QV, F3_PV, F3_CLW, NF3,
                     F2_PS, F2_LSPREC, F2_CONVPREC, F2_TCC, F2_TT2, F2_TD2,
                     F2_SD, F2_ORO, F2_EXCESSORO, F2_LSM, F2_CLOUDSH, F2_CTWC,
                     F2_SSR, F2_SSHF, NF2)
from .grid import MetGrid
from .thermo import ew, f_qvsat

GA = 9.81
CONST = R_AIR / GA


def _layer_thickness(pold, pint, tvold, tv):
    """Hypsometric layer thickness with the reference's two-branch form
    (verttransform_ecmwf.f90:231-236)."""
    dz_grad = CONST * jnp.log(pold / pint) * (tv - tvold) / jnp.log(tv / tvold)
    dz_iso = CONST * jnp.log(pold / pint) * tv
    return jnp.where(jnp.abs(tv - tvold) > 0.2, dz_grad, dz_iso)


def eta_level_heights(akz, bkz, ps, tt2, td2, tth, qvh,
                      pressure_levels: bool = False):
    """Heights of eta full levels above ground per column, and density.

    Returns (uvzlev, rhoh, prsh), each (nlev, ny, nx); level 0 = ground.
    (verttransform_ecmwf.f90:207-240)

    With ``pressure_levels`` (GFS), levels can lie below the terrain
    where ps < akz: the reference starts the integration at the first
    level above ground ``llev`` (verttransform_gfs.f90:146-182).  Here
    that is branch-free: layer thicknesses whose lower level is below
    ground are zeroed, so all below-ground levels collapse onto height
    zero; they then get tiny negative offsets so the z-interpolation's
    searchsorted lands on the llev value at the ground — identical to
    the reference's llev-based column scan.
    """
    pint = akz[:, None, None] + bkz[:, None, None] * ps[None]
    tv = tth * (1.0 + 0.608 * qvh)
    if not pressure_levels:
        tv0 = tt2 * (1.0 + 0.378 * ew(td2) / ps)
        tv = tv.at[0].set(tv0)
    rhoh = pint / (R_AIR * tv)
    dz = _layer_thickness(pint[:-1], pint[1:], tv[:-1], tv[1:])
    if pressure_levels:
        below_lower = pint[:-1] >= ps[None]      # lower level below ground
        dz = jnp.where(below_lower, 0.0, dz)
        uvzlev = jnp.concatenate(
            [jnp.zeros_like(ps)[None], jnp.cumsum(dz, axis=0)], axis=0)
        below = pint >= ps[None]
        nlev = akz.shape[0]
        k = jnp.arange(nlev, dtype=uvzlev.dtype)[:, None, None]
        n_below = jnp.sum(below, axis=0)[None].astype(uvzlev.dtype)
        uvzlev = jnp.where(below, -1e-3 * (n_below - k), uvzlev)
    else:
        uvzlev = jnp.concatenate(
            [jnp.zeros_like(ps)[None], jnp.cumsum(dz, axis=0)], axis=0)
    return uvzlev, rhoh, pint


def compute_heights(grid: MetGrid, eta: EtaFields) -> np.ndarray:
    """Fixed z-grid from a reference column with ps>1000 hPa
    (verttransform_ecmwf.f90:134-170). Host-side, once per run."""
    ps = np.asarray(eta.ps)
    flat = np.argwhere(ps.ravel() > 100000.0)
    idx = int(flat[0, 0]) if flat.size else int(np.argmax(ps))
    jy, ix = np.unravel_index(idx, ps.shape)
    akz, bkz = grid.akz, grid.bkz
    tth = np.asarray(eta.tth)[:, jy, ix]
    qvh = np.asarray(eta.qvh)[:, jy, ix]
    psc = float(ps[jy, ix])
    tvold = float(np.asarray(eta.tt2)[jy, ix]) * (
        1.0 + 0.378 * float(ew(np.asarray(eta.td2)[jy, ix])) / psc)
    pold = psc
    height = np.zeros(grid.nlev)
    for kz in range(1, grid.nlev):
        pint = akz[kz] + bkz[kz] * psc
        tv = tth[kz] * (1.0 + 0.608 * qvh[kz])
        if abs(tv - tvold) > 0.2:
            dz = CONST * np.log(pold / pint) * (tv - tvold) / np.log(tv / tvold)
        else:
            dz = CONST * np.log(pold / pint) * tv
        height[kz] = height[kz - 1] + dz
        tvold, pold = tv, pint
    return height


def _interp_to_height(prof_lev, height, fields_lev):
    """Interpolate column profiles from per-column levels to the fixed height
    grid.  prof_lev: (nlev, ncol) monotone level heights; fields_lev:
    (..., nlev, ncol); height: (nz,).  Returns (..., nz, ncol)."""
    nlev, ncol = prof_lev.shape
    cols = prof_lev.T  # (ncol, nlev)
    idx = jax.vmap(lambda p: jnp.searchsorted(p, height, side="left"))(cols)
    kz = jnp.clip(idx.T, 1, nlev - 1)  # (nz, ncol)
    below = jnp.take_along_axis(prof_lev, kz - 1, axis=0)
    above = jnp.take_along_axis(prof_lev, kz, axis=0)
    w = (height[:, None] - below) / jnp.maximum(above - below, 1e-6)
    w = jnp.clip(w, 0.0, 1.0)
    f_below = jnp.take_along_axis(
        fields_lev, jnp.broadcast_to(kz - 1, fields_lev.shape[:-2] + kz.shape), axis=-2)
    f_above = jnp.take_along_axis(
        fields_lev, jnp.broadcast_to(kz, fields_lev.shape[:-2] + kz.shape), axis=-2)
    out = f_below * (1.0 - w) + f_above * w
    # above the top eta level: hold top value (verttransform_ecmwf.f90:302-316)
    top = prof_lev[-1][None, :]
    out = jnp.where(height[:, None] > top, fields_lev[..., -1:, :], out)
    return out


@functools.partial(jax.jit, static_argnames=("xglobal", "use_clwc",
                                             "pressure_levels"))
def _process_eta_jit(akz, bkz, height, eta: EtaFields, pvh,
                     dxconst, dyconst, dx, dy, ylat0,
                     xglobal: bool, use_clwc: bool,
                     pressure_levels: bool = False):
    nlev = akz.shape[0]
    ny, nx = eta.ps.shape
    nz = nlev
    ncol = ny * nx

    uvzlev, rhoh, prsh = eta_level_heights(
        akz, bkz, eta.ps, eta.tt2, eta.td2, eta.tth, eta.qvh,
        pressure_levels=pressure_levels)

    # --- interpolate u,v,t,qv,pv,rho (and clwc) to the fixed height grid ---
    prof = uvzlev.reshape(nlev, ncol)
    stack = jnp.stack([eta.uuh, eta.vvh, eta.tth, eta.qvh, pvh, rhoh,
                       eta.clwch], axis=0).reshape(7, nlev, ncol)
    zstack = _interp_to_height(prof, height, stack).reshape(7, nz, ny, nx)
    uu, vv, tt, qv, pv, rho, clwc = (zstack[i] for i in range(7))

    # --- vertical wind: Pa/s -> m/s via pinmconv ---
    # (verttransform_ecmwf.f90:243-261,361-387)
    pfull = akz[:, None, None] + bkz[:, None, None] * eta.ps[None]
    if pressure_levels:
        # GFS: omega lives on the SAME pressure levels as u,v
        # (verttransform_gfs.f90:160-186,270-286); below-ground levels are
        # collapsed, and dz/dp at the first above-ground level is anchored
        # at the surface (z=0, p=ps) — the exact hydrostatic gradient.
        wzlev = uvzlev
        zeff = jnp.maximum(uvzlev, 0.0)
        peff = jnp.minimum(pfull, eta.ps[None])

        def _dzdp(dz_, dp_):
            # fully-below-ground spans clamp to dp=0; their pinmconv is
            # never used (those levels collapse onto z<=0), keep it finite
            return dz_ / jnp.where(jnp.abs(dp_) < 0.5, -0.5, dp_)

        pinmconv = jnp.concatenate([
            _dzdp(zeff[1] - zeff[0], peff[1] - peff[0])[None],
            _dzdp(zeff[2:] - zeff[:-2], peff[2:] - peff[:-2]),
            _dzdp(zeff[-1] - zeff[-2], peff[-1] - peff[-2])[None],
        ], axis=0)
    else:
        wzlev = jnp.concatenate([
            jnp.zeros((1, ny, nx)),
            0.5 * (uvzlev[2:] + uvzlev[1:-1]),
            (0.5 * (uvzlev[-1] + uvzlev[-2])
             + uvzlev[-1] - uvzlev[-2])[None],
        ], axis=0)
        pinmconv = jnp.concatenate([
            (uvzlev[1] / (pfull[1] - pfull[0]))[None],
            (uvzlev[2:] - uvzlev[:-2]) / (pfull[2:] - pfull[:-2]),
            ((uvzlev[-1] - uvzlev[-2]) / (pfull[-1] - pfull[-2]))[None],
        ], axis=0)
    gw = (eta.wwh * pinmconv).reshape(nlev, ncol)
    ww = _interp_to_height(wzlev.reshape(nlev, ncol), height, gw).reshape(nz, ny, nx)
    if not pressure_levels:
        ww = ww.at[0].set(eta.wwh[0] * pinmconv[0])
        ww = ww.at[-1].set(eta.wwh[-1] * pinmconv[-1])

    # --- density gradient (verttransform_ecmwf.f90:392-398) ---
    dh = height[1:] - height[:-1]
    drhodz = jnp.concatenate([
        ((rho[1] - rho[0]) / dh[0])[None],
        (rho[2:] - rho[:-2]) / (height[2:, None, None] - height[:-2, None, None]),
    ], axis=0)
    drhodz = jnp.concatenate([drhodz, drhodz[-1:]], axis=0)

    # --- eta-slope correction of w (verttransform_ecmwf.f90:404-453) ---
    # dz/dx of the eta surfaces at fixed height, central differences.
    uvz_z = _interp_to_height(prof, height, uvzlev.reshape(nlev, ncol)
                              ).reshape(nz, ny, nx)
    if xglobal:
        dzdx = (jnp.roll(uvz_z, -1, axis=2) - jnp.roll(uvz_z, 1, axis=2)) / 2.0
    else:
        dzdx = jnp.zeros_like(uvz_z)
        dzdx = dzdx.at[:, :, 1:-1].set((uvz_z[:, :, 2:] - uvz_z[:, :, :-2]) / 2.0)
    dzdy = jnp.zeros_like(uvz_z)
    dzdy = dzdy.at[:, 1:-1, :].set((uvz_z[:, 2:, :] - uvz_z[:, :-2, :]) / 2.0)
    lat = ylat0 + jnp.arange(ny) * dy
    cosf = 1.0 / jnp.cos(lat * jnp.pi / 180.0)
    cosf = jnp.clip(cosf, -100.0, 100.0)
    corr = dzdx * uu * dxconst * cosf[None, :, None] + dzdy * vv * dyconst
    inner = jnp.zeros((nz, ny, nx), bool
                      ).at[1:-1, 1:-1, :].set(True)
    if not xglobal:
        inner = inner & jnp.zeros((1, 1, nx), bool).at[:, :, 1:-1].set(True)
    ww = jnp.where(inner, ww + corr, ww)

    # --- cloud classification for wet scavenging ---
    lsp = eta.lsprec
    convp = eta.convprec
    prec = lsp + convp
    precip = (lsp > 0.01) | (convp > 0.01)
    lsp_dom = lsp >= convp
    dh_full = jnp.concatenate([dh[0:1], dh])[:, None, None]  # height(kz)-height(kz-1)

    if use_clwc:
        # readclouds path (verttransform_ecmwf.f90:616-675)
        dh_up = jnp.concatenate([dh, dh[-1:]])[:, None, None]
        clw = jnp.where(clwc > 0, clwc * rho * dh_up, 0.0)
        clw = clw.at[-1].set(0.0)
        ctwc = jnp.sum(clw, axis=0)
        incloud = clw > 0.0
        big = 1.0e30
        cloudh_min = jnp.min(jnp.where(incloud, height[:, None, None], big), axis=0)
        below = (~incloud) & (cloudh_min[None] >= height[:, None, None])
        cl = jnp.where(incloud, jnp.where(lsp_dom[None], 3, 2),
                       jnp.where(below, jnp.where(lsp_dom[None], 5, 4), 0))
        cl = jnp.where(precip[None], cl, 0)
        cl = jnp.where(height[:, None, None] >= 19000.0, 0, cl)
        cl = cl.at[0].set(0)
        cloudsh = jnp.sum(jnp.where((cl == 2) | (cl == 3), dh_full, 0.0), axis=0)
    else:
        # rh>80% fallback (verttransform_ecmwf.f90:686-723)
        pressure = rho * R_AIR * tt
        rh = qv / f_qvsat(pressure, tt)
        incloud = rh > 0.8
        prec_cloud = incloud & precip[None]
        # rain cloud strictly above this level (processed earlier, top-down)
        above_ct = jnp.cumsum(prec_cloud[::-1].astype(jnp.int32), axis=0)[::-1]
        rain_above = (above_ct - prec_cloud.astype(jnp.int32)) > 0
        cl = jnp.where(
            incloud,
            jnp.where(precip[None], jnp.where(lsp_dom[None], 3, 2), 1),
            jnp.where(rain_above, jnp.where(lsp_dom[None], 5, 4), 0))
        cl = cl.at[0].set(0)
        cloudsh = jnp.sum(jnp.where(prec_cloud, dh_full, 0.0), axis=0)
        ctwc = jnp.zeros_like(eta.ps)
        clw = jnp.zeros_like(rho)

    f3d = jnp.zeros((NF3, nz, ny, nx), jnp.float32)
    f3d = f3d.at[F3_U].set(uu).at[F3_V].set(vv).at[F3_W].set(ww)
    f3d = f3d.at[F3_RHO].set(rho).at[F3_DRHODZ].set(drhodz)
    f3d = f3d.at[F3_TT].set(tt).at[F3_QV].set(qv).at[F3_PV].set(pv)
    f3d = f3d.at[F3_CLW].set(clw)

    f2d = jnp.zeros((NF2, ny, nx), jnp.float32)
    f2d = f2d.at[F2_PS].set(eta.ps).at[F2_LSPREC].set(lsp)
    f2d = f2d.at[F2_CONVPREC].set(convp).at[F2_TCC].set(eta.tcc)
    f2d = f2d.at[F2_TT2].set(eta.tt2).at[F2_TD2].set(eta.td2)
    f2d = f2d.at[F2_SD].set(eta.sd).at[F2_ORO].set(eta.oro)
    f2d = f2d.at[F2_EXCESSORO].set(eta.excessoro).at[F2_LSM].set(eta.lsm)
    f2d = f2d.at[F2_CLOUDSH].set(cloudsh).at[F2_CTWC].set(ctwc)
    f2d = f2d.at[F2_SSR].set(eta.ssr).at[F2_SSHF].set(eta.sshf)

    return f3d, f2d, cl.astype(jnp.int8)


def process_eta(grid: MetGrid, eta: EtaFields, height,
                pvh=None, use_clwc: bool = False) -> ZFields:
    """Full met preprocessing for one wind-field time: verttransform
    (+ cloud diagnostics).  calcpar fields are added by met.calcpar."""
    if pvh is None:
        pvh = jnp.zeros_like(eta.tth)
    height = jnp.asarray(height, jnp.float32)
    f3d, f2d, clouds = _process_eta_jit(
        jnp.asarray(grid.akz, jnp.float32), jnp.asarray(grid.bkz, jnp.float32),
        height, eta, pvh,
        grid.dxconst, grid.dyconst, grid.dx, grid.dy, grid.ylat0,
        xglobal=grid.xglobal, use_clwc=use_clwc,
        pressure_levels=grid.pressure_levels)
    nspec = 1
    vdep = jnp.zeros((nspec, grid.ny, grid.nx), jnp.float32)
    return ZFields(f3d=f3d, f2d=f2d, clouds=clouds, vdep=vdep, height=height)
