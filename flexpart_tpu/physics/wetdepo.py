"""Wet deposition: scavenging coefficients + mass removal, vectorized.

Re-design of wetdepo.f90 + get_wetscav.f90: per particle per sync
interval, gather precip/cloud fields at the particle, compute the
scavenging coefficient Lambda per species (below-cloud gas A*P^B /
aerosol Laakso-rain & Kyro-snow polynomials; in-cloud via cloud water,
T-dependent ice-liquid activation split, Henry partitioning), remove
mass 1-exp(-Lambda*dt) over the precipitating grid fraction, and
scatter-add the deposit onto the output wet-deposition grid with the
same uniform kernel as conccalc (wetdepokernel.f90).

All species loop statically (nspec is tiny); everything else is one
vector op over the particle axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import INCLOUD_RATIO, R_AIR
from ..core.interp import horiz_weights, interp_2d, vert_weights
from ..core.state import Particles
from ..met.fields import (ZFields, F2_LSPREC, F2_CONVPREC, F2_TCC, F3_TT,
                          F2_CLOUDSH, F2_CTWC)

# precipitating area fractions vs rate class (get_wetscav.f90:71-73)
LFR = np.array([0.5, 0.65, 0.8, 0.9, 0.95], np.float32)
CFR = np.array([0.4, 0.55, 0.7, 0.8, 0.9], np.float32)
RATE_EDGES = np.array([1.0, 3.0, 8.0, 20.0], np.float32)

# below-cloud aerosol polynomial constants (get_wetscav.f90:76-78)
BCLR = np.array([274.35758, 332839.59273, 226656.57259, 58005.91340,
                 6588.38582, 0.244984], np.float64)
BCLS = np.array([22.7, 0.0, 0.0, 1321.0, 381.0, 0.0], np.float64)


class WetSpecies(NamedTuple):
    """Static per-species scavenging constants (from SPECIES files)."""
    wetdep: bool
    is_aerosol: bool
    weta_gas: float
    wetb_gas: float
    crain_aero: float
    csnow_aero: float
    ccn_aero: float
    in_aero: float
    henry: float
    dquer: float          # [um]

    @classmethod
    def from_species(cls, s) -> "WetSpecies":
        return cls(wetdep=s.wetdep, is_aerosol=s.dquer > 0.0,
                   weta_gas=s.weta_gas, wetb_gas=s.wetb_gas,
                   crain_aero=s.crain_aero, csnow_aero=s.csnow_aero,
                   ccn_aero=max(s.ccn_aero, 0.0),
                   in_aero=max(s.in_aero, 0.0),
                   henry=s.henry, dquer=s.dquer)


def _below_cloud_aerosol(coeffs, eff, dquer_um, prec):
    """Laakso-2003 / Kyro-2009 polynomial in log10(d) (get_wetscav.f90:
    234-252); dquer capped at 10 um."""
    d_m = min(10.0, dquer_um) / 1.0e6
    ld = np.log10(d_m)
    base = (coeffs[0] + coeffs[1] * ld ** -4 + coeffs[2] * ld ** -3
            + coeffs[3] * ld ** -2 + coeffs[4] * ld ** -1)
    return eff * 10.0 ** (base + coeffs[5] * jnp.sqrt(prec))


@functools.partial(jax.jit, static_argnames=("species", "use_clouds_water"))
def wetscav_all(p: Particles, zf: ZFields, itime, ltsample,
                species: tuple, use_clouds_water: bool):
    """Scavenging coefficient per live particle per species.

    zf: the wind-field time level nearest to itime-ltsample/2
    (get_wetscav.f90:121-127; space-bilinear, time-nearest for clouds).
    Returns (lambda (nspec, N), grfraction (N,))."""
    n = p.capacity
    x, y = p.x, p.y
    ny_m, nx_m = zf.f2d.shape[1], zf.f2d.shape[2]
    hw = horiz_weights(x, y, nx_m, ny_m, False)
    lsp, convp, cc = interp_2d(
        zf.f2d, (F2_LSPREC, F2_CONVPREC, F2_TCC), hw)
    cc = jnp.maximum(cc, 1e-10)

    # cell-center values for clouds / temperature (reference uses the
    # uninterpolated cell, get_wetscav.f90:155-166)
    ix = jnp.clip(x.astype(jnp.int32), 0, nx_m - 1)
    jy = jnp.clip(y.astype(jnp.int32), 0, ny_m - 1)
    indz, _ = vert_weights(p.z, zf.height)
    hz = indz  # level below particle
    clouds_v = zf.clouds[hz, jy, ix].astype(jnp.int32)
    act_temp = zf.f3d[F3_TT][hz, jy, ix]
    ctwc = zf.f2d[F2_CTWC][jy, ix]

    raining = (lsp >= 0.01) | (convp >= 0.01)
    in_cloudy = clouds_v > 1          # below or in cloud

    # area fraction of the cell that precipitates (get_wetscav.f90:175-200)
    edges = jnp.asarray(RATE_EDGES)
    i_l = jnp.searchsorted(edges, lsp, side="right")
    i_c = jnp.searchsorted(edges, convp, side="right")
    lfr = jnp.asarray(LFR)[i_l]
    cfr = jnp.asarray(CFR)[i_c]
    tot = jnp.maximum(lsp + convp, 1e-30)
    grfraction = jnp.maximum(0.05, cc * (lsp * lfr + convp * cfr) / tot)
    prec = (lsp + convp) / grfraction

    below = clouds_v >= 4
    incl = in_cloudy & (~below)

    # cloud water for in-cloud scavenging (get_wetscav.f90:274-290)
    if use_clouds_water:
        cl = ctwc * (grfraction / cc)
    else:
        cl = 1.0e6 * 2e-7 * prec ** 0.36
    # ice/liquid split (get_wetscav.f90:293-305)
    ice_frac = jnp.clip(((act_temp - 273.0) / (273.0 - 253.0)) ** 2,
                        0.0, 1.0)
    ice_frac = jnp.where(act_temp <= 253.0, 1.0, ice_frac)
    ice_frac = jnp.where(act_temp >= 273.0, 0.0, ice_frac)
    liq_frac = jnp.maximum(0.0, 1.0 - ice_frac)

    scavs = []
    for s in species:
        lam = jnp.zeros(n, jnp.float32)
        if not s.wetdep:
            scavs.append(lam)
            continue
        # ---- below-cloud (get_wetscav.f90:216-256)
        if (not s.is_aerosol) and (s.weta_gas > 0.0 or s.wetb_gas > 0.0):
            lam_b = s.weta_gas * prec ** s.wetb_gas
            lam = jnp.where(below, lam_b, lam)
        elif s.is_aerosol and (s.crain_aero > 0.0 or s.csnow_aero > 0.0):
            lam_rain = (_below_cloud_aerosol(BCLR, s.crain_aero, s.dquer,
                                             prec)
                        if s.crain_aero > 0.0 else jnp.zeros(n))
            lam_snow = (_below_cloud_aerosol(BCLS, s.csnow_aero, s.dquer,
                                             prec)
                        if s.csnow_aero > 0.0 else jnp.zeros(n))
            lam_b = jnp.where(act_temp >= 273.0, lam_rain, lam_snow)
            lam = jnp.where(below, lam_b, lam)
        # ---- in-cloud (get_wetscav.f90:262-330)
        if (s.ccn_aero > 0.0 or s.in_aero > 0.0
                or (s.henry > 0.0 and not s.is_aerosol)):
            if s.is_aerosol:
                frac_act = liq_frac * s.ccn_aero + ice_frac * s.in_aero
                s_i = frac_act / jnp.maximum(cl, 1e-30)
            else:
                cle = (1.0 - cl) / (s.henry * (R_AIR / 3500.0)
                                    * act_temp) + cl
                s_i = 1.0 / cle
            lam_i = INCLOUD_RATIO * s_i * (prec / 3.6e6)
            lam = jnp.where(incl, lam_i, lam)
        scavs.append(lam)

    lam_all = jnp.stack(scavs)                      # (nspec, N)
    valid = p.active & raining & in_cloudy
    lam_all = jnp.where(valid[None, :], lam_all, 0.0)
    return lam_all, grfraction


def make_depokernel(nxg: int, nyg: int, npointspec: int, nclassunc: int,
                    nage: int, dxout: float, dyout: float,
                    xoutshift: float, youtshift: float,
                    dx_met: float, dy_met: float, use_kernel: bool = True):
    """Returns jitted (grid2d, deposit(nspec,N), p, nage_idx) -> grid2d:
    uniform-kernel scatter of per-particle deposits onto a 2-D output grid
    (wetdepokernel.f90 / drydepokernel.f90)."""

    @jax.jit
    def scatter(grid, deposit, p: Particles, nage_idx, kp):
        n = p.capacity
        xl = (p.x * dx_met + xoutshift) / dxout
        yl = (p.y * dy_met + youtshift) / dyout
        ix = jnp.floor(xl).astype(jnp.int32)
        jy = jnp.floor(yl).astype(jnp.int32)
        ddx = xl - ix
        ddy = yl - jy
        ixp = jnp.where(ddx > 0.5, ix + 1, ix - 1)
        jyp = jnp.where(ddy > 0.5, jy + 1, jy - 1)
        wx = jnp.where(ddx > 0.5, 1.5 - ddx, 0.5 + ddx)
        wy = jnp.where(ddy > 0.5, 1.5 - ddy, 0.5 + ddy)
        cx = jnp.stack([ix, ixp, ixp, ix], axis=-1)
        cy = jnp.stack([jy, jyp, jy, jyp], axis=-1)
        w4 = jnp.stack([wx * wy, (1 - wx) * (1 - wy), (1 - wx) * wy,
                        wx * (1 - wy)], axis=-1)
        if not use_kernel:
            w4 = jnp.concatenate(
                [jnp.ones((n, 1)), jnp.zeros((n, 3))], axis=1)
        in_grid = (cx >= 0) & (cx < nxg) & (cy >= 0) & (cy < nyg)
        valid = p.active[:, None] & in_grid
        cell = ((nage_idx * nclassunc + p.nclass) * npointspec + kp)
        lin = cell[:, None] * (nyg * nxg) + cy * nxg + cx
        lin = jnp.where(valid, lin, 2 ** 30)
        contrib = w4[..., None] * deposit.T[:, None, :]   # (N,4,nspec)
        contrib = jnp.where(valid[..., None], contrib, 0.0)
        nspec = deposit.shape[0]
        flat = grid.reshape(-1, nspec)
        flat = flat.at[lin.reshape(-1)].add(
            contrib.reshape(-1, nspec), mode="drop")
        return flat.reshape(grid.shape)

    return scatter
