"""Dry-deposition velocity field: Wesely resistance chain, vectorized.

Re-design of the reference per-column chain getvdep.f90 (ra+rb+rc over
13 landuse classes) + getrb.f90 + getrc.f90 + raerod.f90/psih.f90 +
partdep.f90 (aerosol size bins), computed for the WHOLE grid at once per
wind field (called from the getfields pipeline like calcpar.f90:170-186).

Static per-run data (landuse fractions, resistance tables, species
constants) is baked into a jitted closure; the per-field inputs are the
surface arrays already in ZFields.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GA, KARMAN, HREF
from .landuse import (NUMCLASS, WeselyTables, seasonal_category,
                      species_gas_tables)

PR = 0.72   # Prandtl number (getrb.f90)
EPS = 1e-5


def _psih(z, l):
    """Similarity stability correction for heat (psih.f90)."""
    l = jnp.where((l >= 0) & (l < 1e-20), 1e-20, l)
    l = jnp.where((l < 0) & (l > -1e-20), -1e-20, l)
    zeta = z / l
    a, b, c, d = 1.0, 0.667, 5.0, 0.35
    stable = -((1.0 + 0.667 * a * zeta) ** 1.5) \
        - b * (zeta - c / d) * jnp.exp(-d * zeta) - b * c / d + 1.0
    x = (jnp.maximum(1.0 - 16.0 * zeta, 1e-30)) ** 0.25
    unstable = 2.0 * jnp.log((1.0 + x * x) / 2.0)
    out = jnp.where(zeta > 0.0, stable, unstable)
    return jnp.where(jnp.log10(z) - jnp.log10(jnp.abs(l)) < -20.0, 0.0, out)


def _raerod(l, ust, z0):
    """Aerodynamic resistance ground->href (raerod.f90)."""
    return (jnp.log(HREF / z0) - _psih(jnp.float32(HREF), l)
            + _psih(z0, l)) / (KARMAN * ust)


@dataclasses.dataclass(frozen=True)
class DrydepTables:
    """Static per-run dry-deposition data for the jitted kernel."""
    xlanduse: np.ndarray          # (ny, nx, 13) fractional cover
    z0: np.ndarray                # (13,) roughness length
    season: np.ndarray            # (ny,) Wesely seasonal category 1..5
    # gas species data, one row per species (zeros when not a dep gas)
    gas_mask: np.ndarray          # (nspec,) bool
    reldiff: np.ndarray           # (nspec,)
    henry: np.ndarray
    f0: np.ndarray
    rm: np.ndarray
    ri: np.ndarray                # (nspec_or_1, ny, 13) season-resolved
    rlu: np.ndarray               # (nspec, ny, 13)
    rgs: np.ndarray
    rcl: np.ndarray
    rac: np.ndarray               # (ny, 13)
    # aerosol species data
    aero_mask: np.ndarray         # (nspec,) bool
    fract: np.ndarray             # (nspec, NI)
    schmi: np.ndarray
    vset: np.ndarray
    # constant-velocity fallback
    dryvel: np.ndarray            # (nspec,) <0 when unused


def build_drydep_tables(species: Sequence, xlanduse: np.ndarray,
                        z0: np.ndarray, tables: WeselyTables,
                        mmdd: int, ylat0: float, dy: float,
                        ny: int) -> DrydepTables:
    ylat = ylat0 + dy * np.arange(ny)
    season = seasonal_category(mmdd, ylat)       # (ny,) 1..5
    si = season - 1
    nspec = len(species)
    gas_mask = np.array([s.reldiff > 0 for s in species])
    aero_mask = np.array([s.density > 0 and s.dquer > 0 for s in species])
    reldiff = np.array([max(s.reldiff, 0.0) for s in species])
    henry = np.array([s.henry for s in species])
    f0 = np.array([max(s.f0, 0.0) for s in species])

    rlu = np.zeros((nspec, ny, NUMCLASS))
    rgs = np.zeros((nspec, ny, NUMCLASS))
    rcl = np.zeros((nspec, ny, NUMCLASS))
    rm = np.zeros(nspec)
    for i, s in enumerate(species):
        if gas_mask[i]:
            rlu_t, rgs_t, rcl_t, rm_i = species_gas_tables(
                tables, s.henry, f0[i])
            rlu[i] = rlu_t[si]
            rgs[i] = rgs_t[si]
            rcl[i] = rcl_t[si]
            rm[i] = rm_i
    from ..constants import NI
    fract = np.zeros((nspec, NI))
    schmi = np.zeros((nspec, NI))
    vset = np.zeros((nspec, NI))
    for i, s in enumerate(species):
        sc = s.size_classes()
        if sc is not None:
            fract[i] = sc.fract
            schmi[i] = sc.schmi
            vset[i] = sc.vset
    return DrydepTables(
        xlanduse=xlanduse, z0=z0, season=season,
        gas_mask=gas_mask, reldiff=reldiff, henry=henry, f0=f0, rm=rm,
        ri=tables.ri[si], rlu=rlu, rgs=rgs, rcl=rcl, rac=tables.rac[si],
        aero_mask=aero_mask, fract=fract, schmi=schmi, vset=vset,
        dryvel=np.array([s.dryvel for s in species]))


def make_vdep_kernel(td: DrydepTables):
    """Jitted (ust, tt2, td2_e, ps, oli, ssr, precip, sd) -> vdep
    (nspec, ny, nx).  td2_e = vapor pressure ratio ew(td2)/ew(tt2) is
    computed by the caller (calcpar.f90:172-175)."""
    xlanduse = jnp.asarray(td.xlanduse, jnp.float32)
    z0_c = jnp.asarray(td.z0, jnp.float32)
    ri_s = jnp.asarray(td.ri, jnp.float32)        # (ny,13)
    rac_s = jnp.asarray(td.rac, jnp.float32)      # (ny,13)
    rlu_s = jnp.asarray(td.rlu, jnp.float32)      # (nspec,ny,13)
    rgs_s = jnp.asarray(td.rgs, jnp.float32)
    rcl_s = jnp.asarray(td.rcl, jnp.float32)
    nspec = td.gas_mask.shape[0]

    @jax.jit
    def vdep_field(ust, tt2, rh, ps, oli, ssr, precip, sd):
        ny, nx = ust.shape
        L = 1.0 / jnp.where(jnp.abs(oli) < 1e-30, 1e-30, oli)
        ust = jnp.maximum(ust, 1e-8)

        # water-vapor diffusivity + viscosity (getvdep.f90:88-105)
        diffh2o = 2.11e-5 * (tt2 / 273.15) ** 1.94 * (101325.0 / ps)
        tc = tt2 - 273.15
        myl = jnp.where(
            tc < 0, (1.718 + 0.0049 * tc - 1.2e-5 * tc * tc) * 1e-5,
            (1.718 + 0.0049 * tc) * 1e-5)
        rhoa = ps / (287.0 * tt2)
        nyl = myl / rhoa

        # snow switches all cover to class 12 (getvdep.f90:115-126)
        snowy = sd > 0.001
        slanduse = jnp.where(
            snowy[..., None],
            jax.nn.one_hot(11, NUMCLASS, dtype=xlanduse.dtype),
            xlanduse)

        # dynamic water roughness (calcpar.f90:170-172)
        z0 = jnp.broadcast_to(z0_c, (ny, nx, NUMCLASS))
        z0 = z0.at[..., 6].set(0.016 * ust * ust / GA)

        # Wesely stomatal pieces shared across species (getrc.f90:47-66)
        gr = ssr
        t_ok = (tc > 0.0) & (tc < 40.0)
        rs_base = jnp.where(
            t_ok[..., None],
            ri_s[:, None, :] * (1.0 + (200.0 / (gr[..., None] + 0.1)) ** 2)
            * (400.0 / jnp.maximum(tc[..., None] * (40.0 - tc[..., None]),
                                   1e-10)),
            1.0e25)
        wet = (rh > 0.9) | (precip > 0.0)
        rs_base = jnp.where(wet[..., None], rs_base * 3.0, rs_base)
        rdc = 100.0 * (1.0 + 1000.0 / (gr + 10.0))
        corr = 1000.0 * jnp.exp(-tc - 4.0)

        # aerodynamic resistance per class (raerod.f90), and its
        # cover-weighted mean for partdep
        ra = _raerod(L[..., None], ust[..., None], z0)     # (ny,nx,13)
        active = slanduse > EPS
        raquer = jnp.sum(jnp.where(active, ra * slanduse, 0.0), axis=-1)

        vdep = []
        for i in range(nspec):
            v = jnp.zeros((ny, nx), jnp.float32)
            if td.gas_mask[i]:
                # rb (getrb.f90)
                schmidt = nyl / diffh2o * td.reldiff[i]
                rb = 2.0 / (KARMAN * ust) * (schmidt / PR) ** 0.67
                # rc per class (getrc.f90:70-100)
                rsm = rs_base * td.reldiff[i] + td.rm[i]
                rluc = rlu_s[i][:, None, :] + corr[..., None]
                rclc = rcl_s[i][:, None, :] + corr[..., None]
                rgsc = rgs_s[i][:, None, :] + corr[..., None]
                rluo_r = 1.0 / (1.0 / 1000.0 + 1.0 / (3.0 * rluc))
                rluo_h = 1.0 / (1.0 / 3000.0 + 1.0 / (3.0 * rluc))
                rluc_r = 1.0 / (1.0 / (3.0 * rluc)
                                + 1e-7 * td.henry[i] + td.f0[i] / rluo_r)
                rluc_h = 1.0 / (1.0 / (3.0 * rluc)
                                + 1e-7 * td.henry[i] + td.f0[i] / rluo_h)
                rluc = jnp.where((precip > 0.0)[..., None], rluc_r,
                                 jnp.where((rh > 0.9)[..., None], rluc_h,
                                           rluc))
                rc = 1.0 / (1.0 / rsm + 1.0 / rluc
                            + 1.0 / (rdc[..., None] + rclc)
                            + 1.0 / (rac_s[:, None, :] + rgsc))
                rc = jnp.maximum(rc, 10.0)
                rtot = ra + rb[..., None] + rc
                vd = jnp.where(rtot > 0.0, 1.0 / rtot, 9.999)
                v = jnp.sum(jnp.where(active, vd * slanduse, 0.0), axis=-1)
            if td.aero_mask[i]:
                # partdep.f90: per size bin, Stokes-corrected deposition
                vs = jnp.asarray(td.vset[i], jnp.float32)      # (NI,)
                sch = jnp.asarray(td.schmi[i], jnp.float32)
                fr = jnp.asarray(td.fract[i], jnp.float32)
                stokes = vs[None, None, :] / GA * ust[..., None] ** 2 \
                    / nyl[..., None]
                alpha = -3.0 / jnp.maximum(stokes, 1e-30)
                extra = jnp.where(alpha <= np.log10(EPS),
                                  0.0, 10.0 ** alpha)
                rdp = 1.0 / ((sch[None, None, :] + extra)
                             * ust[..., None])
                vdepj = vs + 1.0 / (raquer[..., None] + rdp
                                    + raquer[..., None] * rdp * vs)
                vdepj = jnp.where(ust[..., None] > EPS, vdepj, vs)
                v = v + jnp.sum(vdepj * fr, axis=-1)
            if (not td.gas_mask[i] and not td.aero_mask[i]
                    and td.dryvel[i] > 0.0):
                v = jnp.full((ny, nx), td.dryvel[i], jnp.float32)
            vdep.append(v)
        return jnp.stack(vdep)

    return vdep_field
