"""Scalar per-particle oracle of the reference integrator.

A line-by-line host-side (numpy float32) transcription of
/root/reference/src/advance.f90 (fixed-step path, method=0/CTL<0),
initialize.f90, hanna.f90, hanna1.f90, interpol_all.f90 and
interpol_wind{,_short}.f90, consuming the SAME `rannumb` table and
`nrand` index chase as the Fortran (legacy_rng).  It exists so the
kernel can be validated under matched RNG streams: the reference binary
is not buildable here (no Fortran toolchain), so this oracle is the
executable form of the reference's arithmetic, written from the Fortran
sources, NOT from the JAX kernel.

Scope: mother grid only, no nests, no polar-stereographic caps, no CBL,
no adaptive substepping — the stock-COMMAND fixed-step configuration
(turbswitch on/off, ifine>=1, free troposphere/stratosphere branches,
mesoscale fluctuations, windalign, cyclic/pole BCs, Petterssen
corrector, optional settling).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..constants import D_STRAT, D_TROP, GA, PI180, TURBMESOSCALE
from ..met.fields import (F2_HMIX, F2_OLI, F2_TROPO, F2_USTAR, F2_WSTAR,
                          F3_DRHODZ, F3_RHO, F3_TT, F3_U, F3_V, F3_W)
from .legacy_rng import MAXRAND, NrandStream

f32 = np.float32


@dataclass
class OracleParams:
    nx: int
    ny: int
    nz: int
    xglobal: bool
    ldirect: int
    turbswitch: bool
    ifine: int
    lsynctime: int
    lwindinterv: int
    dx: float
    dy: float
    ylat0: float
    dxconst: float
    dyconst: float
    maxrand: int = MAXRAND
    # optional single-species settling (get_settling.f90)
    settling: bool = False
    sp_density: float = -1.0
    sp_dquer: float = 0.0       # [um]
    sp_cunningham: float = 0.0
    sp_vsetaver: float = 0.0
    # adaptive per-particle time stepping (method=1, ctl>0;
    # readcommand.f90:378-384); forward runs only
    method: int = 0
    # skewed CBL scheme (CBLFLAG=1, advance.f90:405-442, cbl.f90,
    # re_initialize_particle.f90, initialize_cbl_vel.f90); requires
    # turbswitch, fixed-step (method=0)
    cblflag: bool = False
    ctl: float = -5.0
    mintime: int = 1
    # constant dry-deposition velocity [m/s] for the in-loop deposition
    # probability (advance.f90:582-599 with getvdep.f90:196-203's
    # prescribed-dryvel rule); 0 = no dry deposition
    vdep: float = 0.0


class Turb:
    __slots__ = ("sigu", "sigv", "sigw", "dsigwdz", "dsigw2dz",
                 "tlu", "tlv", "tlw")


def _hanna(z, h, ust, wst, ol):
    """hanna.f90:38-106 (turbswitch form)."""
    t = Turb()
    zeta = z / h
    if h / abs(ol) < 1.0:
        ust = max(f32(1.0e-4), ust)
        corr = z / ust
        t.sigu = f32(1.0e-2) + f32(2.0) * ust * f32(math.exp(-3.0e-4 * corr))
        sigw = f32(1.3) * ust * f32(math.exp(-2.0e-4 * corr))
        t.dsigwdz = f32(-2.0e-4) * sigw
        sigw = sigw + f32(1.0e-2)
        t.sigw = sigw
        t.sigv = sigw
        t.tlu = f32(0.5) * z / sigw / (f32(1.0) + f32(1.5e-3) * corr)
        t.tlv = t.tlu
        t.tlw = t.tlu
    elif ol < 0.0:
        t.sigu = f32(1.0e-2) + ust * f32((12.0 - 0.5 * h / ol) ** 0.33333)
        t.sigv = t.sigu
        t.sigw = f32(math.sqrt(1.2 * wst ** 2 * (1.0 - 0.9 * zeta)
                               * zeta ** 0.66666
                               + (1.8 - 1.4 * zeta) * ust ** 2)) + f32(1.0e-2)
        t.dsigwdz = f32(0.5 / t.sigw / h * (-1.4 * ust ** 2 + wst ** 2
                        * (0.8 * max(zeta, 1.0e-3) ** (-0.33333)
                           - 1.8 * zeta ** 0.66666)))
        t.tlu = f32(0.15) * h / t.sigu
        t.tlv = t.tlu
        if z < abs(ol):
            t.tlw = f32(0.1 * z / (t.sigw * (0.55 - 0.38 * abs(z / ol))))
        elif zeta < 0.1:
            t.tlw = f32(0.59 * z / t.sigw)
        else:
            t.tlw = f32(0.15 * h / t.sigw * (1.0 - math.exp(-5.0 * zeta)))
    else:
        t.sigu = f32(1.0e-2) + f32(2.0) * ust * (f32(1.0) - zeta)
        t.sigv = f32(1.0e-2) + f32(1.3) * ust * (f32(1.0) - zeta)
        t.sigw = t.sigv
        t.dsigwdz = f32(-1.3) * ust / h
        t.tlu = f32(0.15 * h / t.sigu * math.sqrt(zeta))
        t.tlv = f32(0.467) * t.tlu
        t.tlw = f32(0.1 * h / t.sigw * zeta ** 0.8)
    t.tlu = max(f32(10.0), t.tlu)
    t.tlv = max(f32(10.0), t.tlv)
    t.tlw = max(f32(30.0), t.tlw)
    if t.dsigwdz == 0.0:
        t.dsigwdz = f32(1.0e-10)
    return t


def _hanna1(z, h, ust, wst, ol):
    """hanna1.f90:41-128 (CTL<0 form; dsigw2dz is d(sigw^2)/dz)."""
    t = Turb()
    zeta = z / h
    if h / abs(ol) < 1.0:
        ust = max(f32(1.0e-4), ust)
        t.sigu = max(f32(2.0) * ust * f32(math.exp(-3.0e-4 * z / ust)),
                     f32(1.0e-5))
        t.sigv = max(f32(1.3) * ust * f32(math.exp(-2.0e-4 * z / ust)),
                     f32(1.0e-5))
        t.sigw = t.sigv
        t.dsigw2dz = f32(-6.76e-4) * ust * f32(math.exp(-4.0e-4 * z / ust))
        t.tlu = f32(0.5 * z / t.sigw / (1.0 + 1.5e-3 * z / ust))
        t.tlv = t.tlu
        t.tlw = t.tlu
    elif ol < 0.0:
        t.sigu = max(ust * f32((12.0 - 0.5 * h / ol) ** 0.33333), f32(1.0e-6))
        t.sigv = t.sigu
        if zeta < 0.03:
            sigw = f32(0.96 * wst * (3 * zeta - ol / h) ** 0.33333)
            t.dsigw2dz = f32(1.8432 * wst * wst / h
                             * (3 * zeta - ol / h) ** (-0.33333))
        elif zeta < 0.4:
            s1 = f32(0.96 * (3 * zeta - ol / h) ** 0.33333)
            s2 = f32(0.763 * zeta ** 0.175)
            if s1 < s2:
                sigw = wst * s1
                t.dsigw2dz = f32(1.8432 * wst * wst / h
                                 * (3 * zeta - ol / h) ** (-0.33333))
            else:
                sigw = wst * s2
                t.dsigw2dz = f32(0.203759 * wst * wst / h * zeta ** (-0.65))
        elif zeta < 0.96:
            sigw = f32(0.722 * wst * (1 - zeta) ** 0.207)
            t.dsigw2dz = f32(-0.215812 * wst * wst / h
                             * (1 - zeta) ** (-0.586))
        else:  # zeta < 1.0 (and ==1.0 keeps previous in Fortran; assume <1)
            sigw = f32(0.37) * wst
            t.dsigw2dz = f32(0.0)
        t.sigw = max(sigw, f32(1.0e-6))
        t.tlu = f32(0.15) * h / t.sigu
        t.tlv = t.tlu
        if z < abs(ol):
            t.tlw = f32(0.1 * z / (t.sigw * (0.55 - 0.38 * abs(z / ol))))
        elif zeta < 0.1:
            t.tlw = f32(0.59 * z / t.sigw)
        else:
            t.tlw = f32(0.15 * h / t.sigw * (1.0 - math.exp(-5.0 * zeta)))
    else:
        t.sigu = max(f32(2.0) * ust * (f32(1.0) - zeta), f32(1.0e-6))
        t.sigv = max(f32(1.3) * ust * (f32(1.0) - zeta), f32(1.0e-6))
        t.sigw = t.sigv
        t.dsigw2dz = f32(3.38 * ust * ust * (zeta - 1.0) / h)
        t.tlu = f32(0.15 * h / t.sigu * math.sqrt(zeta))
        t.tlv = f32(0.467) * t.tlu
        t.tlw = f32(0.1 * h / t.sigw * zeta ** 0.8)
    t.tlu = max(f32(10.0), t.tlu)
    t.tlv = max(f32(10.0), t.tlv)
    t.tlw = max(f32(30.0), t.tlw)
    return t


class _Interp:
    """Bilinear/time/vertical interpolation state for one particle
    (interpol_mod.f90 + interpol_all.f90 conventions)."""

    def __init__(self, prm: OracleParams, z0, z1, itime, memtime):
        self.prm = prm
        self.f3 = (z0.f3d, z1.f3d)        # numpy (NF3, nz, ny, nx)
        self.f2 = (z0.f2d, z1.f2d)
        self.height = np.asarray(z0.height, f32)
        dt1 = f32(itime - memtime[0])
        dt2 = f32(memtime[1] - itime)
        self.dt1, self.dt2 = dt1, dt2
        self.dtt = f32(1.0) / (dt1 + dt2)

    def corners(self, xt, yt):
        nx, ny = self.prm.nx, self.prm.ny
        ix = int(xt)
        jy = int(yt)
        nix = int(round(xt))
        njy = int(round(yt))
        ixp, jyp = ix + 1, jy + 1
        if self.prm.xglobal and ixp > nx - 1:
            ixp = 0
        if jyp >= ny:                      # advance.f90:228-231 pole fix
            jyp -= 1
        ddx = f32(xt - ix)
        ddy = f32(yt - jy)
        rddx, rddy = f32(1.0) - ddx, f32(1.0) - ddy
        p = (rddx * rddy, ddx * rddy, rddx * ddy, ddx * ddy)
        return ix, jy, ixp, jyp, nix, njy, p

    def _bilin(self, a, ix, jy, ixp, jyp, p):
        return (p[0] * a[jy, ix] + p[1] * a[jy, ixp]
                + p[2] * a[jyp, ix] + p[3] * a[jyp, ixp])

    def f2_time(self, fid, ix, jy, ixp, jyp, p):
        """Bilinear each time level, then temporal blend."""
        v1 = self._bilin(self.f2[0][fid], ix, jy, ixp, jyp, p)
        v2 = self._bilin(self.f2[1][fid], ix, jy, ixp, jyp, p)
        return (v1 * self.dt2 + v2 * self.dt1) * self.dtt

    def hmix_max(self, ix, jy, ixp, jyp):
        """Max over 4 corners x 2 times (advance.f90:236-252)."""
        h = f32(0.0)
        for m in range(2):
            a = self.f2[m][F2_HMIX]
            for j in (jy, jyp):
                for i in (ix, ixp):
                    if a[j, i] > h:
                        h = a[j, i]
        return h

    def indz_of(self, zt):
        """Level below current position (interpol_all.f90:117-125)."""
        ht = self.height
        indz = self.prm.nz - 2
        for i in range(1, self.prm.nz):
            if ht[i] > zt:
                indz = i - 1
                break
        return indz, indz + 1

    def profiles(self, xt, yt, zt):
        """interpol_all.f90: ust/wst/ol + u,v,w,rho,drhodz and wind-sigma
        profiles at the two bracketing levels."""
        ix, jy, ixp, jyp, nix, njy, p = self.corners(xt, yt)
        ust = self.f2_time(F2_USTAR, ix, jy, ixp, jyp, p)
        wst = self.f2_time(F2_WSTAR, ix, jy, ixp, jyp, p)
        oliaux = self.f2_time(F2_OLI, ix, jy, ixp, jyp, p)
        ol = f32(1.0) / oliaux if oliaux != 0.0 else f32(99999.0)
        indz, indzp = self.indz_of(zt)
        prof = {}
        for name, fid in (("u", F3_U), ("v", F3_V), ("w", F3_W),
                          ("rho", F3_RHO), ("rhograd", F3_DRHODZ)):
            lev = []
            for n in (indz, indzp):
                y1 = self._bilin(self.f3[0][fid][n], ix, jy, ixp, jyp, p)
                y2 = self._bilin(self.f3[1][fid][n], ix, jy, ixp, jyp, p)
                lev.append((y1 * self.dt2 + y2 * self.dt1) * self.dtt)
            prof[name] = lev
        sig = {}
        for name, fid in (("usig", F3_U), ("vsig", F3_V), ("wsig", F3_W)):
            lev = []
            for n in (indz, indzp):
                sl = f32(0.0)
                sq = f32(0.0)
                for m in range(2):
                    a = self.f3[m][fid][n]
                    for j in (jy, jyp):
                        for i in (ix, ixp):
                            sl = sl + a[j, i]
                            sq = sq + a[j, i] * a[j, i]
                xaux = sq - sl * sl / f32(8.0)
                lev.append(f32(0.0) if xaux < 1.0e-30
                           else f32(math.sqrt(xaux / 7.0)))
            sig[name] = lev
        return ust, wst, ol, indz, indzp, prof, sig

    def vert(self, zt, indz, indzp, lev):
        """interpol_all.f90 caller-side vertical blend (advance.f90:340-350)."""
        ht = self.height
        dz = f32(1.0) / (ht[indzp] - ht[indz])
        dz1 = (f32(zt) - ht[indz]) * dz
        dz2 = (ht[indzp] - f32(zt)) * dz
        return dz1 * lev[1] + dz2 * lev[0]

    def profiles_full(self, xt, yt):
        """Full vertical columns of u,v,w,rho,drhodz + per-level wind
        sigmas at the frozen horizontal stencil — the adaptive loop's
        profile store (interpol_all.f90 with every level filled; the
        reference fills levels lazily via interpol_misslev, numerically
        identical).  Returns (ust, wst, ol, prof[name][nz], sig[name][nz])."""
        ix, jy, ixp, jyp, nix, njy, p = self.corners(xt, yt)
        ust = self.f2_time(F2_USTAR, ix, jy, ixp, jyp, p)
        wst = self.f2_time(F2_WSTAR, ix, jy, ixp, jyp, p)
        oliaux = self.f2_time(F2_OLI, ix, jy, ixp, jyp, p)
        ol = f32(1.0) / oliaux if oliaux != 0.0 else f32(99999.0)
        nz = self.prm.nz
        prof = {}
        for name, fid in (("u", F3_U), ("v", F3_V), ("w", F3_W),
                          ("rho", F3_RHO), ("rhograd", F3_DRHODZ)):
            prof[name] = [
                (self._bilin(self.f3[0][fid][n], ix, jy, ixp, jyp, p)
                 * self.dt2
                 + self._bilin(self.f3[1][fid][n], ix, jy, ixp, jyp, p)
                 * self.dt1) * self.dtt
                for n in range(nz)]
        sig = {}
        for name, fid in (("usig", F3_U), ("vsig", F3_V), ("wsig", F3_W)):
            lev = []
            for n in range(nz):
                sl = f32(0.0)
                sq = f32(0.0)
                for m in range(2):
                    a = self.f3[m][fid][n]
                    for j in (jy, jyp):
                        for i in (ix, ixp):
                            sl = sl + a[j, i]
                            sq = sq + a[j, i] * a[j, i]
                xaux = sq - sl * sl / f32(8.0)
                lev.append(f32(0.0) if xaux < 1.0e-30
                           else f32(math.sqrt(xaux / 7.0)))
            sig[name] = lev
        return ust, wst, ol, prof, sig

    def wind16(self, xt, yt, zt):
        """interpol_wind.f90: u,v,w + 16-sample wind sigmas (above PBL)."""
        ix, jy, ixp, jyp, _, _, p = self.corners(xt, yt)
        indz, indzp = self.indz_of(zt)
        out = []
        for fid in (F3_U, F3_V, F3_W):
            lev = []
            for n in (indz, indzp):
                y1 = self._bilin(self.f3[0][fid][n], ix, jy, ixp, jyp, p)
                y2 = self._bilin(self.f3[1][fid][n], ix, jy, ixp, jyp, p)
                lev.append((y1 * self.dt2 + y2 * self.dt1) * self.dtt)
            out.append(self.vert(zt, indz, indzp, lev))
        sig = []
        for fid in (F3_U, F3_V, F3_W):
            sl = f32(0.0)
            sq = f32(0.0)
            for m in range(2):
                for n in (indz, indzp):
                    a = self.f3[m][fid][n]
                    for j in (jy, jyp):
                        for i in (ix, ixp):
                            sl = sl + a[j, i]
                            sq = sq + a[j, i] * a[j, i]
            xaux = sq - sl * sl / f32(16.0)
            sig.append(f32(0.0) if xaux < 1.0e-30
                       else f32(math.sqrt(xaux / 15.0)))
        return out[0], out[1], out[2], sig[0], sig[1], sig[2]

    def wind_short(self, xt, yt, zt, itime2):
        """interpol_wind_short.f90 at a different time (Petterssen)."""
        dt1 = f32(itime2 - self._memtime0)
        dt2 = f32(self._memtime1 - itime2)
        dtt = f32(1.0) / (dt1 + dt2)
        ix, jy, ixp, jyp, _, _, p = self.corners(xt, yt)
        indz, indzp = self.indz_of(zt)
        out = []
        for fid in (F3_U, F3_V, F3_W):
            lev = []
            for n in (indz, indzp):
                y1 = self._bilin(self.f3[0][fid][n], ix, jy, ixp, jyp, p)
                y2 = self._bilin(self.f3[1][fid][n], ix, jy, ixp, jyp, p)
                lev.append((y1 * dt2 + y2 * dt1) * dtt)
            out.append(self.vert(zt, indz, indzp, lev))
        return out


def _viscosity(t):
    return f32(1.827e-5 * (291.15 + 120.0) / (t + 120.0)
               * (t / 291.15) ** 1.5)


def _settling(prm: OracleParams, itp: _Interp, xt, yt, zt):
    """get_settling.f90:100-127 at the particle position (T, rho from the
    first time level, nearest column — mirrors the kernel's settling
    gather which uses z0 and the rounded column)."""
    nix = min(max(int(round(xt)), 0), prm.nx - 1)
    njy = min(max(int(round(yt)), 0), prm.ny - 1)
    indz, indzp = itp.indz_of(zt)
    ht = itp.height
    dz1 = min(max((f32(zt) - ht[indz]) / (ht[indzp] - ht[indz]), 0.0), 1.0)
    tt = (itp.f3[0][F3_TT][indz, njy, nix] * (1 - dz1)
          + itp.f3[0][F3_TT][indzp, njy, nix] * dz1)
    rhoa = (itp.f3[0][F3_RHO][indz, njy, nix] * (1 - dz1)
            + itp.f3[0][F3_RHO][indzp, njy, nix] * dz1)
    if prm.sp_density <= 0.0:
        return f32(0.0)
    vis_kin = _viscosity(tt) / rhoa
    d_m = f32(prm.sp_dquer / 1.0e6)
    settl = f32(prm.sp_vsetaver)
    reynolds = d_m * abs(settl) / vis_kin
    for _ in range(5):
        re = max(reynolds, 1e-12)
        if re < 1.917:
            c_d = f32(24.0 / re)
        elif re < 500.0:
            c_d = f32(18.5 / re ** 0.6)
        else:
            c_d = f32(0.44)
        settl = -f32(math.sqrt(4.0 * GA * d_m * prm.sp_density
                               * prm.sp_cunningham / (3.0 * c_d * rhoa)))
        reynolds = d_m * abs(settl) / vis_kin
    return settl


# ---------------------------------------------------------------------------
# CBL skewed scheme: scalar f32 transcriptions of cbl.f90,
# re_initialize_particle.f90 and initialize_cbl_vel.f90
# ---------------------------------------------------------------------------

_USURAD2 = f32(0.7071067812)
_USURAD2P = f32(0.3989422804)
_CBL_C0 = f32(3.0)
_COSTLUAR4 = f32(0.66667)
_EPS_C = f32(0.000001)


def _cbrt(x):
    return f32(math.copysign(abs(float(x)) ** (1.0 / 3.0), float(x)))


def _cbl_transition(h, ol):
    if -h / ol < 15.0:
        return f32(math.sin(((-float(h) / float(ol)) + 10.0) / 10.0
                            * math.pi) / 2.0 + 0.5)
    return f32(1.0)


def _cbl_reduced(zp, wst, h, sigw, ol):
    """The reduced bi-Gaussian parameter set of
    re_initialize_particle.f90:48-73 / initialize_cbl_vel.f90:49-75
    (no derivatives, xluarw = sqrt(rluarw)).  Returns
    (aluarw, sigmawa, sigmawb, wa, wb)."""
    z = f32(zp / h)
    transition = _cbl_transition(h, ol)
    w2 = f32(sigw * sigw)
    w3 = f32((f32(1.2) * z * f32((1.0 - z) ** 1.5) + _EPS_C)
             * wst ** 3 * transition)
    skew = f32(w3 / w2 ** 1.5)
    skew2 = f32(skew * skew)
    radw2 = f32(math.sqrt(w2))
    fluarw = f32(_COSTLUAR4 * skew ** f32(0.333333333333333))
    fluarw2 = f32(fluarw * fluarw)
    rluarw = f32((1.0 + fluarw2) ** 3 * skew2
                 / ((3.0 + fluarw2) ** 2 * fluarw2))
    xluarw = f32(math.sqrt(rluarw))
    aluarw = f32(0.5 * (1.0 - xluarw / math.sqrt(4.0 + rluarw)))
    bluarw = f32(1.0 - aluarw)
    sigmawa = f32(radw2 * math.sqrt(bluarw / (aluarw * (1.0 + fluarw2))))
    sigmawb = f32(radw2 * math.sqrt(aluarw / (bluarw * (1.0 + fluarw2))))
    wa = f32(fluarw * sigmawa)
    wb = f32(fluarw * sigmawb)
    return aluarw, sigmawa, sigmawb, wa, wb


def _cbl_scalar(wp, zp, ust, wst, h, rhoa, rhograd, sigw, dsigwdz, tlw,
                ol, ldirect):
    """cbl.f90: drift ath, diffusion bth, and the 6-sigma outlier flag.
    Full derivative chain, f32."""
    timedir = f32(ldirect)
    dens, ddens = rhoa, rhograd
    z = f32(zp / h)
    transition = _cbl_transition(h, ol)
    w2 = f32(sigw * sigw)
    dw2 = f32(2.0 * sigw * dsigwdz)
    alfa = f32(2.0 * w2 / (_CBL_C0 * tlw))
    wold = f32(timedir * wp)
    w3 = f32((f32(1.2) * z * f32((1.0 - z) ** 1.5) + _EPS_C)
             * wst ** 3 * transition)
    dw3 = f32(f32(1.2) * (f32((1.0 - z) ** 1.5)
                          + z * f32(1.5) * f32((1.0 - z) ** 0.5)
                          * f32(-1.0)) * wst ** 3 * f32(1.0 / h)
              * transition)
    skew = f32(w3 / w2 ** 1.5)
    skew2 = f32(skew * skew)
    dskew = f32((dw3 * w2 ** 1.5 - w3 * 1.5 * w2 ** 0.5 * dw2) / w2 ** 3)
    radw2 = f32(w2 ** 0.5)
    dradw2 = f32(0.5 * w2 ** (-0.5) * dw2)
    fluarw = f32(_COSTLUAR4 * _cbrt(skew))
    fluarw2 = f32(fluarw * fluarw)
    if skew != 0.0:
        dfluarw = f32(_COSTLUAR4 * (1.0 / 3.0) * _cbrt(skew ** -2.0)
                      * dskew)
        rluarw = f32((1.0 + fluarw2) ** 3 * skew2
                     / ((3.0 + fluarw2) ** 2 * fluarw2))
        xluarw = f32((1.0 + fluarw2) ** 1.5 * skew
                     / ((3.0 + fluarw2) * fluarw))
        drluarw = f32((
            ((3.0 * (1.0 + fluarw2) ** 2 * (2.0 * fluarw * dfluarw)
              * skew2)
             + (1.0 + fluarw2) ** 3 * 2.0 * skew * dskew)
            * (3.0 + fluarw2) ** 2 * fluarw2
            - (1.0 + fluarw2) ** 3 * skew2
            * ((2.0 * (3.0 + fluarw2) * (2.0 * fluarw * dfluarw)
                * fluarw2)
               + (3.0 + fluarw2) ** 2 * 2.0 * fluarw * dfluarw))
            / ((3.0 + fluarw2) ** 2 * fluarw2) ** 2)
        dxluarw = f32((
            ((1.5 * (1.0 + fluarw2) ** 0.5 * (2.0 * fluarw * dfluarw)
              * skew)
             + (1.0 + fluarw2) ** 1.5 * dskew)
            * (3.0 + fluarw2) * fluarw
            - (1.0 + fluarw2) ** 1.5 * skew
            * (3.0 * dfluarw + 3.0 * fluarw2 * dfluarw))
            / ((3.0 + fluarw2) * fluarw) ** 2)
    else:
        dfluarw = rluarw = drluarw = xluarw = dxluarw = f32(0.0)

    aluarw = f32(0.5 * (1.0 - xluarw / (4.0 + rluarw) ** 0.5))
    bluarw = f32(1.0 - aluarw)
    daluarw = f32(-0.5 * ((dxluarw * (4.0 + rluarw) ** 0.5)
                          - (0.5 * xluarw * (4.0 + rluarw) ** (-0.5)
                             * drluarw)) / (4.0 + rluarw))
    dbluarw = f32(-daluarw)
    sigmawa = f32(radw2 * (bluarw / (aluarw * (1.0 + fluarw2))) ** 0.5)
    sigmawb = f32(radw2 * (aluarw / (bluarw * (1.0 + fluarw2))) ** 0.5)
    dsigmawa = f32(
        dradw2 * (bluarw / (aluarw * (1.0 + fluarw2))) ** 0.5
        + radw2 * ((0.5 * (bluarw / (aluarw * (1.0 + fluarw2))) ** -0.5)
                   * ((dbluarw * (aluarw * (1.0 + fluarw2))
                       - bluarw * (daluarw * (1.0 + fluarw2)
                                   + aluarw * 2.0 * fluarw * dfluarw))
                      / (aluarw * (1.0 + fluarw2)) ** 2)))
    dsigmawb = f32(
        dradw2 * (aluarw / (bluarw * (1.0 + fluarw2))) ** 0.5
        + radw2 * ((0.5 * (aluarw / (bluarw * (1.0 + fluarw2))) ** -0.5)
                   * ((daluarw * (bluarw * (1.0 + fluarw2))
                       - aluarw * (dbluarw * (1.0 + fluarw2)
                                   + bluarw * 2.0 * fluarw * dfluarw))
                      / (bluarw * (1.0 + fluarw2)) ** 2)))
    wa = f32(fluarw * sigmawa)
    wb = f32(fluarw * sigmawb)
    dwa = f32(dfluarw * sigmawa + fluarw * dsigmawa)
    dwb = f32(dfluarw * sigmawb + fluarw * dsigmawb)
    deltawa = f32(wold - wa)
    deltawb = f32(wold + wb)
    wold2 = f32(wold * wold)
    sigmawa2 = f32(sigmawa * sigmawa)
    sigmawb2 = f32(sigmawb * sigmawb)
    flagrein = (abs(deltawa) > 6.0 * sigmawa
                and abs(deltawb) > 6.0 * sigmawb)
    pa = f32(_USURAD2P * (1.0 / sigmawa)
             * math.exp(-(0.5 * (deltawa / sigmawa) ** 2)))
    pb = f32(_USURAD2P * (1.0 / sigmawb)
             * math.exp(-(0.5 * (deltawb / sigmawb) ** 2)))
    ptot = f32(dens * aluarw * pa + dens * bluarw * pb)
    aperfa = f32(deltawa * _USURAD2 / sigmawa)
    aperfb = f32(deltawb * _USURAD2 / sigmawb)
    phi = f32(
        -0.5 * (aluarw * dens * dwa + dens * wa * daluarw
                + aluarw * wa * ddens) * math.erf(aperfa)
        + sigmawa * (aluarw * dens * dsigmawa * (wold2 / sigmawa2 + 1.0)
                     + sigmawa * dens * daluarw
                     + sigmawa * ddens * aluarw
                     + aluarw * wold * dens / sigmawa2
                     * (sigmawa * dwa - wa * dsigmawa)) * pa
        + 0.5 * (bluarw * dens * dwb + wb * dens * dbluarw
                 + wb * bluarw * ddens) * math.erf(aperfb)
        + sigmawb * (bluarw * dens * dsigmawb * (wold2 / sigmawb2 + 1.0)
                     + sigmawb * dens * dbluarw
                     + sigmawb * ddens * bluarw
                     + bluarw * wold * dens / sigmawb2
                     * (-sigmawb * dwb + wb * dsigmawb)) * pb)
    q = f32(timedir * ((aluarw * dens * deltawa / sigmawa2) * pa
                       + (bluarw * dens * deltawb / sigmawb2) * pb))
    ath = f32((1.0 / ptot) * (-(_CBL_C0 / 2.0) * alfa * q + phi))
    bth = f32(math.sqrt(_CBL_C0 * alfa))
    return ath, bth, flagrein


def _reinit_scalar(prm, table, nrand, zt, wst, h, sigw, ol, wp_old,
                   stream=None):
    """re_initialize_particle.f90: redraw wp from the skewed pdf keeping
    the up/downdraft sign; consumes table entries from nrand+1 until
    accepted.  Returns (wp, nrand)."""
    R = prm.maxrand
    nrand += 1
    dcas1 = table[min(nrand, R)]
    alu, sa, sb, wa, wb = _cbl_reduced(zt, wst, h, sigw, ol)
    timedir = f32(prm.ldirect)
    s = f32(1.0) if wp_old >= 0.0 else f32(-1.0)
    tries = 0
    if s * timedir > 0:                       # updraft
        while True:
            wp = f32(dcas1 * sa + wa)
            if wp >= 0.0 or tries > 100:
                break
            nrand += 1
            tries += 1
            dcas1 = table[min(nrand, R)]
    else:                                     # downdraft
        while True:
            wp = f32(dcas1 * sb - wb)
            if wp <= 0.0 or tries > 100:
                break
            nrand += 1
            tries += 1
            dcas1 = table[min(nrand, R)]
    if stream is not None:
        stream.cbl_max_retries = max(
            getattr(stream, "cbl_max_retries", 0), tries)
    return f32(wp * timedir), nrand


def _init_cbl_scalar(prm, stream: NrandStream, zt, wst, h, sigw, ol):
    """initialize_cbl_vel.f90: fresh-particle raw wp from the skewed
    pdf; consumes dcas (ran3) + dcas1 (gasdev) from the shared chain."""
    alu, sa, sb, wa, wb = _cbl_reduced(zt, wst, h, sigw, ol)
    timedir = f32(prm.ldirect)
    dcas = stream.uniform()
    dcas1 = stream.gasdev()
    if dcas <= alu:
        return f32(timedir * (dcas1 * sa + wa))
    return f32(timedir * (dcas1 * sb - wb))


def oracle_initialize(prm: OracleParams, itp: _Interp, stream: NrandStream,
                      table, xt, yt, zt):
    """initialize.f90: turbulent + mesoscale velocity init for a fresh
    particle.  Returns (up, vp, wp, usigold, vsigold, wsigold, icbt)."""
    R = prm.maxrand
    nrand = stream.next_nrand()
    ix, jy, ixp, jyp, _, _, _ = itp.corners(xt, yt)
    h = max(itp.hmix_max(ix, jy, ixp, jyp), f32(1.0))

    idt = abs(prm.lsynctime)
    if zt / h <= 1.0:        # PBL
        ust, wst, ol, indz, indzp, prof, sig = itp.profiles(xt, yt, zt)
        t = _hanna(zt, h, ust, wst, ol) if prm.turbswitch \
            else _hanna1(zt, h, ust, wst, ol)
        if nrand + 2 > R:
            nrand = 1
        up = table[nrand] * t.sigu
        vp = table[nrand + 1] * t.sigv
        wp = table[nrand + 2]
        if not prm.turbswitch:
            wp = wp * t.sigw
        elif prm.cblflag:
            # initialize.f90:142-149
            if -h / ol > 5.0:
                wp = _init_cbl_scalar(prm, stream, zt, wst, h, t.sigw,
                                      ol)
            else:
                wp = f32(wp * t.sigw)
        if prm.method == 1:
            # initial adaptive step (initialize.f90:155-162)
            if prm.turbswitch:
                idt = int(min(t.tlw,
                              h / max(2.0 * abs(wp * t.sigw), 1e-5),
                              0.5 / abs(t.dsigwdz)) * prm.ctl)
            else:
                idt = int(min(t.tlw, h / max(2.0 * abs(wp), 1e-5),
                              600.0) * prm.ctl)
            idt = max(idt, prm.mintime)
        usig = f32(0.5) * (sig["usig"][1] + sig["usig"][0])
        vsig = f32(0.5) * (sig["vsig"][1] + sig["vsig"][0])
        wsig = f32(0.5) * (sig["wsig"][1] + sig["wsig"][0])
    else:                    # above PBL (initialize.f90:180-200)
        _, _, _, usig, vsig, wsig = itp.wind16(xt, yt, zt)
        if nrand + 1 > R:
            nrand = 1
        up = table[nrand] * f32(0.3)
        vp = table[nrand + 1] * f32(0.3)
        nrand += 2
        wp = f32(0.0)
    if nrand + 2 > R:
        nrand = 1
    usigold = table[nrand] * usig            # NO turbmesoscale factor
    vsigold = table[nrand + 1] * vsig        # (initialize.f90:215-217)
    wsigold = table[nrand + 2] * wsig
    return up, vp, wp, usigold, vsigold, wsigold, 1, idt


def oracle_advance(prm: OracleParams, itp: _Interp, stream: NrandStream,
                   table, itime, memtime, state):
    """advance.f90 fixed-step path for ONE particle.

    state: dict with xt (f64 grid units), yt, zt, up, vp, wp,
    usigold, vsigold, wsigold, icbt.  Returns (state, nstop)."""
    R = prm.maxrand
    itp._memtime0, itp._memtime1 = memtime
    xt, yt, zt = state["xt"], state["yt"], f32(state["zt"])
    up, vp, wp = f32(state["up"]), f32(state["vp"]), f32(state["wp"])
    usigold = f32(state["usigold"])
    vsigold = f32(state["vsigold"])
    wsigold = f32(state["wsigold"])
    icbt = state["icbt"]
    ldirect = prm.ldirect
    lsync = abs(prm.lsynctime)
    eps = f32(prm.nx / 3.0e5)
    eps2 = f32(1.0e-9)
    ht = itp.height
    nz = prm.nz

    dxsave = f32(0.0)
    dysave = f32(0.0)
    dawsave = f32(0.0)
    dcwsave = f32(0.0)
    nrand = stream.next_nrand()

    ix, jy, ixp, jyp, nix, njy, _ = itp.corners(xt, yt)
    h = itp.hmix_max(ix, jy, ixp, jyp)
    tropop = itp.f2[0][F2_TROPO][njy, nix]   # advance.f90:252 (nearest, t=1)
    zeta = zt / h

    settling = f32(0.0)

    prob = f32(state.get("prob", 0.0)) * 0.0    # reset (advance.f90:139-142)
    ldt = int(state.get("idt", lsync))
    itimec = itime
    to_ft = False                # mid-interval PBL exit (goto 700)
    if zeta <= 1.0:
        # ---- PBL branch (advance.f90:276-615); method=0 runs the loop
        # exactly once, method=1 until itimec covers the interval ----
        ust = wst = ol = None
        prof = sig = None
        loop = 0
        while True:
            loop += 1
            if prm.method == 1:
                ldt = min(ldt, abs(lsync - (itimec - itime) * ldirect))
                itimec = itimec + ldt * ldirect
            else:
                ldt = lsync
                itimec = itime + lsync * ldirect
            dt = f32(ldt)

            if loop == 1:
                ust, wst, ol, prof, sig = itp.profiles_full(xt, yt)
            indz, indzp = itp.indz_of(zt)
            u = itp.vert(zt, indz, indzp,
                         (prof["u"][indz], prof["u"][indzp]))
            v = itp.vert(zt, indz, indzp,
                         (prof["v"][indz], prof["v"][indzp]))
            w = itp.vert(zt, indz, indzp,
                         (prof["w"][indz], prof["w"][indzp]))
            rhoa = itp.vert(zt, indz, indzp,
                            (prof["rho"][indz], prof["rho"][indzp]))
            rhograd = itp.vert(zt, indz, indzp,
                               (prof["rhograd"][indz],
                                prof["rhograd"][indzp]))
            t = _hanna(zt, h, ust, wst, ol) if prm.turbswitch \
                else _hanna1(zt, h, ust, wst, ol)

            # horizontal OU (advance.f90:369-385)
            if nrand + 1 > R:
                nrand = 1
            if dt / t.tlu < 0.5:
                up = (f32(1.0) - dt / t.tlu) * up + table[nrand] * t.sigu \
                    * f32(math.sqrt(2.0 * dt / t.tlu))
            else:
                ru = f32(math.exp(-dt / t.tlu))
                up = ru * up + table[nrand] * t.sigu \
                    * f32(math.sqrt(1.0 - ru * ru))
            if dt / t.tlv < 0.5:
                vp = (f32(1.0) - dt / t.tlv) * vp + table[nrand + 1] \
                    * t.sigv * f32(math.sqrt(2.0 * dt / t.tlv))
            else:
                rv = f32(math.exp(-dt / t.tlv))
                vp = rv * vp + table[nrand + 1] * t.sigv \
                    * f32(math.sqrt(1.0 - rv * rv))
            nrand += 2

            if nrand + prm.ifine > R:
                nrand = 1
            rhoaux = rhograd / rhoa
            dtf = dt * f32(1.0 / prm.ifine)
            dtftlw = dtf / t.tlw

            # vertical Langevin, ifine substeps (advance.f90:396-498)
            for i in range(1, prm.ifine + 1):
                if prm.turbswitch and prm.cblflag:
                    # CBL branch (advance.f90:405-442); wp is RAW m/s
                    if not dtftlw < 0.5:
                        # reference units quirk: dtftlw>=0.5 falls into
                        # the exact-OU NORMALIZED update with raw wp
                        # (advance.f90:446-455), static nrand+i reads,
                        # chase untouched
                        rw = f32(math.exp(-dtftlw))
                        wp = f32((rw * wp
                                  + table[nrand + i]
                                  * f32(math.sqrt(1.0 - rw * rw))
                                  + t.tlw * (f32(1.0) - rw)
                                  * (t.dsigwdz + rhoaux * t.sigw))
                                 * f32(icbt))
                        delz = wp * t.sigw * dtf
                    elif -h / ol > 5.0:
                        nrand += 1
                        old_wp = wp
                        ath, bth, flagrein = _cbl_scalar(
                            wp, zt, ust, wst, h, rhoa, rhograd, t.sigw,
                            t.dsigwdz, t.tlw, ol, prm.ldirect)
                        wp = f32((wp + ath * dtf
                                  + bth * table[min(nrand, R)]
                                  * f32(math.sqrt(dtf))) * f32(icbt))
                        delz = wp * dtf
                        if flagrein:
                            wp, nrand = _reinit_scalar(
                                prm, table, nrand, zt, wst, h, t.sigw,
                                ol, old_wp, stream=stream)
                            delz = wp * dtf
                    else:
                        # weakly convective Gaussian on raw wp
                        # (advance.f90:425-442).  NOTE: keep this local
                        # named sgw — `sig` is the profile dict read
                        # again after the loop (advance.f90 sigma
                        # re-read), shadowing it crashes that read.
                        nrand += 1
                        sgw = t.sigw
                        ath = f32(-wp / t.tlw + sgw * t.dsigwdz
                                  + wp * wp / sgw * t.dsigwdz
                                  + sgw * sgw / rhoa * rhograd)
                        bth = f32(sgw * table[min(nrand, R)]
                                  * f32(math.sqrt(2.0 * dtftlw)))
                        wp = f32((wp + ath * dtf + bth) * f32(icbt))
                        delz = wp * dtf
                        if math.isnan(wp) or math.isinf(wp):
                            nrand += 1
                            wp = f32(sgw * table[min(nrand, R)])
                            delz = wp * dtf
                elif prm.turbswitch:
                    if dtftlw < 0.5:
                        wp = ((f32(1.0) - dtftlw) * wp
                              + table[nrand + i]
                              * f32(math.sqrt(2.0 * dtftlw))
                              + dtf * (t.dsigwdz + rhoaux * t.sigw)) \
                            * f32(icbt)
                    else:
                        rw = f32(math.exp(-dtftlw))
                        wp = (rw * wp
                              + table[nrand + i]
                              * f32(math.sqrt(1.0 - rw * rw))
                              + t.tlw * (f32(1.0) - rw)
                              * (t.dsigwdz + rhoaux * t.sigw)) * f32(icbt)
                    delz = wp * t.sigw * dtf
                else:
                    rw = f32(math.exp(-dtftlw))
                    wp = (rw * wp
                          + table[nrand + i]
                          * f32(math.sqrt(1.0 - rw * rw)) * t.sigw
                          + t.tlw * (f32(1.0) - rw)
                          * (t.dsigw2dz + rhoaux * t.sigw * t.sigw)) \
                        * f32(icbt)
                    delz = wp * dtf

                if abs(delz) > h:
                    delz = f32(math.fmod(float(delz), float(h)))
                if delz < -zt:
                    icbt = -1
                    zt = -zt - delz
                elif delz > (h - zt):
                    icbt = -1
                    zt = -zt - delz + f32(2.0) * h
                else:
                    icbt = 1
                    zt = zt + delz
                if i != prm.ifine:
                    # hanna_short refresh (advance.f90:494-496)
                    t = _hanna(zt, h, ust, wst, ol) if prm.turbswitch \
                        else _hanna1(zt, h, ust, wst, ol)
            if not prm.cblflag:
                # Fortran do-loop leaves i=ifine+1 (advance.f90:499
                # skips this advance when cblflag=1: the meso draws
                # then REUSE the last in-loop entry)
                nrand += prm.ifine + 1

            # next adaptive step (advance.f90:504-511)
            if prm.method == 1:
                if prm.turbswitch:
                    ldt = int(min(t.tlw,
                                  h / max(2.0 * abs(wp * t.sigw), 1e-5),
                                  0.5 / abs(t.dsigwdz)) * prm.ctl)
                else:
                    ldt = int(min(t.tlw,
                                  h / max(2.0 * abs(wp), 1e-5)) * prm.ctl)
                ldt = max(ldt, prm.mintime)

            if prm.settling:
                settling = _settling(prm, itp, xt, yt, zt)
                w = w + settling

            dxsave += u * dt
            dysave += v * dt
            dawsave += up * dt
            dcwsave += vp * dt
            zt = zt + w * dt * f32(ldirect)
            if zt >= ht[nz - 1]:
                zt = ht[nz - 1] - f32(100.0) * eps

            done = (itimec == itime + lsync * ldirect)
            if zt > h:
                if done:
                    break                       # goto 99
                to_ft = True                    # goto 700
                break

            # deposition probability (advance.f90:582-599), after the
            # vertical update, before the below-ground reflection
            if prm.vdep > 0.0 and zt < 2.0 * f32(15.0):
                prob = f32(1.0) + (prob - f32(1.0)) * f32(
                    math.exp(-prm.vdep * abs(float(dt)) / (2.0 * 15.0)))

            if zt < 0.0:
                zt = min(h - eps2, -zt)

            if done:
                break
        if not to_ft:
            indz, indzp = itp.indz_of(zt)
            usig = f32(0.5) * (sig["usig"][indzp] + sig["usig"][indz])
            vsig = f32(0.5) * (sig["vsig"][indzp] + sig["vsig"][indz])
            wsig = f32(0.5) * (sig["wsig"][indzp] + sig["wsig"][indz])
            if prm.method == 0:
                ldt = lsync
    if zeta > 1.0 or to_ft:
        # ---- free troposphere / stratosphere (advance.f90:628-708);
        # entered directly (zeta>1, full interval) or from a
        # mid-interval PBL exit with the remaining time (goto 700,
        # advance.f90:648 `ldt=abs(lsynctime-itimec+itime)`) ----
        u, v, w, usig, vsig, wsig = itp.wind16(xt, yt, zt)
        ldt = abs(lsync - (itimec - itime) * ldirect)
        dt = f32(ldt)
        if zt < tropop:
            uxscale = f32(math.sqrt(2.0 * D_TROP / dt))
            if nrand + 1 > R:
                nrand = 1
            ux = table[nrand] * uxscale
            vy = table[nrand + 1] * uxscale
            nrand += 2
            wpt = f32(0.0)
        elif zt < tropop + 1000.0:
            weight = (zt - tropop) / f32(1000.0)
            uxscale = f32(math.sqrt(2.0 * D_TROP / dt * (1.0 - weight)))
            if nrand + 2 > R:
                nrand = 1
            ux = table[nrand] * uxscale
            vy = table[nrand + 1] * uxscale
            wpscale = f32(math.sqrt(2.0 * D_STRAT / dt * weight))
            wpt = table[nrand + 2] * wpscale + f32(D_STRAT / 1000.0)
            nrand += 3
        else:
            if nrand > R:
                nrand = 1
            ux = f32(0.0)
            vy = f32(0.0)
            wpscale = f32(math.sqrt(2.0 * D_STRAT / dt))
            wpt = table[nrand] * wpscale
            nrand += 1
        wp = wpt
        if prm.settling:
            settling = _settling(prm, itp, xt, yt, zt)
            w = w + settling
        dxsave += (u + ux) * dt
        dysave += (v + vy) * dt
        zt = zt + (w + wp) * dt * f32(ldirect)
        if zt < 0.0:
            zt = min(h - eps2, -zt)

    # ---- mesoscale fluctuations (advance.f90:716-738) ----
    r = f32(math.exp(-2.0 * float(lsync) / float(prm.lwindinterv)))
    rs = f32(math.sqrt(1.0 - r * r))
    if nrand + 2 > R:
        nrand = 1
    usigold = r * usigold + rs * table[nrand] * usig * f32(TURBMESOSCALE)
    vsigold = r * vsigold + rs * table[nrand + 1] * vsig * f32(TURBMESOSCALE)
    wsigold = r * wsigold + rs * table[nrand + 2] * wsig * f32(TURBMESOSCALE)
    dxsave += usigold * f32(lsync)
    dysave += vsigold * f32(lsync)
    zt = zt + wsigold * f32(lsync)
    if zt < 0.0:
        zt = -zt

    # ---- windalign (windalign.f90) + position update ----
    ff = f32(math.sqrt(u * u + v * v))
    if ff > 1.0e-30:
        sinphi = v / ff
        cosphi = u / ff
    else:
        sinphi = f32(0.0)
        cosphi = f32(1.0)
    uxw = cosphi * dawsave - sinphi * dcwsave
    vyw = sinphi * dawsave + cosphi * dcwsave
    dxsave += uxw
    dysave += vyw
    cosfact = f32(prm.dxconst) / f32(
        math.cos((float(yt) * prm.dy + prm.ylat0) * PI180))
    xt = xt + np.float64(dxsave * cosfact * f32(ldirect))
    yt = yt + np.float64(dysave * f32(prm.dyconst) * f32(ldirect))

    def apply_bcs(xt, yt):
        nxm = f32(prm.nx - 1)
        nym = f32(prm.ny - 1)
        if prm.xglobal:
            if xt >= nxm:
                xt = xt - np.float64(nxm)
            if xt < 0.0:
                xt = xt + np.float64(nxm)
            if xt <= eps:
                xt = np.float64(eps)
            if abs(xt - nxm) <= eps:
                xt = np.float64(nxm - eps)
            if yt < 0.0:
                xt = np.float64(
                    math.fmod(float(xt) * prm.dx + 180.0 + 3600.0, 360.0)
                    / prm.dx)
                yt = -yt
            elif yt > nym:
                xt = np.float64(
                    math.fmod(float(xt) * prm.dx + 180.0 + 3600.0, 360.0)
                    / prm.dx)
                yt = np.float64(2.0 * nym) - yt
        exited = (xt < 0.0 or xt >= nxm or yt < 0.0 or yt > nym)
        return xt, yt, exited

    xt, yt, exited = apply_bcs(xt, yt)
    if exited:
        return state, 3
    if zt >= ht[nz - 1]:
        zt = ht[nz - 1] - f32(100.0) * eps

    # ---- Petterssen corrector (advance.f90:816-986) ----
    endtime = itime + ldt * ldirect
    if ldt == lsync and abs(endtime) <= abs(memtime[1]):
        # u/v/w here already include settling in w (advance.f90 adds
        # settling to w before memorizing uold/wold; the corrector adds
        # settling to the new wind too, advance.f90:893-906)
        uold, vold, wold = u, v, w
        u2, v2, w2 = itp.wind_short(float(xt), float(yt), zt, endtime)
        if prm.settling:
            w2 = w2 + settling
        du = (u2 - uold) / f32(2.0)
        dv = (v2 - vold) / f32(2.0)
        dw = (w2 - wold) / f32(2.0)
        zt = zt + dw * f32(ldt * ldirect)
        if zt < 0.0:
            zt = min(h - eps2, -zt)
        cosfact = f32(prm.dxconst) / f32(
            math.cos((float(yt) * prm.dy + prm.ylat0) * PI180))
        xt = xt + np.float64(du * cosfact * f32(ldt * ldirect))
        yt = yt + np.float64(dv * f32(prm.dyconst) * f32(ldt * ldirect))
        xt, yt, exited = apply_bcs(xt, yt)
        if exited:
            return state, 3
        if zt >= ht[nz - 1]:
            zt = ht[nz - 1] - f32(100.0) * eps

    state = dict(state)
    state.update(xt=xt, yt=yt, zt=zt, up=up, vp=vp, wp=wp,
                 usigold=usigold, vsigold=vsigold, wsigold=wsigold,
                 icbt=icbt, idt=ldt, prob=float(prob))
    return state, 0


def run_oracle(prm: OracleParams, z0, z1, memtime, particles, nsteps,
               itime0=0, seed=-7, table=None, stream=None, nstops=None,
               do_init=True):
    """Drive initialize+advance over nsteps sync intervals, mirroring the
    scheduler's per-particle order (timemanager.f90:531-712).

    particles: list of state dicts with xt/yt/zt (+ itramem).
    Returns (states, nstops, trace) where trace[step][j] = (xt, yt, zt).

    For multi-wind-interval runs (the getfields swap), call repeatedly
    with new (z0, z1, memtime), passing the returned states plus the
    SAME stream/nstops and do_init=False so the ran3 chain and the
    termination bookkeeping continue across intervals."""
    from .legacy_rng import make_rannumb
    if table is None:
        table = make_rannumb(prm.maxrand, seed)
    if stream is None:
        stream = NrandStream(seed, prm.maxrand)
    states = [dict(s) for s in particles]
    if nstops is None:
        nstops = [0] * len(states)
    trace = []
    for k in range(nsteps):
        itime = itime0 + k * prm.lsynctime * prm.ldirect
        itp = _Interp(prm, z0, z1, itime, memtime)
        itp._memtime0, itp._memtime1 = memtime
        for j, s in enumerate(states):
            if nstops[j]:
                continue
            if do_init and k == 0:   # fresh at itime0 (timemanager:553)
                (s["up"], s["vp"], s["wp"], s["usigold"], s["vsigold"],
                 s["wsigold"], s["icbt"], s["idt"]) = oracle_initialize(
                    prm, itp, stream, table, float(s["xt"]),
                    float(s["yt"]), f32(s["zt"]))
            states[j], nstops[j] = oracle_advance(
                prm, itp, stream, table, itime, memtime, s)
        trace.append([(float(s["xt"]), float(s["yt"]), float(s["zt"]))
                      for s in states])
    return states, nstops, trace
