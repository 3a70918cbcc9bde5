"""The particle advance kernel: one lsynctime update for ALL particles.

Vectorized re-design of the reference's per-particle integrator
(/root/reference/src/advance.f90, called from the scheduler loop
timemanager.f90:531-712): zero-acceleration advection with Petterssen
corrector, Hanna/Langevin PBL turbulence with exact OU discretization,
constant-diffusivity free troposphere / stratosphere, mesoscale velocity
fluctuations, gravitational settling, reflection boundary conditions, and
cyclic/pole handling — all as ONE branch-free vectorized function over the
SoA particle arrays, jitted and shard_map-able.

Fixed-step mode (CTL<0, method=0, the stock COMMAND default) runs the PBL
pass once per sync interval; adaptive mode (method=1) reruns it in a
bounded substep loop with per-particle time remaining (advance.f90:282-609).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..constants import D_STRAT, D_TROP, GA, PI180, R_EARTH, TURBMESOSCALE
from ..met.fields import ZFields, F2_HMIX, F2_TROPO, F2_USTAR, F2_WSTAR, F2_OLI, F3_TT, F3_RHO
from . import rng
from .cbl import cbl_terms, init_cbl_wp, legacy_reinit_wp, reinit_wp
from .hanna import hanna, hanna1
from .interp import (HorizWeights, StepTablesQuad,
                     build_step_tables_quad, gather_corners_3d,
                     horiz_weights, sample_all_quad, vert_weights,
                     wind10_quad, interp_wind_legacy, interp_wind_short,
                     interp_wind_short_quad, interp_2d,
                     gather_corners_2d_ln, hmix_max)
from .state import Particles, ds_add


class StepConfig(NamedTuple):
    """Static (compile-time) configuration of the advance kernel.  Anything
    that changes per run but not per compile lives in StepParams instead so
    one XLA executable serves many runs."""
    nx: int
    ny: int
    nz: int
    xglobal: bool
    ldirect: int
    turbswitch: bool
    ifine: int
    method: int
    turboff: bool = False
    nspec: int = 1
    settling: bool = False
    cblflag: bool = False       # skewed CBL scheme (cbl.f90); wp is raw m/s
    maxsubsteps: int = 12       # (unused; adaptive mode now loops until
    #                             the interval is covered, bounded by
    #                             dt_total/mintime)
    mintime: float = 1.0        # minimum adaptive substep [s] (par_mod)
    nest_nx: int = 0            # single nested met grid (0 = no nest);
    nest_ny: int = 0            # superseded by `nests` when that is set
    nests: tuple = ()           # multi-nest shapes ((nx, ny), ...)
    #                             ordered OUTERMOST -> INNERMOST; the
    #                             innermost containing nest wins per
    #                             particle (advance.f90:167-175 scans
    #                             j=numbnests,1,-1)
    polar: bool = False         # global grid reaching the poles: use the
    #                             stereographic update poleward of 75 deg
    tile_mode: bool = False     # domain-decomposed tile step: positions
    #                             are tile-local, BCs/exits are applied
    #                             GLOBALLY by the caller (parallel/domain)
    met_bf16: bool = True       # store the per-step quad-corner row
    #                             tables in bfloat16 (~0.4% wind
    #                             rounding, widened to f32 right after
    #                             the gather): half the bytes per row
    #                             gather and half the tables' device
    #                             memory.  Set False for f32
    #                             interpolation (validation studies)
    legacy_quad: bool = False   # matched-RNG validation of the
    #                             PRODUCTION interpolation path: draws
    #                             still come from the rannumb table in
    #                             reference order, but every met sample
    #                             goes through the quad-corner row
    #                             tables (the path bench.py measures)
    #                             instead of the reference-exact
    #                             per-time-level branch.  Only the
    #                             wind-sigma estimator differs then
    #                             (blended 4-sample vs 8/16-sample);
    #                             with met_bf16=False the deterministic
    #                             core agrees with legacy interp to f32
    #                             roundoff (tests/test_quad_equiv.py)


class StepParams(NamedTuple):
    """Traced scalars of the advance kernel (no recompile on change)."""
    dx: jnp.ndarray
    dy: jnp.ndarray
    ylat0: jnp.ndarray
    dxconst: jnp.ndarray
    dyconst: jnp.ndarray
    lsynctime: jnp.ndarray      # positive length [s]
    fine: jnp.ndarray           # 1/ifine
    ctl: jnp.ndarray            # TL/dt ratio (>0 in adaptive mode)
    lwindinterv: jnp.ndarray
    # per-species settling parameters, shape (nspec,) (get_settling.f90;
    # the settling species of a particle is the first one it carries
    # mass of, advance.f90:518-531)
    sp_density: jnp.ndarray
    sp_dquer: jnp.ndarray       # [um]
    sp_cunningham: jnp.ndarray
    sp_vsetaver: jnp.ndarray
    # nested met grid windows in mother-grid units, (nnest,) arrays
    # ordered outermost -> innermost (com_mod xln/xrn...)
    xln: jnp.ndarray
    yln: jnp.ndarray
    xrn: jnp.ndarray
    yrn: jnp.ndarray
    xresoln: jnp.ndarray        # mother dx / nest dx
    yresoln: jnp.ndarray
    xlon0_pol: jnp.ndarray      # grid lon origin (polar-cap projection)
    # tile-mode globals (parallel/domain.py): x offset of this tile's
    # origin in mother-grid units, and the global cyclic width nx-1
    # (0 -> not tiled, use cfg.nx-1)
    tile_x0: jnp.ndarray
    nxm_pol: jnp.ndarray

    @classmethod
    def make(cls, dx, dy, ylat0, dxconst, dyconst, lsynctime, fine,
             ctl=-5.0, lwindinterv=3600, sp_density=-1.0, sp_dquer=0.0,
             sp_cunningham=0.0, sp_vsetaver=0.0,
             xln=0.0, yln=0.0, xrn=0.0, yrn=0.0,
             xresoln=1.0, yresoln=1.0, xlon0=-180.0,
             tile_x0=0.0, nxm_pol=0.0):
        f = jnp.float32
        def v(x):  # species vectors: scalar -> (1,), sequence -> (nspec,)
            return jnp.atleast_1d(jnp.asarray(x, jnp.float32))
        return cls(f(dx), f(dy), f(ylat0), f(dxconst), f(dyconst),
                   f(abs(lsynctime)), f(fine), f(ctl), f(lwindinterv),
                   v(sp_density), v(sp_dquer), v(sp_cunningham),
                   v(sp_vsetaver), v(xln), v(yln), v(xrn), v(yrn),
                   v(xresoln), v(yresoln), f(xlon0),
                   f(tile_x0), f(nxm_pol))


class LegacyRnd(NamedTuple):
    """Matched-RNG mode inputs: the reference's precomputed gaussian
    table (1-based, validation.legacy_rng.make_rannumb) and the per-call
    `nrand` base indices drawn host-side from the ran3 chain in
    reference consumption order (advance.f90:153, initialize.f90:68).
    When passed to advance_all, every random draw is replaced by the
    exact table reads the Fortran performs, including the mid-call
    `if (nrand+k.gt.maxrand) nrand=1` wraparounds."""
    table: jnp.ndarray        # (maxrand+1,) f32, [0] unused
    nrand_init: jnp.ndarray   # (n,) i32 base for initialize.f90 draws
    nrand: jnp.ndarray        # (n,) i32 base for advance.f90 draws
    #: CBL matched mode only: the initialize_cbl_vel.f90 ran3/gasdev
    #: draws for fresh convective-PBL particles, pre-drawn host-side in
    #: reference chain order (None outside cblflag runs)
    cbl_dcas: jnp.ndarray | None = None    # (n,) uniform ran3
    cbl_dcas1: jnp.ndarray | None = None   # (n,) gasdev gaussian


def _legacy_draws(leg: LegacyRnd, cfg: StepConfig, pbl, in_trop, in_trans):
    """Build the per-site random arrays from the rannumb table, mirroring
    the nrand index arithmetic of initialize.f90/advance.f90 (see the
    file:line map in LegacyRnd and tests/test_matched_rng.py)."""
    tab = leg.table
    R = tab.shape[0] - 1

    # ----- initialize.f90 -----
    ni = leg.nrand_init
    b = jnp.where(ni + 2 > R, 1, ni)             # PBL check (line 130)
    a = jnp.where(ni + 1 > R, 1, ni)             # above-PBL check (192)
    ibase = jnp.where(pbl, b, a)
    mb_i = jnp.where(pbl, b, a + 2)              # meso base (194-213)
    mb_i = jnp.where(mb_i + 2 > R, 1, mb_i)
    rnd_i = jnp.stack([tab[ibase], tab[ibase + 1], tab[b + 2],
                       tab[mb_i], tab[mb_i + 1], tab[mb_i + 2]], 0)

    # ----- advance.f90 -----
    na = leg.nrand
    na1 = jnp.where(na + 1 > R, 1, na)           # horizontal (line 369)
    rnd_h = jnp.stack([tab[na1], tab[na1 + 1]], 0)
    b2 = na1 + 2
    b2 = jnp.where(b2 + cfg.ifine > R, 1, b2)    # vertical (line 395)
    rnd_w = jnp.stack([tab[b2 + 1 + i] for i in range(cfg.ifine)], 0)
    pbl_meso = b2 + cfg.ifine + 1                # nrand=nrand+i, i=ifine+1

    t_b = jnp.where(na + 1 > R, 1, na)           # troposphere (650)
    tr_b = jnp.where(na + 2 > R, 1, na)          # transition (657)
    s_b = jnp.where(na > R, 1, na)               # stratosphere (666)
    rnd_ft = jnp.stack([
        jnp.where(in_trans, tab[tr_b], tab[t_b]),
        jnp.where(in_trans, tab[tr_b + 1], tab[t_b + 1]),
        jnp.where(in_trans, tab[tr_b + 2], tab[s_b]),
    ], 0)
    ft_meso = jnp.where(in_trop, t_b + 2,
                        jnp.where(in_trans, tr_b + 3, s_b + 1))
    mb = jnp.where(pbl, pbl_meso, ft_meso)       # mesoscale (727)
    mb = jnp.where(mb + 2 > R, 1, mb)
    rnd_m = jnp.stack([tab[mb], tab[mb + 1], tab[mb + 2]], 0)
    # bases for the CBL matched mode: b2 seeds the in-loop per-particle
    # nrand chase of _pbl_vertical; ft_meso stays valid for non-PBL
    # particles whose consumption the CBL branch never touches
    return rnd_i, rnd_h, rnd_w, rnd_ft, rnd_m, (b2, ft_meso)


class StepDiag(NamedTuple):
    """Per-step diagnostics (analog of nstop bookkeeping + the CBL
    nan_count of timemanager.f90:714-727)."""
    n_active: jnp.ndarray
    n_exited: jnp.ndarray
    nan_count: jnp.ndarray
    #: adaptive mode only: per-particle seconds spent below 2*href this
    #: interval, accumulated per pass (advance.f90:582-599) — the
    #: deposition-probability window apply_decay_drydep consumes
    t_below: jnp.ndarray | None = None


def _viscosity(t):
    """Sutherland's law (dynamic_viscosity.f90)."""
    return 1.827e-5 * (291.15 + 120.0) / (t + 120.0) * (t / 291.15) ** 1.5


def _settling_velocity(dquer_um, density, cunningham, vsetaver, temp, rhoa):
    """Iterative Reynolds/Cd settling velocity (get_settling.f90:100-127).
    All species parameters are per-particle (pre-gathered) arrays.
    Returns negative (downward) velocity [m/s]."""
    vis_kin = _viscosity(temp) / rhoa
    d_m = dquer_um / 1.0e6

    def cd_of(re):
        re = jnp.maximum(re, 1e-12)
        return jnp.where(re < 1.917, 24.0 / re,
                         jnp.where(re < 500.0, 18.5 / re ** 0.6, 0.44))

    settl = jnp.broadcast_to(vsetaver, temp.shape)
    reynolds = d_m * jnp.abs(settl) / vis_kin
    dens_pos = jnp.maximum(density, 0.0)      # gases: density<0 -> 0 m/s
    for _ in range(5):
        c_d = cd_of(reynolds)
        settl = -jnp.sqrt(4.0 * GA * d_m * dens_pos * cunningham
                          / (3.0 * c_d * rhoa))
        reynolds = d_m * jnp.abs(settl) / vis_kin
    return jnp.where(density > 0.0, settl, 0.0)


def _particle_settling(prm: StepParams, p: Particles, temp, rhoa):
    """Per-particle settling with the parameters of the first species
    the particle carries release mass of (advance.f90:518-531: settling
    is only active when each release point emits a single species, so
    that species is the particle's species)."""
    nsp = jnp.argmax(p.mass0 > 1e-30, axis=1)      # eps3 = tiny(1.0)
    return _settling_velocity(
        prm.sp_dquer[nsp], prm.sp_density[nsp],
        prm.sp_cunningham[nsp], prm.sp_vsetaver[nsp], temp, rhoa)


def _ou_update(vel, rnd, sig, dt_over_tl):
    """Exact/linearized Ornstein-Uhlenbeck velocity update with the
    reference's 0.5 threshold switch (advance.f90:371-384)."""
    lin = (1.0 - dt_over_tl) * vel + rnd * sig * jnp.sqrt(2.0 * dt_over_tl)
    r = jnp.exp(-dt_over_tl)
    exact = r * vel + rnd * sig * jnp.sqrt(jnp.maximum(1.0 - r * r, 0.0))
    return jnp.where(dt_over_tl < 0.5, lin, exact)


def _reflect_pbl(z, delz, h):
    """Ground/hmix reflection, forbidden-state flag (advance.f90:476-491)."""
    delz = jnp.where(jnp.abs(delz) > h, jnp.fmod(delz, h), delz)
    below = delz < -z
    above = delz > (h - z)
    znew = jnp.where(below, -z - delz,
                     jnp.where(above, -z - delz + 2.0 * h, z + delz))
    icbt = jnp.where(below | above, -1, 1).astype(jnp.int8)
    return znew, icbt


def _pbl_vertical(cfg: StepConfig, prm: StepParams, z, wp, icbt, h, ust, wst,
                  ol, rho, drhodz, rnd_w, dt, key=None, legacy_cbl=None):
    """The ifine vertical Langevin substeps (advance.f90:396-498).
    Returns (z, wp, icbt, turb-at-final-z, nan_mask, nrand).  With
    cfg.cblflag, wp is the RAW vertical velocity and the skewed
    bi-Gaussian drift applies in strongly convective columns
    (-h/L > 5, advance.f90:405-442).

    legacy_cbl: optional (table, nrand) for matched-RNG CBL mode — the
    CBL branch consumes rannumb entries per particle with the
    reference's in-loop `nrand=nrand+1` chase (including the
    re_initialize retry loop and the weak-zone NaN redraw), and the
    final per-particle nrand is returned so the caller can base the
    mesoscale draws on it (advance.f90:499 skips the static
    `nrand=nrand+i` advance when cblflag=1).

    `dtftlw` (and everything derived from it: the decay factor rw, the
    random-increment scale, and the linearized-vs-exact branch choice)
    is computed ONCE from the turbulence at the interval-start position
    and kept across all ifine substeps — the reference sets it before
    the substep loop (advance.f90:391) and hanna_short refreshes only
    sigw/dsigwdz/tlw, so the fresh tlw enters the drift term but not
    the decay.  Besides matching the reference bit-for-bit, this hoists
    the exp/sqrt out of the substep loop."""
    rhoaux = drhodz / rho
    dtf = dt * prm.fine
    n = z.shape[0]
    turb = hanna(z, h, ust, wst, ol) if (cfg.turbswitch or cfg.cblflag) \
        else hanna1(z, h, ust, wst, ol)
    dtftlw = dtf / turb.tlw                      # stale by design
    nan_mask = jnp.zeros_like(z, bool)
    rw = jnp.exp(-dtftlw)
    rnd_exact = jnp.sqrt(jnp.maximum(1.0 - rw * rw, 0.0))
    rnd_lin = jnp.sqrt(2.0 * dtftlw)
    use_lin = dtftlw < 0.5
    if legacy_cbl is not None:
        tab, nrand = legacy_cbl
        Rtab = tab.shape[0] - 1
    else:
        tab = nrand = None
    for i in range(cfg.ifine):
        if cfg.cblflag:
            icbtf = icbt.astype(jnp.float32)
            cbl_zone = (-h / ol) > 5.0
            if tab is not None:
                # advance.f90:411/426: nrand=nrand+1 then read, in both
                # the skewed and the weak-Gaussian branch — but only on
                # the dtftlw<0.5 path; the dtftlw>=0.5 quirk branch
                # below reads statically at nrand+i without advancing
                nrand = jnp.where(use_lin, nrand + 1, nrand)
                dmain = tab[jnp.clip(nrand, 1, Rtab)]
            else:
                dmain = rnd_w[i]
            ath_c, bth_c, rein = cbl_terms(
                wp, z, wst, h, rho, drhodz, turb.sigw, turb.dsigwdz,
                turb.tlw, ol, cfg.ldirect)
            wp_c = (wp + ath_c * dtf
                    + bth_c * dmain * jnp.sqrt(dtf)) * icbtf
            if tab is not None:
                wp_re, idx_re = legacy_reinit_wp(
                    tab, nrand, wp, z, wst, h, turb.sigw, turb.dsigwdz,
                    ol, cfg.ldirect)
                nrand = jnp.where(use_lin & cbl_zone & rein, idx_re,
                                  nrand)
            else:
                rr = rng.normals(key, (2, n), tag=40 + i)
                wp_re = reinit_wp(rr[0], rr[1], wp, z, wst, h, turb.sigw,
                                  turb.dsigwdz, ol, cfg.ldirect)
            wp_c = jnp.where(rein, wp_re, wp_c)
            # weakly convective: Gaussian drift on the raw velocity
            # (advance.f90:425-442)
            sig = jnp.maximum(turb.sigw, 1e-6)
            ath_g = (-wp / turb.tlw + sig * turb.dsigwdz
                     + wp * wp / sig * turb.dsigwdz
                     + sig * sig / rho * drhodz)
            wp_g = (wp + ath_g * dtf
                    + sig * dmain * rnd_lin) * icbtf
            wp_new = jnp.where(cbl_zone, wp_c, wp_g)
            # NaN safety net (advance.f90:435-441 nan_count2 redraw)
            nonfin = ~jnp.isfinite(wp_new)
            nan_mask = nan_mask | (nonfin & use_lin)
            if tab is not None:
                # the reference redraw exists only in the weak branch
                # and consumes one entry (advance.f90:436-441); mirror
                # its consumption exactly
                redraw = nonfin & ~cbl_zone & use_lin
                nrand = jnp.where(redraw, nrand + 1, nrand)
                dnan = tab[jnp.clip(nrand, 1, Rtab)]
                wp_new = jnp.where(redraw, sig * dnan, wp_new)
            else:
                wp_new = jnp.where(nonfin, sig * dmain, wp_new)
            delz = wp_new * dtf
            # dtftlw >= 0.5 falls through to the exact-OU NORMALIZED
            # update even when cblflag=1, with wp still raw m/s — a
            # reference units quirk (advance.f90:403,446-455 nest the
            # CBL option inside `dtftlw<0.5` only) that real CBL runs
            # hit wherever tlw is small near the ground; bug-compatible
            # by design so matched validation covers real configs.
            # Draws come from the static rnd_w stack (rannumb(nrand+i),
            # chase untouched).
            wp_q = (rw * wp + rnd_w[i] * rnd_exact
                    + turb.tlw * (1.0 - rw)
                    * (turb.dsigwdz + rhoaux * turb.sigw)) * icbtf
            wp_new = jnp.where(use_lin, wp_new, wp_q)
            delz = jnp.where(use_lin, delz, wp_q * turb.sigw * dtf)
        elif cfg.turbswitch:
            # Gaussian branch (advance.f90:446-455); wp normalized by sigw
            lin = ((1.0 - dtftlw) * wp + rnd_w[i] * rnd_lin
                   + dtf * (turb.dsigwdz + rhoaux * turb.sigw))
            exact = (rw * wp + rnd_w[i] * rnd_exact
                     + turb.tlw * (1.0 - rw) * (turb.dsigwdz + rhoaux * turb.sigw))
            wp_new = jnp.where(use_lin, lin, exact) * icbt.astype(jnp.float32)
            delz = wp_new * turb.sigw * dtf
        else:
            wp_new = (rw * wp
                      + rnd_w[i] * rnd_exact * turb.sigw
                      + turb.tlw * (1.0 - rw)
                      * (turb.dsigw2dz + rhoaux * turb.sigw ** 2)) \
                * icbt.astype(jnp.float32)
            delz = wp_new * dtf
        if cfg.turboff:
            wp_new = jnp.zeros_like(wp_new)
            delz = jnp.zeros_like(delz)
        z, icbt = _reflect_pbl(z, delz, h)
        wp = wp_new
        if i != cfg.ifine - 1:
            # hanna_short refresh at the new z (advance.f90:493-496)
            turb = hanna(z, h, ust, wst, ol) if (cfg.turbswitch
                                                 or cfg.cblflag) \
                else hanna1(z, h, ust, wst, ol)
    return z, wp, icbt, turb, nan_mask, nrand


def _ldt_formula(cfg: StepConfig, prm: StepParams, turb, wp, h):
    """ldt = int(min(...)*ctl), clamped to mintime
    (advance.f90:504-510)."""
    if cfg.turbswitch:
        lim = jnp.minimum(
            jnp.minimum(turb.tlw,
                        h / jnp.maximum(2.0 * jnp.abs(wp * turb.sigw),
                                        1e-5)),
            0.5 / jnp.maximum(jnp.abs(turb.dsigwdz), 1e-10))
    else:
        lim = jnp.minimum(turb.tlw,
                          h / jnp.maximum(2.0 * jnp.abs(wp), 1e-5))
    ldt = jnp.trunc(lim * prm.ctl)
    return jnp.maximum(ldt, jnp.float32(cfg.mintime))


def _adaptive_interval(cfg: StepConfig, prm: StepParams, key,
                       leg: "LegacyRnd | None", z0: ZFields, z1: ZFields,
                       tw0, tw1, tables, hw: HorizWeights, height,
                       h, tropop, ust, wst, ol, z, up, vp, wp, icbt,
                       idt_in, pbl0, settle_fn=None):
    """Reference-faithful adaptive interval (method=1;
    advance.f90:276-720): a masked `lax.while_loop` over PBL passes —
    each pass re-interpolates u,v,w,rho,drhodz VERTICALLY at the
    particle's current z (horizontal stencil frozen at interval start,
    exactly like interpol_all + interpol_misslev), recomputes the Hanna
    turbulence, advances the horizontal OU velocities and the ifine
    vertical Langevin substeps, then picks the next per-particle ldt.
    A particle whose z rises above h mid-interval leaves the loop and
    completes the REST of the interval with the single free-troposphere
    step (`goto 700`, advance.f90:556-560,648); particles starting
    above the PBL take the FT step with the full interval.  The
    entry ldt is the particle's stored idt (timemanager passes idt(j)
    inout); the exit ldt is returned to store back.

    In legacy mode every draw comes from the rannumb table through a
    PER-PARTICLE nrand cursor mirroring the reference's serial index
    arithmetic (wrap checks included); production mode uses counter
    RNG keyed by the pass index.

    Returns dict with z, up, vp, wp, icbt, idt, dxs, dys, daw, dcw,
    u/v/w last-interpolated (for windalign + Petterssen), end-of-
    interval mesoscale sigmas, mesoscale draws, t_below (PBL seconds
    spent under 2*href for the deposition probability), nan count."""
    n = z.shape[0]
    legacy = leg is not None
    legacy_interp = legacy and not cfg.legacy_quad
    if legacy:
        tab = leg.table
        R = tab.shape[0] - 1

    def vert_wind(zc):
        """u,v,w,rho,drhodz at (frozen hw, current z)."""
        indz, dz1 = vert_weights(zc, height)
        if legacy_interp:
            c0 = gather_corners_3d(z0.f3d, (0, 1, 2, 3, 4), hw, indz)
            c1 = gather_corners_3d(z1.f3d, (0, 1, 2, 3, 4), hw, indz)
            # f32 HIGHEST: a default-precision dot may run in TF32 on
            # Hopper
            hi = jax.lax.Precision.HIGHEST
            lev = (jnp.einsum("flnc,nc->fln", c0, hw.p4, precision=hi)
                   * tw0
                   + jnp.einsum("flnc,nc->fln", c1, hw.p4, precision=hi)
                   * tw1)
            val = lev[:, 0] * (1.0 - dz1) + lev[:, 1] * dz1
            return val[0], val[1], val[2], val[3], val[4]
        return wind10_quad(tables.rows, hw, indz, dz1, cfg.nx, cfg.ny)

    def wrap1(nr, need):
        return jnp.where(nr + need > R, 1, nr)

    zero = jnp.zeros(n, jnp.float32)

    def body(carry):
        (k, remaining, ldt, zc, upc, vpc, wpc, icbtc, u_l, v_l, w_l,
         daw, dcw, dxs, dys, t_below, nrand, nan_acc) = carry
        # a particle that rose above h has LEFT the loop (its remaining
        # time is finished by the FT step below), advance.f90:556-560
        act = pbl0 & (remaining > 0.0) & (zc <= h)
        dt_i = jnp.minimum(ldt, remaining)
        dt_i = jnp.where(act, dt_i, 0.0)
        kk = jax.random.fold_in(key, 9000 + k)

        u, v, w, rhoa, drho = vert_wind(zc)
        turb = hanna(zc, h, ust, wst, ol) if (cfg.turbswitch
                                              or cfg.cblflag) \
            else hanna1(zc, h, ust, wst, ol)

        # horizontal OU (advance.f90:369-384): 2 draws
        if legacy:
            nr = wrap1(nrand, 1)
            r_up = tab[nr]
            r_vp = tab[nr + 1]
            nrand2 = nr + 2
        else:
            rh = rng.normals(kk, (2, n), tag=1)
            r_up, r_vp = rh[0], rh[1]
            nrand2 = nrand
        up2 = _ou_update(upc, r_up, turb.sigu, dt_i / turb.tlu)
        vp2 = _ou_update(vpc, r_vp, turb.sigv, dt_i / turb.tlv)

        # vertical ifine substeps (advance.f90:391-498)
        if legacy:
            nr = wrap1(nrand2, cfg.ifine)
            rnd_w = jnp.stack([tab[nr + 1 + i] for i in range(cfg.ifine)],
                              0)
            nrand3 = nr + cfg.ifine + 1
        else:
            rnd_w = rng.normals(kk, (cfg.ifine, n), tag=2)
            nrand3 = nrand2
        z2, wp2, icbt2, turb_f, nm, _ = _pbl_vertical(
            cfg, prm, zc, wpc, icbtc, h, ust, wst, ol, rhoa, drho,
            rnd_w, dt_i, key=kk)
        nan_acc = nan_acc + jnp.sum((nm & act).astype(jnp.int32))

        # next adaptive step from the POST-substep turbulence/velocity
        ldt2 = _ldt_formula(cfg, prm, turb_f, wp2, h)

        # optional settling at the current position (advance.f90:518-531)
        w_eff = w if settle_fn is None else w + settle_fn(zc)

        daw2 = daw + up2 * dt_i
        dcw2 = dcw + vp2 * dt_i
        dxs2 = dxs + u * dt_i
        dys2 = dys + v * dt_i
        z3 = z2 + w_eff * dt_i * jnp.float32(cfg.ldirect)
        htop = height[-1] - jnp.float32(100.0 * cfg.nx / 3.0e5)
        z3 = jnp.minimum(z3, htop)
        # deposition probability window (advance.f90:582-599): time
        # spent below 2*href, AFTER the vertical update, BEFORE the
        # below-ground reflection
        t_below2 = t_below + jnp.where(z3 < 2.0 * 15.0, dt_i, 0.0)
        z3 = jnp.where(z3 < 0.0, jnp.minimum(h - 1e-9, -z3), z3)

        remaining2 = jnp.maximum(remaining - dt_i, 0.0)

        def sel(a, b):
            return jnp.where(act, a, b)

        return (k + 1, sel(remaining2, remaining), sel(ldt2, ldt),
                sel(z3, zc), sel(up2, upc), sel(vp2, vpc),
                sel(wp2, wpc),
                jnp.where(act, icbt2, icbtc).astype(jnp.int8),
                sel(u, u_l), sel(v, v_l), sel(w_eff, w_l),
                sel(daw2, daw), sel(dcw2, dcw), sel(dxs2, dxs),
                sel(dys2, dys), sel(t_below2, t_below),
                jnp.where(act, nrand3, nrand), nan_acc)

    def cond(carry):
        (_, remaining, _, zc, *_rest) = carry
        # stay in the loop while any PBL particle has time left AND is
        # still inside the PBL (advance.f90:556-560: a particle that
        # rose above h leaves the loop with its remaining time)
        act = pbl0 & (remaining > 0.0) & (zc <= h)
        return jnp.any(act)

    remaining0 = jnp.where(pbl0, prm.lsynctime, 0.0) + zero
    ldt0 = jnp.maximum(jnp.asarray(idt_in, jnp.float32),
                       jnp.float32(cfg.mintime))
    nrand0 = (leg.nrand.astype(jnp.int32) if legacy
              else jnp.zeros(n, jnp.int32))
    carry = (jnp.int32(0), remaining0, ldt0, z, jnp.asarray(up),
             jnp.asarray(vp), jnp.asarray(wp), icbt,
             zero, zero, zero, zero, zero, zero, zero, zero,
             nrand0, jnp.int32(0))
    carry = jax.lax.while_loop(cond, body, carry)
    (_, remaining, ldt, zc, upc, vpc, wpc, icbtc, u_l, v_l, w_l,
     daw, dcw, dxs, dys, t_below, nrand, nan_acc) = carry

    # ---- free-troposphere completion (advance.f90:629-708, goto 700):
    # particles that started above the PBL (full interval) or left it
    # mid-interval (remaining time)
    dt_ft = jnp.where(pbl0, remaining, prm.lsynctime)
    ft = dt_ft > 0.0
    u_f, v_f, w_f, _, _ = vert_wind(zc)
    in_trop = zc < tropop
    in_trans = (~in_trop) & (zc < tropop + 1000.0)
    dt_s = jnp.maximum(dt_ft, 1e-6)
    uxscale_t = jnp.sqrt(2.0 * D_TROP / dt_s)
    uxscale_tr = jnp.sqrt(2.0 * D_TROP / dt_s
                          * (1.0 - jnp.clip((zc - tropop) / 1000.0,
                                            0.0, 1.0)))
    wpscale_tr = jnp.sqrt(2.0 * D_STRAT / dt_s
                          * jnp.clip((zc - tropop) / 1000.0, 0.0, 1.0))
    wpscale_s = jnp.sqrt(2.0 * D_STRAT / dt_s)
    if legacy:
        t_b = wrap1(nrand, 1)
        tr_b = wrap1(nrand, 2)
        s_b = wrap1(nrand, 0)
        rf0 = jnp.where(in_trans, tab[tr_b], tab[t_b])
        rf1 = jnp.where(in_trans, tab[tr_b + 1], tab[t_b + 1])
        rf2 = jnp.where(in_trans, tab[tr_b + 2], tab[s_b])
        nrand_ft = jnp.where(in_trop, t_b + 2,
                             jnp.where(in_trans, tr_b + 3, s_b + 1))
        nrand = jnp.where(ft, nrand_ft, nrand)
    else:
        rft = rng.normals(key, (3, n), tag=3)
        rf0, rf1, rf2 = rft[0], rft[1], rft[2]
    ux = jnp.where(in_trop, rf0 * uxscale_t,
                   jnp.where(in_trans, rf0 * uxscale_tr, 0.0))
    vy = jnp.where(in_trop, rf1 * uxscale_t,
                   jnp.where(in_trans, rf1 * uxscale_tr, 0.0))
    wp_ft = jnp.where(in_trop, 0.0,
                      jnp.where(in_trans,
                                rf2 * wpscale_tr + D_STRAT / 1000.0,
                                rf2 * wpscale_s))
    if cfg.turboff:
        ux = jnp.zeros_like(ux)
        vy = jnp.zeros_like(vy)
        wp_ft = jnp.zeros_like(wp_ft)
    w_eff_f = w_f if settle_fn is None else w_f + settle_fn(zc)
    dxs = jnp.where(ft, dxs + (u_f + ux) * dt_ft, dxs)
    dys = jnp.where(ft, dys + (v_f + vy) * dt_ft, dys)
    z_ft = zc + (w_eff_f + wp_ft) * dt_ft * jnp.float32(cfg.ldirect)
    z_ft = jnp.where(z_ft < 0.0, jnp.minimum(h - 1e-9, -z_ft), z_ft)
    zc = jnp.where(ft, z_ft, zc)
    wpc = jnp.where(ft, wp_ft, wpc)
    u_l = jnp.where(ft, u_f, u_l)
    v_l = jnp.where(ft, v_f, v_l)
    w_l = jnp.where(ft, w_eff_f, w_l)
    # ldt bookkeeping: FT sets ldt to the step it took
    # (advance.f90:648); store back for the next interval
    ldt = jnp.where(ft, jnp.maximum(dt_ft, jnp.float32(cfg.mintime)),
                    ldt)

    # ---- end-of-interval mesoscale sigmas at the FINAL z
    # (advance.f90:601-605 profile average; FT via interpol_wind's
    # 16-sample form in legacy mode)
    hw_f = hw
    indz_f, dz1_f = vert_weights(zc, height)
    if legacy_interp:
        wind_e, sig16 = interp_wind_legacy(z0, z1, hw_f, indz_f, dz1_f,
                                           tw0, tw1)
        usig_e = jnp.where(ft, sig16[0], wind_e.usig)
        vsig_e = jnp.where(ft, sig16[1], wind_e.vsig)
        wsig_e = jnp.where(ft, sig16[2], wind_e.wsig)
    else:
        _, _, _, _, _, wind_e = sample_all_quad(tables, hw_f, indz_f,
                                                dz1_f, zc * 0.0,
                                                zc * 0.0, cfg.nx, cfg.ny)
        usig_e, vsig_e, wsig_e = wind_e.usig, wind_e.vsig, wind_e.wsig
    if legacy:
        mb = wrap1(nrand, 2)
        rnd_m = jnp.stack([tab[mb], tab[mb + 1], tab[mb + 2]], 0)
    else:
        rnd_m = rng.normals(key, (3, n), tag=4)

    return dict(z=zc, up=upc, vp=vpc, wp=wpc, icbt=icbtc,
                idt=ldt.astype(jnp.int32), dxs=dxs, dys=dys, daw=daw,
                dcw=dcw, u=u_l, v=v_l, w=w_l, usig=usig_e, vsig=vsig_e,
                wsig=wsig_e, rnd_m=rnd_m, t_below=t_below,
                nan_count=nan_acc)


SWITCHNORTH = 75.0       # polar-cap latitude thresholds (par_mod.f90:123)
SWITCHSOUTH = -75.0


def _polar_update(prm: StepParams, x, y, dxsave, dysave, ldirf, nxm):
    """Polar-stereographic position update for particles poleward of
    +-75 deg (advance.f90:754-778).  The reference precomputes rotated
    uupol/vvpol grids and goes through the cmapf_mod projection package
    (cll2xy/cgszll/cxy2ll); here the tangent polar stereographic map is
    closed-form: the accumulated geographic (east, north) displacement is
    rotated into the plane basis at the particle's longitude, scaled by
    the map factor m = sec^2((90-|lat|)/2), applied in plane coordinates
    rho = 2R tan((90-|lat|)/2), and inverted — branch-free and with no
    extra wind fields in HBM.  Returns (x_new, y_new, north_mask,
    south_mask) in grid units.

    In tile mode, prm.tile_x0 shifts tile-local x into global grid units
    (longitudes and the cyclic wrap must be global) and the result is
    shifted back, so the update is identical to the single-device one."""
    lon = (prm.xlon0_pol + (x + prm.tile_x0) * prm.dx) * PI180
    lat = (prm.ylat0 + y * prm.dy) * PI180
    north = lat > SWITCHNORTH * PI180
    south = lat < SWITCHSOUTH * PI180

    sinl, cosl = jnp.sin(lon), jnp.cos(lon)

    # ---- north pole plane: X = rho sin(lon), Y = -rho cos(lon) ----
    half_n = (jnp.pi / 4.0) - lat / 2.0          # (90 - lat)/2
    rho_n = 2.0 * R_EARTH * jnp.tan(half_n)
    m_n = 1.0 / jnp.cos(half_n) ** 2             # map factor
    dxp = (dxsave * cosl - dysave * sinl) * m_n * ldirf
    dyp = (dxsave * sinl + dysave * cosl) * m_n * ldirf
    xpl = rho_n * sinl + dxp
    ypl = -rho_n * cosl + dyp
    rho2 = jnp.hypot(xpl, ypl)
    lat_n = jnp.pi / 2.0 - 2.0 * jnp.arctan(rho2 / (2.0 * R_EARTH))
    lon_n = jnp.arctan2(xpl, -ypl)

    # ---- south pole plane: X = rho sin(lon), Y = +rho cos(lon) ----
    half_s = (jnp.pi / 4.0) + lat / 2.0          # (90 + lat)/2
    rho_s = 2.0 * R_EARTH * jnp.tan(half_s)
    m_s = 1.0 / jnp.cos(half_s) ** 2
    dxs = (dxsave * cosl + dysave * sinl) * m_s * ldirf
    dys = (-dxsave * sinl + dysave * cosl) * m_s * ldirf
    xps = rho_s * sinl + dxs
    yps = rho_s * cosl + dys
    rho2s = jnp.hypot(xps, yps)
    lat_s = -(jnp.pi / 2.0) + 2.0 * jnp.arctan(rho2s / (2.0 * R_EARTH))
    lon_s = jnp.arctan2(xps, yps)

    lat_new = jnp.where(north, lat_n, lat_s) / PI180
    lon_new = jnp.where(north, lon_n, lon_s) / PI180
    # back to mother-grid units; wrap into the grid's lon window
    xg = (lon_new - prm.xlon0_pol) / prm.dx
    # wrap with the grid's actual cyclic width (cfg.nx-1), matching
    # _apply_bcs — recomputing 360/dx in f32 can drift off nx-1 for
    # resolutions that don't divide 360 exactly (e.g. 0.7 deg)
    xg = jnp.where(xg < 0.0, xg + nxm, xg)
    xg = jnp.where(xg >= nxm, xg - nxm, xg)
    xg = xg - prm.tile_x0                 # back to tile-local units
    yg = (lat_new - prm.ylat0) / prm.dy
    return xg, yg, north, south


def _sample_met(zA: ZFields, zB: ZFields, tw0, tw1, x, y, z, height,
                nx: int, ny: int, xglobal: bool, legacy: bool = False,
                tables: StepTablesQuad | None = None):
    """All met quantities the integrator needs at the particle, from one
    grid (mother or nest): the interpol_all/interpol_wind family.

    Production path: EVERYTHING comes from ONE single-index row gather
    of the per-step quad-corner table (StepTablesQuad) — each particle
    fetches one contiguous 256-byte row holding its complete stencil
    (see the measurement note on StepTablesQuad).

    With legacy=True the winds/sigmas use the reference-exact
    per-time-level interpolation and both sigma conventions (matched-RNG
    validation); the last return slot then carries the 16-sample sigma
    triple (None otherwise)."""
    hw = horiz_weights(x, y, nx, ny, xglobal)
    indz, dz1 = vert_weights(z, height)
    if not legacy:
        if tables is None:
            # endtime weights unused here; caller-facing fallback
            tables = build_step_tables_quad(zA, zB, tw0, tw1, tw0, tw1)
        h, tropop, ust, wst, ol, wind = sample_all_quad(
            tables, hw, indz, dz1, x, y, nx, ny)
        return hw, indz, dz1, h, tropop, ust, wst, ol, wind, None
    h = jnp.maximum(hmix_max(zA, zB, hw, F2_HMIX), 1.0)
    # tropopause: nearest grid point of the FIRST time level
    # (advance.f90:252 `tropopause(nix,njy,1,1)`); nint picks one of the
    # 4 bilinear corners
    trop_c = gather_corners_2d_ln(zA.f2d, (F2_TROPO,), hw)[0]    # (4,N)
    ix_n = (x - hw.ix) >= 0.5
    iy_n = (y - hw.jy) >= 0.5
    tropop = jnp.where(iy_n, jnp.where(ix_n, trop_c[3], trop_c[2]),
                       jnp.where(ix_n, trop_c[1], trop_c[0]))
    sidx = jnp.asarray((F2_USTAR, F2_WSTAR, F2_OLI))
    f2dt = zA.f2d[sidx] * tw0 + zB.f2d[sidx] * tw1
    ust, wst, oliaux = interp_2d(f2dt, (0, 1, 2), hw)
    ol = jnp.where(oliaux != 0.0, 1.0 / oliaux, 99999.0)
    wind, sig16 = interp_wind_legacy(zA, zB, hw, indz, dz1, tw0, tw1)
    return hw, indz, dz1, h, tropop, ust, wst, ol, wind, sig16


@functools.partial(jax.jit, static_argnames=("cfg",))
def advance_all(p: Particles, z0: ZFields, z1: ZFields,
                itime, memtime0, memtime1, key,
                cfg: StepConfig, prm: StepParams,
                z0n: ZFields | None = None, z1n: ZFields | None = None,
                leg: LegacyRnd | None = None,
                tables: StepTablesQuad | None = None,
                tables_n: StepTablesQuad | None = None):
    """Advance every scheduled particle by one lsynctime interval.

    Returns (particles, diag).  Terminated-by-domain-exit particles get
    active=False (reference nstop=3, advance.f90:804-808).  With `leg`,
    every random draw comes from the reference's rannumb table in exact
    consumption order (matched-RNG validation; no nests/CBL).  `tables`
    (per-step blended grid tables) can be precomputed once per sync
    interval and shared across particle chunks (advance_chunked does);
    if absent they are built here."""
    n = p.capacity
    scheduled = p.active
    legacy = leg is not None
    if legacy and cfg.cblflag and cfg.method == 1:
        raise NotImplementedError(
            "matched-RNG CBL validation is fixed-step only (the "
            "adaptive legacy chase assumes static in-loop consumption)")
    # nested met grids, outermost -> innermost (advance.f90:161-175)
    nshapes = (cfg.nests if cfg.nests
               else ((cfg.nest_nx, cfg.nest_ny),) if cfg.nest_nx else ())
    zn0_t = (tuple(z0n) if isinstance(z0n, (tuple, list))
             else ((z0n,) if z0n is not None else ()))
    zn1_t = (tuple(z1n) if isinstance(z1n, (tuple, list))
             else ((z1n,) if z1n is not None else ()))
    if legacy and nshapes:
        raise ValueError("legacy RNG mode does not support nests")
    if cfg.method == 1 and nshapes:
        raise ValueError("adaptive stepping (method=1) with nested met "
                         "grids is not supported yet; use CTL<0 or the "
                         "mother grid only")

    dt1 = (itime - memtime0).astype(jnp.float32)
    dt2 = (memtime1 - itime).astype(jnp.float32)
    dtt = 1.0 / (dt1 + dt2)
    tw0, tw1 = dt2 * dtt, dt1 * dtt
    # Petterssen endpoint time weights (constant per step)
    endtime = itime + prm.lsynctime.astype(jnp.int32) * cfg.ldirect
    edt1 = (endtime - memtime0).astype(jnp.float32)
    edt2 = (memtime1 - endtime).astype(jnp.float32)
    edtt = 1.0 / jnp.maximum(edt1 + edt2, 1e-6)
    ew0, ew1 = edt2 * edtt, edt1 * edtt
    # legacy_quad: legacy draws + PRODUCTION quad-table interpolation
    legacy_interp = legacy and not cfg.legacy_quad
    if not legacy_interp:
        mdt = jnp.bfloat16 if cfg.met_bf16 else jnp.float32
        if tables is None:
            tables = build_step_tables_quad(z0, z1, tw0, tw1, ew0, ew1,
                                            dtype=mdt)
        if nshapes and tables_n is None:
            tables_n = tuple(
                build_step_tables_quad(zn0_t[k], zn1_t[k], tw0, tw1,
                                       ew0, ew1, dtype=mdt)
                for k in range(len(nshapes)))
        elif tables_n is not None and not isinstance(tables_n,
                                                     (tuple, list)):
            tables_n = (tables_n,)

    x = p.x
    y = p.y
    z = p.z
    height = z0.height
    (hw, indz, dz1, h, tropop, ust, wst, ol,
     wind, sig16) = _sample_met(z0, z1, tw0, tw1, x, y, z, height,
                                cfg.nx, cfg.ny, cfg.xglobal,
                                legacy=legacy_interp, tables=tables)

    # nested met fields: recompute for particles inside each nest window
    # and select, outermost first so the INNERMOST containing nest wins
    # (advance.f90:161-175 scans j=numbnests,1,-1)
    if nshapes:
        eps_n = jnp.float32(cfg.nx / 3.0e5)
        for k, (nnx, nny) in enumerate(nshapes):
            in_nest = ((x > prm.xln[k] + eps_n) & (x < prm.xrn[k] - eps_n)
                       & (y > prm.yln[k] + eps_n)
                       & (y < prm.yrn[k] - eps_n))
            xtn = (x - prm.xln[k]) * prm.xresoln[k]
            ytn = (y - prm.yln[k]) * prm.yresoln[k]
            xtn = jnp.clip(xtn, 0.0, nnx - 1.001)
            ytn = jnp.clip(ytn, 0.0, nny - 1.001)
            (_, indz_n, dz1_n, h_n, trop_n, ust_n, wst_n, ol_n,
             wind_n, _) = _sample_met(zn0_t[k], zn1_t[k], tw0, tw1,
                                      xtn, ytn, z, height,
                                      nnx, nny, False,
                                      tables=tables_n[k])
            sel_n = lambda a, b: jnp.where(in_nest, a, b)
            h = sel_n(h_n, h)
            tropop = sel_n(trop_n, tropop)
            ust = sel_n(ust_n, ust)
            wst = sel_n(wst_n, wst)
            ol = sel_n(ol_n, ol)
            wind = type(wind)(*[sel_n(a, b)
                                for a, b in zip(wind_n, wind)])
    u, v, w = wind.u, wind.v, wind.w

    dt = prm.lsynctime
    pbl = (z / h) <= 1.0
    # top-of-domain clamp: height(nz)-100*eps, eps=nxmax/3e5
    # (advance.f90:107,560)
    htop = height[-1] - jnp.float32(100.0 * cfg.nx / 3.0e5)
    in_trop = z < tropop
    in_trans = (~in_trop) & (z < tropop + 1000.0)

    if legacy:
        (l_rnd_i, l_rnd_h, l_rnd_w, l_rnd_ft, l_rnd_m,
         (l_b2, l_ft_meso)) = _legacy_draws(leg, cfg, pbl, in_trop,
                                            in_trans)
    if legacy_interp:
        # above-PBL/PBL sigma conventions (interpol_wind.f90 16-sample
        # vs interpol_all.f90 per-level 8-sample)
        usig_w = jnp.where(pbl, wind.usig, sig16[0])
        vsig_w = jnp.where(pbl, wind.vsig, sig16[1])
        wsig_w = jnp.where(pbl, wind.wsig, sig16[2])
    else:
        usig_w, vsig_w, wsig_w = wind.usig, wind.vsig, wind.wsig

    # -------- newly released particles (initialize.f90:110-219) --------
    # draw the turbulent velocities from the local Hanna sigmas and the
    # mesoscale memory from the local wind stddev so near-source
    # statistics are unbiased from the first step (the reference calls
    # `initialize` right before the first `advance` of each particle,
    # timemanager.f90:553-555)
    # the reference initializes at release AND for everything live at
    # itime==0 (covers IPIN=1 warm-started particles)
    fresh = scheduled & ((p.itramem == itime) | (itime == 0))
    rnd_i = l_rnd_i if legacy else rng.normals(key, (6, n), tag=6)
    turb_i = hanna(z, h, ust, wst, ol) if cfg.turbswitch \
        else hanna1(z, h, ust, wst, ol)
    up_i = jnp.where(pbl, rnd_i[0] * turb_i.sigu, rnd_i[0] * 0.3)
    vp_i = jnp.where(pbl, rnd_i[1] * turb_i.sigv, rnd_i[1] * 0.3)
    if cfg.cblflag:
        # initialize.f90:139-150: raw wp; skewed draw in strongly
        # convective columns (initialize_cbl_vel.f90), Gaussian*sigw
        # otherwise
        if legacy and leg.cbl_dcas is not None:
            dcas, dcas1 = leg.cbl_dcas, leg.cbl_dcas1
        else:
            dcas = rng.uniforms(key, (n,), tag=7)
            dcas1 = rng.normals(key, (n,), tag=8)
        wp_cbl = init_cbl_wp(dcas, dcas1, z, wst, h, turb_i.sigw,
                             turb_i.dsigwdz, ol, cfg.ldirect)
        wp_raw = jnp.where((-h / ol) > 5.0, wp_cbl,
                           rnd_i[2] * turb_i.sigw)
    elif cfg.turbswitch:
        wp_raw = rnd_i[2]
    else:
        wp_raw = rnd_i[2] * turb_i.sigw
    wp_i = jnp.where(pbl, wp_raw, 0.0)
    if cfg.turboff:
        up_i = jnp.zeros_like(up_i)
        vp_i = jnp.zeros_like(vp_i)
        wp_i = jnp.zeros_like(wp_i)
    # stationary mesoscale OU draw (initialize.f90:211-219; scaled by
    # turbmesoscale to match the process variance in advance.f90:729-733)
    # legacy note: initialize.f90:215-217 draws the mesoscale memory from
    # the FULL wind stddev (no turbmesoscale); the production default
    # uses the OU process' stationary std (documented deviation)
    meso_f = 1.0 if legacy else TURBMESOSCALE
    usig_i = rnd_i[3] * usig_w * meso_f
    vsig_i = rnd_i[4] * vsig_w * meso_f
    wsig_i = rnd_i[5] * wsig_w * meso_f
    idt_upd = p.idt
    if cfg.method == 1:
        # initial adaptive step (initialize.f90:155-162,191):
        # turbswitch form caps by 0.5/|dsigwdz|, hanna1 form by 600 s
        if cfg.turbswitch:
            lim_i = jnp.minimum(
                jnp.minimum(turb_i.tlw,
                            h / jnp.maximum(2.0 * jnp.abs(wp_i
                                                          * turb_i.sigw),
                                            1e-5)),
                0.5 / jnp.maximum(jnp.abs(turb_i.dsigwdz), 1e-10))
        else:
            lim_i = jnp.minimum(
                jnp.minimum(turb_i.tlw,
                            h / jnp.maximum(2.0 * jnp.abs(wp_i), 1e-5)),
                600.0)
        idt_i = jnp.maximum(jnp.trunc(lim_i * prm.ctl),
                            jnp.float32(cfg.mintime))
        idt_i = jnp.where(pbl, idt_i, prm.lsynctime).astype(jnp.int32)
        idt_upd = jnp.where(fresh, idt_i, p.idt)
    p = p._replace(
        up=jnp.where(fresh, up_i, p.up),
        vp=jnp.where(fresh, vp_i, p.vp),
        wp=jnp.where(fresh, wp_i, p.wp),
        usig=jnp.where(fresh, usig_i, p.usig),
        vsig=jnp.where(fresh, vsig_i, p.vsig),
        wsig=jnp.where(fresh, wsig_i, p.wsig),
        idt=idt_upd,
        cbt=jnp.where(fresh, 1, p.cbt).astype(jnp.int8))

    ldirf = jnp.float32(cfg.ldirect)
    # settling closure at the frozen horizontal cell (advance.f90:518-531;
    # get_settling is called with the un-updated xt/yt)
    if cfg.settling:
        nix = jnp.clip(jnp.round(x).astype(jnp.int32), 0, cfg.nx - 1)
        njy = jnp.clip(jnp.round(y).astype(jnp.int32), 0, cfg.ny - 1)

        def settle_fn(zc):
            indzc, dz1c = vert_weights(zc, height)
            lin = indzc * (cfg.ny * cfg.nx) + njy * cfg.nx + nix
            tt_lo = z0.f3d[F3_TT].reshape(-1)[lin]
            tt_hi = z0.f3d[F3_TT].reshape(-1)[lin + cfg.ny * cfg.nx]
            rho_lo = z0.f3d[F3_RHO].reshape(-1)[lin]
            rho_hi = z0.f3d[F3_RHO].reshape(-1)[lin + cfg.ny * cfg.nx]
            temp = tt_lo * (1 - dz1c) + tt_hi * dz1c
            rhoa = rho_lo * (1 - dz1c) + rho_hi * dz1c
            return _particle_settling(prm, p, temp, rhoa)
    else:
        settle_fn = None

    if cfg.method == 1:
        # -------- reference-faithful adaptive interval (method=1) -----
        res = _adaptive_interval(
            cfg, prm, key, leg, z0, z1, tw0, tw1, tables, hw, height,
            h, tropop, ust, wst, ol, z, p.up, p.vp, p.wp, p.cbt,
            p.idt, pbl, settle_fn=settle_fn)
        z_new = jnp.minimum(res["z"], htop)
        up_new, vp_new, wp_new = res["up"], res["vp"], res["wp"]
        icbt = res["icbt"]
        idt_new = res["idt"]
        dxsave, dysave = res["dxs"], res["dys"]
        dawsave, dcwsave = res["daw"], res["dcw"]
        if cfg.turboff:
            up_new = jnp.zeros_like(up_new)
            vp_new = jnp.zeros_like(vp_new)
            dawsave = jnp.zeros_like(dawsave)
            dcwsave = jnp.zeros_like(dcwsave)
        # last-interpolated wind for windalign + Petterssen (already
        # settling-inclusive for w)
        u_ref, v_ref, w_ref = res["u"], res["v"], res["w"]
        usig_w, vsig_w, wsig_w = res["usig"], res["vsig"], res["wsig"]
        rnd_m = res["rnd_m"]
        nan_mask = None
        nanc_extra = res["nan_count"]
        t_below = res["t_below"]
        settling = settle_fn(z_new) if settle_fn is not None \
            else jnp.zeros_like(z)
        # corrector only for full-interval steps (advance.f90:829)
        pett_gate = (idt_new.astype(jnp.float32)
                     == prm.lsynctime)
    else:
        # ---------------- fixed-step PBL branch (advance.f90:276-615) --
        rnd_h = l_rnd_h if legacy else rng.normals(key, (2, n), tag=1)
        rnd_w = l_rnd_w if legacy else rng.normals(key, (cfg.ifine, n),
                                                   tag=2)
        turb0 = hanna(z, h, ust, wst, ol) if cfg.turbswitch \
            else hanna1(z, h, ust, wst, ol)
        up_pbl = _ou_update(p.up, rnd_h[0], turb0.sigu, dt / turb0.tlu)
        vp_pbl = _ou_update(p.vp, rnd_h[1], turb0.sigv, dt / turb0.tlv)
        if cfg.turboff:
            up_pbl = jnp.zeros_like(up_pbl)
            vp_pbl = jnp.zeros_like(vp_pbl)

        z_pbl, wp_pbl, icbt, _, nan_mask, nrand_end = _pbl_vertical(
            cfg, prm, z, p.wp, p.cbt, h, ust, wst, ol, wind.rho,
            wind.drhodz, rnd_w, dt, key=key,
            legacy_cbl=((leg.table, l_b2)
                        if (legacy and cfg.cblflag) else None))
        daw_pbl = up_pbl * dt
        dcw_pbl = vp_pbl * dt

        settling = settle_fn(z) if settle_fn is not None \
            else jnp.zeros_like(z)
        w_eff = w + settling

        dxs_pbl = u * dt
        dys_pbl = v * dt
        z_pbl = z_pbl + w_eff * dt * ldirf
        z_pbl = jnp.minimum(z_pbl, htop)
        z_pbl = jnp.where(z_pbl < 0.0, jnp.minimum(h - 1e-9, -z_pbl),
                          z_pbl)

        # ------ free troposphere / stratosphere (advance.f90:629-708) --
        rnd_ft = l_rnd_ft if legacy else rng.normals(key, (3, n), tag=3)
        weight = jnp.clip((z - tropop) / 1000.0, 0.0, 1.0)
        uxscale_t = jnp.sqrt(2.0 * D_TROP / dt)
        uxscale_tr = jnp.sqrt(2.0 * D_TROP / dt * (1.0 - weight))
        wpscale_tr = jnp.sqrt(2.0 * D_STRAT / dt * weight)
        wpscale_s = jnp.sqrt(2.0 * D_STRAT / dt)

        ux = jnp.where(in_trop, rnd_ft[0] * uxscale_t,
                       jnp.where(in_trans, rnd_ft[0] * uxscale_tr, 0.0))
        vy = jnp.where(in_trop, rnd_ft[1] * uxscale_t,
                       jnp.where(in_trans, rnd_ft[1] * uxscale_tr, 0.0))
        wp_ft = jnp.where(in_trop, 0.0,
                          jnp.where(in_trans,
                                    rnd_ft[2] * wpscale_tr
                                    + D_STRAT / 1000.0,
                                    rnd_ft[2] * wpscale_s))
        if cfg.turboff:
            ux = jnp.zeros_like(ux)
            vy = jnp.zeros_like(vy)
            wp_ft = jnp.zeros_like(wp_ft)

        dxs_ft = (u + ux) * dt
        dys_ft = (v + vy) * dt
        z_ft = z + (w_eff + wp_ft) * dt * ldirf
        z_ft = jnp.where(z_ft < 0.0, jnp.minimum(h - 1e-9, -z_ft), z_ft)

        # ---------------- merge branches ----------------
        dxsave = jnp.where(pbl, dxs_pbl, dxs_ft)
        dysave = jnp.where(pbl, dys_pbl, dys_ft)
        dawsave = jnp.where(pbl, daw_pbl, 0.0)
        dcwsave = jnp.where(pbl, dcw_pbl, 0.0)
        z_new = jnp.where(pbl, z_pbl, z_ft)
        up_new = jnp.where(pbl, up_pbl, p.up)
        vp_new = jnp.where(pbl, vp_pbl, p.vp)
        wp_new = jnp.where(pbl, wp_pbl, wp_ft)
        icbt = jnp.where(pbl, icbt, p.cbt)
        u_ref, v_ref, w_ref = u, v, w_eff
        idt_new = None
        nanc_extra = None
        t_below = None
        pett_gate = True

        # ------------ mesoscale draws (advance.f90:720-738) ------------
        if legacy and cfg.cblflag:
            # cblflag skips the static post-loop advance
            # (advance.f90:499), so the meso base for PBL particles is
            # the last in-loop index consumed — the first meso draw
            # REUSES that entry, exactly like the Fortran
            tab_m = leg.table
            Rm = tab_m.shape[0] - 1
            mb = jnp.where(pbl, nrand_end, l_ft_meso)
            mb = jnp.where(mb + 2 > Rm, 1, mb)
            rnd_m = jnp.stack([tab_m[mb], tab_m[mb + 1],
                               tab_m[mb + 2]], 0)
        else:
            rnd_m = l_rnd_m if legacy else rng.normals(key, (3, n),
                                                       tag=4)
    r = jnp.exp(-2.0 * prm.lsynctime / prm.lwindinterv)
    rs = jnp.sqrt(1.0 - r * r)
    usig_new = r * p.usig + rs * rnd_m[0] * usig_w * TURBMESOSCALE
    vsig_new = r * p.vsig + rs * rnd_m[1] * vsig_w * TURBMESOSCALE
    wsig_new = r * p.wsig + rs * rnd_m[2] * wsig_w * TURBMESOSCALE
    if cfg.turboff:
        usig_new = jnp.zeros_like(usig_new)
        vsig_new = jnp.zeros_like(vsig_new)
        wsig_new = jnp.zeros_like(wsig_new)
    lsync = prm.lsynctime
    dxsave = dxsave + usig_new * lsync
    dysave = dysave + vsig_new * lsync
    z_new = z_new + wsig_new * lsync
    z_new = jnp.abs(z_new)

    # ------- windalign + metric position update (advance.f90:747-799) -------
    # rotation from the LAST-interpolated wind (windalign.f90 is called
    # with the u,v of the final pass in adaptive mode)
    ffinv = 1.0 / jnp.maximum(jnp.sqrt(u_ref * u_ref + v_ref * v_ref),
                              1e-30)
    sinphi, cosphi = v_ref * ffinv, u_ref * ffinv
    ux_t = cosphi * dawsave - sinphi * dcwsave
    vy_t = sinphi * dawsave + cosphi * dcwsave
    dxsave = dxsave + ux_t
    dysave = dysave + vy_t

    cosfact = prm.dxconst / jnp.cos((y * prm.dy + prm.ylat0) * PI180)
    x_hi, x_lo = ds_add(p.x_hi, p.x_lo, dxsave * cosfact * ldirf)
    y_hi, y_lo = ds_add(p.y_hi, p.y_lo, dysave * prm.dyconst * ldirf)

    pol = jnp.zeros_like(x, bool)
    if cfg.polar:
        # stereographic update inside the polar caps (advance.f90:754-778)
        nxm_eff = jnp.where(prm.nxm_pol > 0, prm.nxm_pol,
                            jnp.float32(cfg.nx - 1))
        xg_p, yg_p, pn, ps = _polar_update(prm, x, y, dxsave, dysave,
                                           ldirf, nxm_eff)
        pol = pn | ps
        x_hi = jnp.where(pol, xg_p, x_hi)
        x_lo = jnp.where(pol, 0.0, x_lo)
        y_hi = jnp.where(pol, yg_p, y_hi)
        y_lo = jnp.where(pol, 0.0, y_lo)

    x_hi, x_lo, y_hi, y_lo, exited = _apply_bcs(cfg, prm, x_hi, x_lo, y_hi,
                                                 y_lo)
    z_new = jnp.minimum(z_new, htop)

    # ---------------- Petterssen corrector (advance.f90:816-986) ------------
    # only full-interval steps correct (ldt==lsynctime gate, :829)
    can_pett = (jnp.abs(endtime) <= jnp.abs(memtime1)) & (~exited) \
        & pett_gate
    if cfg.polar and cfg.tile_mode:
        # tile mode: a cap-ending predictor may land outside this tile's
        # halo (meridian convergence), so the endpoint wind gather can't
        # be done locally — skip the corrector for those (the reference
        # similarly skips it when the step switches grids,
        # advance.f90:841-857); cap starters whose endpoint stayed put
        # still can't gather across the post-wrap jump, so gate on pol
        can_pett = can_pett & ~pol
    xn = x_hi + x_lo
    yn = y_hi + y_lo
    hw2 = horiz_weights(xn, yn, cfg.nx, cfg.ny, cfg.xglobal)
    indz2, dz1_2 = vert_weights(z_new, height)
    if legacy_interp:
        # reference-exact per-time-level corrector wind
        # (interpol_wind_short.f90)
        u2, v2, w2 = interp_wind_short(z0, z1, hw2, indz2, dz1_2,
                                       ew0, ew1)
    else:
        u2, v2, w2 = interp_wind_short_quad(tables.rowsE, hw2, indz2,
                                            dz1_2, cfg.nx, cfg.ny)
    for k, (nnx, nny) in enumerate(nshapes):
        in_nest2 = ((xn > prm.xln[k] + eps_n) & (xn < prm.xrn[k] - eps_n)
                    & (yn > prm.yln[k] + eps_n)
                    & (yn < prm.yrn[k] - eps_n))
        xtn2 = jnp.clip((xn - prm.xln[k]) * prm.xresoln[k], 0.0,
                        nnx - 1.001)
        ytn2 = jnp.clip((yn - prm.yln[k]) * prm.yresoln[k], 0.0,
                        nny - 1.001)
        hw2n = horiz_weights(xtn2, ytn2, nnx, nny, False)
        u2n, v2n, w2n = interp_wind_short_quad(tables_n[k].rowsE, hw2n,
                                               indz2, dz1_2, nnx, nny)
        u2 = jnp.where(in_nest2, u2n, u2)
        v2 = jnp.where(in_nest2, v2n, v2)
        w2 = jnp.where(in_nest2, w2n, w2)
    w2 = w2 + settling
    du = (u2 - u_ref) / 2.0
    dv = (v2 - v_ref) / 2.0
    dw = (w2 - w_ref) / 2.0
    dtl = prm.lsynctime

    z_corr = z_new + dw * dtl * ldirf
    z_corr = jnp.where(z_corr < 0.0, jnp.minimum(h - 1e-9, -z_corr), z_corr)
    cosfact2 = prm.dxconst / jnp.cos((yn * prm.dy + prm.ylat0) * PI180)
    xc_hi, xc_lo = ds_add(x_hi, x_lo, du * cosfact2 * dtl * ldirf)
    yc_hi, yc_lo = ds_add(y_hi, y_lo, dv * prm.dyconst * dtl * ldirf)
    if cfg.polar:
        nxm_eff2 = jnp.where(prm.nxm_pol > 0, prm.nxm_pol,
                             jnp.float32(cfg.nx - 1))
        xg_c, yg_c, pn2, ps2 = _polar_update(prm, xn, yn, du * dtl,
                                             dv * dtl, ldirf, nxm_eff2)
        pol2 = pn2 | ps2
        xc_hi = jnp.where(pol2, xg_c, xc_hi)
        xc_lo = jnp.where(pol2, 0.0, xc_lo)
        yc_hi = jnp.where(pol2, yg_c, yc_hi)
        yc_lo = jnp.where(pol2, 0.0, yc_lo)
    xc_hi, xc_lo, yc_hi, yc_lo, exited2 = _apply_bcs(cfg, prm, xc_hi, xc_lo,
                                                     yc_hi, yc_lo)

    x_hi = jnp.where(can_pett, xc_hi, x_hi)
    x_lo = jnp.where(can_pett, xc_lo, x_lo)
    y_hi = jnp.where(can_pett, yc_hi, y_hi)
    y_lo = jnp.where(can_pett, yc_lo, y_lo)
    z_new = jnp.where(can_pett, z_corr, z_new)
    exited = exited | (can_pett & exited2)
    z_new = jnp.minimum(z_new, htop)

    # ---------------- write back (masked on scheduled) ----------------
    keep = scheduled & (~exited)

    def sel(new, old):
        return jnp.where(scheduled, new, old)

    new_p = p._replace(
        x_hi=sel(x_hi, p.x_hi), x_lo=sel(x_lo, p.x_lo),
        y_hi=sel(y_hi, p.y_hi), y_lo=sel(y_lo, p.y_lo),
        z=sel(z_new, p.z),
        up=sel(up_new, p.up), vp=sel(vp_new, p.vp), wp=sel(wp_new, p.wp),
        usig=sel(usig_new, p.usig), vsig=sel(vsig_new, p.vsig),
        wsig=sel(wsig_new, p.wsig),
        cbt=jnp.where(scheduled, icbt, p.cbt).astype(jnp.int8),
        itra=jnp.where(scheduled,
                       itime + prm.lsynctime.astype(jnp.int32) * cfg.ldirect,
                       p.itra),
        active=jnp.where(scheduled, keep, p.active),
    )
    if cfg.method == 1:
        # store the next adaptive step (timemanager passes idt inout)
        new_p = new_p._replace(idt=jnp.where(scheduled, idt_new, p.idt))
        nanc = nanc_extra
    elif not legacy:
        nanc = jnp.sum((nan_mask & scheduled & pbl).astype(jnp.int32))
    else:
        nanc = jnp.zeros((), jnp.int32)
    diag = StepDiag(
        n_active=jnp.sum(new_p.active.astype(jnp.int32)),
        n_exited=jnp.sum((scheduled & exited).astype(jnp.int32)),
        nan_count=nanc,
        t_below=(jnp.where(scheduled, t_below, 0.0)
                 if t_below is not None else None),
    )
    return new_p, diag


@functools.partial(jax.jit, static_argnames=("cfg", "n_chunks"))
def advance_chunked(p: Particles, z0: ZFields, z1: ZFields,
                    itime, memtime0, memtime1, key,
                    cfg: StepConfig, prm: StepParams, n_chunks: int,
                    z0n: ZFields | None = None,
                    z1n: ZFields | None = None):
    """advance_all over particle chunks via lax.map: bounds the gather
    intermediates (the (F,2,B,4) corner arrays) to one chunk, letting a
    single chip hold 10M+ particles in HBM.  Each chunk folds its index
    into the step key so streams stay decorrelated."""
    n = p.capacity
    if n % n_chunks:
        raise ValueError(f"capacity {n} not divisible by {n_chunks} chunks")
    b = n // n_chunks
    pc = jax.tree.map(lambda a: a.reshape((n_chunks, b) + a.shape[1:]), p)

    # per-step grid tables built ONCE, shared by every chunk (the lax.map
    # body closes over them so XLA keeps a single copy in HBM instead of
    # re-blending the full stack per chunk)
    dt1 = (itime - memtime0).astype(jnp.float32)
    dt2 = (memtime1 - itime).astype(jnp.float32)
    dtt = 1.0 / (dt1 + dt2)
    endtime = itime + prm.lsynctime.astype(jnp.int32) * cfg.ldirect
    edt1 = (endtime - memtime0).astype(jnp.float32)
    edt2 = (memtime1 - endtime).astype(jnp.float32)
    edtt = 1.0 / jnp.maximum(edt1 + edt2, 1e-6)
    mdt = jnp.bfloat16 if cfg.met_bf16 else jnp.float32
    tables = build_step_tables_quad(z0, z1, dt2 * dtt, dt1 * dtt,
                                    edt2 * edtt, edt1 * edtt, dtype=mdt)
    zn0_t = (tuple(z0n) if isinstance(z0n, (tuple, list))
             else ((z0n,) if z0n is not None else ()))
    zn1_t = (tuple(z1n) if isinstance(z1n, (tuple, list))
             else ((z1n,) if z1n is not None else ()))
    tables_n = (tuple(
        build_step_tables_quad(a, b, dt2 * dtt, dt1 * dtt,
                               edt2 * edtt, edt1 * edtt, dtype=mdt)
        for a, b in zip(zn0_t, zn1_t)) or None)

    def body(args):
        pi, i = args
        ki = jax.random.fold_in(key, i)
        return advance_all(pi, z0, z1, itime, memtime0, memtime1, ki,
                           cfg, prm, z0n, z1n, tables=tables,
                           tables_n=tables_n)

    pout, diag = jax.lax.map(body, (pc, jnp.arange(n_chunks)))
    p2 = jax.tree.map(lambda a: a.reshape((n,) + a.shape[2:]), pout)
    return p2, StepDiag(n_active=diag.n_active.sum(),
                        n_exited=diag.n_exited.sum(),
                        nan_count=diag.nan_count.sum(),
                        t_below=(diag.t_below.reshape(n)
                                 if diag.t_below is not None else None))


def _apply_bcs(cfg: StepConfig, prm: StepParams, x_hi, x_lo, y_hi, y_lo):
    """Cyclic longitude + pole mirroring for global grids; exit detection
    (advance.f90:784-808).  The double-single position pair is collapsed to
    plain f32 only for particles that actually wrap/mirror."""
    x = x_hi + x_lo
    y = y_hi + y_lo
    if cfg.tile_mode:
        # tile-local coordinates: the halo absorbs the step displacement;
        # wrap/mirror/exit happen in global coordinates in the caller
        return x_hi, x_lo, y_hi, y_lo, jnp.zeros_like(x, bool)
    nxm = jnp.float32(cfg.nx - 1)
    nym = jnp.float32(cfg.ny - 1)
    eps = jnp.float32(cfg.nx / 3.0e5)
    if cfg.xglobal:
        xw = jnp.where(x >= nxm, x - nxm, x)
        xw = jnp.where(x < 0.0, x + nxm, xw)
        xw = jnp.where(xw <= eps, eps, xw)
        xw = jnp.where(jnp.abs(xw - nxm) <= eps, nxm - eps, xw)
        # pole crossing: mirror and shift 180 deg (advance.f90:792-798)
        crossed_s = y < 0.0
        crossed_n = y > nym
        xw = jnp.where(crossed_s | crossed_n,
                       jnp.mod(xw * prm.dx + 180.0, 360.0) / prm.dx, xw)
        yw = jnp.where(crossed_s, -y, y)
        yw = jnp.where(crossed_n, 2.0 * nym - yw, yw)
        x_changed = xw != x
        y_changed = yw != y
        x_hi = jnp.where(x_changed, xw, x_hi)
        x_lo = jnp.where(x_changed, 0.0, x_lo)
        y_hi = jnp.where(y_changed, yw, y_hi)
        y_lo = jnp.where(y_changed, 0.0, y_lo)
        exited = (xw < 0.0) | (xw >= nxm) | (yw < 0.0) | (yw > nym)
        return x_hi, x_lo, y_hi, y_lo, exited
    exited = (x < 0.0) | (x >= nxm) | (y < 0.0) | (y > nym)
    return x_hi, x_lo, y_hi, y_lo, exited
