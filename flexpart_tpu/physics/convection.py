"""Convective redistribution: Emanuel (1991) buoyancy-sorting scheme.

Re-design of the reference convection stack — convmix.f90 (driver),
calcmatrix.f90 (matrix assembly), convect43c.f90 (Emanuel CONVECT v4.3c as
adapted for FLEXPART: only the displacement matrix FMASS, compensating
subsidence SUB and the cloud-base-mass-flux memory CBMF matter for an
LPDM; the T/q tendencies of the original scheme are unused) and
redist.f90 (per-particle categorical redistribution).

Design differences from the Fortran (SURVEY.md §7 "hard parts" #3):
  * the reference sorts particles by grid column and runs the scheme
    serially per occupied column (convmix.f90:152-202); here the scheme is
    BATCHED over a leading column axis and runs for every grid column at
    once — embarrassingly parallel on the VPU, no sort needed;
  * early returns (iflag 0/2/3) become validity masks; the running-min
    loop in the entrainment normalization becomes a lax.scan over the
    level axis with the column axis vectorized;
  * per-particle redistribution is one gather + cumulative-sum
    categorical draw over the particle axis (redist.f90:100-140).

All level indices below are 0-based: index k here = Fortran level k+1.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GA, R_AIR
from ..met.thermo import f_qvsat

# Emanuel scheme parameters (convect43c.f90:250-262)
ELCRIT = 0.0011
TLCRIT = -55.0
ENTP = 1.5
DTMAX_C = 0.9
ALPHA = 0.025
DAMP = 0.1
CPD = 1005.7
CPV = 1870.0
CL_W = 2500.0
RV = 461.5
RD = 287.04
LV0 = 2.501e6
CPVMCL = CL_W - CPV
EPS0 = RD / RV
EPSI = 1.0 / EPS0
EPSILON = 1.0e-20


def nconvlev_from_grid(akz, bkz, nlev: int) -> int:
    """Number of profile levels for convection: up to the first level with
    p(SLP) < 50 hPa (gridcheck_ecmwf.f90:553-565)."""
    p = np.asarray(akz) + np.asarray(bkz) * 101325.0
    idx = int(np.argmax(p < 5000.0))
    if p[min(idx, nlev - 1)] >= 5000.0:
        idx = nlev - 2
    return int(min(idx, nlev - 2))


def _tlift_sat(tconv, qconv, qsconv, pconv, gz, q_nk, ah0):
    """Saturated-ascent parcel at every level, 2 Newton iterations
    (TLIFT, convect43c.f90:1041-1060).  All (C, L1)."""
    tg = tconv
    qg = qsconv
    alv = LV0 - CPVMCL * (tconv - 273.15)
    for _ in range(2):
        s = 1.0 / (CPD + alv * alv * qg / (RV * tconv * tconv))
        ahg = CPD * tg + (CL_W - CPD) * q_nk * tconv + alv * qg + gz
        tg = jnp.maximum(tg + s * (ah0 - ahg), 35.0)
        tc = tg - 273.15
        es = jnp.where(
            tc >= 0.0,
            6.112 * jnp.exp(17.67 * tc / (243.5 + tc)),
            jnp.exp(23.33086 - 6111.72784 / tg + 0.15215 * jnp.log(tg)))
        qg = EPS0 * es / jnp.maximum(pconv - es * (1.0 - EPS0), 1e-6)
    tpk = (ah0 - (CL_W - CPD) * q_nk * tconv - gz - alv * qg) / CPD
    clw = jnp.maximum(q_nk - qg, 0.0)
    tvp = tpk * (1.0 + (qg / (1.0 - q_nk)) * EPSI)
    return tvp, tpk, clw


@functools.partial(jax.jit, static_argnames=("nl",))
def convect_columns(pconv, phconv, tconv, qconv, cbmf0, nl: int):
    """Batched Emanuel scheme over C columns.

    pconv (C, L1) full-level p [hPa]; phconv (C, L2) half-level p [hPa];
    tconv/qconv (C, L1); cbmf0 (C,) flux memory.  L1 = nl+1, L2 = nl+2.
    Returns (fmass (C, L1, L1) [source, dest] in CBMF units,
             sub (C, L1), cbmf (C,), lconv (C,), nctop (C,) 0-based
             inclusive top level)."""
    C, L1 = pconv.shape
    assert L1 == nl + 1
    lev = jnp.arange(L1)
    dph = phconv[:, :L1] - phconv[:, 1:L1 + 1]       # (C, L1) > 0

    qsconv = f_qvsat(pconv * 100.0, tconv)

    # ---- profiles (convect43c.f90:398-424) ----
    tv = tconv * (1.0 + qconv * EPSI - qconv)
    cpn = CPD * (1.0 - qconv) + CPV * qconv
    lv = LV0 - CPVMCL * (tconv - 273.15)
    dgz = jnp.zeros_like(pconv).at[:, 1:].set(
        0.5 * RD * (tv[:, 1:] + tv[:, :-1])
        * (pconv[:, :-1] - pconv[:, 1:]) / phconv[:, 1:L1])
    gz = jnp.cumsum(dgz, axis=1)
    h = tconv * cpn + gz
    hm = (CPD * (1.0 - qconv) + CL_W * qconv) \
        * (tconv - tconv[:, :1]) + lv * qconv + gz
    hm = hm.at[:, 0].set(lv[:, 0] * qconv[:, 0])

    # ---- parcel origin: min moist static energy, then max below it ----
    cand = jnp.concatenate(
        [jnp.zeros((C, 1), bool), hm[:, 1:] < hm[:, :-1]], axis=1)
    ihmin = jnp.argmin(jnp.where(cand, hm, jnp.inf), axis=1)
    ihmin = jnp.where(jnp.any(cand, axis=1), ihmin, nl - 1)
    ihmin = jnp.minimum(ihmin, nl - 2)
    nk = jnp.argmax(jnp.where(lev[None, :] <= ihmin[:, None], hm, -jnp.inf),
                    axis=1)

    def take(a, idx):
        return jnp.take_along_axis(a, idx[:, None], axis=1)[:, 0]

    t_nk = take(tconv, nk)
    q_nk = take(qconv, nk)
    ok0 = (t_nk >= 250.0) & (q_nk > 0.0) & (ihmin < nl - 2)

    # ---- LCL (Bolton 1980; convect43c.f90:447-455) ----
    rh = jnp.clip(q_nk / jnp.maximum(take(qsconv, nk), 1e-10), 1e-6, 1.0)
    chi = t_nk / (1669.0 - 122.0 * rh - t_nk)
    plcl = take(pconv, nk) * rh ** chi
    ok2 = (plcl >= 200.0) & (plcl < 2000.0)

    # ---- first level above LCL (ICB) ----
    above_lcl = (pconv < plcl[:, None]) & (lev[None, :] > nk[:, None])
    icb = jnp.where(jnp.any(above_lcl, axis=1),
                    jnp.argmax(above_lcl, axis=1), nl - 2)
    icb = jnp.minimum(icb, nl - 2)
    ok3 = icb < nl - 2

    # ---- lifted parcel (TLIFT) ----
    gz_nk = take(gz, nk)
    ah0 = (CPD * (1.0 - q_nk) + CL_W * q_nk) * t_nk \
        + q_nk * (LV0 - CPVMCL * (t_nk - 273.15)) + gz_nk
    cpp = CPD * (1.0 - q_nk) + q_nk * CPV
    tpk_dry = t_nk[:, None] - (gz - gz_nk[:, None]) / cpp[:, None]
    tvp_dry = tpk_dry * (1.0 + q_nk[:, None] * EPSI)
    tvp_sat, tpk_sat, clw_sat = _tlift_sat(
        tconv, qconv, qsconv, pconv, gz, q_nk[:, None], ah0[:, None])
    sat_zone = lev[None, :] >= icb[:, None]
    tvp = jnp.where(sat_zone, tvp_sat, tvp_dry)
    tp = jnp.where(sat_zone, tpk_sat, tpk_dry)
    clw = jnp.where(sat_zone, clw_sat, 0.0)
    # water-loading correction (convect43c.f90:478-480,529-531)
    tvp = tvp - tp * q_nk[:, None]

    tvp_icb = take(tvp, icb)
    tv_icb = take(tv, icb)
    stable = (cbmf0 == 0.0) & (tvp_icb <= tv_icb - DTMAX_C)

    # ---- precipitation efficiency (convect43c.f90:506-524) ----
    tca = tp - 273.15
    elacrit = jnp.where(tca >= 0.0, ELCRIT,
                        jnp.maximum(ELCRIT * (1.0 - tca / TLCRIT), 0.0))
    ep = jnp.clip(0.999 * (1.0 - elacrit / jnp.maximum(clw, 1e-8)),
                  0.0, 0.999)
    ep = jnp.where(lev[None, :] <= nk[:, None], 0.0, ep)

    # ---- CAPE scan -> INB / INB1 (convect43c.f90:556-576) ----
    by = (tvp - tv) * dph / pconv
    in_scan = (lev[None, :] >= icb[:, None] + 1) & (lev[None, :] <= nl - 2)
    by_m = jnp.where(in_scan, by, 0.0)
    cape_cum = jnp.cumsum(by_m, axis=1)
    inb1 = jnp.max(jnp.where(in_scan & (by >= 0.0), lev[None, :] + 1, 0),
                   axis=1)
    inb1 = jnp.maximum(inb1, icb + 1)
    pos = in_scan & (cape_cum > 0.0)
    last_pos = jnp.max(jnp.where(pos, lev[None, :], -1), axis=1)
    has_cape = last_pos >= 0
    inb = jnp.maximum(jnp.where(has_cape, last_pos + 1, icb + 1), inb1)
    inb = jnp.minimum(inb, nl - 1)

    # ---- liquid-water static energy of the lifted parcel ----
    in_cloud = (lev[None, :] >= icb[:, None]) & (lev[None, :] <= inb[:, None])
    hp = jnp.where(in_cloud,
                   take(h, nk)[:, None] + (lv + (CPD - CPV) * tconv)
                   * ep * clw, h)

    # ---- cloud-base mass flux relaxation (convect43c.f90:592-614) ----
    icbm = jnp.maximum(icb - 1, 0)
    tvp_icbm = take(tvp, icbm)
    p_icbm = take(pconv, icbm)
    tvpplcl = tvp_icbm - RD * tvp_icbm * (p_icbm - plcl) \
        / (take(cpn, icbm) * p_icbm)
    p_icb = take(pconv, icb)
    icb1 = jnp.minimum(icb + 1, nl)
    tvaplcl = tv_icb + (tvp_icb - take(tvp, icb1)) * (plcl - p_icb) \
        / jnp.maximum(p_icb - take(pconv, icb1), 1e-3)
    pbl_zone = (lev[None, :] >= nk[:, None]) & (lev[None, :] < icb[:, None])
    dtpbl = jnp.sum(jnp.where(pbl_zone, (tvp - tv) * dph, 0.0), axis=1) \
        / jnp.maximum(take(phconv[:, :L1], nk) - take(phconv[:, :L1], icb),
                      1e-3)
    dtma = tvpplcl - tvaplcl + DTMAX_C + dtpbl
    damps = DAMP * 3.0        # DAMP*DELT/DELT0 with DELT0 = DELT/3
    cbmf = jnp.maximum((1.0 - damps) * cbmf0 + 0.1 * ALPHA * dtma, 0.0)
    any_flux = (cbmf > 0.0) | (cbmf0 > 0.0)
    valid = ok0 & ok2 & ok3 & (~stable) & any_flux

    # ---- updraft mass fractions M(i) (convect43c.f90:620-634) ----
    k_idx = jnp.minimum(lev[None, :], inb1[:, None])
    k_idx = jnp.broadcast_to(k_idx, (C, L1))
    dbo = jnp.abs(jnp.take_along_axis(tv, k_idx, 1)
                  - jnp.take_along_axis(tvp, k_idx, 1)) \
        + ENTP * 0.02 * jnp.take_along_axis(dph, k_idx, 1)
    m_zone = (lev[None, :] >= icb[:, None] + 1) \
        & (lev[None, :] <= inb[:, None])
    dbo = jnp.where(m_zone, dbo, 0.0)
    m_flux = cbmf[:, None] * dbo \
        / jnp.maximum(jnp.sum(dbo, axis=1, keepdims=True), 1e-30)

    # ---- entrainment: SIJ / MENT (convect43c.f90:640-711) ----
    qti = q_nk[:, None] - ep * clw                   # indexed by i
    lv_j, t_j, qs_j, q_j = (a[:, None, :] for a in (lv, tconv, qsconv,
                                                    qconv))
    q_i, h_i, hp_i, qti_i = (a[:, :, None] for a in (qconv, h, hp, qti))
    h_j = h[:, None, :]
    bf2 = 1.0 + lv_j * lv_j * qs_j / (RV * t_j * t_j * CPD)
    anum = h_j - hp_i + (CPV - CPD) * t_j * (qti_i - q_j)
    denom = h_i - hp_i + (CPD - CPV) * (q_i - qti_i) * t_j
    dei = jnp.where(jnp.abs(denom) < 0.01, 0.01, denom)
    sij = anum / dei
    eye = jnp.eye(L1)[None]
    sij = sij * (1 - eye) + eye
    altem = (sij * q_i + (1.0 - sij) * qti_i - qs_j) / bf2
    cwat = (clw * (1.0 - ep))[:, None, :]
    j_gt_i = (lev[None, :] > lev[:, None])[None]
    redo = ((sij < 0.0) | (sij > 1.0) | (altem > cwat)) & j_gt_i
    anum2 = anum - lv_j * (qti_i - qs_j - cwat * bf2)
    denom2 = denom + lv_j * (q_i - qti_i)
    denom2 = jnp.where(jnp.abs(denom2) < 0.01, 0.01, denom2)
    sij2 = anum2 / denom2
    altem2 = sij2 * q_i + (1.0 - sij2) * qti_i - qs_j - (bf2 - 1.0) * cwat
    sij = jnp.where(redo, sij2, sij)
    del altem, altem2

    ij_zone = m_zone[:, :, None] & in_cloud[:, None, :]
    mixed = (sij > 0.0) & (sij < 0.9) & ij_zone & (1 - eye).astype(bool)
    ment = jnp.where(mixed, m_flux[:, :, None] / (1.0 - sij), 0.0)
    nent = jnp.sum(mixed, axis=2)
    sij = jnp.clip(sij, 0.0, 1.0)
    sij = sij * (1 - eye) + eye

    # detrain-at-level fallback (convect43c.f90:704-711)
    no_ent = (nent == 0) & m_zone
    ment = jnp.where(no_ent[:, :, None] & eye.astype(bool),
                     m_flux[:, :, None], ment)

    # ---- normalize to equal mixing probability (convect43c.f90:717-769):
    # weight w(I,J) from the spacing of SIJ around SCRIT; scan over j with
    # a per-(column, i) running-min carry
    qp1 = qti
    anum_s = h - hp - lv * (qp1 - qsconv)
    denom_s = h - hp + lv * (qconv - qp1)
    denom_s = jnp.where(jnp.abs(denom_s) < 0.01, 0.01, denom_s)
    scrit = anum_s / denom_s
    alt = qp1 - qsconv + scrit * (qconv - qp1)
    scrit = jnp.maximum(jnp.where(alt < 0.0, 1.0, scrit), 0.0)  # (C,L1) by i

    sij_jp = jnp.concatenate([sij[:, :, 1:], jnp.zeros((C, L1, 1))], axis=2)
    sij_jm = jnp.concatenate([jnp.zeros((C, L1, 1)), sij[:, :, :-1]], axis=2)

    def scan_j(smin, j):
        s_j = sij[:, :, j]
        s_jp = sij_jp[:, :, j]
        s_jm = sij_jm[:, :, j]
        in_range = (s_j > 0.0) & (s_j < 0.9)
        gt = jnp.broadcast_to(j > lev[None, :], (C, L1))    # j > i
        smid_g = jnp.minimum(s_j, scrit)
        new_min = (smid_g < smin) & (s_jp < smid_g)
        sjmax_g = jnp.where(new_min,
                            jnp.minimum(jnp.minimum(s_jp, s_j), scrit),
                            smid_g)
        sjmin_g = jnp.where(new_min,
                            jnp.minimum(jnp.maximum(s_jm, s_j), scrit),
                            smid_g)
        smin_next = jnp.where(in_range & gt & new_min, smid_g, smin)
        smid_l = jnp.maximum(s_j, scrit)
        sjmax_l = jnp.maximum(s_jp, scrit)
        sjmin_l = jnp.maximum(jnp.where(j > 0, s_jm, 0.0), scrit)
        smid = jnp.where(gt, smid_g, smid_l)
        sjmax = jnp.where(gt, sjmax_g, sjmax_l)
        sjmin = jnp.where(gt, sjmin_g, sjmin_l)
        w = jnp.where(in_range,
                      jnp.abs(sjmax - smid) + jnp.abs(sjmin - smid), 0.0)
        return smin_next, w

    _, w_all = jax.lax.scan(scan_j, jnp.ones((C, L1)), jnp.arange(L1))
    w_all = jnp.moveaxis(w_all, 0, 2)                # (C, i, j)
    w_dph = w_all * dph[:, None, :] * in_cloud[:, None, :]
    asij = jnp.maximum(jnp.sum(w_dph, axis=2, keepdims=True), 1e-21)
    ment_n = ment * w_dph / asij
    has_ent = (nent != 0)[:, :, None]
    ment = jnp.where(has_ent, ment_n, ment)
    bsum = jnp.sum(jnp.where(in_cloud[:, None, :], ment, 0.0), axis=2)
    dead = (nent != 0) & (bsum < 1e-18) & m_zone
    ment = jnp.where(dead[:, :, None],
                     jnp.where(eye.astype(bool), m_flux[:, :, None], 0.0),
                     ment)

    # ---- saturated up/downdraft fluxes per level (convect43c.f90:879-917):
    # FUP(i) = [i>=NK] sum_{k>i} M(k) + sum_{k<=i, j>i} MENT(k,j)
    # FDOWN(i) = sum_{k<i} sum_{j>=i} MENT(j,k)
    mask_j_gt_i = lev[None, None, :] > lev[None, :, None]
    m_above = jnp.sum(jnp.where(mask_j_gt_i, m_flux[:, None, :], 0.0),
                      axis=2)
    m_above = jnp.where(lev[None, :] >= nk[:, None], m_above, 0.0)
    ment_k_to_i = jnp.cumsum(ment, axis=1)           # sum over first idx <= i
    fup = m_above + jnp.sum(jnp.where(mask_j_gt_i, ment_k_to_i, 0.0), axis=2)
    ment_j_from_i = jnp.cumsum(ment[:, ::-1, :], axis=1)[:, ::-1, :]
    mask_k_lt_i = lev[None, None, :] < lev[None, :, None]
    fdown = jnp.sum(jnp.where(mask_k_lt_i, ment_j_from_i, 0.0), axis=2)

    # ---- displacement matrix + subsidence (convect43c.f90:1009-1032) ----
    nk_onehot = jax.nn.one_hot(nk, L1, dtype=ment.dtype)
    fmass = ment + nk_onehot[:, :, None] * m_flux[:, None, :]
    conv_box = lev[None, :] <= (inb[:, None] + 1)
    fmass = jnp.where(conv_box[:, :, None] & conv_box[:, None, :]
                      & valid[:, None, None], fmass, 0.0)
    big = fmass > EPSILON
    nctop = jnp.max(jnp.where(big, jnp.maximum(lev[None, None, :],
                                               lev[None, :, None]), 0),
                    axis=(1, 2)) + 1
    nctop = jnp.minimum(nctop, nl - 1)
    sub = jnp.zeros((C, L1)).at[:, 1:].set(fup[:, :-1] - fdown[:, 1:])
    sub = jnp.where(valid[:, None], sub, 0.0)

    cbmf_out = jnp.where(ok0 & ok2 & ok3, cbmf, 0.0)
    cbmf_out = jnp.where(stable & ok0 & ok2 & ok3, cbmf0, cbmf_out)
    return fmass, sub, cbmf_out, valid, nctop


@functools.partial(jax.jit, static_argnames=("nl",))
def fmassfrac_from_fmass(fmass, sub, dpr_pa, delt, nl: int):
    """calcmatrix.f90:118-135: scale by the timestep and put the
    non-displaced remainder on the diagonal.  dpr_pa (C, L1) in Pa."""
    rlevmass = dpr_pa / GA                           # (C, L1) kg/m2
    f = delt * fmass
    rowsum = jnp.sum(f, axis=2)
    L1 = nl + 1
    eye = jnp.eye(L1)[None]
    f = f + eye * (rlevmass - rowsum)[:, :, None]
    return f, rlevmass


def build_conv_profiles(akz, bkz, akm, bkm, ps, tth, qvh, tt2, td2):
    """convmix.f90:168-189 profile extraction (0-based): profile level k
    uses eta full level k+1 (the ground level is skipped).

    Returns (pconv_hpa (C,L1), phconv_hpa (C,L2), tconv, qconv, dpr_pa)
    flattened over the grid; L1 = nlev-1 here (callers slice to nl+1)."""
    nlev = tth.shape[0]
    C = ps.size
    psf = ps.reshape(1, C)
    akz = jnp.asarray(akz, jnp.float32)[1:, None]
    bkz = jnp.asarray(bkz, jnp.float32)[1:, None]
    akm_ = jnp.asarray(akm, jnp.float32)[1:, None]
    bkm_ = jnp.asarray(bkm, jnp.float32)[1:, None]
    pconv = (akz + bkz * psf)                        # (nlev-1, C) Pa
    phconv = jnp.concatenate([psf, akm_ + bkm_ * psf], axis=0)  # (nlev, C)
    tconv = tth.reshape(nlev, C)[1:]
    qconv = qvh.reshape(nlev, C)[1:]
    dpr = phconv[:-1] - phconv[1:]                   # (nlev-1, C) Pa
    return (pconv.T / 100.0, phconv.T / 100.0, tconv.T, qconv.T, dpr.T)


def make_convection_kernel(grid, nl: int | None = None):
    """Bind grid coefficients; return a jitted function
    (eta0, eta1, tw0, tw1, cbmf, delt) -> (fmassfrac, rlevmass, phconv_hpa,
    pconv_hpa, tconv, sub, uvzlev, lconv, nctop, cbmf_new) with all
    outputs shaped (C, ...) over flattened grid columns."""
    if nl is None:
        nl = nconvlev_from_grid(grid.akz, grid.bkz, grid.nlev)
    nl = min(nl, grid.nlev - 2)
    L1 = nl + 1
    akz, bkz = grid.akz, grid.bkz
    akm, bkm = grid.akm, grid.bkm

    @jax.jit
    def run(eta0_ps, eta0_tth, eta0_qvh, eta0_tt2, eta0_td2,
            eta1_ps, eta1_tth, eta1_qvh, eta1_tt2, eta1_td2,
            tw0, tw1, cbmf, delt):
        ps = eta0_ps * tw0 + eta1_ps * tw1
        tth = eta0_tth * tw0 + eta1_tth * tw1
        qvh = eta0_qvh * tw0 + eta1_qvh * tw1
        tt2 = eta0_tt2 * tw0 + eta1_tt2 * tw1
        td2 = eta0_td2 * tw0 + eta1_td2 * tw1
        pconv, phconv, tconv, qconv, dpr = build_conv_profiles(
            akz, bkz, akm, bkm, ps, tth, qvh, tt2, td2)
        pconv = pconv[:, :L1]
        phconv = phconv[:, :L1 + 1]
        tconv = tconv[:, :L1]
        qconv = qconv[:, :L1]
        dpr = dpr[:, :L1]
        fmass, sub, cbmf_new, lconv, nctop = convect_columns(
            pconv, phconv, tconv, qconv, cbmf, nl)
        fmassfrac, rlevmass = fmassfrac_from_fmass(
            fmass, sub, dpr, delt, nl)
        uvzlev = _uvzlev(phconv, pconv, tconv, qconv,
                         tt2.reshape(-1), td2.reshape(-1),
                         ps.reshape(-1) / 100.0)
        return (fmassfrac, rlevmass, phconv, pconv, tconv, sub, uvzlev,
                lconv, nctop, cbmf_new)

    run.nl = nl
    return run


def _uvzlev(phconv_hpa, pconv_hpa, tconv, qconv, tt2, td2, ps):
    """Heights AGL of the half levels by hypsometric integration of
    virtual temperature (redist.f90:46-100).  Returns (C, L1+1)."""
    from ..met.thermo import ew
    C, L1 = pconv_hpa.shape
    const = R_AIR / GA
    tvold = tt2 * (1.0 + 0.378 * ew(td2) / ps)       # (C,)
    tvfull = tconv * (1.0 + 0.608 * qconv)           # (C, L1)
    # virtual T at half level k+1 (between full levels k and k+1)
    tv_half = tvfull[:, :-1] + (tvfull[:, 1:] - tvfull[:, :-1]) \
        * (pconv_hpa[:, :-1] - phconv_hpa[:, 1:L1]) \
        / (pconv_hpa[:, :-1] - pconv_hpa[:, 1:])
    tv_seq = jnp.concatenate([tvold[:, None], tv_half], axis=1)  # (C, L1)
    p_seq = phconv_hpa                                  # (C, L1+1)

    def hyps(tv_lo, tv_hi, p_lo, p_hi):
        dlnp = jnp.log(jnp.maximum(p_lo, 1e-3) / jnp.maximum(p_hi, 1e-3))
        ratio = jnp.where(jnp.abs(tv_hi - tv_lo) > 0.2,
                          (tv_hi - tv_lo)
                          / jnp.log(jnp.maximum(tv_hi, 1.0)
                                    / jnp.maximum(tv_lo, 1.0)),
                          tv_hi)
        return const * dlnp * ratio

    dz = hyps(tv_seq[:, :-1], tv_seq[:, 1:], p_seq[:, :-2], p_seq[:, 1:-1])
    uvz = jnp.concatenate(
        [jnp.zeros((C, 1)), jnp.cumsum(dz, axis=1)], axis=1)  # (C, L1)
    # top half-level height (one more step using tv of the last full level)
    dz_top = hyps(tv_seq[:, -1], tvfull[:, -1], p_seq[:, -2], p_seq[:, -1])
    return jnp.concatenate([uvz, uvz[:, -1:] + dz_top[:, None]], axis=1)


@functools.partial(jax.jit, static_argnames=("nl", "nx", "ny", "ldirect"))
def redist_particles(p, key, fmassfrac, rlevmass, phconv_hpa, sub, uvzlev,
                     pconv_hpa, tconv, lconv, lsynctime, itime,
                     nl: int, nx: int, ny: int, ldirect: int):
    """Vectorized redist.f90: categorical draw of the destination level
    from the particle's column matrix row + compensating subsidence."""
    from ..core.state import Particles
    L1 = nl + 1
    n = p.capacity
    x, y, z = p.x, p.y, p.z
    ix = jnp.clip(jnp.round(x).astype(jnp.int32), 0, nx - 1)
    jy = jnp.clip(jnp.round(y).astype(jnp.int32), 0, ny - 1)
    col = jy * nx + ix

    live = p.active & (p.itra == itime) & lconv[col]
    uvz_p = uvzlev[col]                               # (N, L1+1)
    # levold: uvzlev[kz] is the LOWER boundary of cell kz (0-based);
    # reference: first kz in [2, nconvtop] with uvzlev(kz) >= z -> kz-1
    levold = jnp.clip(
        jnp.sum((uvz_p[:, 1:L1] < z[:, None]).astype(jnp.int32), axis=1),
        0, L1 - 1)
    in_dom = z < uvz_p[jnp.arange(n), jnp.minimum(levold + 1, L1)]
    live = live & in_dom

    row = fmassfrac[col, levold]                      # (N, L1)
    totmass = jnp.maximum(rlevmass[col, levold], 1e-30)
    if ldirect < 0:
        row = fmassfrac[col, :, levold]               # transposed matrix
    frac = jnp.cumsum(row / totmass[:, None], axis=1)
    rn = jax.random.uniform(key, (n,))
    hit = frac >= rn[:, None]
    levnew = jnp.where(jnp.any(hit, axis=1),
                       jnp.argmax(hit, axis=1), levold)
    moved = live & (levnew != levold)

    # new z inside destination cell, uniform in mass => linear in
    # (ffraction - rn) within the cell, log-p interpolated
    ffrac_at = jnp.take_along_axis(frac, levnew[:, None], axis=1)[:, 0]
    f_at = jnp.take_along_axis(row, levnew[:, None], axis=1)[:, 0]
    dlevfrac = jnp.where(ffrac_at > 1e-20,
                         (ffrac_at - rn) * totmass
                         / jnp.maximum(f_at * totmass, 1e-30), 0.5)
    dlevfrac = jnp.clip(dlevfrac, 0.0, 1.0)
    ph_p = phconv_hpa[col]                            # (N, L1+1)
    lo = jnp.take_along_axis(ph_p, levnew[:, None], axis=1)[:, 0]
    hi = jnp.take_along_axis(ph_p, jnp.minimum(levnew + 1, L1)[:, None],
                             axis=1)[:, 0]
    # note hi < lo (pressure decreases upward): dz1, dz2, dz all negative,
    # signs cancel in the weighted mean (redist.f90:146-152)
    dlogp = (1.0 - dlevfrac) * (jnp.log(hi) - jnp.log(lo))
    pint = jnp.log(lo) + dlogp
    dz1 = pint - jnp.log(lo)
    dz2 = jnp.log(hi) - pint
    dz = dz1 + dz2
    dz = jnp.where(jnp.abs(dz) > 1e-20, dz, -1e-20)
    z_lo = jnp.take_along_axis(uvz_p, levnew[:, None], axis=1)[:, 0]
    z_hi = jnp.take_along_axis(uvz_p, jnp.minimum(levnew + 1, L1)[:, None],
                               axis=1)[:, 0]
    z_new = jnp.abs((z_lo * dz2 + z_hi * dz1) / dz)

    # compensating subsidence for non-redistributed particles
    # (redist.f90:170-215)
    sub_p = sub[col]                                  # (N, L1)
    dpr_p = rlevmass[col] * GA                        # back to Pa
    lo_i = levold
    lo_m = jnp.maximum(levold - 1, 0)
    t_mid = lambda a, i: jnp.take_along_axis(a, i[:, None], axis=1)[:, 0]

    def wsub_at(levi):
        """-sub/(1-sub/dpr*g) * R * T(half) / p(half) at half level levi."""
        levim = jnp.maximum(levi - 1, 0)
        tk = t_mid(tconv[col], levim)
        tk1 = t_mid(tconv[col], levi)
        pk = t_mid(pconv_hpa[col], levim)
        pk1 = t_mid(pconv_hpa[col], levi)
        phk = t_mid(phconv_hpa[col][:, :L1], levi)
        t_half = tk + (tk1 - tk) * (pk - phk) / jnp.maximum(pk - pk1, 1e-3)
        s = t_mid(sub_p, levi)
        d = t_mid(dpr_p, levi)
        s_eff = s / jnp.maximum(1.0 - s / d * GA, 1e-3)
        # phconv in Pa here (redist.f90:186 uses the Pa array)
        return -s_eff * R_AIR * t_half / jnp.maximum(phk * 100.0, 1e-3)

    w_lo = jnp.where(levold > 0, wsub_at(jnp.maximum(levold, 1)), 0.0)
    w_hi = wsub_at(jnp.minimum(levold + 1, L1 - 1))
    z_l = jnp.take_along_axis(uvz_p, levold[:, None], axis=1)[:, 0]
    z_h = jnp.take_along_axis(uvz_p, jnp.minimum(levold + 1, L1)[:, None],
                              axis=1)[:, 0]
    d1 = z - z_l
    d2 = jnp.maximum(z_h - z, 0.0)
    wpart = (d2 * w_lo + d1 * w_hi) / jnp.maximum(d1 + d2, 1e-30)
    z_sub = jnp.abs(z + wpart * jnp.float32(lsynctime))

    z_out = jnp.where(moved, z_new, jnp.where(live, z_sub, z))
    return p._replace(z=z_out), jnp.sum(moved.astype(jnp.int32))
