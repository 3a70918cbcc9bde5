"""Space-time interpolation of met fields at particle positions.

Vectorized re-design of the reference interpolation family
(interpol_all.f90, interpol_wind.f90, interpol_mod.f90): per particle, one
fused gather fetches the 4 horizontal corners x 2 vertical levels x 2 time
levels of every needed 3-D field at once from the stacked field array
(fields.ZFields.f3d), then bilinear/linear/linear weights combine them.
Wind standard deviations (mesoscale driver) use the same gathered corner
values, matching interpol_all.f90:216-240 (per-level, 8 samples) and
interpol_wind.f90:195-215 (16 samples).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..met.fields import ZFields, F3_U, F3_V, F3_W, F3_RHO, F3_DRHODZ

_HIGHEST = jax.lax.Precision.HIGHEST


class HorizWeights(NamedTuple):
    ix: jnp.ndarray    # (N,) i32 lower-left corner
    jy: jnp.ndarray
    idx4: jnp.ndarray  # (N,4) i32 flattened corner indices into (ny*nx)
    p4: jnp.ndarray    # (N,4) f32 bilinear weights


def horiz_weights(x, y, nx: int, ny: int, xglobal: bool) -> HorizWeights:
    """Bilinear corner indices/weights (advance.f90:208-218).  For global
    grids the +1 column wraps cyclically."""
    ix = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, nx - 2)
    jy = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, ny - 2)
    ddx = jnp.clip(x - ix, 0.0, 1.0)
    ddy = jnp.clip(y - jy, 0.0, 1.0)
    rddx = 1.0 - ddx
    rddy = 1.0 - ddy
    p4 = jnp.stack([rddx * rddy, ddx * rddy, rddx * ddy, ddx * ddy], axis=-1)
    ixp = ix + 1
    if xglobal:
        ixp = jnp.where(ixp > nx - 1, 0, ixp)
    jyp = jnp.minimum(jy + 1, ny - 1)
    base = jy * nx
    basep = jyp * nx
    idx4 = jnp.stack([base + ix, base + ixp, basep + ix, basep + ixp], axis=-1)
    return HorizWeights(ix=ix, jy=jy, idx4=idx4, p4=p4)


def vert_weights(z, height):
    """Bracketing z-levels and weights (interpol_all.f90:118-126)."""
    nz = height.shape[0]
    indz = jnp.clip(jnp.searchsorted(height, z, side="right") - 1, 0, nz - 2)
    h0 = height[indz]
    h1 = height[indz + 1]
    dz1 = jnp.clip((z - h0) / (h1 - h0), 0.0, 1.0)  # weight of upper level
    return indz, dz1


def gather_corners_3d(f3d, field_ids, hw: HorizWeights, indz):
    """Gather corner values of selected 3-D fields at levels (indz, indz+1).

    f3d: (NF3, nz, ny, nx); returns (F, 2, N, 4): per field, per level,
    per particle, per corner."""
    nf, nz, ny, nx = f3d.shape
    flat = f3d.reshape(nf, nz, ny * nx)[jnp.asarray(field_ids)]
    lin0 = indz[:, None] * (ny * nx) + hw.idx4          # (N,4)
    lin1 = (indz + 1)[:, None] * (ny * nx) + hw.idx4
    lin = jnp.stack([lin0, lin1], axis=0)               # (2,N,4)
    out = flat.reshape(len(field_ids), nz * ny * nx)[:, lin]  # (F,2,N,4)
    return out


def gather_corners_2d(f2d, field_ids, hw: HorizWeights):
    """(F2, ny, nx) -> (F, N, 4) corner values."""
    nf, ny, nx = f2d.shape
    flat = f2d.reshape(nf, ny * nx)[jnp.asarray(field_ids)]
    return flat[:, hw.idx4]


def gather_corners_2d_ln(f2d, field_ids, hw: HorizWeights):
    """(F2, ny, nx) -> (F, 4, N) corner values, corner dim LEADING.

    Layout: the particle axis stays LAST (minor) and the corner axis of
    4 leads, so the per-corner weighted sums reduce over a major axis
    and every consumer works on long particle-axis vectors."""
    nf, ny, nx = f2d.shape
    flat = f2d.reshape(nf, ny * nx)[jnp.asarray(field_ids)]
    return flat[:, hw.idx4.T]


def interp_2d(f2d, field_ids, hw: HorizWeights):
    """Bilinear 2-D interpolation: (F, N)."""
    vals = gather_corners_2d_ln(f2d, field_ids, hw)       # (F,4,N)
    return jnp.sum(vals * hw.p4.T[None], axis=1)


class WindInterp(NamedTuple):
    """Everything the advance kernel needs at the particle position."""
    u: jnp.ndarray
    v: jnp.ndarray
    w: jnp.ndarray
    rho: jnp.ndarray
    drhodz: jnp.ndarray
    usig: jnp.ndarray   # profile-averaged wind stddevs (mesoscale driver)
    vsig: jnp.ndarray
    wsig: jnp.ndarray


_WIND_FIELDS = (F3_U, F3_V, F3_W, F3_RHO, F3_DRHODZ)


def interp_wind(z0: ZFields, z1: ZFields, hw: HorizWeights, indz, dz1,
                tw0, tw1) -> WindInterp:
    """u,v,w,rho,drhodz + wind sigmas at particle positions.

    tw0/tw1: scalar time weights (dt2*dtt, dt1*dtt in the reference).
    Sigma uses the PBL convention (per level over 4 corners x 2 times,
    interpol_all.f90:216-240, then 0.5*(level+level'), advance.f90:603-606);
    the reference's above-PBL 16-sample variant differs only ~1/16 in
    normalization and is treated identically here."""
    c0 = gather_corners_3d(z0.f3d, _WIND_FIELDS, hw, indz)  # (5,2,N,4)
    c1 = gather_corners_3d(z1.f3d, _WIND_FIELDS, hw, indz)

    # horizontal + time interpolation per level: (5,2,N)
    # f32 HIGHEST: a default-precision dot may run in TF32 on Hopper
    lev = (jnp.einsum("flnc,nc->fln", c0, hw.p4, precision=_HIGHEST) * tw0
           + jnp.einsum("flnc,nc->fln", c1, hw.p4, precision=_HIGHEST)
           * tw1)
    # vertical: (5,N)
    val = lev[:, 0] * (1.0 - dz1) + lev[:, 1] * dz1

    # wind stddev over the 8 samples per level (4 corners x 2 times)
    uvw0 = c0[:3]
    uvw1 = c1[:3]
    sl = jnp.sum(uvw0, axis=-1) + jnp.sum(uvw1, axis=-1)         # (3,2,N)
    sq = jnp.sum(uvw0 ** 2, axis=-1) + jnp.sum(uvw1 ** 2, axis=-1)
    var = sq - sl * sl / 8.0
    sig_lev = jnp.where(var < 1.0e-30, 0.0, jnp.sqrt(jnp.maximum(var, 0.0) / 7.0))
    sig = 0.5 * (sig_lev[:, 0] + sig_lev[:, 1])                  # (3,N)

    return WindInterp(u=val[0], v=val[1], w=val[2], rho=val[3],
                      drhodz=val[4], usig=sig[0], vsig=sig[1], wsig=sig[2])


def interp_wind_legacy(z0: ZFields, z1: ZFields, hw: HorizWeights, indz, dz1,
                       tw0, tw1):
    """Reference-exact interpolation for matched-RNG validation: winds
    from per-time-level bilinear + temporal blend (interpol_all.f90),
    with BOTH wind-sigma conventions returned — the PBL per-level
    8-sample form (interpol_all.f90:216-240, averaged over the two
    levels like advance.f90:603-606) and the above-PBL 16-sample form
    (interpol_wind.f90:194-213).  Returns (WindInterp-with-8-sample-sig,
    (usig16, vsig16, wsig16))."""
    c0 = gather_corners_3d(z0.f3d, _WIND_FIELDS, hw, indz)  # (5,2,N,4)
    c1 = gather_corners_3d(z1.f3d, _WIND_FIELDS, hw, indz)
    # f32 HIGHEST: a default-precision dot may run in TF32 on Hopper
    lev = (jnp.einsum("flnc,nc->fln", c0, hw.p4, precision=_HIGHEST) * tw0
           + jnp.einsum("flnc,nc->fln", c1, hw.p4, precision=_HIGHEST)
           * tw1)
    val = lev[:, 0] * (1.0 - dz1) + lev[:, 1] * dz1

    uvw0, uvw1 = c0[:3], c1[:3]
    sl = jnp.sum(uvw0, axis=-1) + jnp.sum(uvw1, axis=-1)     # (3,2,N)
    sq = jnp.sum(uvw0 ** 2, axis=-1) + jnp.sum(uvw1 ** 2, axis=-1)
    var = sq - sl * sl / 8.0
    sig_lev = jnp.where(var < 1.0e-30, 0.0,
                        jnp.sqrt(jnp.maximum(var, 0.0) / 7.0))
    sig8 = 0.5 * (sig_lev[:, 0] + sig_lev[:, 1])             # (3,N)

    sl16 = jnp.sum(sl, axis=1)                               # (3,N)
    sq16 = jnp.sum(sq, axis=1)
    var16 = sq16 - sl16 * sl16 / 16.0
    sig16 = jnp.where(var16 < 1.0e-30, 0.0,
                      jnp.sqrt(jnp.maximum(var16, 0.0) / 15.0))

    wind = WindInterp(u=val[0], v=val[1], w=val[2], rho=val[3],
                      drhodz=val[4], usig=sig8[0], vsig=sig8[1],
                      wsig=sig8[2])
    return wind, (sig16[0], sig16[1], sig16[2])


def interp_wind_short(z0: ZFields, z1: ZFields, hw: HorizWeights, indz, dz1,
                      tw0, tw1):
    """Wind only, for the Petterssen corrector (interpol_wind_short.f90)."""
    fields = (F3_U, F3_V, F3_W)
    c0 = gather_corners_3d(z0.f3d, fields, hw, indz)
    c1 = gather_corners_3d(z1.f3d, fields, hw, indz)
    # f32 HIGHEST: a default-precision dot may run in TF32 on Hopper
    lev = (jnp.einsum("flnc,nc->fln", c0, hw.p4, precision=_HIGHEST) * tw0
           + jnp.einsum("flnc,nc->fln", c1, hw.p4, precision=_HIGHEST)
           * tw1)
    val = lev[:, 0] * (1.0 - dz1) + lev[:, 1] * dz1
    return val[0], val[1], val[2]


def blend_wind_stack(z0: ZFields, z1: ZFields, tw0, tw1):
    """Pre-interpolate the hot 3-D fields to the current time ON THE
    GRID: spatial and temporal interpolation are both linear so they
    commute, and the per-particle gather volume halves (one time level
    instead of two).  Cost is one fused elementwise pass over the grid —
    negligible next to millions of random gathers."""
    idx = jnp.asarray(_WIND_FIELDS)
    return z0.f3d[idx] * tw0 + z1.f3d[idx] * tw1         # (5, nz, ny, nx)


class StepTables(NamedTuple):
    """Per-step grid tables, built ONCE per sync interval and shared by
    every particle chunk: the 2-D sampling pattern — hmix 8 corners x 2
    times + tropopause 4 + ustar/wstar/oli 12 — becomes one packed-row
    gather instead of separate gathers."""
    f3dt: jnp.ndarray    # (5, nz, ny, nx) time-blended u,v,w,rho,drhodz
    f3de: jnp.ndarray    # (3, nz, ny, nx) endtime-blended u,v,w (Petterssen)
    pack2: jnp.ndarray   # (8, ny, nx): [max-time hmix, tropo(t0),
    #                      ustar_t, wstar_t, oli_t, 0, 0, 0]


def build_step_tables(z0: ZFields, z1: ZFields, tw0, tw1, ew0, ew1,
                      dtype=jnp.float32) -> StepTables:
    """One fused elementwise pass over the grid per step (cheap next to
    the per-particle gathers it feeds).  hmix takes the max over the two
    time levels here so the per-particle reduction is only over the 4
    corners (max commutes; advance.f90:236-252).

    dtype=bfloat16 halves the random-gather traffic of the two 3-D
    stacks; values are widened back to f32 right after the gather, so only the stored wind/density values
    carry the 8-bit-mantissa rounding (~0.4% — far below the turbulent
    velocity scale the integrator adds on top)."""
    from ..met.fields import F2_HMIX, F2_OLI, F2_TROPO, F2_USTAR, F2_WSTAR
    f3dt = blend_wind_stack(z0, z1, tw0, tw1).astype(dtype)
    idx3 = jnp.asarray((F3_U, F3_V, F3_W))
    f3de = (z0.f3d[idx3] * ew0 + z1.f3d[idx3] * ew1).astype(dtype)
    sidx = jnp.asarray((F2_USTAR, F2_WSTAR, F2_OLI))
    f2dt = z0.f2d[sidx] * tw0 + z1.f2d[sidx] * tw1
    pack2 = jnp.concatenate([
        jnp.maximum(z0.f2d[F2_HMIX], z1.f2d[F2_HMIX])[None],
        z0.f2d[F2_TROPO][None],
        f2dt,
        jnp.zeros((3,) + z0.f2d.shape[1:], z0.f2d.dtype),
    ], axis=0)
    return StepTables(f3dt=f3dt, f3de=f3de, pack2=pack2)


def sample_2d_packed(pack2, hw: HorizWeights, x, y):
    """All 2-D met quantities from ONE 4-index strided gather of the
    packed table: (h, tropop, ust, wst, ol)."""
    ny, nx = pack2.shape[1:]
    g = pack2.reshape(8, ny * nx)[:, hw.idx4.T]        # (8, 4, N)
    h = jnp.maximum(jnp.max(g[0], axis=0), 1.0)
    # tropopause: nearest corner of the first time level
    # (advance.f90:252 `tropopause(nix,njy,1,1)`)
    ix_n = (x - hw.ix) >= 0.5
    iy_n = (y - hw.jy) >= 0.5
    trop_c = g[1]
    tropop = jnp.where(iy_n, jnp.where(ix_n, trop_c[3], trop_c[2]),
                       jnp.where(ix_n, trop_c[1], trop_c[0]))
    p4t = hw.p4.T                                      # (4, N)
    ust = jnp.sum(g[2] * p4t, axis=0)
    wst = jnp.sum(g[3] * p4t, axis=0)
    oliaux = jnp.sum(g[4] * p4t, axis=0)
    ol = jnp.where(oliaux != 0.0, 1.0 / oliaux, 99999.0)
    return h, tropop, ust, wst, ol


def gather_corners_3d_ln(f3d, field_ids, hw: HorizWeights, indz):
    """Lanes-first corner gather: (F, 2, 4, N) — see gather_corners_2d_ln
    for the layout rationale."""
    nf, nz, ny, nx = f3d.shape
    flat = f3d.reshape(nf, nz * ny * nx)[jnp.asarray(field_ids)]
    lin0 = indz[None] * (ny * nx) + hw.idx4.T            # (4,N)
    lin = jnp.stack([lin0, lin0 + ny * nx], axis=0)      # (2,4,N)
    return flat[:, lin]                                  # (F,2,4,N)


def interp_wind_blended(f3dt, hw: HorizWeights, indz, dz1) -> WindInterp:
    """interp_wind on a pre-time-blended stack.  The mesoscale wind
    stddev uses the 4 corner samples per level of the blended field
    (variance/3) instead of the reference's 4x2-time samples — the
    spatial part dominates and temporal smoothing only slightly lowers
    the heuristic mesoscale amplitude (turbmesoscale=0.16 scaling)."""
    c = gather_corners_3d_ln(f3dt, (0, 1, 2, 3, 4), hw, indz)  # (5,2,4,N)
    c = c.astype(jnp.float32)          # widen right after the gather
    p4t = hw.p4.T                                              # (4,N)
    lev = jnp.sum(c * p4t[None, None], axis=2)                 # (5,2,N)
    val = lev[:, 0] * (1.0 - dz1) + lev[:, 1] * dz1
    uvw = c[:3]
    sl = jnp.sum(uvw, axis=2)                                  # (3,2,N)
    sq = jnp.sum(uvw * uvw, axis=2)
    var = sq - sl * sl / 4.0
    sig_lev = jnp.where(var < 1.0e-30, 0.0,
                        jnp.sqrt(jnp.maximum(var, 0.0) / 3.0))
    sig = 0.5 * (sig_lev[:, 0] + sig_lev[:, 1])
    return WindInterp(u=val[0], v=val[1], w=val[2], rho=val[3],
                      drhodz=val[4], usig=sig[0], vsig=sig[1],
                      wsig=sig[2])


def interp_wind_short_blended(f3dt, hw: HorizWeights, indz, dz1):
    """Petterssen-corrector wind from a pre-blended (end-time) stack."""
    c = gather_corners_3d_ln(f3dt, (0, 1, 2), hw, indz)        # (3,2,4,N)
    c = c.astype(jnp.float32)
    lev = jnp.sum(c * hw.p4.T[None, None], axis=2)
    val = lev[:, 0] * (1.0 - dz1) + lev[:, 1] * dz1
    return val[0], val[1], val[2]


class StepTablesPaired(NamedTuple):
    """Per-step grid tables in LEVEL-PAIRED layout: row r = (k, y, x)
    carries every field at levels k AND k+1 stacked along the slice
    (field) axis, so one gather instruction with FOUR indices per
    particle (the horizontal corners) fetches the full interpolation
    stencil: half the index count of the (level, corner) form."""
    packA: jnp.ndarray   # (15, nz-1, ny, nx): u,v,w,rho,drhodz at
    #                      (k, k+1) interleaved [f*2+level] + hmix-max,
    #                      tropo(t0), ustar_t, wstar_t, oli_t
    packE: jnp.ndarray   # (6, nz-1, ny, nx): endtime u,v,w at (k, k+1)


def build_step_tables_paired(z0: ZFields, z1: ZFields, tw0, tw1, ew0, ew1,
                             dtype=jnp.float32) -> StepTablesPaired:
    """One fused pass over the grid per sync interval (shared by all
    particle chunks).  hmix takes the max over both time levels here
    (advance.f90:236-252); the 2-D rows are broadcast down the k axis
    so they ride the same 4-index gather."""
    from ..met.fields import F2_HMIX, F2_OLI, F2_TROPO, F2_USTAR, F2_WSTAR
    f3dt = blend_wind_stack(z0, z1, tw0, tw1)            # (5, nz, ny, nx)
    nz, ny, nx = f3dt.shape[1:]
    pairA = jnp.stack([f3dt[:, :-1], f3dt[:, 1:]],
                      axis=1).reshape(10, nz - 1, ny, nx)
    sidx = jnp.asarray((F2_USTAR, F2_WSTAR, F2_OLI))
    f2dt = z0.f2d[sidx] * tw0 + z1.f2d[sidx] * tw1
    pack2d = jnp.concatenate([
        jnp.maximum(z0.f2d[F2_HMIX], z1.f2d[F2_HMIX])[None],
        z0.f2d[F2_TROPO][None],
        f2dt,
    ], axis=0)                                           # (5, ny, nx)
    pack2b = jnp.broadcast_to(pack2d[:, None],
                              (5, nz - 1, ny, nx))
    packA = jnp.concatenate([pairA, pack2b], axis=0).astype(dtype)
    idx3 = jnp.asarray((F3_U, F3_V, F3_W))
    e3 = z0.f3d[idx3] * ew0 + z1.f3d[idx3] * ew1
    packE = jnp.stack([e3[:, :-1], e3[:, 1:]],
                      axis=1).reshape(6, nz - 1, ny, nx).astype(dtype)
    return StepTablesPaired(packA=packA, packE=packE)


def sample_all_paired(tables: StepTablesPaired, hw: HorizWeights,
                      indz, dz1, x, y):
    """Everything the PBL/FT integrator needs at the particle position
    from ONE 4-index gather of the paired table: returns
    (h, tropop, ust, wst, ol, WindInterp) — the fused
    interpol_all/interpol_wind + 2-D family."""
    nzp, ny, nx = tables.packA.shape[1:]
    flat = tables.packA.reshape(15, nzp * ny * nx)
    lin = indz[None] * (ny * nx) + hw.idx4.T             # (4, N)
    g = flat[:, lin].astype(jnp.float32)                 # (15, 4, N)
    return _reduce_stencil15(g, hw, dz1, x, y)


class StepTablesQuad(NamedTuple):
    """Per-step grid tables in QUAD-CORNER ROW layout: row r = (k, y, x)
    carries every stencil quantity at ALL FOUR horizontal corners of
    cell (y, x) and BOTH bracketing levels (k, k+1), packed into the
    lane (minor) dimension.  One gather with ONE index per particle
    fetches the complete interpolation stencil as a 256-byte (f32) or
    128-byte (bf16) contiguous row, instead of 4-index column gathers.
    The 4x row duplication costs device memory (~0.5 GB on the REF1
    grid) and one fused build pass per sync step.

    Lane order of `rows`: lane = q*4 + c, q in 0..14 over
    (u0,u1,v0,v1,w0,w1,rho0,rho1,drho0,drho1, hmix-max, tropo(t0),
    ustar_t, wstar_t, oli_t), c over corners (y,x),(y,x+1),(y+1,x),
    (y+1,x+1); lanes 60-62 carry the PRECOMPUTED per-cell mesoscale
    wind sigmas (usig, vsig, wsig) in the reference's 8-sample
    convention — std over 4 corners x 2 TIME LEVELS per level
    (interpol_all.f90:216-240), averaged over the bracketing pair
    (advance.f90:601-605).  Sigma is a per-CELL quantity (identical
    for every particle in the cell at a given level pair), so the
    grid-level precompute is exact, rides the same single-index
    gather in the otherwise-padding lanes, and REMOVES the
    per-particle variance math from the hot reduction.  It also avoids
    the blended-estimator bias: the 4-corner variance of the
    time-blended field lost the temporal spread component and
    undershot the reference sigma by up to ~2.4x on time-evolving
    fields (measured, tests/test_quad_equiv.py).  Lane 63 pads.
    `rowsE`: endtime u,v,w pairs, lane = q*4 + c, q in 0..5, lanes
    24-63 pad."""
    rows: jnp.ndarray    # (R, 64), R = (nz-1)*ny*nx
    rowsE: jnp.ndarray   # (R, 64), lanes 24-63 pad (see _rows_from_quads)


def _corner_stack(a):
    """(Q, nzp, ny, nx) -> (Q, 4, nzp, ny, nx): values at the 4 corners
    of each cell.  x+1 via cyclic roll (for global grids the wrap column
    duplicates column 0 anyway; for limited-area/tile grids the last
    column's rows are never gathered because horiz_weights clips
    ix <= nx-2).  y+1 clamps at the last row (same never-gathered
    argument for jy = ny-1)."""
    ax = jnp.roll(a, -1, axis=-1)
    ay = jnp.concatenate([a[..., 1:, :], a[..., -1:, :]], axis=-2)
    axy = jnp.roll(ay, -1, axis=-1)
    return jnp.stack([a, ax, ay, axy], axis=1)


def _rows_from_quads(q):
    """(Q, 4, nzp, ny, nx) -> (nzp*ny*nx, Q*4 padded to a multiple of
    64) with lane = q*4 + c.

    The 64-lane width (`rowsE` holds 24 useful lanes) was chosen for
    another backend's gather result layout; whether it pays on the GPU
    is an open layout question."""
    Q = q.shape[0]
    nzp, ny, nx = q.shape[2:]
    r = q.reshape(Q * 4, nzp * ny * nx).T                # (R, Q*4)
    pad = (-(Q * 4)) % 64
    if pad:
        r = jnp.pad(r, ((0, 0), (0, pad)))
    return r


def _cell_sigma8(z0: ZFields, z1: ZFields):
    """Per-cell mesoscale wind sigmas in the reference convention:
    per level, std over the cell's 4 corners x 2 time levels
    (interpol_all.f90:216-240, var/7), then averaged over the
    bracketing level pair (advance.f90:601-605).  Returns
    (3, nz-1, ny, nx) for u,v,w."""
    idx3 = jnp.asarray((F3_U, F3_V, F3_W))
    u0 = _corner_stack(z0.f3d[idx3])                     # (3,4,nz,ny,nx)
    u1 = _corner_stack(z1.f3d[idx3])
    sl = jnp.sum(u0, axis=1) + jnp.sum(u1, axis=1)       # (3,nz,ny,nx)
    sq = jnp.sum(u0 * u0, axis=1) + jnp.sum(u1 * u1, axis=1)
    var = sq - sl * sl / 8.0
    sig = jnp.where(var < 1.0e-30, 0.0,
                    jnp.sqrt(jnp.maximum(var, 0.0) / 7.0))
    return 0.5 * (sig[:, :-1] + sig[:, 1:])              # (3,nz-1,ny,nx)


def _corners4(a):
    """One field at the cell's 4 corners (same roll/clamp semantics as
    _corner_stack, per-field)."""
    ax = jnp.roll(a, -1, axis=-1)
    ay = jnp.concatenate([a[..., 1:, :], a[..., -1:, :]], axis=-2)
    axy = jnp.roll(ay, -1, axis=-1)
    return (a, ax, ay, axy)


def build_step_tables_quad(z0: ZFields, z1: ZFields, tw0, tw1, ew0, ew1,
                           dtype=jnp.float32) -> StepTablesQuad:
    """One fused pass over the grid per sync interval, shared by every
    particle chunk.  hmix takes the max over the two time levels here
    (advance.f90:236-252); 2-D rows are broadcast down the k axis so
    they ride the same single-index gather.

    The rows are built LANES-LAST (stack the 64 per-lane grid arrays
    along a new minor axis) instead of lanes-first + transpose: the
    round-4 form materialized a (64, R) array and paid an explicit
    (R, 64) relayout copy per step (~tens of ms at REF1 scale in the
    op profile); stacking into the final layout lets XLA fuse the
    corner rolls straight into the output pass.  Output is bitwise
    identical."""
    from ..met.fields import F2_HMIX, F2_OLI, F2_TROPO, F2_USTAR, F2_WSTAR
    f3dt = blend_wind_stack(z0, z1, tw0, tw1)            # (5, nz, ny, nx)
    nz, ny, nx = f3dt.shape[1:]
    pairA = jnp.stack([f3dt[:, :-1], f3dt[:, 1:]],
                      axis=1).reshape(10, nz - 1, ny, nx)
    sidx = jnp.asarray((F2_USTAR, F2_WSTAR, F2_OLI))
    f2dt = z0.f2d[sidx] * tw0 + z1.f2d[sidx] * tw1
    pack2d = jnp.concatenate([
        jnp.maximum(z0.f2d[F2_HMIX], z1.f2d[F2_HMIX])[None],
        z0.f2d[F2_TROPO][None],
        f2dt,
    ], axis=0)                                           # (5, ny, nx)
    pack2b = jnp.broadcast_to(pack2d[:, None], (5, nz - 1, ny, nx))
    a15 = jnp.concatenate([pairA, pack2b], axis=0)       # (15, nzp, ny, nx)
    sig3 = _cell_sigma8(z0, z1)                          # (3,nzp,ny,nx)
    lanes = []
    for q in range(15):
        lanes.extend(_corners4(a15[q]))
    # lanes 60-62: per-cell sigmas; lane 63 pad
    lanes.extend([sig3[0], sig3[1], sig3[2], jnp.zeros_like(sig3[0])])
    rows = jnp.stack(lanes, axis=-1).astype(dtype).reshape(-1, 64)
    idx3 = jnp.asarray((F3_U, F3_V, F3_W))
    e3 = z0.f3d[idx3] * ew0 + z1.f3d[idx3] * ew1
    pairE = jnp.stack([e3[:, :-1], e3[:, 1:]],
                      axis=1).reshape(6, nz - 1, ny, nx)
    lanesE = []
    for q in range(6):
        lanesE.extend(_corners4(pairE[q]))
    lanesE.extend([jnp.zeros_like(pairE[0])] * 40)       # lanes 24-63 pad
    rowsE = jnp.stack(lanesE, axis=-1).astype(dtype).reshape(-1, 64)
    return StepTablesQuad(rows=rows, rowsE=rowsE)


def _cell_rowid(hw: HorizWeights, indz, nx: int, ny: int):
    """Linear row id of the particle's cell in a (nzp, ny, nx) table."""
    return indz * (ny * nx) + hw.jy * nx + hw.ix


def _reduce_stencil15(g, hw: HorizWeights, dz1, x, y, sig=None):
    """Shared reduction of the (15, 4, N) gathered stencil (quad or
    paired layout) to the interp_all/interp_wind quantities.

    sig: optional (3, N) precomputed per-cell wind sigmas (quad table
    lanes 60-62, reference 8-sample convention).  Without it (paired
    layout) the sigmas fall back to the per-level 4-corner variance of
    the time-blended stack — a biased estimator that loses the
    temporal spread (kept only for the legacy paired path)."""
    p4t = hw.p4.T                                        # (4, N)
    low = g[0:10:2]                                      # (5, 4, N) @ k
    high = g[1:10:2]                                     # (5, 4, N) @ k+1
    lev0 = jnp.sum(low * p4t, axis=1)                    # (5, N)
    lev1 = jnp.sum(high * p4t, axis=1)
    val = lev0 * (1.0 - dz1) + lev1 * dz1
    if sig is None:
        # blended-stack fallback (paired layout only)
        uvw = jnp.stack([low[:3], high[:3]], axis=1)     # (3, 2, 4, N)
        sl = jnp.sum(uvw, axis=2)
        sq = jnp.sum(uvw * uvw, axis=2)
        var = sq - sl * sl / 4.0
        sig_lev = jnp.where(var < 1.0e-30, 0.0,
                            jnp.sqrt(jnp.maximum(var, 0.0) / 3.0))
        sig = 0.5 * (sig_lev[:, 0] + sig_lev[:, 1])
    wind = WindInterp(u=val[0], v=val[1], w=val[2], rho=val[3],
                      drhodz=val[4], usig=sig[0], vsig=sig[1],
                      wsig=sig[2])
    h = jnp.maximum(jnp.max(g[10], axis=0), 1.0)
    ix_n = (x - hw.ix) >= 0.5
    iy_n = (y - hw.jy) >= 0.5
    trop_c = g[11]
    tropop = jnp.where(iy_n, jnp.where(ix_n, trop_c[3], trop_c[2]),
                       jnp.where(ix_n, trop_c[1], trop_c[0]))
    ust = jnp.sum(g[12] * p4t, axis=0)
    wst = jnp.sum(g[13] * p4t, axis=0)
    oliaux = jnp.sum(g[14] * p4t, axis=0)
    ol = jnp.where(oliaux != 0.0, 1.0 / oliaux, 99999.0)
    return h, tropop, ust, wst, ol, wind


def sample_all_quad(tables: StepTablesQuad, hw: HorizWeights,
                    indz, dz1, x, y, nx: int, ny: int):
    """Everything the PBL/FT integrator needs at the particle position
    from ONE single-index row gather of the quad-corner table: returns
    (h, tropop, ust, wst, ol, WindInterp) — the fused
    interpol_all/interpol_wind + 2-D family."""
    lin = _cell_rowid(hw, indz, nx, ny)                  # (N,)
    g = tables.rows[lin].T.astype(jnp.float32)           # (64, N)
    sig = g[60:63]                                       # (3, N) per-cell
    g = g[:60].reshape(15, 4, -1)
    return _reduce_stencil15(g, hw, dz1, x, y, sig=sig)


def wind10_quad(rows, hw: HorizWeights, indz, dz1, nx: int, ny: int):
    """u,v,w,rho,drhodz only, from the quad table (the adaptive loop's
    per-pass vertical re-interpolation at frozen horizontal stencil)."""
    lin = _cell_rowid(hw, indz, nx, ny)
    g = rows[lin].T.astype(jnp.float32)                  # (64, N)
    g = g[:40].reshape(10, 4, -1)
    p4t = hw.p4.T
    lev0 = jnp.sum(g[0:10:2] * p4t, axis=1)
    lev1 = jnp.sum(g[1:10:2] * p4t, axis=1)
    val = lev0 * (1.0 - dz1) + lev1 * dz1
    return val[0], val[1], val[2], val[3], val[4]


def interp_wind_short_quad(rowsE, hw: HorizWeights, indz, dz1,
                           nx: int, ny: int):
    """Petterssen-corrector wind: one single-index row gather of the
    endtime quad-corner table (interpol_wind_short.f90)."""
    lin = _cell_rowid(hw, indz, nx, ny)
    g = rowsE[lin].T.astype(jnp.float32)                 # (64, N)
    g = g[:24].reshape(6, 4, -1)
    p4t = hw.p4.T
    lev0 = jnp.sum(g[0:6:2] * p4t, axis=1)               # (3, N)
    lev1 = jnp.sum(g[1:6:2] * p4t, axis=1)
    val = lev0 * (1.0 - dz1) + lev1 * dz1
    return val[0], val[1], val[2]


def interp_wind_short_paired(packE, hw: HorizWeights, indz, dz1):
    """Petterssen-corrector wind: one 4-index gather of the endtime
    level-paired stack (interpol_wind_short.f90)."""
    nzp, ny, nx = packE.shape[1:]
    flat = packE.reshape(6, nzp * ny * nx)
    lin = indz[None] * (ny * nx) + hw.idx4.T
    g = flat[:, lin].astype(jnp.float32)                 # (6, 4, N)
    p4t = hw.p4.T
    lev0 = jnp.sum(g[0:6:2] * p4t, axis=1)               # (3, N)
    lev1 = jnp.sum(g[1:6:2] * p4t, axis=1)
    val = lev0 * (1.0 - dz1) + lev1 * dz1
    return val[0], val[1], val[2]


def hmix_max(z0: ZFields, z1: ZFields, hw: HorizWeights, f2_hmix: int):
    """Max mixing height over the 4 surrounding points and both time levels
    (advance.f90:236-252)."""
    h0 = gather_corners_2d_ln(z0.f2d, (f2_hmix,), hw)[0]   # (4,N)
    h1 = gather_corners_2d_ln(z1.f2d, (f2_hmix,), hw)[0]
    return jnp.maximum(jnp.max(h0, axis=0), jnp.max(h1, axis=0))
