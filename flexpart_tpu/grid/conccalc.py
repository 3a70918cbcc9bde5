"""Concentration sampling: scatter-add of particle mass onto the output grid.

Vectorized re-design of /root/reference/src/conccalc.f90: for every live
particle, the output cell (or 4-cell uniform kernel for particles older
than 3 h and away from boundaries, conccalc.f90:171-260) is computed
branch-free and the (mass / rho for mixing-ratio units) contributions are
scatter-added into the 7-D accumulator with one fused `.at[].add`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..met.fields import ZFields, F3_RHO
from ..core.state import Particles
from ..core.interp import horiz_weights, vert_weights
from .outgrid import Accumulators


class ConcConfig(NamedTuple):
    nxg: int
    nyg: int
    nzg: int
    npointspec: int
    nclassunc: int
    nage: int
    dxout: float
    dyout: float
    xoutshift: float     # met-grid lon0 - outgrid lon0 [deg]
    youtshift: float
    dx_met: float
    dy_met: float
    ind_samp: int        # 0: mass, -1: divide by air density
    use_kernel: bool = True
    ioutputforeachrelease: bool = True
    particle_count_output: bool = False
    bkdep: bool = False  # WET/DRYBKDEP: weight by max(xscav,0)
    #                      (conccalc.f90:181,230)
    kernel_possible: bool = True
    #: False when the caller can prove (host-side) that NO live particle
    #: can be >= 3 h old, so the uniform kernel never triggers and one
    #: scatter index per particle suffices — see kernel_possible_at().


def kernel_possible_at(itime, first_release_time,
                       use_kernel: bool = True) -> bool:
    """Host-side: can ANY particle be >= 3 h old at itime?  Particle age
    is |itra - itramem| and itramem is the release time, so the oldest
    possible age is the elapsed time since the first release — pure host
    arithmetic on the schedule (conccalc.f90:171 `itage > 10800` gate).
    While this is False the sampler compiles the direct-only single-index
    scatter; crossing 3 h triggers exactly one recompile."""
    if not use_kernel:
        return False
    if first_release_time is None:
        return True
    return abs(int(itime) - int(first_release_time)) >= 10800


def make_conccalc(outheights):
    """Bind the static output level heights, return a jitted sampler:
    (acc, particles, zfields, itime, lage, weight, cfg) -> acc."""
    oh = jnp.asarray(np.asarray(outheights, np.float32))

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def _run(acc: Accumulators, p: Particles, zf: ZFields,
             itime, lage, weight, cfg: ConcConfig) -> Accumulators:
        return _conccalc_impl(acc, p, zf, itime, lage, weight, cfg, oh)

    return _run


def _conccalc_impl(acc, p, zf, itime, lage, weight, cfg: ConcConfig,
                   outheight, origin=None):
    """origin: (x0, y0) offset of this device's met tile in mother-grid
    units (tiled mode) — only the ind_samp=-1 density gather is
    tile-local; the output-grid mapping always uses global positions."""
    n = p.capacity
    live = p.active & (p.itra == itime)
    x, y, z = p.x, p.y, p.z
    itage = jnp.abs(p.itra - p.itramem)
    # age class of the particle (conccalc.f90:54-59)
    nage_idx = jnp.clip(jnp.searchsorted(lage, itage, side="right"),
                        0, cfg.nage - 1)

    # air density at the particle for mixing-ratio output
    # (conccalc.f90:80-125; newer wind field only, no time interpolation)
    if cfg.ind_samp == -1:
        nx_m, ny_m = zf.f3d.shape[3], zf.f3d.shape[2]
        xm = x - origin[0] if origin is not None else x
        ym = y - origin[1] if origin is not None else y
        hw = horiz_weights(xm, ym, nx_m, ny_m, False)
        indz, dz1 = vert_weights(z, zf.height)
        rho_flat = zf.f3d[F3_RHO].reshape(-1)
        lin0 = indz[:, None] * (ny_m * nx_m) + hw.idx4
        # f32 HIGHEST: a default-precision dot may run in TF32 on Hopper
        hi = jax.lax.Precision.HIGHEST
        rho_lo = jnp.einsum("nc,nc->n", rho_flat[lin0], hw.p4, precision=hi)
        rho_hi = jnp.einsum("nc,nc->n", rho_flat[lin0 + ny_m * nx_m], hw.p4,
                            precision=hi)
        rhoi = rho_lo * (1.0 - dz1) + rho_hi * dz1
    else:
        rhoi = jnp.ones_like(z)

    # vertical output layer: first outheight above z (conccalc.f90:146-149)
    kz = jnp.searchsorted(outheight, z, side="right")
    in_z = kz < cfg.nzg
    kz = jnp.minimum(kz, cfg.nzg - 1)

    # output-grid coordinates (conccalc.f90:156-161)
    xl = (x * cfg.dx_met + cfg.xoutshift) / cfg.dxout
    yl = (y * cfg.dy_met + cfg.youtshift) / cfg.dyout
    ix = jnp.floor(xl).astype(jnp.int32)
    jy = jnp.floor(yl).astype(jnp.int32)

    # direct attribution for young / near-boundary particles
    # (conccalc.f90:171-178)
    near_edge = ((xl < 0.5) | (yl < 0.5)
                 | (xl > cfg.nxg - 1 - 0.5) | (yl > cfg.nyg - 1 - 0.5))
    direct = (not cfg.use_kernel) | (itage < 10800) | near_edge

    kp = p.npoint if cfg.ioutputforeachrelease else jnp.zeros_like(p.npoint)
    cell = (((nage_idx * cfg.nclassunc + p.nclass) * cfg.npointspec + kp)
            * cfg.nzg + kz)

    if not cfg.kernel_possible:
        # ---- direct-only fast path: ONE scatter index per particle ----
        # The caller asserts (host-side, from itime and the earliest
        # release start) that no live particle can be >= 3 h old, so the
        # uniform kernel can never trigger (conccalc.f90:171-178), and
        # the young-plume phase scatters one index per particle instead
        # of the kernel's four.
        in_grid = (ix >= 0) & (ix < cfg.nxg) & (jy >= 0) & (jy < cfg.nyg)
        valid = live & in_z & in_grid
        lin = cell * (cfg.nyg * cfg.nxg) + jy * cfg.nxg + ix
        lin = jnp.where(valid, lin, 2 ** 30)
        if cfg.particle_count_output:
            contrib = jnp.ones((n, p.nspec), jnp.float32)
        else:
            contrib = p.mass / rhoi[:, None]
            if cfg.bkdep:
                contrib = contrib * jnp.maximum(p.xscav, 0.0)
        contrib = jnp.where(valid[:, None], contrib * weight, 0.0)
        flat = acc.gridunc.reshape(-1, p.nspec)
        flat = flat.at[lin].add(contrib, mode="drop")
        return acc._replace(gridunc=flat.reshape(acc.gridunc.shape),
                            outnum=acc.outnum + weight)

    # uniform-kernel weights (conccalc.f90:203-220)
    ddx = xl - ix
    ddy = yl - jy
    ixp = jnp.where(ddx > 0.5, ix + 1, ix - 1)
    jyp = jnp.where(ddy > 0.5, jy + 1, jy - 1)
    wx = jnp.where(ddx > 0.5, 1.5 - ddx, 0.5 + ddx)
    wy = jnp.where(ddy > 0.5, 1.5 - ddy, 0.5 + ddy)

    cx = jnp.stack([ix, ix, ixp, ixp], axis=-1)          # (N,4)
    cy = jnp.stack([jy, jyp, jy, jyp], axis=-1)
    w4 = jnp.stack([wx * wy, wx * (1 - wy), (1 - wx) * wy,
                    (1 - wx) * (1 - wy)], axis=-1)
    w4 = jnp.where(direct[:, None],
                   jnp.concatenate([jnp.ones((n, 1)), jnp.zeros((n, 3))], 1),
                   w4)

    in_grid = (cx >= 0) & (cx < cfg.nxg) & (cy >= 0) & (cy < cfg.nyg)
    valid = live[:, None] & in_z[:, None] & in_grid & (w4 > 0)

    lin = cell[:, None] * (cfg.nyg * cfg.nxg) + cy * cfg.nxg + cx
    lin = jnp.where(valid, lin, 2 ** 30)  # out-of-range -> dropped

    if cfg.particle_count_output:
        contrib = jnp.broadcast_to(w4[..., None], w4.shape + (p.nspec,))
    else:
        contrib = (w4 / rhoi[:, None])[..., None] * p.mass[:, None, :]
        if cfg.bkdep:
            contrib = contrib * jnp.maximum(p.xscav, 0.0)[:, None, :]
    contrib = jnp.where(valid[..., None], contrib * weight, 0.0)

    flat = acc.gridunc.reshape(-1, p.nspec)
    flat = flat.at[lin.reshape(-1)].add(contrib.reshape(-1, p.nspec),
                                        mode="drop")
    return acc._replace(gridunc=flat.reshape(acc.gridunc.shape),
                        outnum=acc.outnum + weight)
