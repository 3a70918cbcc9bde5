"""Sensitivity to initial conditions for backward runs (linit_cond).

Re-design of /root/reference/src/initial_cond_calc.f90 +
initial_cond_output.f90: when a particle TERMINATES (domain exit, age
class, minmass) — and for every survivor at the run end — its mass
(divided by local air density for linit_cond=1, initial_cond_calc.f90:44-87)
is scattered onto the output grid with the same uniform 4-point kernel as
conccalc (no age gate; direct attribution near boundaries,
initial_cond_calc.f90:120-196).  The accumulated field, normalized by the
release mass, is the source-receptor sensitivity to the tracer's initial
distribution, written as ``grid_initial_nnn`` in the reference's sparse
format with empty wet/dry blocks (initial_cond_output.f90:83-126).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.interp import horiz_weights, vert_weights
from ..core.state import Particles
from ..met.fields import F3_RHO, ZFields


class InitCondConfig(NamedTuple):
    nxg: int
    nyg: int
    nzg: int
    npointspec: int
    dxout: float
    dyout: float
    xoutshift: float
    youtshift: float
    dx_met: float
    dy_met: float
    linit_cond: int          # 1: divide by air density, 2: plain mass
    ioutputforeachrelease: bool = True


def zero_init_cond(cfg: InitCondConfig, nspec: int):
    return jnp.zeros((cfg.npointspec, cfg.nzg, cfg.nyg, cfg.nxg, nspec),
                     jnp.float32)


def make_initcond_scatter(outheights):
    oh = jnp.asarray(np.asarray(outheights, np.float32))

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def _run(grid, p: Particles, mask, zf: ZFields,
             cfg: InitCondConfig):
        """Scatter mass[/rho] of `mask` particles into `grid`."""
        n = p.capacity
        x, y, z = p.x, p.y, p.z

        if cfg.linit_cond == 1:
            nx_m, ny_m = zf.f3d.shape[3], zf.f3d.shape[2]
            hw = horiz_weights(x, y, nx_m, ny_m, False)
            indz, dz1 = vert_weights(z, zf.height)
            rho_flat = zf.f3d[F3_RHO].reshape(-1)
            lin0 = indz[:, None] * (ny_m * nx_m) + hw.idx4
            # f32 HIGHEST: a default-precision dot may run in TF32 on Hopper
            hi = jax.lax.Precision.HIGHEST
            rho_lo = jnp.einsum("nc,nc->n", rho_flat[lin0], hw.p4,
                                precision=hi)
            rho_hi = jnp.einsum("nc,nc->n", rho_flat[lin0 + ny_m * nx_m],
                                hw.p4, precision=hi)
            rhoi = rho_lo * (1.0 - dz1) + rho_hi * dz1
        else:
            rhoi = jnp.ones_like(z)

        kz = jnp.searchsorted(oh, z, side="right")
        in_z = kz < cfg.nzg
        kz = jnp.minimum(kz, cfg.nzg - 1)

        xl = (x * cfg.dx_met + cfg.xoutshift) / cfg.dxout
        yl = (y * cfg.dy_met + cfg.youtshift) / cfg.dyout
        ix = jnp.floor(xl).astype(jnp.int32)
        jy = jnp.floor(yl).astype(jnp.int32)

        near_edge = ((xl < 0.5) | (yl < 0.5)
                     | (xl > cfg.nxg - 1 - 0.5)
                     | (yl > cfg.nyg - 1 - 0.5))
        ddx = xl - ix
        ddy = yl - jy
        ixp = jnp.where(ddx > 0.5, ix + 1, ix - 1)
        jyp = jnp.where(ddy > 0.5, jy + 1, jy - 1)
        wx = jnp.where(ddx > 0.5, 1.5 - ddx, 0.5 + ddx)
        wy = jnp.where(ddy > 0.5, 1.5 - ddy, 0.5 + ddy)

        cx = jnp.stack([ix, ix, ixp, ixp], axis=-1)
        cy = jnp.stack([jy, jyp, jy, jyp], axis=-1)
        w4 = jnp.stack([wx * wy, wx * (1 - wy), (1 - wx) * wy,
                        (1 - wx) * (1 - wy)], axis=-1)
        w4 = jnp.where(near_edge[:, None],
                       jnp.concatenate([jnp.ones((n, 1)),
                                        jnp.zeros((n, 3))], 1), w4)

        in_grid = (cx >= 0) & (cx < cfg.nxg) & (cy >= 0) & (cy < cfg.nyg)
        valid = mask[:, None] & in_z[:, None] & in_grid & (w4 > 0)

        kp = (p.npoint if cfg.ioutputforeachrelease
              else jnp.zeros_like(p.npoint))
        cell = kp * cfg.nzg + kz
        lin = cell[:, None] * (cfg.nyg * cfg.nxg) + cy * cfg.nxg + cx
        lin = jnp.where(valid, lin, 2 ** 30)

        contrib = (w4 / rhoi[:, None])[..., None] * p.mass[:, None, :]
        contrib = jnp.where(valid[..., None], contrib, 0.0)

        nspec = p.nspec
        flat = grid.reshape(-1, nspec)
        flat = flat.at[lin.reshape(-1)].add(contrib.reshape(-1, nspec),
                                            mode="drop")
        return flat.reshape(grid.shape)

    return _run


def write_initial_cond(outdir, itime: int, grid, release_mass,
                       fact_recept=None):
    """grid_initial_nnn files (initial_cond_output.f90:60-131).

    grid: (kp, nz, ny, nx, nspec); release_mass: (kp, nspec) total mass
    per release point and species; fact_recept: optional (kp,) density
    factor for ind_rel=1 runs (rho_rel), else 1."""
    from pathlib import Path

    from ..io.fortran_writer import _rec, _sparse_block
    import struct as _struct

    g = np.asarray(grid)
    npoint, nz, ny, nx, nspec = g.shape
    if fact_recept is None:
        fact_recept = np.ones(npoint, np.float32)
    for ks in range(nspec):
        out = bytearray(_rec(_struct.pack("<i", int(itime))))
        for kp in range(npoint):
            empty = _sparse_block(np.zeros(0, np.float32))
            out += empty + empty      # dummy wet + dry blocks
            xm = release_mass[kp][ks] if release_mass is not None else 1.0
            xm = xm if xm > 0 else 1.0
            field = g[kp, :, :, :, ks] / xm * fact_recept[kp]
            out += _sparse_block(field.ravel(), index_offset=nx * ny)
        Path(outdir, f"grid_initial_{ks + 1:03d}").write_bytes(bytes(out))
