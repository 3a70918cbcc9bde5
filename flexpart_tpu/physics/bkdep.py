"""Backward deposition source-receptor modes (WETBKDEP / DRYBKDEP).

Re-design of the reference's ind_receptor=3/4 backward machinery
(readcommand.f90:316-339, timemanager.f90:565-598): each particle, ONCE
at its first step after release, is assigned a scavenging factor
``xscav``:

  * WETBKDEP: Lambda * (zpoint2-zpoint1) * grfraction(1) from the wet
    scavenging coefficient at the release location/time
    (timemanager.f90:585-596);
  * DRYBKDEP: the dry deposition velocity interpolated to the particle
    (get_vdep_prob.f90:43-61 returns vdepo -> result kg/m2/s);
  * zero scavenging at the release -> the particle's mass is zeroed so it
    never contributes (timemanager.f90:572-578).

conccalc then multiplies every contribution by max(xscav, 0)
(conccalc.f90:181,230).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.interp import horiz_weights
from ..core.state import Particles
from .wetdepo import wetscav_all


@jax.jit
def assign_drybkdep(p: Particles, vdep_field) -> Particles:
    """vdep_field: (nspec, ny, nx) deposition velocity grid."""
    fresh = p.active & (p.xscav[:, 0] < 0.0)
    ny, nx = vdep_field.shape[1], vdep_field.shape[2]
    hw = horiz_weights(p.x, p.y, nx, ny, False)
    flat = vdep_field.reshape(vdep_field.shape[0], -1)
    # f32 HIGHEST: a default-precision dot may run in TF32 on Hopper
    vd = jnp.einsum("snc,nc->sn", flat[:, hw.idx4], hw.p4,
                    precision=jax.lax.Precision.HIGHEST)     # (nspec, N)
    vd = vd.T                                                # (N, nspec)
    xs = jnp.where(fresh[:, None], jnp.maximum(vd, 0.0), p.xscav)
    mass = jnp.where(fresh[:, None] & (vd <= 0.0), 0.0, p.mass)
    return p._replace(xscav=xs, mass=mass)


def assign_wetbkdep(p: Particles, zf, itime, ltsample, wet_species,
                    use_clwc: bool, column_height) -> Particles:
    """column_height: (N,) release-box vertical extent per particle
    (zpoint2-zpoint1; 20 km under the forced WETBKDEP release)."""
    fresh = p.active & (p.xscav[:, 0] < 0.0)
    lam, grfrac = wetscav_all(p, zf, itime, ltsample, wet_species,
                              use_clwc)                       # (nspec,N)
    xs_new = (lam * column_height[None, :] * grfrac[None, :]).T
    xs = jnp.where(fresh[:, None], jnp.maximum(xs_new, 0.0), p.xscav)
    mass = jnp.where(fresh[:, None] & (xs_new <= 0.0), 0.0, p.mass)
    return p._replace(xscav=xs, mass=mass)


def write_precip(path, when, releases, grid, eta, first: bool):
    """wetscav_precip.txt: release-point precipitation time series
    (writeprecip.f90:25-52) for WETBKDEP post-processing."""
    import numpy as np
    jjjjmmdd = when.year * 10000 + when.month * 100 + when.day
    ihmmss = when.hour * 10000 + when.minute * 100 + when.second
    lsp = np.asarray(eta.lsprec)
    cvp = np.asarray(eta.convprec)
    with open(path, "w" if first else "a") as f:
        for b in releases.boxes:
            x1, y1 = grid.lonlat_to_grid(b.lon1, b.lat1)
            x2, y2 = grid.lonlat_to_grid(b.lon2, b.lat2)
            ix = int((x1 + x2) / 2.0)
            jy = int((y1 + y2) / 2.0)
            f.write(f" {jjjjmmdd} {ihmmss} {b.lon1:.4f} {b.lat1:.4f} "
                    f"{lsp[jy, ix]:.6e} {cvp[jy, ix]:.6e}\n")
