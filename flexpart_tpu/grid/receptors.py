"""Receptor-point concentration sampling.

Vectorized re-design of the receptor block of conccalc.f90:430-498: an
age-broadened Epanechnikov kernel gathers nearby particle mass at fixed
receptor locations.  The reference loops receptors x particles with
early exits; here it is one (R, N) broadcast per sync sample — R is tiny
(RECEPTORS namelist), N is the particle axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Receptor
from ..constants import PI, R_EARTH
from ..core.state import Particles


class ReceptorSet(NamedTuple):
    """Device arrays only (jit-traversable); names kept separately."""
    x: jnp.ndarray         # (R,) grid units
    y: jnp.ndarray
    area: jnp.ndarray      # (R,) cell area [m2] (openreceptors.f90)


def build_receptors(receptors, grid):
    """Returns (ReceptorSet, names) or (None, ())."""
    if not receptors:
        return None, ()
    xs, ys, areas, names = [], [], [], []
    for r in receptors:
        x, y = grid.lonlat_to_grid(r.lon, r.lat)
        xs.append(float(x))
        ys.append(float(y))
        # grid-cell area at the receptor latitude (openreceptors.f90)
        ylat = r.lat
        area = (2.0 * PI * R_EARTH / 360.0 * grid.dy) \
            * (2.0 * PI * R_EARTH / 360.0 * grid.dx
               * np.cos(np.deg2rad(ylat)))
        areas.append(area)
        names.append(r.name)
    return ReceptorSet(x=jnp.asarray(xs, jnp.float32),
                       y=jnp.asarray(ys, jnp.float32),
                       area=jnp.asarray(areas, jnp.float32)), tuple(names)


@functools.partial(jax.jit, static_argnames=("dx", "dy"))
def sample_receptors(creceptor, rec: ReceptorSet, p: Particles, itime,
                     weight, dx: float, dy: float):
    """One sampling pass (conccalc.f90:430-498).  creceptor: (R, nspec)."""
    itage = jnp.abs(p.itra - p.itramem).astype(jnp.float32)
    live = p.active & (p.itra == itime)

    hzmax, hxmax, hymax = 150.0, 6.0, 4.0    # conccalc.f90:42 caps
    hz = jnp.minimum(50.0 + 0.3 * jnp.sqrt(itage), hzmax)          # (N,)
    hx = jnp.minimum((0.29 + 2.222e-3 * jnp.sqrt(itage)) * dx
                     + itage * 1.2e-5, hxmax)
    hy = jnp.minimum((0.18 + 1.389e-3 * jnp.sqrt(itage)) * dy
                     + itage * 7.5e-6, hymax)

    zd = p.z[None, :] / hz[None, :]                                # (R, N)
    xd = (p.x[None, :] - rec.x[:, None]) / hx[None, :]
    yd = (p.y[None, :] - rec.y[:, None]) / hy[None, :]
    r2 = xd * xd + yd * yd + zd * zd
    inside = (r2 < 1.0) & live[None, :]
    factor = 0.596831                      # 15/(8 pi), Epanechnikov norm
    xkern = factor * (1.0 - r2) / (hx * hy * hz)[None, :]
    w = jnp.where(inside, xkern, 0.0)                              # (R, N)
    # f32 HIGHEST: a default-precision dot may run in TF32 on Hopper
    c = jnp.matmul(w, p.mass,
                   precision=jax.lax.Precision.HIGHEST)            # (R, ks)
    return creceptor + 2.0 * weight * c / rec.area[:, None]
