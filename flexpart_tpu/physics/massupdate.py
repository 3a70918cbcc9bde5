"""Per-step particle mass updates: wet deposit, dry deposit, decay,
minmass termination.

Vectorized analogs of the mass bookkeeping in wetdepo.f90:102-138 and
timemanager.f90:643-686: every quantity is an (nspec, N) / (N, nspec)
array op; species constants are baked in statically (nspec is tiny).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import HREF
from ..core.interp import horiz_weights
from ..core.state import Particles

TINY = np.finfo(np.float32).tiny


class MassSpecies(NamedTuple):
    """Static per-species mass-update constants."""
    decay: tuple            # (nspec,) decay constant [1/s]; <=0 off
    drydep: tuple           # (nspec,) bool
    minmass: float = 1.0e-4


@functools.partial(jax.jit, static_argnames=("sp",))
def apply_wetdepo(p: Particles, lam, grfraction, ltsample, ldeltat,
                  sp: MassSpecies):
    """Wet-deposition mass removal (wetdepo.f90:102-138).

    lam: (nspec, N) scavenging coefficients (0 where none).
    Returns (particles, deposit (nspec, N)) with the deposit already
    decay-corrected to the last gridded-decay time (ldeltat)."""
    lamT = lam.T                                       # (N, nspec)
    wetdeposit = p.mass * (1.0 - jnp.exp(-lamT * jnp.abs(ltsample))) \
        * grfraction[:, None]
    restmass = p.mass - wetdeposit
    new_mass = jnp.where(restmass > TINY, restmass, 0.0)
    dec = jnp.asarray(sp.decay, jnp.float32)
    corr = jnp.where(dec > 0.0,
                     jnp.exp(jnp.abs(ldeltat).astype(jnp.float32) * dec),
                     1.0)
    deposit = (wetdeposit * corr[None, :]).T           # (nspec, N)
    deposit = jnp.where(p.active[None, :], deposit, 0.0)
    return p._replace(mass=new_mass), deposit


@functools.partial(jax.jit, static_argnames=("sp", "has_vdep"))
def apply_decay_drydep(p: Particles, vdep_field, lsynctime, ldeltat,
                       sp: MassSpecies, has_vdep: bool, t_below=None):
    """Radioactive decay + dry-deposition mass removal + minmass
    termination (timemanager.f90:643-686).

    vdep_field: (nspec, ny, nx) deposition-velocity field of the current
    wind-field time level (bilinear at the particle, interpol_vdep.f90)
    or None.  t_below: adaptive-mode per-particle seconds spent below
    2*href during the interval (the prob accumulation of
    advance.f90:582-599, whose per-pass factors multiply to
    exp(-vdep*t_below/2href)); None = fixed-step single-factor rule
    (identical when dt==lsynctime).  Returns
    (particles, drydeposit (nspec, N))."""
    n = p.capacity
    nspec = p.nspec
    dec = jnp.asarray(sp.decay, jnp.float32)
    dt = jnp.abs(lsynctime).astype(jnp.float32)
    decfact = jnp.where(dec > 0.0, jnp.exp(-dt * dec), 1.0)   # (nspec,)

    if has_vdep:
        ny_m, nx_m = vdep_field.shape[1], vdep_field.shape[2]
        hw = horiz_weights(p.x, p.y, nx_m, ny_m, False)
        flat = vdep_field.reshape(nspec, ny_m * nx_m)
        # f32 HIGHEST: a default-precision dot may run in TF32 on Hopper
        vd = jnp.einsum("snc,nc->sn", flat[:, hw.idx4], hw.p4,
                        precision=jax.lax.Precision.HIGHEST)  # (nspec,N)
        if t_below is not None:
            prob = 1.0 - jnp.exp(-vd * t_below[None, :] / (2.0 * HREF))
        else:
            prob = jnp.where(p.z[None, :] < 2.0 * HREF,
                             1.0 - jnp.exp(-vd * dt / (2.0 * HREF)), 0.0)
    else:
        prob = jnp.zeros((nspec, n), jnp.float32)

    drydep_mask = jnp.asarray(sp.drydep, bool)                 # (nspec,)
    probT = jnp.where(drydep_mask[None, :], prob.T, 0.0)       # (N,nspec)
    drydeposit = p.mass * probT * decfact[None, :]
    new_mass = p.mass * (1.0 - probT) * decfact[None, :]
    corr = jnp.where(dec > 0.0,
                     jnp.exp(jnp.abs(ldeltat).astype(jnp.float32) * dec),
                     1.0)
    deposit = (drydeposit * corr[None, :]).T                   # (nspec,N)
    deposit = jnp.where(p.active[None, :], deposit, 0.0)

    # minmass termination (timemanager.f90:662-686)
    frac = jnp.where(p.mass0 > 0.0, new_mass / p.mass0, 1.0)
    xmassfract = jnp.max(frac, axis=1)
    keep = xmassfract >= sp.minmass
    new_active = p.active & keep
    return p._replace(mass=jnp.where(p.active[:, None], new_mass, p.mass),
                      active=new_active), deposit


@jax.jit
def decay_deposition_grids(wetgridunc, drygridunc, decay, lsynctime):
    """Radioactive decay of already-deposited mass on the output grids
    (timemanager.f90:269-304).  decay: (nspec,) array; grids have species
    innermost."""
    dec = jnp.asarray(decay, jnp.float32)
    dt = jnp.abs(lsynctime).astype(jnp.float32)
    f = jnp.where(dec > 0.0, jnp.exp(-dt * dec), 1.0)
    return wetgridunc * f, drygridunc * f
