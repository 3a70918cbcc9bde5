"""Particle state: fixed-capacity SoA arrays as a JAX pytree.

Re-design of the reference's global particle arrays
(com_mod.f90:675-695: itra1, npoint, nclass, idt, itramem, xtra1, ytra1,
ztra1, xmass1 + turbulence memory uap/ucp/uzp and mesoscale memory
uvwsig).  Differences, by design:

  * fixed capacity N with an explicit ``active`` mask (the reference's
    sentinel itra1 = -999999999, FLEXPART.f90:315-317, becomes a bool);
  * horizontal positions in mother-grid units carried as *double-single*
    (hi+lo float32 pairs) — the reference uses real(dp) for xtra1/ytra1
    (com_mod.f90:680); the two-float add keeps a ~48-bit mantissa for
    the position accumulation with f32 arithmetic only;
  * free slots are recycled by prefix-sum allocation at release time
    (core/release.py) instead of a growing count.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

# itra value for slots that are not scheduled (terminated/not yet released)
ITRA_INACTIVE = -999999999


class Particles(NamedTuple):
    x_hi: jnp.ndarray     # (N,) f32 grid units
    x_lo: jnp.ndarray     # (N,) f32 low part
    y_hi: jnp.ndarray     # (N,) f32
    y_lo: jnp.ndarray     # (N,) f32
    z: jnp.ndarray        # (N,) f32 metres above ground
    itra: jnp.ndarray     # (N,) i32 time of next update [s]
    itramem: jnp.ndarray  # (N,) i32 release time [s] (age reference)
    npoint: jnp.ndarray   # (N,) i32 release point index
    nclass: jnp.ndarray   # (N,) i32 uncertainty class 0..nclassunc-1
    idt: jnp.ndarray      # (N,) i32 adaptive time-step memory [s]
    itrasplit: jnp.ndarray  # (N,) i32 next split time [s] (com_mod.f90:707)
    up: jnp.ndarray       # (N,) f32 turbulent along-wind velocity [m/s]
    vp: jnp.ndarray       # (N,) f32 turbulent cross-wind velocity [m/s]
    wp: jnp.ndarray       # (N,) f32 turbulent w (normalized by sigw if turbswitch)
    usig: jnp.ndarray     # (N,) f32 mesoscale velocity memory [m/s]
    vsig: jnp.ndarray     # (N,) f32
    wsig: jnp.ndarray     # (N,) f32
    cbt: jnp.ndarray      # (N,) i8 forbidden-state flag (+1/-1)
    mass: jnp.ndarray     # (N, nspec) f32
    mass0: jnp.ndarray    # (N, nspec) f32 mass at release (minmass check)
    xscav: jnp.ndarray    # (N, nspec) f32 backward-dep scavenging factor
    #                       (com_mod xscav_frac1; 1 outside WET/DRYBKDEP,
    #                       -1 = not yet computed in bkdep runs)
    active: jnp.ndarray   # (N,) bool

    @property
    def capacity(self) -> int:
        return self.x_hi.shape[0]

    @property
    def nspec(self) -> int:
        return self.mass.shape[1]

    @property
    def x(self) -> jnp.ndarray:
        return self.x_hi + self.x_lo

    @property
    def y(self) -> jnp.ndarray:
        return self.y_hi + self.y_lo


def empty_particles(capacity: int, nspec: int = 1) -> Particles:
    zf = jnp.zeros(capacity, jnp.float32)
    zi = jnp.zeros(capacity, jnp.int32)
    return Particles(
        x_hi=zf, x_lo=zf, y_hi=zf, y_lo=zf, z=zf,
        itra=jnp.full(capacity, ITRA_INACTIVE, jnp.int32),
        itramem=zi, npoint=zi, nclass=zi, idt=zi,
        itrasplit=jnp.full(capacity, ITRA_INACTIVE, jnp.int32),
        up=zf, vp=zf, wp=zf, usig=zf, vsig=zf, wsig=zf,
        cbt=jnp.ones(capacity, jnp.int8),
        mass=jnp.zeros((capacity, nspec), jnp.float32),
        mass0=jnp.zeros((capacity, nspec), jnp.float32),
        xscav=jnp.ones((capacity, nspec), jnp.float32),
        active=jnp.zeros(capacity, bool),
    )


def ds_add(hi: jnp.ndarray, lo: jnp.ndarray, d: jnp.ndarray):
    """Double-single accumulate: (hi, lo) + d with error-free two-sum.
    Keeps the sum accurate to ~2^-46 of |hi| over millions of adds."""
    s = hi + d
    bb = s - hi
    err = (hi - (s - bb)) + (d - bb)
    lo2 = lo + err
    hi2 = s + lo2
    lo3 = lo2 - (hi2 - s)
    return hi2, lo3


def ds_value(hi: jnp.ndarray, lo: jnp.ndarray) -> jnp.ndarray:
    return hi + lo


def ds_set(val: jnp.ndarray):
    """Build a (hi, lo) pair from a plain float32 value."""
    return val, jnp.zeros_like(val)
