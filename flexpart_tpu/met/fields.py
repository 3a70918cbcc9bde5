"""Met-field containers.

The reference keeps met data as dozens of separate global Fortran arrays in
com_mod.f90:355-426.  Here a wind-field time level is ONE stacked 3-D array
plus ONE stacked 2-D array (field-major, (F, nz, ny, nx) / (F, ny, nx)) so
the particle interpolation kernel performs a single large gather per step —
plus a few specials (cloud classification, per-species deposition
velocities).

``EtaFields`` is what a met backend (GRIB decoder / synthetic generator)
produces on the native hybrid-eta levels; ``process_eta`` in
met/verttransform.py turns it into a ``ZFields`` on the fixed height grid.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class EtaFields(NamedTuple):
    """Raw decoded fields on hybrid-eta levels, bottom-up, level 0 = ground
    (10m-wind artificial level, see readwind_ecmwf.f90:489-494).
    3-D arrays: (nlev, ny, nx); 2-D: (ny, nx)."""
    ps: jnp.ndarray        # surface pressure [Pa]
    tt2: jnp.ndarray       # 2m temperature [K]
    td2: jnp.ndarray       # 2m dewpoint [K]
    sshf: jnp.ndarray      # surface sensible heat flux [W/m2] (ECMWF sign)
    surfstr: jnp.ndarray   # surface stress magnitude [N/m2]
    ssr: jnp.ndarray       # surface solar radiation [W/m2]
    lsprec: jnp.ndarray    # large-scale precip [mm/h]
    convprec: jnp.ndarray  # convective precip [mm/h]
    tcc: jnp.ndarray       # total cloud cover [0..1]
    sd: jnp.ndarray        # snow depth [m w.e.]
    oro: jnp.ndarray       # orography [m]
    excessoro: jnp.ndarray # subgrid orography std [m]
    lsm: jnp.ndarray       # land-sea mask [0..1]
    tth: jnp.ndarray       # temperature on eta levels [K]
    qvh: jnp.ndarray       # specific humidity on eta levels [kg/kg]
    uuh: jnp.ndarray       # u on eta levels [m/s]
    vvh: jnp.ndarray       # v on eta levels [m/s]
    wwh: jnp.ndarray       # etadot on half levels [Pa/s]
    clwch: jnp.ndarray     # cloud (liquid+ice) water content [kg/kg] (zeros if absent)


# --- stacked 3-D field indices (ZFields.f3d) ---
F3_U = 0        # u wind [m/s] (z levels)
F3_V = 1
F3_W = 2        # w wind [m/s] after pinmconv + eta-slope correction
F3_RHO = 3      # air density [kg/m3]
F3_DRHODZ = 4   # d(rho)/dz [kg/m4]
F3_TT = 5       # temperature [K]
F3_QV = 6       # specific humidity [kg/kg]
F3_PV = 7       # potential vorticity [pvu]
F3_CLW = 8      # per-layer cloud water [m2/m3] (readclouds diagnostics)
NF3 = 9

# --- stacked 2-D field indices (ZFields.f2d) ---
F2_PS = 0
F2_HMIX = 1      # PBL height [m]
F2_TROPO = 2     # thermal tropopause height [m]
F2_USTAR = 3
F2_WSTAR = 4
F2_OLI = 5       # inverse Obukhov length [1/m]
F2_LSPREC = 6
F2_CONVPREC = 7
F2_TCC = 8
F2_TT2 = 9
F2_TD2 = 10
F2_SD = 11
F2_ORO = 12
F2_EXCESSORO = 13
F2_LSM = 14
F2_CLOUDSH = 15  # total cloud depth [m] (for wet scavenging)
F2_CTWC = 16     # column total cloud water
F2_SSR = 17
F2_SSHF = 18
NF2 = 19


class ZFields(NamedTuple):
    """One processed wind-field time level on the fixed height grid —
    the analog of one `memind` slot of com_mod's uu/vv/ww/rho/... stacks
    plus the calcpar surface fields."""
    f3d: jnp.ndarray      # (NF3, nz, ny, nx) float32
    f2d: jnp.ndarray      # (NF2, ny, nx) float32
    clouds: jnp.ndarray   # (nz, ny, nx) int8 scavenging classification
    vdep: jnp.ndarray     # (nspec, ny, nx) float32 dry-deposition velocity
    height: jnp.ndarray   # (nz,) float32 fixed height grid [m]

    @property
    def nz(self) -> int:
        return self.f3d.shape[1]


def zeros_zfields(nz: int, ny: int, nx: int, nspec: int = 1) -> ZFields:
    return ZFields(
        f3d=jnp.zeros((NF3, nz, ny, nx), jnp.float32),
        f2d=jnp.zeros((NF2, ny, nx), jnp.float32),
        clouds=jnp.zeros((nz, ny, nx), jnp.int8),
        vdep=jnp.zeros((nspec, ny, nx), jnp.float32),
        height=jnp.zeros((nz,), jnp.float32),
    )


def eta_from_numpy(d: dict[str, np.ndarray]) -> EtaFields:
    return EtaFields(**{k: jnp.asarray(v, jnp.float32) for k, v in d.items()})
