"""Physical constants and model parameters.

Re-design of the reference constant set (see
/root/reference/src/par_mod.f90:59-110).  Unlike the reference, grid sizes and
particle capacities are *runtime* configuration (carried by typed config
objects), not compile-time constants; only true physical constants and
universal model parameters live here.
"""

from __future__ import annotations

import math

# --- physical constants (par_mod.f90:62-76) ---
PI = math.pi
R_EARTH = 6.371e6        # radius of earth [m]
R_AIR = 287.05           # gas constant, dry air [J/kg/K]
GA = 9.81                # gravitational acceleration [m/s^2]
CPA = 1004.6             # specific heat of dry air [J/kg/K]
KAPPA = 0.286            # poisson exponent for potential temperature
PI180 = PI / 180.0
VONKARMAN = 0.40
KARMAN = 0.40
RGAS = 8.31447           # universal gas constant [J/mol/K]
R_WATER = 461.495        # gas constant, water vapour [J/kg/K]
RHO_WATER = 1000.0       # [kg/m3]

# --- model parameters (par_mod.f90:78-96) ---
HREF = 15.0              # reference height for dry deposition [m]
CONVKE = 2.0             # share of kinetic energy usable for lifting
HMIXMIN = 100.0          # minimum PBL height [m]
HMIXMAX = 4500.0         # maximum PBL height [m]
D_TROP = 50.0            # horizontal diffusivity, free troposphere [m2/s]
D_STRAT = 0.1            # vertical diffusivity, stratosphere [m2/s]
TURBMESOSCALE = 0.16     # mesoscale wind fluctuation factor
INCLOUD_RATIO = 6.2      # in-cloud scavenging ratio (par_mod.f90:95)
XMWML = 18.016 / 28.960  # molar weight ratio water/dry air

# --- stratospheric ozone tracer (par_mod.f90:115-117) ---
OZONESCALE = 60.0        # ppbv O3 per PV unit
PVCRIT = 2.0             # PV of dynamical tropopause [pvu]

# --- time constants (par_mod.f90:124-126) ---
IDIFFNORM = 10800        # normal interval between wind fields [s]
IDIFFMAX = 2 * IDIFFNORM
MINSTEP = 1              # minimum integration substep [s]

# --- polar stereographic switch latitudes (par_mod.f90:133-135) ---
SWITCHNORTH = 75.0
SWITCHSOUTH = -75.0

# --- landuse / deposition (par_mod.f90:225) ---
NUMCLASS = 13            # number of landuse classes
NI = 11                  # number of particle diameter classes

# --- misc ---
MINMASS = 1.0e-4         # relative mass threshold to terminate a particle
ICMV = -9999             # integer missing value (wet scavenging)
