"""Typed configuration layer.

Parses the reference's namelist formats (COMMAND, RELEASES, SPECIES_nnn,
OUTGRID, AGECLASSES, RECEPTORS, pathnames, AVAILABLE — reference readers in
/root/reference/src/read*.f90) into immutable dataclasses that drive the
JAX runtime.  All grid sizes / capacities that were compile-time
constants in the reference (par_mod.f90) are runtime values here.
"""

from .namelist import parse_namelist, namelist_groups, namelist_single
from .command import Command
from .species import Species, SizeClasses, part0
from .releases import Releases, ReleaseBox
from .outgrid import OutGrid, AgeClasses, Receptor, read_receptors
from .paths import Pathnames, WindFieldEntry, read_available

__all__ = [
    "parse_namelist", "namelist_groups", "namelist_single",
    "Command", "Species", "SizeClasses", "part0",
    "Releases", "ReleaseBox",
    "OutGrid", "AgeClasses", "Receptor", "read_receptors",
    "Pathnames", "WindFieldEntry", "read_available",
]
