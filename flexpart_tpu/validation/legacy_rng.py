"""Exact host-side ports of the reference's Numerical Recipes RNG.

The reference seeds a 1M-entry table of clipped N(0,1) draws at startup
(`rannumb`, /root/reference/src/FLEXPART.f90:54-59) from `gasdev1`
(polar Box-Muller over `ran3`, random_mod.f90:70-91), and every
`advance`/`initialize` call draws one `ran3` uniform to pick a base
index `nrand` into that table (advance.f90:153, initialize.f90:68).
Release positions use `ran1` (releaseparticles.f90:147-193).

These ports reproduce the integer arithmetic exactly (all state is
Python ints; the float outputs are single-precision-safe because the
generators only produce values of the form k/1e9 or k*am with exact
f32-representable factors applied at the end), so a matched-stream
comparison between the kernel in legacy-RNG mode and the scalar
oracle of advance.f90 consumes bitwise-identical random numbers.
"""

from __future__ import annotations

import functools
import math

import numpy as np

MAXRAND = 1000000        # par_mod.f90:254


class Ran3:
    """Knuth subtractive generator, stateful port of random_mod.f90:93-139.

    The Fortran keeps `ma/inext/inextp` in SAVE variables and
    (re)initializes when `idum < 0` or on first use; `idum` is set to 1
    after init (the caller's idummy variable is INOUT)."""

    MBIG = 1000000000
    MSEED = 161803398

    def __init__(self, idum: int = -7):
        self.ma = [0] * 56        # 1-based
        self.inext = 0
        self.inextp = 0
        self.iff = 0
        self.idum = idum

    def _init_table(self):
        mj = (self.MSEED - abs(self.idum)) % self.MBIG
        self.ma[55] = mj
        mk = 1
        for i in range(1, 55):
            ii = (21 * i) % 55
            self.ma[ii] = mk
            mk = mj - mk
            if mk < 0:
                mk += self.MBIG
            mj = self.ma[ii]
        for _ in range(4):
            for i in range(1, 56):
                self.ma[i] -= self.ma[1 + (i + 30) % 55]
                if self.ma[i] < 0:
                    self.ma[i] += self.MBIG
        self.inext = 0
        self.inextp = 31
        self.idum = 1
        self.iff = 1

    def __call__(self) -> np.float32:
        if self.idum < 0 or self.iff == 0:
            self._init_table()
        self.inext += 1
        if self.inext == 56:
            self.inext = 1
        self.inextp += 1
        if self.inextp == 56:
            self.inextp = 1
        mj = self.ma[self.inext] - self.ma[self.inextp]
        if mj < 0:
            mj += self.MBIG
        self.ma[self.inext] = mj
        # fac = 1./mbig in f32
        return np.float32(mj) * np.float32(np.float32(1.0) / np.float32(self.MBIG))


class Ran1:
    """Park-Miller with Bays-Durham shuffle (random_mod.f90:12-42)."""

    IA, IM, IQ, IR = 16807, 2147483647, 127773, 2836
    NTAB = 32

    def __init__(self, idum: int = -7):
        self.iv = [0] * (self.NTAB + 1)
        self.iy = 0
        self.idum = idum

    def __call__(self) -> np.float32:
        ndiv = 1 + (self.IM - 1) // self.NTAB
        am = np.float32(1.0) / np.float32(self.IM)
        eps = np.float32(1.2e-7)
        rnmx = np.float32(1.0) - eps
        if self.idum <= 0 or self.iy == 0:
            self.idum = max(-self.idum, 1)
            for j in range(self.NTAB + 8, 0, -1):
                k = self.idum // self.IQ
                self.idum = self.IA * (self.idum - k * self.IQ) - self.IR * k
                if self.idum < 0:
                    self.idum += self.IM
                if j <= self.NTAB:
                    self.iv[j] = self.idum
            self.iy = self.iv[1]
        k = self.idum // self.IQ
        self.idum = self.IA * (self.idum - k * self.IQ) - self.IR * k
        if self.idum < 0:
            self.idum += self.IM
        j = 1 + self.iy // ndiv
        self.iy = self.iv[j]
        self.iv[j] = self.idum
        return min(am * np.float32(self.iy), rnmx)


def gasdev1(ran3: Ran3):
    """Polar Box-Muller pair, clipped to +-3 (random_mod.f90:70-91)."""
    while True:
        v1 = np.float32(2.0) * ran3() - np.float32(1.0)
        v2 = np.float32(2.0) * ran3() - np.float32(1.0)
        r = v1 * v1 + v2 * v2
        if not (r >= 1.0 or r == 0.0):
            break
    fac = np.float32(math.sqrt(-2.0 * math.log(float(r)) / float(r)))
    r1 = np.float32(np.clip(v1 * fac, -3.0, 3.0))
    r2 = np.float32(np.clip(v2 * fac, -3.0, 3.0))
    return r1, r2


@functools.lru_cache(maxsize=2)
def make_rannumb(maxrand: int = MAXRAND, seed: int = -7) -> np.ndarray:
    """The reference's startup RNG table, 1-based: rannumb[1..maxrand]
    (FLEXPART.f90:54-59; index 0 is unused padding so Fortran indices can
    be used directly).  The last odd entry pair fills (maxrand,
    maxrand-1) in that order, exactly like the reference."""
    g = Ran3(seed)
    tab = np.zeros(maxrand + 1, np.float32)
    for j in range(1, maxrand, 2):
        tab[j], tab[j + 1] = gasdev1(g)
    r1, r2 = gasdev1(g)
    tab[maxrand], tab[maxrand - 1] = r1, r2
    return tab


class NrandStream:
    """The per-call `nrand = int(ran3(idummy)*real(maxrand-1))+1` chase
    (advance.f90:153, initialize.f90:68).  One shared idummy chain, in
    reference consumption order (per particle, initialize before advance
    within the same scheduler iteration, timemanager.f90:553-611)."""

    def __init__(self, seed: int = -7, maxrand: int = MAXRAND):
        self.ran3 = Ran3(seed)
        self.maxrand = maxrand
        self._gset = np.float32(0.0)   # gasdev pair cache
        self._iset = 0

    def next_nrand(self) -> int:
        return int(self.ran3() * np.float32(self.maxrand - 1)) + 1

    def uniform(self) -> np.float32:
        """One ran3 draw from the shared chain (initialize_cbl_vel.f90
        `dcas=ran3(idum)`)."""
        return self.ran3()

    def gasdev(self) -> np.float32:
        """random_mod.f90:45-67 `gasdev`: UNclipped polar Box-Muller
        with the Fortran's iset pair cache, over the shared chain."""
        if self._iset == 0:
            while True:
                v1 = np.float32(2.0) * self.ran3() - np.float32(1.0)
                v2 = np.float32(2.0) * self.ran3() - np.float32(1.0)
                r = v1 * v1 + v2 * v2
                if not (r >= 1.0 or r == 0.0):
                    break
            fac = np.float32(math.sqrt(-2.0 * math.log(float(r))
                                       / float(r)))
            self._gset = np.float32(v1 * fac)
            self._iset = 1
            return np.float32(v2 * fac)
        self._iset = 0
        return self._gset
