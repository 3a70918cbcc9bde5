"""Receptor sampling against a float64 numpy transcription of
conccalc.f90:430-498.  The (R, N) x (N, nspec) product runs at HIGHEST
precision (a default-precision f32 dot may use TF32 on Hopper), so it
must agree with float64 to f32 rounding."""
import jax.numpy as jnp
import numpy as np

from flexpart_tpu.core.state import empty_particles
from flexpart_tpu.grid.receptors import ReceptorSet, sample_receptors


def _reference(rx, ry, area, x, y, z, age, mass, live, weight, dx, dy):
    hz = np.minimum(50.0 + 0.3 * np.sqrt(age), 150.0)
    hx = np.minimum((0.29 + 2.222e-3 * np.sqrt(age)) * dx
                    + age * 1.2e-5, 6.0)
    hy = np.minimum((0.18 + 1.389e-3 * np.sqrt(age)) * dy
                    + age * 7.5e-6, 4.0)
    out = np.zeros((len(rx), mass.shape[1]))
    for r in range(len(rx)):
        r2 = (((x - rx[r]) / hx) ** 2 + ((y - ry[r]) / hy) ** 2
              + (z / hz) ** 2)
        w = np.where((r2 < 1.0) & live,
                     0.596831 * (1.0 - r2) / (hx * hy * hz), 0.0)
        out[r] = 2.0 * weight * (w @ mass) / area[r]
    return out


def test_sample_receptors_matches_float64_reference():
    rs = np.random.RandomState(3)
    n, nspec = 4096, 2
    itime = 3600
    rx = np.array([10.0, 10.5, 30.0])
    ry = np.array([20.0, 20.2, 5.0])
    area = np.array([1.2e10, 1.1e10, 1.3e10])
    x = rs.uniform(8.0, 13.0, n)
    y = rs.uniform(18.0, 22.0, n)
    z = rs.uniform(0.0, 200.0, n)
    itramem = rs.randint(0, 3000, n)
    mass = rs.uniform(0.5, 1.5, (n, nspec)) * (1.0 + 1e-3 * rs.rand(n, 1))
    live = rs.rand(n) < 0.9
    p = empty_particles(n, nspec=nspec)._replace(
        x_hi=jnp.asarray(x, jnp.float32), y_hi=jnp.asarray(y, jnp.float32),
        z=jnp.asarray(z, jnp.float32),
        itra=jnp.where(jnp.asarray(live), itime, itime - 900),
        itramem=jnp.asarray(itramem, jnp.int32),
        mass=jnp.asarray(mass, jnp.float32), active=jnp.ones(n, bool))
    rec = ReceptorSet(x=jnp.asarray(rx, jnp.float32),
                      y=jnp.asarray(ry, jnp.float32),
                      area=jnp.asarray(area, jnp.float32))
    got = sample_receptors(jnp.zeros((3, nspec), jnp.float32), rec, p,
                           jnp.int32(itime), jnp.float32(0.25), dx=1.0,
                           dy=1.0)
    f32 = lambda a: np.float64(np.float32(a))
    want = _reference(rx, ry, area, f32(x), f32(y), f32(z),
                      np.float64(itime - itramem), f32(mass), live,
                      0.25, 1.0, 1.0)
    assert want[0].min() > 0 and want[2].max() == 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5,
                               atol=1e-6 * want.max())
