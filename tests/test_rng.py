"""RNG contract: determinism, clipping, stream separation.

The production draws replace the reference's gasdev1 table
(random_mod.f90:61-90); the contract the draws must satisfy is
N(0,1) clipped to +/-3 with draws depending only on (key, tag, shape).
"""
import jax
import jax.numpy as jnp
import numpy as np

from flexpart_tpu.core import rng


def test_threefry_deterministic_and_clipped():
    k = jax.random.PRNGKey(7)
    a = rng.normals(k, (4, 1000), tag=2)
    b = rng.normals(k, (4, 1000), tag=2)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(jnp.max(jnp.abs(a))) <= 3.0


def test_tags_give_distinct_streams():
    k = jax.random.PRNGKey(7)
    a = rng.normals(k, (1000,), tag=1)
    b = rng.normals(k, (1000,), tag=2)
    assert not np.array_equal(np.asarray(a), np.asarray(b))


def test_uniforms_in_range():
    k = jax.random.PRNGKey(3)
    u = rng.uniforms(k, (1000,), tag=0)
    u = np.asarray(u)
    assert u.min() >= 0.0 and u.max() < 1.0
