"""Counter-based RNG.

Replaces the reference's precomputed 1M-entry gaussian table + stateful
ran3 index chase (FLEXPART.f90:56-59, random_mod.f90, advance.f90:153)
with stateless draws keyed on (seed, step, draw-slot): reproducible,
order-independent, shard-friendly — each call site gets its own stream,
so resharding particles across chips never changes the physics.  Normal
draws are clipped to +/-3 exactly like the reference's gasdev1
(random_mod.f90:85-89).

Draws come from jax.random (threefry2x32), which is bit-stable across
backends and jax versions and depends only on (key, tag, shape), so
serial, dp-sharded and tiled executions that make the same calls draw
the same numbers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def step_key(base_key: jnp.ndarray, step_index) -> jnp.ndarray:
    """Key for one sync step."""
    return jax.random.fold_in(base_key, step_index)


def normals(key: jnp.ndarray, shape, tag: int = 0) -> jnp.ndarray:
    """Clipped N(0,1) draws (gasdev1-compatible distribution)."""
    k = jax.random.fold_in(key, tag)
    return jnp.clip(jax.random.normal(k, shape, jnp.float32), -3.0, 3.0)


def uniforms(key: jnp.ndarray, shape, tag: int = 0) -> jnp.ndarray:
    k = jax.random.fold_in(key, tag)
    return jax.random.uniform(k, shape, jnp.float32)
