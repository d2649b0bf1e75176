"""Clamped-normal sampling (`limited_distr`) and Gaussian input noise.

JAX equivalent of `reference/backend/src/distribution/mod.rs:9-18`
and `GaussianParameters` (iterate_and_spike/mod.rs:2893-2928), using JAX
threaded PRNG keys instead of a global thread RNG.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def limited_distr(key, mean, std, minimum, maximum, shape=()):
    """Normal(mean, std) clamped to [minimum, maximum]; returns mean
    UNCLAMPED when std == 0 (distribution/mod.rs:10-12 early-returns the
    mean before any clamping)."""
    sample = mean + std * jax.random.normal(key, shape)
    clipped = jnp.clip(sample, minimum, maximum)
    return jnp.where(jnp.asarray(std) == 0.0,
                     jnp.broadcast_to(jnp.asarray(mean, clipped.dtype),
                                      clipped.shape),
                     clipped)


class GaussianParameters:
    """Mirror of the reference's noise parameter set (defaults:
    iterate_and_spike/mod.rs:2906-2915)."""

    def __init__(self, mean=1.0, std=0.0, maximum=2.0, minimum=0.0):
        self.mean = mean
        self.std = std
        self.max = maximum
        self.min = minimum

    def sample(self, key, shape=()):
        return limited_distr(key, self.mean, self.std, self.min, self.max, shape)
