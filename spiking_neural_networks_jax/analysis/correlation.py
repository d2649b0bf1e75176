"""Pearson correlation (rebuild of `reference/backend/src/correlation/mod.rs`)."""

from __future__ import annotations

import jax.numpy as jnp


def pearsonr(x, y):
    """`pearsonr` (correlation/mod.rs:19-39): returns NaN when either series
    has zero variance (matching the reference's division by zero)."""
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    if x.shape != y.shape:
        raise ValueError("series are not the same length")
    xm = x - jnp.mean(x)
    ym = y - jnp.mean(y)
    numerator = jnp.sum(xm * ym)
    denominator = jnp.sqrt(jnp.sum(xm ** 2) * jnp.sum(ym ** 2))
    return numerator / denominator
