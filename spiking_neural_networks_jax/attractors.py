"""Hopfield attractor utilities and the discrete bipolar neuron lattice.

JAX rebuild of `reference/backend/src/neuron/attractors/mod.rs`:
instead of object-per-neuron sign updates over an adjacency structure, the
whole lattice is one +/-1 state vector updated by float32 dot products.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def generate_hopfield_network(patterns):
    """Bipolar outer-product learning with zero diagonal
    (`generate_hopfield_network`, attractors/mod.rs:486-557).

    ``patterns``: (P, rows, cols) bool/0-1 array.  Returns (N, N) f32 weights
    where N = rows * cols (w[i, j] = edge i -> j).
    """
    pats = np.asarray(patterns)
    if pats.ndim != 3:
        raise ValueError("patterns must be (P, rows, cols)")
    p, rows, cols = pats.shape
    flat = np.where(pats.reshape(p, -1), 1.0, -1.0).astype(np.float32)
    w = flat.T @ flat
    np.fill_diagonal(w, 0.0)
    return jnp.asarray(w)


def generate_binary_hopfield_network(patterns, a, b, scalar):
    """Binary-pattern variant (`generate_binary_hopfield_network`,
    attractors/mod.rs:577-654): dw[i, j] = (x_i - b)(x_j - a) * scalar,
    zero diagonal.

    NOTE: the reference materializes EVERY off-diagonal edge, including
    zero-weight ones (attractors/mod.rs:645-650) — and zero-weight edges
    still count in the gap-junction input-averaging denominator
    (neuron/mod.rs:722-729).  When wiring a lattice with these weights,
    use a full off-diagonal mask (``~np.eye(n, dtype=bool)``), not
    ``w != 0``, to reproduce the reference dynamics."""
    pats = np.asarray(patterns)
    p, rows, cols = pats.shape
    flat = np.where(pats.reshape(p, -1), 1.0, 0.0).astype(np.float32)
    w = ((flat - b).T @ (flat - a)) * scalar
    np.fill_diagonal(w, 0.0)
    return jnp.asarray(w)


def distort_pattern(pattern, noise_level, key=None, seed=None):
    """Randomly flips pattern bits with probability ``noise_level``
    (`distort_pattern`, attractors/mod.rs:657-678).  Like the reference's
    per-call thread_rng, the default draws FRESH noise each call; pass
    ``seed`` (or ``key``) for reproducibility."""
    pattern = np.asarray(pattern, bool)
    if key is not None:
        flips = np.asarray(jax.random.uniform(key, pattern.shape)) <= noise_level
    else:
        flips = np.random.default_rng(seed).random(pattern.shape) <= noise_level
    return np.where(flips, ~pattern, pattern)


def generate_random_patterns(rows, cols, num_patterns, p_one, seed=0):
    """`generate_random_patterns` (attractors/mod.rs:682-703): i.i.d.
    Bernoulli(p_one) boolean patterns."""
    rng = np.random.default_rng(seed)
    return rng.random((num_patterns, rows, cols)) < p_one


class DiscreteNeuronLattice:
    """Bipolar discrete-neuron lattice (`DiscreteNeuronLattice`,
    attractors/mod.rs:359-462).

    State is a (N,) +/-1 f32 vector; `iterate` computes all inputs from the
    previous state in one matmul then thresholds at zero — the two-phase
    semantic of `DiscreteNeuronLattice::iterate` (:443-461), vectorized.
    """

    def __init__(self, rows, cols, weights=None):
        self.rows, self.cols = rows, cols
        n = rows * cols
        self.state = jnp.full((n,), -1.0, jnp.float32)
        self.weights = (jnp.zeros((n, n), jnp.float32)
                        if weights is None else jnp.asarray(weights))

    @classmethod
    def generate_lattice_from_dimension(cls, rows, cols):
        return cls(rows, cols)

    def input_pattern_into_discrete_grid(self, pattern):
        """`input_pattern_into_discrete_grid` (attractors/mod.rs:398-408)."""
        pat = np.asarray(pattern, bool).reshape(-1)
        if pat.shape[0] != self.rows * self.cols:
            raise ValueError(
                f"pattern has {pat.shape[0]} cells, lattice has "
                f"{self.rows * self.cols}")
        self.state = jnp.where(jnp.asarray(pat), 1.0, -1.0)

    def convert_to_numerics(self):
        return np.asarray(self.state).reshape(self.rows, self.cols).astype(np.int64)

    def convert_to_bools(self):
        return np.asarray(self.state > 0).reshape(self.rows, self.cols)

    def iterate(self, steps=1):
        """SEQUENTIAL in-place sweep: node i's input uses the already-
        updated states of earlier nodes (`DiscreteNeuronLattice::iterate`,
        attractors/mod.rs:443-461; `DiscreteNeuron::update` :280-285,
        input > 0 -> active else inactive).  The reference sweeps in hash
        order; we fix row-major order — for the symmetric Hopfield weights
        this runtime targets, any sequential order descends the energy,
        whereas a synchronous sign(W s) update can 2-cycle forever."""
        self.state = _discrete_iterate(self.weights, self.state, steps)


@jax.jit
def _discrete_step(weights, state):
    def body(i, s):
        # sum_j w[j, i] * s_j, s updated; full float32 (no TF32)
        inp = jnp.dot(s, weights[:, i], precision=jax.lax.Precision.HIGHEST)
        return s.at[i].set(jnp.where(inp > 0.0, 1.0, -1.0))
    return jax.lax.fori_loop(0, state.shape[0], body, state)


def _discrete_iterate(weights, state, steps):
    def body(s, _):
        return _discrete_step(weights, s), None
    state, _ = jax.lax.scan(body, state, None, length=steps)
    return state
