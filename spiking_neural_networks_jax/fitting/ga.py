"""Genetic algorithm over bitstring chromosomes, fully vectorized.

JAX rebuild of `reference/backend/src/ga/mod.rs`: the population
is a (n_pop, total_bits) bit array; crossover, mutation, and tournament
selection are batched `jax.random` ops, and the objective evaluates the whole
population at once (replacing the reference's rayon `par_iter`, ga/mod.rs:233)
— the entire generation's simulations run as one vmapped program.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


class GeneticAlgorithmParameters:
    """`GeneticAlgorithmParameters` (ga/mod.rs:157-190)."""

    def __init__(self, bounds=((0.0, 1.0),), n_bits=8, n_iter=100, n_pop=100,
                 r_cross=0.9, r_mut=0.1, k=3):
        self.bounds = tuple(map(tuple, bounds))
        self.n_bits = n_bits
        self.n_iter = n_iter
        self.n_pop = n_pop
        self.r_cross = r_cross
        self.r_mut = r_mut
        self.k = k
        if n_pop % 2 != 0:
            raise ValueError("population must be even")


def decode_population(bits, bounds, n_bits):
    """`decode` (ga/mod.rs:105-140): each n_bits substring -> integer ->
    scaled into its (min, max) bound.  bits: (..., n_params * n_bits) in
    {0, 1}; returns (..., n_params) f32."""
    bounds = jnp.asarray(bounds, jnp.float32)
    n_params = bounds.shape[0]
    b = bits.reshape(bits.shape[:-1] + (n_params, n_bits))
    weights = 2 ** jnp.arange(n_bits - 1, -1, -1, dtype=jnp.float32)
    ints = jnp.sum(b.astype(jnp.float32) * weights, axis=-1)
    maximum = 2.0 ** n_bits - 1.0
    lo, hi = bounds[:, 0], bounds[:, 1]
    return lo + (ints / maximum) * (hi - lo)


def _selection(key, scores, n_pop, k):
    """Tournament selection (ga/mod.rs:84-100), batched: for each slot draw k
    random candidates and keep the lowest-scoring one."""
    idx = jax.random.randint(key, (n_pop, k), 0, n_pop)
    cand_scores = scores[idx]
    winners = idx[jnp.arange(n_pop), jnp.argmin(cand_scores, axis=1)]
    return winners


def _crossover_mutate(key, parents, r_cross, r_mut):
    """Single-point crossover per pair + i.i.d. bit-flip mutation
    (ga/mod.rs:51-81), batched."""
    n_pop, total_bits = parents.shape
    k1, k2, k3 = jax.random.split(key, 3)
    pairs = parents.reshape(n_pop // 2, 2, total_bits)
    do_cross = jax.random.uniform(k1, (n_pop // 2, 1)) <= r_cross
    points = jax.random.randint(k2, (n_pop // 2, 1), 1, total_bits)
    pos = jnp.arange(total_bits)[None, :]
    take_second = (pos >= points) & do_cross
    child1 = jnp.where(take_second, pairs[:, 1], pairs[:, 0])
    child2 = jnp.where(take_second, pairs[:, 0], pairs[:, 1])
    children = jnp.stack([child1, child2], axis=1).reshape(n_pop, total_bits)
    flips = jax.random.uniform(k3, children.shape) <= r_mut
    return jnp.where(flips, 1 - children, children)


def genetic_algo(objective, params, key=None, verbose=False):
    """`genetic_algo` (ga/mod.rs:203-272).

    ``objective(decoded)`` takes the decoded (n_pop, n_params) array and
    returns (n_pop,) scores to MINIMIZE.  Returns (best_params, best_score,
    all_scores)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    bounds = jnp.asarray(params.bounds, jnp.float32)
    total_bits = params.n_bits * len(params.bounds)

    key, sub = jax.random.split(key)
    pop = jax.random.randint(sub, (params.n_pop, total_bits), 0, 2,
                             dtype=jnp.int32)

    best = None
    best_eval = jnp.inf
    all_scores = []

    for gen in range(params.n_iter):
        decoded = decode_population(pop, bounds, params.n_bits)
        scores = jnp.asarray(objective(decoded))
        all_scores.append(np.asarray(scores))
        gen_best = int(jnp.argmin(scores))
        if float(scores[gen_best]) < float(best_eval):
            best_eval = scores[gen_best]
            best = decoded[gen_best]
            if verbose:
                print(f"gen {gen + 1}: new best score {float(best_eval):.6f}")
        key, ks, kc = jax.random.split(key, 3)
        winners = _selection(ks, scores, params.n_pop, params.k)
        pop = _crossover_mutate(kc, pop[winners], params.r_cross, params.r_mut)

    return np.asarray(best), float(best_eval), all_scores
