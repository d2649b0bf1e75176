"""Liquid state machine: reservoir dynamics and the separation property.

Port of the reference's liquid pipelines
(`/root/reference/interface/experiments/isolated_liquid_pipeline.py`,
`liquid_custom_manifold_generation.py`): a recurrent Izhikevich "liquid"
driven by Poisson-encoded inputs; we measure the separation property —
liquid states for *different* input patterns should diverge more than states
for *noisy repeats of the same* pattern — which is what makes the reservoir a
useful temporal kernel for readouts.

Run: python experiments/liquid_state_machine.py
"""

from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])

import spiking_neural_networks_jax as snn


def liquid_state(net, liquid, iterations, tau=20.0):
    """Run and return the exponentially filtered spike-count state vector."""
    hist = []
    liquid.grid_history.reset()
    liquid.update_grid_history = True
    net.run_lattices(iterations)
    spikes = (np.stack(liquid.grid_history.history) >= 29.0)  # (T, r, c)
    t = np.arange(spikes.shape[0])[:, None, None]
    weights = np.exp(-(spikes.shape[0] - 1 - t) / tau)
    return (spikes * weights).sum(axis=0).reshape(-1)


def build(seed, pattern, rows=10, cols=10, rate_hz=80.0, liquid_seed=42):
    # the liquid (weights + initial state) is FIXED across conditions; only
    # the input pattern and its Poisson realization vary
    rng = np.random.default_rng(liquid_seed)
    liquid = snn.Lattice(snn.Izhikevich(), id=0)
    liquid.populate(rows, cols, gap_conductance=10.0)
    # sparse random recurrent weights, 20% inhibitory (liquid topology)
    n = rows * cols
    mask = rng.random((n, n)) < 0.1
    np.fill_diagonal(mask, False)
    w = rng.uniform(0.5, 1.5, (n, n)) * np.where(
        rng.random((n, n)) < 0.2, -1.0, 1.0)
    from spiking_neural_networks_jax.ops.graph import DenseGraph
    import jax.numpy as jnp
    liquid.graph = DenseGraph(jnp.asarray(np.where(mask, w, 0.0), jnp.float32),
                              jnp.asarray(mask))
    liquid.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(-65, 20, n), jnp.float32)})

    inp = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(), id=1)
    inp.populate(rows, cols)
    chance = snn.PoissonSpikeTrain.rate_to_chance(rate_hz, 0.1)
    inp.state = dict(inp.state)
    inp.state["chance_of_firing"] = jnp.asarray(
        np.where(pattern.reshape(-1), chance, 0.0), jnp.float32)
    import jax
    inp.key = jax.random.PRNGKey(seed)

    net = snn.LatticeNetwork.generate_network([liquid], [inp])
    net.connect(1, 0, lambda x, y: x == y, lambda x, y: 6.0)
    return net, liquid


def main(iterations=800):
    rng = np.random.default_rng(0)
    pattern_a = rng.random((10, 10)) < 0.3
    pattern_b = rng.random((10, 10)) < 0.3

    def noisy(p, level=0.05, seed=1):
        r = np.random.default_rng(seed)
        return np.where(r.random(p.shape) < level, ~p, p)

    states = {}
    for name, (pattern, seed) in {
        "a1": (pattern_a, 1), "a2": (noisy(pattern_a), 2),
        "b1": (pattern_b, 3), "b2": (noisy(pattern_b), 4),
    }.items():
        net, liquid = build(seed, pattern)
        states[name] = liquid_state(net, liquid, iterations)

    def dist(x, y):
        return float(np.linalg.norm(states[x] - states[y]))

    within = (dist("a1", "a2") + dist("b1", "b2")) / 2
    between = (dist("a1", "b1") + dist("a1", "b2")
               + dist("a2", "b1") + dist("a2", "b2")) / 4
    print(f"within-class distance:  {within:.2f}")
    print(f"between-class distance: {between:.2f}")
    print(f"separation ratio: {between / max(within, 1e-9):.2f} "
          f"({'OK' if between > within else 'WEAK'})")
    return within, between


if __name__ == "__main__":
    main()
