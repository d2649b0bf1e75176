"""R-STDP reward-modulated lattice golden tests."""

import numpy as np
import jax.numpy as jnp

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.ops.graph import DenseGraph
from reference_impl import (RefIzhikevich, TraceW, run_ref_rstdp_lattice, f32)


def test_rstdp_lattice_matches_scalar_reference():
    n_side, iters = 3, 120
    n = n_side * n_side
    rng = np.random.default_rng(11)
    mask = rng.random((n, n)) < 0.5
    np.fill_diagonal(mask, False)
    w0 = rng.uniform(0.5, 1.5, (n, n)).astype(np.float32)
    v_init = rng.uniform(-65, 25, n).astype(np.float32)
    rewards = np.where(np.arange(iters) % 20 < 10, 0.5, -0.2).astype(np.float32)

    lat = snn.RewardModulatedLattice(snn.Izhikevich())
    lat.populate(n_side, n_side, gap_conductance=10.0)
    lat.graph = DenseGraph(jnp.asarray(np.where(mask, w0, 0.0)), jnp.asarray(mask))
    lat._reset_trace()
    lat.apply(lambda s: {**s, "v": jnp.asarray(v_init)})
    lat.update_grid_history = True
    lat.run_lattice_with_reward(jnp.asarray(rewards), iters)

    neurons = []
    for v in v_init:
        nr = RefIzhikevich(gap_conductance=10.0)
        nr.v = f32(v)
        neurons.append(nr)
    weights = [[TraceW(w0[i][j]) if mask[i][j] else None for j in range(n)]
               for i in range(n)]
    p = dict(lat.reward_modulator.params)
    want_v, want_w, want_dop = run_ref_rstdp_lattice(neurons, weights, rewards, p)

    got_v = np.stack(lat.grid_history.history).reshape(iters, n)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(lat.dopamine, want_dop, rtol=1e-4)
    got_w = np.asarray(lat.graph.weights)
    got_c = np.asarray(lat.trace["c"])
    for i in range(n):
        for j in range(n):
            if mask[i][j]:
                np.testing.assert_allclose(got_w[i, j], want_w[i][j].w,
                                           rtol=1e-3, atol=1e-3)
                np.testing.assert_allclose(got_c[i, j], want_w[i][j].c,
                                           rtol=1e-3, atol=1e-4)


def test_rstdp_agent_interface():
    """Environment loop drives a reward-modulated lattice (interactable)."""
    lat = snn.RewardModulatedLattice(snn.Izhikevich())
    lat.populate(2, 2, gap_conductance=10.0, v=jnp.asarray([0., -30., 10., -60.]))
    lat.connect(lambda a, b: a != b)

    class CountingState:
        def __init__(self):
            self.updates = 0

        def update_state(self, agent):
            self.updates += 1

    state = CountingState()
    env = snn.Environment(
        agent=lat, state=state,
        state_encoder=lambda st, ag: None,
        reward_function=lambda st, ag: 0.1)
    env.run_with_reward(25)
    assert state.updates == 25
    assert lat.internal_clock == 25
    assert lat.dopamine != 0.0
