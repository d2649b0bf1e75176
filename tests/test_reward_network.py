"""RewardModulatedLatticeNetwork tests."""

import numpy as np
import jax.numpy as jnp
import pytest

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.ops.graph import DenseGraph


def make_reward_lattice(seed=0, n_side=3, id=0):
    rng = np.random.default_rng(seed)
    n = n_side * n_side
    lat = snn.RewardModulatedLattice(snn.Izhikevich(), id=id)
    lat.populate(n_side, n_side, gap_conductance=10.0)
    mask = rng.random((n, n)) < 0.5
    np.fill_diagonal(mask, False)
    w = rng.uniform(0.5, 1.5, (n, n)).astype(np.float32)
    lat.graph = DenseGraph(jnp.asarray(np.where(mask, w, 0.0)), jnp.asarray(mask))
    lat._reset_trace()
    lat.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(-65, 25, n), jnp.float32)})
    return lat


def test_network_with_single_reward_lattice_matches_standalone():
    iters = 100
    rewards = np.where(np.arange(iters) % 10 < 5, 0.4, -0.1).astype(np.float32)

    solo = make_reward_lattice(seed=7)
    solo.run_lattice_with_reward(jnp.asarray(rewards), iters)

    inner = make_reward_lattice(seed=7)
    net = snn.RewardModulatedLatticeNetwork()
    net.add_lattice(inner)
    net.run_lattices_with_reward(jnp.asarray(rewards), iters)

    np.testing.assert_allclose(np.asarray(inner.state["v"]),
                               np.asarray(solo.state["v"]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(inner.graph.weights),
                               np.asarray(solo.graph.weights),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(inner.trace["c"]),
                               np.asarray(solo.trace["c"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(net.dopamine, solo.dopamine, rtol=1e-5)


def test_mixed_network_with_reward_connection():
    rng = np.random.default_rng(3)
    plain = snn.Lattice(snn.Izhikevich(), id=0)
    plain.populate(3, 3, gap_conductance=10.0)
    plain.connect(lambda a, b: a != b)
    plain.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(-65, 25, 9), jnp.float32)})
    plain.do_plasticity = True

    rlat = make_reward_lattice(seed=5, id=1)
    st = snn.SpikeTrainLattice(snn.RateSpikeTrain(), id=2)
    st.populate(3, 3, rate=1.5)

    net = snn.RewardModulatedLatticeNetwork()
    net.add_lattice(plain)
    net.add_lattice(rlat)
    net.add_spike_train_lattice(st)
    net.connect(2, 0, lambda a, b: a == b, lambda a, b: 5.0)
    net.connect(2, 1, lambda a, b: a == b, lambda a, b: 8.0)  # drive rlat too
    net.connect_with_reward_modulation(0, 1, lambda a, b: a == b,
                                       lambda a, b: 1.0)

    w_plain_before = np.asarray(plain.graph.weights).copy()
    net.run_lattices_with_reward(0.5, 500)

    # plain lattice STDP moved its weights
    assert np.abs(np.asarray(plain.graph.weights) - w_plain_before).max() > 0
    # reward connection traces accumulated and weights moved with dopamine
    src, dst, w, c, dw, ct = net.reward_connections[(0, 1)]
    assert np.abs(c).max() > 0
    assert not np.allclose(w, 1.0)
    assert net.dopamine != 0.0
    # all finite
    for lat in (plain, rlat):
        assert np.isfinite(np.asarray(lat.state["v"])).all()


def test_reward_network_agent_interface():
    rlat = make_reward_lattice(seed=9)
    net = snn.RewardModulatedLatticeNetwork()
    net.add_lattice(rlat)
    env = snn.Environment(
        agent=net, state=type("S", (), {"update_state": lambda self, a: None})(),
        state_encoder=lambda st, ag: None,
        reward_function=lambda st, ag: 0.2)
    env.run_with_reward(10)
    assert net.internal_clock == 10


def _mixed_net(structured, seed=11):
    """Plain plastic lattice (0), reward lattice (1), plain NON-plastic
    lattice (3), spike train (2); plain conns 2->0, 0->3, 3->1 (plain edge
    into a modulated lattice: reward-sweep STDP every step) and reward conns
    0->1 (plastic pre: spiking visits) and 2->1 (spike-train pre)."""
    rng = np.random.default_rng(seed)
    plain = snn.Lattice(snn.Izhikevich(), id=0)
    plain.populate(3, 3, gap_conductance=10.0)
    plain.connect(lambda a, b: a != b)
    plain.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(-65, 25, 9), jnp.float32)})
    plain.do_plasticity = True

    quiet = snn.Lattice(snn.Izhikevich(), id=3)
    quiet.populate(3, 3, gap_conductance=10.0)
    quiet.connect(lambda a, b: a != b)
    quiet.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(-65, 25, 9), jnp.float32)})

    rlat = make_reward_lattice(seed=seed + 1, id=1)
    st = snn.SpikeTrainLattice(snn.RateSpikeTrain(), id=2)
    st.populate(3, 3, rate=1.5)

    net = snn.RewardModulatedLatticeNetwork()
    net.structured = structured
    net.add_lattice(plain)
    net.add_lattice(quiet)
    net.add_lattice(rlat)
    net.add_spike_train_lattice(st)
    net.connect(2, 0, lambda a, b: a == b, lambda a, b: 5.0)
    net.connect(2, 3, lambda a, b: a == b, lambda a, b: 8.0)
    net.connect(0, 3, lambda a, b: a == b, lambda a, b: 0.7)
    net.connect(3, 1, lambda a, b: a == b, lambda a, b: 0.9)
    net.connect_with_reward_modulation(0, 1, lambda a, b: a == b,
                                       lambda a, b: 1.0)
    net.connect_with_reward_modulation(2, 1, lambda a, b: a == b,
                                       lambda a, b: 8.0)
    return net


@pytest.mark.slow
def test_structured_reward_runner_matches_flat():
    """The structure-preserving reward runner computes exactly what the flat
    COO runner computes (states, weights, traces, dopamine)."""
    iters = 120
    rewards = np.where(np.arange(iters) % 7 < 4, 0.4, -0.2).astype(np.float32)

    flat = _mixed_net(structured=False)
    flat.run_lattices_with_reward(jnp.asarray(rewards), iters)
    stru = _mixed_net(structured=True)
    stru.run_lattices_with_reward(jnp.asarray(rewards), iters)

    for i in (0, 3):
        np.testing.assert_allclose(
            np.asarray(stru.get_lattice(i).state["v"]),
            np.asarray(flat.get_lattice(i).state["v"]),
            rtol=1e-5, atol=1e-4, err_msg=f"lat{i} v")
        np.testing.assert_allclose(
            np.asarray(stru.get_lattice(i).graph.weights),
            np.asarray(flat.get_lattice(i).graph.weights),
            rtol=1e-5, atol=1e-4, err_msg=f"lat{i} w")
    r_f = flat.get_reward_modulated_lattice(1)
    r_s = stru.get_reward_modulated_lattice(1)
    np.testing.assert_allclose(np.asarray(r_s.state["v"]),
                               np.asarray(r_f.state["v"]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(r_s.graph.weights),
                               np.asarray(r_f.graph.weights),
                               rtol=1e-4, atol=1e-4)
    for k in ("c", "dw"):
        np.testing.assert_allclose(np.asarray(r_s.trace[k]),
                                   np.asarray(r_f.trace[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"trace {k}")
    np.testing.assert_array_equal(np.asarray(r_s.trace["counter"]),
                                  np.asarray(r_f.trace["counter"]))
    np.testing.assert_allclose(stru.dopamine, flat.dopamine, rtol=1e-5)

    for key in flat.connections:
        wf = flat.connections[key][2]
        ws = stru.connections[key][2]
        np.testing.assert_allclose(ws, wf, rtol=1e-5, atol=1e-4,
                                   err_msg=f"conn {key}")
    for key in flat.reward_connections:
        for f, s, nm in zip(flat.reward_connections[key][2:],
                            stru.reward_connections[key][2:],
                            ("w", "c", "dw", "ct")):
            np.testing.assert_allclose(np.asarray(s, np.float32),
                                       np.asarray(f, np.float32),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"rconn {key} {nm}")


@pytest.mark.parametrize("structured", [False, True])
def test_plain_edge_into_modulated_lattice_gets_stdp(structured):
    """A plain Weight edge whose postsynaptic side is a modulated reward
    lattice receives STDP every step (reference reward sweep,
    mod.rs:4868-4898) — even though NO lattice has do_plasticity — while
    never receiving dopamine-trace updates."""
    net = _mixed_net(structured=structured)
    net.get_lattice(0).do_plasticity = False
    w_before = net.connections[(3, 1)][2].copy()
    q_before = np.asarray(net.get_lattice(3).graph.weights).copy()
    net.run_lattices_with_reward(0.5, 300)
    # edge 3->1: post is modulated, pre is plain -> STDP applied per step
    assert np.abs(net.connections[(3, 1)][2] - w_before).max() > 0
    # intra edges of the non-plastic plain lattice never move
    np.testing.assert_array_equal(
        np.asarray(net.get_lattice(3).graph.weights), q_before)


def test_reward_network_connecting_graph_history():
    """update_connecting_graph_history on a reward network records the
    per-step edge weights (falls back to the flat runner)."""
    net = _mixed_net(structured=True)  # history forces the flat path anyway
    net.update_connecting_graph_history = True
    net.run_lattices_with_reward(0.4, 30)
    assert len(net.connecting_graph_history) == 30
    assert np.isfinite(net.connecting_graph_history[-1]).all()
