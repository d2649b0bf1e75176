"""Regressions for review findings on the reward/per-edge paths."""

import numpy as np
import pytest
import jax.numpy as jnp

import spiking_neural_networks_jax as snn


def test_sparse_trace_follows_edges_on_edit():
    """SparseGraph edits re-sort the COO edge list; eligibility traces must
    follow their (src, dst) pair (were positionally misaligned)."""
    lat = snn.RewardModulatedLattice(snn.Izhikevich())
    lat.populate(2, 2, gap_conductance=10.0)
    # three edges in a known order
    for k, (pre, post) in enumerate([((0, 1), (0, 0)), ((1, 0), (0, 1)),
                                     ((1, 1), (1, 0))]):
        lat.edit_weight(pre, post, 1.0 + k)
    # hand-write distinguishable traces per edge
    lat.trace = dict(
        c=jnp.asarray(np.array([10.0, 20.0, 30.0], np.float32)),
        dw=jnp.asarray(np.array([1.0, 2.0, 3.0], np.float32)),
        counter=jnp.zeros(3, jnp.int32))
    src0 = np.asarray(lat.graph.src).copy()
    dst0 = np.asarray(lat.graph.dst).copy()
    c_by_edge = {(int(s), int(d)): float(c)
                 for s, d, c in zip(src0, dst0, np.asarray(lat.trace["c"]))}
    # add an edge that sorts BEFORE the existing ones
    lat.edit_weight((0, 0), (1, 1), 9.0)
    for s, d, c in zip(np.asarray(lat.graph.src), np.asarray(lat.graph.dst),
                       np.asarray(lat.trace["c"])):
        expected = c_by_edge.get((int(s), int(d)), 0.0)
        assert float(c) == expected, (int(s), int(d), float(c), expected)
    # remove an edge: no crash, and the remaining traces still line up
    lat.edit_weight((0, 1), (0, 0), None)
    for s, d, c in zip(np.asarray(lat.graph.src), np.asarray(lat.graph.dst),
                       np.asarray(lat.trace["c"])):
        expected = c_by_edge.get((int(s), int(d)), 0.0)
        assert float(c) == expected


def _reward_net():
    rlat = snn.RewardModulatedLattice(snn.Izhikevich(), id=0)
    rlat.populate(2, 2, gap_conductance=10.0)
    rlat.connect_stencil(radius=1.0, seed=1)
    plain = snn.Lattice(snn.Izhikevich(), id=1)
    plain.populate(2, 2, gap_conductance=10.0)
    plain.connect_stencil(radius=1.0, seed=2)
    net = snn.RewardModulatedLatticeNetwork()
    net.add_lattice(rlat)
    net.add_lattice(plain)
    net.connect_with_reward_modulation(1, 0, lambda a, b: a == b,
                                       lambda a, b: 1.5)
    return net


def test_network_per_edge_api_covers_reward_edges():
    """lookup_weight sees reward-modulated connecting edges; edit_weight
    edits them in place (was silently adding a duplicate plain edge)."""
    net = _reward_net()
    assert net.lookup_weight((1, (0, 0)), (0, (0, 0))) == 1.5
    net.edit_weight((1, (0, 0)), (0, (0, 0)), 7.0)
    assert net.lookup_weight((1, (0, 0)), (0, (0, 0))) == 7.0
    assert (1, 0) not in net.connections, "duplicate plain edge created"
    assert float(net.reward_connections[(1, 0)][2][0]) == 7.0 or \
        7.0 in [float(x) for x in net.reward_connections[(1, 0)][2]]
    # incoming connections include the reward edge and the intra edges of
    # the reward lattice itself
    incoming = net.get_incoming_connections((0, (0, 1)))
    assert (1, (0, 1)) in incoming
    assert any(lid == 0 for lid, _ in incoming), "intra edges missing"
    # same-lattice query on the reward lattice does not crash
    w = net.lookup_weight((0, (0, 0)), (0, (0, 1)))
    assert w is None or isinstance(w, float)


def test_flat_reward_path_records_graph_history_and_bumps_version():
    """The flat fallback (forced via update_connecting_graph_history) must
    record per-lattice graph histories and invalidate the cached
    structured plan on write-back."""
    net = _reward_net()
    plain = net.get_lattice(1)
    plain.do_plasticity = True
    plain.update_graph_history = True
    rng = np.random.default_rng(0)
    v0 = rng.uniform(-65, 40, 4).astype(np.float32)
    plain.apply(lambda s: {**s, "v": jnp.asarray(v0)})
    net.update_connecting_graph_history = True  # forces the flat path
    v_before = net._conn_version
    net.run_lattices_with_reward(0.5, 5)
    assert len(plain.graph_history) == 5, "flat path dropped graph history"
    assert len(net.connecting_graph_history) == 5
    assert net._conn_version > v_before, \
        "flat write-back did not invalidate the structured plan cache"


@pytest.mark.slow
def test_reward_lattice_chunked_history():
    """Reward-lattice history runs are chunked at history_chunk with a
    seamless trajectory."""
    def build():
        lat = snn.RewardModulatedLattice(snn.Izhikevich())
        lat.populate(4, 4, gap_conductance=10.0)
        lat.connect_stencil(radius=1.0, seed=3)
        lat.update_grid_history = True
        v0 = np.random.default_rng(1).uniform(-65, 40, 16).astype(np.float32)
        lat.apply(lambda s: {**s, "v": jnp.asarray(v0)})
        return lat

    a = build()
    b = build()
    b.history_chunk = 7
    a.run_lattice_with_reward(0.3, 30)
    b.run_lattice_with_reward(0.3, 30)
    ha = np.stack(a.grid_history.history)
    hb = np.stack(b.grid_history.history)
    assert ha.shape == hb.shape == (30, 4, 4)
    np.testing.assert_array_equal(ha, hb)
    np.testing.assert_array_equal(np.asarray(a.state["v"]),
                                  np.asarray(b.state["v"]))


def test_reward_network_checkpoint_roundtrip(tmp_path):
    """save_network/load_network must carry reward lattices (state +
    traces + dopamine) and reward connections (were silently dropped);
    extensionless paths round-trip too."""
    from spiking_neural_networks_jax.utils.checkpoint import (load_network,
                                                              save_network)
    net = _reward_net()
    plain = net.get_lattice(1)
    rng = np.random.default_rng(3)
    v0 = rng.uniform(-65, 40, 4).astype(np.float32)
    plain.apply(lambda s: {**s, "v": jnp.asarray(v0)})
    net.run_lattices_with_reward(0.6, 25)
    path = tmp_path / "ckpt"           # extensionless on purpose
    save_network(net, str(path))

    fresh = _reward_net()
    load_network(fresh, str(path))
    rl_a = net.get_reward_modulated_lattice(0)
    rl_b = fresh.get_reward_modulated_lattice(0)
    np.testing.assert_array_equal(np.asarray(rl_a.state["v"]),
                                  np.asarray(rl_b.state["v"]))
    for f in ("c", "dw", "counter"):
        np.testing.assert_array_equal(np.asarray(rl_a.trace[f]),
                                      np.asarray(rl_b.trace[f]))
    assert rl_a.dopamine == rl_b.dopamine
    assert fresh.dopamine == net.dopamine
    a = net.reward_connections[(1, 0)]
    b = fresh.reward_connections[(1, 0)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # the restored network continues identically
    net.run_lattices_with_reward(0.6, 25)
    fresh.run_lattices_with_reward(0.6, 25)
    np.testing.assert_allclose(
        np.asarray(net.get_lattice(1).state["v"]),
        np.asarray(fresh.get_lattice(1).state["v"]), rtol=1e-6, atol=1e-6)


def test_chemical_coupled_fitting_summary():
    """Chemical coupled trials (fitting/mod.rs iterate_coupled_* with
    neurotransmission) run and produce finite summaries; the paired state
    keeps the neurotransmitter type axis LAST (was crossed with the pair
    axis and crashed)."""
    from spiking_neural_networks_jax.fitting.fitting import (
        get_reference_summary)
    m = snn.Izhikevich()
    s = m.init_state(1)
    s = m.insert_receptor(s, "AMPA")
    s = m.insert_neurotransmitter(s, "AMPA")
    stm = snn.PoissonSpikeTrain()
    sts = stm.init_from_firing_rate(1, hertz=100.0, dt=0.1)
    out = get_reference_summary(m, s, stm, sts, iterations=100,
                                chemical=True)
    assert out.shape == (1, 4)
    assert np.isfinite(np.asarray(out)).all()


def test_empty_reward_connection_runs():
    """connect_with_reward_modulation matching no pairs must not crash the
    structured runner (EmptyBlock had no reward-visit guard)."""
    net = _reward_net()
    net.reward_connections.clear()
    net.connect_with_reward_modulation(1, 0, lambda a, b: False,
                                       lambda a, b: 1.0)
    net.run_lattices_with_reward(0.5, 10)
    assert net.internal_clock == 10


def test_jit_environment_zero_iterations():
    """run_with_reward(0) must return an empty reward array (the chunk
    loop never runs; np.concatenate([]) crashed)."""
    from spiking_neural_networks_jax.interactable import JitEnvironment
    lat = snn.RewardModulatedLattice(snn.Izhikevich())
    lat.populate(2, 2, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5, seed=0)
    env = JitEnvironment(lat, {"x": jnp.float32(0.0)},
                         lambda e, s: s,
                         lambda e, s: jnp.float32(0.0),
                         lambda e, s: e)
    out = env.run_with_reward(0)
    assert out.shape == (0,)
    assert lat.internal_clock == 0
