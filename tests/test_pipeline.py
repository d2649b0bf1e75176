"""Pipeline-parallel chain execution (parallel/pipeline.py) vs the
structured single-mesh runner — same network, two execution strategies.

The pipelined path must reproduce `run_lattices` semantics (the reference's
two-phase network step, neuron/mod.rs:2420-2476) with one lattice per
device and ppermute-delivered inter-stage fields."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.parallel import (make_pipeline_mesh,
                                                  run_pipelined)
from spiking_neural_networks_jax.errors import LatticeNetworkError


def _chain(stages=4, rows=8, cols=8, plastic=(), chemical=False, seed=0,
           history=False, stagger=False):
    rng = np.random.default_rng(seed)
    lats = []
    for k in range(stages):
        lat = snn.Lattice(snn.Izhikevich(), id=k)
        lat.populate(rows, cols, gap_conductance=10.0)
        lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=seed + k)
        v0 = rng.uniform(-65.0, 30.0, rows * cols)
        v0[rng.permutation(rows * cols)[:8]] = 40.0  # spike at t=0
        lat.apply(lambda s: {**s, "v": jnp.asarray(v0, jnp.float32)})
        if stagger:
            # spike-history offsets so STDP time diffs are nonzero from the
            # first visit (t_pre != t_post)
            lft = np.full(rows * cols, -1, np.int32)
            lft[::2] = 3
            v1 = np.asarray(v0)
            v1[1::2] = 40.0
            lat.apply(lambda s: {**s,
                                 "v": jnp.asarray(v1, jnp.float32),
                                 "last_firing_time": jnp.asarray(lft)})
        lat.do_plasticity = k in plastic
        lat.update_grid_history = history
        if chemical:
            s = lat.state
            for t in ("AMPA", "GABA"):
                s = lat.model.insert_receptor(s, t)
                s = lat.model.insert_neurotransmitter(s, t)
            lat.state = s
        lats.append(lat)
    net = snn.LatticeNetwork.generate_network(lats, [])
    for k in range(stages - 1):
        net.connect(k, k + 1, lambda a, b: a == b, lambda a, b: 3.0)
    net.chemical_synapse = chemical
    net.electrical_synapse = not chemical
    return net


def _mesh(stages):
    return make_pipeline_mesh(stages, devices=jax.devices()[:stages])


def test_pipeline_matches_structured_electrical():
    a = _chain(stages=4, seed=3)
    b = _chain(stages=4, seed=3)
    a.run_lattices(200)
    run_pipelined(b, 200, mesh=_mesh(4))
    total_fired = 0
    for k in range(4):
        va = np.asarray(a.get_lattice(k).state["v"])
        vb = np.asarray(b.get_lattice(k).state["v"])
        np.testing.assert_allclose(va, vb, rtol=2e-5, atol=2e-4)
        fa = np.asarray(a.get_lattice(k).state["last_firing_time"])
        fb = np.asarray(b.get_lattice(k).state["last_firing_time"])
        total_fired += int((fa >= 0).sum())
        assert ((fa >= 0) == (fb >= 0)).mean() > 0.99
    assert total_fired > 0, "vacuous: no spikes anywhere in the chain"


def test_pipeline_ships_lazy_host_states():
    """run_pipelined must ship lazily-populated host states before
    consuming them (the run-entry-point invariant; utils/transfer)."""
    from spiking_neural_networks_jax.utils.transfer import state_is_host

    a = _chain(stages=2, seed=9)
    b = _chain(stages=2, seed=9)
    for k in range(2):
        lat = b.get_lattice(k)
        # convert to the lazy-host form lixirnet.populate now produces
        lat.state = {key: np.asarray(v) for key, v in lat.state.items()}
        assert state_is_host(lat.state)
    a.run_lattices(50)
    run_pipelined(b, 50, mesh=_mesh(2))
    for k in range(2):
        assert not state_is_host(b.get_lattice(k).state)
        np.testing.assert_allclose(
            np.asarray(a.get_lattice(k).state["v"]),
            np.asarray(b.get_lattice(k).state["v"]), rtol=2e-5, atol=2e-4)


@pytest.mark.slow
def test_pipeline_plasticity_matches_structured():
    a = _chain(stages=3, plastic=(0, 2), seed=5, stagger=True)
    b = _chain(stages=3, plastic=(0, 2), seed=5, stagger=True)
    a.run_lattices(150)
    run_pipelined(b, 150, mesh=_mesh(3))
    # intra-lattice weights evolved identically (stage 0 and 2 plastic)
    for k in (0, 2):
        wa = np.asarray(a.get_lattice(k).graph.weights)
        wb = np.asarray(b.get_lattice(k).graph.weights)
        assert not np.array_equal(wa, np.asarray(
            _chain(stages=3, plastic=(0, 2), seed=5, stagger=True)
            .get_lattice(k).graph.weights)), "vacuous: no weight change"
        np.testing.assert_allclose(wa, wb, rtol=2e-4, atol=2e-4)
    # non-plastic stage untouched
    w1a = np.asarray(a.get_lattice(1).graph.weights)
    w1b = np.asarray(b.get_lattice(1).graph.weights)
    np.testing.assert_array_equal(w1a, w1b)
    # connecting-edge weights (pre- or post-plastic links are updated)
    for key in ((0, 1), (1, 2)):
        _, _, wa = a.connections[key]
        _, _, wb = b.connections[key]
        np.testing.assert_allclose(np.asarray(wa), np.asarray(wb),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.slow
def test_pipeline_chemical_chain():
    a = _chain(stages=2, chemical=True, seed=7)
    b = _chain(stages=2, chemical=True, seed=7)
    a.run_lattices(100)
    run_pipelined(b, 100, mesh=_mesh(2))
    for k in range(2):
        np.testing.assert_allclose(
            np.asarray(a.get_lattice(k).state["v"]),
            np.asarray(b.get_lattice(k).state["v"]), rtol=2e-5, atol=2e-4)


def test_pipeline_grid_history():
    a = _chain(stages=2, seed=9, history=True)
    b = _chain(stages=2, seed=9, history=True)
    a.run_lattices(50)
    run_pipelined(b, 50, mesh=_mesh(2))
    for k in range(2):
        ha = np.stack(a.get_lattice(k).grid_history.history)
        hb = np.stack(b.get_lattice(k).grid_history.history)
        assert ha.shape == hb.shape == (50, 8, 8)
        np.testing.assert_allclose(ha, hb, rtol=2e-5, atol=2e-4)


def test_pipeline_rejects_non_chain():
    net = _chain(stages=3, seed=1)
    net.connect(2, 0, lambda a, b: a == b, lambda a, b: 1.0)  # cycle edge
    with pytest.raises(LatticeNetworkError):
        run_pipelined(net, 10, mesh=_mesh(3))


def test_pipeline_clock_and_repeat_runs():
    net = _chain(stages=2, seed=11)
    mesh = _mesh(2)
    run_pipelined(net, 60, mesh=mesh)
    run_pipelined(net, 60, mesh=mesh)
    assert net.internal_clock == 120
    assert net.get_lattice(0).internal_clock == 120


def test_pipeline_chunked_history_matches_unchunked():
    """History runs are chunked at net.history_chunk like run_lattices;
    chunk boundaries must be seamless (same trajectory, concatenated
    history)."""
    a = _chain(stages=2, seed=13, history=True)
    b = _chain(stages=2, seed=13, history=True)
    b.history_chunk = 16  # force 4 chunks of a 50-step run
    mesh = _mesh(2)
    run_pipelined(a, 50, mesh=mesh)
    run_pipelined(b, 50, mesh=mesh)
    assert b.internal_clock == 50
    for k in range(2):
        ha = np.stack(a.get_lattice(k).grid_history.history)
        hb = np.stack(b.get_lattice(k).grid_history.history)
        assert hb.shape == (50, 8, 8)
        np.testing.assert_allclose(ha, hb, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(a.get_lattice(k).state["v"]),
            np.asarray(b.get_lattice(k).state["v"]), rtol=1e-6, atol=1e-6)


def test_pipeline_rejects_reward_networks():
    """Reward-modulated machinery must be rejected, not silently dropped."""
    rnet = snn.RewardModulatedLatticeNetwork()
    for k in range(2):
        lat = snn.Lattice(snn.Izhikevich(), id=k)
        lat.populate(4, 4, gap_conductance=10.0)
        lat.connect_stencil(radius=1.0, seed=k)
        rnet.add_lattice(lat)
    rnet.connect_with_reward_modulation(0, 1, lambda a_, b_: a_ == b_,
                                        lambda a_, b_: 1.0)
    with pytest.raises(LatticeNetworkError):
        run_pipelined(rnet, 10, mesh=_mesh(2))


# ---------------------------------------------------------------------------
# Reward-modulated (R-STDP) pipelines (VERDICT r2 item 8)
# ---------------------------------------------------------------------------

from spiking_neural_networks_jax.parallel import run_pipelined_with_reward


def _reward_chain(stages=4, rows=6, cols=6, seed=0, mixed=False,
                  history=False):
    """Chain of RewardModulatedLattices (or, with mixed=True, alternating
    reward/plain-plastic stages) linked by reward-modulated edges (plain
    edges into plain stages when mixed)."""
    rng = np.random.default_rng(seed)
    net = snn.RewardModulatedLatticeNetwork()
    for k in range(stages):
        plain = mixed and (k % 2 == 1)
        if plain:
            lat = snn.Lattice(snn.Izhikevich(), id=k)
        else:
            lat = snn.RewardModulatedLattice(snn.Izhikevich(), id=k)
        lat.populate(rows, cols, gap_conductance=10.0)
        lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=seed + k)
        v0 = rng.uniform(-65.0, 30.0, rows * cols)
        v0[rng.permutation(rows * cols)[:6]] = 40.0
        lft = np.full(rows * cols, -1, np.int32)
        lft[::2] = 2  # stagger so STDP deltas are nonzero early
        lat.apply(lambda s: {**s, "v": jnp.asarray(v0, jnp.float32),
                             "last_firing_time": jnp.asarray(lft)})
        lat.update_grid_history = history
        if plain:
            lat.do_plasticity = True
            net.add_lattice(lat)
        else:
            net.add_reward_modulated_lattice(lat)
    for k in range(stages - 1):
        post_plain = mixed and ((k + 1) % 2 == 1)
        if post_plain:
            net.connect(k, k + 1, lambda a, b: a == b, lambda a, b: 2.0)
        else:
            net.connect_with_reward_modulation(
                k, k + 1, lambda a, b: a == b, lambda a, b: 2.0)
    return net


def _reward_lat(net, k):
    return (net.reward_modulated_lattices.get(k) or net.lattices[k])


@pytest.mark.slow
def test_reward_pipeline_matches_structured():
    stages = 4
    a = _reward_chain(stages=stages, seed=11)
    b = _reward_chain(stages=stages, seed=11)
    a.run_lattices_with_reward(0.4, 120)
    run_pipelined_with_reward(b, 0.4, 120, mesh=_mesh(stages))

    assert abs(a.dopamine - b.dopamine) < 1e-5
    fired = 0
    for k in range(stages):
        la, lb = _reward_lat(a, k), _reward_lat(b, k)
        np.testing.assert_allclose(np.asarray(la.state["v"]),
                                   np.asarray(lb.state["v"]),
                                   rtol=2e-5, atol=2e-4, err_msg=f"v {k}")
        np.testing.assert_array_equal(
            np.asarray(la.state["last_firing_time"]),
            np.asarray(lb.state["last_firing_time"]))
        fired += int((np.asarray(la.state["last_firing_time"]) >= 0).sum())
        wa = np.asarray(la.graph.weights)
        wb = np.asarray(lb.graph.weights)
        np.testing.assert_allclose(wa, wb, rtol=2e-4, atol=2e-4,
                                   err_msg=f"intra weights {k}")
        for f in ("c", "dw", "counter"):
            np.testing.assert_allclose(np.asarray(la.trace[f]),
                                       np.asarray(lb.trace[f]),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"trace[{f}] {k}")
    assert fired > 0, "vacuous: no spikes anywhere"
    # modulation actually changed weights
    fresh = _reward_chain(stages=stages, seed=11)
    w0 = np.asarray(_reward_lat(fresh, 0).graph.weights)
    assert not np.array_equal(np.asarray(_reward_lat(a, 0).graph.weights),
                              w0), "vacuous: R-STDP changed nothing"
    # reward connecting edges: weights + traces agree
    for k in range(stages - 1):
        ca = a.reward_connections[(k, k + 1)]
        cb = b.reward_connections[(k, k + 1)]
        for fa, fb in zip(ca[2:], cb[2:]):
            np.testing.assert_allclose(np.asarray(fa), np.asarray(fb),
                                       rtol=2e-4, atol=2e-4)


@pytest.mark.slow
def test_reward_pipeline_mixed_stages_matches_structured():
    """Alternating reward/plain-plastic stages with mixed edge kinds."""
    stages = 4
    a = _reward_chain(stages=stages, seed=13, mixed=True)
    b = _reward_chain(stages=stages, seed=13, mixed=True)
    a.run_lattices_with_reward(0.5, 100)
    run_pipelined_with_reward(b, 0.5, 100, mesh=_mesh(stages))

    assert abs(a.dopamine - b.dopamine) < 1e-5
    for k in range(stages):
        la, lb = _reward_lat(a, k), _reward_lat(b, k)
        np.testing.assert_allclose(np.asarray(la.state["v"]),
                                   np.asarray(lb.state["v"]),
                                   rtol=2e-5, atol=2e-4, err_msg=f"v {k}")
        np.testing.assert_allclose(np.asarray(la.graph.weights),
                                   np.asarray(lb.graph.weights),
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"intra weights {k}")
    for link, conn in a.connections.items():
        np.testing.assert_allclose(np.asarray(conn[2]),
                                   np.asarray(b.connections[link][2]),
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"plain conn {link}")
    for link, conn in a.reward_connections.items():
        for fa, fb in zip(conn[2:], b.reward_connections[link][2:]):
            np.testing.assert_allclose(np.asarray(fa), np.asarray(fb),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"reward conn {link}")


@pytest.mark.slow
def test_reward_pipeline_grid_history():
    stages = 3
    a = _reward_chain(stages=stages, seed=17, history=True)
    b = _reward_chain(stages=stages, seed=17, history=True)
    a.run_lattices_with_reward(0.3, 60)
    run_pipelined_with_reward(b, 0.3, 60, mesh=_mesh(stages))
    for k in range(stages):
        ha = np.stack(_reward_lat(a, k).grid_history.history)
        hb = np.stack(_reward_lat(b, k).grid_history.history)
        assert ha.shape == hb.shape == (60, 6, 6)
        np.testing.assert_allclose(ha, hb, rtol=2e-5, atol=2e-4)


def test_reward_pipeline_zero_iterations():
    """iterations=0 with grid histories on: the chunk loop never runs and
    hist_parts stays empty (np.concatenate([]) crashed)."""
    net = _reward_chain(stages=2, history=True)
    run_pipelined_with_reward(net, 0.4, 0, mesh=_mesh(2))
    assert net.internal_clock == 0
    run_pipelined(_chain(stages=2, history=True), 0, mesh=_mesh(2))
