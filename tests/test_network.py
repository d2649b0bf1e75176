"""LatticeNetwork golden tests vs the scalar network simulator (mirrors the
reference's network tests: spike_train_neuron_interaction.rs,
rate_spike_train_lattices.rs, gpu_connection_behavior.rs)."""

import numpy as np
import jax.numpy as jnp
import pytest

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.ops.graph import DenseGraph
from reference_impl import (
    RefIzhikevich, RefRateSpikeTrain, run_ref_network, f32, AMPA, NMDA)
import reference_impl as RI


def build_network(chemical=False, plasticity=False, seed=0):
    """2 Izhikevich lattices (2x2) + 1 rate spike-train lattice (2x2),
    intra connections in both lattices, 0->1 and 1->0 inter edges,
    spike-train -> lattice 0 edges.  Returns (network, scalar replicas)."""
    rng = np.random.default_rng(seed)
    n_per = 4

    # ---- framework ----
    lat0 = snn.Lattice(snn.Izhikevich(), id=0)
    lat0.populate(2, 2, gap_conductance=10.0)
    lat1 = snn.Lattice(snn.Izhikevich(), id=1)
    lat1.populate(2, 2, gap_conductance=10.0)

    v0 = rng.uniform(-65, 25, n_per).astype(np.float32)
    v1 = rng.uniform(-65, 25, n_per).astype(np.float32)
    lat0.apply(lambda s: {**s, "v": jnp.asarray(v0)})
    lat1.apply(lambda s: {**s, "v": jnp.asarray(v1)})

    intra0 = rng.random((n_per, n_per)) < 0.7
    np.fill_diagonal(intra0, False)
    w_intra0 = rng.uniform(0.5, 1.5, (n_per, n_per)).astype(np.float32)
    intra1 = rng.random((n_per, n_per)) < 0.7
    np.fill_diagonal(intra1, False)
    w_intra1 = rng.uniform(0.5, 1.5, (n_per, n_per)).astype(np.float32)
    lat0.graph = DenseGraph(jnp.asarray(np.where(intra0, w_intra0, 0.0)),
                            jnp.asarray(intra0))
    lat1.graph = DenseGraph(jnp.asarray(np.where(intra1, w_intra1, 0.0)),
                            jnp.asarray(intra1))

    st = snn.SpikeTrainLattice(snn.RateSpikeTrain(), id=2)
    st.populate(2, 2, rate=2.0, v_th=30.0)

    if chemical:
        for lat in (lat0, lat1):
            s = lat.state
            s = lat.model.insert_receptor(s, "AMPA")
            s = lat.model.insert_receptor(s, "NMDA")
            s = lat.model.insert_neurotransmitter(s, "AMPA")
            s = lat.model.insert_neurotransmitter(s, "NMDA")
            lat.state = s
        st.state = st.model.insert_neurotransmitter(st.state, "AMPA")

    if plasticity:
        lat0.do_plasticity = True
        lat1.do_plasticity = True

    net = snn.LatticeNetwork.generate_network([lat0, lat1], [st])
    net.chemical_synapse = chemical

    def one_to_one(a, b):
        return a == b

    def cross(a, b):
        return (a[0] + b[0]) % 2 == 0

    net.connect(0, 1, one_to_one, lambda a, b: 1.2)
    net.connect(1, 0, cross, lambda a, b: 0.8)
    net.connect(2, 0, one_to_one, lambda a, b: 2.0)

    # ---- scalar replica ----
    neurons = []
    for v in list(v0) + list(v1):
        nr = RefIzhikevich(gap_conductance=10.0)
        nr.v = f32(v)
        if chemical:
            nr.receptors = RI.ReceptorSet((AMPA, NMDA), "approximate")
            nr.nts = RI.NTSet((AMPA, NMDA), "approximate")
        neurons.append(nr)
    sts = []
    for _ in range(n_per):
        s = RefRateSpikeTrain(rate=2.0, nt_kinds=(AMPA,) if chemical else ())
        sts.append(s)

    m = 2 * n_per + n_per
    weights = [[None] * (2 * n_per) for _ in range(m)]
    pos = [(r, c) for r in range(2) for c in range(2)]
    for i in range(n_per):
        for j in range(n_per):
            if intra0[i, j]:
                weights[i][j] = float(w_intra0[i, j])
            if intra1[i, j]:
                weights[n_per + i][n_per + j] = float(w_intra1[i, j])
    for i, p1 in enumerate(pos):
        for j, p2 in enumerate(pos):
            if one_to_one(p1, p2):
                weights[i][n_per + j] = 1.2          # 0 -> 1
                weights[2 * n_per + i][j] = 2.0      # st -> 0
            if cross(p1, p2):
                weights[n_per + i][j] = 0.8          # 1 -> 0
    return net, neurons, sts, weights


@pytest.mark.parametrize("chemical", [False, True])
def test_network_matches_scalar_reference(chemical):
    iters = 200
    net, neurons, sts, weights = build_network(chemical=chemical)
    for lat in net.lattices.values():
        lat.update_grid_history = True
    net.run_lattices(iters)

    want, _ = run_ref_network(neurons, sts, weights, iters,
                              electrical=True, chemical=chemical)
    got0 = np.stack(net.get_lattice(0).grid_history.history).reshape(iters, 4)
    got1 = np.stack(net.get_lattice(1).grid_history.history).reshape(iters, 4)
    got = np.concatenate([got0, got1], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3)


def test_network_stdp_matches_scalar_reference():
    iters = 150
    net, neurons, sts, weights = build_network(plasticity=True, seed=3)
    net.run_lattices(iters)

    stdp = dict(a_plus=2.0, a_minus=2.0, tau_plus=4.5, tau_minus=4.5, dt=0.1)
    want_v, want_w = run_ref_network(neurons, sts, weights, iters,
                                     electrical=True, stdp=stdp,
                                     do_plasticity=True)
    # intra weights written back into the lattice graphs
    got_w0 = np.asarray(net.get_lattice(0).graph.weights)
    for i in range(4):
        for j in range(4):
            expect = want_w[i][j]
            if expect is not None:
                np.testing.assert_allclose(got_w0[i, j], expect, rtol=1e-4,
                                           atol=1e-3)
    # connecting weights (1 -> 0)
    src, dst, w_conn = net.connections[(1, 0)]
    for s_, d_, wv in zip(src, dst, w_conn):
        expect = want_w[4 + s_][d_]
        np.testing.assert_allclose(wv, expect, rtol=1e-4, atol=1e-3)
    # spike-train -> lattice edges also plastic when target lattice is
    src, dst, w_st = net.connections[(2, 0)]
    for s_, d_, wv in zip(src, dst, w_st):
        expect = want_w[8 + s_][d_]
        np.testing.assert_allclose(wv, expect, rtol=1e-4, atol=1e-3)
    # final voltages match
    got_v = np.concatenate([np.asarray(net.get_lattice(0).state["v"]),
                            np.asarray(net.get_lattice(1).state["v"])])
    np.testing.assert_allclose(got_v, want_v[-1], rtol=1e-4, atol=5e-3)


def test_structure_checks():
    lat = snn.Lattice(snn.Izhikevich(), id=0)
    lat.populate(2, 2)
    st = snn.SpikeTrainLattice(snn.RateSpikeTrain(), id=0)
    st.populate(2, 2)
    net = snn.LatticeNetwork()
    net.add_lattice(lat)
    with pytest.raises(ValueError):
        net.add_spike_train_lattice(st)   # id collision
    st.id = 1
    net.add_spike_train_lattice(st)
    with pytest.raises(ValueError):
        net.connect(0, 1, lambda a, b: True)   # spike train postsynaptic
    with pytest.raises(KeyError):
        net.connect(5, 0, lambda a, b: True)   # unknown presynaptic


def test_standalone_spike_train_lattice():
    st = snn.SpikeTrainLattice(snn.RateSpikeTrain(), id=0)
    st.populate(2, 3, rate=1.0)   # fires every 1 ms = every 10 steps (dt 0.1)
    st.update_grid_history = True
    st.run_lattice(40)
    hist = np.stack(st.grid_history.history)
    spikes_at = np.nonzero(hist[:, 0, 0] == 30.0)[0]
    np.testing.assert_array_equal(spikes_at, [9, 19, 29, 39])
    assert int(st.state["last_firing_time"][0]) == 39


def test_poisson_spike_train_statistics():
    """Poisson parity is statistical (reference's own Python-tier approach):
    firing rate ~ chance_of_firing."""
    model = snn.PoissonSpikeTrain()
    st = snn.SpikeTrainLattice(model, id=0)
    st.populate(10, 10)
    st.state = model.init_from_firing_rate(100, hertz=100.0, dt=0.1)
    st.update_grid_history = True
    st.run_lattice(2000)
    hist = np.stack(st.grid_history.history)
    rate = (hist == 30.0).mean()
    expect = model.rate_to_chance(100.0, 0.1)   # 0.01
    assert abs(rate - expect) < 0.002


def test_dense_and_sparse_network_gathers_match():
    """The dense (matvec) network fast path equals the segment-sum path."""
    results = {}
    for dense in (True, False):
        net, _, _, _ = build_network(chemical=True, plasticity=True, seed=9)
        net.dense_gather = dense
        for lat in net.lattices.values():
            lat.update_grid_history = True
        net.run_lattices(150)
        results[dense] = (
            np.stack(net.get_lattice(0).grid_history.history),
            np.asarray(net.get_lattice(0).graph.weights))
    np.testing.assert_allclose(results[True][0], results[False][0],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(results[True][1], results[False][1],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.slow
def test_structured_runner_matches_flat():
    """The structure-preserving runner equals the flat COO runner exactly
    (electrical+chemical, STDP, mixed connection kinds)."""
    for chemical, plasticity in [(False, False), (True, False), (True, True)]:
        results = {}
        for structured in (True, False):
            net, _, _, _ = build_network(chemical=chemical,
                                         plasticity=plasticity, seed=17)
            net.structured = structured
            for lat in net.lattices.values():
                lat.update_grid_history = True
            net.run_lattices(120)
            results[structured] = (
                np.stack(net.get_lattice(0).grid_history.history),
                np.stack(net.get_lattice(1).grid_history.history),
                np.asarray(net.get_lattice(0).graph.weights),
                np.asarray(net.connections[(1, 0)][2]),
                np.asarray(net.connections[(2, 0)][2]))
        for a, b in zip(results[True], results[False]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4,
                                       err_msg=f"chem={chemical} plast={plasticity}")


def test_padded_block_connection_matches_dense():
    """PaddedBlock (low in-degree gather op) equals DenseBlock op-for-op."""
    from spiking_neural_networks_jax.core import structured

    rng = np.random.default_rng(31)
    n_pre, n_post, e = 64, 16, 48
    dst = np.repeat(np.arange(n_post), 3).astype(np.int64)  # in-degree 3
    # unique (src, dst) pairs: distinct sources per destination
    src = np.concatenate([rng.choice(n_pre, 3, replace=False)
                          for _ in range(n_post)]).astype(np.int64)
    w = rng.uniform(-1, 1, e).astype(np.float32)

    padded = structured.PaddedBlock(src, dst, w, n_pre, n_post)
    dense = structured.DenseBlock(src, dst, w, n_pre, n_post)

    a_src = jnp.asarray(rng.uniform(-65, 30, n_pre), jnp.float32)
    sub = jnp.ones(n_pre, jnp.float32)
    v_post = jnp.asarray(rng.uniform(-65, 30, n_post), jnp.float32)

    g_p = structured._conn_gather("padded", padded.aux, padded.w0,
                                  a_src, sub, v_post)
    g_d = structured._conn_gather("dense", dense.aux, dense.w0,
                                  a_src, sub, v_post)
    np.testing.assert_allclose(np.asarray(g_p), np.asarray(g_d),
                               rtol=1e-5, atol=1e-4)

    t_src = jnp.asarray(rng.uniform(0, 1, (n_pre, 3)), jnp.float32)
    m_src = jnp.asarray((rng.random((n_pre, 3)) < 0.7), jnp.float32)
    s_p, c_p = structured._conn_gather_chemical("padded", padded.aux,
                                                padded.w0, t_src, m_src)
    s_d, c_d = structured._conn_gather_chemical("dense", dense.aux,
                                                dense.w0, t_src, m_src)
    np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_d),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(c_p), np.asarray(c_d),
                               rtol=1e-5, atol=1e-5)

    # plasticity update + per-edge extraction round trip
    lft_pre = jnp.asarray(rng.integers(-1, 50, n_pre), jnp.int32)
    lft_post = jnp.asarray(rng.integers(-1, 50, n_post), jnp.int32)
    spk_pre = jnp.asarray(rng.random(n_pre) < 0.3)
    spk_post = jnp.asarray(rng.random(n_post) < 0.3)
    pre_vals = dict(last_firing_time=lft_pre, is_spiking=spk_pre)
    post_vals = dict(last_firing_time=lft_post, is_spiking=spk_post)
    params = {k: jnp.float32(v) for k, v in snn.STDP().params.items()}

    from spiking_neural_networks_jax.core.plasticity import STDP as STDPRule

    def delta(w_, pre, post):
        return STDPRule.edge_dw(w_, pre, post, params)

    w_p = structured._conn_edge_update("padded", padded.aux, padded.w0,
                                       delta, pre_vals, post_vals)
    w_d = structured._conn_edge_update("dense", dense.aux, dense.w0,
                                       delta, pre_vals, post_vals)
    np.testing.assert_allclose(padded.extract(w_p), dense.extract(w_d),
                               rtol=1e-5, atol=1e-5)


def test_network_set_dt_rescales_poisson_chance():
    """LatticeNetwork::set_dt propagates to every member lattice; Poisson
    trains rescale chance_of_firing by the dt ratio (spike_train/mod.rs:
    340-350) so the firing rate in Hz is invariant."""
    net = snn.LatticeNetwork()
    lat = snn.Lattice(snn.Izhikevich(), id=0)
    lat.populate(3, 3, gap_conductance=5.0)
    lat.connect_stencil(radius=1.5)
    model = snn.PoissonSpikeTrain()
    st = snn.SpikeTrainLattice(model, id=1)
    st.populate(3, 3)
    st.state = model.init_from_firing_rate(9, hertz=100.0, dt=0.1)
    chance0 = float(np.asarray(st.state["chance_of_firing"])[0])
    net.add_lattice(lat)
    net.add_spike_train_lattice(st)
    net.connect(1, 0, lambda a, b: a == b, lambda a, b: 1.0)

    net.set_dt(0.2)
    assert np.allclose(np.asarray(lat.state["dt"]), 0.2)
    assert np.allclose(np.asarray(st.state["dt"]), 0.2)
    # doubling dt doubles the per-step chance (same rate in Hz)
    assert np.allclose(np.asarray(st.state["chance_of_firing"]),
                       chance0 * 2.0, rtol=1e-6)
    # and the network still runs at the new dt
    net.run_lattices(50)
    assert np.isfinite(np.asarray(lat.state["v"])).all()


def test_lattice_set_dt_updates_plasticity():
    """Lattice::set_dt also forwards to the plasticity rule (STDP dt scales
    the weight update integration)."""
    lat = snn.Lattice(snn.Izhikevich())
    lat.plasticity = snn.STDP()
    lat.populate(2, 2, gap_conductance=5.0)
    lat.connect_stencil(radius=1.0)
    lat.set_dt(0.05)
    assert abs(lat.plasticity.params["dt"] - 0.05) < 1e-9


@pytest.mark.slow
def test_structured_plan_cache_across_runs():
    """Repeated run_lattices reuse the cached plan + device weights; any
    connect() invalidates it; plastic weights keep flowing through the
    cache (guards the donated-buffer re-adoption, which the CPU backend
    tolerates but an accelerator rejects)."""
    exc = snn.Lattice(snn.Izhikevich(), id=0)
    exc.populate(4, 4, gap_conductance=10.0)
    exc.connect_stencil(radius=1.5)
    exc.do_plasticity = True
    st = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(), id=1)
    st.populate(4, 4)
    st.state = snn.PoissonSpikeTrain().init_from_firing_rate(
        16, hertz=1000.0, dt=0.1)
    net = snn.LatticeNetwork.generate_network([exc], [st])
    net.connect(1, 0, lambda a, b: a == b, lambda a, b: 50.0)

    net.run_lattices(200)
    plan1 = net._structured_plan
    assert plan1 is not None
    assert (np.asarray(exc.state["last_firing_time"]) >= 0).any()
    w1 = np.asarray(net.connections[(1, 0)][2]).copy()
    net.run_lattices(200)
    assert net._structured_plan is plan1          # cache hit
    w2 = np.asarray(net.connections[(1, 0)][2])
    assert net.internal_clock == 400
    assert not np.allclose(w1, w2)                # plasticity flowed through

    net.connect(1, 0, lambda a, b: a == b, lambda a, b: 1.0)
    net.run_lattices(10)
    assert net._structured_plan is not plan1      # invalidated + rebuilt
    w3 = np.asarray(net.connections[(1, 0)][2])
    assert np.all(np.abs(w3) <= 10.0)             # new weights took effect


@pytest.mark.slow
def test_network_per_lattice_graph_history():
    """lattice.update_graph_history inside a network records per-step
    backend-layout weight snapshots (reference updates lattice graph
    history inside the network step, neuron/mod.rs:2443) — on both the
    structured and flat runners, with identical values."""
    def build(structured):
        net, _, _, _ = build_network(chemical=False, plasticity=True, seed=2)
        net.structured = structured
        lat0 = net.get_lattice(0)
        lat0.update_graph_history = True
        # near-threshold start so spikes (and STDP movement) happen early
        lat0.state["v"] = jnp.full_like(lat0.state["v"], 29.5)
        return net

    stru = build(True)
    stru.run_lattices(200)
    h_s = stru.get_lattice(0).graph_history
    assert len(h_s) == 200
    assert h_s[0].shape == np.asarray(stru.get_lattice(0).graph.weights).shape

    flat = build(False)
    flat.run_lattices(200)
    h_f = flat.get_lattice(0).graph_history
    assert len(h_f) == 200
    np.testing.assert_allclose(np.asarray(h_s[-1]), np.asarray(h_f[-1]),
                               rtol=1e-5, atol=1e-5)
    # weights actually moved at some point
    assert np.abs(np.asarray(h_s[-1]) - np.asarray(h_s[0])).max() > 0
