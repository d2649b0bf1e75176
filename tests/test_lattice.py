"""Lattice runtime golden tests vs the scalar two-phase simulator, plus
graph-backend equivalence and structural invariants (mirrors the reference's
backend/tests tier: gpu_accuracy.rs, grid_formation_invariant.rs,
size_zero_cases.rs)."""

import numpy as np
import jax.numpy as jnp
import pytest

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.ops.graph import (
    DenseGraph, dense_to_sparse, StencilGraph, radius_offsets)
from reference_impl import RefIzhikevich, run_ref_lattice, f32, AMPA, NMDA, GABA


def make_dense_weights(n, density, seed, wmin=0.5, wmax=1.5, self_loops=False):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    if not self_loops:
        np.fill_diagonal(mask, False)
    w = rng.uniform(wmin, wmax, (n, n)).astype(np.float32)
    return mask, np.where(mask, w, 0.0).astype(np.float32)


def build_lattice(rows, cols, mask, w, v_init, electrical, chemical,
                  with_receptors=False):
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(rows, cols)
    lat.graph = DenseGraph(jnp.asarray(w), jnp.asarray(mask))
    lat.electrical_synapse = electrical
    lat.chemical_synapse = chemical
    lat.apply(lambda s: {**s, "v": jnp.asarray(v_init)})
    if with_receptors:
        s = lat.state
        s = lat.model.insert_receptor(s, "AMPA")
        s = lat.model.insert_receptor(s, "NMDA")
        s = lat.model.insert_neurotransmitter(s, "AMPA")
        s = lat.model.insert_neurotransmitter(s, "NMDA")
        lat.state = s
    lat.update_grid_history = True
    return lat


def build_ref(n, mask, w, v_init, with_receptors=False):
    neurons = []
    for i in range(n):
        nr = RefIzhikevich(gap_conductance=10.0)
        nr.v = f32(v_init[i])
        if with_receptors:
            import reference_impl as RI
            nr.receptors = RI.ReceptorSet((AMPA, NMDA), "approximate")
            nr.nts = RI.NTSet((AMPA, NMDA), "approximate")
        neurons.append(nr)
    weights = [[float(w[i][j]) if mask[i][j] else None for j in range(n)]
               for i in range(n)]
    return neurons, weights


@pytest.mark.parametrize("electrical,chemical", [
    (True, False), (False, True), (True, True)])
def test_lattice_matches_scalar_reference(electrical, chemical):
    rows, cols, iters = 3, 3, 300
    n = rows * cols
    mask, w = make_dense_weights(n, 0.5, seed=1)
    rng = np.random.default_rng(2)
    v_init = rng.uniform(-65, 30, n).astype(np.float32)

    lat = build_lattice(rows, cols, mask, w, v_init, electrical, chemical,
                        with_receptors=chemical)
    lat.apply(lambda s: {**s, "gap_conductance":
                         jnp.full_like(s["gap_conductance"], 10.0)})
    lat.run_lattice(iters)
    got = np.stack(lat.grid_history.history).reshape(iters, n)

    neurons, weights = build_ref(n, mask, w, v_init, with_receptors=chemical)
    want, _ = run_ref_lattice(neurons, weights, iters,
                              electrical=electrical, chemical=chemical)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3)


def test_graph_backend_equivalence():
    """Dense, sparse, and stencil backends produce identical trajectories for
    the same radius-2 connectivity."""
    rows = cols = 6
    n = rows * cols
    offsets = radius_offsets(2.0)

    # Build the same connectivity as dense mask
    pos = [(r, c) for r in range(rows) for c in range(cols)]
    mask = np.zeros((n, n), bool)
    w = np.zeros((n, n), np.float32)
    rng = np.random.default_rng(3)
    wmap = {}
    for o, (dr, dc) in enumerate(offsets):
        wmap[(dr, dc)] = rng.uniform(0.5, 1.5, (rows, cols)).astype(np.float32)
    for j, (r, c) in enumerate(pos):
        for (dr, dc) in offsets:
            sr, sc = r + dr, c + dc
            if 0 <= sr < rows and 0 <= sc < cols:
                i = sr * cols + sc
                mask[i, j] = True
                w[i, j] = wmap[(dr, dc)][r, c]

    v_init = np.random.default_rng(4).uniform(-65, 30, n).astype(np.float32)

    results = {}
    for backend in ("dense", "sparse", "stencil"):
        lat = snn.Lattice(snn.Izhikevich())
        lat.populate(rows, cols, v=v_init, gap_conductance=10.0)
        dense = DenseGraph(jnp.asarray(w), jnp.asarray(mask))
        if backend == "dense":
            lat.graph = dense
        elif backend == "sparse":
            lat.graph = dense_to_sparse(dense)
        else:
            lat.graph = StencilGraph.build(
                rows, cols, offsets,
                weight_fn=lambda dr, dc, rr, cc: wmap[(dr, dc)])
        lat.update_grid_history = True
        lat.run_lattice(200)
        results[backend] = np.stack(lat.grid_history.history)

    np.testing.assert_allclose(results["dense"], results["sparse"],
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(results["dense"], results["stencil"],
                               rtol=1e-6, atol=1e-5)


def test_stdp_lattice_matches_scalar_reference():
    rows, cols, iters = 3, 3, 200
    n = rows * cols
    mask, w = make_dense_weights(n, 0.6, seed=5)
    v_init = np.random.default_rng(6).uniform(-65, 30, n).astype(np.float32)

    lat = build_lattice(rows, cols, mask, w, v_init, True, False)
    lat.apply(lambda s: {**s, "gap_conductance":
                         jnp.full_like(s["gap_conductance"], 10.0)})
    lat.do_plasticity = True
    lat.plasticity = snn.STDP()
    lat.run_lattice(iters)
    got_v = np.stack(lat.grid_history.history).reshape(iters, n)
    got_w = np.asarray(lat.graph.weights)

    neurons, weights = build_ref(n, mask, w, v_init)
    stdp = dict(a_plus=2.0, a_minus=2.0, tau_plus=4.5, tau_minus=4.5, dt=0.1)
    want_v, want_w = run_ref_lattice(neurons, weights, iters, electrical=True,
                                     stdp=stdp, do_plasticity=True)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=5e-3)
    want_w_arr = np.array([[want_w[i][j] if want_w[i][j] is not None else 0.0
                            for j in range(n)] for i in range(n)], np.float32)
    np.testing.assert_allclose(got_w, want_w_arr, rtol=1e-4, atol=1e-3)


def test_no_connections_behaves_like_isolated():
    """Zero in-degree => averaged input is 0 (divide by max(count,1))."""
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(2, 2)
    lat.update_grid_history = True
    lat.run_lattice(100)
    got = np.stack(lat.grid_history.history).reshape(100, 4)

    ref = RefIzhikevich()
    want = []
    for _ in range(100):
        ref.iterate_and_spike(0.0)
        want.append(ref.v)
    for col in range(4):
        np.testing.assert_allclose(got[:, col], want, rtol=1e-5, atol=1e-4)


def test_populate_dimensions_and_reset():
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(4, 7)
    assert lat.state["v"].shape == (28,)
    assert lat.voltages().shape == (4, 7)
    lat.run_lattice(10)
    assert lat.internal_clock == 10
    lat.reset_timing()
    assert lat.internal_clock == 0
    assert int(lat.state["last_firing_time"].max()) == -1


def test_zero_iterations_and_no_synapses():
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(2, 2)
    lat.run_lattice(0)
    lat.electrical_synapse = False
    lat.chemical_synapse = False
    lat.run_lattice(10)
    assert lat.internal_clock == 0


def test_last_firing_time_tracking():
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(1, 1)
    lat.update_grid_history = True
    # strong drive: neuron spikes periodically; lft equals the step index of
    # the most recent spike
    lat.apply(lambda s: {**s, "v": jnp.full_like(s["v"], 20.0)})

    ref = RefIzhikevich()
    ref.v = f32(20.0)
    lft = None
    lat.run_lattice(300)
    for it in range(300):
        if ref.iterate_and_spike(0.0):
            lft = it
    assert int(lat.state["last_firing_time"][0]) == (lft if lft is not None else -1)


def _stencil_ref_case(rows, cols, radius, keep_prob, seed, iters):
    """A stencil lattice's XLA run next to the scalar reference driven by
    the same edges as a dense weight list."""
    v0 = np.random.default_rng(seed).uniform(-65, 30,
                                             rows * cols).astype(np.float32)
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(rows, cols, gap_conductance=10.0, v=v0)
    lat.connect_stencil(radius=radius, keep_prob=keep_prob, seed=seed)
    lat.update_grid_history = True
    lat.run_lattice(iters)
    got = np.stack(lat.grid_history.history).reshape(iters, rows * cols)

    n = rows * cols
    g = lat.graph
    w = np.asarray(g.weights)
    m = np.asarray(g.mask)
    mask = np.zeros((n, n), bool)
    dense = np.zeros((n, n), np.float32)
    for o, (dr, dc) in enumerate(g.offsets):
        rr, cc = np.nonzero(m[o])
        dst = rr * cols + cc
        src = (rr + dr) * cols + (cc + dc)
        mask[src, dst] = True
        dense[src, dst] = w[o, rr, cc]
    neurons, weights = build_ref(n, mask, dense, v0)
    want, _ = run_ref_lattice(neurons, weights, iters)
    return got, want, np.asarray(lat.state["last_firing_time"]), neurons


@pytest.mark.parametrize("rows,cols,radius,keep_prob,seed", [
    (6, 6, 2.0, 0.8, 4),      # the flagship's stencil at a small size
    (4, 9, 1.0, 0.9, 11),     # nearest neighbours on a non-square grid
    (5, 5, 1.5, 1.0, 21),     # diagonal neighbours, every edge kept
])
def test_stencil_lattice_matches_scalar_reference(rows, cols, radius,
                                                  keep_prob, seed):
    """Electrical Izhikevich over a StencilGraph (the flagship's class) vs
    the object-per-neuron scalar reference over the same edges."""
    iters = 200
    got, want, lft, neurons = _stencil_ref_case(rows, cols, radius,
                                                keep_prob, seed, iters)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3)
    want_lft = [-1 if nr.last_firing_time is None else nr.last_firing_time
                for nr in neurons]
    np.testing.assert_array_equal(lft, want_lft)


def test_bcm_lattice_matches_scalar_reference():
    """BCM plasticity + BCMIzhikevich activity tracking vs scalar reference."""
    from reference_impl import RefBCMIzhikevich, run_ref_lattice_bcm
    rows, cols, iters = 3, 3, 1200   # crosses the 500-step activity windows
    n = rows * cols
    mask, w = make_dense_weights(n, 0.6, seed=13)
    v_init = np.random.default_rng(14).uniform(-65, 30, n).astype(np.float32)

    lat = snn.Lattice(snn.BCMIzhikevich())
    lat.populate(rows, cols, gap_conductance=10.0,
                 firing_rate_window=50.0, v=v_init)
    lat.graph = DenseGraph(jnp.asarray(w), jnp.asarray(mask))
    lat.do_plasticity = True
    lat.plasticity = snn.BCM()
    lat.update_grid_history = True
    lat.run_lattice(iters)
    got_v = np.stack(lat.grid_history.history).reshape(iters, n)
    got_w = np.asarray(lat.graph.weights)

    neurons = []
    for v in v_init:
        nr = RefBCMIzhikevich(gap_conductance=10.0, firing_rate_window=50.0)
        nr.v = np.float32(v)
        neurons.append(nr)
    weights = [[float(w[i][j]) if mask[i][j] else None for j in range(n)]
               for i in range(n)]
    p = dict(decay=0.1, average_scalar=0.1, dt=0.1)
    want_v, want_w = run_ref_lattice_bcm(neurons, weights, iters, p)

    np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=5e-3)
    for i in range(n):
        for j in range(n):
            if mask[i][j]:
                np.testing.assert_allclose(got_w[i, j], want_w[i][j],
                                           rtol=1e-3, atol=1e-3)


def test_preset_spike_train():
    """PresetSpikeTrain cycles its firing times (spike_train/mod.rs:752-831)."""
    model = snn.PresetSpikeTrain()
    st = snn.SpikeTrainLattice(model, id=0)
    st.rows = st.cols = 1
    st.state = model.init_state(1, firing_times=[2.0, 1.0])
    import jax
    key = jax.random.PRNGKey(0)
    fired_at = []
    s = st.state
    for clock in range(100):
        s, spk, key = model.step(s, key, clock)
        if bool(spk[0]):
            fired_at.append(clock)
    # internal clock accumulates dt=0.1; fires when clock > 2.0 (~step 20
    # modulo f32 accumulation drift), then when clock > 1.0, cycling
    assert fired_at[0] in (19, 20)
    diffs = set(np.diff(fired_at).tolist())
    assert diffs <= {10, 11, 20, 21}
    assert len(fired_at) >= 5


def test_hh_lattice_matches_scalar_reference():
    """Hodgkin-Huxley lattice (Destexhe kinetics) vs scalar two-phase sim."""
    from reference_impl import RefHodgkinHuxley, run_ref_lattice
    rows, cols, iters = 2, 2, 300
    n = rows * cols
    mask, w = make_dense_weights(n, 0.8, seed=21)
    v_init = np.random.default_rng(22).uniform(-70, -50, n).astype(np.float32)

    lat = snn.Lattice(snn.HodgkinHuxley())
    lat.populate(rows, cols, v=v_init, gap_conductance=7.0)
    lat.graph = DenseGraph(jnp.asarray(w), jnp.asarray(mask))
    s = lat.state
    s = lat.model.insert_receptor(s, "AMPA")
    s = lat.model.insert_neurotransmitter(s, "AMPA")
    lat.state = s
    lat.chemical_synapse = True
    lat.update_grid_history = True
    lat.run_lattice(iters)
    got = np.stack(lat.grid_history.history).reshape(iters, n)

    neurons = []
    for v in v_init:
        nr = RefHodgkinHuxley()
        nr.v = np.float32(v)
        import reference_impl as RI
        nr.receptors = RI.ReceptorSet((0,), "destexhe")
        nr.nts = RI.NTSet((0,), "destexhe")
        neurons.append(nr)
    weights = [[float(w[i][j]) if mask[i][j] else None for j in range(n)]
               for i in range(n)]
    want, _ = run_ref_lattice(neurons, weights, iters, electrical=True,
                              chemical=True)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-2)


def test_error_taxonomy():
    from spiking_neural_networks_jax import errors
    lat = snn.Lattice(snn.Izhikevich(), id=0)
    lat.populate(2, 2)
    net = snn.LatticeNetwork()
    net.add_lattice(lat)
    lat2 = snn.Lattice(snn.Izhikevich(), id=0)
    lat2.populate(2, 2)
    with pytest.raises(errors.LatticeNetworkError):
        net.add_lattice(lat2)
    with pytest.raises(errors.SpikingNeuralNetworksError):
        net.add_lattice(lat2)  # umbrella catches too


def test_lattice_set_dt_golden():
    """set_dt (neuron/mod.rs:649-652) rescales the integration step for every
    neuron; trajectory must match the scalar reference run at the new dt."""
    rows, cols, iters = 3, 3, 300
    n = rows * cols
    mask, w = make_dense_weights(n, 0.5, seed=11)
    rng = np.random.default_rng(12)
    v_init = rng.uniform(-65, 30, n).astype(np.float32)

    lat = build_lattice(rows, cols, mask, w, v_init, True, False)
    lat.apply(lambda s: {**s, "gap_conductance":
                         jnp.full_like(s["gap_conductance"], 10.0)})
    lat.set_dt(0.5)
    lat.run_lattice(iters)
    got = np.stack(lat.grid_history.history).reshape(iters, n)

    neurons, weights = build_ref(n, mask, w, v_init)
    for nr in neurons:
        nr.dt = f32(0.5)
    want, _ = run_ref_lattice(neurons, weights, iters)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3)


def test_connect_decomposes_to_stencil():
    """connect() with a radius-style predicate produces a StencilGraph whose
    trajectory matches the dense construction exactly."""
    from spiking_neural_networks_jax.ops.graph import connect_dense

    rng = np.random.default_rng(9)
    kept = {}

    def pred(x, y):
        key = (x, y)
        if key not in kept:
            kept[key] = bool(np.hypot(x[0] - y[0], x[1] - y[1]) <= 2
                             and rng.uniform() <= 0.8 and x != y)
        return kept[key]

    v0 = np.random.default_rng(3).uniform(-65, 30, 64).astype(np.float32)

    lat = snn.Lattice(snn.Izhikevich(), id=0)
    lat.populate(8, 8, gap_conductance=10.0)
    lat.connect(pred, lambda x, y: 1.5)
    assert isinstance(lat.graph, StencilGraph)
    lat.apply(lambda s: {**s, "v": jnp.asarray(v0)})
    lat.update_grid_history = True
    lat.run_lattice(300)
    got = np.stack(lat.grid_history.history)

    lat2 = snn.Lattice(snn.Izhikevich(), id=1)
    lat2.populate(8, 8, gap_conductance=10.0)
    lat2.graph = connect_dense(8, 8, pred, lambda x, y: 1.5)
    lat2.apply(lambda s: {**s, "v": jnp.asarray(v0)})
    lat2.update_grid_history = True
    lat2.run_lattice(300)
    want = np.stack(lat2.grid_history.history)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    # wide-support predicates must stay dense
    lat3 = snn.Lattice(snn.Izhikevich(), id=2)
    lat3.populate(6, 6)
    lat3.connect(lambda x, y: x != y)
    assert isinstance(lat3.graph, DenseGraph)


def test_graph_weight_history():
    """`update_graph_history` records the weight planes per step
    (Graph::update_history, neuron/mod.rs:908-910); forcing two adjacent
    neurons to fire a few steps apart produces a visible STDP update in
    the recorded history."""
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(3, 3, gap_conductance=10.0)
    lat.connect_stencil(radius=1.0)
    lat.do_plasticity = True
    lat.update_graph_history = True

    def force(idx):
        lat.apply(lambda s: {**s, "v": s["v"].at[idx].set(31.0)})

    force(4)
    lat.run_lattice(3)
    force(5)                   # neighbor fires 3 steps later -> dw != 0
    lat.run_lattice(3)
    lat.run_lattice(4)
    assert len(lat.graph_history) == 10
    first, last = lat.graph_history[0], lat.graph_history[-1]
    assert first.shape == last.shape
    assert not np.allclose(first, last)   # STDP moved weights


def test_per_edge_graph_api_all_backends():
    """Graph trait per-edge access (lookup_weight / edit_weight /
    get_incoming_connections / get_outgoing_connections,
    graph/mod.rs:42-72) on all three device graph backends."""
    from spiking_neural_networks_jax.ops.graph import (
        DenseGraph, SparseGraph, StencilGraph, dense_to_sparse)
    from spiking_neural_networks_jax.errors import GraphError

    rng = np.random.default_rng(3)
    n = 9
    mask = rng.random((n, n)) < 0.5
    np.fill_diagonal(mask, False)
    w = (rng.uniform(0.5, 1.5, (n, n)) * mask).astype(np.float32)
    dense = DenseGraph(jnp.asarray(w), jnp.asarray(mask))
    sparse = dense_to_sparse(dense)
    stencil = StencilGraph.build(3, 3, ((0, 1), (1, 0)), seed=0)

    for g in (dense, sparse):
        src, dst = map(int, np.argwhere(mask)[0])
        assert g.lookup_weight(src, dst) == pytest.approx(float(w[src, dst]))
        no_src, no_dst = map(int, np.argwhere(~mask)[0])
        assert g.lookup_weight(no_src, no_dst) is None
        g2 = g.edit_weight(src, dst, 7.25)
        assert g2.lookup_weight(src, dst) == 7.25
        g3 = g2.edit_weight(src, dst, None)
        assert g3.lookup_weight(src, dst) is None
        assert src not in g3.get_incoming_connections(dst)
        g4 = g3.edit_weight(no_src, no_dst, 1.5)   # create a new edge
        assert g4.lookup_weight(no_src, no_dst) == 1.5
        assert no_dst in g4.get_outgoing_connections(no_src)
        assert g.get_incoming_connections(dst) == \
            set(np.nonzero(mask[:, dst])[0].tolist())
        with pytest.raises(GraphError):
            g.lookup_weight(0, n + 5)

    # stencil: in-support edit, out-of-support edit grows a plane
    assert stencil.lookup_weight(1, 0) == 1.0       # offset (0,1): src=(0,1)
    s2 = stencil.edit_weight(1, 0, 2.5)
    assert s2.lookup_weight(1, 0) == 2.5
    assert s2.lookup_weight(8, 0) is None
    s3 = s2.edit_weight(8, 0, 0.5)                   # offset (2,2): new plane
    assert s3.lookup_weight(8, 0) == 0.5
    assert len(s3.offsets) == len(stencil.offsets) + 1
    assert 8 in s3.get_incoming_connections(0)
    assert 0 in s3.get_outgoing_connections(8)
    # gather still works with the grown plane and reflects the new edge
    v = jnp.arange(9, dtype=jnp.float32)
    ones = jnp.ones(9)
    out = s3.gather_electrical(v, ones, jnp.zeros(9), ones)
    assert np.isfinite(np.asarray(out)).all()


def test_scan_unroll_bit_exact():
    """`scan_unroll` is a pure scheduling knob: unrolled step loops must be
    bit-identical to the rolled loop (lattice and reward-lattice runners)."""
    def lat_run(unroll):
        lat = snn.Lattice(snn.Izhikevich())
        lat.populate(8, 8, gap_conductance=10.0)
        lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=4)
        lat.do_plasticity = True
        v0 = np.random.default_rng(0).uniform(-65.0, 35.0, 64)
        lat.apply(lambda s: {**s, "v": jnp.asarray(v0, jnp.float32)})
        lat.scan_unroll = unroll
        lat.run_lattice(101)  # odd length: exercises the unroll remainder
        return np.asarray(lat.state["v"]), np.asarray(lat.graph.weights)

    v1, w1 = lat_run(1)
    v4, w4 = lat_run(4)
    np.testing.assert_array_equal(v1, v4)
    np.testing.assert_array_equal(w1, w4)


@pytest.mark.parametrize("kind", ["grid", "eeg", "spikes", "average"])
def test_history_chunking_is_seamless(kind):
    """Histories recorded in chunks (history_chunk=16 over 37 steps: two
    full chunks and a remainder) equal one unchunked run bit for bit."""
    from spiking_neural_networks_jax.core.history import HISTORY_KINDS
    rows = cols = 16
    v0 = np.random.default_rng(8).uniform(-65, 30,
                                          rows * cols).astype(np.float32)

    def run(chunk):
        lat = snn.Lattice(snn.Izhikevich())
        lat.populate(rows, cols, gap_conductance=10.0, v=v0)
        lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=4)
        lat.grid_history = HISTORY_KINDS[kind]()
        lat.update_grid_history = True
        lat.history_chunk = chunk
        lat.run_lattice(37)
        return lat

    a, b = run(None), run(16)
    ha = np.asarray(a.grid_history.history)
    hb = np.asarray(b.grid_history.history)
    assert ha.shape == hb.shape and ha.shape[0] == 37
    np.testing.assert_array_equal(hb, ha)
    np.testing.assert_array_equal(np.asarray(b.state["v"]),
                                  np.asarray(a.state["v"]))


def test_preset_spike_train_lazy_populate():
    """populate(firing_times=...) goes through init_state_host (lazy core
    populate) and must still install the preset firing-time fields."""
    model = snn.PresetSpikeTrain()
    st = snn.SpikeTrainLattice(model, id=0)
    st.populate(1, 1, firing_times=[2.0, 1.0])
    assert "firing_times" in st.state and "firing_times_len" in st.state
    st.update_grid_history = True
    st.run_lattice(50)
    hist = np.stack(st.grid_history.history)
    assert hist.max() == 30.0  # it fired at least once


@pytest.mark.parametrize("make", [
    lambda: snn.Lattice(snn.Izhikevich()),
    lambda: snn.LatticeNetwork(),
    lambda: snn.RewardModulatedLattice(snn.Izhikevich()),
    lambda: snn.RewardModulatedLatticeNetwork(),
], ids=["lattice", "network", "reward-lattice", "reward-network"])
def test_removed_use_pallas_setting_raises(make):
    """Code that still sets the removed `use_pallas` fails instead of
    having its choice ignored."""
    obj = make()
    with pytest.raises(AttributeError, match="removed"):
        obj.use_pallas = False
    with pytest.raises(AttributeError, match="removed"):
        obj.use_pallas
