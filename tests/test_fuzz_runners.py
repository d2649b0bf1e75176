"""Property test: the structured network runner must match the flat COO
runner on randomized topologies.

The fixed equivalence tests in test_network.py exercise hand-picked
wirings; here seeded random networks (lattice count/sizes, connection
patterns, plasticity flags, synapse modes) guard the operator-classification
edge cases (OneToOne / ResampleBlock / PaddedBlock / DenseBlock selection,
mixed plastic endpoints, spike-train sources)."""

import numpy as np
import jax.numpy as jnp
import pytest

import spiking_neural_networks_jax as snn


def _build(seed, structured):
    rng = np.random.default_rng(seed)
    n_lat = int(rng.integers(1, 4))
    sizes = [int(rng.integers(3, 7)) for _ in range(n_lat)]
    lats = []
    for k, n_side in enumerate(sizes):
        lat = snn.Lattice(snn.Izhikevich(), id=k)
        lat.populate(n_side, n_side, gap_conductance=10.0)
        lat.connect_stencil(radius=1.5, keep_prob=float(rng.uniform(0.5, 1.0)),
                            seed=seed * 10 + k)
        v0 = rng.uniform(-65.0, 30.0, n_side * n_side)
        v0[rng.permutation(n_side * n_side)[:3]] = 40.0
        lat.apply(lambda s, v0=v0: {**s, "v": jnp.asarray(v0, jnp.float32)})
        lat.do_plasticity = bool(rng.random() < 0.5)
        lats.append(lat)
    st = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(), id=n_lat)
    st.populate(sizes[0], sizes[0])
    st.state = st.model.init_from_firing_rate(sizes[0] ** 2, hertz=80.0,
                                              dt=0.1)
    net = snn.LatticeNetwork.generate_network(lats, [st])
    net.connect(n_lat, 0, lambda a, b: a == b, lambda a, b: 4.0)
    # random cross-lattice connections (position-pair predicates give
    # one-to-one / dense / padded classifications depending on shapes)
    for _ in range(int(rng.integers(1, 4))):
        pre, post = rng.integers(0, n_lat, 2)
        if pre == post:
            continue
        kind = rng.integers(0, 2)
        if kind == 0 and sizes[pre] == sizes[post]:
            net.connect(int(pre), int(post), lambda a, b: a == b,
                        lambda a, b: 1.5)
        else:
            thresh = float(rng.uniform(0.05, 0.3))
            net.connect(int(pre), int(post),
                        lambda a, b, t=thresh: (hash((a, b)) % 997) / 997 < t,
                        lambda a, b: 0.7)
    net.structured = structured
    return net


@pytest.mark.parametrize("seed", [
    101,
    pytest.param(202, marks=pytest.mark.slow),
    pytest.param(303, marks=pytest.mark.slow),
    pytest.param(404, marks=pytest.mark.slow),
])
def test_structured_matches_flat_random_topology(seed):
    a = _build(seed, structured=True)
    b = _build(seed, structured=False)
    a.run_lattices(120)
    b.run_lattices(120)
    fired = 0
    for k in a.lattices:
        va = np.asarray(a.get_lattice(k).state["v"])
        vb = np.asarray(b.get_lattice(k).state["v"])
        np.testing.assert_allclose(va, vb, rtol=2e-5, atol=2e-4,
                                   err_msg=f"lattice {k} seed {seed}")
        wa = np.asarray(a.get_lattice(k).graph.weights)
        wb = np.asarray(b.get_lattice(k).graph.weights)
        np.testing.assert_allclose(wa, wb, rtol=2e-4, atol=2e-4,
                                   err_msg=f"weights {k} seed {seed}")
        fired += int((np.asarray(
            a.get_lattice(k).state["last_firing_time"]) >= 0).sum())
    for key in a.connections:
        _, _, wa = a.connections[key]
        _, _, wb = b.connections[key]
        np.testing.assert_allclose(np.asarray(wa), np.asarray(wb),
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"conn {key} seed {seed}")
    assert fired > 0, f"vacuous run for seed {seed}"


def _build_reward(seed, structured):
    rng = np.random.default_rng(seed)
    n_side = int(rng.integers(4, 8))
    rlat = snn.RewardModulatedLattice(snn.Izhikevich(), id=0)
    rlat.populate(n_side, n_side, gap_conductance=10.0)
    rlat.connect_stencil(radius=1.5, keep_prob=float(rng.uniform(0.6, 1.0)),
                         seed=seed)
    rlat.do_modulation = bool(rng.random() < 0.8)
    plain = snn.Lattice(snn.Izhikevich(), id=1)
    plain.populate(n_side, n_side, gap_conductance=10.0)
    plain.connect_stencil(radius=1.5, keep_prob=0.9, seed=seed + 1)
    plain.do_plasticity = bool(rng.random() < 0.7)
    v0 = rng.uniform(-65.0, 30.0, n_side * n_side)
    v0[rng.permutation(n_side * n_side)[:4]] = 40.0
    plain.apply(lambda s: {**s, "v": jnp.asarray(v0, jnp.float32)})
    st = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(), id=2)
    st.populate(n_side, n_side)
    st.state = st.model.init_from_firing_rate(n_side * n_side, hertz=60.0,
                                              dt=0.1)
    net = snn.RewardModulatedLatticeNetwork()
    net.add_lattice(rlat)
    net.add_lattice(plain)
    net.add_spike_train_lattice(st)
    net.connect(2, 1, lambda a, b: a == b, lambda a, b: 5.0)
    if rng.random() < 0.5:
        net.connect_with_reward_modulation(1, 0, lambda a, b: a == b,
                                           lambda a, b: 1.0)
    else:
        net.connect(1, 0, lambda a, b: a == b, lambda a, b: 1.0)
    net.structured = structured
    return net


@pytest.mark.parametrize("seed", [
    pytest.param(11, marks=pytest.mark.slow),
    pytest.param(22, marks=pytest.mark.slow),
    33,
])
def test_reward_structured_matches_flat_random(seed):
    a = _build_reward(seed, structured=True)
    b = _build_reward(seed, structured=False)
    a.run_lattices_with_reward(0.4, 100)
    b.run_lattices_with_reward(0.4, 100)
    for getter in (lambda n: n.get_reward_modulated_lattice(0),
                   lambda n: n.get_lattice(1)):
        la, lb = getter(a), getter(b)
        np.testing.assert_allclose(np.asarray(la.state["v"]),
                                   np.asarray(lb.state["v"]),
                                   rtol=2e-5, atol=2e-4)
        np.testing.assert_allclose(np.asarray(la.graph.weights),
                                   np.asarray(lb.graph.weights),
                                   rtol=2e-4, atol=2e-4)
    ra = a.get_reward_modulated_lattice(0)
    for field in ("c", "dw", "counter"):
        np.testing.assert_allclose(np.asarray(ra.trace[field]),
                                   np.asarray(
            b.get_reward_modulated_lattice(0).trace[field]),
                                   rtol=2e-4, atol=2e-4)


def _build_bcm(structured):
    rng = np.random.default_rng(77)
    lats = []
    for k in range(2):
        lat = snn.Lattice(snn.BCMIzhikevich(), id=k)
        lat.populate(5, 5, gap_conductance=10.0)
        lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=70 + k)
        v0 = rng.uniform(-65.0, 30.0, 25)
        v0[rng.permutation(25)[:4]] = 40.0
        lat.apply(lambda s, v0=v0: {**s, "v": jnp.asarray(v0, jnp.float32)})
        lat.do_plasticity = True
        lat.plasticity = snn.BCM()
        lats.append(lat)
    net = snn.LatticeNetwork.generate_network(lats, [])
    net.connect(0, 1, lambda a, b: a == b, lambda a, b: 2.0)
    net.structured = structured
    return net


def test_bcm_network_structured_matches_flat():
    """BCM plasticity (activity-dependent, weight-dependent decay) through
    the network runners — both intra-lattice and connecting edges."""
    a = _build_bcm(True)
    b = _build_bcm(False)
    a.run_lattices(150)
    b.run_lattices(150)
    changed = False
    for k in range(2):
        np.testing.assert_allclose(
            np.asarray(a.get_lattice(k).state["v"]),
            np.asarray(b.get_lattice(k).state["v"]), rtol=2e-5, atol=2e-4)
        wa = np.asarray(a.get_lattice(k).graph.weights)
        wb = np.asarray(b.get_lattice(k).graph.weights)
        np.testing.assert_allclose(wa, wb, rtol=2e-4, atol=2e-4)
        w0 = np.asarray(_build_bcm(True).get_lattice(k).graph.weights)
        changed = changed or not np.array_equal(wa, w0)
    assert changed, "vacuous: BCM never changed any weight"
