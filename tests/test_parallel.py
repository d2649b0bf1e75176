"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import os
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.parallel.sharding import (
    make_mesh, make_sharded_training_step, batched_state,
    shard_batched_inputs, _batched_electrical_gather)


@pytest.fixture(scope="module")
def mesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


def _setup(batch, n, seed=0):
    model = snn.Izhikevich()
    state = batched_state(model, batch, n, gap_conductance=10.0)
    rng = np.random.default_rng(seed)
    state["v"] = jnp.asarray(rng.uniform(-65, 30, (batch, n)), jnp.float32)
    mask = jnp.asarray(rng.random((batch, n, n)) < 0.4)
    weights = jnp.asarray(rng.uniform(0.5, 1.5, (batch, n, n)),
                          jnp.float32) * mask
    return model, state, mask, weights


def test_mesh_shape(mesh):
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("dp", "tp")


@pytest.mark.slow
def test_sharded_step_matches_unsharded(mesh):
    """The (dp, tp)-sharded training step computes exactly what the
    unsharded batched program computes."""
    batch, n = 4, 64
    model, state, mask, weights = _setup(batch, n)

    # unsharded single-device run
    def plain_step(state, weights, mask, clock, pparams):
        elec = _batched_electrical_gather(state["v"], state["gap_conductance"],
                                          weights, mask)
        state, spikes = model.step(state, elec, skip_nt=True)
        state["last_firing_time"] = jnp.where(spikes, clock,
                                              state["last_firing_time"])
        return state, spikes

    stdp_params = {k: jnp.float32(v) for k, v in snn.STDP().params.items()}
    ref_state = jax.tree.map(lambda x: x.copy(), state)
    ref_w = weights.copy()
    for clock in range(5):
        ref_state, ref_spikes = plain_step(ref_state, ref_w, mask,
                                           jnp.int32(clock), stdp_params)
        lft = ref_state["last_firing_time"]
        from spiking_neural_networks_jax.models.base import NEVER
        both = (lft[:, :, None] != NEVER) & (lft[:, None, :] != NEVER)
        diff = jnp.abs((lft[:, :, None] - lft[:, None, :]).astype(jnp.float32)) * 0.1
        plus = 2.0 * jnp.exp(-diff / 4.5)
        minus = -2.0 * jnp.exp(-diff / 4.5)
        dw = jnp.where(lft[:, :, None] < lft[:, None, :], plus,
                       jnp.where(lft[:, :, None] > lft[:, None, :], minus, 0.0))
        dw = jnp.where(both, dw, 0.0) * (
            ref_spikes[:, :, None].astype(jnp.float32)
            + ref_spikes[:, None, :].astype(jnp.float32))
        ref_w = jnp.where(mask, ref_w + dw, ref_w)

    # sharded run
    sstate, sweights, smask = shard_batched_inputs(mesh, state, weights, mask)
    step, stdp = make_sharded_training_step(mesh, model)
    for clock in range(5):
        sstate, sweights, spikes = step(sstate, sweights, smask,
                                        jnp.int32(clock), stdp_params)

    np.testing.assert_allclose(np.asarray(sstate["v"]),
                               np.asarray(ref_state["v"]), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(sweights), np.asarray(ref_w),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.slow
def test_dryrun_multichip_entry():
    """The driver's 8-device dryrun, in a FRESH subprocess like the driver
    runs it.  In-process it compiles ~20 sharded programs on top of the
    whole suite's accumulated XLA:CPU compiler state, which segfaults
    backend_compile non-deterministically late in full-suite runs (r05:
    twice at the tp-reward pjit, both times fine in a fresh process) —
    process isolation removes the suite-order fragility without losing
    any coverage."""
    import subprocess
    import sys

    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "dryrun_multichip ok" in proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# Single-lattice / network sharding (parallel/lattice_sharding.py): every
# feature vs its unsharded twin on the same virtual mesh
# ---------------------------------------------------------------------------

from spiking_neural_networks_jax.parallel import (make_lattice_mesh,
                                                  shard_lattice, shard_network)
from spiking_neural_networks_jax.ops.graph import DenseGraph


@pytest.fixture(scope="module")
def tp_mesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    return make_lattice_mesh(8)


def _stencil_lattice(rows=32, cols=32, chemical=False, plasticity=True,
                     seed=0):
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(rows, cols, gap_conductance=10.0)
    rng = np.random.default_rng(seed)
    lat.state["v"] = jnp.asarray(
        rng.uniform(-65, 30, rows * cols), jnp.float32)
    lat.connect_stencil(radius=1.5, keep_prob=0.8, seed=3)
    lat.do_plasticity = plasticity
    if chemical:
        s = lat.state
        s = lat.model.insert_receptor(s, "AMPA")
        s = lat.model.insert_receptor(s, "NMDA")
        s = lat.model.insert_neurotransmitter(s, "AMPA")
        s = lat.model.insert_neurotransmitter(s, "NMDA")
        lat.state = s
        lat.chemical_synapse = True
    return lat


def _assert_states_equal(a, b, what):
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"{what}: state[{k}] diverged")


@pytest.mark.slow
def test_sharded_stencil_lattice_bit_exact(tp_mesh):
    """One large lattice row-block sharded over 8 devices: electrical
    stencil gather + STDP are elementwise/shifted ops, so the SPMD program
    must be bit-identical to the single-device run."""
    ref = _stencil_lattice()
    ref.run_lattice(100)

    lat = _stencil_lattice()
    shard_lattice(lat, tp_mesh)
    lat.run_lattice(100)

    assert lat.state["v"].sharding.num_devices == 8
    _assert_states_equal(ref.state, lat.state, "stencil")
    np.testing.assert_array_equal(np.asarray(ref.graph.weights),
                                  np.asarray(lat.graph.weights))
    assert (np.asarray(lat.state["last_firing_time"]) >= 0).any()


def test_sharded_chemical_lattice(tp_mesh):
    """Chemical synapses (AMPA+NMDA receptor kinetics through the stencil
    chemical gather) under sharding."""
    ref = _stencil_lattice(chemical=True, plasticity=False)
    ref.run_lattice(60)

    lat = _stencil_lattice(chemical=True, plasticity=False)
    shard_lattice(lat, tp_mesh)
    lat.run_lattice(60)

    _assert_states_equal(ref.state, lat.state, "chemical")


def test_sharded_dense_graph_lattice(tp_mesh):
    """Column-sharded dense adjacency: the matvec gather all-gathers the
    presynaptic vector; results match the single-device matvec."""
    def build():
        lat = snn.Lattice(snn.Izhikevich())
        lat.populate(8, 8, gap_conductance=10.0)
        rng = np.random.default_rng(1)
        lat.state["v"] = jnp.asarray(rng.uniform(-65, 30, 64), jnp.float32)
        mask = rng.random((64, 64)) < 0.4
        np.fill_diagonal(mask, False)
        w = rng.uniform(0.5, 1.5, (64, 64)).astype(np.float32) * mask
        lat.graph = DenseGraph(jnp.asarray(w), jnp.asarray(mask))
        lat.do_plasticity = True
        return lat

    ref = build()
    ref.run_lattice(80)
    lat = build()
    shard_lattice(lat, tp_mesh)
    lat.run_lattice(80)

    np.testing.assert_allclose(np.asarray(ref.state["v"]),
                               np.asarray(lat.state["v"]), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref.graph.weights),
                               np.asarray(lat.graph.weights),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(ref.state["last_firing_time"]),
        np.asarray(lat.state["last_firing_time"]))


@pytest.mark.slow
def test_sharded_network_full_feature(tp_mesh):
    """Multi-lattice network (2 neuron lattices + rate spike-train lattice,
    chemical synapses, STDP, connecting edges) sharded via shard_network:
    the structured runner keeps per-lattice arrays, each row-block sharded."""
    def build():
        rng = np.random.default_rng(4)
        lat0 = snn.Lattice(snn.Izhikevich(), id=0)
        lat0.populate(8, 8, gap_conductance=10.0)
        lat1 = snn.Lattice(snn.Izhikevich(), id=1)
        lat1.populate(8, 8, gap_conductance=10.0)
        lat0.state["v"] = jnp.asarray(rng.uniform(-65, 25, 64), jnp.float32)
        lat1.state["v"] = jnp.asarray(rng.uniform(-65, 25, 64), jnp.float32)
        lat0.connect_stencil(radius=1.5, keep_prob=0.9, seed=5)
        lat1.connect_stencil(radius=1.5, keep_prob=0.9, seed=6)
        lat0.do_plasticity = True
        st = snn.SpikeTrainLattice(snn.RateSpikeTrain(), id=2)
        st.populate(8, 8, rate=2.0, v_th=30.0)
        for lat in (lat0, lat1):
            s = lat.state
            s = lat.model.insert_receptor(s, "AMPA")
            s = lat.model.insert_neurotransmitter(s, "AMPA")
            lat.state = s
        st.state = st.model.insert_neurotransmitter(st.state, "AMPA")
        net = snn.LatticeNetwork.generate_network([lat0, lat1], [st])
        net.chemical_synapse = True
        net.connect_vectorized(0, 1, lambda pr, pc, qr, qc: np.where(
            (pr == qr) & (pc == qc), 1.0, np.nan))
        net.connect_vectorized(2, 0, lambda pr, pc, qr, qc: np.where(
            (pr == qr), 0.8, np.nan))
        return net

    ref = build()
    ref.run_lattices(60)

    net = build()
    shard_network(net, tp_mesh)
    net.run_lattices(60)

    for i in (0, 1):
        _assert_states_equal(ref.get_lattice(i).state,
                             net.get_lattice(i).state, f"net lat{i}")
    _assert_states_equal(ref.get_spike_train_lattice(2).state,
                         net.get_spike_train_lattice(2).state, "net st")
    assert (np.asarray(net.get_lattice(0).state["last_firing_time"]) >= 0).any()


def test_sharded_reward_lattice(tp_mesh):
    """R-STDP lattice with per-edge eligibility traces sharded like its
    stencil weight planes."""
    def build():
        lat = snn.RewardModulatedLattice(snn.Izhikevich())
        lat.populate(8, 8, gap_conductance=10.0)
        rng = np.random.default_rng(2)
        lat.state["v"] = jnp.asarray(rng.uniform(-65, 30, 64), jnp.float32)
        lat.connect_stencil(radius=1.5, keep_prob=0.8, seed=7)
        return lat

    ref = build()
    ref.run_lattice_with_reward(0.5, 60)
    lat = build()
    shard_lattice(lat, tp_mesh)
    lat.run_lattice_with_reward(0.5, 60)

    _assert_states_equal(ref.state, lat.state, "reward")
    np.testing.assert_array_equal(np.asarray(ref.graph.weights),
                                  np.asarray(lat.graph.weights))
    for k in ref.trace:
        np.testing.assert_array_equal(np.asarray(ref.trace[k]),
                                      np.asarray(lat.trace[k]),
                                      err_msg=f"trace[{k}]")


@pytest.mark.slow
def test_sharded_512_lattice_bit_exact(tp_mesh):
    """The BASELINE north-star config (512x512, radius-2 stencil) sharded
    over 8 devices matches the single-device trace exactly (VERDICT r1 #2)."""
    def build():
        lat = snn.Lattice(snn.Izhikevich())
        lat.populate(512, 512, gap_conductance=10.0)
        rng = np.random.default_rng(0)
        lat.state["v"] = jnp.asarray(
            rng.uniform(-65, 30, 512 * 512), jnp.float32)
        lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=3)
        return lat

    ref = build()
    ref.run_lattice(30)
    lat = build()
    shard_lattice(lat, tp_mesh)
    lat.run_lattice(30)
    np.testing.assert_array_equal(np.asarray(ref.state["v"]),
                                  np.asarray(lat.state["v"]))
    assert (np.asarray(lat.state["last_firing_time"]) >= 0).any()


@pytest.mark.slow
def test_hybrid_mesh_single_host_and_lattice_shard():
    """Multi-host helpers degrade gracefully on one host: hybrid mesh is
    (1, n) / 1-D prefer_ici, and a lattice shards over it bit-exactly."""
    from spiking_neural_networks_jax.parallel import (make_hybrid_mesh,
                                                      initialize_multihost)
    initialize_multihost()   # no-op without a coordinator
    mesh2d = make_hybrid_mesh()
    assert mesh2d.devices.shape == (1, 8)
    assert mesh2d.axis_names == ("dp", "tp")
    mesh1d = make_hybrid_mesh(prefer_ici=True)
    assert mesh1d.devices.shape == (8,)

    ref = _stencil_lattice(rows=16, cols=16)
    ref.run_lattice(50)
    lat = _stencil_lattice(rows=16, cols=16)
    shard_lattice(lat, mesh1d)
    lat.run_lattice(50)
    np.testing.assert_array_equal(np.asarray(ref.state["v"]),
                                  np.asarray(lat.state["v"]))


@pytest.mark.slow
def test_multihost_two_process():
    """Execute the DCN path for real: two coordinated `jax.distributed`
    CPU processes (2 local devices each -> 4 global), asserting the global
    device set, the (dp=2, tp=2) hybrid mesh, and a 4-way sharded lattice
    run bit-exact vs a process-local single-device run
    (tests/_multihost_worker.py)."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i}: MULTIHOST_OK" in out
