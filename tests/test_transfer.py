"""Tests for the transfer layer (utils/transfer.py): single- and
multi-state ships, and the lazy-populate flow where lixirnet states stay
host-side until run time."""

import numpy as np
import jax
import pytest

from spiking_neural_networks_jax.utils.transfer import (
    device_put_state, device_put_states, ensure_device_state, ship_states,
    state_is_host)


def _rand_state(rng, n, tag=0):
    return {
        f"f{tag}": rng.standard_normal(n).astype(np.float32),
        f"mat{tag}": rng.standard_normal((n, 3)).astype(np.float32),
        f"b{tag}": rng.random(n) < 0.5,
        f"i{tag}": rng.integers(-5, 5, n).astype(np.int32),
    }


def test_device_put_states_round_trip():
    rng = np.random.default_rng(0)
    states = [_rand_state(rng, 7, t) for t in range(3)]
    out = device_put_states(states)
    assert len(out) == 3
    for host, dev in zip(states, out):
        assert set(host) == set(dev)
        for k in host:
            assert isinstance(dev[k], jax.Array)
            assert dev[k].dtype == np.asarray(host[k]).dtype
            np.testing.assert_array_equal(np.asarray(dev[k]), host[k])


def test_device_put_states_empty_and_single():
    assert device_put_states([]) == []
    rng = np.random.default_rng(1)
    st = _rand_state(rng, 4)
    (out,) = device_put_states([st])
    for k in st:
        np.testing.assert_array_equal(np.asarray(out[k]), st[k])


def test_ensure_device_state_mixed_leaves():
    rng = np.random.default_rng(2)
    st = _rand_state(rng, 5)
    st["already"] = jax.numpy.arange(5.0)
    assert state_is_host(st)
    dev_leaf = st["already"]
    out = ensure_device_state(st)
    assert not state_is_host(out)
    assert out["already"] is dev_leaf  # device leaves pass through
    np.testing.assert_array_equal(np.asarray(out["f0"]), st["f0"])
    # fully-device states are a no-op (identity)
    assert ensure_device_state(out) is out


def test_ship_states_batches_all_holders():
    class Holder:
        def __init__(self, st):
            self.state = st

    rng = np.random.default_rng(3)
    hosts = [_rand_state(rng, 6, t) for t in range(4)]
    holders = [Holder(dict(h)) for h in hosts]
    holders[1].state = ensure_device_state(holders[1].state)  # pre-shipped
    ship_states(holders)
    for h, src in zip(holders, hosts):
        assert not state_is_host(h.state)
        for k in src:
            np.testing.assert_array_equal(np.asarray(h.state[k]), src[k])


def test_lazy_lixirnet_populate_matches_eager(monkeypatch):
    """A lixirnet network built lazily (host states, one batched ship at
    run time) must produce bit-identical results to the same network with
    states force-shipped after every populate."""
    import spiking_neural_networks_jax.lixirnet as ln

    def build():
        neuron = ln.IzhikevichNeuron()
        glu = ln.BoundedNeurotransmitterKinetics()
        neuron.set_synaptic_neurotransmitters(
            {ln.DopaGluGABANeurotransmitterType.Glutamate: glu})
        rec = ln.DopaGluGABA()
        rec.insert(ln.DopaGluGABANeurotransmitterType.Glutamate,
                   ln.GlutamateReceptor())
        neuron.set_receptors(rec)
        poisson = ln.PoissonNeuron()
        poisson.set_synaptic_neurotransmitters(
            {ln.DopaGluGABANeurotransmitterType.Glutamate: glu})

        lat = ln.IzhikevichNeuronLattice(0)
        lat.populate(neuron, 3, 3)

        counter = iter(range(100))

        def setup(n):
            n.current_voltage = -65.0 + 0.5 * next(counter)  # per-neuron
        lat.apply(setup)
        lat.connect(lambda x, y: x != y, lambda x, y: 1.5)
        lat.update_grid_history = True

        st = ln.PoissonLattice(1)
        st.populate(poisson, 3, 3)

        net = ln.IzhikevichNeuronNetwork()
        net.add_lattice(lat)
        net.add_spike_train_lattice(st)
        net.connect(1, 0, lambda x, y: x == y, lambda x, y: 2.0)
        net.electrical_synapse = False
        net.chemical_synapse = True
        return net

    lazy = build()
    assert state_is_host(lazy.get_lattice(0)._inner.state)
    assert state_is_host(lazy.get_spike_train_lattice(1)._inner.state)

    eager = build()
    for latt in (eager.get_lattice(0), eager.get_spike_train_lattice(1)):
        latt._inner.state = ensure_device_state(latt._inner.state)

    lazy.run_lattices(25)
    eager.run_lattices(25)
    assert not state_is_host(lazy.get_lattice(0)._inner.state)
    h_lazy = np.stack(lazy.get_lattice(0).history)
    h_eager = np.stack(eager.get_lattice(0).history)
    np.testing.assert_array_equal(h_lazy, h_eager)


def test_lazy_standalone_lattice_run():
    """Core Lattice.run_lattice ships a lazily-populated state itself."""
    from spiking_neural_networks_jax.core.lattice import Lattice
    from spiking_neural_networks_jax.models.integrate_and_fire import (
        Izhikevich)

    lat = Lattice(Izhikevich())
    lat.populate_host(4, 4, v=-64.0)
    lat.connect_stencil(radius=1, weight_fn=lambda dr, dc, rr, cc: 1.0)
    lat.set_dt(0.5)          # host-aware full_like keeps state host-side
    lat.reset_timing()
    assert state_is_host(lat.state)
    lat.run_lattice(10)
    assert not state_is_host(lat.state)

    ref = Lattice(Izhikevich())
    ref.populate(4, 4, v=-64.0)
    ref.connect_stencil(radius=1, weight_fn=lambda dr, dc, rr, cc: 1.0)
    ref.set_dt(0.5)
    ref.reset_timing()
    ref.run_lattice(10)
    np.testing.assert_array_equal(np.asarray(lat.state["v"]),
                                  np.asarray(ref.state["v"]))


def test_ship_states_keeps_device_leaves():
    """`ship_states` moves only host leaves: a leaf already on the device
    is passed through as the same array object, not copied."""
    import types
    rng = np.random.default_rng(4)
    st = _rand_state(rng, 5)
    dev_leaf = jax.device_put(st["f0"])
    holder = types.SimpleNamespace(state={**st, "f0": dev_leaf})
    ship_states([holder])
    assert not state_is_host(holder.state)
    assert holder.state["f0"] is dev_leaf
    np.testing.assert_array_equal(np.asarray(holder.state["b0"]), st["b0"])


def test_core_populate_is_lazy_with_at_api():
    """Core `populate` defers the device ship (round-4 lazy populate) and
    the host leaves still expose the JAX `.at[...]` update API via
    HostArray, so apply-callbacks written against device arrays work
    unchanged on an unshipped state."""
    from spiking_neural_networks_jax.core.lattice import Lattice
    from spiking_neural_networks_jax.core.network import SpikeTrainLattice
    from spiking_neural_networks_jax.core.reward import (
        RewardModulatedLattice)
    from spiking_neural_networks_jax.models.integrate_and_fire import (
        Izhikevich)
    from spiking_neural_networks_jax.models.spike_train import (
        PoissonSpikeTrain)
    from spiking_neural_networks_jax.utils.transfer import state_is_host

    lat = Lattice(Izhikevich())
    lat.populate(3, 3, v=-64.0)
    assert state_is_host(lat.state)
    lat.apply(lambda s: {**s, "v": s["v"].at[2].set(30.0)})
    assert state_is_host(lat.state)  # .at update stayed host-side
    assert float(np.asarray(lat.state["v"])[2]) == 30.0
    lat.apply(lambda s: {**s, "v": s["v"].at[0].add(1.0).at[0].max(-60.0)})
    assert float(np.asarray(lat.state["v"])[0]) == -60.0

    st = SpikeTrainLattice(PoissonSpikeTrain())
    st.populate(2, 2)
    assert state_is_host(st.state)

    rw = RewardModulatedLattice(Izhikevich())
    rw.populate(2, 2)
    assert state_is_host(rw.state)
    rw.connect(lambda a, b: a != b, lambda a, b: 0.5)
    rw.run_lattice(3)
    assert not state_is_host(rw.state)
