"""The XLA lattice runner against the object-per-neuron scalar reference
(tests/reference_impl.py) for the model families and the chemical
kinetics: every class a lattice can run takes this one runner."""

import numpy as np
import jax.numpy as jnp
import pytest

import spiking_neural_networks_jax as snn
import reference_impl as ref
from reference_impl import run_ref_lattice, f32


def _dense_edges(n, density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    np.fill_diagonal(mask, False)
    w = np.where(mask, rng.uniform(0.5, 1.5, (n, n)), 0.0).astype(np.float32)
    return mask, w


def _weights_list(mask, w):
    n = mask.shape[0]
    return [[float(w[i][j]) if mask[i][j] else None for j in range(n)]
            for i in range(n)]


@pytest.mark.parametrize("model_cls,ref_cls,spread", [
    (snn.LeakyIntegrateAndFire, ref.RefLIF, 30.0),
    (snn.AdaptiveLeakyIntegrateAndFire, ref.RefAdaptiveLIF, 30.0),
    (snn.AdaptiveExpLeakyIntegrateAndFire, ref.RefAdExLIF, 30.0),
    (snn.QuadraticIntegrateAndFire, ref.RefQIF, 30.0),
    (snn.SimpleLeakyIntegrateAndFire, ref.RefSimpleLIF, 30.0),
], ids=["lif", "alif", "adex", "qif", "simple-lif"])
def test_electrical_lattice_matches_scalar_reference(model_cls, ref_cls,
                                                     spread):
    """Gap-junction lattices of each integrate-and-fire model: dense
    random edges, voltages spread from rest to past threshold."""
    side, iters = 3, 300
    n = side * side
    mask, w = _dense_edges(n, 0.5, seed=7)
    model = model_cls()
    rest = float(model.FIELDS["v"])
    v0 = (rest + np.random.default_rng(8).uniform(0, spread, n)) \
        .astype(np.float32)
    lat = snn.Lattice(model)
    lat.populate(side, side, gap_conductance=10.0, v=v0)
    lat.graph = snn.DenseGraph(jnp.asarray(w), jnp.asarray(mask))
    lat.update_grid_history = True
    lat.run_lattice(iters)
    got = np.stack(lat.grid_history.history).reshape(iters, n)

    neurons = []
    for i in range(n):
        nr = ref_cls(gap_conductance=10.0)
        nr.v = f32(v0[i])
        neurons.append(nr)
    want, _ = run_ref_lattice(neurons, _weights_list(mask, w), iters)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3)
    assert (np.asarray(lat.state["last_firing_time"]) >= 0).any()


@pytest.mark.parametrize("kinetics", ["approximate", "destexhe",
                                      "exponential_decay"])
@pytest.mark.parametrize("electrical", [False, True])
def test_chemical_kinetics_match_scalar_reference(kinetics, electrical):
    """Chemical synapses with AMPA and NMDA receptors under each
    neurotransmitter/receptor kinetics, with and without gap junctions."""
    side, iters = 3, 300
    n = side * side
    mask, w = _dense_edges(n, 0.5, seed=1)
    v0 = np.random.default_rng(2).uniform(-65, 30, n).astype(np.float32)
    model = snn.Izhikevich(nt_kinetics=kinetics, rec_kinetics=kinetics)
    lat = snn.Lattice(model)
    lat.populate(side, side, gap_conductance=10.0, v=v0)
    lat.graph = snn.DenseGraph(jnp.asarray(w), jnp.asarray(mask))
    lat.electrical_synapse = electrical
    lat.chemical_synapse = True
    s = lat.state
    for t in ("AMPA", "NMDA"):
        s = model.insert_receptor(s, t)
        s = model.insert_neurotransmitter(s, t)
    lat.state = s
    lat.update_grid_history = True
    lat.run_lattice(iters)
    got = np.stack(lat.grid_history.history).reshape(iters, n)

    neurons = []
    for i in range(n):
        nr = ref.RefIzhikevich(gap_conductance=10.0)
        nr.v = f32(v0[i])
        nr.receptors = ref.ReceptorSet((ref.AMPA, ref.NMDA), kinetics)
        nr.nts = ref.NTSet((ref.AMPA, ref.NMDA), kinetics)
        neurons.append(nr)
    want, _ = run_ref_lattice(neurons, _weights_list(mask, w), iters,
                              electrical=electrical, chemical=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3)
