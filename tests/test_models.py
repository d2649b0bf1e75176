"""Tier-1 numerical equivalence tests: vectorized models vs the independent
scalar reference implementation (mirrors the reference's DSL-vs-handwritten
exact-equality tests, nb_macro/tests/basic_lif.rs:26-50)."""

import numpy as np
import jax.numpy as jnp
import pytest

import spiking_neural_networks_jax as snn
from reference_impl import (
    RefIzhikevich, RefLIF, RefAdaptiveLIF, RefAdExLIF, RefQIF, RefSimpleLIF,
    RefHodgkinHuxley, RefMorrisLecar, AMPA, NMDA, GABA,
)

# (model, scalar reference, atol): the conductance models (HH/ML) accumulate
# ~1e-3 mV of cross-compiler `exp`/`tanh` ULP drift over 1000 stiff Euler
# steps; the reference's own CPU-vs-GPU tolerance is 2 mV
# (backend/tests/gpu_accuracy.rs:35-37).
PAIRS = [
    (snn.Izhikevich, RefIzhikevich, 1e-4, 1000),
    (snn.LeakyIntegrateAndFire, RefLIF, 1e-4, 1000),
    (snn.AdaptiveLeakyIntegrateAndFire, RefAdaptiveLIF, 1e-4, 1000),
    (snn.AdaptiveExpLeakyIntegrateAndFire, RefAdExLIF, 1e-4, 1000),
    (snn.QuadraticIntegrateAndFire, RefQIF, 1e-4, 1000),
    (snn.SimpleLeakyIntegrateAndFire, RefSimpleLIF, 1e-4, 1000),
    (snn.HodgkinHuxley, RefHodgkinHuxley, 2e-2, 1000),
    (snn.MorrisLecar, RefMorrisLecar, 2e-2, 1000),
]

INPUTS = [0.0, 10.0, 20.0, 30.0, 40.0, 50.0]


def run_vectorized(model, n_inputs, iterations, chemical=None):
    """Run one neuron per input level in a single vectorized state."""
    import jax
    state = model.init_state(len(n_inputs))
    if chemical is not None:
        for t in ("AMPA", "NMDA", "GABA"):
            state = model.insert_receptor(state, t)
        t_in = jnp.full((len(n_inputs), 3), chemical, jnp.float32)
        t_valid = jnp.ones((len(n_inputs), 3), bool)

        def scan_step(s, _):
            s, _spk = model.step(s, i, t_in, t_valid)
            return s, s["v"]
    else:
        def scan_step(s, _):
            s, _spk = model.step(s, i)
            return s, s["v"]
    i = jnp.asarray(n_inputs, jnp.float32)
    state, vs = jax.jit(
        lambda s: jax.lax.scan(scan_step, s, None, length=iterations))(state)
    return np.asarray(vs)


def run_scalar(ref_cls, inputs, iterations, chemical=None):
    out = np.zeros((iterations, len(inputs)), np.float32)
    for col, i in enumerate(inputs):
        neuron = ref_cls()
        if chemical is not None:
            neuron.receptors = type(neuron.receptors)(
                (AMPA, NMDA, GABA), neuron.rec_kind)
            t_total = {AMPA: np.float32(chemical), NMDA: np.float32(chemical),
                       GABA: np.float32(chemical)}
        for it in range(iterations):
            if chemical is not None:
                neuron.iterate_with_neurotransmitter_and_spike(i, t_total)
            else:
                neuron.iterate_and_spike(i)
            out[it, col] = neuron.v
    return out


@pytest.mark.parametrize("model_cls,ref_cls,atol,iters",
                         PAIRS, ids=[p[0].__name__ for p in PAIRS])
def test_static_input_electrical(model_cls, ref_cls, atol, iters):
    model = model_cls()
    got = run_vectorized(model, INPUTS, iters)
    want = run_scalar(ref_cls, INPUTS, iters)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("model_cls,ref_cls,atol,iters",
                         PAIRS, ids=[p[0].__name__ for p in PAIRS])
def test_static_input_chemical(model_cls, ref_cls, atol, iters):
    model = model_cls()
    got = run_vectorized(model, INPUTS, iters, chemical=0.5)
    want = run_scalar(ref_cls, INPUTS, iters, chemical=0.5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def test_neurotransmitter_release_trace():
    """Concentration dynamics track the scalar reference, including the
    one-step delay (release uses the previous step's spike flag)."""
    from reference_impl import ApproxNT
    model = snn.Izhikevich()
    state = model.init_state(1)
    state = model.insert_neurotransmitter(state, "AMPA")

    ref = RefIzhikevich()
    ref_nt = ApproxNT()

    got, want = [], []
    for it in range(500):
        state, _ = model.step(state, jnp.asarray([40.0]))
        got.append(float(state["nt$t"][0, AMPA]))
        spiking_before = ref.is_spiking
        ref.v = ref.v + ref.dv(np.float32(40.0))
        ref.w = ref.w + ref.dw()
        ref_nt.apply_t_change(ref.v, spiking_before, ref.dt)
        ref.handle_spiking()
        want.append(float(ref_nt.t))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_destexhe_and_exp_decay_kinetics():
    for nt_kind in ("destexhe", "exponential_decay"):
        model = snn.Izhikevich(nt_kinetics=nt_kind, rec_kinetics="approximate")
        state = model.init_state(2)
        state = model.insert_neurotransmitter(state, "AMPA")

        import reference_impl as RI
        ref = RefIzhikevich()
        ref.nt_kind = nt_kind
        ref.nts = RI.NTSet((AMPA,), nt_kind)

        for it in range(300):
            state, _ = model.step(state, jnp.asarray([30.0, 30.0]))
            ref.iterate_and_spike(30.0)
            np.testing.assert_allclose(
                float(state["nt$t"][0, AMPA]), float(ref.nts.nts[AMPA].t),
                rtol=1e-5, atol=1e-6, err_msg=f"{nt_kind} step {it}")


def test_receptor_kinetics_variants():
    for rk in ("destexhe", "exponential_decay"):
        model = snn.Izhikevich(rec_kinetics=rk)
        state = model.init_state(1)
        state = model.insert_receptor(state, "AMPA")
        t_in = jnp.full((1, 3), 0.8, jnp.float32)
        valid = jnp.asarray([[True, False, False]])

        ref = RefIzhikevich()
        import reference_impl as RI
        ref.receptors = RI.ReceptorSet((AMPA,), rk)

        for it in range(300):
            state, _ = model.step(state, jnp.asarray([25.0]), t_in, valid)
            ref.iterate_with_neurotransmitter_and_spike(
                25.0, {AMPA: np.float32(0.8)})
            np.testing.assert_allclose(
                float(state["v"][0]), float(ref.v), rtol=1e-5, atol=1e-4,
                err_msg=f"{rk} step {it}")


@pytest.mark.slow
def test_dopa_izhikevich_dopamine_modulation():
    """D2 dopamine input scales down AMPA/NMDA gain one step later
    (lixirnet DopaGluGABA semantics, interface_gpu/lixirnet/src/lib.rs:45-66)."""
    import spiking_neural_networks_jax as snn

    def run(dopa_conc, s_d2):
        model = snn.DopaIzhikevich()
        state = model.init_state(1)
        for t in ("Glutamate", "GABA", "Dopamine"):
            state = model.insert_receptor(state, t)
        state["rec$s_d2"] = jnp.full((1,), s_d2, jnp.float32)
        t_in = jnp.asarray([[0.8, 0.0, dopa_conc]], jnp.float32)
        valid = jnp.asarray([[True, True, True]])
        vs = []
        for _ in range(400):
            state, _ = model.step(state, jnp.zeros(1), t_in, valid)
            vs.append(float(state["v"][0]))
        return np.asarray(vs), state

    v_plain, s_plain = run(0.0, 0.9)
    v_d2, s_d2 = run(1.0, 0.9)
    # with D2 activation the inhibitory modifier shrinks -> less glutamate
    # current -> different (less excited) trajectory
    assert float(s_d2["rec$inh_modifier"][0]) < 0.2
    assert float(s_plain["rec$inh_modifier"][0]) == 1.0
    assert np.abs(v_plain - v_d2).max() > 1.0
    # spike counts: glutamate drives spiking; D2 suppression reduces it
    spikes_plain = (np.diff(v_plain) < -40).sum()
    spikes_d2 = (np.diff(v_d2) < -40).sum()
    assert spikes_plain >= spikes_d2


def test_run_static_input_with_gaussian_noise():
    """`run_static_input_*` with GaussianParameters noise
    (integrate_and_fire/mod.rs:40-58)."""
    import jax
    from spiking_neural_networks_jax.models.base import run_static_input
    model = snn.Izhikevich()
    state = model.init_state(3)
    state, volts = run_static_input(model, state, 30.0, 200,
                                    key=jax.random.PRNGKey(0),
                                    gaussian=(1.0, 0.2, 0.5, 1.5))
    v = np.asarray(volts)
    assert v.shape == (200, 3)
    assert np.isfinite(v).all()
    # noise decorrelates the three neurons' trajectories
    assert not np.allclose(v[:, 0], v[:, 1])


def test_bcm_poisson_spike_train_statistics():
    import jax
    model = snn.BCMPoissonSpikeTrain()
    s = model.init_state(200, chance_of_firing=0.05,
                         firing_rate_window=10.0)
    key = jax.random.PRNGKey(1)
    total = 0
    for clock in range(500):
        s, spk, key = model.step(s, key, clock)
        total += int(np.asarray(spk).sum())
    rate = total / (500 * 200)
    assert abs(rate - 0.05) < 0.01
    # activity tracking engaged
    assert float(np.abs(np.asarray(s["average_activity"])).max()) > 0
