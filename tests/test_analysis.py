"""Analysis-layer tests: PSD vs NumPy, EMD vs scipy construction, Pearson,
Hopfield attractor recovery, GA convergence, fitting smoke test (mirrors the
reference's eeg / attractors / ga test coverage)."""

import numpy as np
import pytest
import jax.numpy as jnp

from spiking_neural_networks_jax.analysis import eeg, correlation
from spiking_neural_networks_jax import attractors
from spiking_neural_networks_jax.fitting import (
    GeneticAlgorithmParameters, genetic_algo, decode_population)


def test_power_density_matches_numpy():
    rng = np.random.default_rng(0)
    dt, total_time = 0.1, 100.0
    t = np.arange(0, total_time, dt)
    x = (np.sin(2 * np.pi * 3.0 * t) + 0.5 * rng.normal(size=t.shape)).astype(np.float32)

    faxis, sxx = eeg.get_power_density(x, dt, total_time)
    # independent numpy construction (eeg/mod.rs:15-46)
    xf = np.fft.fft(x - x.mean())
    sxx_np = (2 * dt ** 2 / (len(x) * dt)) * np.real(xf * np.conj(xf))[: len(x) // 2]
    np.testing.assert_allclose(np.asarray(sxx), sxx_np, rtol=1e-3, atol=1e-3)
    # dominant frequency = 3 Hz
    assert abs(float(faxis[int(np.argmax(np.asarray(sxx)))]) - 3.0) < 0.1


def test_emd_matches_scipy_semantics():
    rng = np.random.default_rng(1)
    u = rng.random(32).astype(np.float32)
    v = rng.random(32).astype(np.float32)
    uw = rng.random(32).astype(np.float32)
    vw = rng.random(32).astype(np.float32)
    got = float(eeg.earth_moving_distance(u, v, uw, vw))

    # independent implementation of scipy's wasserstein_distance
    us, vs = np.sort(u), np.sort(v)
    allv = np.sort(np.concatenate([u, v]))
    deltas = np.diff(allv)
    ui = np.searchsorted(us, allv[:-1], side="right")
    vi = np.searchsorted(vs, allv[:-1], side="right")
    ucum = np.concatenate([[0], np.cumsum(uw[np.argsort(u)])])
    vcum = np.concatenate([[0], np.cumsum(vw[np.argsort(v)])])
    want = np.sum(np.abs(ucum[ui] / ucum[-1] - vcum[vi] / vcum[-1]) * deltas)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_power_density_comparison_zero_for_identical():
    x = np.sin(np.linspace(0, 20, 512)).astype(np.float32)
    _, sxx = eeg.get_power_density(x, 0.1, 51.2)
    assert float(eeg.power_density_comparison(sxx, sxx)) == 0.0


def test_pearsonr():
    rng = np.random.default_rng(2)
    x = rng.normal(size=100).astype(np.float32)
    y = 2 * x + rng.normal(scale=0.1, size=100).astype(np.float32)
    got = float(correlation.pearsonr(x, y))
    want = np.corrcoef(x, y)[0, 1]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # zero-variance input -> NaN (reference semantics)
    assert np.isnan(float(correlation.pearsonr(np.ones(10, np.float32), x[:10])))


def test_hopfield_recovers_patterns():
    """The reference's doc-test scenario (attractors/mod.rs:306-358)."""
    patterns = attractors.generate_random_patterns(10, 10, 3, 0.5, seed=4)
    w = attractors.generate_hopfield_network(patterns)
    lattice = attractors.DiscreteNeuronLattice(10, 10, w)
    for pattern in patterns:
        distorted = attractors.distort_pattern(pattern, 0.2, seed=5)
        lattice.input_pattern_into_discrete_grid(distorted)
        lattice.iterate(10)
        np.testing.assert_array_equal(lattice.convert_to_bools(), pattern)


def test_binary_hopfield_weights():
    patterns = attractors.generate_random_patterns(4, 4, 2, 0.5, seed=6)
    w = np.asarray(attractors.generate_binary_hopfield_network(
        patterns, a=0.5, b=0.5, scalar=1.0))
    flat = np.where(patterns.reshape(2, -1), 1.0, 0.0)
    want = ((flat - 0.5).T @ (flat - 0.5))
    np.fill_diagonal(want, 0.0)
    np.testing.assert_allclose(w, want, rtol=1e-6)


def test_decode_population():
    bits = jnp.asarray([[1, 1, 1, 1, 0, 0, 0, 0]])
    vals = decode_population(bits, [(0.0, 1.0), (-5.0, 5.0)], 4)
    np.testing.assert_allclose(np.asarray(vals), [[1.0, -5.0]], atol=1e-6)


@pytest.mark.slow
def test_genetic_algo_minimizes_quadratic():
    params = GeneticAlgorithmParameters(
        bounds=[(-5.0, 5.0), (-5.0, 5.0)], n_bits=10, n_iter=30, n_pop=64,
        r_cross=0.9, r_mut=0.05, k=3)

    def objective(decoded):
        return jnp.sum((decoded - jnp.asarray([1.5, -2.0])) ** 2, axis=-1)

    best, score, _ = genetic_algo(objective, params)
    assert score < 0.05
    np.testing.assert_allclose(best, [1.5, -2.0], atol=0.3)


def test_checkpoint_roundtrip():
    """Lattice checkpoint/resume is lossless (new capability vs reference)."""
    import tempfile, os
    import spiking_neural_networks_jax as snn
    from spiking_neural_networks_jax.utils import checkpoint as ckpt

    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(4, 4, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5, seed=2)
    lat.run_lattice(50)
    v_mid = lat.voltages().copy()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.npz")
        ckpt.save_lattice(lat, path)
        lat.run_lattice(50)
        v_end = lat.voltages().copy()
        ckpt.load_lattice(lat, path)
        assert lat.internal_clock == 50
        np.testing.assert_array_equal(lat.voltages(), v_mid)
        lat.run_lattice(50)
        np.testing.assert_allclose(lat.voltages(), v_end, rtol=1e-6)


@pytest.mark.slow
def test_fit_neuron_to_neuron_recovers_parameter():
    """End-to-end GA fitting (fitting/mod.rs:411+ scenario): recover the
    Izhikevich `a` parameter of a reference neuron from its spike summary."""
    import jax
    import spiking_neural_networks_jax as snn
    from spiking_neural_networks_jax.fitting import (
        FittingSettings, fit_neuron_to_neuron, get_reference_summary,
        GeneticAlgorithmParameters)

    model = snn.Izhikevich()
    st_model = snn.RateSpikeTrain()
    st_state = st_model.init_state(1, rate=2.0, v_th=30.0)

    true_a = 0.05
    ref_state = model.init_state(1, a=true_a, gap_conductance=10.0)
    ref_summary = get_reference_summary(model, ref_state, st_model, st_state,
                                        iterations=400)

    def converter(params):
        return {"a": params[0], "gap_conductance": 10.0}

    settings = FittingSettings(
        neuron_model=model, st_model=st_model,
        spike_train_states=[st_state],
        reference_summaries=[ref_summary[0]],
        scaling_factors=[(800.0, 10.0)],
        iterations=400, converter=converter)
    ga = GeneticAlgorithmParameters(bounds=[(0.01, 0.12)], n_bits=8,
                                    n_iter=10, n_pop=32, r_mut=0.08)
    best, score, _ = fit_neuron_to_neuron(settings, ga,
                                          key=jax.random.PRNGKey(3))
    # the fitted parameter should reproduce the reference's firing summary
    fit_state = model.init_state(1, a=float(best[0]), gap_conductance=10.0)
    fit_summary = get_reference_summary(model, fit_state, st_model, st_state,
                                        iterations=400)
    np.testing.assert_allclose(np.asarray(fit_summary),
                               np.asarray(ref_summary), rtol=0.1, atol=2.0)
    assert score < 1.0


@pytest.mark.slow
def test_coupled_neuron_utilities():
    """`iterate_coupled_spiking_neurons(_and_spike_train)` equivalents."""
    import jax.numpy as jnp
    import spiking_neural_networks_jax as snn
    from spiking_neural_networks_jax import coupling

    model = snn.Izhikevich()
    pre = model.init_state(1, gap_conductance=10.0)
    post = model.init_state(1, gap_conductance=10.0)
    for _ in range(500):
        pre, post, ps, qs = coupling.iterate_coupled_spiking_neurons(
            model, pre, post, jnp.asarray([40.0]))
    assert np.isfinite(float(post["v"][0]))

    st_model = snn.RateSpikeTrain()
    st = st_model.init_state(1, rate=1.0)
    pre = model.init_state(1, gap_conductance=10.0)
    post = model.init_state(1, gap_conductance=10.0)
    import jax
    key = jax.random.PRNGKey(0)
    fired = 0
    for t in range(400):
        st, pre, post, s1, s2, s3, key = \
            coupling.iterate_coupled_spiking_neurons_and_spike_train(
                st_model, model, st, pre, post, t)
        fired += int(s2[0])
    assert fired > 0  # spike train drive propagates to the presynaptic neuron


def test_step_timer():
    from spiking_neural_networks_jax.utils.profiling import StepTimer
    import spiking_neural_networks_jax as snn
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(4, 4, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5)
    r = StepTimer(lat).measure(iterations=50)
    assert r["steps_per_sec"] > 0 and r["neuron_updates_per_sec"] > 0


def test_network_checkpoint_roundtrip():
    """Network checkpoint/resume: reloading into a freshly-built network
    reproduces the exact trajectory of the uninterrupted run (and the
    structured-plan cache correctly invalidates on load)."""
    import tempfile, os
    import spiking_neural_networks_jax as snn
    from spiking_neural_networks_jax.utils import checkpoint as ckpt

    def build():
        exc = snn.Lattice(snn.Izhikevich(), id=0)
        exc.populate(4, 4, gap_conductance=10.0)
        exc.connect_stencil(radius=1.5, seed=2)
        exc.do_plasticity = True
        st = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(), id=1)
        st.populate(4, 4)
        st.state = snn.PoissonSpikeTrain().init_from_firing_rate(
            16, hertz=500.0, dt=0.1)
        net = snn.LatticeNetwork.generate_network([exc], [st])
        net.connect(1, 0, lambda a, b: a == b, lambda a, b: 30.0)
        return net, exc

    net, exc = build()
    net.run_lattices(100)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "net.npz")
        ckpt.save_network(net, path)
        net.run_lattices(100)
        v_ref = np.asarray(exc.state["v"]).copy()
        w_ref = np.asarray(net.connections[(1, 0)][2]).copy()

        net2, exc2 = build()
        ckpt.load_network(net2, path)
        net2.run_lattices(100)
        np.testing.assert_array_equal(np.asarray(exc2.state["v"]), v_ref)
        np.testing.assert_array_equal(
            np.asarray(net2.connections[(1, 0)][2]), w_ref)


def test_reward_lattice_checkpoint_roundtrip():
    """R-STDP lattice checkpoints carry trace state + dopamine; resume is
    exact."""
    import tempfile, os
    import spiking_neural_networks_jax as snn
    from spiking_neural_networks_jax.utils import checkpoint as ckpt

    def build():
        lat = snn.RewardModulatedLattice(snn.Izhikevich())
        lat.populate(4, 4, gap_conductance=10.0)
        lat.connect_stencil(radius=1.5)
        lat.apply(lambda s: {**s, "v": jnp.full_like(s["v"], -20.0)})
        return lat

    lat = build()
    lat.run_lattice_with_reward(0.5, 100)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "r.npz")
        ckpt.save_lattice(lat, path)
        lat.run_lattice_with_reward(0.5, 100)
        v_ref = np.asarray(lat.state["v"]).copy()
        c_ref = np.asarray(lat.trace["c"]).copy()

        lat2 = build()
        ckpt.load_lattice(lat2, path)
        assert abs(lat2.dopamine - 0.0) >= 0.0     # restored scalar
        lat2.run_lattice_with_reward(0.5, 100)
        np.testing.assert_array_equal(np.asarray(lat2.state["v"]), v_ref)
        np.testing.assert_array_equal(np.asarray(lat2.trace["c"]), c_ref)


@pytest.mark.slow
def test_fit_neuron_to_neuron_cross_family():
    """The reference's actual fit_neuron_to_neuron use (fitting/mod.rs:411):
    T and U are DIFFERENT model families.  Fit an Izhikevich neuron to an
    adaptive-LIF target's spiking summaries across two drive rates and
    assert the fitted scaled-summary distance beats tolerance."""
    import jax
    import spiking_neural_networks_jax as snn
    from spiking_neural_networks_jax.fitting import (
        FittingSettings, fit_neuron_to_neuron, get_reference_summary,
        GeneticAlgorithmParameters, scale_summary, compare_summary)

    target_model = snn.AdaptiveLeakyIntegrateAndFire()
    fit_model = snn.Izhikevich()
    st_model = snn.RateSpikeTrain()
    st_states = [st_model.init_state(1, rate=2.0, v_th=30.0),
                 st_model.init_state(1, rate=5.0, v_th=30.0)]

    target_state = target_model.init_state(1, gap_conductance=10.0)
    refs = [get_reference_summary(target_model, target_state, st_model, st,
                                  iterations=400) for st in st_states]
    scales = [(800.0, 10.0), (800.0, 10.0)]

    def converter(params):
        return {"a": params[0], "b": params[1], "c_m": params[2],
                "gap_conductance": 10.0}

    settings = FittingSettings(
        neuron_model=fit_model, st_model=st_model,
        spike_train_states=st_states,
        reference_summaries=[r[0] for r in refs],
        scaling_factors=scales, iterations=400, converter=converter)
    ga = GeneticAlgorithmParameters(
        bounds=[(0.005, 0.2), (0.1, 0.3), (25.0, 150.0)], n_bits=8,
        n_iter=12, n_pop=64, r_mut=0.08)
    best, score, _ = fit_neuron_to_neuron(settings, ga,
                                          key=jax.random.PRNGKey(5))
    assert np.isfinite(score)
    # fitted Izhikevich reproduces the ALIF target's summaries within
    # tolerance on the scaled metric (sum over both drive conditions)
    fit_state = fit_model.init_state(1, a=float(best[0]), b=float(best[1]),
                                     c_m=float(best[2]),
                                     gap_conductance=10.0)
    total = 0.0
    for st, ref, (ts, ps) in zip(st_states, refs, scales):
        fit_summary = get_reference_summary(fit_model, fit_state, st_model,
                                            st, iterations=400)
        total += float(compare_summary(
            scale_summary(fit_summary[0], ts, ps),
            scale_summary(ref[0], ts, ps)))
    assert total < 0.5, (total, np.asarray(best))
