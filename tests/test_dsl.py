"""DSL tests: generated models vs handwritten models, exact equality over
1000 steps across input sweeps — the reference's own DSL test strategy
(nb_macro/tests/basic_lif.rs:26-50, izhikevich_testing.rs)."""

import numpy as np
import pytest
import jax.numpy as jnp

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.dsl import neuron_builder

IZHIKEVICH_NB = """
[neuron]
    type: DSLIzhikevich
    vars: w = 30, a = 0.02, b = 0.2, c = -55, d = 8, v_th = 30, tau_m = 1, c_m = 100
    on_spike:
        v = c
        w += d
    spike_detection: v >= v_th
    on_iteration:
        dw/dt = (a * (b * v - w)) / tau_m
        dv/dt = (0.04 * v * v + 5 * v + 140 - w + i) / c_m
[end]
"""


def test_dsl_izhikevich_matches_handwritten():
    gen = neuron_builder(IZHIKEVICH_NB)["DSLIzhikevich"]
    model = gen()
    ref = snn.Izhikevich()

    inputs = jnp.asarray([0.0, 10.0, 30.0, 50.0])
    s1 = model.init_state(4, v=-65.0)
    s2 = ref.init_state(4)
    for _ in range(1000):
        s1, sp1 = model.step(s1, inputs)
        s2, sp2 = ref.step(s2, inputs)
    # not bit-exact: the DSL expresses dv as (expr / c_m) * dt while the
    # handwritten model uses expr * (dt / c_m) — same association difference
    # the reference's own DSL-generated models have vs backend models
    np.testing.assert_allclose(np.asarray(s1["v"]), np.asarray(s2["v"]),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(np.asarray(s1["w"]), np.asarray(s2["w"]),
                               rtol=1e-6, atol=1e-4)


@pytest.mark.slow
def test_dsl_izhikevich_chemical_matches_handwritten():
    gen = neuron_builder(IZHIKEVICH_NB)["DSLIzhikevich"]
    model = gen()
    ref = snn.Izhikevich()
    s1 = model.init_state(2, v=-65.0)
    s2 = ref.init_state(2)
    for m in (model, ref):
        pass
    for t in ("AMPA", "NMDA", "GABA"):
        s1 = model.insert_receptor(s1, t)
        s2 = ref.insert_receptor(s2, t)
    t_in = jnp.full((2, 3), 0.5, jnp.float32)
    valid = jnp.ones((2, 3), bool)
    i = jnp.asarray([10.0, 40.0])
    for _ in range(500):
        s1, _ = model.step(s1, i, t_in, valid)
        s2, _ = ref.step(s2, i, t_in, valid)
    np.testing.assert_allclose(np.asarray(s1["v"]), np.asarray(s2["v"]),
                               rtol=1e-6, atol=1e-5)


def test_dsl_lif_nb_file_format():
    """The reference's example .nb file parses and runs
    (nb_macro/tests/lif.nb)."""
    src = """[neuron]
    type: BasicIntegrateAndFire
    vars: e = 0, v_reset = -75, v_th = -55
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        dv/dt = (v - e) + i
[end]"""
    gen = neuron_builder(src)["BasicIntegrateAndFire"]
    model = gen()
    s = model.init_state(1, v=-75.0)
    assert float(s["e"][0]) == 0.0
    assert float(s["gap_conductance"][0]) == 10.0  # injected default
    for _ in range(100):
        s, spk = model.step(s, jnp.asarray([50.0]))
    assert np.isfinite(float(s["v"][0]))


def test_dsl_rate_spike_train_matches_handwritten():
    src = """[spike_train]
    type: DSLRateSpikeTrain
    vars: step = 0., rate = 0.
    on_iteration:
        step += dt
        [if] rate != 0. && step >= rate [then]
            step = 0
            current_voltage = v_th
            is_spiking = true
        [else]
            current_voltage = v_resting
            is_spiking = false
        [end]
[end]"""
    gen = neuron_builder(src)["DSLRateSpikeTrain"]
    model = gen()
    ref = snn.RateSpikeTrain()
    import jax
    key = jax.random.PRNGKey(0)
    s1 = model.init_state(2, rate=1.0)
    s2 = ref.init_state(2, rate=1.0)
    for clock in range(50):
        s1, sp1, key = model.step(s1, key, clock)
        s2, sp2, key = ref.step(s2, key, clock)
        np.testing.assert_array_equal(np.asarray(sp1), np.asarray(sp2))
        np.testing.assert_array_equal(np.asarray(s1["v"]), np.asarray(s2["v"]))


@pytest.mark.slow
def test_dsl_bounded_kinetics_and_dopa_receptors():
    """The full lixirnet model definition compiles and matches the
    hand-built DopaIzhikevich (interface_gpu/lixirnet/src/lib.rs:22-79)."""
    src = """
[neurotransmitter_kinetics]
    type: DSLBoundedNeurotransmitterKinetics
    vars: t_max = 1, clearance_constant = 0.001, conc = 0
    on_iteration:
        [if] is_spiking [then]
            conc = t_max
        [else]
            conc = 0
        [end]

        t = t + dt * -clearance_constant * t + conc

        t = min(max(t, 0), t_max)
[end]

[receptor_kinetics]
    type: DSLBoundedReceptorKinetics
    vars: r_max = 1
    on_iteration:
        r = min(max(t, 0), r_max)
[end]

[receptors]
    type: DSLDopaGluGABA
    kinetics: DSLBoundedReceptorKinetics
    vars: inh_modifier = 1, nmda_modifier = 1
    neurotransmitter: Glutamate
    receptors: ampa_r, nmda_r
    vars: current = 0, g_ampa = 1, g_nmda = 0.6, e_ampa = 0, e_nmda = 0, mg = 0.3
    on_iteration:
        current = inh_modifier * g_ampa * ampa_r * (v - e_ampa) + (1 / (1 + (exp(-0.062 * v) * mg / 3.57))) * inh_modifier * g_nmda * (nmda_r r^ nmda_modifier) * (v - e_nmda)
    neurotransmitter: GABA
    vars: current = 0, g = 1.2, e = -80
    on_iteration:
        current = g * r * (v - e)
    neurotransmitter: Dopamine
    receptors: r_d1, r_d2
    vars: s_d2 = 0, s_d1 = 0
    on_iteration:
        inh_modifier = 1 - (r_d2 * s_d2)
        nmda_modifier = 1 - (r_d1 * s_d1)
[end]

[neuron]
    type: DSLDopaIzhikevich
    kinetics: DSLBoundedNeurotransmitterKinetics, DSLBoundedReceptorKinetics
    receptors: DSLDopaGluGABA
    vars: w = 30, a = 0.02, b = 0.2, c = -55, d = 8, v_th = 30, tau_m = 1, c_m = 100
    on_spike:
        v = c
        w += d
    spike_detection: v >= v_th
    on_iteration:
        dw/dt = (a * (b * v - w)) / tau_m
        dv/dt = (0.04 * v * v + 5 * v + 140 - w + i) / c_m
[end]
"""
    out = neuron_builder(src)
    gen = out["DSLDopaIzhikevich"]
    model = gen()
    assert model.type_names == ("Glutamate", "GABA", "Dopamine")

    hand = snn.DopaIzhikevich()
    s1 = model.init_state(2, v=-65.0)
    s2 = hand.init_state(2)
    for t in ("Glutamate", "GABA", "Dopamine"):
        s1 = model.insert_receptor(s1, t)
        s2 = hand.insert_receptor(s2, t)
    s1["rec$Dopamine$s_d2"] = jnp.full((2,), 0.8, jnp.float32)
    s2["rec$s_d2"] = jnp.full((2,), 0.8, jnp.float32)
    # neurotransmitter release check too
    s1 = model.insert_neurotransmitter(s1, "Glutamate")
    s2 = hand.insert_neurotransmitter(s2, "Glutamate")

    t_in = jnp.asarray([[0.7, 0.2, 0.6], [0.7, 0.2, 0.6]], jnp.float32)
    valid = jnp.ones((2, 3), bool)
    i = jnp.asarray([20.0, 35.0])
    for it in range(500):
        s1, sp1 = model.step(s1, i, t_in, valid)
        s2, sp2 = hand.step(s2, i, t_in, valid)
        np.testing.assert_allclose(
            np.asarray(s1["v"]), np.asarray(s2["v"]), rtol=1e-5, atol=1e-4,
            err_msg=f"step {it}")
    np.testing.assert_allclose(np.asarray(s1["nt$t"]), np.asarray(s2["nt$t"]),
                               rtol=1e-5, atol=1e-6)


def test_dsl_ion_channel_based_neuron():
    """Reference nb_macro/tests/ion_channel_based_neuron.rs scenario."""
    src = """
[ion_channel]
    type: TestLeak
    vars: e = 0, g = 1
    on_iteration:
        current = g * (v - e)
[end]

[neuron]
    type: ChannelLIF
    ion_channels: l = TestLeak
    vars: v_reset = -75, v_th = -55
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        l.update_current(v)
        dv/dt = l.current + i
[end]
"""
    out = neuron_builder(src)
    model = out["ChannelLIF"]()
    s = model.init_state(2, v=-75.0)
    assert "l$current" in s and "l$g" in s
    # independent manual euler: v += dt * (g*(v-e) + i)
    v_ref = np.float32(-75.0)
    for _ in range(300):
        s, spk = model.step(s, jnp.asarray([20.0, 20.0]))
        cur = np.float32(1.0) * (v_ref - np.float32(0.0))
        v_ref = v_ref + np.float32(0.1) * (cur + np.float32(20.0))
        if v_ref >= -55.0:
            v_ref = np.float32(-75.0)
        np.testing.assert_allclose(float(s["v"][0]), v_ref, rtol=1e-5,
                                   atol=1e-4)


def test_dsl_gating_variable_channel():
    """Reference nb_macro/tests/gating_variables_ion_channel.rs scenario."""
    src = """
[ion_channel]
    type: TestChannel
    vars: e = 0, g = 1
    gating_vars: n
    on_iteration:
        current = g * n.alpha * n.beta * n.state * (v - e)
[end]
"""
    out = neuron_builder(src)
    leak = out["TestChannel"]()
    leak.set_gating("n", alpha=1.0, beta=1.0, state=1.0)
    for v in [-50.0, -20.0, 0.0, 30.0]:
        assert abs(leak.update_current(v) - v) < 1e-6
    leak.g = 2.0
    for v in [-50.0, 10.0]:
        assert abs(leak.update_current(v) - 2 * v) < 1e-5


def test_dsl_gating_update_in_channel():
    """Channel using n.update(dt) — the HH-style Euler gate."""
    src = """
[ion_channel]
    type: GateChan
    vars: g = 2, e = -10
    gating_vars: m
    on_iteration:
        m.update(dt)
        current = g * m.state * (v - e)
[end]
"""
    out = neuron_builder(src)
    ch = out["GateChan"]()
    ch.set_gating("m", alpha=0.5, beta=0.25, state=0.0)
    cur = ch.update_current(0.0, dt=0.1)
    # state after one update: 0 + 0.1*(0.5*1 - 0) = 0.05
    np.testing.assert_allclose(ch.state["m$state"][0], 0.05, rtol=1e-6)
    np.testing.assert_allclose(cur, 2 * 0.05 * (0.0 - (-10.0)), rtol=1e-5)


ELECTROCHEM_NB = """
[neuron]
    type: ElectroChemIzhikevich
    vars: w = 30, a = 0.02, b = 0.2, c = -55, d = 8, v_th = 30, tau_m = 1, c_m = 100, modifier = 1
    on_spike:
        v = c
        w += d
    spike_detection: v >= v_th
    on_iteration:
        dw/dt = (a * (b * v - w)) / tau_m
        dv/dt = (0.04 * v * v + 5 * v + 140 - w + i) / c_m
    on_electrochemical_iteration:
        receptors.update_receptor_kinetics(t, dt)
        receptors.set_receptor_currents(v, dt)
        dw/dt = (a * (b * v - w)) / tau_m
        dv/dt = (0.04 * v * v + 5 * v + 140 - w + i) / c_m
        v = (modifier * -receptors.get_receptor_currents(dt, c_m)) + v
        synaptic_neurotransmitters.apply_t_changes()
[end]
"""


@pytest.mark.slow
def test_dsl_custom_electrochemical_iteration():
    """A custom [on_electrochemical_iteration] body that spells out the
    default template (nb_macro neuron_receptor_integration.rs:53-58) must
    match the built-in chemical path exactly; modifier != 1 must diverge."""
    gen = neuron_builder(ELECTROCHEM_NB)["ElectroChemIzhikevich"]
    model = gen()
    ref = snn.Izhikevich()
    s1 = model.init_state(2, v=-65.0)
    s2 = ref.init_state(2)
    for t in ("AMPA", "NMDA", "GABA"):
        s1 = model.insert_receptor(s1, t)
        s2 = ref.insert_receptor(s2, t)
    s1 = model.insert_neurotransmitter(s1, "AMPA")
    s2 = ref.insert_neurotransmitter(s2, "AMPA")
    t_in = jnp.full((2, 3), 0.5, jnp.float32)
    valid = jnp.ones((2, 3), bool)
    i = jnp.asarray([10.0, 40.0])
    for _ in range(300):
        s1, _ = model.step(s1, i, t_in, valid)
        s2, _ = ref.step(s2, i, t_in, valid)
    np.testing.assert_allclose(np.asarray(s1["v"]), np.asarray(s2["v"]),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s1["nt$t"]), np.asarray(s2["nt$t"]),
                               rtol=1e-6, atol=1e-6)

    # the body is live: doubling the receptor-current modifier diverges
    s3 = model.init_state(2, v=-65.0, modifier=2.0)
    for t in ("AMPA", "NMDA", "GABA"):
        s3 = model.insert_receptor(s3, t)
    s3 = model.insert_neurotransmitter(s3, "AMPA")
    for _ in range(300):
        s3, _ = model.step(s3, i, t_in, valid)
    assert not np.allclose(np.asarray(s3["v"]), np.asarray(s1["v"]))

    # electrical-only path still uses on_iteration (no receptors touched)
    s4 = model.init_state(2, v=-65.0)
    s5 = ref.init_state(2)
    for _ in range(300):
        s4, _ = model.step(s4, i)
        s5, _ = ref.step(s5, i)
    np.testing.assert_allclose(np.asarray(s4["v"]), np.asarray(s5["v"]),
                               rtol=1e-6, atol=1e-5)


def test_dsl_electrochemical_in_chemical_lattice():
    """The custom electrochemical body runs inside a chemical-synapse
    lattice scan (the full jit path, not just neuron.step)."""
    gen = neuron_builder(ELECTROCHEM_NB)["ElectroChemIzhikevich"]
    model = gen()
    lat = snn.Lattice(model)
    lat.populate(4, 4, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5, seed=0)
    lat.electrical_synapse = False
    lat.chemical_synapse = True
    s = lat.state
    for t in ("AMPA", "NMDA"):
        s = model.insert_receptor(s, t)
        s = model.insert_neurotransmitter(s, t)
    s["v"] = jnp.asarray(
        np.random.default_rng(0).uniform(-65, 30, 16), jnp.float32)
    lat.state = s
    lat.run_lattice(200)
    assert np.isfinite(np.asarray(lat.state["v"])).all()
    # NT concentrations were driven by the explicit apply_t_changes call
    assert float(np.abs(np.asarray(lat.state["nt$t"])).max()) > 0.0


FUNC_DECL_NB = """
[neuron]
    type: FuncDeclNeuron
    vars: v_reset = -75, v_th = -55, e = 0, alpha = 2
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        f(x, y) = x + alpha * y
        g(x) = f(x, x) - e
        dv/dt = f(e - v, i) + g(0.5)
[end]
"""


def test_dsl_func_declaration():
    """`f(x, y) = expr` user functions (func_declaration,
    pest_ast/mod.rs:54-55): usable in later statements, can reference model
    vars as free variables, and compose with other user functions."""
    gen = neuron_builder(FUNC_DECL_NB)["FuncDeclNeuron"]
    model = gen()
    inputs = jnp.asarray([0.0, 5.0, 20.0])
    s = model.init_state(3, v=-70.0)
    v = np.full(3, -70.0, np.float32)
    for _ in range(500):
        s, spikes = model.step(s, inputs)
        # handwritten equivalent: f(x,y)=x+2y; g(x)=3x-e; dv = f(e-v,i)+g(.5)
        dv = ((0.0 - v) + 2.0 * np.asarray(inputs)) + (0.5 + 2.0 * 0.5 - 0.0)
        v = v + 0.1 * dv
        spiked = v >= -55.0
        v = np.where(spiked, -75.0, v)
        np.testing.assert_allclose(np.asarray(s["v"]), v, rtol=1e-5,
                                   atol=1e-4)


BOOL_VARS_NB = """
[neuron]
    type: BoolVarNeuron
    vars: e = 0, v_reset = -75, v_th = -55, flag = false, out = 0
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        [if] flag [then]
            out = 1
        [else]
            out = 2
        [end]
        dv/dt = (v - e) + i
[end]
"""


def test_dsl_bool_vars():
    """Boolean vars with `false` defaults driving [if] branches
    (nb_macro/tests/bool_vars.rs)."""
    gen = neuron_builder(BOOL_VARS_NB)["BoolVarNeuron"]
    model = gen()
    s = model.init_state(2, v=-70.0)
    s["flag"] = jnp.asarray([0.0, 1.0])   # per-neuron flag
    s, _ = model.step(s, jnp.zeros(2))
    np.testing.assert_array_equal(np.asarray(s["out"]), [2.0, 1.0])


TAN_NB = """
[neuron]
    type: TanNeuron
    vars: v_reset = -75, v_th = 50000
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        v = tan(i)
[end]
"""


def test_dsl_builtin_functions_sweep():
    """Builtin function coverage incl. tan
    (nb_macro/tests/function_usage.rs): exact equality across the
    reference's input sweep."""
    gen = neuron_builder(TAN_NB)["TanNeuron"]
    model = gen()
    inputs = jnp.asarray(np.arange(-10, 10, dtype=np.float32))
    s = model.init_state(20)
    s, _ = model.step(s, inputs)
    np.testing.assert_allclose(np.asarray(s["v"]),
                               np.tan(np.arange(-10, 10, dtype=np.float32)),
                               rtol=1e-6)


def test_dsl_struct_assignment_ion_channels():
    """`ion_channels: l = TypeName` struct assignments inside [neuron]
    (struct_assignment, pest_ast/mod.rs:70; parsed + instantiated)."""
    src = """
[ion_channel]
    type: SimpleLeak
    vars: current = 0, e = -80, g = 0.1
    on_iteration:
        current = g * (v - e)
[end]

[neuron]
    type: LeakAssignNeuron
    vars: v_reset = -75, v_th = -55
    ion_channels: l1 = SimpleLeak, l2 = SimpleLeak
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        l1.update_current(v)
        l2.update_current(v)
        dv/dt = i - l1.current - l2.current
[end]
"""
    gen = neuron_builder(src)["LeakAssignNeuron"]
    model = gen()
    s = model.init_state(2, v=-70.0)
    assert "l1$current" in s and "l2$current" in s
    s, _ = model.step(s, jnp.zeros(2))
    # leak current of each channel: 0.1 * (-70 + 80) = 1.0
    np.testing.assert_allclose(np.asarray(s["l1$current"]), 1.0, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(s["v"]), -70.0 + 0.1 * (0.0 - 1.0 - 1.0), rtol=1e-6)


def test_dsl_duplicate_variable_rejected():
    """Duplicate names in a `vars:` section fail to compile, matching the
    reference's compile_fail doctest (nb_macro/tests/duplicate_variables.rs)."""
    with pytest.raises(SyntaxError, match="duplicate variable"):
        neuron_builder("""
[neuron]
    type: DupVarNeuron
    vars: e = 0, e = 1, v_reset = -75, v_th = -55
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        dv/dt = (v - e) + i
[end]
""")


def test_dsl_duplicate_definition_rejected():
    """Two blocks defining the same type name collide (a Rust struct name
    collision in the reference's macro expansion)."""
    src = """
[neuron]
    type: TwiceDefined
    vars: e = 0
    on_spike:
        v = -75
    spike_detection: v >= -55
    on_iteration:
        dv/dt = (v - e) + i
[end]
"""
    with pytest.raises(SyntaxError, match="duplicate definition"):
        neuron_builder(src + src)


def test_dsl_mandatory_vars_injected():
    """Mandatory iterate-and-spike fields (current_voltage, is_spiking,
    dt, gap conductance) are injected with defaults even when the block
    declares none of them (nb_macro mandatory_vars_tests crate)."""
    out = neuron_builder("""
[neuron]
    type: MinimalNeuron
    vars: e = 0
    on_spike:
        v = -75
    spike_detection: v >= -55
    on_iteration:
        dv/dt = (v - e) + i
[end]
""")
    model = out["MinimalNeuron"]()
    state = model.init_state(4)
    for key in ("v", "is_spiking", "last_firing_time", "dt",
                "gap_conductance"):
        assert key in state, key
    assert state["v"].shape == (4,)


def test_dsl_neural_refractoriness_matches_delta_dirac():
    """Port of nb_macro/tests/delta_dirac_refractoriness.rs: a DSL
    [neural_refractoriness] block spelling out the Gaussian-decay effect
    must match the built-in DeltaDiracRefractoriness for random decay /
    times / amplitudes."""
    from spiking_neural_networks_jax.models.spike_train import REFRACTORINESS

    neuron_builder("""
[neural_refractoriness]
    type: TestRefractoriness
    effect: (v_th - v_resting) * exp((-1 / (decay / dt)) * (time_difference ^ 2)) + v_resting
[end]
""")
    assert "TestRefractoriness" in REFRACTORINESS
    rng = np.random.default_rng(3)
    for _ in range(50):
        decay = jnp.float32(rng.uniform(0.0, 20000.0))
        lft = int(rng.integers(0, 1000))
        timestep = int(rng.integers(lft, lft + 1000))
        v_max = jnp.float32(rng.uniform(10.0, 30.0))
        v_resting = jnp.float32(0.0)
        dt = jnp.float32(0.1)
        diff = jnp.float32(timestep - lft)
        ours = REFRACTORINESS["delta_dirac"](decay, v_max - v_resting, diff,
                                             v_resting, dt)
        generated = REFRACTORINESS["TestRefractoriness"](
            decay, v_max - v_resting, diff, v_resting, dt)
        np.testing.assert_allclose(float(ours), float(generated), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.slow
def test_dsl_timestep_dependent_ion_channel():
    """Port of nb_macro/tests/timestep_dependent_ion_channel.rs: a calcium
    channel whose alpha/beta are voltage expressions, with `s.update(dt)`
    and `current = g * -(s.state ^ 2) * (v - e)`, checked against a
    hand-written f32 reference at 9 voltages x 1000 steps."""
    out = neuron_builder("""
[ion_channel]
    type: CalciumIonChannel
    vars: e = 80, g = 0.025
    gating_vars: s
    on_iteration:
        s.alpha = 1.6 / (1 + exp(-0.072 * (v - 5)))
        s.beta = (0.02 * (v + 8.9)) / ((exp(v + 8.9) / 5) - 1)
        s.update(dt)
        current = g * -(s.state ^ 2) * (v - e)
[end]
""")
    f32 = np.float32

    def reference(voltage, steps, dt=0.01):
        # ReferenceCalciumIonChannel (timestep_dependent_ion_channel.rs:7-48)
        s_state, current = f32(0.0), f32(0.0)
        g_ca, e_ca = f32(0.025), f32(80.0)
        v, dt = f32(voltage), f32(dt)
        outs = []
        for _ in range(steps):
            alpha = f32(1.6) / (f32(1.0) + np.exp(f32(-0.072) * (v - f32(5.0)),
                                                  dtype=f32))
            beta = (f32(0.02) * (v + f32(8.9))) \
                / ((np.exp(v + f32(8.9), dtype=f32) / f32(5.0)) - f32(1.0))
            # BasicGatingVariable::update (ion_channels/mod.rs:40-44)
            s_state = s_state + dt * (alpha * (f32(1.0) - s_state)
                                      - beta * s_state)
            current = -s_state ** f32(2.0) * g_ca * (v - e_ca)
            outs.append(float(current))
        return outs

    for voltage in (-50.0, -40.0, -30.0, -20.0, -10.0, 0.0, 10.0, 20.0,
                    30.0):
        ch = out["CalciumIonChannel"]()
        ref = reference(voltage, 200)
        for k in range(200):
            cur = ch.update_current(voltage, dt=0.01)
        np.testing.assert_allclose(float(np.asarray(cur).reshape(-1)[0]),
                                   ref[-1], rtol=1e-5, atol=1e-8,
                                   err_msg=f"v={voltage}")
