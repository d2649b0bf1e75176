"""Ports of the remaining reference DSL test files (VERDICT r2 item 4).

Each test transcribes one of `/root/reference/build_test/nb_macro/tests/`:

* hodgkin_huxley.rs / morris_lecar.rs — DSL-defined conductance models with
  `continuous()` peak spike detection proven equal to the hand-written
  models (the reference files only compile-check the DSL; here we go
  further and assert trajectory equality).
* if_statements.rs — all if/elseif/else/nesting variants: voltage equality
  vs the plain reference LIF plus live flag assertions.
* shared_receptors.rs + neuron_receptor_integration.rs — multi-
  neurotransmitter receptor sets (ionotropic, metabotropic, multi-slot).
* ionotropic_channels.rs + ionotropic_channels_testing.rs — AMPA/NMDA/Mg/
  GABA monotonicity sweeps, batched into one state (the sweeps are the
  neuron axis — the vectorized form of the reference's per-config loops).
* kinetics_default_impl.rs — `kinetics:` spec binds the generated default.
* izhikevich_attractor.rs — DSL Izhikevich recalling Hopfield patterns in
  a lattice / an exc+inh network.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.core.history import SpikeHistory
from spiking_neural_networks_jax.dsl import neuron_builder
from spiking_neural_networks_jax.attractors import (
    distort_pattern, generate_binary_hopfield_network,
    generate_hopfield_network, generate_random_patterns)
from spiking_neural_networks_jax.ops.graph import DenseGraph


def _scan_spikes(model, s, i, t_in=None, valid=None, steps=1000):
    """Run `steps` iterations under one jitted lax.scan; return final state
    and per-neuron total spike counts."""
    def body(s, _):
        if t_in is None:
            s, sp = model.step(s, i)
        else:
            s, sp = model.step(s, i, t_in, valid)
        return s, sp

    def run(s):
        return jax.lax.scan(body, s, None, length=steps)

    s, sps = jax.jit(run)(s)
    return s, np.asarray(sps).astype(np.int64).sum(axis=0)


# ---------------------------------------------------------------------------
# hodgkin_huxley.rs — DSL HH (gating-variable channels, continuous()) equals
# the hand-written HodgkinHuxley
# ---------------------------------------------------------------------------

HH_NB = """
[ion_channel]
    type: DSLNa
    vars: e = 50, g = 120
    gating_vars: m, h
    on_iteration:
        m.alpha = 0.1 * ((v + 40.) / (1. - exp(-(v + 40.) / 10.)))
        m.beta = 4. * exp(-(v + 65.) / 18.)
        h.alpha = 0.07 * exp(-(v + 65.) / 20.)
        h.beta = 1. / (exp(-(v + 35.) / 10.) + 1.)
        m.update(dt)
        h.update(dt)
        current = m.state ^ 3 * h.state * g * (v - e)
[end]

[ion_channel]
    type: DSLK
    vars: e = -77, g = 36
    gating_vars: n
    on_iteration:
        n.alpha = 0.01 * (v + 55.) / (1. - exp(-(v + 55.) / 10.))
        n.beta = 0.125 * exp(-(v + 65.) / 80.)
        n.update(dt)
        current = n.state ^ 4 * g * (v - e)
[end]

[ion_channel]
    type: DSLKLeak
    vars: e = -55, g = 0.3
    on_iteration:
        current = g * (v - e)
[end]

[neuron]
    type: DSLHodgkinHuxley
    ion_channels: na = DSLNa, k = DSLK, kleak = DSLKLeak
    vars: v_th = 0, c_m = 1
    spike_detection: continuous()
    on_iteration:
        na.update_current(v)
        k.update_current(v)
        kleak.update_current(v)
        dv/dt = (i - (na.current + k.current + kleak.current)) / c_m
[end]
"""


def test_dsl_hodgkin_huxley_matches_handwritten():
    """DSL HH with Na/K/K-leak gating channels == models/hodgkin_huxley.py
    over an input sweep (nb_macro/tests/hodgkin_huxley.rs scenario, proven
    rather than just compiled)."""
    gen = neuron_builder(HH_NB)["DSLHodgkinHuxley"]
    model = gen()
    ref = snn.HodgkinHuxley()

    inputs = jnp.asarray(np.linspace(0.0, 100.0, 11), jnp.float32)
    s1 = model.init_state(11, v=-65.0, dt=0.01)
    s2 = ref.init_state(11, dt=0.01)

    def body1(s, _):
        s, sp = model.step(s, inputs)
        return s, (s["v"], sp)

    def body2(s, _):
        s, sp = ref.step(s, inputs)
        return s, (s["v"], sp)

    s1, (v1, sp1) = jax.jit(lambda s: jax.lax.scan(
        body1, s, None, length=2000))(s1)
    s2, (v2, sp2) = jax.jit(lambda s: jax.lax.scan(
        body2, s, None, length=2000))(s2)

    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2),
                               rtol=1e-4, atol=5e-3)
    # identical spike trains (peak detection on identical trajectories)
    np.testing.assert_array_equal(np.asarray(sp1), np.asarray(sp2))
    assert int(np.asarray(sp1).sum()) > 0, "vacuous: HH never spiked"


# ---------------------------------------------------------------------------
# morris_lecar.rs — DSL ML (steady-state channels) equals the hand-written
# MorrisLecar
# ---------------------------------------------------------------------------

ML_NB = """
[ion_channel]
    type: DSLReducedCalcium
    vars: e_ca = 120, g_ca = 4, v1 = -1.2, v2 = 18
    on_iteration:
        m_ss = 0.5 * (1. + tanh((v - v1) / v2))
        current = g_ca * m_ss * (v - e_ca)
[end]

[ion_channel]
    type: DSLKSteadyState
    vars: g_k = 8, v_k = -84, n = 0, phi = 0.067, v_3 = 12, v_4 = 17.4
    on_iteration:
        n_ss = 0.5 * (1. + tanh((v - v_3) / v_4))
        t_n = 1. / (phi * cosh((v - v_3) / (2. * v_4)))
        n += ((n_ss - n) / t_n) * dt
        current = g_k * n * (v - v_k)
[end]

[ion_channel]
    type: DSLLeak
    vars: e = -60, g = 2
    on_iteration:
        current = g * (v - e)
[end]

[neuron]
    type: DSLMorrisLecar
    ion_channels: ca = DSLReducedCalcium, k = DSLKSteadyState, leak = DSLLeak
    vars: v_th = 25, c_m = 6.6
    spike_detection: continuous()
    on_iteration:
        ca.update_current(v)
        k.update_current(v)
        leak.update_current(v)
        dv/dt = (i - leak.current - ca.current - k.current) / c_m
[end]
"""


def test_dsl_morris_lecar_matches_handwritten():
    """DSL Morris-Lecar == models/morris_lecar.py over an input sweep
    (nb_macro/tests/morris_lecar.rs scenario, with the reference file's
    m_inf/m_ss typo corrected so the calcium current is live)."""
    gen = neuron_builder(ML_NB)["DSLMorrisLecar"]
    model = gen()
    ref = snn.MorrisLecar()

    inputs = jnp.asarray(np.linspace(0.0, 200.0, 9), jnp.float32)
    s1 = model.init_state(9, v=-70.0, dt=0.01)
    s2 = ref.init_state(9, dt=0.01)

    def body(m):
        def f(s, _):
            s, sp = m.step(s, inputs)
            return s, (s["v"], sp)
        return f

    s1, (v1, sp1) = jax.jit(lambda s: jax.lax.scan(
        body(model), s, None, length=3000))(s1)
    s2, (v2, sp2) = jax.jit(lambda s: jax.lax.scan(
        body(ref), s, None, length=3000))(s2)

    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2),
                               rtol=1e-4, atol=5e-3)
    np.testing.assert_array_equal(np.asarray(sp1), np.asarray(sp2))
    assert int(np.asarray(sp1).sum()) > 0, "vacuous: ML never spiked"


# ---------------------------------------------------------------------------
# if_statements.rs — every if/elseif/else/nesting shape
# ---------------------------------------------------------------------------

IF_HEADER = """
[neuron]
    type: {name}
    vars: e = 0, v_reset = -75, v_th = -55{extra_vars}
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        dv/dt = (v - e) + i
{body}[end]
"""

VOLTAGES = np.asarray([-50., -40., -30., -20., -10., 0., 10., 20., 30., 40.,
                       50.], np.float32)


def _run_if_variant(name, extra_vars, body, steps=1000):
    """Run the variant over the reference's 11-current sweep (vectorized as
    the neuron axis) alongside the plain reference LIF; return final states
    of both plus the generated model's final env."""
    src = IF_HEADER.format(name=name, extra_vars=extra_vars, body=body)
    ref_src = IF_HEADER.format(name="PlainLIF", extra_vars="", body="")
    model = neuron_builder(src)[name]()
    ref = neuron_builder(ref_src)["PlainLIF"]()
    i = jnp.asarray(VOLTAGES)
    s1 = model.init_state(11, v=0.0)
    s2 = ref.init_state(11, v=0.0)

    def body1(s, _):
        s, _sp = model.step(s, i)
        return s, s["v"]

    def body2(s, _):
        s, _sp = ref.step(s, i)
        return s, s["v"]

    s1, v1 = jax.jit(lambda s: jax.lax.scan(body1, s, None, length=steps))(s1)
    s2, v2 = jax.jit(lambda s: jax.lax.scan(body2, s, None, length=steps))(s2)
    np.testing.assert_array_equal(
        np.asarray(v1), np.asarray(v2),
        err_msg=f"{name}: if-statement changed the voltage trajectory")
    return s1


def test_dsl_if_statement():
    s = _run_if_variant("BasicIf", ", flag = 0", """\
        [if] i < 0 [then]
            flag = 1
        [end]
""")
    np.testing.assert_array_equal(
        np.asarray(s["flag"]), np.where(VOLTAGES < 0, 1.0, 0.0))


def test_dsl_nested_if_statement():
    s = _run_if_variant("NestedIf", ", flag1 = 0, flag2 = 0", """\
        [if] i < 0 [then]
            flag1 = 1
            [if] i > -30 [then]
                flag2 = 2
            [end]
        [end]
""")
    np.testing.assert_array_equal(
        np.asarray(s["flag1"]), np.where(VOLTAGES < 0, 1.0, 0.0))
    np.testing.assert_array_equal(
        np.asarray(s["flag2"]),
        np.where((VOLTAGES < 0) & (VOLTAGES > -30), 2.0, 0.0))


def test_dsl_if_else_statement():
    s = _run_if_variant("ElseIfNeuron", ", flag = 0", """\
        [if] i < 0 [then]
            flag = 1
        [else]
            flag = 2
        [end]
""")
    np.testing.assert_array_equal(
        np.asarray(s["flag"]), np.where(VOLTAGES < 0, 1.0, 2.0))


def test_dsl_if_else_if_statement():
    s = _run_if_variant("ElseIf2", ", flag = 0", """\
        [if] i < 0 [then]
            flag = 1
        [elseif] i > 30 [then]
            flag = 2
        [end]
""")
    expected = np.where(VOLTAGES < 0, 1.0, np.where(VOLTAGES > 30, 2.0, 0.0))
    np.testing.assert_array_equal(np.asarray(s["flag"]), expected)


def test_dsl_if_else_if_else_statement():
    s = _run_if_variant("ElseIf3", ", flag = 0", """\
        [if] i < 0 [then]
            flag = 1
        [elseif] i > 30 [then]
            flag = 2
        [else]
            flag = 3
        [end]
""")
    expected = np.where(VOLTAGES < 0, 1.0, np.where(VOLTAGES > 30, 2.0, 3.0))
    np.testing.assert_array_equal(np.asarray(s["flag"]), expected)


def test_dsl_if_else_if_else_if_else():
    s = _run_if_variant("ElseIf4", ", flag = 0", """\
        [if] i < 0 [then]
            flag = 1
        [elseif] i > 20 [then]
            flag = 2
        [elseif] i > 0 [then]
            flag = 3
        [else]
            flag = 4
        [end]
""")
    expected = np.where(
        VOLTAGES < 0, 1.0, np.where(
            VOLTAGES > 20, 2.0, np.where(VOLTAGES > 0, 3.0, 4.0)))
    np.testing.assert_array_equal(np.asarray(s["flag"]), expected)


def test_dsl_if_else_if_nested():
    s = _run_if_variant("ElseIfNested", ", flag = 0", """\
        [if] i < 0 [then]
            flag = 1
        [elseif] i > 20 [then]
            [if] i >= 40 [then]
                flag = 2
            [else]
                flag = 3
            [end]
        [else]
            flag = 4
        [end]
""")
    expected = np.where(
        VOLTAGES < 0, 1.0, np.where(
            VOLTAGES > 20, np.where(VOLTAGES >= 40, 2.0, 3.0), 4.0))
    np.testing.assert_array_equal(np.asarray(s["flag"]), expected)


# ---------------------------------------------------------------------------
# shared_receptors.rs + neuron_receptor_integration.rs
# ---------------------------------------------------------------------------

SHARED_RECEPTORS_NB = """
[receptors]
    type: MultipleReceptors
    neurotransmitter: A
    vars: current = 0, g = 1, e = 0
    on_iteration:
        current = g * r * (v - e)
    neurotransmitter: B
    vars: current = 0, g = 1, e = 0
    on_iteration:
        current = 2 * g * r * (v - e)
[end]

[receptors]
    type: MixedReceptors
    vars: m = 0
    neurotransmitter: Iono
    vars: current = 0, g = 1, e = 0
    on_iteration:
        current = g * m * r * (v - e)
    neurotransmitter: Meta
    vars: s = 1
    on_iteration:
        m = s * r
[end]

[receptors]
    type: CombinedReceptors
    neurotransmitter: Combined
    receptors: r1, r2
    vars: current = 0, g1 = 2, e1 = 0, g2 = 2, e2 = 0
    on_iteration:
        current = g1 * r1 * (v - e1) + g2 * r2 * (v - e2)
[end]

[neuron]
    type: MultiIntegrateAndFire
    receptors: MultipleReceptors
    vars: e = 0, v_reset = -75, v_th = -55
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        dv/dt = (v - e) + i
[end]

[neuron]
    type: MixedIntegrateAndFire
    receptors: MixedReceptors
    vars: e = 0, v_reset = -75, v_th = -55
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        dv/dt = (v - e) + i
[end]

[neuron]
    type: ElectroChemicalIntegrateAndFire
    receptors: MultipleReceptors
    vars: e = 0, v_reset = -75, v_th = -55, modifier = 1
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        dv/dt = (v - e) + i
    on_electrochemical_iteration:
        receptors.update_receptor_kinetics(t, dt)
        receptors.set_receptor_currents(v, dt)
        dv/dt = (v - e) + i
        v = (modifier * -receptors.get_receptor_currents(dt, c_m)) + v
        synaptic_neurotransmitters.apply_t_changes()
[end]

[neuron]
    type: CombinedIntegrateAndFire
    receptors: CombinedReceptors
    vars: e = 0, v_reset = -75, v_th = -55
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        dv/dt = (v - e) + i
[end]
"""


@pytest.fixture(scope="module")
def shared_receptors():
    return neuron_builder(SHARED_RECEPTORS_NB)


def test_dsl_shared_multiple_receptors(shared_receptors):
    """More inserted receptor types -> more spikes
    (neuron_receptor_integration.rs test_multiple_receptors), with the
    (has_a, has_b) configs batched as three neurons."""
    model = shared_receptors["MultiIntegrateAndFire"]()
    assert model.type_names == ("A", "B")
    s = model.init_state(3, v=0.0)
    # neuron 0: no receptors; neuron 1: A; neuron 2: A + B (all g = 2)
    mask = np.zeros((3, 2), bool)
    mask[1, 0] = mask[2, 0] = mask[2, 1] = True
    s["rec$mask"] = jnp.asarray(mask)
    s["rec$A$g"] = jnp.full((3,), 2.0, jnp.float32)
    s["rec$B$g"] = jnp.full((3,), 2.0, jnp.float32)
    t_in = jnp.ones((3, 2), jnp.float32)
    valid = jnp.ones((3, 2), bool)
    _, counts = _scan_spikes(model, s, jnp.zeros(3), t_in, valid, steps=20000)
    assert counts[0] < counts[1] < counts[2], counts


def test_dsl_mixed_metabotropic_receptors(shared_receptors):
    """A metabotropic group (no `current`) only matters through the shared
    top-level var it writes (test_mixed_receptors)."""
    model = shared_receptors["MixedIntegrateAndFire"]()
    s = model.init_state(3, v=0.0)
    # neuron 0: none; neuron 1: Meta only; neuron 2: Meta + Iono (g = 2)
    mask = np.zeros((3, 2), bool)
    meta = model.type_index("Meta")
    iono = model.type_index("Iono")
    mask[1, meta] = mask[2, meta] = mask[2, iono] = True
    s["rec$mask"] = jnp.asarray(mask)
    s["rec$Iono$g"] = jnp.full((3,), 2.0, jnp.float32)
    t_in = jnp.ones((3, 2), jnp.float32)
    valid = jnp.ones((3, 2), bool)
    _, counts = _scan_spikes(model, s, jnp.zeros(3), t_in, valid, steps=20000)
    assert counts[0] == counts[1], counts      # meta alone adds no current
    assert counts[1] < counts[2], counts       # meta gates iono on


def test_dsl_combined_two_slot_receptors(shared_receptors):
    """`receptors: r1, r2` — one group with two receptor-kinetics slots
    equals two single-slot groups with matching conductances
    (test_combined_receptors); both slots track t exactly."""
    combined = shared_receptors["CombinedIntegrateAndFire"]()
    multi = shared_receptors["MultiIntegrateAndFire"]()
    for t in (0.0, 0.3, 0.7, 1.0):
        s1 = combined.init_state(1, v=0.0, dt=1.0)
        s1 = combined.insert_receptor(s1, "Combined")
        s2 = multi.init_state(1, v=0.0, dt=1.0)
        s2 = multi.insert_receptor(s2, "A", **{"A$g": 2.0})
        s2 = multi.insert_receptor(s2, "B", **{"B$g": 1.0})
        t1 = jnp.full((1, 1), t, jnp.float32)
        t2 = jnp.full((1, 2), t, jnp.float32)
        v1 = jnp.ones((1, 1), bool)
        v2 = jnp.ones((1, 2), bool)
        for _ in range(200):
            s1, sp1 = combined.step(s1, jnp.zeros(1), t1, v1)
            s2, sp2 = multi.step(s2, jnp.zeros(1), t2, v2)
            assert bool(sp1[0]) == bool(sp2[0])
        # both kinetics slots track the concentration (ApproximateReceptor)
        np.testing.assert_allclose(float(s1["rec$r"][0, 0]), t, atol=1e-6)
        np.testing.assert_allclose(float(s1["rec$r2"][0, 0]), t, atol=1e-6)
        a, b = np.asarray(s1["v"]), np.asarray(s2["v"])
        finite = np.isfinite(a) & np.isfinite(b)
        np.testing.assert_allclose(a[finite], b[finite], rtol=1e-4)


def test_dsl_custom_electrochemical_differing(shared_receptors):
    """A custom electrochemical body with modifier=3 amplifies receptor
    currents -> strictly more spikes than the default template
    (test_custom_electrochemical_differing)."""
    custom = shared_receptors["ElectroChemicalIntegrateAndFire"]()
    plain = shared_receptors["MultiIntegrateAndFire"]()
    ts = jnp.asarray(np.linspace(0.0, 1.0, 6), jnp.float32)
    n = 6
    s1 = custom.init_state(n, v=0.0, dt=1.0, modifier=3.0)
    s2 = plain.init_state(n, v=0.0, dt=1.0)
    for name, g in (("A", 2.0), ("B", 2.0)):
        s1 = custom.insert_receptor(s1, name, **{f"{name}$g": g})
        s2 = plain.insert_receptor(s2, name, **{f"{name}$g": g})
    t_in = jnp.stack([ts, ts], axis=1)
    valid = jnp.ones((n, 2), bool)
    _, c1 = _scan_spikes(custom, s1, jnp.zeros(n), t_in, valid, steps=1000)
    _, c2 = _scan_spikes(plain, s2, jnp.zeros(n), t_in, valid, steps=1000)
    total1, total2 = int(c1.sum()), int(c2.sum())
    assert total1 > total2, (total1, total2)


# ---------------------------------------------------------------------------
# kinetics_default_impl.rs
# ---------------------------------------------------------------------------

def test_dsl_kinetics_default_impl():
    """A neuron's `kinetics:` spec binds the DSL-defined kinetics as the
    generated default (kinetics_default_impl.rs test_types)."""
    out = neuron_builder("""
[neurotransmitter_kinetics]
    type: DefBoundedNT
    vars: t_max = 1, c = 0.001, conc = 0
    on_iteration:
        [if] is_spiking [then]
            conc = t_max
        [else]
            conc = 0
        [end]
        t = t + dt * -c * t + conc
        t = min(max(t, 0), t_max)
[end]

[receptor_kinetics]
    type: DefBoundedRec
    vars: r_max = 1
    on_iteration:
        r = min(max(t, 0), r_max)
[end]

[neuron]
    type: DefBasicIntegrateAndFire
    kinetics: DefBoundedNT, DefBoundedRec
    vars: e = 0, v_reset = -75, v_th = -55
    on_spike:
        v = v_reset
    spike_detection: v >= v_th
    on_iteration:
        dv/dt = -(v - e) + i
[end]
""")
    model = out["DefBasicIntegrateAndFire"]()
    # the generated default impl is parameterized by the DSL kinetics
    assert model.nt_kinetics == out["DefBoundedNT"]
    assert model.rec_kinetics == out["DefBoundedRec"]
    # and they are live: a spiking neuron releases bounded neurotransmitter
    s = model.init_state(1, v=-60.0)
    s = model.insert_neurotransmitter(s, "AMPA")
    for _ in range(300):
        s, _ = model.step(s, jnp.asarray([25.0]))
    t = float(s["nt$t"][0, model.type_index("AMPA")])
    assert 0.0 < t <= 1.0


# ---------------------------------------------------------------------------
# ionotropic_channels.rs + ionotropic_channels_testing.rs
# ---------------------------------------------------------------------------

IONOTROPIC_NB = """
[receptors]
    type: DSLIonotropic
    neurotransmitter: AMPA
    vars: current = 0, g = 1, e = 0
    on_iteration:
        current = g * r * (v - e)
    neurotransmitter: NMDA
    vars: current = 0, g = 0.6, mg = 0.3, e = 0
    on_iteration:
        current = 1 / (1 + (exp(-0.062 * v) * mg / 3.75)) * g * r * (v - e)
    neurotransmitter: GABA
    vars: current = 0, g = 1.2, e = -80
    on_iteration:
        current = g * r * (v - e)
[end]

[neuron]
    type: IonoLIF
    receptors: DSLIonotropic
    vars: v_reset = -75, v_th = -55, g = 0.1, e = 0
    on_spike: v = v_reset
    spike_detection: v > v_th
    on_iteration:
        dv/dt = -g * (v - e) + i
[end]
"""


def test_dsl_ionotropic_monotonicity():
    """AMPA ^, NMDA ^, Mg v, GABA v, AMPA+NMDA grid ^^ — the five
    ionotropic_channels_testing.rs sweeps, batched as one 55-neuron state
    under a single 10k-step scan."""
    model = neuron_builder(IONOTROPIC_NB)["IonoLIF"]()
    names = model.type_names
    assert names == ("AMPA", "NMDA", "GABA")
    levels = np.linspace(0.0, 1.0, 11).astype(np.float32)

    # rows 0-10: AMPA sweep; 11-21: NMDA sweep; 22-32: Mg sweep (t NMDA=1);
    # 33-43: GABA sweep (AMPA=1); 44-54: AMPA+NMDA diagonal band checks are
    # covered by the two single sweeps plus one joint row set below.
    n = 55
    s = model.init_state(n, v=0.0, dt=1.0)
    mask = np.zeros((n, 3), bool)
    t_in = np.zeros((n, 3), np.float32)
    mg = np.full(n, 0.3, np.float32)

    mask[0:11, 0] = True
    t_in[0:11, 0] = levels

    mask[11:22, 1] = True
    t_in[11:22, 1] = levels

    mask[22:33, 1] = True
    t_in[22:33, 1] = 1.0
    mg[22:33] = levels

    mask[33:44, 0] = True
    mask[33:44, 2] = True
    t_in[33:44, 0] = 1.0
    t_in[33:44, 2] = levels

    # joint sweep: AMPA level varies with NMDA fixed at 0.5
    mask[44:55, 0] = True
    mask[44:55, 1] = True
    t_in[44:55, 0] = levels
    t_in[44:55, 1] = 0.5

    s["rec$mask"] = jnp.asarray(mask)
    s["rec$NMDA$mg"] = jnp.asarray(mg)
    valid = jnp.ones((n, 3), bool)
    _, counts = _scan_spikes(model, s, jnp.zeros(n),
                             jnp.asarray(t_in), valid, steps=10000)

    def nondecreasing(c):
        return all(c[i] >= c[i - 1] for i in range(1, len(c)))

    def nonincreasing(c):
        return all(c[i] <= c[i - 1] for i in range(1, len(c)))

    ampa, nmda, mg_c, gaba, joint = (counts[0:11], counts[11:22],
                                     counts[22:33], counts[33:44],
                                     counts[44:55])
    assert nondecreasing(ampa) and ampa[0] < ampa[-1], ampa
    assert nondecreasing(nmda) and nmda[0] < nmda[-1], nmda
    assert nonincreasing(mg_c) and mg_c[0] > mg_c[-1], mg_c
    assert nonincreasing(gaba) and gaba[0] > gaba[-1], gaba
    assert nondecreasing(joint), joint
    # joint rows spike at least as much as the matching AMPA-only rows
    assert (joint >= ampa).all(), (joint, ampa)


# ---------------------------------------------------------------------------
# izhikevich_attractor.rs — DSL Izhikevich + Hopfield recall
# ---------------------------------------------------------------------------

DSL_IZHIKEVICH_NB = """
[neuron]
    type: AttractorIzhikevich
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


def _recall_accuracy(lat, pattern, threshold):
    counts = lat.grid_history.aggregate()
    predicted = counts >= threshold
    return float((predicted == np.asarray(pattern, bool)).mean())


@pytest.mark.slow
def test_dsl_izhikevich_attractor_bipolar():
    """A DSL-defined Izhikevich lattice wired with bipolar Hopfield weights
    recalls a distorted pattern (izhikevich_attractor.rs
    test_autoassociative_bipolar)."""
    gen = neuron_builder(DSL_IZHIKEVICH_NB)["AttractorIzhikevich"]
    accuracies = []
    for trial in range(3):
        model = gen()
        lat = snn.Lattice(model)
        lat.populate(7, 7, gap_conductance=10.0, v=-65.0, dt=1.0)
        patterns = generate_random_patterns(7, 7, 1, 0.5, seed=100 + trial)
        w = generate_hopfield_network(patterns)
        # the reference materializes every off-diagonal edge (incl. zero
        # weights, which count in input averaging) — see attractors.py
        lat.set_graph(DenseGraph(w, jnp.asarray(~np.eye(49, dtype=bool))))
        distorted = distort_pattern(patterns[0], 0.1, seed=trial)
        flat = jnp.asarray(np.asarray(distorted, bool).reshape(-1))
        lat.apply(lambda s: {**s, "v": jnp.where(flat, s["v_th"], s["c"])})
        lat.grid_history = SpikeHistory()
        lat.update_grid_history = True
        lat.run_lattice(1000)
        accuracies.append(_recall_accuracy(lat, patterns[0], threshold=5))
    assert sum(a > 0.9 for a in accuracies) >= 1, accuracies


@pytest.mark.slow
def test_dsl_izhikevich_attractor_binary_network():
    """Binary Hopfield exc lattice + inhibitory lattice in a network
    (izhikevich_attractor.rs test_electrical_autoassociative_binary)."""
    gen = neuron_builder(DSL_IZHIKEVICH_NB)["AttractorIzhikevich"]
    accuracies = []
    for trial in range(3):
        rng = np.random.default_rng(200 + trial)
        inh = snn.Lattice(gen(), id=0)
        inh.populate(3, 3, gap_conductance=10.0, dt=1.0,
                     v=rng.uniform(-55.0, 30.0, 9).astype(np.float32))
        inh.connect(lambda x, y: x != y, lambda x, y: -1.5)

        exc = snn.Lattice(gen(), id=1)
        exc.populate(5, 5, gap_conductance=10.0, v=-65.0, dt=1.0)
        patterns = generate_random_patterns(5, 5, 1, 0.5, seed=300 + trial)
        w = generate_binary_hopfield_network(patterns, 1.0, 1.0, 0.5)
        # full off-diagonal mask: zero-weight edges count in input averaging
        exc.set_graph(DenseGraph(w, jnp.asarray(~np.eye(25, dtype=bool))))
        distorted = distort_pattern(patterns[0], 0.1, seed=trial)
        flat = jnp.asarray(np.asarray(distorted, bool).reshape(-1))
        exc.apply(lambda s: {**s, "v": jnp.where(flat, s["v_th"], s["c"])})
        exc.grid_history = SpikeHistory()
        exc.update_grid_history = True

        net = snn.LatticeNetwork.generate_network([inh, exc], [])
        net.connect(0, 1, lambda a, b: True, lambda a, b: -2.0)
        net.connect(1, 0, lambda a, b: True, lambda a, b: 1.0)
        net.run_lattices(1000)
        accuracies.append(_recall_accuracy(
            net.get_lattice(1), patterns[0], threshold=10))
    assert sum(accuracies) / 3 >= 0.85, accuracies
