"""Hand-derived golden fixtures.

The constants below were produced by tests/golden_derivation.py — a
line-by-line float32 transcription of the cited Rust statements, written
independently of the framework AND of tests/reference_impl.py.  The literal
values are committed (not recomputed from the derivation alone) so that a
later edit to either implementation that shifts the numbers fails loudly;
the derivation script is additionally cross-checked against the constants.

Fidelity target: rtol 1e-5 vs the Rust reference equations (BASELINE.md).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import spiking_neural_networks_jax as snn
from golden_derivation import izhikevich_trace, lif_trace, hh_trace

# (input, step_index (1-based), expected (v, w)) from golden_derivation.py
IZH_FIXTURES = [
    (10.0, 1, (-65.03600311279297, 29.913999557495117)),
    (10.0, 2, (-65.07190704345703, 29.828157424926758)),
    (10.0, 3, (-65.10771942138672, 29.74247169494629)),
    (10.0, 100, (-68.15202331542969, 22.137161254882812)),
    (10.0, 1000, (-72.3055648803711, -8.525339126586914)),
    (50.0, 1, (-64.99600219726562, 29.913999557495117)),
    (50.0, 100, (-64.20713806152344, 22.21077537536621)),
    (50.0, 1000, (-29.979511260986328, -4.114350318908691)),
]

# (input, step_index, expected (v, refractory_count)), first spikes at steps
# 110, 320, 530, ... (1-based)
LIF_FIXTURES = [
    (300.0, 1, (-74.69999694824219, 0.0)),
    (300.0, 2, (-74.40299987792969, 0.0)),
    (300.0, 100, (-55.98097610473633, 0.0)),
]
LIF_SPIKE_STEPS = [110, 320, 530, 740, 950]

# (input, step_index, expected (v, m, h, n)); peak-detected spikes at steps
# 203 and 1215 (1-based)
HH_FIXTURES = [
    (25.0, 1, (-64.72000122070312, 0.0022356375120580196,
               0.000699999975040555, 0.0005819766083732247)),
    (25.0, 2, (-64.44084167480469, 0.004421653691679239,
               0.0013894442236050963, 0.0011724268551915884)),
    (25.0, 1000, (-53.21112060546875, 0.16999994218349457,
                  0.24712376296520233, 0.45368874073028564)),
    (25.0, 2000, (-57.16706085205078, 0.11498002707958221,
                  0.3369198143482208, 0.4496263265609741)),
]
HH_SPIKE_STEPS = [203, 1215]


def test_derivation_matches_committed_constants():
    """Guard: the committed literals ARE what the transcription computes."""
    for i, step, (v, w) in IZH_FIXTURES:
        got = izhikevich_trace(i, step)[step - 1]
        assert got[0] == v and got[1] == w
    for i, step, (v, rc) in LIF_FIXTURES:
        got = lif_trace(i, step)[step - 1]
        assert got[0] == v and got[1] == rc
    tr = lif_trace(300.0, 1000)
    assert [k + 1 for k, t in enumerate(tr) if t[2]] == LIF_SPIKE_STEPS
    for i, step, vals in HH_FIXTURES:
        got = hh_trace(i, step)[step - 1]
        np.testing.assert_allclose(got[:4], vals, rtol=0)
    tr = hh_trace(25.0, 2000)
    assert [k + 1 for k, t in enumerate(tr) if t[4]] == HH_SPIKE_STEPS


def _run(model, i, steps, n=1):
    s = model.init_state(n)
    inp = jnp.full((n,), i, jnp.float32)
    spike_steps = []
    for k in range(steps):
        s, spikes = model.step(s, inp)
        if bool(np.asarray(spikes)[0]):
            spike_steps.append(k + 1)
    return s, spike_steps


def test_izhikevich_golden():
    by_input = {}
    for i, step, expected in IZH_FIXTURES:
        by_input.setdefault(i, []).append((step, expected))
    for i, rows in by_input.items():
        model = snn.Izhikevich()
        s = model.init_state(1)
        inp = jnp.full((1,), i, jnp.float32)
        k = 0
        for step, (v, w) in sorted(rows):
            while k < step:
                s, _ = model.step(s, inp)
                k += 1
            np.testing.assert_allclose(float(s["v"][0]), v, rtol=1e-5,
                                       err_msg=f"i={i} step={step}")
            np.testing.assert_allclose(float(s["w"][0]), w, rtol=1e-5,
                                       err_msg=f"i={i} step={step}")


def test_lif_golden():
    model = snn.LeakyIntegrateAndFire()
    s = model.init_state(1)
    inp = jnp.full((1,), 300.0, jnp.float32)
    spike_steps = []
    rows = {step: vals for _, step, vals in LIF_FIXTURES}
    for k in range(1, 1001):
        s, spikes = model.step(s, inp)
        if bool(np.asarray(spikes)[0]):
            spike_steps.append(k)
        if k in rows:
            v, rc = rows[k]
            np.testing.assert_allclose(float(s["v"][0]), v, rtol=1e-5,
                                       err_msg=f"step={k}")
            np.testing.assert_allclose(float(s["refractory_count"][0]), rc,
                                       rtol=1e-5, err_msg=f"step={k}")
    assert spike_steps == LIF_SPIKE_STEPS


def test_hodgkin_huxley_golden():
    model = snn.HodgkinHuxley()
    s = model.init_state(1)
    inp = jnp.full((1,), 25.0, jnp.float32)
    spike_steps = []
    rows = {step: vals for _, step, vals in HH_FIXTURES}
    for k in range(1, 2001):
        s, spikes = model.step(s, inp)
        if bool(np.asarray(spikes)[0]):
            spike_steps.append(k)
        if k in rows:
            v, m, h, n = rows[k]
            np.testing.assert_allclose(float(s["v"][0]), v, rtol=1e-5,
                                       err_msg=f"step={k}")
            np.testing.assert_allclose(float(s["na$m_state"][0]), m, rtol=1e-4)
            np.testing.assert_allclose(float(s["na$h_state"][0]), h, rtol=1e-4)
            np.testing.assert_allclose(float(s["k$n_state"][0]), n, rtol=1e-4)
    assert spike_steps == HH_SPIKE_STEPS


# Morris-Lecar, i=60, dt=0.01 (morris_lecar/mod.rs defaults): (step, (v, n))
ML_FIXTURES = [
    (100, (-59.43805694580078, 4.260112109477632e-05)),
    (1000, (-14.302948951721191, 0.0066414885222911835)),
    (1295, (45.09712600708008, 0.14336080849170685)),
    (3000, (-46.36225128173828, 0.08135108649730682)),
]
ML_SPIKE_STEPS = [1295]

# Quadratic IF, i=100, dt=0.1 (integrate_and_fire/mod.rs:298-321 defaults):
# (step, (v, refractory_count))
QIF_FIXTURES = [
    (100, (-68.73091888427734, 0.0)),
    (293, (-75.0, 100.0)),
    (1000, (-63.269412994384766, 0.0)),
    (2000, (-72.17388153076172, 0.0)),
]
QIF_SPIKE_STEPS = [293, 686, 1079, 1472, 1865]


def test_ml_qif_derivations_match_committed_constants():
    from golden_derivation import morris_lecar_trace, qif_trace
    tr = morris_lecar_trace(60.0, 3000)
    for step, (v, n) in ML_FIXTURES:
        assert tr[step - 1][0] == v and tr[step - 1][1] == n
    assert [k + 1 for k, t in enumerate(tr) if t[2]] == ML_SPIKE_STEPS
    tr = qif_trace(100.0, 2000)
    for step, (v, rc) in QIF_FIXTURES:
        assert tr[step - 1][0] == v and tr[step - 1][1] == rc
    assert [k + 1 for k, t in enumerate(tr) if t[2]] == QIF_SPIKE_STEPS


def test_morris_lecar_golden():
    model = snn.MorrisLecar()
    s = model.init_state(1)
    inp = jnp.full((1,), 60.0, jnp.float32)
    rows = dict(ML_FIXTURES)
    spike_steps = []
    for k in range(1, 3001):
        s, spikes = model.step(s, inp)
        if bool(np.asarray(spikes)[0]):
            spike_steps.append(k)
        if k in rows:
            v, n = rows[k]
            np.testing.assert_allclose(float(s["v"][0]), v, rtol=1e-5,
                                       err_msg=f"step={k}")
            # tanh/cosh differ by ~1 ulp between numpy-f32 and XLA,
            # visible in the tiny early-time n values
            np.testing.assert_allclose(float(s["kss$n"][0]), n, rtol=1e-3,
                                       atol=1e-8, err_msg=f"step={k}")
    assert spike_steps == ML_SPIKE_STEPS


def test_quadratic_if_golden():
    model = snn.QuadraticIntegrateAndFire()
    s = model.init_state(1)
    inp = jnp.full((1,), 100.0, jnp.float32)
    rows = dict(QIF_FIXTURES)
    spike_steps = []
    for k in range(1, 2001):
        s, spikes = model.step(s, inp)
        if bool(np.asarray(spikes)[0]):
            spike_steps.append(k)
        if k in rows:
            v, rc = rows[k]
            np.testing.assert_allclose(float(s["v"][0]), v, rtol=1e-5,
                                       err_msg=f"step={k}")
            np.testing.assert_allclose(float(s["refractory_count"][0]), rc,
                                       rtol=1e-5, err_msg=f"step={k}")
    assert spike_steps == QIF_SPIKE_STEPS


# Adaptive LIF / adaptive exponential LIF, i=400, dt=0.1: (step, (v, w))
ALIF_FIXTURES = [
    (100, (-71.22103118896484, 8.445464134216309)),
    (942, (-75.0, 123.77133178710938)),
    (1500, (-61.78314208984375, 65.63562774658203)),
]
ALIF_SPIKE_STEPS = [942]
ADEX_FIXTURES = [
    (100, (-71.22103118896484, 8.445464134216309)),
    (933, (-75.0, 123.44351196289062)),
    (1500, (-61.601619720458984, 66.863525390625)),
]
ADEX_SPIKE_STEPS = [933]


def test_adaptive_derivations_match_committed_constants():
    from golden_derivation import alif_trace, adex_trace
    for trace, fixtures, spike_steps in (
            (alif_trace, ALIF_FIXTURES, ALIF_SPIKE_STEPS),
            (adex_trace, ADEX_FIXTURES, ADEX_SPIKE_STEPS)):
        tr = trace(400.0, 1500)
        for step, (v, w) in fixtures:
            assert tr[step - 1][0] == v and tr[step - 1][1] == w
        assert [k + 1 for k, t in enumerate(tr) if t[2]] == spike_steps


def _adaptive_golden(model, fixtures, spike_ref):
    s = model.init_state(1)
    inp = jnp.full((1,), 400.0, jnp.float32)
    rows = dict(fixtures)
    spike_steps = []
    for k in range(1, 1501):
        s, spikes = model.step(s, inp)
        if bool(np.asarray(spikes)[0]):
            spike_steps.append(k)
        if k in rows:
            v, w = rows[k]
            np.testing.assert_allclose(float(s["v"][0]), v, rtol=1e-5,
                                       err_msg=f"step={k}")
            np.testing.assert_allclose(float(s["w"][0]), w, rtol=1e-5,
                                       err_msg=f"step={k}")
    assert spike_steps == spike_ref


def test_adaptive_lif_golden():
    _adaptive_golden(snn.AdaptiveLeakyIntegrateAndFire(), ALIF_FIXTURES,
                     ALIF_SPIKE_STEPS)


def test_adaptive_exp_lif_golden():
    _adaptive_golden(snn.AdaptiveExpLeakyIntegrateAndFire(), ADEX_FIXTURES,
                     ADEX_SPIKE_STEPS)


# Leaky Izhikevich, i=5000, dt=0.1: (step, (v, w))
LIZH_FIXTURES = [
    (27, (-55.0, 37.82438278198242)),
    (100, (-28.27825164794922, 53.171119689941406)),
    (1000, (23.938488006591797, 59.18878173828125)),
    (1500, (19.919116973876953, 61.6777458190918)),
]
LIZH_SPIKE_STEPS = [27, 56, 93, 148, 598, 1320]

# Simple LIF, i=8, dt=0.1 (reset-only spiking, 14-step period): (step, v)
SLIF_FIXTURES = [(14, -75.0), (100, -71.91549682617188),
                 (500, -60.17921447753906)]


def test_lizh_slif_derivations_match_committed_constants():
    from golden_derivation import leaky_izhikevich_trace, simple_lif_trace
    tr = leaky_izhikevich_trace(5000.0, 1500)
    for step, (v, w) in LIZH_FIXTURES:
        assert tr[step - 1][0] == v and tr[step - 1][1] == w
    assert [k + 1 for k, t in enumerate(tr) if t[2]] == LIZH_SPIKE_STEPS
    tr = simple_lif_trace(8.0, 500)
    for step, v in SLIF_FIXTURES:
        assert tr[step - 1][0] == v
    assert [k + 1 for k, t in enumerate(tr) if t[1]][:3] == [14, 28, 42]


def test_leaky_izhikevich_golden():
    model = snn.LeakyIzhikevich()
    s = model.init_state(1)
    inp = jnp.full((1,), 5000.0, jnp.float32)
    rows = dict(LIZH_FIXTURES)
    spike_steps = []
    for k in range(1, 1501):
        s, spikes = model.step(s, inp)
        if bool(np.asarray(spikes)[0]):
            spike_steps.append(k)
        if k in rows:
            v, w = rows[k]
            np.testing.assert_allclose(float(s["v"][0]), v, rtol=1e-5,
                                       err_msg=f"step={k}")
            np.testing.assert_allclose(float(s["w"][0]), w, rtol=1e-5,
                                       err_msg=f"step={k}")
    assert spike_steps == LIZH_SPIKE_STEPS


def test_simple_lif_golden():
    model = snn.SimpleLeakyIntegrateAndFire()
    s = model.init_state(1)
    inp = jnp.full((1,), 8.0, jnp.float32)
    rows = dict(SLIF_FIXTURES)
    spike_steps = []
    for k in range(1, 501):
        s, spikes = model.step(s, inp)
        if bool(np.asarray(spikes)[0]):
            spike_steps.append(k)
        if k in rows:
            np.testing.assert_allclose(float(s["v"][0]), rows[k], rtol=1e-5,
                                       err_msg=f"step={k}")
    assert spike_steps[:5] == [14, 28, 42, 56, 70]


# BCM Izhikevich, i=400, dt=0.1: (step, (v, current_activity,
# average_activity, num_spikes)).  current_activity accumulates LIFETIME
# spikes over the window denominator (num_spikes never resets —
# integrate_and_fire/mod.rs:1437-1444, replicated faithfully)
BCM_FIXTURES = [
    (5000, (-33.93001937866211, 0.5400000214576721, 0.18000000715255737, 27)),
    (10000, (5.575139999389648, 1.0800000429153442, 0.48000001907348633, 54)),
    (12000, (4.478339672088623, 1.0800000429153442, 0.48000001907348633, 65)),
]


def test_bcm_derivation_matches_committed_constants():
    from golden_derivation import bcm_izhikevich_trace
    tr = bcm_izhikevich_trace(400.0, 12000)
    for step, (v, ca, aa, ns) in BCM_FIXTURES:
        t = tr[step - 1]
        assert t[0] == v and t[1] == ca and t[2] == aa and t[3] == ns


@pytest.mark.slow
def test_bcm_izhikevich_activity_golden():
    model = snn.BCMIzhikevich()
    s = model.init_state(1)
    inp = jnp.full((1,), 400.0, jnp.float32)
    rows = {step: vals for step, vals in BCM_FIXTURES}
    for k in range(1, 12001):
        s, spikes = model.step(s, inp)
        if k in rows:
            v, ca, aa, ns = rows[k]
            np.testing.assert_allclose(float(s["v"][0]), v, rtol=1e-5)
            np.testing.assert_allclose(float(s["current_activity"][0]), ca,
                                       rtol=1e-6)
            np.testing.assert_allclose(float(s["average_activity"][0]), aa,
                                       rtol=1e-6)
            assert int(s["num_spikes"][0]) == ns


# Izhikevich driven chemically (AMPA 0.9 / NMDA 0.7 / GABA 0.2 until step
# 1500, then silence): (step, (v, w)).  Exercises the Mg-block (3.75
# denominator), receptor currents from the pre-update voltage, and the
# receptor-update-before-voltage-update iterate order
CHEM_FIXTURES = [
    (100, (-63.3039436340332, 22.228078842163086)),
    (1000, (-33.065284729003906, -3.974364995956421)),
    (1588, (-55.0, 5.998130798339844)),
    (2000, (-61.55084991455078, -3.996185302734375)),
]
CHEM_SPIKE_STEPS = [1588]


def _chem_sched(k):
    return (0.9, 0.7, 0.2) if k < 1500 else (0.0, 0.0, 0.0)


def test_chemical_derivation_matches_committed_constants():
    from golden_derivation import izhikevich_chemical_trace
    tr = izhikevich_chemical_trace(_chem_sched, 2000)
    for step, (v, w) in CHEM_FIXTURES:
        assert tr[step - 1][0] == v and tr[step - 1][1] == w
    assert [k + 1 for k, t in enumerate(tr) if t[2]] == CHEM_SPIKE_STEPS


@pytest.mark.slow
def test_izhikevich_chemical_golden():
    model = snn.Izhikevich()
    s = model.init_state(1)
    for t in ("AMPA", "NMDA", "GABA"):
        s = model.insert_receptor(s, t)
    rows = dict(CHEM_FIXTURES)
    spike_steps = []
    for k in range(1, 2001):
        t_in = jnp.asarray([list(_chem_sched(k - 1))], jnp.float32)
        valid = jnp.ones((1, 3), bool)
        s, spikes = model.step(s, jnp.zeros((1,)), t_in, valid)
        if bool(np.asarray(spikes)[0]):
            spike_steps.append(k)
        if k in rows:
            v, w = rows[k]
            np.testing.assert_allclose(float(s["v"][0]), v, rtol=1e-5,
                                       err_msg=f"step={k}")
            np.testing.assert_allclose(float(s["w"][0]), w, rtol=1e-5,
                                       err_msg=f"step={k}")
    assert spike_steps == CHEM_SPIKE_STEPS


# lixirnet DopaGluGABA Izhikevich (Glu 0.9 / GABA 0.1 / Dopamine 0.6 until
# step 1500; s_d1=0.8, s_d2=0.5): (step, (v, w, inh_mod, nmda_mod)).
# Exercises the 3.57 Mg denominator, nmda_r^nmda_modifier gain, and the
# one-step-delayed D1/D2 modifier application (Dopamine block runs last)
DOPA_FIXTURES = [
    (100, (-64.8182144165039, 22.199766159057617, 0.699999988079071,
           0.5199999809265137)),
    (1000, (-45.63336181640625, -5.384042739868164, 0.699999988079071,
            0.5199999809265137)),
    (1901, (-55.0, 5.082145690917969, 1.0, 1.0)),
    (2000, (-56.79095458984375, 2.1571664810180664, 1.0, 1.0)),
]
DOPA_SPIKE_STEPS = [1901]


def _dopa_sched(k):
    return (0.9, 0.1, 0.6) if k < 1500 else (0.0, 0.0, 0.0)


def test_dopa_derivation_matches_committed_constants():
    from golden_derivation import dopa_glu_gaba_trace
    tr = dopa_glu_gaba_trace(_dopa_sched, 0.8, 0.5, 2000)
    for step, (v, w, im, nm) in DOPA_FIXTURES:
        t = tr[step - 1]
        assert (t[0], t[1], t[2], t[3]) == (v, w, im, nm)
    assert [k + 1 for k, t in enumerate(tr) if t[4]] == DOPA_SPIKE_STEPS


@pytest.mark.slow
def test_dopa_glu_gaba_golden():
    model = snn.DopaIzhikevich()
    s = model.init_state(1)
    for t in ("Glutamate", "GABA", "Dopamine"):
        s = model.insert_receptor(s, t)
    s["rec$s_d1"] = jnp.full((1,), 0.8, jnp.float32)
    s["rec$s_d2"] = jnp.full((1,), 0.5, jnp.float32)
    rows = dict(DOPA_FIXTURES)
    spike_steps = []
    for k in range(1, 2001):
        t_in = jnp.asarray([list(_dopa_sched(k - 1))], jnp.float32)
        valid = jnp.ones((1, 3), bool)
        s, spikes = model.step(s, jnp.zeros((1,)), t_in, valid)
        if bool(np.asarray(spikes)[0]):
            spike_steps.append(k)
        if k in rows:
            v, w, im, nm = rows[k]
            np.testing.assert_allclose(float(s["v"][0]), v, rtol=1e-5)
            np.testing.assert_allclose(float(s["w"][0]), w, rtol=1e-5)
            np.testing.assert_allclose(float(s["rec$inh_modifier"][0]), im,
                                       rtol=1e-6)
            np.testing.assert_allclose(float(s["rec$nmda_modifier"][0]), nm,
                                       rtol=1e-6)
    assert spike_steps == DOPA_SPIKE_STEPS
