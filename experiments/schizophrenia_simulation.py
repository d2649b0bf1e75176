"""Schizophrenia receptor-efficacy working-memory pipeline (TOML grid).

Full-depth port of `/root/reference/interface/experiments/
schizophrenia_simulation_pipeline.py` (602 LoC): a Hopfield-memory
excitatory/inhibitory network with separate AMPA/NMDA/GABA
neurotransmitter pools (approximate kinetics, per-type clearance) recalls
a cued pattern in two phases — cue pattern1, measure, then cue pattern2
(or silence / a noisy cue), measure again.  Scaling `nmda_g` down across
conditions is the schizophrenia NMDA-hypofunction model; the grid also
sweeps conductances, clearances, and connectivity.

Uses the native Ionotropic receptor family (AMPA and NMDA carry their own
clearances, like the reference's legacy lixirnet surface).  Reference
TOMLs from `schizophrenia_pipeline_args/` replay unmodified (see
`experiments/schizophrenia_pipeline_args/`).

Usage:
    python experiments/schizophrenia_simulation.py [args.toml]
"""

from __future__ import annotations

import itertools
import json
import sys

import numpy as np
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from pipeline_setup import (
    output_path, parse_toml, get_weights, weights_ie, generate_patterns,
    skewed_random, find_peaks_above_threshold, determine_accuracy,
    signal_to_noise)

import spiking_neural_networks_jax as snn

I1, E1, C1 = 0, 1, 2

SIM_DEFAULTS = dict(
    iterations1=3000, iterations2=3000, peaks_on=False,
    cue_firing_rate=0.01, second_cue=True, second_cue_is_noisy=False,
    first_cue_is_noisy=False, noisy_cue_noise_level=0.1,
    noisy_cue_firing_rate=0.01, measure_snr=False, first_window=1000,
    second_window=1000, trials=10, num_patterns=3, weights_scalar=1,
    inh_weights_scalar=0.25, a=1, b=1, correlation_threshold=0.08,
    use_correlation_as_accuracy=False, get_all_accuracies=False, skew=1,
    exc_n=7, inh_n=3, distortion=0.15, dt=1, c_m=25, seed=0,
)

KEYS = [
    "exc_to_inh", "prob_of_exc_to_inh", "spike_train_to_exc",
    "nmda_g", "ampa_g", "gabaa_g",
    "nmda_clearance", "ampa_clearance", "gabaa_clearance",
]

VAR_DEFAULTS = dict(
    prob_of_exc_to_inh=[0.5], exc_to_inh=[1], spike_train_to_exc=[5],
    nmda_g=[0.6], ampa_g=[1], gabaa_g=[1.2], gabaa_clearance=[0.001],
)


def fill_defaults(parsed):
    """schizophrenia_simulation_pipeline.py:39-142, including the
    `glutamate_clearance` alias that ties nmda+ampa clearance together."""
    if "simulation_parameters" not in parsed:
        raise ValueError("Requires `simulation_parameters` table")
    if "filename" not in parsed["simulation_parameters"]:
        raise ValueError("Requires `filename` field in `simulation_parameters`")
    if "variables" not in parsed:
        raise ValueError("Requires `variables` table")
    for k, v in SIM_DEFAULTS.items():
        parsed["simulation_parameters"].setdefault(k, v)
    for k, v in VAR_DEFAULTS.items():
        parsed["variables"].setdefault(k, list(v))
    if "glutamate_clearance" not in parsed["variables"]:
        parsed["variables"].setdefault("nmda_clearance", [0.001])
        parsed["variables"].setdefault("ampa_clearance", [0.001])
        parsed["simulation_parameters"]["use_glutamate_clearance"] = False
    else:
        glu = parsed["variables"]["glutamate_clearance"]
        parsed["variables"]["nmda_clearance"] = list(glu)
        parsed["variables"]["ampa_clearance"] = list(glu)
        parsed["simulation_parameters"]["use_glutamate_clearance"] = True


def generate_key(parsed, current_state):
    key = [f"trial: {current_state['trial']}",
           f"pattern1: {current_state['pattern1']}",
           f"pattern2: {current_state['pattern2']}"]
    for field in KEYS:
        if len(parsed["variables"][field]) != 1:
            key.append(f"{field}: {current_state[field]}")
    return ", ".join(key)


def setup_lattice_neurons(lat, sp, rng):
    n = lat.n
    v0 = skewed_random(-65, 30, sp["skew"], size=n, rng=rng)
    lat.state["v"] = jnp.asarray(v0.astype(np.float32))
    lat.state["c_m"] = jnp.full((n,), float(sp["c_m"]), jnp.float32)


def cue_chances(sp, patterns, pattern_index, rng, noisy):
    """(N,) chance_of_firing array for the Poisson cue lattice."""
    num = sp["exc_n"] ** 2
    if noisy:
        on = rng.uniform(0, 1, num) < sp["noisy_cue_noise_level"]
        return np.where(on, sp["noisy_cue_firing_rate"], 0.0)
    state = np.asarray(patterns[pattern_index], bool)
    flips = rng.uniform(0, 1, num) < sp["distortion"]
    state = state ^ flips
    return np.where(state, sp["cue_firing_rate"], 0.0)


def phase_accuracy(sp, patterns, pattern_index, peaks, window):
    return determine_accuracy(
        patterns, pattern_index, sp["num_patterns"], window, peaks,
        sp["exc_n"], sp["use_correlation_as_accuracy"],
        sp["get_all_accuracies"])


def run_trial(sp, cs, patterns, rng):
    exc_n, inh_n = sp["exc_n"], sp["inh_n"]
    num = exc_n * exc_n
    pattern1, pattern2 = (int(i) for i in rng.choice(
        sp["num_patterns"], 2, replace=False))

    w = get_weights(num, patterns, a=sp["a"], b=sp["b"],
                    scalar=sp["weights_scalar"] / sp["num_patterns"])
    w_ie = weights_ie(exc_n, sp["inh_weights_scalar"], patterns,
                      sp["num_patterns"])

    def with_receptors(s, model):
        s = model.insert_receptor(s, "AMPA", g=cs["ampa_g"])
        s = model.insert_receptor(s, "NMDA", g=cs["nmda_g"])
        s = model.insert_receptor(s, "GABA", g=cs["gabaa_g"])
        return s

    inh = snn.Lattice(snn.Izhikevich(), id=I1)
    inh.populate(inh_n, inh_n)
    setup_lattice_neurons(inh, sp, rng)
    s = with_receptors(inh.state, inh.model)
    s = inh.model.insert_neurotransmitter(
        s, "GABA", clearance_constant=cs["gabaa_clearance"])
    inh.state = s

    exc = snn.Lattice(snn.Izhikevich(), id=E1)
    exc.populate(exc_n, exc_n)
    setup_lattice_neurons(exc, sp, rng)
    s = with_receptors(exc.state, exc.model)
    s = exc.model.insert_neurotransmitter(
        s, "AMPA", clearance_constant=cs["ampa_clearance"])
    s = exc.model.insert_neurotransmitter(
        s, "NMDA", clearance_constant=cs["nmda_clearance"])
    exc.state = s
    w_np = np.asarray(w)
    exc.connect(lambda a, b: bool(w_np[a[0] * exc_n + a[1],
                                       b[0] * exc_n + b[1]] != 0),
                lambda a, b: float(w_np[a[0] * exc_n + a[1],
                                        b[0] * exc_n + b[1]]))
    exc.update_grid_history = True

    st = snn.SpikeTrainLattice(
        snn.PoissonSpikeTrain(nt_kinetics="approximate"), id=C1)
    st.populate(exc_n, exc_n)
    s = st.state
    s = st.model.insert_neurotransmitter(
        s, "AMPA", clearance_constant=cs["ampa_clearance"])
    s = st.model.insert_neurotransmitter(
        s, "NMDA", clearance_constant=cs["nmda_clearance"])
    st.state = s

    net = snn.LatticeNetwork.generate_network([inh, exc], [st])
    net.connect(I1, E1, lambda a, b: True,
                lambda a, b: float(w_ie[b[0], b[1]]))
    net.connect(E1, I1,
                lambda a, b: rng.uniform() <= cs["prob_of_exc_to_inh"],
                lambda a, b: cs["exc_to_inh"])
    net.connect(C1, E1, lambda a, b: a == b,
                lambda a, b: cs["spike_train_to_exc"])
    net.set_dt(sp["dt"])
    net.electrical_synapse = False
    net.chemical_synapse = True

    def set_cue(chances):
        st.state = dict(st.state,
                        chance_of_firing=jnp.asarray(
                            chances.astype(np.float32)))

    # phase 1
    set_cue(cue_chances(sp, patterns, pattern1, rng,
                        sp["first_cue_is_noisy"]))
    net.run_lattices(sp["iterations1"])

    hist = np.stack(exc.grid_history.history)
    data = hist.reshape(hist.shape[0], -1)
    peaks = [find_peaks_above_threshold(data[:, i], 20) for i in range(num)]
    first_window = sp["iterations1"] - sp["first_window"]
    first_acc = phase_accuracy(sp, patterns, pattern1, peaks, first_window)

    # phase 2: second cue / silence / noise
    if not sp["second_cue_is_noisy"]:
        if sp["second_cue"]:
            set_cue(cue_chances(sp, patterns, pattern2, rng, False))
        else:
            set_cue(np.zeros(num))
    else:
        set_cue(cue_chances(sp, patterns, pattern2, rng, True))
    net.run_lattices(sp["iterations2"])

    hist = np.stack(exc.grid_history.history)
    data = hist.reshape(hist.shape[0], -1)
    peaks = [find_peaks_above_threshold(data[:, i], 20) for i in range(num)]
    second_window = sp["iterations2"] - sp["second_window"]
    if not sp["second_cue"]:
        pattern2 = pattern1
    if sp["iterations2"] != 0:
        second_acc = phase_accuracy(sp, patterns, pattern2, peaks,
                                    second_window)
    else:
        second_acc = 0

    value = {"first_acc": first_acc, "second_acc": second_acc}
    if sp["measure_snr"]:
        signal = data.mean(axis=1)
        value["first_snr"] = float(
            signal_to_noise(signal[:sp["iterations1"]]))
        value["second_snr"] = (float(signal_to_noise(
            signal[sp["iterations1"]:])) if sp["iterations2"] else None)
    if sp["peaks_on"]:
        value["peaks"] = [[int(p) for p in sub] for sub in peaks]
    return value, pattern1, pattern2


def main(argv):
    if len(argv) > 1:
        with open(argv[1], "rb") as f:
            parsed = parse_toml(f)
    else:  # built-in smoke config
        parsed = {
            "simulation_parameters": dict(
                filename="schizophrenia_simulation_output.json",
                iterations1=2000, iterations2=1000, first_window=800,
                second_window=800, second_cue=False, trials=1,
                use_correlation_as_accuracy=True, a=-1, b=0, skew=0.1),
            "variables": dict(spike_train_to_exc=[4.5],
                              prob_of_exc_to_inh=[1],
                              nmda_g=[0.6, 0.1]),
        }
    fill_defaults(parsed)
    sp = parsed["simulation_parameters"]
    np.seterr(divide="ignore", invalid="ignore")
    print(json.dumps(parsed, indent=4))

    rng = np.random.default_rng(sp["seed"])
    num = sp["exc_n"] ** 2
    patterns = generate_patterns(num, 0.5, sp["num_patterns"],
                                 sp["correlation_threshold"], rng=rng)

    combos = list(itertools.product(
        *[parsed["variables"][key] for key in KEYS]))
    all_states = [dict(zip(KEYS, c)) for c in combos]
    if sp["use_glutamate_clearance"]:
        all_states = [s for s in all_states
                      if s["nmda_clearance"] == s["ampa_clearance"]]

    simulation_output = {}
    for current_state in all_states:
        for trial in range(sp["trials"]):
            value, pattern1, pattern2 = run_trial(
                sp, current_state, patterns, rng)
            current_state.update(trial=trial, pattern1=pattern1,
                                 pattern2=pattern2)
            key = generate_key(parsed, current_state)
            simulation_output[key] = value
            print(f"{key} -> first_acc={value['first_acc']} "
                  f"second_acc={value['second_acc']}")

    with open(output_path(sp["filename"]), "w") as f:
        json.dump(simulation_output, f, indent=4)
    print("Finished simulation")
    return simulation_output


if __name__ == "__main__":
    main(sys.argv)
