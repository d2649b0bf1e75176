"""Rate-based Bayesian inference pipeline (full TOML grid search).

Full-depth port of `/root/reference/interface_gpu/experiments/
bayesian_inference_pipeline_rate_based.py` (909 LoC; the live,
non-commented path): an excitatory Hopfield lattice with an inhibitory
pool recalls a distorted pattern cued by **rate spike trains**, while a
"Bayesian" cue biases recall toward a second pattern.  The bias can act

* directly (glutamatergic cue -> main group),
* through dopamine (`d1` / `d2` — D1 boosts NMDA gain, D2 damps
  glutamate; with `d2` the cue is the INVERTED pattern),
* on the excitatory or the inhibitory group (`d_acts_on_inh`),
* or through a second Hopfield memory whose recalled activity routes
  through a dopaminergic intermediate lattice (`memory_biases_memory`).

Every `[variables]` entry is swept as a full grid (itertools.product) with
`generate_key_helper` keying, exactly like the reference, so the
reference's committed `bayesian_inf_args/*.toml` configs replay
unmodified (see `experiments/bayesian_inf_args/`).

Usage:
    python experiments/bayesian_inference_rate_based.py [args.toml]
"""

from __future__ import annotations

import itertools
import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from pipeline_setup import (
    output_path, parse_toml, generate_key_helper, get_weights, weights_ie,
    generate_patterns, generate_setup_neuron,
    get_rate_spike_train_setup_function,
    get_noisy_rate_spike_train_setup_function,
    find_peaks_above_threshold, determine_accuracy, signal_to_noise)

import spiking_neural_networks_jax.lixirnet as ln

# lattice ids inside one network (bayesian_inference_pipeline_rate_based
# .py:230-239)
I1, E1, C1, C2, I2, E2, D = 0, 1, 2, 3, 4, 5, 6

SIM_DEFAULTS = dict(
    iterations1=3000, iterations2=3000, bayesian_is_not_main=True,
    pattern_switch=False, memory_biases_memory=False, main_noisy=False,
    noisy_cue_noise_level=0.1, bayesian_1_on=True, bayesian_2_on=True,
    main_1_on=True, main_2_on=True, d1=False, d2=False, peaks_on=False,
    measure_snr=False, distortion_on_only=False, d_acts_on_inh=False,
    first_window=1000, second_window=1000, trials=10, gpu_batch=10,
    num_patterns=3, weights_scalar=1, inh_weights_scalar=0.25, a=1, b=1,
    reset_patterns=False, correlation_threshold=0.08,
    use_correlation_as_accuracy=False, get_all_accuracies=False, skew=1,
    exc_n=7, inh_n=3, dt=1, c_m=25, seed=0,
)

VAR_DEFAULTS = dict(
    distortion=[0.15], bayesian_distortion=[0],
    main_firing_rate=[100], bayesian_firing_rate=[100],
    prob_of_exc_to_inh=[0.5], exc_to_inh=[1], spike_train_to_exc=[5],
    bayesian_to_exc=[5], prob_of_d_to_inh=[1],
    nmda_g=[0.6], ampa_g=[1], gabaa_g=[1.2],
    s_d1=[0], s_d2=[0],
    glutamate_clearance=[0.001], gabaa_clearance=[0.001],
    dopamine_clearance=[0.001],
)

FIELDS = list(VAR_DEFAULTS)


def fill_defaults(parsed):
    """bayesian_inference_pipeline_rate_based.py:20-166."""
    if "simulation_parameters" not in parsed:
        raise ValueError("Requires `simulation_parameters` table")
    if "filename" not in parsed["simulation_parameters"]:
        raise ValueError("Requires `filename` field in `simulation_parameters`")
    if "variables" not in parsed:
        raise ValueError("Requires `variables` table")
    for k, v in SIM_DEFAULTS.items():
        parsed["simulation_parameters"].setdefault(k, v)
    sp = parsed["simulation_parameters"]
    if sp["d1"] and sp["d2"]:
        raise ValueError("D1 and D2 cannot both be active, must be one or "
                         "the other or neither")
    for k, v in VAR_DEFAULTS.items():
        parsed["variables"].setdefault(k, list(v))
    unknown = [i for i in parsed["variables"] if i not in FIELDS]
    if unknown:
        raise ValueError(f"Unknown variables: {unknown}")


def generate_key(parsed, current_state):
    """bayesian_inference_pipeline_rate_based.py:177-191."""
    key = [f"trial: {current_state['trial']}",
           f"pattern1: {current_state['pattern1']}",
           f"pattern2: {current_state['pattern2']}"]
    if "switched_pattern" in current_state:
        key.append(f"switched_pattern: {current_state['switched_pattern']}")
    for field in FIELDS:
        generate_key_helper(current_state, key, parsed, field)
    return ", ".join(key)


def build_prototypes(sp, cs):
    glu_neuro = ln.BoundedNeurotransmitterKinetics(
        clearance_constant=cs["glutamate_clearance"])
    gaba_neuro = ln.BoundedNeurotransmitterKinetics(
        clearance_constant=cs["gabaa_clearance"])
    dopa_neuro = ln.BoundedNeurotransmitterKinetics(
        clearance_constant=cs["dopamine_clearance"])
    exc_nts = {ln.DopaGluGABANeurotransmitterType.Glutamate: glu_neuro}
    inh_nts = {ln.DopaGluGABANeurotransmitterType.GABA: gaba_neuro}
    dopa_nts = {ln.DopaGluGABANeurotransmitterType.Dopamine: dopa_neuro}

    # reference quirk (rate_based.py:272-273): the AMPA conductance is
    # assigned from `nmda_g` and the NMDA conductance from `ampa_g`
    glu = ln.GlutamateReceptor(g_ampa=cs["nmda_g"], g_nmda=cs["ampa_g"])
    gabaa = ln.GABAReceptor(g=cs["gabaa_g"])
    dopamine_rs = ln.DopamineReceptor(
        s_d1=cs["s_d1"] if sp["d1"] else 0.0,
        s_d2=cs["s_d2"] if sp["d2"] else 0.0)
    receptors = ln.DopaGluGABA()
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Glutamate, glu)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.GABA, gabaa)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Dopamine,
                     dopamine_rs)

    exc_neuron = ln.IzhikevichNeuron()
    exc_neuron.set_synaptic_neurotransmitters(exc_nts)
    exc_neuron.set_receptors(receptors)
    inh_neuron = ln.IzhikevichNeuron()
    inh_neuron.set_synaptic_neurotransmitters(inh_nts)
    inh_neuron.set_receptors(receptors)
    dopa_neuron = ln.IzhikevichNeuron()
    dopa_neuron.set_synaptic_neurotransmitters(dopa_nts)
    dopa_neuron.set_receptors(receptors)

    spike_train = ln.RateSpikeTrain()
    spike_train.set_synaptic_neurotransmitters(exc_nts)
    spike_train_dopa = ln.RateSpikeTrain()
    spike_train_dopa.set_synaptic_neurotransmitters(dopa_nts)
    return (exc_neuron, inh_neuron, dopa_neuron, spike_train,
            spike_train_dopa)


def e2_to_e1_map(bayes_pattern, target_pattern):
    """The reference's pointer-walk pairing of active prior-memory cells to
    active target cells (rate_based.py:481-506)."""
    mapping, pointer = {}, -1
    targets = list(enumerate(target_pattern))
    for n1, i in enumerate(bayes_pattern):
        if i == 0:
            continue
        to_iterate = targets[pointer + 1:]
        if not to_iterate:
            break
        for n2, j in to_iterate:
            if j == 0:
                continue
            pointer = n2
            break
        mapping[n1] = pointer
    return mapping


def run_trial(sp, cs, patterns, bayes_patterns, rng):
    exc_n, inh_n = sp["exc_n"], sp["inh_n"]
    num = exc_n * exc_n
    num_patterns = sp["num_patterns"]
    mbm = sp["memory_biases_memory"]
    dopa_on = sp["d1"] or sp["d2"]

    w = get_weights(num, patterns, a=sp["a"], b=sp["b"],
                    scalar=sp["weights_scalar"] / num_patterns)
    w_ie = weights_ie(exc_n, sp["inh_weights_scalar"], patterns,
                      num_patterns)
    (exc_neuron, inh_neuron, dopa_neuron, spike_train,
     spike_train_dopa) = build_prototypes(sp, cs)
    setup_neuron = generate_setup_neuron(sp["c_m"], sp["skew"], rng=rng)

    if sp["bayesian_is_not_main"]:
        pattern1, pattern2 = rng.choice(num_patterns, 2, replace=False)
    else:
        pattern1 = pattern2 = rng.choice(num_patterns)
    pattern1, pattern2 = int(pattern1), int(pattern2)

    inh_lattice = ln.IzhikevichNeuronLattice(I1)
    inh_lattice.populate(inh_neuron, inh_n, inh_n)
    inh_lattice.apply(setup_neuron)

    exc_lattice = ln.IzhikevichNeuronLattice(E1)
    exc_lattice.populate(exc_neuron, exc_n, exc_n)
    exc_lattice.apply(setup_neuron)
    p2i = exc_lattice.position_to_index
    exc_lattice.connect(lambda x, y: bool(w[p2i[x]][p2i[y]] != 0),
                        lambda x, y: float(w[p2i[x]][p2i[y]]))
    exc_lattice.update_grid_history = True

    spike_train_lattice = ln.RateSpikeTrainLattice(C1)
    spike_train_lattice.populate(spike_train, exc_n, exc_n)

    lattices = [exc_lattice, inh_lattice]
    st_lattices = [spike_train_lattice]

    bayes_pattern_index = None
    if mbm:
        w2 = get_weights(num, bayes_patterns, a=sp["a"], b=sp["b"],
                         scalar=sp["weights_scalar"] / num_patterns)
        inh_lattice_2 = ln.IzhikevichNeuronLattice(I2)
        inh_lattice_2.populate(inh_neuron, inh_n, inh_n)
        inh_lattice_2.apply(setup_neuron)
        exc_lattice_2 = ln.IzhikevichNeuronLattice(E2)
        exc_lattice_2.populate(exc_neuron, exc_n, exc_n)
        exc_lattice_2.apply(setup_neuron)
        p2i2 = exc_lattice_2.position_to_index
        exc_lattice_2.connect(lambda x, y: bool(w2[p2i2[x]][p2i2[y]] != 0),
                              lambda x, y: float(w2[p2i2[x]][p2i2[y]]))
        exc_lattice_2.update_grid_history = True
        lattices += [exc_lattice_2, inh_lattice_2]
        bayes_pattern_index = int(rng.choice(num_patterns))
        cue_lattice = ln.RateSpikeTrainLattice(C2)
        cue_lattice.populate(spike_train, exc_n, exc_n)
        if dopa_on:
            d_intermediate = ln.IzhikevichNeuronLattice(D)
            d_intermediate.populate(dopa_neuron, exc_n, exc_n)
            lattices.append(d_intermediate)
    else:
        cue_lattice = ln.RateSpikeTrainLattice(C2)
        cue_lattice.populate(spike_train_dopa if dopa_on else spike_train,
                             exc_n, exc_n)
    st_lattices.append(cue_lattice)

    network = ln.IzhikevichNeuronNetwork.generate_network(
        lattices, st_lattices)

    network.connect(
        I1, E1, lambda x, y: True,
        lambda x, y: float(w_ie[p2i[y] // exc_n, p2i[y] % exc_n]))
    network.connect(
        E1, I1, lambda x, y: rng.uniform() <= cs["prob_of_exc_to_inh"],
        lambda x, y: cs["exc_to_inh"])
    network.connect(C1, E1, lambda x, y: x == y,
                    lambda x, y: cs["spike_train_to_exc"])

    if mbm:
        network.connect(
            I2, E2, lambda x, y: True,
            lambda x, y: float(w_ie[p2i2[y] // exc_n, p2i2[y] % exc_n]))
        network.connect(
            E2, I2, lambda x, y: rng.uniform() <= cs["prob_of_exc_to_inh"],
            lambda x, y: cs["exc_to_inh"])
        network.connect(C2, E2, lambda x, y: x == y,
                        lambda x, y: cs["spike_train_to_exc"])
        bayes_pat = bayes_patterns[bayes_pattern_index]
        if not sp["d_acts_on_inh"]:
            if sp["d2"]:
                target = np.logical_not(patterns[pattern2]).astype(int)
            else:
                target = patterns[pattern2]
            mapping = e2_to_e1_map(bayes_pat, target)
            src_keys, dst_vals = set(mapping), set(mapping.values())
            if dopa_on:
                network.connect(
                    E2, D,
                    lambda x, y: bool(x[0] * exc_n + x[1] in src_keys
                                      and y[0] * exc_n + y[1] in dst_vals),
                    lambda x, y: cs["bayesian_to_exc"])
                network.connect(
                    D, E1,
                    lambda x, y: bool(x[0] * exc_n + x[1] in src_keys
                                      and y[0] * exc_n + y[1] in dst_vals),
                    lambda x, y: cs["bayesian_to_exc"])
            else:
                network.connect(
                    E2, E1,
                    lambda x, y: bool(x[0] * exc_n + x[1] in src_keys
                                      and y[0] * exc_n + y[1] in dst_vals),
                    lambda x, y: cs["bayesian_to_exc"])
        else:
            mapping = e2_to_e1_map(bayes_pat, [1] * (inh_n * inh_n))
            src_keys, dst_vals = set(mapping), set(mapping.values())
            network.connect(
                E2, D, lambda x, y: bool(bayes_pat[x[0] * exc_n + x[1]]),
                lambda x, y: cs["bayesian_to_exc"])
            network.connect(
                D, I1,
                lambda x, y: bool(
                    x[0] * exc_n + x[1] in src_keys
                    and y[0] * inh_n + y[1] in dst_vals
                    and rng.uniform() < cs["prob_of_d_to_inh"]),
                lambda x, y: cs["bayesian_to_exc"])
    else:
        network.connect(C2, E1 if not sp["d_acts_on_inh"] else I1,
                        lambda x, y: x == y,
                        lambda x, y: cs["bayesian_to_exc"])

    network.set_dt(sp["dt"])
    network.electrical_synapse = False
    network.chemical_synapse = True

    main_firing_rate = cs["main_firing_rate"] if sp["main_1_on"] else 0
    if not sp["main_noisy"]:
        network.apply_spike_train_lattice_given_position(
            C1, get_rate_spike_train_setup_function(
                patterns, pattern1, cs["distortion"], main_firing_rate,
                exc_n, sp["distortion_on_only"], rng=rng))
    else:
        network.apply_spike_train_lattice(
            C1, get_noisy_rate_spike_train_setup_function(
                sp["noisy_cue_noise_level"], main_firing_rate, rng=rng))

    bayesian_firing_rate = (cs["bayesian_firing_rate"]
                            if sp["bayesian_1_on"] else 0)
    if mbm:
        network.apply_spike_train_lattice_given_position(
            C2, get_rate_spike_train_setup_function(
                bayes_patterns, bayes_pattern_index,
                cs["bayesian_distortion"], bayesian_firing_rate, exc_n,
                sp["distortion_on_only"], rng=rng))
    else:
        if sp["d2"]:
            cue_patterns = [np.logical_not(i).astype(int) for i in patterns]
        else:
            cue_patterns = patterns
        network.apply_spike_train_lattice_given_position(
            C2, get_rate_spike_train_setup_function(
                cue_patterns, pattern2, cs["bayesian_distortion"],
                bayesian_firing_rate, exc_n, sp["distortion_on_only"],
                rng=rng))

    network.run_lattices(sp["iterations1"])

    hist = np.stack(network.get_lattice(E1).history)
    data = hist.reshape(hist.shape[0], -1)
    peaks = [find_peaks_above_threshold(data[:, i], 20)
             for i in range(num)]
    first_window = sp["iterations1"] - sp["first_window"]

    value = {}
    value["first_acc"] = determine_accuracy(
        patterns, pattern1, num_patterns, first_window, peaks, exc_n,
        sp["use_correlation_as_accuracy"], sp["get_all_accuracies"])
    if sp["bayesian_is_not_main"]:
        value["bayesian_first_acc"] = determine_accuracy(
            patterns, pattern2, num_patterns, first_window, peaks, exc_n,
            sp["use_correlation_as_accuracy"], sp["get_all_accuracies"])
    if mbm:
        hist2 = np.stack(network.get_lattice(E2).history)
        data2 = hist2.reshape(hist2.shape[0], -1)
        peaks2 = [find_peaks_above_threshold(data2[:, i], 20)
                  for i in range(num)]
        value["memory_biases_memory_first_acc"] = determine_accuracy(
            bayes_patterns, bayes_pattern_index, num_patterns,
            first_window, peaks2, exc_n,
            sp["use_correlation_as_accuracy"], sp["get_all_accuracies"])
    if sp["measure_snr"]:
        signal = data.mean(axis=1)
        value["first_snr"] = float(
            signal_to_noise(signal[:sp["iterations1"]]))
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
                filename="bayesian_rate_based_output.json",
                iterations1=1500, first_window=500, trials=2, d1=True,
                use_correlation_as_accuracy=True, measure_snr=True,
                reset_patterns=True, a=-1, b=0, skew=0.1),
            "variables": dict(s_d1=[1], distortion=[0.3, 0.6],
                              spike_train_to_exc=[4],
                              bayesian_to_exc=[0.4],
                              prob_of_exc_to_inh=[1]),
        }
    fill_defaults(parsed)
    sp = parsed["simulation_parameters"]
    np.seterr(divide="ignore", invalid="ignore")
    print(json.dumps(parsed, indent=4))

    rng = np.random.default_rng(sp["seed"])
    num = sp["exc_n"] ** 2
    combos = list(itertools.product(*parsed["variables"].values()))
    all_states = [dict(zip(parsed["variables"].keys(), c)) for c in combos]

    patterns = generate_patterns(num, 0.5, sp["num_patterns"],
                                 sp["correlation_threshold"], rng=rng)
    bayes_patterns = generate_patterns(num, 0.5, sp["num_patterns"],
                                       sp["correlation_threshold"], rng=rng)

    simulation_output = {}
    for current_state in all_states:
        for trial in range(sp["trials"]):
            if sp["reset_patterns"]:
                patterns = generate_patterns(
                    num, 0.5, sp["num_patterns"],
                    sp["correlation_threshold"], rng=rng)
                bayes_patterns = generate_patterns(
                    num, 0.5, sp["num_patterns"],
                    sp["correlation_threshold"], rng=rng)
            value, pattern1, pattern2 = run_trial(
                sp, current_state, patterns, bayes_patterns, rng)
            current_state.update(trial=trial, pattern1=pattern1,
                                 pattern2=pattern2)
            key = generate_key(parsed, current_state)
            simulation_output[key] = value
            print(f"{key} -> first_acc={value['first_acc']}")

    with open(output_path(sp["filename"]), "w") as f:
        json.dump(simulation_output, f, indent=4)
    print("Finished simulation")
    return simulation_output


if __name__ == "__main__":
    main(sys.argv)
