"""Dopaminergic neuromodulation of liquid stability.

Port of `/root/reference/interface/experiments/dopamine_liquid_interaction.py`:
a recurrent excitatory liquid (chemical glutamate synapses, echo-state
weight scaling) receives a disturbing Poisson group and a tonic dopamine
group.  The disturbance follows an off/on/off protocol; the metric is how
many steps the liquid's mean voltage takes to return to its pre-disturbance
baseline.  Varying D1/D2 gains (and where the dopamine projects) maps how
neuromodulation shifts the liquid's stability — e.g. with tonic D1 the
network sits at a higher, noisier baseline and re-enters it sooner.

Run: python experiments/dopamine_liquid_interaction.py
"""

from __future__ import annotations

import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from pipeline_setup import output_path, signal_to_noise
from lsm_setup import (generate_liquid_weights, generate_start_firing,
                       stop_firing, determine_return_to_baseline)

import spiking_neural_networks_jax.lixirnet as ln


def run_condition(s_d1, s_d2, rows=8, cols=8, off_phase=5000, on_phase=1000,
                  settling_period=1000, tolerance=2.0, seed=0,
                  disturb_rate=0.01, dopa_rate=0.01, internal_scalar=0.125,
                  spike_train_connectivity=0.5, spike_train_to_exc=3.0):
    rng = np.random.default_rng(seed)
    num = rows * cols
    w = generate_liquid_weights(num, connectivity=0.25,
                                scalar=internal_scalar, rng=rng)

    glu_neuro = ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)
    dopa_neuro = ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)
    exc_nts = {ln.DopaGluGABANeurotransmitterType.Glutamate: glu_neuro}
    dopa_nts = {ln.DopaGluGABANeurotransmitterType.Dopamine: dopa_neuro}

    glu = ln.GlutamateReceptor(ampa_r=ln.BoundedReceptorKinetics(r_max=10),
                               nmda_r=ln.BoundedReceptorKinetics(r_max=10))
    dopamine_rs = ln.DopamineReceptor(s_d1=s_d1, s_d2=s_d2)
    receptors = ln.DopaGluGABA()
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Glutamate, glu)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Dopamine, dopamine_rs)

    exc_neuron = ln.IzhikevichNeuron()
    exc_neuron.c_m = 25.0
    exc_neuron.set_synaptic_neurotransmitters(exc_nts)
    exc_neuron.set_receptors(receptors)
    poisson = ln.PoissonNeuron()
    poisson.set_synaptic_neurotransmitters(exc_nts)
    poisson_dopa = ln.PoissonNeuron()
    poisson_dopa.set_synaptic_neurotransmitters(dopa_nts)

    liquid = ln.IzhikevichNeuronLattice(0)
    liquid.populate(exc_neuron, rows, cols)
    pos_to_idx = liquid.position_to_index
    liquid.connect(lambda x, y: bool(w[pos_to_idx[x]][pos_to_idx[y]] != 0),
                   lambda x, y: float(w[pos_to_idx[x]][pos_to_idx[y]]))
    liquid.apply(lambda n: setattr(
        n, "current_voltage", float(rng.uniform(-65, 30))))
    liquid.update_grid_history = True

    disturb = ln.PoissonLattice(1)
    disturb.populate(poisson, rows, cols)
    dopa = ln.PoissonLattice(2)
    dopa.populate(poisson_dopa, rows, cols)

    network = ln.IzhikevichNeuronNetwork.generate_network(
        [liquid], [disturb, dopa])
    network.connect(
        1, 0, lambda x, y: rng.uniform() < spike_train_connectivity,
        lambda x, y: spike_train_to_exc)
    network.connect(
        2, 0, lambda x, y: rng.uniform() < spike_train_connectivity,
        lambda x, y: spike_train_to_exc)
    network.electrical_synapse = False
    network.chemical_synapse = True
    network.set_dt(1.0)

    # tonic dopamine for the whole protocol
    network.apply_spike_train_lattice(2, generate_start_firing(dopa_rate))

    network.apply_spike_train_lattice(1, stop_firing)
    network.run_lattices(off_phase)
    network.apply_spike_train_lattice(1, generate_start_firing(disturb_rate))
    network.run_lattices(on_phase)
    network.apply_spike_train_lattice(1, stop_firing)
    network.run_lattices(off_phase)

    hist = network.get_lattice(0).history
    voltages = [float(np.array(i).mean()) for i in hist]
    recovery = determine_return_to_baseline(
        voltages, settling_period, on_phase, off_phase, tolerance)
    snr_baseline = float(signal_to_noise(voltages[settling_period:off_phase]))
    snr_disturbed = float(signal_to_noise(
        voltages[off_phase:off_phase + on_phase]))
    return dict(recovery_steps=recovery, snr_baseline=snr_baseline,
                snr_disturbed=snr_disturbed)


def main():
    conditions = {
        "no dopamine receptors": dict(s_d1=0.0, s_d2=0.0),
        "d2 (inhibitory gain)": dict(s_d1=0.0, s_d2=0.05),
        "d1 (excitatory gain)": dict(s_d1=1.0, s_d2=0.0),
    }
    results = {}
    for name, kw in conditions.items():
        results[name] = run_condition(**kw)
        r = results[name]
        print(f"{name}: recovery {r['recovery_steps']} steps, "
              f"baseline SNR {r['snr_baseline']:.2f}, "
              f"disturbed SNR {r['snr_disturbed']:.2f}")
    with open(output_path("dopamine_liquid_output.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


# ---------------------------------------------------------------------------
# Full TOML grid runner — port of the reference protocol
# (`/root/reference/interface/experiments/dopamine_liquid_interaction.py`),
# driven by the committed `dopamine_liquid_args/*.toml` configs.  Uses the
# legacy Dopa* lixirnet surface exactly like the reference script.
# ---------------------------------------------------------------------------

_SIM_DEFAULTS = dict(
    exc_only=True, on_phase=1000, off_phase=5000, settling_period=1000,
    tolerance=2, peaks_on=False, trials=10, skew=1, exc_n=7, inh_n=3,
    d1=False, d2=False, d_acts_on_inh=False, dt=1, c_m=100,
    measure_snr=False)

_VAR_DEFAULTS = dict(
    cue_firing_rate=[0.01], dopamine_firing_rate=[0.01],
    connectivity=[0.25], inh_connectivity=[0.25],
    exc_to_inh_connectivity=[0.15], inh_to_exc_connectivity=[0.15],
    spike_train_connectivity=[0.5], internal_scalar=[0.125],
    spike_train_to_exc=[3], exc_to_inh_weight=[0.0125],
    inh_to_exc_weight=[0.0125], inh_internal_scalar=[2],
    nmda_g=[0.6], ampa_g=[1], gabaa_g=[1.2], s_d1=[1], s_d2=[0.025],
    glutamate_clearance=[0.001], gabaa_clearance=[0.001],
    dopamine_clearance=[0.001])

_KEY_FIELDS = [
    "cue_firing_rate", "dopamine_firing_rate", "connectivity",
    "spike_train_connectivity", "inh_connectivity",
    "exc_to_inh_connectivity", "inh_to_exc_connectivity",
    "spike_train_to_exc", "internal_scalar", "inh_internal_scalar",
    "exc_to_inh_weight", "inh_to_exc_weight", "nmda_g", "ampa_g",
    "gabaa_g", "s_d1", "s_d2", "glutamate_clearance", "gabaa_clearance",
    "dopamine_clearance"]


def fill_defaults(parsed):
    """Reference `fill_defaults`
    (interface/experiments/dopamine_liquid_interaction.py:18-111)."""
    if "simulation_parameters" not in parsed:
        raise ValueError("Requires `simulation_parameters` table")
    if "filename" not in parsed["simulation_parameters"]:
        raise ValueError(
            "Requires `filename` field in `simulation_parameters`")
    if "variables" not in parsed:
        raise ValueError("Requires `variables` table")
    for k, v in _SIM_DEFAULTS.items():
        parsed["simulation_parameters"].setdefault(k, v)
    for k, v in _VAR_DEFAULTS.items():
        parsed["variables"].setdefault(k, list(v))
    return parsed


def _run_grid_point(sp, cs, rng):
    """One (combination, trial) run of the reference protocol
    (interface/experiments/dopamine_liquid_interaction.py:164-370)."""
    from pipeline_setup import generate_setup_neuron, find_peaks_above_threshold

    exc_n, inh_n = sp["exc_n"], sp["inh_n"]
    num, inh_num = exc_n * exc_n, inh_n * inh_n
    setup_neuron = generate_setup_neuron(sp["c_m"], sp["skew"], rng=rng)
    w = generate_liquid_weights(num, connectivity=cs["connectivity"],
                                scalar=cs["internal_scalar"], rng=rng)

    glu_neuro = ln.ApproximateNeurotransmitter(
        clearance_constant=cs["glutamate_clearance"])
    exc_nts = ln.DopaGluGABAApproximateNeurotransmitters()
    exc_nts.set_neurotransmitter(
        ln.DopaGluGABANeurotransmitterType.Glutamate, glu_neuro)
    gaba_neuro = ln.ApproximateNeurotransmitter(
        clearance_constant=cs["gabaa_clearance"])
    inh_nts = ln.DopaGluGABAApproximateNeurotransmitters()
    inh_nts.set_neurotransmitter(
        ln.DopaGluGABANeurotransmitterType.GABA, gaba_neuro)
    dopa_neuro = ln.ApproximateNeurotransmitter(
        clearance_constant=cs["dopamine_clearance"])
    dopa_nts = ln.DopaGluGABAApproximateNeurotransmitters()
    dopa_nts.set_neurotransmitter(
        ln.DopaGluGABANeurotransmitterType.Dopamine, dopa_neuro)

    glu = ln.GlutamateReceptor()
    # NOTE: the reference assigns the swapped pair (ampa_g <- nmda_g,
    # nmda_g <- ampa_g; dopamine_liquid_interaction.py:190-191) —
    # replicated faithfully so its configs reproduce
    glu.ampa_g = cs["nmda_g"]
    glu.nmda_g = cs["ampa_g"]
    gaba = ln.GABAReceptor()
    gaba.g = cs["gabaa_g"]
    dopamine_rs = ln.DopamineReceptor()
    dopamine_rs.d1_enabled = sp["d1"]
    dopamine_rs.d2_enabled = sp["d2"]
    dopamine_rs.s_d1 = cs["s_d1"]
    dopamine_rs.s_d2 = cs["s_d2"]
    receptors = ln.DopaGluGABAReceptors()
    receptors.set_receptor(
        ln.DopaGluGABANeurotransmitterType.Glutamate, glu)
    receptors.set_receptor(ln.DopaGluGABANeurotransmitterType.GABA, gaba)
    receptors.set_receptor(
        ln.DopaGluGABANeurotransmitterType.Dopamine, dopamine_rs)

    exc_neuron = ln.DopaIzhikevichNeuron()
    exc_neuron.set_neurotransmitters(exc_nts)
    exc_neuron.set_receptors(receptors)
    poisson_neuron = ln.DopaPoissonNeuron()
    poisson_neuron.set_neurotransmitters(exc_nts)
    dopa_poisson = ln.DopaPoissonNeuron()
    dopa_poisson.set_neurotransmitters(dopa_nts)

    e1, i1, c1, c2 = 0, 1, 2, 3
    exc_lattice = ln.DopaIzhikevichLattice(e1)
    exc_lattice.populate(exc_neuron, exc_n, exc_n)
    exc_lattice.apply(setup_neuron)
    p2i = exc_lattice.position_to_index
    exc_lattice.connect(
        lambda x, y: bool(float(w[p2i[x]][p2i[y]]) != 0),
        lambda x, y: float(w[p2i[x]][p2i[y]]))
    exc_lattice.update_grid_history = True

    spike_train_lattice = ln.DopaPoissonLattice(c1)
    spike_train_lattice.populate(poisson_neuron, exc_n, exc_n)
    dopa_lattice = ln.DopaPoissonLattice(c2)
    dopa_lattice.populate(dopa_poisson, exc_n, exc_n)

    if not sp["exc_only"]:
        w_inh = generate_liquid_weights(
            inh_num, connectivity=cs["inh_connectivity"],
            scalar=cs["inh_internal_scalar"], rng=rng)
        inh_neuron = ln.DopaIzhikevichNeuron()
        inh_neuron.set_neurotransmitters(inh_nts)
        inh_neuron.set_receptors(receptors)
        inh_lattice = ln.DopaIzhikevichLattice(i1)
        inh_lattice.populate(inh_neuron, inh_n, inh_n)
        inh_lattice.apply(setup_neuron)
        q2i = inh_lattice.position_to_index
        inh_lattice.connect(
            lambda x, y: bool(float(w_inh[q2i[x]][q2i[y]]) != 0),
            lambda x, y: float(w_inh[q2i[x]][q2i[y]]))
        network = ln.DopaIzhikevichNetwork.generate_network(
            [exc_lattice, inh_lattice],
            [spike_train_lattice, dopa_lattice])
    else:
        network = ln.DopaIzhikevichNetwork.generate_network(
            [exc_lattice], [spike_train_lattice, dopa_lattice])

    network.set_dt(sp["dt"])
    network.electrical_synapse = False
    network.chemical_synapse = True
    network.apply_spike_train_lattice(
        c2, generate_start_firing(cs["dopamine_firing_rate"]))

    if not sp["exc_only"]:
        # NOTE: the reference wires BOTH of these i1 -> e1 (the second was
        # plainly meant to be e1 -> i1; dopamine_liquid_interaction.py:
        # 273-284) — replicated faithfully
        network.connect(
            i1, e1,
            lambda x, y: rng.uniform(0, 1) < cs["inh_to_exc_connectivity"],
            lambda x, y: cs["inh_to_exc_weight"])
        network.connect(
            i1, e1,
            lambda x, y: rng.uniform(0, 1) < cs["exc_to_inh_connectivity"],
            lambda x, y: cs["exc_to_inh_weight"])
    network.connect(
        c1, e1,
        lambda x, y: rng.uniform(0, 1) < cs["spike_train_connectivity"],
        lambda x, y: cs["spike_train_to_exc"])
    dopa_target = i1 if (sp["d_acts_on_inh"] and not sp["exc_only"]) else e1
    network.connect(
        c2, dopa_target,
        lambda x, y: rng.uniform(0, 1) < cs["spike_train_connectivity"],
        lambda x, y: cs["spike_train_to_exc"])

    network.apply_spike_train_lattice(c1, stop_firing)
    network.run_lattices(sp["off_phase"])
    network.apply_spike_train_lattice(
        c1, generate_start_firing(cs["cue_firing_rate"]))
    network.run_lattices(sp["on_phase"])
    network.apply_spike_train_lattice(c1, stop_firing)
    network.run_lattices(sp["off_phase"])

    hist = network.get_lattice(e1).history
    voltages = [float(np.array(i).mean()) for i in hist]
    out = {"return_to_baseline": determine_return_to_baseline(
        voltages, sp["settling_period"], sp["on_phase"], sp["off_phase"],
        sp["tolerance"]), "voltages": voltages}
    if sp["measure_snr"]:
        out["first_snr"] = float(signal_to_noise(
            voltages[sp["settling_period"]:sp["off_phase"]]))
        out["second_snr"] = float(signal_to_noise(
            voltages[sp["on_phase"] + sp["off_phase"]:]))
        out["during_disturbance"] = float(signal_to_noise(
            voltages[sp["on_phase"]:sp["on_phase"] + sp["off_phase"]]))
    if sp["peaks_on"]:
        data = np.array(hist).reshape(len(hist), -1)
        out["peaks"] = [
            [int(p) for p in find_peaks_above_threshold(data[:, i], 20)]
            for i in range(data.shape[1])]
    return out


def run_grid(argv, seed=0):
    """TOML-grid entry point (reference protocol)."""
    import itertools
    from pipeline_setup import parse_toml, generate_key_helper

    with open(argv[1], "rb") as f:
        parsed = parse_toml(f)
    fill_defaults(parsed)
    sp = parsed["simulation_parameters"]
    names = list(parsed["variables"].keys())
    combos = list(itertools.product(*parsed["variables"].values()))
    rng = np.random.default_rng(seed)
    out = {}
    for combo in combos:
        cs = dict(zip(names, combo))
        for trial in range(sp["trials"]):
            value = _run_grid_point(sp, cs, rng)
            cs["trial"] = trial
            key = [f"trial: {trial}"]
            for field in _KEY_FIELDS:
                generate_key_helper(cs, key, parsed, field)
            out[", ".join(key)] = value
    with open(output_path(sp["filename"]), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1:
        run_grid(sys.argv)
    else:
        main()
