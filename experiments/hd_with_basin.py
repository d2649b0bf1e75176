"""Electrochemical head-direction ring with a dopaminergic attractor basin.

Implements the experiment sketched in `/root/reference/interface_gpu/
experiments/hd_with_basin.py` (a 2-line design note: "electrochemical hd
with basin around a certain angle" + "try d1 and d2 action on certain
neurons in hd ring exc/inh to bias a certain direction"): the HD ring from
hd_electrochemical_model_no_turning.py plus a tonic dopaminergic rate
spike train projecting onto every HD neuron.  Per-neuron D1 gain is high
near the basin angle (amplifying glutamate currents there) and per-neuron
D2 gain is high far from it (damping them), so the bump, cued anywhere,
drifts into the basin.

Usage:
    python experiments/hd_with_basin.py [--basin N] [--cue N]
        [--iterations N] [--cue-iterations N]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from pipeline_setup import output_path, find_peaks_above_threshold
from hd_electrochemical_model_dopaminergic import (center_of_mass_ring,
                                                   ring_distance)
from hd_electrochemical_model_no_turning import (N, HD, HD_INH, CUE,
                                                 hd_weight,
                                                 distance_scaled_inhibition)

import spiking_neural_networks_jax.lixirnet as ln

DOPA = 3
BACKGROUND = 4


def main(basin=45, cue_angle=20, iterations=4000, cue_iterations=1500,
         seed=0, dopamine_weight=2.0):
    rng = np.random.default_rng(seed)

    glu = ln.GlutamateReceptor()
    gabaa = ln.GABAReceptor()
    dopa = ln.DopamineReceptor()        # per-neuron gains set after populate
    receptors = ln.DopaGluGABA()
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Glutamate, glu)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.GABA, gabaa)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Dopamine, dopa)

    glu_nts = {ln.DopaGluGABANeurotransmitterType.Glutamate:
               ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)}
    gaba_nts = {ln.DopaGluGABANeurotransmitterType.GABA:
                ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)}
    dopa_nts = {ln.DopaGluGABANeurotransmitterType.Dopamine:
                ln.BoundedNeurotransmitterKinetics(clearance_constant=0.002)}

    exc_neuron = ln.IzhikevichNeuron()
    exc_neuron.set_synaptic_neurotransmitters(glu_nts)
    exc_neuron.set_receptors(receptors)
    inh_neuron = ln.IzhikevichNeuron()
    inh_neuron.set_synaptic_neurotransmitters(gaba_nts)
    inh_neuron.set_receptors(receptors)
    cue_train = ln.RateSpikeTrain()
    cue_train.set_synaptic_neurotransmitters(glu_nts)
    dopa_train = ln.RateSpikeTrain()
    dopa_train.set_synaptic_neurotransmitters(dopa_nts)

    def setup_neuron(neuron):
        neuron.current_voltage = float(rng.uniform(neuron.c, neuron.v_th))
        neuron.c_m = 25
        return neuron

    hd = ln.IzhikevichNeuronLattice(HD)
    hd.populate(exc_neuron, N, 1)
    hd.connect(lambda x, y: True, hd_weight)
    hd.apply(setup_neuron)
    hd.update_grid_history = True

    hd_inh = ln.IzhikevichNeuronLattice(HD_INH)
    hd_inh.populate(inh_neuron, N, 1)
    hd_inh.connect(lambda x, y: True, hd_weight)
    hd_inh.apply(setup_neuron)

    # the basin: D1 gain peaks at the basin angle (boosting excitation
    # there), D2 gain grows away from it (damping excitation elsewhere)
    dist = np.array([ring_distance(N, k, basin) for k in range(N)],
                    np.float32)
    # wide profile: the D1/D2 gradient must reach wherever the cue parks
    # the bump (sigma = N/2), or the basin exerts no pull on it
    profile = np.exp(-(dist / (N / 2.0)) ** 2).astype(np.float32)
    hd.inner.state["rec$s_d1"] = 1.0 * profile
    hd.inner.state["rec$s_d2"] = 0.6 * (1.0 - profile)

    cue = ln.RateSpikeTrainLattice(CUE)
    cue.populate(cue_train, N, 1)
    cue.apply_given_position(
        lambda pos, n: setattr(
            n, "rate",
            0.01 if ring_distance(N, pos[0], cue_angle) <= 2 else 0.0) or n)

    dopa_cells = ln.RateSpikeTrainLattice(DOPA)
    dopa_cells.populate(dopa_train, 1, 1)
    dopa_cells.apply(lambda n: setattr(n, "rate", 0.01) or n)

    # weak uniform background drive: gives the D1-boosted basin region
    # something to amplify once the cue is gone (rate trains with random
    # phase offsets — all spike-train lattices in one network must share a
    # model config, so Poisson cannot be mixed with the rate trains here)
    background_train = ln.RateSpikeTrain()
    background_train.set_synaptic_neurotransmitters(glu_nts)
    background = ln.RateSpikeTrainLattice(BACKGROUND)
    background.populate(background_train, N, 1)

    def setup_background(pos, n):
        n.rate = 20.0
        n.step = float(rng.integers(0, 20))
        return n

    background.apply_given_position(setup_background)

    net = ln.IzhikevichNeuronNetwork.generate_network(
        [hd, hd_inh], [cue, dopa_cells, background])
    net.connect(CUE, HD, lambda x, y: x[0] == y[0],
                lambda x, y: float(2 * N + 3) * 4.0)
    net.connect(BACKGROUND, HD, lambda x, y: x[0] == y[0],
                lambda x, y: float(2 * N + 3) * 1.5)
    net.connect(DOPA, HD, lambda x, y: True, lambda x, y: dopamine_weight)
    net.connect(HD, HD_INH, lambda x, y: True,
                lambda x, y: max(hd_weight(x, y), 0))
    net.connect(HD_INH, HD, lambda x, y: True, distance_scaled_inhibition)
    net.set_dt(1)
    net.electrical_synapse = False
    net.chemical_synapse = True

    net.run_lattices(cue_iterations)
    net.apply_spike_train_lattice(CUE, lambda n: setattr(n, "rate", 0.0) or n)
    net.run_lattices(iterations)

    hist = np.stack(net.get_lattice(HD).history)
    data = hist.reshape(hist.shape[0], -1)
    peaks = [find_peaks_above_threshold(data[:, i], 20)
             for i in range(data.shape[1])]

    def window_theta(lo, hi):
        counts = np.array([len([j for j in p if lo <= j < hi])
                           for p in peaks])
        return float(center_of_mass_ring(counts)) if counts.sum() else None

    cued = window_theta(cue_iterations // 2, cue_iterations)
    total = cue_iterations + iterations
    final = window_theta(total - iterations // 2, total)

    def rdist(a, b):
        return None if a is None or b is None else \
            abs((a - b + N / 2) % N - N / 2)

    out = dict(basin=basin, cue_angle=cue_angle, cued_theta=cued,
               final_theta=final,
               dist_to_basin_start=rdist(cued, basin),
               dist_to_basin_end=rdist(final, basin),
               peaks=[[int(p) for p in sub] for sub in peaks])
    path = output_path("hd_with_basin_output.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print(f"hd basin: cued theta {cued} (target basin {basin}), "
          f"final theta {final}; dist to basin "
          f"{out['dist_to_basin_start']} -> {out['dist_to_basin_end']}; "
          f"saved {path}")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--basin", type=int, default=45)
    p.add_argument("--cue", type=int, default=20)
    p.add_argument("--iterations", type=int, default=4000)
    p.add_argument("--cue-iterations", type=int, default=1500)
    a = p.parse_args()
    main(basin=a.basin, cue_angle=a.cue, iterations=a.iterations,
         cue_iterations=a.cue_iterations)
