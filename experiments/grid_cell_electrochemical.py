"""Grid-cell toroidal attractor with chemical synapses.

Implements `/root/reference/interface_gpu/experiments/
grid_cell_electrochemical.py` (an empty placeholder in the reference —
the electrochemical counterpart of its grid_cell_electrical_model.py):
the toroidal local-excitation / global-inhibition sheet from
grid_cell_model.py, rebuilt on glutamate/GABA receptor kinetics.  The
excitatory sheet talks through bounded glutamate release; a matching
inhibitory sheet (driven one-to-one by the grid) returns
distance-increasing GABA, and setter rate trains pin the bump.

Usage:
    python experiments/grid_cell_electrochemical.py [--iterations N]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from pipeline_setup import output_path
from grid_cell_model import toroidal_dist

import spiking_neural_networks_jax.lixirnet as ln

N = 16
GRID, GRID_INH, SETTERS = 0, 1, 2


def grid_weight(x, y):
    return 3 * np.exp(-2 * toroidal_dist(x, y, N) ** 2 / (N * 3)) - 0.9


def inh_weight(x, y):
    """GABA projection grows with toroidal distance — suppresses activity
    far from the bump."""
    d = toroidal_dist(x, y, N)
    return 2.0 * (1.0 - np.exp(-d ** 2 / (N * 1.5)))


def main(iterations=3000, target=(4, 10), seed=0):
    rng = np.random.default_rng(seed)

    glu = ln.GlutamateReceptor()
    gabaa = ln.GABAReceptor()
    receptors = ln.DopaGluGABA()
    receptors.insert(ln.DopaGluGABANeurotransmitterType.Glutamate, glu)
    receptors.insert(ln.DopaGluGABANeurotransmitterType.GABA, gabaa)

    glu_nts = {ln.DopaGluGABANeurotransmitterType.Glutamate:
               ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)}
    gaba_nts = {ln.DopaGluGABANeurotransmitterType.GABA:
                ln.BoundedNeurotransmitterKinetics(clearance_constant=0.001)}

    exc_neuron = ln.IzhikevichNeuron()
    exc_neuron.set_synaptic_neurotransmitters(glu_nts)
    exc_neuron.set_receptors(receptors)
    inh_neuron = ln.IzhikevichNeuron()
    inh_neuron.set_synaptic_neurotransmitters(gaba_nts)
    inh_neuron.set_receptors(receptors)
    setter_train = ln.RateSpikeTrain()
    setter_train.set_synaptic_neurotransmitters(glu_nts)

    def setup_neuron(neuron):
        neuron.current_voltage = neuron.c
        neuron.c_m = 25
        return neuron

    grid_cells = ln.IzhikevichNeuronLattice(GRID)
    grid_cells.populate(exc_neuron, N, N)
    grid_cells.connect(lambda x, y: True, grid_weight)
    grid_cells.apply(setup_neuron)
    grid_cells.update_grid_history = True

    grid_inh = ln.IzhikevichNeuronLattice(GRID_INH)
    grid_inh.populate(inh_neuron, N, N)
    grid_inh.apply(setup_neuron)

    setters = ln.RateSpikeTrainLattice(SETTERS)
    setters.populate(setter_train, N, N)

    def setup_setter(pos, neuron):
        neuron.rate = 1.0 if toroidal_dist(pos, target, N) <= 2 else 0.0
        return neuron

    setters.apply_given_position(setup_setter)

    net = ln.IzhikevichNeuronNetwork.generate_network(
        [grid_cells, grid_inh], [setters])
    in_degree = float(2 * N * N + 1)
    net.connect(SETTERS, GRID, lambda x, y: x == y,
                lambda x, y: in_degree * 4.0)
    net.connect(GRID, GRID_INH, lambda x, y: x == y,
                lambda x, y: float(N * N) * 2.0)
    net.connect(GRID_INH, GRID, lambda x, y: True, inh_weight)
    net.set_dt(1.0)
    net.electrical_synapse = False
    net.chemical_synapse = True

    net.run_lattices(iterations)

    hist = np.stack(net.get_lattice(GRID).history)
    counts = (hist[iterations // 2:] >= 29.0).sum(axis=0).astype(np.float64)
    center = []
    for axis in range(2):
        profile = counts.sum(axis=1 - axis)
        ang = 2 * np.pi * np.arange(N) / N
        z = (profile * np.exp(1j * ang)).sum()
        center.append(float((np.angle(z) % (2 * np.pi)) / (2 * np.pi) * N))
    d = float(toroidal_dist(center, target, N))
    out = dict(center=[round(c, 2) for c in center], target=list(target),
               toroidal_distance=round(d, 2),
               total_spikes=int(counts.sum()))
    path = output_path("grid_cell_electrochemical_output.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print(f"electrochemical grid: bump at "
          f"({center[0]:.1f}, {center[1]:.1f}), target {target}, "
          f"toroidal distance {d:.1f} ({'OK' if d <= 4 else 'OFF'}); "
          f"saved {path}")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--iterations", type=int, default=3000)
    a = p.parse_args()
    main(iterations=a.iterations)
