"""Tolman-Eichenbaum-style structural/sensory factorization on a ring world.

Implements the experiment referenced in `/root/reference/interface/
experiments/tolman_eichenbaum.py` (a 1-line pointer at jbakermans/
torch_tem in the reference), scaled to a spiking-network testbed: the
Tolman-Eichenbaum Machine's core claim is that spatial STRUCTURE (a ring
of positions and how actions move you along it) and SENSORY bindings
(which observation lives at which position) are factorized — structure
is reused across environments while bindings are relearned per
environment.

Here the structural code is a fixed ring attractor (local excitation /
global inhibition — the framework's HD machinery) whose bump is driven
along a random walk.  Per environment, a plastic (STDP) projection binds
active ring cells to the observation cell a teacher activates at each
position.  After learning, the teacher is removed and the ring bump alone
must recall each position's observation.  The ring weights NEVER change
between environments; only the bindings are re-learned, and recall
accuracy is reported for both environments.

Usage:
    python experiments/tolman_eichenbaum.py [--positions N] [--objects N]
        [--walk-steps N]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from pipeline_setup import output_path

import spiking_neural_networks_jax.lixirnet as ln

RING, READOUT, CUE, TEACHER = 0, 1, 2, 3


def ring_distance(length, i, j):
    return min(abs(i - j), length - abs(i - j))


def build(n_pos, n_obj, rng, stdp_a=0.2):
    from spiking_neural_networks_jax.core.history import SpikeHistory

    def setup_neuron(neuron):
        neuron.current_voltage = neuron.c
        neuron.c_m = 25
        return neuron

    # structural position cells: a fixed one-to-one cue->cell map (the
    # path-integration output in the full TEM; held constant across
    # environments here)
    ring = ln.IzhikevichNeuronLattice(RING)
    ring.populate(ln.IzhikevichNeuron(), n_pos, 1)
    ring.apply(setup_neuron)
    ring.inner.grid_history = SpikeHistory()
    ring.update_grid_history = True

    readout = ln.IzhikevichNeuronLattice(READOUT)
    readout.populate(ln.IzhikevichNeuron(), n_obj, 1)
    # quiet start + lateral inhibition: only the taught cell should fire
    # during binding, or every binding column grows together
    readout.apply(setup_neuron)
    readout.connect(lambda x, y: x != y, lambda x, y: -10.0)
    readout.inner.grid_history = SpikeHistory()
    readout.update_grid_history = True
    readout.plasticity = ln.STDP(a_plus=stdp_a, a_minus=stdp_a, dt=1.0)

    cue = ln.RateSpikeTrainLattice(CUE)
    cue.populate(ln.RateSpikeTrain(), n_pos, 1)
    teacher = ln.RateSpikeTrainLattice(TEACHER)
    teacher.populate(ln.RateSpikeTrain(), n_obj, 1)
    # fast refractoriness decay (default k=10000 means a train that fired
    # once keeps delivering ~85% of its peak voltage 40 steps later, so
    # stale cues never stop driving their cells)
    for st in (cue, teacher):
        st.inner.state["refractoriness$k"] = np.full(
            st.inner.state["refractoriness$k"].shape, 2.0, np.float32)

    net = ln.IzhikevichNeuronNetwork.generate_network(
        [ring, readout], [cue, teacher])
    ring_in = float(n_pos + 2)
    net.connect(CUE, RING, lambda x, y: x[0] == y[0],
                lambda x, y: ring_in * 40.0)
    # the plastic structure->sensory binding (starts weak + uniform)
    net.connect(RING, READOUT, lambda x, y: True, lambda x, y: 0.2)
    read_in = float(n_pos + 1)
    net.connect(TEACHER, READOUT, lambda x, y: x[0] == y[0],
                lambda x, y: read_in * 40.0)
    net.set_dt(1.0)
    return net


def set_one_hot_rate(net, lattice_id, index, rate=5.0, phase=0.0):
    """Drive one cell of a rate-train lattice periodically.  `phase` sets
    the initial step counter: a larger phase fires sooner."""
    def setter(pos, n):
        active = index is not None and pos[0] == index
        n.rate = rate if active else 0.0
        n.step = phase if active else 0.0
        return n
    net.apply_spike_train_lattice_given_position(lattice_id, setter)


def fresh_visit(net):
    """Visit boundary: clear last-firing-times (stale pairings otherwise
    leak STDP across visits) and re-arm the neurons (Izhikevich adaptation
    accumulated over a visit otherwise silences the next one)."""
    for lid in (RING, READOUT):
        lat = net.get_lattice(lid)
        lat.reset_timing()
        lat.apply(lambda n: setattr(n, "current_voltage", n.c) or
                  setattr(n, "u", n.b * n.c) or n)
    net.get_spike_train_lattice(CUE).reset_timing()
    net.get_spike_train_lattice(TEACHER).reset_timing()


def learn_environment(net, env_map, walk, steps_per_visit):
    """Random walk with the teacher labelling each position's observation;
    STDP binds co-active ring cells to the taught observation cell.

    The cue leads the teacher by two steps each 5-step cycle, so the
    position cell consistently fires BEFORE the taught observation cell —
    pair-based STDP is a strict no-op at zero timing difference
    (plasticity/mod.rs:46-65 fires on neither branch when the last firing
    times are equal), so phase-locked drives at the same step would never
    learn."""
    net.get_lattice(READOUT).do_plasticity = True
    for p in walk:
        fresh_visit(net)
        set_one_hot_rate(net, CUE, p, phase=4.0)
        set_one_hot_rate(net, TEACHER, int(env_map[p]), phase=2.0)
        net.run_lattices(steps_per_visit)
    net.get_lattice(READOUT).do_plasticity = False


def recall_accuracy(net, env_map, n_pos, steps_per_visit):
    """Teacher off: cue each position, predict the observation from the
    readout cell with the most spikes."""
    set_one_hot_rate(net, TEACHER, None)
    correct = 0
    for p in range(n_pos):
        fresh_visit(net)
        set_one_hot_rate(net, CUE, p, phase=4.0)
        net.get_lattice(READOUT).reset_history()
        net.run_lattices(steps_per_visit)
        hist = np.stack(net.get_lattice(READOUT).history)  # bool spikes
        counts = hist.sum(axis=0).reshape(-1)
        if counts.sum() > 0 and int(np.argmax(counts)) == int(env_map[p]):
            correct += 1
    return correct / n_pos


def reset_bindings(net, n_pos, n_obj, rng):
    """New environment: re-initialize every weight STDP could have touched
    (all edges with the plastic readout as an endpoint: the bindings, the
    teacher projection, and the readout's own lateral inhibition); the
    structural position code is untouched."""
    for i in range(n_pos):
        for j in range(n_obj):
            net.edit_weight((RING, (i, 0)), (READOUT, (j, 0)), 0.2)
    read_in = float(n_pos + 1)
    for j in range(n_obj):
        net.edit_weight((TEACHER, (j, 0)), (READOUT, (j, 0)), read_in * 40.0)
    readout = net.get_lattice(READOUT)
    for i in range(n_obj):
        for j in range(n_obj):
            if i != j:
                readout.edit_weight((i, 0), (j, 0), -10.0)


def main(n_pos=12, n_obj=4, walk_steps=60, steps_per_visit=40, seed=0):
    rng = np.random.default_rng(seed)
    net = build(n_pos, n_obj, rng)

    envs = [rng.integers(0, n_obj, n_pos) for _ in range(2)]
    results = {}
    for k, env_map in enumerate(envs):
        if k > 0:
            reset_bindings(net, n_pos, n_obj, rng)
        # random walk over the ring (neighbouring steps, like an agent)
        pos, walk = int(rng.integers(n_pos)), []
        for _ in range(walk_steps):
            pos = (pos + int(rng.choice([-1, 1]))) % n_pos
            walk.append(pos)
        learn_environment(net, env_map, walk, steps_per_visit)
        acc = recall_accuracy(net, env_map, n_pos, steps_per_visit)
        results[f"env{k}_accuracy"] = acc
        print(f"environment {k}: recall accuracy {acc:.2f} "
              f"(chance {1 / n_obj:.2f})")

    results.update(chance=1.0 / n_obj, n_positions=n_pos, n_objects=n_obj,
                   walk_steps=walk_steps, seed=seed)
    path = output_path("tolman_eichenbaum_output.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"saved {path}")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--positions", type=int, default=12)
    p.add_argument("--objects", type=int, default=4)
    p.add_argument("--walk-steps", type=int, default=60)
    a = p.parse_args()
    main(n_pos=a.positions, n_obj=a.objects, walk_steps=a.walk_steps)
