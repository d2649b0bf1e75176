"""Head-direction ring attractor with shift layers.

Port of the reference's `interface_gpu/experiments/hd_model.py`: a ring of
Izhikevich neurons with local-excitation / global-inhibition weights holds a
direction bump; left/right "shift" layers driven by turning cells rotate the
bump through asymmetric (sigmoid-derivative) weights.

Run: python experiments/hd_attractor.py
"""

from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import spiking_neural_networks_jax.lixirnet as ln

N = 60


def circular_displacement(length, theta1, theta2):
    raw = theta2 - theta1
    return (raw + length / 2) % length - length / 2


def ring_distance(length, i, j):
    return min(abs(i - j), length - abs(i - j))


def sigmoid_second_derivative(x):
    return -1 * ((np.exp(x) * (np.exp(x) - 1)) / (np.exp(x) + 1) ** 3)


def hd_weight(x, y):
    return 3 * np.exp(-2 * ring_distance(N, x[0], y[0]) ** 2 / (N * 10)) - 0.9


def hd_to_shift_weight(x, y):
    return 1 * (np.exp(-2 * ring_distance(N, x[0], y[0]) ** 2 / (N * 10)) - 0.2)


def shift_left_weight(x, y):
    return 20 * sigmoid_second_derivative(
        circular_displacement(N, x[0], y[0]) / 5)


def shift_right_weight(x, y):
    return -20 * sigmoid_second_derivative(
        circular_displacement(N, x[0], y[0]) / 5)


def bump_position(history_chunk):
    """Circular mean of firing activity over the ring."""
    counts = (history_chunk >= 29.0).sum(axis=0)[:, 0]
    if counts.sum() == 0:
        return None
    angles = 2 * np.pi * np.arange(N) / N
    z = (counts * np.exp(1j * angles)).sum()
    return (np.angle(z) % (2 * np.pi)) / (2 * np.pi) * N


def main(direction=0, iterations=3000):
    rng = np.random.default_rng(0)

    def setup_neuron(neuron):
        neuron.current_voltage = float(rng.uniform(neuron.c, neuron.v_th))
        neuron.c_m = 100
        return neuron

    shift_left = ln.IzhikevichNeuronLattice(0)
    shift_left.populate(ln.IzhikevichNeuron(), N, 1)
    shift_left.apply(setup_neuron)

    shift_right = ln.IzhikevichNeuronLattice(1)
    shift_right.populate(ln.IzhikevichNeuron(), N, 1)
    shift_right.apply(setup_neuron)

    hd = ln.IzhikevichNeuronLattice(2)
    hd.populate(ln.IzhikevichNeuron(), N, 1)
    hd.connect(lambda x, y: True, hd_weight)
    hd.apply(setup_neuron)
    hd.update_grid_history = True

    turning = ln.RateSpikeTrainLattice(3)
    turning.populate(ln.RateSpikeTrain(), 2, 1)
    turning.apply_given_position(
        lambda pos, nr: setattr(nr, "rate", 100.0 if pos[0] == direction else 0.0))

    net = ln.IzhikevichNeuronNetwork.generate_network(
        [shift_left, shift_right, hd], [turning])
    net.connect(3, direction, lambda x, y: True, lambda x, y: 10)
    net.connect(0, 2, lambda x, y: True, shift_right_weight)
    net.connect(1, 2, lambda x, y: True, shift_left_weight)
    net.connect(2, 0, lambda x, y: True, hd_to_shift_weight)
    net.connect(2, 1, lambda x, y: True, hd_to_shift_weight)
    net.set_dt(1.0)

    net.run_lattices(iterations)
    hist = np.stack(net.get_lattice(2).history)  # (T, N, 1)

    window = iterations // 6
    positions = []
    for k in range(6):
        p = bump_position(hist[k * window:(k + 1) * window])
        positions.append(None if p is None else round(float(p), 1))
    print("bump position per window:", positions)
    active = (hist >= 29.0).any(axis=(1, 2)).mean()
    print(f"fraction of steps with activity: {active:.2f}")
    return positions


if __name__ == "__main__":
    main()
