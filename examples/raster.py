"""Spike raster from a lattice run.

Port of `/root/reference/interface/examples/raster.py`: random local
connectivity (radius 2, 80%), randomized initial voltages, long run, then a
per-neuron spike raster extracted with peak detection.  Prints an ASCII
raster instead of a matplotlib figure.

Run: python examples/raster.py
"""

import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])
import spiking_neural_networks_jax.lixirnet as ln
from spiking_neural_networks_jax.analysis.peaks import find_peaks_above_threshold

N = 5
ITERATIONS = 2000
PEAK_THRESHOLD = 20.0


def main():
    rng = np.random.default_rng(0)

    lattice = ln.IzhikevichNeuronLattice(0)
    lattice.populate(ln.IzhikevichNeuron(), N, N)
    lattice.apply(lambda n: setattr(
        n, "current_voltage", float(rng.uniform(-65, 30))))
    lattice.connect(
        lambda x, y: bool(
            np.hypot(x[0] - y[0], x[1] - y[1]) <= 2
            and rng.uniform() <= 0.8 and x != y))
    lattice.update_grid_history = True
    lattice.reset_timing()
    lattice.reset_history()
    lattice.run_lattice(ITERATIONS)

    hist = np.stack(lattice.history).reshape(ITERATIONS, N * N)
    raster = [find_peaks_above_threshold(hist[:, i], PEAK_THRESHOLD)
              for i in range(N * N)]

    bins = 80
    width = ITERATIONS // bins
    print(f"spike raster ({N * N} neurons x {ITERATIONS} steps, "
          f"one column = {width} steps):")
    for i, peaks in enumerate(raster):
        row = [" "] * bins
        for p in peaks:
            row[min(p // width, bins - 1)] = "|"
        print(f"{i:3d} {''.join(row)}")
    rates = [len(p) / (ITERATIONS / 1000) for p in raster]
    print(f"mean firing rate: {np.mean(rates):.1f} spikes/1000 steps")


if __name__ == "__main__":
    main()
