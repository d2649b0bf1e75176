"""Izhikevich lattice with radius-2 random connectivity (the reference's
`backend/examples/lattice/main.rs`): run 5000 steps, save the voltage
history."""

import os
import sys

import numpy as np
import jax.numpy as jnp

import spiking_neural_networks_jax as snn

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "experiments"))
from pipeline_setup import output_path  # noqa: E402


def main():
    rows, cols, iterations = 10, 10, 5000
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(rows, cols, gap_conductance=10.0)
    # connect neurons within a radius of 2 with an 80% chance of connection
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=0)
    rng = np.random.default_rng(0)
    lat.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(-65.0, 30.0, rows * cols), jnp.float32)})
    lat.update_grid_history = True

    lat.run_lattice(iterations)

    hist = np.stack(lat.grid_history.history)
    np.save(output_path("lattice_history.npy"), hist)
    print(f"saved lattice_history.npy {hist.shape}; "
          f"V in [{hist.min():.1f}, {hist.max():.1f}]")


if __name__ == "__main__":
    main()
