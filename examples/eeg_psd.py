"""EEG readout + power spectral density of an inhibition-stabilized lattice
(the reference's interface/examples/inh_exc.py + eeg analysis)."""

import numpy as np
import jax.numpy as jnp

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.core.history import EEGHistory
from spiking_neural_networks_jax.analysis import eeg


def main():
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(10, 10, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=3)
    rng = np.random.default_rng(1)
    lat.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(-65, 30, 100), jnp.float32)})
    lat.grid_history = EEGHistory()
    lat.update_grid_history = True

    iterations, dt = 10000, 0.1
    lat.run_lattice(iterations)

    series = np.asarray(lat.grid_history.history)
    faxis, sxx = eeg.get_power_density(series, dt, iterations * dt)
    dom = float(faxis[int(np.argmax(np.asarray(sxx)))])
    print(f"EEG series length {len(series)}; dominant frequency "
          f"{dom:.2f} (1/ms units)")


if __name__ == "__main__":
    main()
