"""Interacting excitatory/inhibitory pools (the reference's
`backend/examples/interacting_pools/main.rs`): a 5x5 all-to-all inhibitory
pool and a 10x10 all-to-all excitatory pool, cross-coupled all-to-all
(inh -> exc with weight -1, exc -> inh with the default weight), each
recording an `AverageVoltageHistory` (core/history.py ==
neuron/mod.rs:305-322).  The reference writes the two average-voltage
traces to CSVs; here they are summarized (pass ``csv_prefix`` to write
``<prefix>_{inh,exc}.csv``)."""

import numpy as np
import jax.numpy as jnp

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.core.history import AverageVoltageHistory


def main(iterations=5000, csv_prefix=None, seed=0):
    rng = np.random.default_rng(seed)

    def pool(id, side, weight):
        lat = snn.Lattice(snn.Izhikevich(), id=id)
        lat.populate(side, side)
        lat.connect(lambda x, y: x != y, lambda x, y: weight)
        # current_voltage ~ U(v_init, v_th), as the reference's apply does
        lat.apply(lambda s: {**s, "v": jnp.asarray(
            rng.uniform(-65.0, 30.0, side * side), jnp.float32)})
        lat.grid_history = AverageVoltageHistory()
        lat.update_grid_history = True
        return lat

    inh = pool(0, 5, -1.0)
    exc = pool(1, 10, 1.0)

    net = snn.LatticeNetwork.generate_network([inh, exc], [])
    net.connect(0, 1, lambda x, y: True, lambda x, y: -1.0)
    net.connect(1, 0, lambda x, y: True)      # default weight (1.0)
    net.run_lattices(iterations)

    traces = {}
    for id, label in ((0, "inh"), (1, "exc")):
        trace = np.asarray(net.get_lattice(id).grid_history.history)
        traces[label] = trace
        print(f"{label} pool average voltage: {len(trace)} steps, "
              f"range [{trace.min():.2f}, {trace.max():.2f}] mV, "
              f"final {trace[-1]:.2f}")
        if csv_prefix is not None:
            with open(f"{csv_prefix}_{label}.csv", "w") as f:
                f.write("voltages\n")
                f.writelines(f"{x}\n" for x in trace)
    return traces


if __name__ == "__main__":
    main()
