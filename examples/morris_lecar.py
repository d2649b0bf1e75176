"""Morris-Lecar static-input run (the reference's
`backend/examples/morris_lecar/main.rs`): a single neuron driven by a
constant 100 uA/cm^2 current for 10k steps; the voltage trace is scanned
on device and summarized (the reference writes it to
`morris_lecar_static_input.csv` — pass ``csv_path`` to do the same)."""

import numpy as np
import jax
import jax.numpy as jnp

import spiking_neural_networks_jax as snn


def main(iterations=10000, csv_path=None):
    model = snn.MorrisLecar()
    state = model.init_state(1)
    current = jnp.asarray([100.0], jnp.float32)

    def step(s, _):
        s, spikes = model.step(s, current)
        return s, s["v"][0]

    state, voltages = jax.jit(
        lambda s: jax.lax.scan(step, s, None, length=iterations))(state)
    v = np.asarray(voltages)

    # oscillation summary: count upward zero-crossings of the limit cycle
    mid = 0.5 * (v.min() + v.max())
    crossings = int(((v[:-1] < mid) & (v[1:] >= mid)).sum())
    print(f"Morris-Lecar, I={float(current[0]):.0f}: V in "
          f"[{v.min():.2f}, {v.max():.2f}] mV over {iterations} steps, "
          f"{crossings} oscillations")

    if csv_path is not None:
        with open(csv_path, "w") as f:
            f.write("voltages\n")
            f.writelines(f"{x}\n" for x in v)
    return v


if __name__ == "__main__":
    main()
