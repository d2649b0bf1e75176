"""Hodgkin-Huxley static-input sweep (the reference's
`backend/examples/hodgkin_huxley/main.rs`): gating variables + voltage."""

import numpy as np
import jax
import jax.numpy as jnp

import spiking_neural_networks_jax as snn


def main():
    model = snn.HodgkinHuxley()
    inputs = jnp.asarray([0.0, 10.0, 25.0, 50.0])
    state = model.init_state(4)

    def step(s, _):
        s, spikes = model.step(s, inputs)
        return s, (s["v"], s["na$m_state"], s["k$n_state"])

    state, (v, m, n_gate) = jax.jit(
        lambda s: jax.lax.scan(step, s, None, length=5000))(state)
    v = np.asarray(v)
    print("input ->  spikes (peak count over 50ms):")
    for col, i in enumerate(inputs):
        peaks = int(((v[1:-1, col] > 0) & (np.diff(v[:-1, col]) > 0)
                     & (np.diff(v[1:, col]) < 0)).sum())
        print(f"  {float(i):5.1f} -> {peaks}")


if __name__ == "__main__":
    main()
