"""Reward-modulated STDP lattice (the reference's
`backend/examples/rstdp_lattice/main.rs`): reward schedule shapes weights
through dopamine-modulated eligibility traces."""

import numpy as np
import jax.numpy as jnp

import spiking_neural_networks_jax as snn


def main():
    lat = snn.RewardModulatedLattice(snn.Izhikevich())
    lat.populate(4, 4, gap_conductance=10.0)
    lat.connect(lambda x, y: x != y, lambda x, y: 1.0)
    rng = np.random.default_rng(0)
    lat.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(-65, 30, 16), jnp.float32)})

    rewards = np.where(np.arange(1000) % 100 < 50, 1.0, -0.5)
    lat.run_lattice_with_reward(jnp.asarray(rewards, jnp.float32), 1000)

    w = np.asarray(lat.graph.weights)
    print(f"dopamine={lat.dopamine:.3f}; weights in "
          f"[{w.min():.2f}, {w.max():.2f}]; "
          f"trace |c| max={np.abs(np.asarray(lat.trace['c'])).max():.4f}")


if __name__ == "__main__":
    main()
