"""Reward-driven agent in a closed-loop environment — fused on device.

Demonstrates the `Environment`/`Agent` protocol
(`/root/reference/backend/src/interactable/mod.rs:21-60`): a reward-modulated
Izhikevich lattice is the agent; the environment's state tracks the
lattice's firing rate; the reward pushes the firing rate toward a target by
dopamine-modulating the recurrent weights (R-STDP).

Unlike the reference's per-step host loop, `JitEnvironment` compiles the
WHOLE episode — reward computation, R-STDP agent update, state update, cue
encoding — into one `lax.scan` device program (the host-loop `Environment`
pays a device dispatch per step).

Run: python examples/agent_environment.py
"""

import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])
import jax
import jax.numpy as jnp

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.interactable import JitEnvironment

TARGET_RATE = 0.08      # fraction of neurons spiking per step


def reward_fn(env, s):
    # proportional control toward the target rate; the sign of the reward
    # (via dopamine) gates whether the eligibility traces strengthen or
    # weaken the recurrent weights
    return jnp.clip(env["target"] - env["rate"], -0.05, 0.05)


def update_fn(env, s):
    spiking = s["is_spiking"].astype(jnp.float32).mean()
    return {**env, "rate": 0.9 * env["rate"] + 0.1 * spiking,
            "key": env["key"]}


def encoder_fn(env, s):
    # random cue: a fresh subset fires every step; the recurrent weights
    # (shaped by R-STDP) determine how far the activity spreads beyond it
    key, sub = jax.random.split(env["key"])
    idx = jax.random.choice(sub, 100, (6,), replace=False)
    return {**s, "v": s["v"].at[idx].set(31.0)}


def encoder_key_fn(env, s):
    """update_state advances the cue key so encoder_fn sees a fresh draw."""
    key, _ = jax.random.split(env["key"])
    return {**env, "key": key}


def main(iterations=1500):
    agent = snn.RewardModulatedLattice(snn.Izhikevich())
    agent.populate(10, 10, gap_conductance=10.0)
    agent.connect(lambda x, y: np.hypot(x[0] - y[0], x[1] - y[1]) <= 2
                  and x != y,
                  lambda x, y: 2.0)
    rng = np.random.default_rng(0)
    agent.apply(lambda s: {**s, "v": jnp.asarray(
        rng.uniform(-65, 30, 100), jnp.float32)})

    def update_state(env, s):
        return encoder_key_fn(update_fn(env, s), s)

    env = JitEnvironment(
        agent,
        {"rate": jnp.float32(0.0), "target": jnp.float32(TARGET_RATE),
         "key": jax.random.PRNGKey(3)},
        encoder_fn, reward_fn, update_state)

    def weight_drift():
        g = agent.graph
        return float(jnp.abs(jnp.where(g.mask, g.weights - 2.0, 0.0)).max())

    w_start = weight_drift()
    rates = []
    for chunk in range(10):
        env.run_with_reward(iterations // 10)
        rates.append(float(env.state["rate"]))
    w_mid = weight_drift()

    # flip the objective: an over-target setpoint makes the reward negative,
    # reversing the dopamine-gated drift
    env.state = {**env.state, "target": jnp.float32(-1.0)}
    for chunk in range(10):
        env.run_with_reward(iterations // 10)
        rates.append(float(env.state["rate"]))
    w_end = weight_drift()

    print("firing-rate trajectory:", " ".join(f"{r:.3f}" for r in rates))
    print(f"max |recurrent weight drift|: start {w_start:.3f} -> after "
          f"+reward {w_mid:.3f} -> after -reward {w_end:.3f}")
    print("reward-gated plasticity moved weights:", w_mid > w_start)
    return rates


if __name__ == "__main__":
    main()
