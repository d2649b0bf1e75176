"""Agent/Environment protocol: host loop (reference semantics) and the
on-device JitEnvironment must produce the same trajectory."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.interactable import (Environment,
                                                      JitEnvironment)

TARGET = 0.10


def _agent():
    lat = snn.RewardModulatedLattice(snn.Izhikevich())
    lat.populate(8, 8, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=2)
    v0 = np.random.default_rng(0).uniform(-65.0, 30.0, 64).astype(np.float32)
    v0[:6] = 40.0
    # staggered spike history so R-STDP time diffs are nonzero immediately
    lft = np.full(64, -1, np.int32)
    lft[::2] = 3
    lat.apply(lambda s: {**s, "v": jnp.asarray(v0),
                         "last_firing_time": jnp.asarray(lft)})
    return lat


class _HostState:
    def __init__(self):
        self.rate = np.float32(0.0)

    def update_state(self, agent):
        spiking = np.float32(np.asarray(
            agent.state["is_spiking"], np.float32).mean())
        self.rate = np.float32(0.9) * self.rate + np.float32(0.1) * spiking


def _host_encoder(state, agent):
    # constant cue: clamp the first 6 neurons high every step
    v = np.asarray(agent.state["v"]).copy()
    v[:6] = 40.0
    agent.state = {**agent.state, "v": jnp.asarray(v, jnp.float32)}


def _host_reward(state, agent):
    return float(np.float32(TARGET) - state.rate)


def test_jit_environment_matches_host_loop():
    steps = 40

    host_agent = _agent()
    host_env = Environment(host_agent, _HostState(), _host_encoder,
                           _host_reward)
    host_env.run_with_reward(steps)

    jit_agent = _agent()

    def reward_fn(env, s):
        return jnp.float32(TARGET) - env["rate"]

    def update_fn(env, s):
        spiking = s["is_spiking"].astype(jnp.float32).mean()
        return {"rate": jnp.float32(0.9) * env["rate"]
                + jnp.float32(0.1) * spiking}

    def encoder_fn(env, s):
        v = s["v"].at[:6].set(40.0)
        return {**s, "v": v}

    jit_env = JitEnvironment(jit_agent, {"rate": jnp.float32(0.0)},
                             encoder_fn, reward_fn, update_fn)
    rewards = jit_env.run_with_reward(steps)

    assert rewards.shape == (steps,)
    np.testing.assert_allclose(np.asarray(host_agent.state["v"]),
                               np.asarray(jit_agent.state["v"]),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(host_agent.graph.weights),
                               np.asarray(jit_agent.graph.weights),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(host_agent.dopamine, jit_agent.dopamine,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(host_env.state.rate,
                               float(jit_env.state["rate"]), rtol=1e-4,
                               atol=1e-6)
    # non-vacuous: the loop spiked and modulated weights
    assert (np.asarray(jit_agent.state["last_firing_time"]) >= 0).any()
    w0 = np.asarray(_agent().graph.weights)
    assert not np.array_equal(np.asarray(jit_agent.graph.weights), w0)


def test_jit_environment_repeat_and_clock():
    agent = _agent()
    env = JitEnvironment(agent, {"rate": jnp.float32(0.0)},
                         lambda e, s: s,
                         lambda e, s: jnp.float32(0.5),
                         lambda e, s: e)
    env.run_with_reward(30)
    env.run_with_reward(30)
    assert agent.internal_clock == 60


def test_jit_environment_unsupervised_matches_host():
    """`JitEnvironment.run` (unsupervised, plain-Lattice agent) vs the
    host-loop `UnsupervisedEnvironment` (interactable/mod.rs:48-59)."""
    from spiking_neural_networks_jax.interactable import (
        UnsupervisedEnvironment)

    def plain_agent():
        lat = snn.Lattice(snn.Izhikevich())
        lat.populate(8, 8, gap_conductance=10.0)
        lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=4)
        lat.do_plasticity = True
        v0 = np.random.default_rng(1).uniform(-65.0, 30.0, 64) \
            .astype(np.float32)
        v0[:5] = 40.0
        lft = np.full(64, -1, np.int32)
        lft[::2] = 3
        lat.apply(lambda s: {**s, "v": jnp.asarray(v0),
                             "last_firing_time": jnp.asarray(lft)})
        return lat

    class HState:
        def update_state(self, agent):
            pass

    def host_encoder(state, agent):
        agent.apply(lambda s: {**s, "v": s["v"].at[:5].set(40.0)})

    host = plain_agent()
    henv = UnsupervisedEnvironment(host, HState(), host_encoder)
    henv.run(50)

    fused = plain_agent()
    jenv = JitEnvironment(fused, {}, lambda e, s: {**s,
                                                   "v": s["v"].at[:5]
                                                   .set(40.0)},
                          None, lambda e, s: e)
    jenv.run(50)

    np.testing.assert_allclose(np.asarray(host.state["v"]),
                               np.asarray(fused.state["v"]),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(host.graph.weights),
                               np.asarray(fused.graph.weights),
                               rtol=2e-4, atol=2e-4)
    assert fused.internal_clock == 50


def test_jit_environment_grid_history():
    """JitEnvironment records grid histories inside the fused episode
    (was rejected in round 2): seamless across history chunks and equal to
    the host-loop trajectory."""
    import numpy as np
    import jax.numpy as jnp
    import spiking_neural_networks_jax as snn
    from spiking_neural_networks_jax.interactable import JitEnvironment

    def build():
        lat = snn.RewardModulatedLattice(snn.Izhikevich())
        lat.populate(4, 4, gap_conductance=10.0)
        lat.connect_stencil(radius=1.5, keep_prob=1.0, seed=2)
        v0 = np.random.default_rng(3).uniform(-65, 30, 16).astype(np.float32)
        lat.apply(lambda s: {**s, "v": jnp.asarray(v0)})
        lat.update_grid_history = True
        env = JitEnvironment(
            lat, {"rate": jnp.float32(0.0)},
            lambda e, s: {**s, "v": s["v"].at[:2].set(31.0)},
            lambda e, s: jnp.clip(0.05 - e["rate"], -0.05, 0.05),
            lambda e, s: {"rate": 0.9 * e["rate"]
                          + 0.1 * s["is_spiking"].astype(jnp.float32).mean()})
        return lat, env

    lat_a, env_a = build()
    env_a.run_with_reward(50)
    assert len(lat_a.grid_history.history) == 50
    ha = np.stack(lat_a.grid_history.history)
    assert ha.shape == (50, 4, 4)

    # chunked run produces the identical trajectory
    lat_b, env_b = build()
    lat_b.history_chunk = 7
    env_b.run_with_reward(50)
    hb = np.stack(lat_b.grid_history.history)
    np.testing.assert_array_equal(ha, hb)
    np.testing.assert_array_equal(np.asarray(lat_a.state["v"]),
                                  np.asarray(lat_b.state["v"]))

    # EEG history kind works through the same path
    from spiking_neural_networks_jax.core.history import EEGHistory
    lat_c, env_c = build()
    lat_c.grid_history = EEGHistory()
    env_c.run_with_reward(30)
    assert len(lat_c.grid_history.history) == 30


def test_jit_environment_unsupervised_grid_history():
    import numpy as np
    import jax.numpy as jnp
    import spiking_neural_networks_jax as snn
    from spiking_neural_networks_jax.interactable import JitEnvironment

    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(4, 4, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5, keep_prob=1.0, seed=4)
    lat.update_grid_history = True
    env = JitEnvironment(
        lat, {"t": jnp.float32(0.0)},
        lambda e, s: {**s, "v": s["v"].at[:3].set(31.0)},
        None, lambda e, s: {"t": e["t"] + 1.0})
    env.run(40)
    assert len(lat.grid_history.history) == 40


def _poly_callbacks(cue=6, target=TARGET):
    """Closed-loop callbacks on the flat (N,) state: a reward tracking the
    mean spike rate and an encoder clamping the first ``cue`` neurons."""
    def reward_fn(env, s):
        return jnp.float32(target) - env["rate"]

    def update_fn(env, s):
        spiking = s["is_spiking"].astype(jnp.float32).mean()
        return {"rate": jnp.float32(0.9) * env["rate"]
                + jnp.float32(0.1) * spiking}

    def encoder_fn(env, s):
        fi = jax.lax.iota(jnp.int32, s["v"].shape[0])
        return {**s, "v": jnp.where(fi < cue, jnp.float32(40.0), s["v"])}

    return encoder_fn, reward_fn, update_fn


class _RateState:
    """Host-loop environment state mirroring `_poly_callbacks`."""

    def __init__(self):
        self.rate = np.float32(0.0)

    def update_state(self, agent):
        spiking = np.float32(np.asarray(
            agent.state["is_spiking"], np.float32).mean())
        self.rate = np.float32(0.9) * self.rate + np.float32(0.1) * spiking


def _lif_agent():
    lat = snn.RewardModulatedLattice(snn.LeakyIntegrateAndFire())
    lat.populate(8, 8, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=2)
    v0 = np.random.default_rng(0).uniform(-60.0, -20.0, 64)
    lat.apply(lambda s: {**s, "v": jnp.asarray(v0, jnp.float32)})
    return lat


@pytest.mark.parametrize("make_agent,steps,cue", [
    (_agent, 75, 6), (_agent, 11, 6), (_lif_agent, 30, 6)],
    ids=["izhikevich-75", "izhikevich-11", "lif-30"])
def test_jit_environment_reward_loop_matches_host(make_agent, steps, cue):
    """The on-device closed loop (one scan per episode) against the host
    `Environment` loop, which steps the agent one `update_and_apply_reward`
    at a time: rewards, state, weights, traces and env state agree."""
    enc, rew, upd = _poly_callbacks(cue=cue)
    host = make_agent()
    host_state = _RateState()

    def host_encoder(state, agent):
        agent.state = dict(enc(None, agent.state))

    rewards_host = []

    def host_reward(state, agent):
        r = float(np.float32(TARGET) - state.rate)
        rewards_host.append(r)
        return r

    Environment(host, host_state, host_encoder,
                host_reward).run_with_reward(steps)

    agent = make_agent()
    env = JitEnvironment(agent, {"rate": jnp.float32(0.0)}, enc, rew, upd)
    rewards = env.run_with_reward(steps)

    np.testing.assert_allclose(rewards, rewards_host, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(agent.state["v"]),
                               np.asarray(host.state["v"]),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_array_equal(
        np.asarray(agent.state["last_firing_time"]),
        np.asarray(host.state["last_firing_time"]))
    np.testing.assert_allclose(np.asarray(agent.graph.weights),
                               np.asarray(host.graph.weights),
                               rtol=2e-4, atol=2e-4)
    for k in ("c", "dw"):
        np.testing.assert_allclose(np.asarray(agent.trace[k]),
                                   np.asarray(host.trace[k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    np.testing.assert_allclose(float(env.state["rate"]), host_state.rate,
                               rtol=1e-4, atol=1e-6)
    assert agent.internal_clock == steps
    # non-vacuous: the cue made the lattice spike
    assert (np.asarray(agent.state["last_firing_time"]) >= 0).any()


def test_jit_environment_unsupervised_stdp_matches_host():
    """Unsupervised `JitEnvironment.run` on a plain STDP lattice against
    the host `UnsupervisedEnvironment` loop."""
    from spiking_neural_networks_jax.interactable import (
        UnsupervisedEnvironment)

    def make():
        lat = snn.Lattice(snn.Izhikevich())
        lat.populate(8, 8, gap_conductance=10.0)
        lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=4)
        lat.do_plasticity = True
        v0 = np.random.default_rng(1).uniform(-65.0, 30.0, 64) \
            .astype(np.float32)
        lft = np.full(64, -1, np.int32)
        lft[::2] = 3
        lat.apply(lambda s: {**s, "v": jnp.asarray(v0),
                             "last_firing_time": jnp.asarray(lft)})
        return lat

    enc, _, upd = _poly_callbacks(cue=5)
    host = make()
    host_state = _RateState()

    def host_encoder(state, agent):
        agent.state = dict(enc(None, agent.state))

    UnsupervisedEnvironment(host, host_state, host_encoder).run(11)
    lat = make()
    env = JitEnvironment(lat, {"rate": jnp.float32(0.0)}, enc, None, upd)
    env.run(11)
    np.testing.assert_allclose(np.asarray(lat.state["v"]),
                               np.asarray(host.state["v"]),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_array_equal(
        np.asarray(lat.state["last_firing_time"]),
        np.asarray(host.state["last_firing_time"]))
    np.testing.assert_allclose(np.asarray(lat.graph.weights),
                               np.asarray(host.graph.weights),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(env.state["rate"]), host_state.rate,
                               rtol=1e-4, atol=1e-6)
    assert lat.internal_clock == 11


def test_jit_environment_missing_field_raises():
    """A LIF agent has no "w" state: a callback reading it raises KeyError
    at trace time rather than reading some substitute plane."""
    _, _, upd = _poly_callbacks()
    enc, _, _ = _poly_callbacks()
    env = JitEnvironment(_lif_agent(), {"rate": jnp.float32(0.0)}, enc,
                         lambda e, s: s["w"].mean(), upd)
    with pytest.raises(KeyError):
        env.run_with_reward(3)
