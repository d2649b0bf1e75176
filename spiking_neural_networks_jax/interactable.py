"""Agent / State / Environment wrappers for reward-driven simulation.

JAX rebuild of `reference/backend/src/interactable/mod.rs`.
`RewardModulatedLattice` implements the Agent protocol
(`update_and_apply_reward` / `update`); `Lattice` / `LatticeNetwork`
implement the unsupervised protocol (`update == run 1 step`).
"""

from __future__ import annotations


def _agent_history_chunk(agent):
    """Resolved history chunk for a JitEnvironment agent
    (core/history.resolve_history_chunk; None = auto)."""
    from .core.history import history_step_bytes, resolve_history_chunk
    bps = 0
    if agent.update_grid_history:
        bps += history_step_bytes(agent.grid_history.kind, agent.n)
    if getattr(agent, "update_graph_history", False):
        bps += 4 * int(agent.graph.weights.size)
    return resolve_history_chunk(agent.history_chunk, bps)


class Environment:
    """`Environment` (interactable/mod.rs:21-60): agent + state + encoders.

    - ``state_encoder(state, agent)``: writes the environment state into the
      agent (e.g. sets spike-train rates / input currents).
    - ``reward_function(state, agent) -> float``: computes the reward.
    """

    def __init__(self, agent, state, state_encoder, reward_function=None):
        self.agent = agent
        self.state = state
        self.state_encoder = state_encoder
        self.reward_function = reward_function

    def run_with_reward(self, iterations):
        """`Environment::run_with_reward` (interactable/mod.rs:33-46)."""
        if self.reward_function is None:
            raise ValueError("run_with_reward requires a reward_function")
        for _ in range(iterations):
            reward = self.reward_function(self.state, self.agent)
            self.agent.update_and_apply_reward(reward)
            self.state.update_state(self.agent)
            self.state_encoder(self.state, self.agent)

    def run(self, iterations):
        """`Environment::run` (interactable/mod.rs:48-59)."""
        for _ in range(iterations):
            self.agent.update()
            self.state.update_state(self.agent)
            self.state_encoder(self.state, self.agent)


# Unsupervised variant (interactable/mod.rs:63-97): same loop without reward.
class UnsupervisedEnvironment(Environment):
    def __init__(self, agent, state, state_encoder):
        super().__init__(agent, state, state_encoder, reward_function=None)


class JitEnvironment:
    """Fully on-device closed loop: the reference's `run_with_reward`
    iteration (interactable/mod.rs:33-46) fused into ONE `lax.scan`.

    The host :class:`Environment` dispatches a device program per step.
    Here the environment state is a pytree of arrays and the three callbacks are
    PURE jax functions, so a whole episode compiles into a single device
    program (same design as the lattice runners):

    - ``reward_function(env_state, agent_state) -> f32 scalar``
    - ``update_state(env_state, agent_state) -> env_state``
    - ``state_encoder(env_state, agent_state) -> agent_state`` (write
      cues/drive into agent fields, e.g. ``state["v"]`` overrides)

    Per-step order matches the reference exactly: reward -> agent update
    (R-STDP double visit) -> state update -> encoder.  The agent must be a
    :class:`~.core.reward.RewardModulatedLattice`."""

    def __init__(self, agent, state, state_encoder, reward_function,
                 update_state):
        self.agent = agent
        self.state = state
        self.state_encoder = state_encoder
        self.reward_function = reward_function
        self.update_state = update_state
        # (iterations, flags, callbacks) -> jitted scan.  A small bounded
        # cache, not a single slot: history chunking builds TWO runners
        # per call (the chunk-length one and the tail-length one), and a
        # single slot would evict and rebuild both on every call; the
        # bound keeps variable-length episode sweeps from accumulating
        # compiled whole-episode executables without limit.
        self._runners = {}
        self._runners_max = 8

    def _build(self, iterations, skip_nt, hist_sig):
        import functools
        import jax
        import jax.numpy as jnp
        from .core.reward import reward_lattice_step
        from .core.lattice import resolve_unroll

        agent = self.agent
        model = agent.model
        electrical = agent.electrical_synapse
        chemical = agent.chemical_synapse
        do_modulation = agent.do_modulation
        unroll = resolve_unroll(agent.scan_unroll)
        readout, shape = self._readout(hist_sig)

        def one_step(pparams, carry, _):
            s, graph, trace, dopamine, clock, env = carry
            reward = self.reward_function(env, s)
            s, graph, trace, dopamine, clock = reward_lattice_step(
                model, electrical, chemical, do_modulation, True, skip_nt,
                pparams, s, graph, trace, dopamine, clock, reward)
            env = self.update_state(env, s)
            s = dict(self.state_encoder(env, s))
            ys = {"reward": reward}
            if readout is not None:
                ys["grid"] = readout.readout(s, shape)
            return (s, graph, trace, dopamine, clock, env), ys

        def run(state, graph, trace, dopamine, clock, env, pparams):
            step = functools.partial(one_step, pparams)
            carry, ys = jax.lax.scan(
                step, (state, graph, trace, dopamine, clock, env), None,
                length=iterations, unroll=unroll)
            return carry, ys

        return jax.jit(run, donate_argnums=(0, 1, 2, 5))

    def _cache(self, key, runner):
        """Insert into the bounded runner cache (FIFO eviction)."""
        if len(self._runners) >= self._runners_max:
            self._runners.pop(next(iter(self._runners)))
        self._runners[key] = runner
        return runner

    def _readout(self, hist_sig):
        """Rebuild the history readout object from its frozen signature
        (episodes stay ONE device program; the per-step readouts ride the
        scan ys and are drained to the host history after the run)."""
        if hist_sig is None:
            return None, None
        from .core.history import HISTORY_KINDS
        cls = HISTORY_KINDS[hist_sig[0]]
        h = cls(*hist_sig[1:]) if len(hist_sig) > 1 else cls()
        return h, (self.agent.rows, self.agent.cols)

    def _hist_sig(self):
        agent = self.agent
        if getattr(agent, "update_graph_history", False):
            raise ValueError(
                "JitEnvironment does not record graph (weight) histories; "
                "use the host-loop Environment for those")
        if getattr(agent, "update_grid_history", False):
            from .core.lattice import _freeze
            return _freeze(agent.grid_history)
        return None

    def run_with_reward(self, iterations):
        """Run `iterations` fused closed-loop steps; returns the per-step
        reward trace (host array).  Grid/EEG histories are recorded when
        ``agent.update_grid_history`` is set (chunked like the lattice
        runners)."""
        import numpy as np
        import jax
        import jax.numpy as jnp
        agent = self.agent
        from .utils.transfer import ensure_device_state
        agent.state = ensure_device_state(agent.state)  # lazy-populate ship
        hist_sig = self._hist_sig()
        skip_nt = not bool(jnp.any(agent.state["nt$mask"]))
        chunk = _agent_history_chunk(agent) if hist_sig is not None \
            else int(iterations)
        rewards_all = []
        remaining = int(iterations)
        while remaining > 0:
            length = min(remaining, chunk)
            # the callback OBJECTS are part of the cache key (not their
            # id()s, which CPython can reuse after GC): a swapped reward/
            # encoder function must retrace, not reuse stale traced code
            key = (length, skip_nt, agent.electrical_synapse,
                   agent.chemical_synapse, agent.do_modulation, hist_sig,
                   (agent.rows, agent.cols),
                   getattr(agent.graph, "offsets", None),
                   self.reward_function, self.update_state,
                   self.state_encoder,
                   jax.tree_util.tree_structure(self.state))
            runner = self._runners.get(key)
            if runner is None:
                runner = self._cache(key, self._build(
                    length, skip_nt, hist_sig))
            pparams = {k: jnp.float32(v)
                       for k, v in agent.reward_modulator.params.items()}
            carry, ys = runner(
                agent.state, agent.graph, agent.trace,
                jnp.float32(agent.dopamine), jnp.int32(agent.internal_clock),
                self.state, pparams)
            s, graph, trace, dopamine, clock, env = carry
            agent.state, agent.graph, agent.trace = s, graph, trace
            self.state = env
            # one batched host pull for the scalars and traces
            pulls = [dopamine, clock, ys["reward"]]
            if hist_sig is not None:
                pulls.append(ys["grid"])
            got = jax.device_get(pulls)
            agent.dopamine = float(got[0])
            agent.internal_clock = int(got[1])
            rewards_all.append(np.asarray(got[2]))
            if hist_sig is not None:
                agent.grid_history.extend(got[3])
            remaining -= length
        if not rewards_all:
            return np.zeros((0,), np.float32)
        return np.concatenate(rewards_all)

    # -- unsupervised fused loop (Environment::run, interactable/
    #    mod.rs:48-59): agent is a plain Lattice, no reward ----------------
    def _build_unsupervised(self, iterations, skip_nt, hist_sig):
        import functools
        import jax
        import jax.numpy as jnp
        from .core.lattice import lattice_step, resolve_unroll

        agent = self.agent
        model = agent.model
        electrical = agent.electrical_synapse
        chemical = agent.chemical_synapse
        do_plasticity = bool(agent.do_plasticity)
        plasticity = agent.plasticity
        unroll = resolve_unroll(agent.scan_unroll)
        readout, shape = self._readout(hist_sig)

        def one_step(pparams, carry, _):
            s, graph, clock, env = carry
            s, graph, clock = lattice_step(
                model, electrical, chemical, do_plasticity, skip_nt,
                plasticity, pparams, s, graph, clock)
            env = self.update_state(env, s)
            s = dict(self.state_encoder(env, s))
            ys = {} if readout is None else {"grid": readout.readout(s,
                                                                     shape)}
            return (s, graph, clock, env), ys

        def run(state, graph, clock, env, pparams):
            step = functools.partial(one_step, pparams)
            carry, ys = jax.lax.scan(
                step, (state, graph, clock, env), None, length=iterations,
                unroll=unroll)
            return carry, ys

        return jax.jit(run, donate_argnums=(0, 1, 3))

    def run(self, iterations):
        """Unsupervised fused loop: agent step -> state update -> encoder
        per step, one device program; agent is a plain :class:`Lattice`.
        Grid/EEG histories are recorded when set (chunked)."""
        import jax
        import jax.numpy as jnp
        agent = self.agent
        from .utils.transfer import ensure_device_state
        agent.state = ensure_device_state(agent.state)  # lazy-populate ship
        hist_sig = self._hist_sig()
        skip_nt = not bool(jnp.any(agent.state["nt$mask"]))
        chunk = _agent_history_chunk(agent) if hist_sig is not None \
            else int(iterations)
        remaining = int(iterations)
        while remaining > 0:
            length = min(remaining, chunk)
            key = ("unsup", length, skip_nt, agent.electrical_synapse,
                   agent.chemical_synapse, bool(agent.do_plasticity),
                   hist_sig, (agent.rows, agent.cols),
                   getattr(agent.graph, "offsets", None),
                   self.update_state, self.state_encoder,
                   jax.tree_util.tree_structure(self.state))
            runner = self._runners.get(key)
            if runner is None:
                runner = self._cache(key, self._build_unsupervised(
                    length, skip_nt, hist_sig))
            pparams = {k: jnp.float32(v)
                       for k, v in agent.plasticity.params.items()}
            (s, graph, clock, env), ys = runner(
                agent.state, agent.graph, jnp.int32(agent.internal_clock),
                self.state, pparams)
            agent.state, agent.graph = s, graph
            self.state = env
            pulls = [clock] + ([ys["grid"]] if hist_sig is not None else [])
            got = jax.device_get(pulls)
            agent.internal_clock = int(got[0])
            if hist_sig is not None:
                agent.grid_history.extend(got[1])
            remaining -= length
