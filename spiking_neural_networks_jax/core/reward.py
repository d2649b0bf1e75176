"""Reward-modulated (R-STDP) lattice runtime.

JAX rebuild of `RewardModulatedLattice`
(`reference/backend/src/neuron/mod.rs:2719-3415`).  Edge weights carry
eligibility-trace state (`TraceRSTDP`, plasticity/mod.rs:122-150): per-edge
arrays ``c`` (trace), ``dw`` (accumulator) and ``counter`` (visit parity),
shaped like the graph's weight array for every backend.

Visit semantics: the reference's reward modulator `do_update` is always true
(plasticity/mod.rs:239-241), so during a step *every* neuron triggers an
update of its incoming and outgoing edges — each intra-lattice edge is
visited exactly twice per step (once per endpoint), each spike-train-sourced
edge once.  Note the visit-parity consequence: a once-visited edge commits
its accumulated `dw` into the trace `c` only every SECOND step (its counter
alternates 1, 0, 1, ... across steps), exactly as in the reference.  `RewardModulatedSTDP::update_weight` (plasticity/mod.rs:208-237)
is applied per visit:

    dw += stdp_delta
    if counter == 0: counter = 1
    else:            c = c * exp(-dt/tau_c) + tau_c * dw ; counter = 0 ; dw = 0
    weight += c * dopamine

The dopamine scalar decays with the reward before the sweep
(`update`, :204-206).  As with STDP, we use the deferred (post-step) firing
times for all visits; the delta depends only on last-firing-times so the
vectorization is order-independent.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..models.base import NEVER, get_neurotransmitter_concentrations
from ..ops.graph import (SparseGraph, connect_dense, dense_to_stencil,
                         radius_offsets, StencilGraph)
from .history import GridVoltageHistory
from .lattice import removed_setting, resolve_unroll, _freeze
from .plasticity import RewardModulatedSTDP


def rstdp_visit(w, c, dw, counter, delta, dopamine, p):
    """One vectorized visit of `RewardModulatedSTDP::update_weight`."""
    dw = dw + delta
    apply_trace = counter != 0
    c = jnp.where(apply_trace,
                  c * jnp.exp(-p["dt"] / p["tau_c"]) + p["tau_c"] * dw, c)
    dw = jnp.where(apply_trace, 0.0, dw)
    counter = jnp.where(apply_trace, 0, 1).astype(counter.dtype)
    w = w + c * dopamine
    return w, c, dw, counter


def stdp_delta_arrays(lft_pre, lft_post, p):
    both = jnp.logical_and(lft_pre != NEVER, lft_post != NEVER)
    diff = jnp.abs((lft_pre - lft_post).astype(jnp.float32)) * p["dt"]
    # one exp of the selected argument (bitwise identical; see
    # core/plasticity.STDP.edge_delta)
    pre_first = lft_pre < lft_post
    e = jnp.exp(jnp.where(pre_first, -diff / p["tau_plus"],
                          -diff / p["tau_minus"]))
    dw = jnp.where(pre_first, p["a_plus"] * e,
                   jnp.where(lft_pre > lft_post, -p["a_minus"] * e, 0.0))
    return jnp.where(both, dw, 0.0)


class RewardModulatedLattice:
    """Lattice whose weights are dopamine-modulated eligibility traces.

    API mirrors `RewardModulatedLattice` (populate/connect/apply/
    run_lattice_with_reward, neuron/mod.rs:2814-3415); implements the `Agent`
    trait via :meth:`update_and_apply_reward` / :meth:`update`.
    """

    use_pallas = removed_setting(
        "use_pallas", "networks and reward-modulated lattices run on the "
        "XLA path, with no fused kernel to choose")

    def __init__(self, model, id=0):
        self.model = model
        self.id = id
        self.state = None
        self.graph = None
        self.trace = None  # dict(c, dw, counter) shaped like graph.weights
        self.rows = self.cols = 0
        self.electrical_synapse = True
        self.chemical_synapse = False
        self.do_modulation = True
        self.do_plasticity = False  # (STDP never applies; modulation does)
        self.reward_modulator = RewardModulatedSTDP()
        self.dopamine = 0.0
        self.update_grid_history = False
        self.grid_history = GridVoltageHistory()
        self.update_graph_history = False
        self.graph_history = []
        self.internal_clock = 0
        self.key = jax.random.PRNGKey(0)
        self.history_chunk = None  # None = auto (core/history)
        self.in_network = False
        self.scan_unroll = None  # step-loop unroll (None=auto; see Lattice)

    @property
    def n(self):
        return self.rows * self.cols

    def populate(self, rows, cols, **overrides):
        """Host-lazy like `Lattice.populate`: state stays NumPy until a run
        entry point ships it (one batched transfer per run call)."""
        if self.in_network and (rows, cols) != (self.rows, self.cols):
            raise ValueError("dimensions must match when lattice is in a network")
        self.rows, self.cols = rows, cols
        from ..utils.transfer import host_state_view
        self.state = host_state_view(
            self.model.init_state_host(rows * cols, **overrides))
        self.graph = SparseGraph.empty(self.n)
        self._reset_trace()

    def _reset_trace(self):
        shape = self.graph.weights.shape
        self.trace = dict(c=jnp.zeros(shape, jnp.float32),
                          dw=jnp.zeros(shape, jnp.float32),
                          counter=jnp.zeros(shape, jnp.int32))

    def connect(self, connecting_conditional, weight_logic=None):
        # R-STDP carries THREE trace planes shaped like the weights, so the
        # dense layout moves 4x (N, N) per step (measured 1.3ms/step at
        # 64x64 vs 27us as a stencil).  Radius-style predicates decompose
        # into offset planes; wide-support graphs stay dense (matvec).
        # connect_auto decomposes host-side and ships ONCE.
        from ..ops.graph import connect_auto
        self.graph = connect_auto(self.rows, self.cols,
                                  connecting_conditional, weight_logic)
        self._reset_trace()

    def connect_stencil(self, radius=None, offsets=None, weight_fn=None,
                        keep_prob=1.0, seed=0):
        if offsets is None:
            offsets = radius_offsets(radius)
        self.graph = StencilGraph.build(self.rows, self.cols, offsets,
                                        weight_fn=weight_fn,
                                        keep_prob=keep_prob, seed=seed)
        self._reset_trace()

    def apply(self, fn):
        self.state = dict(fn(dict(self.state)))

    def shard(self, mesh, axis="tp"):
        """Row-block shard state + graph + trace planes over a mesh."""
        from ..parallel.lattice_sharding import shard_lattice
        return shard_lattice(self, mesh, axis)

    # -- per-edge graph access (Graph trait, graph/mod.rs:42-72) -------------
    def _flat(self, pos):
        from ..errors import GraphError
        r, c = pos
        if not (0 <= r < self.rows and 0 <= c < self.cols):
            raise GraphError(f"position {pos} not in lattice")
        return r * self.cols + c

    def lookup_weight(self, presynaptic, postsynaptic):
        return self.graph.lookup_weight(self._flat(presynaptic),
                                        self._flat(postsynaptic))

    def edit_weight(self, presynaptic, postsynaptic, weight):
        """Edit one synapse, carrying the eligibility traces with it.

        Stencil/dense layouts are positional: grown structure (a new
        stencil offset plane) is zero-padded at the end.  A COO SparseGraph
        re-sorts its edge list on edit, so traces are REMAPPED by (src,
        dst) pair — removed edges drop their trace, added edges start at
        zero (the positional zero-pad used before silently attached every
        trace to the wrong synapse after a re-sort)."""
        old_graph = self.graph
        self.graph = self.graph.edit_weight(self._flat(presynaptic),
                                            self._flat(postsynaptic), weight)
        if self.trace is None:
            return
        if isinstance(self.graph, SparseGraph):
            old_pos = {}
            if isinstance(old_graph, SparseGraph):
                old_src = np.asarray(old_graph.src)
                old_dst = np.asarray(old_graph.dst)
                old_pos = {(int(s), int(d)): k
                           for k, (s, d) in enumerate(zip(old_src, old_dst))}
            new_src = np.asarray(self.graph.src)
            new_dst = np.asarray(self.graph.dst)
            new = {}
            for key, v in self.trace.items():
                host = np.asarray(v)
                out = np.zeros(len(new_src), host.dtype)
                for k, (s, d) in enumerate(zip(new_src, new_dst)):
                    idx = old_pos.get((int(s), int(d)))
                    if idx is not None and idx < len(host):
                        out[k] = host[idx]
                new[key] = jnp.asarray(out)
            self.trace = new
            return
        shape = self.graph.weights.shape
        if self.trace["c"].shape != shape:
            new = {}
            for k, v in self.trace.items():
                grown = jnp.zeros(shape, v.dtype)
                grown = grown.at[tuple(slice(0, s) for s in v.shape)].set(v)
                new[k] = grown
            self.trace = new

    def get_incoming_connections(self, pos):
        flat = self.graph.get_incoming_connections(self._flat(pos))
        return {(i // self.cols, i % self.cols) for i in flat}

    def get_outgoing_connections(self, pos):
        flat = self.graph.get_outgoing_connections(self._flat(pos))
        return {(i // self.cols, i % self.cols) for i in flat}

    def set_dt(self, dt):
        from ..utils.transfer import full_like
        self.state["dt"] = full_like(self.state["dt"], dt)
        self.reward_modulator.set_dt(dt)

    def reset_timing(self):
        self.internal_clock = 0
        from ..utils.transfer import full_like
        self.state["last_firing_time"] = full_like(
            self.state["last_firing_time"], NEVER)

    # -- Agent trait (neuron/mod.rs:3395-3415) ---------------------------------
    def update_and_apply_reward(self, reward):
        self.run_lattice_with_reward(reward, 1)

    def update(self):
        self.run_lattice(1)

    # -- simulation -------------------------------------------------------------
    def run_lattice_with_reward(self, reward, iterations=1):
        """Iterate with a reward signal each step.  ``reward`` may be a
        scalar (constant) or a length-``iterations`` array (schedule)."""
        rewards = jnp.broadcast_to(
            jnp.asarray(reward, jnp.float32), (iterations,))
        self._run(rewards, with_reward=True)

    def run_lattice(self, iterations):
        """Iterate without updating dopamine (modulation still applies with
        the stale dopamine value, matching the `without_reward` variants)."""
        self._run(jnp.zeros((iterations,), jnp.float32), with_reward=False)

    def _run(self, rewards, with_reward):
        if not self.electrical_synapse and not self.chemical_synapse:
            return
        iterations = int(rewards.shape[0])
        if iterations == 0:
            return
        from ..utils.transfer import ensure_device_state
        self.state = ensure_device_state(self.state)  # lazy-populate ship
        # chunk history runs like Lattice.run_lattice — an unchunked
        # update_graph_history scan would stack per-step full weight
        # arrays for the whole run on device
        any_hist = self.update_grid_history or self.update_graph_history
        from .history import history_step_bytes, resolve_history_chunk
        hchunk = resolve_history_chunk(
            self.history_chunk,
            (history_step_bytes(self.grid_history.kind, self.n)
             if self.update_grid_history else 0)
            + (4 * int(self.graph.weights.size)
               if self.update_graph_history else 0))
        if any_hist and iterations > hchunk:
            off = 0
            while off < iterations:
                length = min(hchunk, iterations - off)
                self._run(rewards[off:off + length], with_reward)
                off += length
            return
        runner = _build_reward_runner(
            self.model, type(self.graph), self.electrical_synapse,
            self.chemical_synapse, self.do_modulation, with_reward,
            self.update_grid_history,
            _freeze(self.grid_history) if self.update_grid_history else None,
            (self.rows, self.cols),
            not bool(jnp.any(self.state["nt$mask"])),
            int(iterations), self.update_graph_history,
            resolve_unroll(self.scan_unroll))
        pparams = {k: jnp.float32(v)
                   for k, v in self.reward_modulator.params.items()}
        state, graph, trace, dopamine, key, clock, ys = runner(
            self.state, self.graph, self.trace, jnp.float32(self.dopamine),
            self.key, jnp.int32(self.internal_clock), rewards, pparams)
        self.state, self.graph, self.trace, self.key = state, graph, trace, key
        self.dopamine = float(dopamine)
        self.internal_clock += iterations
        if self.update_grid_history:
            self.grid_history.extend(ys["grid"])
        if self.update_graph_history:
            self.graph_history.extend(np.asarray(ys["__weights__"]))

    def voltages(self):
        return np.asarray(self.state["v"]).reshape(self.rows, self.cols)


def reward_lattice_step(model, electrical, chemical, do_modulation,
                        with_reward, skip_nt, pparams, state, graph, trace,
                        dopamine, clock, reward):
    """One reward-modulated lattice step (`update_and_apply_reward`,
    interactable/mod.rs:7-12 + the R-STDP double visit,
    plasticity/mod.rs:199-242).  Pure; shared by the standalone reward
    runner and the fused on-device environment loop (interactable.py)."""
    if electrical:
        sub_v = jnp.ones_like(state["v"])
        elec = graph.gather_electrical(
            state["v"], sub_v, state["v"], state["gap_conductance"])
    else:
        elec = jnp.zeros_like(state["v"])

    if with_reward:
        # reward_modulator.update(reward) before iterating
        dopamine = dopamine * jnp.exp(-pparams["dt"] / pparams["tau_d"]) \
            + pparams["tau_d"] * reward

    if chemical:
        t, mask = get_neurotransmitter_concentrations(state)
        t_in, t_valid = graph.gather_chemical(t, mask.astype(jnp.float32))
        state, spikes = model.step(state, elec, t_in, t_valid,
                                   skip_nt=skip_nt)
    else:
        state, spikes = model.step(state, elec, skip_nt=skip_nt)

    state["last_firing_time"] = jnp.where(
        spikes, clock, state["last_firing_time"])

    if do_modulation:
        # every edge visited twice per step (both endpoints trigger,
        # do_update always true — plasticity/mod.rs:239-241)
        vals = {"last_firing_time": state["last_firing_time"]}
        pre, post = graph.edge_pre_post(vals, vals)
        delta = stdp_delta_arrays(pre["last_firing_time"],
                                  post["last_firing_time"], pparams)
        w0 = graph.weights
        w, c, dw, ct = rstdp_visit(
            w0, trace["c"], trace["dw"], trace["counter"], delta,
            dopamine, pparams)
        w, c, dw, ct = rstdp_visit(w, c, dw, ct, delta, dopamine, pparams)
        m = graph.edge_mask
        graph = graph.replace_weights(jnp.where(m, w, w0))
        trace = dict(c=jnp.where(m, c, trace["c"]),
                     dw=jnp.where(m, dw, trace["dw"]),
                     counter=jnp.where(m, ct, trace["counter"]))

    return state, graph, trace, dopamine, clock + 1


@functools.lru_cache(maxsize=None)
def _build_reward_runner(model, graph_cls, electrical, chemical,
                         do_modulation, with_reward, grid_history, hist_sig,
                         shape, skip_nt, length, graph_history=False,
                         unroll=1):
    from .history import HISTORY_KINDS
    readout = None
    if grid_history:
        cls = HISTORY_KINDS[hist_sig[0]]
        readout = cls(*hist_sig[1:]) if len(hist_sig) > 1 else cls()

    def one_step(pparams, carry, reward):
        state, graph, trace, dopamine, key, clock = carry
        state, graph, trace, dopamine, clock = reward_lattice_step(
            model, electrical, chemical, do_modulation, with_reward, skip_nt,
            pparams, state, graph, trace, dopamine, clock, reward)
        ys = {}
        if readout is not None:
            ys["grid"] = readout.readout(state, shape)
        if graph_history:
            ys["__weights__"] = graph.weights
        return (state, graph, trace, dopamine, key, clock), ys

    def run(state, graph, trace, dopamine, key, clock, rewards, pparams):
        step = functools.partial(one_step, pparams)
        (state, graph, trace, dopamine, key, clock), ys = jax.lax.scan(
            step, (state, graph, trace, dopamine, key, clock), rewards,
            unroll=unroll)
        return state, graph, trace, dopamine, key, clock, ys

    return jax.jit(run, donate_argnums=(0, 1, 2))
