"""Reward-modulated lattice network: mixed plain / reward-modulated lattices.

JAX rebuild of `RewardModulatedLatticeNetwork`
(`reference/backend/src/neuron/mod.rs:3455-5455`): ordinary lattices
(STDP-style plasticity), reward-modulated lattices (R-STDP trace weights),
and spike-train lattices, with a connecting graph whose edges are either
plain weights or trace-carrying reward-modulated weights
(`RewardModulatedConnection`, neuron/mod.rs:3419-3432).

Flattening follows `core/network.py`: one global node space, one edge list.
Each edge carries (w, c, dw, counter) plus a static ``modulated`` flag
(intra edges of reward lattices + reward connections).  Per step:

* **modulated edges** receive 0-2 R-STDP visits: one per endpoint in a
  reward lattice with ``do_modulation`` (every step — the modulator's
  `do_update` is always true, plasticity/mod.rs:239-241) plus one per
  SPIKING endpoint in a plain lattice with ``do_plasticity``
  (mod.rs:4742-4762); spike trains never trigger;
* **plain edges** receive STDP visits: one per spiking plastic endpoint,
  plus the reward sweep's every-step visit when one endpoint is modulated
  and the other is a plain lattice (mod.rs:4868-4898, 4928-4947).

The shared dopamine scalar decays with the reward before the visits
(plasticity/mod.rs:204-206).  The structure-preserving runner
(`core/reward_structured.py`) is the default; this flat COO path is the
fallback (connecting-graph history) and the equivalence oracle.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..models.base import get_neurotransmitter_concentrations
from ..models.spike_train import refractoriness_effect
from .lattice import _freeze, resolve_unroll
from .network import (LatticeNetwork, _edge_history_to_layout,
                      _graph_to_coo, _write_back_graph)
from .plasticity import STDP, RewardModulatedSTDP
from .reward import RewardModulatedLattice, rstdp_visit, stdp_delta_arrays


class RewardModulatedLatticeNetwork(LatticeNetwork):
    """`RewardModulatedLatticeNetwork` (neuron/mod.rs:3455+).

    API adds: ``add_reward_modulated_lattice``,
    ``connect_with_reward_modulation``, ``run_lattices_with_reward``;
    implements the `Agent` trait (update_and_apply_reward / update).
    """

    # the reward runtime operates on the COO edge list (trace state per edge)
    dense_gather = False

    def __init__(self):
        super().__init__()
        self.reward_modulated_lattices = {}
        # (pre, post) -> (src, dst, w, c, dw, counter) host arrays
        self.reward_connections = {}
        self.reward_modulator = RewardModulatedSTDP()
        self.dopamine = 0.0

    def _check_id(self, id):
        if id in self.reward_modulated_lattices:
            raise ValueError(f"id {id} already present in network")
        super()._check_id(id)

    def add_lattice(self, lattice):
        if isinstance(lattice, RewardModulatedLattice):
            return self.add_reward_modulated_lattice(lattice)
        super().add_lattice(lattice)

    def add_reward_modulated_lattice(self, lattice):
        self._check_id(lattice.id)
        ref = (list(self.lattices.values())
               + list(self.reward_modulated_lattices.values()))
        if ref and ref[0].model != lattice.model:
            raise ValueError("all lattices must share one neuron model config")
        lattice.in_network = True
        self.reward_modulated_lattices[lattice.id] = lattice
        self._conn_version += 1

    def get_reward_modulated_lattice(self, id):
        return self.reward_modulated_lattices[id]

    def _neuron_lattices(self):
        """All neuron-bearing lattices in a stable order."""
        out = dict(self.lattices)
        out.update(self.reward_modulated_lattices)
        return out

    def _ship_states(self):
        from ..utils.transfer import ship_states
        ship_states(list(self.lattices.values())
                    + list(self.reward_modulated_lattices.values())
                    + list(self.spike_train_lattices.values()))

    def connect(self, presynaptic_id, postsynaptic_id, connecting_conditional,
                weight_logic=None):
        """Plain connection; reward-modulated lattices are valid endpoints."""
        saved = self.lattices
        self.lattices = self._neuron_lattices()
        try:
            super().connect(presynaptic_id, postsynaptic_id,
                            connecting_conditional, weight_logic)
        finally:
            self.lattices = saved

    def connect_with_reward_modulation(self, presynaptic_id, postsynaptic_id,
                                       connecting_conditional,
                                       weight_logic=None):
        """`connect_with_reward_modulation` (neuron/mod.rs:4076+): edges carry
        fresh TraceRSTDP state."""
        all_lat = self._neuron_lattices()
        if postsynaptic_id not in all_lat:
            raise KeyError(f"unknown postsynaptic id {postsynaptic_id}")
        pre = all_lat.get(presynaptic_id) \
            or self.spike_train_lattices.get(presynaptic_id)
        if pre is None:
            raise KeyError(f"unknown presynaptic id {presynaptic_id}")
        post = all_lat[postsynaptic_id]
        from ..ops.graph import positions
        src, dst, w = [], [], []
        for i, p1 in enumerate(positions(pre.rows, pre.cols)):
            t1 = (int(p1[0]), int(p1[1]))
            for j, p2 in enumerate(positions(post.rows, post.cols)):
                t2 = (int(p2[0]), int(p2[1]))
                if connecting_conditional(t1, t2):
                    src.append(i)
                    dst.append(j)
                    w.append(1.0 if weight_logic is None
                             else weight_logic(t1, t2))
        n = len(w)
        self.reward_connections[(presynaptic_id, postsynaptic_id)] = (
            np.asarray(src, np.int64), np.asarray(dst, np.int64),
            np.asarray(w, np.float32), np.zeros(n, np.float32),
            np.zeros(n, np.float32), np.zeros(n, np.int32))
        self._conn_version += 1

    # -- Agent trait ------------------------------------------------------------
    def update_and_apply_reward(self, reward):
        self.run_lattices_with_reward(reward, 1)

    def update(self):
        self.run_lattices(1)

    # -- flattening ----------------------------------------------------------------
    def _compile(self):
        # temporarily expose reward-modulated lattices as ordinary lattices to
        # reuse the base flattening, then add trace state + visit counts.
        saved = self.lattices
        merged = self._neuron_lattices()
        self.lattices = merged
        try:
            plan = super()._compile()
        finally:
            self.lattices = saved

        n_edges_plain = plan["w"].shape[0]
        lat_ids = plan["lat_ids"]
        n_offset = plan["n_offset"]

        # per-node "reward-modulated trigger" flag (do_modulation, visits
        # every step — the modulator's do_update is always true)
        node_mod = np.zeros(plan["n_total"], np.float32)
        for i, lat in self.reward_modulated_lattices.items():
            if lat.do_modulation:
                node_mod[n_offset[i]:n_offset[i] + lat.n] = 1.0
        # per-node "lives in a PLAIN lattice" flag: the reward sweep applies
        # the plain lattice's plasticity to plain connecting edges whose
        # other endpoint is a plain lattice (mod.rs:4868-4898, 4928-4947),
        # ungated on that lattice's do_plasticity
        node_plain = np.zeros(plan["n_total"], np.float32)
        for i, lat in self.lattices.items():
            node_plain[n_offset[i]:n_offset[i] + lat.n] = 1.0

        # intra-lattice edges of reward-modulated lattices are themselves
        # trace-modulated; collect their trace state aligned with plan edges.
        # `modulated` marks the RewardModulatedWeight edges — ONLY these
        # receive R-STDP visits; plain Weight edges receive STDP
        # (mod.rs:4720-4760 match on the connection enum)
        c = np.zeros(n_edges_plain, np.float32)
        dwacc = np.zeros(n_edges_plain, np.float32)
        counter = np.zeros(n_edges_plain, np.int32)
        modulated = np.zeros(n_edges_plain, bool)
        offset = 0
        for entry in plan["provenance"]:
            kind, owner, count, prov, src, dst = entry
            if kind == "intra" and owner in self.reward_modulated_lattices:
                lat = self.reward_modulated_lattices[owner]
                modulated[offset:offset + count] = True
                if lat.trace is not None:
                    tw = _trace_to_edges(lat, src, dst)
                    c[offset:offset + count] = tw[0]
                    dwacc[offset:offset + count] = tw[1]
                    counter[offset:offset + count] = tw[2]
            offset += count

        # reward-modulated connecting edges appended at the end
        r_src, r_dst, r_w = [], [], []
        r_c, r_dw, r_ct = [], [], []
        r_prov = []
        for (pre_id, post_id), (src, dst, w, cc, dd, ct) in sorted(
                self.reward_connections.items()):
            base = n_offset.get(pre_id, plan["st_offset"].get(pre_id))
            r_src.append(src + base)
            r_dst.append(dst + n_offset[post_id])
            r_w.append(w)
            r_c.append(cc)
            r_dw.append(dd)
            r_ct.append(ct)
            r_prov.append(((pre_id, post_id), len(w), src, dst))

        src_host = np.asarray(plan["src"])
        dst_host = np.asarray(plan["dst"])
        if r_src:
            src_all = np.concatenate([src_host, np.concatenate(r_src)])
            dst_all = np.concatenate([dst_host, np.concatenate(r_dst)])
            w_all = np.concatenate([np.asarray(plan["w"]),
                                    np.concatenate(r_w)])
            c = np.concatenate([c, np.concatenate(r_c)])
            dwacc = np.concatenate([dwacc, np.concatenate(r_dw)])
            counter = np.concatenate([counter, np.concatenate(r_ct)])
            n_extra = len(w_all) - n_edges_plain
            plastic = np.concatenate([np.asarray(plan["plastic"]),
                                      np.zeros(n_extra, bool)])
            modulated = np.concatenate([modulated, np.ones(n_extra, bool)])
            in_deg = np.zeros(plan["n_neurons"], np.float32)
            np.add.at(in_deg, dst_all, 1.0)
            plan.update(src=jnp.asarray(src_all, jnp.int32),
                        dst=jnp.asarray(dst_all, jnp.int32),
                        w=jnp.asarray(w_all), plastic=jnp.asarray(plastic),
                        in_deg=jnp.asarray(in_deg))
            src_host, dst_host = src_all, dst_all

        plan["trace"] = dict(c=jnp.asarray(c), dw=jnp.asarray(dwacc),
                             counter=jnp.asarray(counter))
        plan["node_mod"] = jnp.asarray(node_mod)
        plan["node_plain"] = jnp.asarray(node_plain)
        plan["modulated"] = jnp.asarray(modulated)
        # static: does the reward sweep ever STDP a plain edge (modulated
        # endpoint on one side, plain lattice on the other)?
        cross = (node_mod[src_host] * node_plain[dst_host]
                 + node_mod[dst_host] * node_plain[src_host])
        plan["stdp_cross_any"] = bool(len(cross)
                                      and float(cross[~modulated].max(initial=0.0)) > 0)
        plan["r_provenance"] = r_prov
        plan["n_edges_plain"] = n_edges_plain
        return plan

    # -- simulation ----------------------------------------------------------------
    def run_lattices(self, iterations):
        self.run_lattices_with_reward(
            jnp.zeros((iterations,), jnp.float32), iterations,
            with_reward=False)

    def _structured_supported(self):
        return (type(self) is RewardModulatedLatticeNetwork
                and not self.update_connecting_graph_history
                and self._neuron_lattices())

    def run_lattices_with_reward(self, reward, iterations=1, with_reward=True):
        """`run_lattices_with_reward` (neuron/mod.rs): one dopamine update +
        full network step per iteration.  ``reward`` scalar or (iterations,)
        schedule."""
        if iterations == 0:
            return
        if not self.electrical_synapse and not self.chemical_synapse:
            return
        rewards = jnp.broadcast_to(jnp.asarray(reward, jnp.float32),
                                   (iterations,))
        self._ship_states()
        merged = self._neuron_lattices()
        any_hist = any(l.update_grid_history
                       or getattr(l, "update_graph_history", False)
                       for l in merged.values()) \
            or any(s.update_grid_history
                   for s in self.spike_train_lattices.values()) \
            or self.update_connecting_graph_history
        chunk = self._history_chunk() if any_hist else int(iterations)
        if self.structured and self._structured_supported():
            from .reward_structured import run_structured_reward
            off = 0
            while off < iterations:
                length = min(chunk, iterations - off)
                run_structured_reward(self, rewards[off:off + length],
                                      with_reward)
                off += length
            return
        plan = self._compile()
        off = 0
        while off < iterations:
            length = min(chunk, iterations - off)
            plan = self._run_reward_chunk(plan, rewards[off:off + length],
                                          with_reward)
            off += length
        self._write_back_reward(plan)

    def _run_reward_chunk(self, plan, rewards, with_reward):
        merged = self._neuron_lattices()
        neuron_model = next(iter(merged.values())).model
        st_model = (next(iter(self.spike_train_lattices.values())).model
                    if plan["st_ids"] else None)
        # STDP runs when a plain lattice has do_plasticity OR the reward
        # sweep reaches a plain edge (modulated endpoint x plain endpoint)
        do_plasticity = any(l.do_plasticity for l in self.lattices.values()) \
            or plan["stdp_cross_any"]
        plasticity = self._plasticity()
        skip_nt = not bool(jnp.any(plan["nstate"]["nt$mask"]))
        hist_sig = self._history_signature(plan)
        # per-lattice graph (weight) histories, incl. reward-modulated
        # lattices (mirrors network.py ghist wiring)
        ghist = []
        goffset = 0
        for entry in plan["provenance"]:
            kind_, owner_, count_, prov_, src_, dst_ = entry
            if kind_ == "intra" and getattr(
                    merged[owner_], "update_graph_history", False):
                ghist.append((owner_, goffset, count_))
            goffset += count_

        runner = _build_reward_network_runner(
            neuron_model, st_model, self.electrical_synapse,
            self.chemical_synapse, do_plasticity, type(plasticity),
            hist_sig, plan["n_neurons"], plan["n_total"], skip_nt,
            with_reward, int(rewards.shape[0]),
            self.update_connecting_graph_history,
            resolve_unroll(self.scan_unroll),
            tuple(ghist))

        pparams = {k: jnp.float32(v) for k, v in plasticity.params.items()}
        rparams = {k: jnp.float32(v)
                   for k, v in self.reward_modulator.params.items()}
        carry, ys = runner(
            plan["nstate"], plan["st_state"], plan["w"], plan["trace"],
            jnp.float32(self.dopamine), self.key,
            jnp.int32(self.internal_clock), rewards,
            dict(src=plan["src"], dst=plan["dst"],
                 node_plastic=plan["node_plastic"],
                 node_mod=plan["node_mod"], node_plain=plan["node_plain"],
                 modulated=plan["modulated"], in_deg=plan["in_deg"]),
            pparams, rparams)
        (plan["nstate"], plan["st_state"], plan["w"], plan["trace"],
         dopamine, self.key) = carry[:6]
        self.dopamine = float(dopamine)
        self.internal_clock += int(rewards.shape[0])

        for (key_id, kind, fsig, shape, off, n) in hist_sig:
            scope, i = key_id
            hist = (merged[i].grid_history if scope == "lat"
                    else self.spike_train_lattices[i].grid_history)
            hist.extend(ys[key_id])
        if self.update_connecting_graph_history:
            self.connecting_graph_history.extend(np.asarray(ys[("__w__", -1)]))
        for (i, start, count) in ghist:
            lat = merged[i]
            for entry in plan["provenance"]:
                if entry[0] == "intra" and entry[1] == i:
                    _, _, _, prov_, src_, dst_ = entry
                    break
            lat.graph_history.extend(_edge_history_to_layout(
                lat.graph, prov_, src_, dst_, np.asarray(ys[("gw", i)])))
        return plan

    def _history_signature(self, plan):
        saved = self.lattices
        self.lattices = self._neuron_lattices()
        try:
            return super()._history_signature(plan)
        finally:
            self.lattices = saved

    def _write_back_reward(self, plan):
        saved = self.lattices
        merged = self._neuron_lattices()
        self.lattices = merged
        try:
            # base write-back handles states + plain/intra weights (trims the
            # appended reward edges first)
            w_np = np.asarray(plan["w"])
            trimmed = dict(plan)
            trimmed["w"] = w_np[: plan["n_edges_plain"]]
            self._write_back(trimmed)
        finally:
            self.lattices = saved

        c = np.asarray(plan["trace"]["c"])
        dw = np.asarray(plan["trace"]["dw"])
        ct = np.asarray(plan["trace"]["counter"])
        # intra traces back into reward-modulated lattices
        offset = 0
        for entry in plan["provenance"]:
            kind, owner, count, prov, src, dst = entry
            if kind == "intra" and owner in self.reward_modulated_lattices:
                lat = self.reward_modulated_lattices[owner]
                _edges_to_trace(lat, src, dst,
                                c[offset:offset + count],
                                dw[offset:offset + count],
                                ct[offset:offset + count])
                lat.dopamine = self.dopamine
            offset += count
        # appended reward connections
        pos = plan["n_edges_plain"]
        for (key, count, src, dst) in plan["r_provenance"]:
            self.reward_connections[key] = (
                src, dst, w_np[pos:pos + count].copy(),
                c[pos:pos + count].copy(), dw[pos:pos + count].copy(),
                ct[pos:pos + count].copy())
            pos += count
        # reward_connections moved: the cached structured reward plan holds
        # device copies keyed on _conn_version and must be invalidated
        # (CLAUDE.md convention)
        self._conn_version += 1


def _trace_to_edges(lattice, src, dst):
    """Extract per-edge (c, dw, counter) from a lattice's graph-shaped trace
    in the same order _graph_to_coo emitted its edges."""
    from ..ops.graph import DenseGraph, SparseGraph, StencilGraph
    g = lattice.graph
    tr = lattice.trace
    if isinstance(g, DenseGraph):
        c = np.asarray(tr["c"])[src, dst]
        dw = np.asarray(tr["dw"])[src, dst]
        ct = np.asarray(tr["counter"])[src, dst]
    elif isinstance(g, SparseGraph):
        c = np.asarray(tr["c"])
        dw = np.asarray(tr["dw"])
        ct = np.asarray(tr["counter"])
    else:  # StencilGraph: same mask order as _graph_to_coo
        mask = np.asarray(g.mask)
        c = np.asarray(tr["c"])[mask]
        dw = np.asarray(tr["dw"])[mask]
        ct = np.asarray(tr["counter"])[mask]
    return c, dw, ct


def _edges_to_trace(lattice, src, dst, c, dw, ct):
    from ..ops.graph import DenseGraph, SparseGraph
    g = lattice.graph
    tr = {k: np.asarray(v).copy() for k, v in lattice.trace.items()}
    if isinstance(g, DenseGraph):
        tr["c"][src, dst] = c
        tr["dw"][src, dst] = dw
        tr["counter"][src, dst] = ct
    elif isinstance(g, SparseGraph):
        tr["c"], tr["dw"], tr["counter"] = c, dw, ct
    else:
        mask = np.asarray(g.mask)
        tr["c"][mask] = c
        tr["dw"][mask] = dw
        tr["counter"][mask] = ct
    lattice.trace = {k: jnp.asarray(v) for k, v in tr.items()}


@functools.lru_cache(maxsize=None)
def _build_reward_network_runner(neuron_model, st_model, electrical, chemical,
                                 do_plasticity, plasticity_cls, history_sig,
                                 n_neurons, n_total, skip_nt, with_reward,
                                 length, w_history=False, unroll=1,
                                 ghist=()):
    from .history import HISTORY_KINDS

    readouts = []
    for (key_id, kind, fsig, shape, off, n) in history_sig:
        cls = HISTORY_KINDS[kind]
        h = cls(*fsig[1:]) if len(fsig) > 1 else cls()
        readouts.append((key_id, h, shape, off, n))

    def one_step(edges, pparams, rparams, carry, reward):
        nstate, st_state, w, trace, dopamine, key, clock = carry
        src, dst = edges["src"], edges["dst"]
        cnt = jnp.maximum(edges["in_deg"], 1.0)

        if st_state is not None:
            st_effect = refractoriness_effect(
                st_model.refractoriness, st_state, clock)
            a_src = jnp.concatenate([nstate["v"], st_effect])
            sub_v = jnp.concatenate(
                [jnp.ones_like(nstate["v"]), jnp.zeros_like(st_effect)])
        else:
            a_src = nstate["v"]
            sub_v = jnp.ones_like(a_src)

        if electrical:
            # one gather for (a, sub) instead of two
            pair = jnp.stack([a_src, sub_v], axis=-1)[src]
            contrib = w * (pair[..., 0] - pair[..., 1] * nstate["v"][dst])
            summed = jax.ops.segment_sum(contrib, dst, num_segments=n_neurons)
            elec = nstate["gap_conductance"] * summed / cnt
        else:
            elec = jnp.zeros_like(nstate["v"])

        if with_reward:
            dopamine = dopamine * jnp.exp(-rparams["dt"] / rparams["tau_d"]) \
                + rparams["tau_d"] * reward

        if chemical:
            t_n, m_n = get_neurotransmitter_concentrations(nstate)
            if st_state is not None:
                t_s, m_s = get_neurotransmitter_concentrations(st_state)
                t_src = jnp.concatenate([t_n, t_s])
                m_src = jnp.concatenate([m_n, m_s]).astype(jnp.float32)
            else:
                t_src, m_src = t_n, m_n.astype(jnp.float32)
            T = t_src.shape[-1]
            both = jnp.concatenate([t_src * m_src, m_src], axis=-1)[src]
            vals = w[:, None] * both[..., :T]
            sums = jax.ops.segment_sum(vals, dst, num_segments=n_neurons)
            cnts = jax.ops.segment_sum(both[..., T:], dst,
                                       num_segments=n_neurons)
            t_in = sums / jnp.maximum(cnts, 1.0)
            nstate, spikes = neuron_model.step(
                nstate, elec, t_in, cnts > 0.0, skip_nt=skip_nt)
        else:
            nstate, spikes = neuron_model.step(nstate, elec, skip_nt=skip_nt)

        nstate["last_firing_time"] = jnp.where(
            spikes, clock, nstate["last_firing_time"])

        def node_vals(key_name):
            nv = nstate[key_name] if key_name != "is_spiking" else spikes
            if st_state is not None and key_name in st_state:
                sv = (st_state["is_spiking"] if key_name == "is_spiking"
                      else st_state[key_name])
                return jnp.concatenate([nv, sv])
            if st_state is not None:
                pad = jnp.zeros((n_total - n_neurons,), nv.dtype)
                return jnp.concatenate([nv, pad])
            return nv

        # fuse ALL per-node edge-endpoint fields into one stacked matrix and
        # gather it once per side (this replaces up to 10 scalar takes
        # with 2)
        node_keys = list(dict.fromkeys(
            ("last_firing_time", "is_spiking") + plasticity_cls.NODE_KEYS))
        trig = spikes.astype(jnp.float32) * edges["node_plastic"][:n_neurons]
        if st_state is not None:
            trig = jnp.concatenate(
                [trig, jnp.zeros((n_total - n_neurons,), jnp.float32)])
        fields = [node_vals(k).astype(jnp.float32) for k in node_keys] \
            + [edges["node_mod"], edges["node_plain"], trig]
        stacked = jnp.stack(fields, axis=-1)
        g_src, g_dst = stacked[src], stacked[dst]
        kidx = {k: i for i, k in enumerate(node_keys)}
        b = len(node_keys)
        lft_src = g_src[..., kidx["last_firing_time"]]
        lft_dst = g_dst[..., kidx["last_firing_time"]]
        mod_src, mod_dst = g_src[..., b], g_dst[..., b]
        plain_src, plain_dst = g_src[..., b + 1], g_dst[..., b + 1]
        trig_src, trig_dst = g_src[..., b + 2], g_dst[..., b + 2]
        mod_edge = edges["modulated"]

        # ---- STDP on plain (Weight) edges only ----
        # visit count = spiking endpoints in plastic plain lattices
        # (mod.rs:5083 + across/within sweeps) PLUS modulated endpoints whose
        # other end is a plain lattice (the reward sweep applies the plain
        # plasticity to those edges every step, mod.rs:4868-4898, 4928-4947)
        if do_plasticity:
            pre = {k: g_src[..., kidx[k]] for k in plasticity_cls.NODE_KEYS}
            post = {k: g_dst[..., kidx[k]] for k in plasticity_cls.NODE_KEYS}
            count = (trig_src + trig_dst
                     + mod_src * plain_dst + mod_dst * plain_src)
            w_new = plasticity_cls.apply_visits(w, pre, post, pparams, count)
            w = jnp.where(mod_edge, w, w_new)

        # ---- R-STDP on modulated edges only: one visit per modulated
        # endpoint (every step) + one per spiking plastic plain endpoint
        # (mod.rs:4742-4762) ----
        visits = jnp.where(mod_edge,
                           mod_src + mod_dst + trig_src + trig_dst, 0.0)
        delta = stdp_delta_arrays(lft_src, lft_dst, rparams)
        w1, c1, dw1, ct1 = rstdp_visit(w, trace["c"], trace["dw"],
                                       trace["counter"], delta, dopamine,
                                       rparams)
        m1 = visits >= 1.0
        w = jnp.where(m1, w1, w)
        c_, dw_, ct_ = (jnp.where(m1, c1, trace["c"]),
                        jnp.where(m1, dw1, trace["dw"]),
                        jnp.where(m1, ct1, trace["counter"]))
        w2, c2, dw2, ct2 = rstdp_visit(w, c_, dw_, ct_, delta, dopamine,
                                       rparams)
        m2 = visits >= 2.0
        w = jnp.where(m2, w2, w)
        trace = dict(c=jnp.where(m2, c2, c_), dw=jnp.where(m2, dw2, dw_),
                     counter=jnp.where(m2, ct2, ct_))

        clock = clock + 1

        if st_state is not None:
            st_state, st_spikes, key = st_model.step(st_state, key, clock - 1)
            st_state["last_firing_time"] = jnp.where(
                st_spikes, clock - 1, st_state["last_firing_time"])

        ys = {}
        for key_id, h, shape, off, n in readouts:
            scope, _ = key_id
            state = nstate if scope == "lat" else st_state
            sl = {k: v[off:off + n] for k, v in state.items()
                  if k in ("v", "is_spiking")}
            ys[key_id] = h.readout(sl, shape)
        if w_history:
            ys[("__w__", -1)] = w
        for (i, start, count) in ghist:
            ys[("gw", i)] = jax.lax.slice_in_dim(w, start, start + count)
        return (nstate, st_state, w, trace, dopamine, key, clock), ys

    def run(nstate, st_state, w, trace, dopamine, key, clock, rewards,
            edges, pparams, rparams):
        step = functools.partial(one_step, edges, pparams, rparams)
        carry, ys = jax.lax.scan(
            step, (nstate, st_state, w, trace, dopamine, key, clock), rewards,
            unroll=unroll)
        return carry, ys

    return jax.jit(run, donate_argnums=(0, 1, 2, 3))
