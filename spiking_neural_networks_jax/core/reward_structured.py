"""Structure-preserving runner for RewardModulatedLatticeNetwork.

The flat runner (`core/reward_network.py`) lowers the whole network to one
COO edge list with per-edge (c, dw, counter) trace vectors — every step pays
stacked-row gathers plus a segment_sum.  This runner keeps each component in
its native layout instead, exactly like `core/structured.py` does for plain
networks (and like the 112x `ops/graph.dense_to_stencil` fix did for the
standalone R-STDP lattice):

* intra-lattice synapses keep their graph backend; reward-modulated
  lattices carry their (c, dw, counter) planes SHAPED LIKE the weight array
  (stencil planes stay stencil planes — the trace update is a fused
  elementwise pass, no gathers);
* connections (plain and reward-modulated) are classified into the
  structured ops (one-to-one / dense block / padded gather); reward
  connections carry their traces in the same op layout.

Visit semantics match the flat runner (and the reference,
`reference/backend/src/neuron/mod.rs:5030-5290`):

* modulated edges: one R-STDP visit per endpoint in a reward lattice with
  ``do_modulation`` (every step) plus one per spiking endpoint in a plain
  lattice with ``do_plasticity`` (mod.rs:4742-4762);
* plain edges: STDP visits from spiking plastic endpoints plus the reward
  sweep's every-step visits when one endpoint is modulated and the other is
  a plain lattice (mod.rs:4868-4898, 4928-4947).

Because lattice membership is static, the mod/plain endpoint flags resolve
to compile-time constants per connection — only the spiking terms stay
dynamic.  Equivalence with the flat path is tested directly
(tests/test_reward_network.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..models.spike_train import refractoriness_effect
from .lattice import _freeze, resolve_unroll
from .reward import rstdp_visit, stdp_delta_arrays
from .structured import (classify_connection, _conn_edge_update,
                         _edge_layout, _phase_a, _phase_b)


def compile_structured_reward(net):
    """Classify every component; static per-connection endpoint flags."""
    merged = net._neuron_lattices()
    lat_ids = sorted(merged)
    st_ids = sorted(net.spike_train_lattices)
    reward_ids = set(net.reward_modulated_lattices)

    def flags(node_id):
        """(is_mod, is_plastic, is_plain) for an endpoint lattice id."""
        if node_id in reward_ids:
            lat = net.reward_modulated_lattices[node_id]
            return bool(lat.do_modulation), False, False
        if node_id in net.lattices:
            lat = net.lattices[node_id]
            return False, bool(lat.do_plasticity), True
        return False, False, False  # spike train

    def build(entries, reward):
        out = []
        for (pre_id, post_id), data in sorted(entries.items()):
            src, dst, w = data[0], data[1], data[2]
            pre = merged.get(pre_id) or net.spike_train_lattices.get(pre_id)
            post = merged[post_id]
            pre_is_st = pre_id in net.spike_train_lattices
            pre_mod, pre_plastic, pre_plain = flags(pre_id)
            post_mod, post_plastic, post_plain = flags(post_id)
            if reward:
                # static visit part: modulated endpoints fire every step
                static = int(pre_mod) + int(post_mod)
                dynamic = pre_plastic or post_plastic
                plastic_like = True       # traces update every step
            else:
                static = int(pre_mod and post_plain) \
                    + int(post_mod and pre_plain)
                dynamic = pre_plastic or post_plastic
                plastic_like = bool(static or dynamic)
            op = classify_connection(np.asarray(src), np.asarray(dst),
                                     np.asarray(w), pre.n, post.n,
                                     plastic_like,
                                     pre_shape=(pre.rows, pre.cols),
                                     post_shape=(post.rows, post.cols))
            entry = dict(pre=pre_id, post=post_id, op=op,
                         pre_is_st=pre_is_st, key=(pre_id, post_id),
                         static=static,
                         pre_plastic=pre_plastic, post_plastic=post_plastic,
                         updates=bool(static or dynamic) or reward)
            if reward:
                entry["trace0"] = dict(
                    c=op.place(data[3]), dw=op.place(data[4]),
                    counter=op.place(data[5], np.int32))
            out.append(entry)
        return out

    conns = build(net.connections, reward=False)
    rconns = build(net.reward_connections, reward=True)
    return dict(lat_ids=lat_ids, st_ids=st_ids, conns=conns, rconns=rconns)


def run_structured_reward(net, rewards, with_reward):
    merged = net._neuron_lattices()
    mod_key = tuple((i, bool(net.reward_modulated_lattices[i].do_modulation))
                    for i in sorted(net.reward_modulated_lattices))
    plast_key = tuple(bool(net.lattices[i].do_plasticity)
                      for i in sorted(net.lattices))
    version = (getattr(net, "_conn_version", None), plast_key, mod_key)
    cached = getattr(net, "_structured_reward_plan", None)
    if cached is not None and cached[0] == version:
        plan = cached[1]
    else:
        plan = compile_structured_reward(net)
        net._structured_reward_plan = (version, plan)

    lat_ids, st_ids = plan["lat_ids"], plan["st_ids"]
    conns, rconns = plan["conns"], plan["rconns"]
    lattices = [merged[i] for i in lat_ids]
    sts = [net.spike_train_lattices[i] for i in st_ids]
    reward_ids = set(net.reward_modulated_lattices)

    model = lattices[0].model
    st_model = sts[0].model if sts else None
    plasticity = net._plasticity()
    lat_kind = tuple(
        ("mod" if (i in reward_ids
                   and net.reward_modulated_lattices[i].do_modulation)
         else "reward" if i in reward_ids
         else "plastic" if merged[i].do_plasticity else "plain")
        for i in lat_ids)
    skip_nt = not any(
        jax.device_get([jnp.any(l.state["nt$mask"]) for l in lattices]))
    hist = tuple(
        (i, l.grid_history.kind, _freeze(l.grid_history), (l.rows, l.cols))
        for i, l in zip(lat_ids, lattices) if l.update_grid_history)
    st_hist = tuple(
        (i, s.grid_history.kind, _freeze(s.grid_history), (s.rows, s.cols))
        for i, s in zip(st_ids, sts) if s.update_grid_history)
    ghist = tuple(i for i, l in zip(lat_ids, lattices)
                  if getattr(l, "update_graph_history", False))

    conn_meta = tuple(
        (c["pre"], c["post"], c["op"].kind, c["pre_is_st"], c["static"],
         c["pre_plastic"], c["post_plastic"], c["updates"]) for c in conns)
    rconn_meta = tuple(
        (c["pre"], c["post"], c["op"].kind, c["pre_is_st"], c["static"],
         c["pre_plastic"], c["post_plastic"]) for c in rconns)
    graph_types = tuple(type(l.graph) for l in lattices)

    runner = _build_structured_reward_runner(
        model, st_model, tuple(lat_ids), tuple(st_ids), conn_meta,
        rconn_meta, graph_types, lat_kind, net.electrical_synapse,
        net.chemical_synapse, type(plasticity), skip_nt,
        bool(with_reward), hist, st_hist, int(rewards.shape[0]), ghist,
        resolve_unroll(net.scan_unroll))

    states = tuple(l.state for l in lattices)
    st_states = tuple(s.state for s in sts)
    graphs = tuple(l.graph for l in lattices)
    traces = tuple(
        (merged[i].trace if i in reward_ids else None) for i in lat_ids)
    conn_ws = tuple(c["op"].w0 for c in conns)
    conn_aux = tuple(c["op"].aux for c in conns)
    rconn_ws = tuple(c["op"].w0 for c in rconns)
    rconn_traces = tuple(c["trace0"] for c in rconns)
    rconn_aux = tuple(c["op"].aux for c in rconns)
    pparams = {k: jnp.float32(v) for k, v in plasticity.params.items()}
    rparams = {k: jnp.float32(v)
               for k, v in net.reward_modulator.params.items()}

    out = runner(states, st_states, graphs, traces, conn_ws, conn_aux,
                 rconn_ws, rconn_traces, rconn_aux,
                 jnp.float32(net.dopamine), net.key,
                 jnp.int32(net.internal_clock), rewards, pparams, rparams)
    (states, st_states, graphs, traces, conn_ws, rconn_ws, rconn_traces,
     dopamine, net.key, ys) = out
    iterations = int(rewards.shape[0])
    net.internal_clock += iterations

    # one batched host pull for everything user-visible
    pull = [dopamine]
    for c, w in zip(conns, conn_ws):
        if c["updates"]:
            pull.append(w)
    for c, w, tr in zip(rconns, rconn_ws, rconn_traces):
        pull += [w, tr["c"], tr["dw"], tr["counter"]]
    pulled = jax.device_get(pull)
    net.dopamine = float(pulled[0])
    pi = 1

    for i, lat, state, graph, trace in zip(lat_ids, lattices, states, graphs,
                                           traces):
        lat.state = dict(state)
        lat.graph = graph
        lat.internal_clock = net.internal_clock
        if i in reward_ids:
            lat.trace = dict(trace)
            lat.dopamine = net.dopamine
    for st, state in zip(sts, st_states):
        st.state = dict(state)
        st.internal_clock = net.internal_clock
    for c, w in zip(conns, conn_ws):
        c["op"].w0 = w                  # donated: re-adopt returned buffer
        if not c["updates"]:
            continue
        src, dst, _old = net.connections[c["key"]]
        net.connections[c["key"]] = (src, dst, c["op"].extract(pulled[pi]))
        pi += 1
    for c, w, tr in zip(rconns, rconn_ws, rconn_traces):
        c["op"].w0 = w
        c["trace0"] = tr
        src, dst = net.reward_connections[c["key"]][:2]
        net.reward_connections[c["key"]] = (
            src, dst, c["op"].extract(pulled[pi]),
            c["op"].extract(pulled[pi + 1]),
            c["op"].extract(pulled[pi + 2]),
            c["op"].extract(pulled[pi + 3]))
        pi += 4
    for (i, kind, sig, shape) in hist:
        merged[i].grid_history.extend(ys[("lat", i)])
    for (i, kind, sig, shape) in st_hist:
        net.spike_train_lattices[i].grid_history.extend(ys[("st", i)])
    for i in ghist:
        merged[i].graph_history.extend(np.asarray(ys[("gw", i)]))


def _conn_reward_update(kind, aux, w, tr, static, pre_plastic, post_plastic,
                        pre_vals, post_vals, dopamine, rparams):
    """Up to two gated R-STDP visits on one connection block, in layout."""
    if kind == "empty":
        return w, tr
    pre, post = _edge_layout(kind, aux, pre_vals, post_vals)
    delta = stdp_delta_arrays(pre["last_firing_time"],
                              post["last_firing_time"], rparams)
    visits = jnp.asarray(float(static), jnp.float32)
    if pre_plastic:
        visits = visits + pre["trig"]
    if post_plastic:
        visits = visits + post["trig"]
    visits = jnp.broadcast_to(visits, delta.shape)
    mask = aux["mask"]

    c, dwacc, ct = tr["c"], tr["dw"], tr["counter"]
    w1, c1, d1, t1 = rstdp_visit(w, c, dwacc, ct, delta, dopamine, rparams)
    m1 = jnp.logical_and(mask, visits >= 1.0)
    w = jnp.where(m1, w1, w)
    c = jnp.where(m1, c1, c)
    dwacc = jnp.where(m1, d1, dwacc)
    ct = jnp.where(m1, t1, ct)
    w2, c2, d2, t2 = rstdp_visit(w, c, dwacc, ct, delta, dopamine, rparams)
    m2 = jnp.logical_and(mask, visits >= 2.0)
    w = jnp.where(m2, w2, w)
    tr = dict(c=jnp.where(m2, c2, c), dw=jnp.where(m2, d2, dwacc),
              counter=jnp.where(m2, t2, ct))
    return w, tr


@functools.lru_cache(maxsize=None)
def _build_structured_reward_runner(model, st_model, lat_ids, st_ids,
                                    conn_meta, rconn_meta, graph_types,
                                    lat_kind, electrical, chemical,
                                    plasticity_cls, skip_nt, with_reward,
                                    hist, st_hist, length, ghist=(),
                                    unroll=1):
    from .history import HISTORY_KINDS

    lat_index = {i: k for k, i in enumerate(lat_ids)}
    st_index = {i: k for k, i in enumerate(st_ids)}

    readouts = []
    for (i, kind, sig, shape) in hist:
        cls = HISTORY_KINDS[kind]
        readouts.append((("lat", i), cls(*sig[1:]) if len(sig) > 1 else cls(),
                         shape, lat_index[i]))
    for (i, kind, sig, shape) in st_hist:
        cls = HISTORY_KINDS[kind]
        readouts.append((("st", i), cls(*sig[1:]) if len(sig) > 1 else cls(),
                         shape, st_index[i]))

    any_plastic = any(k == "plastic" for k in lat_kind) \
        or any(m[4] or m[5] or m[6] for m in conn_meta)

    def one_step(pparams, rparams, carry, reward):
        (states, st_states, graphs, traces, conn_ws, conn_aux,
         rconn_ws, rconn_traces, rconn_aux, dopamine, key, clock) = carry
        states = list(states)
        st_states = list(st_states)
        graphs = list(graphs)
        traces = list(traces)
        conn_ws = list(conn_ws)
        rconn_ws = list(rconn_ws)
        rconn_traces = list(rconn_traces)

        effects = [refractoriness_effect(st_model.refractoriness, s, clock)
                   for s in st_states] if st_states else []

        all_conns = [(m, conn_aux[ci], conn_ws[ci])
                     for ci, m in enumerate(conn_meta)] \
            + [(m, rconn_aux[ci], rconn_ws[ci])
               for ci, m in enumerate(rconn_meta)]

        # ---- Phase A (structured._phase_a, shared with the plain runner) ----
        inputs, chem_sums, chem_cnts = _phase_a(
            lat_ids, lat_index, st_index, states, st_states, graphs,
            [(m[:4], aux, w) for (m, aux, w) in all_conns],
            effects, electrical, chemical)

        # dopamine decays with the reward before the visits
        # (plasticity/mod.rs:204-206)
        if with_reward:
            dopamine = dopamine * jnp.exp(-rparams["dt"] / rparams["tau_d"]) \
                + rparams["tau_d"] * reward

        # ---- Phase B: step every lattice (one concatenated model call;
        # structured._phase_b) ----
        states, spikes_list = _phase_b(model, states, inputs, chem_sums,
                                       chem_cnts, chemical, skip_nt, clock)

        def vals_of(node_id, keys):
            """Per-node value dict for an endpoint population."""
            if node_id in st_index:
                s = st_states[st_index[node_id]]
                out = {}
                for key_ in keys:
                    if key_ == "trig":
                        out[key_] = jnp.zeros_like(s["v"])
                    elif key_ in s:
                        out[key_] = s[key_]
                    else:
                        out[key_] = jnp.zeros_like(s["v"])
                return out
            k = lat_index[node_id]
            s = states[k]
            out = {}
            for key_ in keys:
                if key_ == "trig":
                    out[key_] = spikes_list[k].astype(jnp.float32)
                elif key_ == "is_spiking":
                    out[key_] = spikes_list[k]
                else:
                    out[key_] = s[key_]
            return out

        # ---- STDP: intra plastic plain lattices + plain connections ----
        if any_plastic:
            for k in range(len(lat_ids)):
                if lat_kind[k] == "plastic":
                    vals = {key_: (spikes_list[k] if key_ == "is_spiking"
                                   else states[k][key_])
                            for key_ in plasticity_cls.NODE_KEYS}
                    graphs[k] = graphs[k].apply_edge_update(
                        lambda w, pre, post: plasticity_cls.apply_visits(
                            w, pre, post, pparams,
                            pre["is_spiking"].astype(jnp.float32)
                            + post["is_spiking"].astype(jnp.float32)) - w,
                        vals, vals)
            for ci, meta in enumerate(conn_meta):
                (pre_id, post_id, kind, pre_is_st, static, pre_plastic,
                 post_plastic, updates) = meta
                if not updates:
                    continue
                keys = list(dict.fromkeys(
                    plasticity_cls.NODE_KEYS + ("trig",)))
                pre_vals = vals_of(pre_id, keys)
                post_vals = vals_of(post_id, keys)

                def gated_delta(w, pre, post, static=static,
                                pre_plastic=pre_plastic,
                                post_plastic=post_plastic):
                    count = jnp.asarray(float(static), jnp.float32)
                    if pre_plastic:
                        count = count + pre["trig"]
                    if post_plastic:
                        count = count + post["trig"]
                    return plasticity_cls.apply_visits(
                        w, pre, post, pparams, count) - w

                conn_ws[ci] = _conn_edge_update(
                    kind, conn_aux[ci], conn_ws[ci], gated_delta,
                    pre_vals, post_vals)

        # ---- R-STDP visits ----
        # intra edges of modulated reward lattices: exactly two visits per
        # edge per step in the graph's NATIVE layout (stencil planes stay
        # planes — same program as the standalone reward lattice runner)
        for k in range(len(lat_ids)):
            if lat_kind[k] != "mod":
                continue
            g = graphs[k]
            tr = traces[k]
            vals = {"last_firing_time": states[k]["last_firing_time"]}
            pre, post = g.edge_pre_post(vals, vals)
            delta = stdp_delta_arrays(pre["last_firing_time"],
                                      post["last_firing_time"], rparams)
            w0 = g.weights
            w, c, dw, ct = rstdp_visit(w0, tr["c"], tr["dw"], tr["counter"],
                                       delta, dopamine, rparams)
            w, c, dw, ct = rstdp_visit(w, c, dw, ct, delta, dopamine, rparams)
            m = g.edge_mask
            graphs[k] = g.replace_weights(jnp.where(m, w, w0))
            traces[k] = dict(c=jnp.where(m, c, tr["c"]),
                             dw=jnp.where(m, dw, tr["dw"]),
                             counter=jnp.where(m, ct, tr["counter"]))

        # reward connections: static modulated visits + dynamic plastic ones
        for ci, meta in enumerate(rconn_meta):
            (pre_id, post_id, kind, pre_is_st, static, pre_plastic,
             post_plastic) = meta
            keys = ("last_firing_time", "trig")
            pre_vals = vals_of(pre_id, keys)
            post_vals = vals_of(post_id, keys)
            rconn_ws[ci], rconn_traces[ci] = _conn_reward_update(
                kind, rconn_aux[ci], rconn_ws[ci], rconn_traces[ci], static,
                pre_plastic, post_plastic, pre_vals, post_vals, dopamine,
                rparams)

        clock = clock + 1

        # ---- spike trains last ----
        for k in range(len(st_ids)):
            st_states[k], st_spk, key = st_model.step(st_states[k], key,
                                                      clock - 1)
            st_states[k]["last_firing_time"] = jnp.where(
                st_spk, clock - 1, st_states[k]["last_firing_time"])

        ys = {}
        for key_id, h, shape, idx in readouts:
            pool = states if key_id[0] == "lat" else st_states
            ys[key_id] = h.readout(pool[idx], shape)
        for i in ghist:
            ys[("gw", i)] = graphs[lat_index[i]].weights

        return (tuple(states), tuple(st_states), tuple(graphs),
                tuple(traces), tuple(conn_ws), conn_aux, tuple(rconn_ws),
                tuple(rconn_traces), rconn_aux, dopamine, key, clock), ys

    def run(states, st_states, graphs, traces, conn_ws, conn_aux, rconn_ws,
            rconn_traces, rconn_aux, dopamine, key, clock, rewards, pparams,
            rparams):
        step = functools.partial(one_step, pparams, rparams)
        carry, ys = jax.lax.scan(
            step, (states, st_states, graphs, traces, conn_ws, conn_aux,
                   rconn_ws, rconn_traces, rconn_aux, dopamine, key, clock),
            rewards, unroll=unroll)
        return (carry[0], carry[1], carry[2], carry[3], carry[4], carry[6],
                carry[7], carry[9], carry[10], ys)

    return jax.jit(run, donate_argnums=(0, 1, 2, 3, 4, 6, 7))
