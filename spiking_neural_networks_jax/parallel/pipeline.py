"""Pipeline parallelism: a chain-topology LatticeNetwork with one lattice
per device (SURVEY.md §2.5 pipeline-parallel row — "pipeline multi-lattice
networks across devices (each lattice a stage)").

The reference has no distributed execution at all; its closest analog is the
single-device network runtime (`reference/backend/src/neuron/
gpu_lattices/mod.rs:2284-2580`).  Here a network whose lattices form a chain
(stage 0 -> 1 -> ... -> S-1 via one-to-one connections) is executed as ONE
SPMD program over a ``("pp",)`` mesh:

* every per-stage array (state leaves, intra-lattice graph planes,
  connecting-edge weights) is stacked along a leading stage axis and
  sharded ``P("pp", ...)`` — one stage per device;
* inside a single `shard_map` + `lax.scan`, each device runs the SAME
  single-lattice step the structured network runner uses (core/
  structured.py:509-654), and the previous stage's fields arrive by
  `lax.ppermute` over the inter-chip interconnect — one hop per step for
  the membrane voltage (electrical), the neurotransmitter concentrations
  (chemical), and the plasticity node fields (STDP on connecting edges);
* unlike GPipe-style microbatched pipelining there are no bubbles: an SNN
  chain is a systolic array in time — stage k+1's step-t input depends
  only on stage k's step t-1 state (the reference's two-phase semantics,
  neuron/mod.rs:2420-2476), so all S stages compute every step and the
  per-step communication is a single neighbor permute.

Semantics are exactly the structured runner's (same expression order), so
pipelined runs match `run_lattices` to float-accumulation order.

Supported chains (validated, errors otherwise): homogeneous model + grid
shape + intra-graph structure across stages, one-to-one connecting edges,
electrical and/or chemical synapses, per-stage plasticity (intra + gated
connecting-edge updates), grid histories.  Spike-train lattices are not
part of the chain; drive stage 0 with state overrides instead.

Reward-modulated chains run through :func:`run_pipelined_with_reward`
(mixed reward/plain stages, reward-modulated or plain one-to-one links,
R-STDP eligibility traces as stage-local planes, replicated dopamine).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.structured import (_chem_counts, _conn_edge_update, _conn_gather,
                               _conn_gather_chemical, _freeze)
from ..core.lattice import resolve_unroll
from ..core.history import HISTORY_KINDS
from ..core.reward import rstdp_visit, stdp_delta_arrays
from ..errors import LatticeNetworkError
from ..models.base import get_neurotransmitter_concentrations
from ..ops.graph import DenseGraph, StencilGraph


def make_pipeline_mesh(n_stages, devices=None, axis="pp"):
    """A 1-D mesh with one device per pipeline stage."""
    if devices is None:
        devices = jax.devices()
    if len(devices) < n_stages:
        raise ValueError(
            f"pipeline of {n_stages} stages needs {n_stages} devices, "
            f"have {len(devices)}")
    return Mesh(np.asarray(devices[:n_stages]), (axis,))


def _chain_order(net, order):
    """Validate the chain topology and return the stage order."""
    if net.spike_train_lattices:
        raise LatticeNetworkError(
            "pipelined networks cannot contain spike-train lattices; "
            "drive stage 0 via state overrides")
    if getattr(net, "reward_modulated_lattices", None) \
            or getattr(net, "reward_connections", None):
        raise LatticeNetworkError(
            "pipelined execution does not support reward-modulated "
            "lattices or reward connections; use run_lattices_with_reward")
    if order is None:
        order = sorted(net.lattices)
    if sorted(order) != sorted(net.lattices):
        raise LatticeNetworkError("order must list every lattice id once")
    links = {(order[k], order[k + 1]) for k in range(len(order) - 1)}
    extra = set(net.connections) - links
    if extra:
        raise LatticeNetworkError(
            f"not a chain: connections {sorted(extra)} are not stage->next")
    return list(order)


def _stack_state(lattices, mesh, axis):
    """Host-side stack of per-stage state dicts -> (S, ...) sharded leaves."""
    keys = sorted(lattices[0].state)
    out = {}
    for k in keys:
        stacked = np.stack([np.asarray(l.state[k]) for l in lattices])
        sh = NamedSharding(mesh, P(axis, *([None] * (stacked.ndim - 1))))
        out[k] = jax.device_put(stacked, sh)
    return out


def _stack_graphs(lattices, mesh, axis):
    """Stack per-stage intra graphs (same static structure) into leading-S
    arrays; returns (graph_kind, static, arrays dict)."""
    g0 = lattices[0].graph
    if isinstance(g0, StencilGraph):
        offsets = g0.offsets
        for l in lattices:
            if not isinstance(l.graph, StencilGraph) \
                    or l.graph.offsets != offsets:
                raise LatticeNetworkError(
                    "pipelined stages need identical stencil offset sets")
        arrs = dict(
            weights=np.stack([np.asarray(l.graph.weights) for l in lattices]),
            mask=np.stack([np.asarray(l.graph.mask) for l in lattices]),
            in_deg=np.stack([np.asarray(l.graph.in_deg) for l in lattices]))
        static = offsets
        kind = "stencil"
    elif isinstance(g0, DenseGraph):
        for l in lattices:
            if not isinstance(l.graph, DenseGraph):
                raise LatticeNetworkError(
                    "pipelined stages need one intra-graph backend")
        arrs = dict(
            weights=np.stack([np.asarray(l.graph.weights) for l in lattices]),
            mask=np.stack([np.asarray(l.graph.mask) for l in lattices]))
        static = None
        kind = "dense"
    else:
        raise LatticeNetworkError(
            "pipelined intra graphs must be StencilGraph or DenseGraph "
            f"(got {type(g0).__name__}); COO edge lists have no stage-"
            "stackable layout")
    out = {}
    for k, v in sorted(arrs.items()):
        sh = NamedSharding(mesh, P(axis, *([None] * (v.ndim - 1))))
        out[k] = jax.device_put(v, sh)
    return kind, static, out


def _local_graph(kind, static, arrs):
    """Rebuild the stage-local graph object from squeezed block arrays."""
    if kind == "stencil":
        return StencilGraph(static, arrs["weights"], arrs["mask"],
                            arrs["in_deg"])
    return DenseGraph(arrs["weights"], arrs["mask"])


def _stack_connections(net, order, lattices, mesh, axis):
    """(S, N) connecting-edge weights/mask/in_deg; row s is the one-to-one
    link INTO stage s (row 0 all-zero)."""
    n = lattices[0].n
    S = len(order)
    w = np.zeros((S, n), np.float32)
    m = np.zeros((S, n), bool)
    for s in range(1, S):
        conn = net.connections.get((order[s - 1], order[s]))
        if conn is None:
            continue
        src, dst, cw = conn
        src, dst = np.asarray(src), np.asarray(dst)
        if len(src) and not (src == dst).all():
            raise LatticeNetworkError(
                "pipelined connecting edges must be one-to-one "
                "(src position == dst position)")
        w[s, dst] = cw
        m[s, dst] = True
    spec = NamedSharding(mesh, P(axis, None))
    out = {}
    for k, v in (("w", w.astype(np.float32)), ("mask", m),
                 ("in_deg", m.astype(np.float32))):
        out[k] = jax.device_put(v, spec)
    return out


@functools.lru_cache(maxsize=None)
def _build_pipeline_runner(mesh, axis, model, graph_kind, graph_static,
                           electrical, chemical, plasticity_cls, any_plast,
                           skip_nt, hist_sig, shape, S, length, unroll=1):
    perm = tuple((k, k + 1) for k in range(S - 1))

    readout = None
    if hist_sig is not None:
        cls = HISTORY_KINDS[hist_sig[0]]
        readout = cls(*hist_sig[1:]) if len(hist_sig) > 1 else cls()

    def hop(x):
        """Previous stage's value of x (stage 0 receives zeros)."""
        if S == 1:
            return jnp.zeros_like(x)
        return jax.lax.ppermute(x, axis, perm)

    def one_step(pparams, plast, conn_aux, carry, _):
        s, garrs, conn_w, clock = carry
        g = _local_graph(graph_kind, graph_static, garrs)
        flag, pre_flag = plast  # this stage / previous stage plastic (0/1)

        # ---- Phase A (structured.py:520-576 specialized to one lattice
        # plus one incoming one-to-one connection) ----
        total = jnp.zeros_like(s["v"])
        cnt = jnp.zeros_like(s["v"])
        if electrical:
            total = total + g.gather_electrical(
                s["v"], jnp.ones_like(s["v"]), s["v"],
                jnp.ones_like(s["v"])) * jnp.maximum(g.in_degree(), 1.0)
            cnt = cnt + g.in_degree()
            v_recv = hop(s["v"])
            total = total + _conn_gather("one2one", conn_aux, conn_w,
                                         v_recv, jnp.ones_like(v_recv),
                                         s["v"])
            cnt = cnt + conn_aux["in_deg"]
        inputs = s["gap_conductance"] * total / jnp.maximum(cnt, 1.0) \
            if electrical else jnp.zeros_like(s["v"])

        if chemical:
            t, m = get_neurotransmitter_concentrations(s)
            mf = m.astype(jnp.float32)
            t_in_g, _valid = g.gather_chemical(t, mf)
            gc = _chem_counts(g, mf)
            csum = t_in_g * jnp.maximum(gc, 1.0) * (gc > 0)
            ccnt = gc
            k_nt = t.shape[-1]
            both = hop(jnp.concatenate([t, mf], axis=-1))
            sums, cnts = _conn_gather_chemical(
                "one2one", conn_aux, conn_w, both[..., :k_nt],
                both[..., k_nt:])
            csum = csum + sums
            ccnt = ccnt + cnts
            t_in = csum / jnp.maximum(ccnt, 1.0)
            s, spk = model.step(s, inputs, t_in, ccnt > 0.0, skip_nt=skip_nt)
        else:
            s, spk = model.step(s, inputs, skip_nt=skip_nt)
        s["last_firing_time"] = jnp.where(spk, clock, s["last_firing_time"])

        # ---- deferred plasticity (structured.py:594-635); per-stage
        # enables are data (0/1 floats), so the single SPMD program gates
        # deltas instead of branching ----
        if any_plast:
            vals = {k: s[k] for k in plasticity_cls.NODE_KEYS}
            garrs = _graph_arrays(g.apply_edge_update(
                lambda w, pre, post: flag * (plasticity_cls.apply_visits(
                    w, pre, post, pparams,
                    pre["is_spiking"].astype(jnp.float32)
                    + post["is_spiking"].astype(jnp.float32)) - w),
                vals, vals), graph_kind)

            keys = list(plasticity_cls.NODE_KEYS)
            stacked = hop(jnp.stack(
                [s[k].astype(jnp.float32) for k in keys], axis=-1))
            pre_vals = {k: stacked[..., f] for f, k in enumerate(keys)}

            def gated_delta(w, pre, post):
                count = (pre["is_spiking"].astype(jnp.float32) * pre_flag
                         + post["is_spiking"].astype(jnp.float32) * flag)
                gate = jnp.maximum(pre_flag, flag)
                return gate * (plasticity_cls.apply_visits(
                    w, pre, post, pparams, count) - w)

            conn_w = _conn_edge_update("one2one", conn_aux, conn_w,
                                       gated_delta, pre_vals, vals)
        else:
            garrs = _graph_arrays(g, graph_kind)

        clock = clock + 1
        ys = readout.readout(s, shape) if readout is not None else ()
        return (s, garrs, conn_w, clock), ys

    def body(state, garrs, conn_w, conn_aux, plast_pair, clock, pparams):
        # blocks carry a leading stage axis of length 1: squeeze it
        s = {k: v[0] for k, v in state.items()}
        garrs = {k: v[0] for k, v in garrs.items()}
        conn_w = conn_w[0]
        conn_aux = {k: v[0] for k, v in conn_aux.items()}
        plast = (plast_pair[0, 0], plast_pair[0, 1])
        step = functools.partial(one_step, pparams, plast, conn_aux)
        (s, garrs, conn_w, clock), ys = jax.lax.scan(
            step, (s, garrs, conn_w, clock), None, length=length,
            unroll=unroll)
        out_state = {k: v[None] for k, v in s.items()}
        out_g = {k: v[None] for k, v in garrs.items()}
        if readout is not None:
            ys = ys[:, None]  # (T, 1, ...) local -> (T, S, ...) global
        return out_state, out_g, conn_w[None], ys

    stage = P(axis)
    rep = P()
    out_ys = P(None, axis) if readout is not None else rep
    # conn_aux and plast_pair are NOT donated: chunked runs reuse them
    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(stage, stage, stage, stage, stage, rep, rep),
        out_specs=(stage, stage, stage, out_ys))
    return jax.jit(mapped, donate_argnums=(0, 1, 2))


def _graph_arrays(g, kind):
    if kind == "stencil":
        return dict(weights=g.weights, mask=g.mask, in_deg=g.in_deg)
    return dict(weights=g.weights, mask=g.mask)


def run_pipelined(net, iterations, mesh=None, order=None, axis="pp"):
    """Run a chain-topology LatticeNetwork as one SPMD pipeline over a
    ``("pp",)`` mesh (one lattice per device) and write results back to the
    network exactly as `run_lattices` would."""
    net._ship_states()  # lazy-populate states ship before consumption
    order = _chain_order(net, order)
    lattices = [net.lattices[i] for i in order]
    S = len(lattices)
    if mesh is None:
        mesh = make_pipeline_mesh(S, axis=axis)
    if mesh.devices.size != S:
        raise LatticeNetworkError(
            f"mesh has {mesh.devices.size} devices for {S} stages")
    axis = mesh.axis_names[0]
    shape0 = (lattices[0].rows, lattices[0].cols)
    for l in lattices:
        if (l.rows, l.cols) != shape0:
            raise LatticeNetworkError("pipelined stages must share (rows, "
                                      "cols)")

    model = lattices[0].model
    plasticity = net._plasticity()
    any_plast = any(bool(l.do_plasticity) for l in lattices)
    skip_nt = not any(bool(jnp.any(l.state["nt$mask"])) for l in lattices)

    hist_flags = {bool(l.update_grid_history) for l in lattices}
    if hist_flags == {True}:
        sigs = {_freeze(l.grid_history) for l in lattices}
        if len(sigs) != 1:
            raise LatticeNetworkError(
                "pipelined stages must share one grid-history kind")
        hist_sig = next(iter(sigs))
    elif hist_flags == {False}:
        hist_sig = None
    else:
        raise LatticeNetworkError(
            "grid history must be enabled on all stages or none")

    graph_kind, graph_static, garrs = _stack_graphs(lattices, mesh, axis)
    states = _stack_state(lattices, mesh, axis)
    conn = _stack_connections(net, order, lattices, mesh, axis)
    conn_w = conn.pop("w")
    conn_aux = conn  # mask + in_deg: NOT donated, reused across chunks
    plast_pair = jax.device_put(
        np.array([[float(bool(l.do_plasticity)),
                   float(bool(lattices[k - 1].do_plasticity)) if k else 0.0]
                  for k, l in enumerate(lattices)], np.float32),
        NamedSharding(mesh, P(axis, None)))
    pparams = {k: jnp.float32(v) for k, v in plasticity.params.items()}

    # history runs are chunked like run_lattices (core/network.py:619-624):
    # an unchunked 100k-step grid-history scan would materialize the whole
    # (T, S, rows, cols) ys buffer on device
    chunk_len = net._history_chunk() if hist_sig is not None \
        else int(iterations)
    remaining = int(iterations)
    hist_parts = []
    while remaining > 0:
        length = min(remaining, chunk_len)
        runner = _build_pipeline_runner(
            mesh, axis, model, graph_kind, graph_static,
            bool(net.electrical_synapse), bool(net.chemical_synapse),
            type(plasticity), any_plast, skip_nt, hist_sig, shape0, S,
            length,
            resolve_unroll(getattr(net, "scan_unroll", None)))
        states, garrs, conn_w, ys = runner(
            states, garrs, conn_w, conn_aux, plast_pair,
            jnp.int32(net.internal_clock), pparams)
        net.internal_clock += length
        remaining -= length
        if hist_sig is not None:
            hist_parts.append(np.asarray(ys))

    # ---- write back per stage (mirrors core/structured.run_structured) ----
    from ..utils.transfer import device_put_state
    host_state = {k: np.asarray(v) for k, v in states.items()}
    host_g = {k: np.asarray(v) for k, v in garrs.items()}
    host_cw = np.asarray(conn_w)

    for s_idx, lat in enumerate(lattices):
        lat.state = device_put_state(
            {k: v[s_idx] for k, v in host_state.items()})
        if graph_kind == "stencil":
            lat.graph = StencilGraph(
                graph_static, jax.device_put(host_g["weights"][s_idx]),
                jax.device_put(host_g["mask"][s_idx]),
                jax.device_put(host_g["in_deg"][s_idx]))
        else:
            lat.graph = DenseGraph(jax.device_put(host_g["weights"][s_idx]),
                                   jax.device_put(host_g["mask"][s_idx]))
        lat.internal_clock = net.internal_clock
    for s_idx in range(1, S):
        key = (order[s_idx - 1], order[s_idx])
        if key not in net.connections:
            continue
        src, dst, _old = net.connections[key]
        net.connections[key] = (src, dst, host_cw[s_idx][np.asarray(dst)])
    net._conn_version += 1  # weights may have moved: invalidate cached plans
    if hist_sig is not None and hist_parts:
        hist = np.concatenate(hist_parts)  # (T, S, rows, cols)
        for s_idx, lat in enumerate(lattices):
            lat.grid_history.extend(hist[:, s_idx])
    return net


# ---------------------------------------------------------------------------
# Reward-modulated (R-STDP) pipeline: chain RewardModulatedLatticeNetworks
# (VERDICT r2 item 8).  Stage-local eligibility traces are just more planes
# shaped like the stage's weights, and the dopamine scalar is replicated —
# its update depends only on the (replicated) reward schedule, so every
# device computes the identical value with no extra communication.  The
# per-step hop carries (last_firing_time, is_spiking) exactly like the STDP
# pipeline; per-stage modulation/plasticity enables are data flags.
# Semantics follow the structured reward runner (core/reward_network.py
# one_step; neuron/mod.rs:4742-4947): modulated edges get up to two R-STDP
# visits per step, plain edges get STDP visits counted from spiking plastic
# endpoints plus modulated-endpoint sweeps.
# ---------------------------------------------------------------------------


def _reward_chain_order(net, order):
    if net.spike_train_lattices:
        raise LatticeNetworkError(
            "pipelined networks cannot contain spike-train lattices")
    all_ids = dict(net.lattices)
    all_ids.update(net.reward_modulated_lattices)
    if order is None:
        order = sorted(all_ids)
    if sorted(order) != sorted(all_ids):
        raise LatticeNetworkError("order must list every lattice id once")
    links = {(order[k], order[k + 1]) for k in range(len(order) - 1)}
    extra = (set(net.connections) | set(net.reward_connections)) - links
    if extra:
        raise LatticeNetworkError(
            f"not a chain: connections {sorted(extra)} are not stage->next")
    both = set(net.connections) & set(net.reward_connections)
    if both:
        raise LatticeNetworkError(
            f"links {sorted(both)} are both plain and reward-modulated")
    return list(order), all_ids


def _stack_traces(lattices, mesh, axis):
    """Stack per-stage intra-edge trace planes (zeros for plain stages)."""
    shape = None
    for lat in lattices:
        if getattr(lat, "trace", None) is not None:
            shape = np.asarray(lat.trace["c"]).shape
            break
    if shape is None:
        shape = np.asarray(lattices[0].graph.weights).shape
    out = {}
    for k, dt in (("c", np.float32), ("dw", np.float32),
                  ("counter", np.int32)):
        planes = []
        for lat in lattices:
            tr = getattr(lat, "trace", None)
            planes.append(np.asarray(tr[k]) if tr is not None
                          else np.zeros(shape, dt))
        stacked = np.stack(planes).astype(dt)
        sh = NamedSharding(mesh, P(axis, *([None] * (stacked.ndim - 1))))
        out[k] = jax.device_put(stacked, sh)
    return out


def _stack_reward_connections(net, order, lattices, mesh, axis):
    """(S, N) connecting-edge arrays: weights, mask, in_deg, modulated flag,
    and the three trace planes (reward rows carry their stored traces)."""
    n = lattices[0].n
    S = len(order)
    w = np.zeros((S, n), np.float32)
    m = np.zeros((S, n), bool)
    mod = np.zeros((S, n), np.float32)
    c = np.zeros((S, n), np.float32)
    dw = np.zeros((S, n), np.float32)
    ct = np.zeros((S, n), np.int32)
    for s in range(1, S):
        link = (order[s - 1], order[s])
        if link in net.connections:
            src, dst, cw = net.connections[link]
            src, dst = np.asarray(src), np.asarray(dst)
            if len(src) and not (src == dst).all():
                raise LatticeNetworkError(
                    "pipelined connecting edges must be one-to-one")
            w[s, dst] = cw
            m[s, dst] = True
        elif link in net.reward_connections:
            src, dst, cw, ec, edw, ect = net.reward_connections[link]
            src, dst = np.asarray(src), np.asarray(dst)
            if len(src) and not (src == dst).all():
                raise LatticeNetworkError(
                    "pipelined connecting edges must be one-to-one")
            w[s, dst] = cw
            m[s, dst] = True
            mod[s, dst] = 1.0
            c[s, dst] = ec
            dw[s, dst] = edw
            ct[s, dst] = ect
    spec = NamedSharding(mesh, P(axis, None))
    out = {}
    for k, v in (("w", w), ("mask", m), ("in_deg", m.astype(np.float32)),
                 ("modulated", mod), ("c", c), ("dw", dw), ("counter", ct)):
        out[k] = jax.device_put(v, spec)
    return out


@functools.lru_cache(maxsize=None)
def _build_reward_pipeline_runner(mesh, axis, model, graph_kind,
                                  graph_static, electrical, chemical,
                                  plasticity_cls, with_reward, skip_nt,
                                  hist_sig, shape, S, length, unroll=1):
    perm = tuple((k, k + 1) for k in range(S - 1))

    readout = None
    if hist_sig is not None:
        cls = HISTORY_KINDS[hist_sig[0]]
        readout = cls(*hist_sig[1:]) if len(hist_sig) > 1 else cls()

    def hop(x):
        if S == 1:
            return jnp.zeros_like(x)
        return jax.lax.ppermute(x, axis, perm)

    def one_step(rparams, pparams, flags, conn_aux, carry, reward):
        s, garrs, itrace, conn_w, ctrace, dopamine, clock = carry
        g = _local_graph(graph_kind, graph_static, garrs)
        (self_mod, self_plain, self_plast,
         pre_mod, pre_plain, pre_plast) = flags

        # ---- Phase A (identical to the plain pipeline) ----
        total = jnp.zeros_like(s["v"])
        cnt = jnp.zeros_like(s["v"])
        if electrical:
            total = total + g.gather_electrical(
                s["v"], jnp.ones_like(s["v"]), s["v"],
                jnp.ones_like(s["v"])) * jnp.maximum(g.in_degree(), 1.0)
            cnt = cnt + g.in_degree()
            v_recv = hop(s["v"])
            total = total + _conn_gather("one2one", conn_aux, conn_w,
                                         v_recv, jnp.ones_like(v_recv),
                                         s["v"])
            cnt = cnt + conn_aux["in_deg"]
        inputs = s["gap_conductance"] * total / jnp.maximum(cnt, 1.0) \
            if electrical else jnp.zeros_like(s["v"])

        if with_reward:
            # reward_modulator.update(reward) before the neuron sweep
            # (plasticity/mod.rs:204-206); replicated — identical on every
            # device
            dopamine = dopamine * jnp.exp(
                -rparams["dt"] / rparams["tau_d"]) \
                + rparams["tau_d"] * reward

        if chemical:
            t, m = get_neurotransmitter_concentrations(s)
            mf = m.astype(jnp.float32)
            t_in_g, _valid = g.gather_chemical(t, mf)
            gc = _chem_counts(g, mf)
            csum = t_in_g * jnp.maximum(gc, 1.0) * (gc > 0)
            ccnt = gc
            k_nt = t.shape[-1]
            both = hop(jnp.concatenate([t, mf], axis=-1))
            sums, cnts = _conn_gather_chemical(
                "one2one", conn_aux, conn_w, both[..., :k_nt],
                both[..., k_nt:])
            csum = csum + sums
            ccnt = ccnt + cnts
            t_in = csum / jnp.maximum(ccnt, 1.0)
            s, spk = model.step(s, inputs, t_in, ccnt > 0.0,
                                skip_nt=skip_nt)
        else:
            s, spk = model.step(s, inputs, skip_nt=skip_nt)
        s["last_firing_time"] = jnp.where(spk, clock,
                                          s["last_firing_time"])

        # ---- hop the previous stage's plasticity fields ----
        stacked = hop(jnp.stack(
            [s["last_firing_time"].astype(jnp.float32),
             spk.astype(jnp.float32)], axis=-1))
        lft_pre = stacked[..., 0].astype(jnp.int32)
        spk_pre = stacked[..., 1]
        spk_f = spk.astype(jnp.float32)

        # ---- intra edges ----
        vals = {"last_firing_time": s["last_firing_time"],
                "is_spiking": spk}
        pre, post = g.edge_pre_post(vals, vals)
        emask = g.edge_mask
        w0 = g.weights
        # R-STDP: two visits per step on a modulated stage's intra edges
        # (both endpoints modulated; reward_lattice_step)
        delta_i = stdp_delta_arrays(pre["last_firing_time"],
                                    post["last_firing_time"], rparams)
        w1, c1, dw1, ct1 = rstdp_visit(
            w0, itrace["c"], itrace["dw"], itrace["counter"], delta_i,
            dopamine, rparams)
        w1, c1, dw1, ct1 = rstdp_visit(w1, c1, dw1, ct1, delta_i,
                                       dopamine, rparams)
        mod_gate = emask & (self_mod > 0)
        new_w = jnp.where(mod_gate, w1, w0)
        itrace = dict(
            c=jnp.where(mod_gate, c1, itrace["c"]),
            dw=jnp.where(mod_gate, dw1, itrace["dw"]),
            counter=jnp.where(mod_gate, ct1, itrace["counter"]))
        # STDP on a plain plastic stage's intra edges
        count_i = (pre["is_spiking"].astype(jnp.float32)
                   + post["is_spiking"].astype(jnp.float32))
        w_stdp = plasticity_cls.apply_visits(w0, pre, post, pparams,
                                             count_i)
        plast_gate = emask & (self_plast > 0)
        new_w = jnp.where(plast_gate, w_stdp, new_w)
        garrs = _graph_arrays(g.replace_weights(new_w), graph_kind)

        # ---- the incoming one-to-one connecting edge ----
        cm = conn_aux["mask"]
        mod_edge = conn_aux["modulated"]
        lft_dst = s["last_firing_time"]
        delta_c = stdp_delta_arrays(lft_pre, lft_dst, rparams)
        trig_src = spk_pre * pre_plast
        trig_dst = spk_f * self_plast
        # R-STDP visits (reward_network.py one_step): one per modulated
        # endpoint (every step) + one per spiking plastic plain endpoint,
        # capped at two applications
        visits = (pre_mod + self_mod + trig_src + trig_dst) * mod_edge
        w1, c1, dw1, ct1 = rstdp_visit(
            conn_w, ctrace["c"], ctrace["dw"], ctrace["counter"], delta_c,
            dopamine, rparams)
        m1 = cm & (visits >= 1.0)
        cw = jnp.where(m1, w1, conn_w)
        c_ = jnp.where(m1, c1, ctrace["c"])
        dw_ = jnp.where(m1, dw1, ctrace["dw"])
        ct_ = jnp.where(m1, ct1, ctrace["counter"])
        w2, c2, dw2, ct2 = rstdp_visit(cw, c_, dw_, ct_, delta_c,
                                       dopamine, rparams)
        m2 = cm & (visits >= 2.0)
        cw = jnp.where(m2, w2, cw)
        ctrace = dict(c=jnp.where(m2, c2, c_), dw=jnp.where(m2, dw2, dw_),
                      counter=jnp.where(m2, ct2, ct_))
        # plain STDP on unmodulated connecting edges: spiking plastic
        # endpoints + modulated-endpoint sweeps onto plain lattices
        count_c = (trig_src + trig_dst
                   + pre_mod * self_plain + self_mod * pre_plain)
        pre_c = {"last_firing_time": lft_pre, "is_spiking": spk_pre > 0}
        post_c = {"last_firing_time": lft_dst, "is_spiking": spk}
        w_plain = plasticity_cls.apply_visits(cw, pre_c, post_c, pparams,
                                              count_c)
        conn_w = jnp.where(cm & (mod_edge == 0.0), w_plain, cw)

        clock = clock + 1
        ys = readout.readout(s, shape) if readout is not None else ()
        return (s, garrs, itrace, conn_w, ctrace, dopamine, clock), ys

    def body(state, garrs, itrace, conn_w, ctrace, conn_aux, flags,
             dopamine, clock, rewards, rparams, pparams):
        s = {k: v[0] for k, v in state.items()}
        garrs = {k: v[0] for k, v in garrs.items()}
        itrace = {k: v[0] for k, v in itrace.items()}
        conn_w = conn_w[0]
        ctrace = {k: v[0] for k, v in ctrace.items()}
        conn_aux = {k: v[0] for k, v in conn_aux.items()}
        fl = tuple(flags[0, i] for i in range(6))
        step = functools.partial(one_step, rparams, pparams, fl, conn_aux)
        (s, garrs, itrace, conn_w, ctrace, dopamine, clock), ys = \
            jax.lax.scan(step, (s, garrs, itrace, conn_w, ctrace, dopamine,
                                clock), rewards, length=length,
                         unroll=unroll)
        out = ({k: v[None] for k, v in s.items()},
               {k: v[None] for k, v in garrs.items()},
               {k: v[None] for k, v in itrace.items()},
               conn_w[None], {k: v[None] for k, v in ctrace.items()},
               dopamine)
        if readout is not None:
            ys = ys[:, None]
        return out + (ys,)

    stage = P(axis)
    rep = P()
    out_ys = P(None, axis) if readout is not None else rep
    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(stage, stage, stage, stage, stage, stage, stage, rep,
                  rep, rep, rep, rep),
        out_specs=(stage, stage, stage, stage, stage, rep, out_ys))
    return jax.jit(mapped, donate_argnums=(0, 1, 2, 3, 4))


def run_pipelined_with_reward(net, reward, iterations, mesh=None,
                              order=None, axis="pp", with_reward=True):
    """Run a chain-topology RewardModulatedLatticeNetwork as one SPMD
    pipeline (one lattice per device) and write state, weights, traces and
    dopamine back exactly as `run_lattices_with_reward` would."""
    net._ship_states()  # lazy-populate states ship before consumption
    order, all_lat = _reward_chain_order(net, order)
    lattices = [all_lat[i] for i in order]
    S = len(lattices)
    if mesh is None:
        mesh = make_pipeline_mesh(S, axis=axis)
    if mesh.devices.size != S:
        raise LatticeNetworkError(
            f"mesh has {mesh.devices.size} devices for {S} stages")
    axis = mesh.axis_names[0]
    shape0 = (lattices[0].rows, lattices[0].cols)
    for lat in lattices:
        if (lat.rows, lat.cols) != shape0:
            raise LatticeNetworkError(
                "pipelined stages must share (rows, cols)")

    model = lattices[0].model
    plasticity = net._plasticity()
    modulator = net.reward_modulator
    skip_nt = not any(bool(jnp.any(l.state["nt$mask"])) for l in lattices)

    hist_flags = {bool(l.update_grid_history) for l in lattices}
    if hist_flags == {True}:
        sigs = {_freeze(l.grid_history) for l in lattices}
        if len(sigs) != 1:
            raise LatticeNetworkError(
                "pipelined stages must share one grid-history kind")
        hist_sig = next(iter(sigs))
    elif hist_flags == {False}:
        hist_sig = None
    else:
        raise LatticeNetworkError(
            "grid history must be enabled on all stages or none")

    graph_kind, graph_static, garrs = _stack_graphs(lattices, mesh, axis)
    states = _stack_state(lattices, mesh, axis)
    itrace = _stack_traces(lattices, mesh, axis)
    conn = _stack_reward_connections(net, order, lattices, mesh, axis)
    conn_w = conn.pop("w")
    ctrace = {k: conn.pop(k) for k in ("c", "dw", "counter")}
    conn_aux = conn   # mask + in_deg + modulated: reused across chunks

    def _flag_row(k, lat):
        is_reward = order[k] in net.reward_modulated_lattices
        mod = float(is_reward and bool(lat.do_modulation))
        plain = float(not is_reward)
        plast = float((not is_reward) and bool(lat.do_plasticity))
        return mod, plain, plast

    rows = []
    for k, lat in enumerate(lattices):
        self_f = _flag_row(k, lat)
        pre_f = _flag_row(k - 1, lattices[k - 1]) if k else (0.0, 0.0, 0.0)
        rows.append(list(self_f) + list(pre_f))
    flags = jax.device_put(np.asarray(rows, np.float32),
                           NamedSharding(mesh, P(axis, None)))
    rparams = {k: jnp.float32(v) for k, v in modulator.params.items()}
    pparams = {k: jnp.float32(v) for k, v in plasticity.params.items()}

    rewards_all = jnp.broadcast_to(
        jnp.asarray(reward, jnp.float32), (int(iterations),))
    dopamine = jnp.float32(net.dopamine)

    chunk_len = net._history_chunk() if hist_sig is not None \
        else int(iterations)
    off = 0
    hist_parts = []
    while off < int(iterations):
        length = min(int(iterations) - off, chunk_len)
        runner = _build_reward_pipeline_runner(
            mesh, axis, model, graph_kind, graph_static,
            bool(net.electrical_synapse), bool(net.chemical_synapse),
            type(plasticity), bool(with_reward), skip_nt, hist_sig,
            shape0, S, length,
            resolve_unroll(getattr(net, "scan_unroll", None)))
        (states, garrs, itrace, conn_w, ctrace, dopamine, ys) = runner(
            states, garrs, itrace, conn_w, ctrace, conn_aux, flags,
            dopamine, jnp.int32(net.internal_clock),
            rewards_all[off:off + length], rparams, pparams)
        net.internal_clock += length
        off += length
        if hist_sig is not None:
            hist_parts.append(np.asarray(ys))
    net.dopamine = float(dopamine)

    # ---- write back per stage ----
    from ..utils.transfer import device_put_state
    host_state = {k: np.asarray(v) for k, v in states.items()}
    host_g = {k: np.asarray(v) for k, v in garrs.items()}
    host_it = {k: np.asarray(v) for k, v in itrace.items()}
    host_cw = np.asarray(conn_w)
    host_ct = {k: np.asarray(v) for k, v in ctrace.items()}

    for s_idx, lat in enumerate(lattices):
        lat.state = device_put_state(
            {k: v[s_idx] for k, v in host_state.items()})
        if graph_kind == "stencil":
            lat.graph = StencilGraph(
                graph_static, jax.device_put(host_g["weights"][s_idx]),
                jax.device_put(host_g["mask"][s_idx]),
                jax.device_put(host_g["in_deg"][s_idx]))
        else:
            lat.graph = DenseGraph(jax.device_put(host_g["weights"][s_idx]),
                                   jax.device_put(host_g["mask"][s_idx]))
        if getattr(lat, "trace", None) is not None:
            lat.trace = {k: jax.device_put(v[s_idx])
                         for k, v in host_it.items()}
            lat.dopamine = net.dopamine
        lat.internal_clock = net.internal_clock
    for s_idx in range(1, S):
        link = (order[s_idx - 1], order[s_idx])
        if link in net.connections:
            src, dst, _old = net.connections[link]
            net.connections[link] = (src, dst,
                                     host_cw[s_idx][np.asarray(dst)])
        elif link in net.reward_connections:
            src, dst, _w, _c, _dw, _ct = net.reward_connections[link]
            d = np.asarray(dst)
            net.reward_connections[link] = (
                src, dst, host_cw[s_idx][d], host_ct["c"][s_idx][d],
                host_ct["dw"][s_idx][d], host_ct["counter"][s_idx][d])
    net._conn_version += 1
    if hist_sig is not None and hist_parts:
        hist = np.concatenate(hist_parts)
        for s_idx, lat in enumerate(lattices):
            lat.grid_history.extend(hist[:, s_idx])
    return net
