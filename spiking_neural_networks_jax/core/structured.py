"""Structure-preserving network runner.

The flat runner (`core/network.py`) lowers every network to one global COO
edge list — simple, but bound by its scatters and gathers.  This runner
keeps the
network's algebraic structure instead: the step is a SUM OF STRUCTURED
OPERATORS —

* intra-lattice synapses keep their native graph backend (a StencilGraph
  stays a fused shifted-add stencil; a DenseGraph stays a matvec);
* inter-lattice connections are classified: one-to-one -> elementwise
  vector ops; small blocks -> dense (pre.n, post.n) matvecs; irregular ->
  per-block segment_sum fallback;
* per-lattice neuron states never get concatenated — each lattice steps on
  its own arrays and XLA fuses the whole network step into one program.

Semantics are identical to the flat runner (two-phase step, in-degree
averaging across ALL incoming components, deferred plasticity with
per-spiking-plastic-endpoint counts, clock sync, spike trains last); the
equivalence is tested directly against the flat path.

Enabled via ``LatticeNetwork.structured = True`` (the default); reward-
modulated networks have their own structure-preserving runner built on
these operators (`core/reward_structured.py`).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..models.base import get_neurotransmitter_concentrations
from ..models.spike_train import refractoriness_effect
from ..ops.graph import HIGHEST, DenseGraph
from .lattice import _freeze, resolve_unroll


# ---------------------------------------------------------------------------
# Connection operators
# ---------------------------------------------------------------------------


class OneToOne:
    """src[k] == dst[k] for every edge: elementwise connection.

    Host-side builder; the device-side data travels as the dynamic ``aux``
    dict (mask, in_deg) + the weight vector."""

    kind = "one2one"

    def __init__(self, src, dst, w, n):
        self.dst_host = dst
        wv = np.zeros(n, np.float32)
        mv = np.zeros(n, bool)
        np.add.at(wv, dst, w)   # duplicate (src, dst) edges sum, like the
        mv[dst] = True          # flat runner's segment_sum
        self.w0 = jnp.asarray(wv)
        self.aux = dict(mask=jax.device_put(mv),
                        in_deg=jnp.asarray(mv.astype(np.float32)))

    def extract(self, w):
        return np.asarray(w)[self.dst_host]

    def place(self, vals, dtype=np.float32):
        """Scatter flat per-edge values into this op's layout."""
        out = np.zeros(self.w0.shape, dtype)
        out[self.dst_host] = vals
        return jnp.asarray(out)


class EmptyBlock:
    """A connection with no edges: zero contribution, O(n_post) state.
    (The dense fallback would allocate (n_pre, n_post) — 256 GiB for an
    empty predicate between two 512x512 lattices.)"""

    kind = "empty"

    def __init__(self, n_post):
        self.w0 = jnp.zeros((0,), jnp.float32)
        self.aux = dict(in_deg=jnp.zeros((n_post,), jnp.float32))

    def extract(self, w):
        return np.zeros(0, np.float32)

    def place(self, vals, dtype=np.float32):
        return jnp.zeros((0,), dtype)


class DenseBlock:
    """Small irregular connection as a dense (n_pre, n_post) block."""

    kind = "dense"

    def __init__(self, src, dst, w, n_pre, n_post):
        wv = np.zeros((n_pre, n_post), np.float32)
        mv = np.zeros((n_pre, n_post), bool)
        np.add.at(wv, (src, dst), w)  # duplicates sum (flat segment_sum)
        mv[src, dst] = True
        self.src_host, self.dst_host = src, dst
        self.w0 = jnp.asarray(wv)
        self.aux = dict(mask=jax.device_put(mv),
                        in_deg=jnp.asarray(mv.sum(axis=0).astype(np.float32)))

    def extract(self, w):
        return np.asarray(w)[self.src_host, self.dst_host]

    def place(self, vals, dtype=np.float32):
        out = np.zeros(self.w0.shape, dtype)
        out[self.src_host, self.dst_host] = vals
        return jnp.asarray(out)


class PaddedBlock:
    """Low-in-degree connection as a (n_post, K) gather: idx/w per incoming
    slot.  Pure takes, no scatter — weights live in the padded layout so
    plasticity is (n_post, K) elementwise too."""

    kind = "padded"
    MAX_K = 16

    def __init__(self, src, dst, w, n_pre, n_post):
        counts = np.zeros(n_post, np.int64)
        np.add.at(counts, dst, 1)
        k_max = max(int(counts.max()), 1)
        idx = np.zeros((n_post, k_max), np.int32)
        wv = np.zeros((n_post, k_max), np.float32)
        mv = np.zeros((n_post, k_max), bool)
        slot = np.zeros(n_post, np.int64)
        self.edge_slots = np.empty(len(src), np.int64)  # flat (j*K + k)
        for e, (i, j) in enumerate(zip(src, dst)):
            k = slot[j]
            idx[j, k] = i
            wv[j, k] = w[e]
            mv[j, k] = True
            self.edge_slots[e] = j * k_max + k
            slot[j] += 1
        self.w0 = jnp.asarray(wv)
        self.aux = dict(mask=jax.device_put(mv),
                        idx=jnp.asarray(idx),
                        in_deg=jnp.asarray(counts.astype(np.float32)))

    def extract(self, w):
        return np.asarray(w).reshape(-1)[self.edge_slots]

    def place(self, vals, dtype=np.float32):
        out = np.zeros(self.w0.shape, dtype).reshape(-1)
        out[self.edge_slots] = vals
        return jnp.asarray(out.reshape(self.w0.shape))


class ResampleBlock:
    """Strided grid-to-grid connection — pooling, upsampling, and shifted
    same-size projections — detected from the COO edge list.

    For post position (r, c) the presynaptic sources are
    ``pre(f(r) + dr, f(c) + dc)`` over a small static tap set, where f is
    ``r * stride`` (downsampling) or ``r // factor`` (upsampling) per axis.
    Weights live as (n_taps, R2, C2) planes like a StencilGraph; the gather
    is n_taps strided slices / broadcast-repeats — NO index gathers.
    """

    kind = "resample"
    MAX_TAPS = 64

    def __init__(self, src, dst, w, shapes, fr, fc, taps, dr, dc):
        R1, C1, R2, C2 = shapes
        self.static = (R1, C1, R2, C2, int(fr), int(fc),
                       tuple((int(a), int(b)) for a, b in taps))
        # the runner dispatches on `kind`, a static hashable: carry the
        # shape/stride/tap config inside it
        self.kind = ("resample",) + self.static
        tap_index = {(int(a), int(b)): t for t, (a, b) in enumerate(taps)}
        n_taps = len(taps)
        tr, tc = dst // C2, dst % C2
        ti = np.array([tap_index[(int(a), int(b))] for a, b in zip(dr, dc)])
        wv = np.zeros((n_taps, R2, C2), np.float32)
        mv = np.zeros((n_taps, R2, C2), bool)
        np.add.at(wv, (ti, tr, tc), w)  # duplicates sum (flat segment_sum)
        mv[ti, tr, tc] = True
        self._edge_idx = (ti, tr, tc)
        self.w0 = jnp.asarray(wv)
        self.aux = dict(mask=jax.device_put(mv),
                        in_deg=jnp.asarray(
                            mv.sum(axis=0).reshape(-1).astype(np.float32)))

    def extract(self, w):
        ti, tr, tc = self._edge_idx
        return np.asarray(w)[ti, tr, tc]

    def place(self, vals, dtype=np.float32):
        ti, tr, tc = self._edge_idx
        out = np.zeros(self.w0.shape, dtype)
        out[ti, tr, tc] = vals
        return jnp.asarray(out)


def _detect_resample(src, dst, n_pre, n_post, pre_shape, post_shape,
                     max_taps=ResampleBlock.MAX_TAPS):
    """Try to express the edge list as a strided/up-sampled tap set."""
    if pre_shape is None or post_shape is None or len(src) == 0:
        return None
    R1, C1 = pre_shape
    R2, C2 = post_shape
    if R1 * C1 != n_pre or R2 * C2 != n_post or not (R1 and C1 and R2 and C2):
        return None

    def factor(n1, n2):
        if n1 % n2 == 0:
            return n1 // n2       # positive: down-stride
        if n2 % n1 == 0:
            return -(n2 // n1)    # negative: up-repeat factor
        return None

    fr, fc = factor(R1, R2), factor(C1, C2)
    if fr is None or fc is None:
        return None
    sr, sc = src // C1, src % C1
    tr, tc = dst // C2, dst % C2
    dr = sr - (tr * fr if fr > 0 else tr // -fr)
    dc = sc - (tc * fc if fc > 0 else tc // -fc)
    taps = np.unique(np.stack([dr, dc], axis=1), axis=0)
    if len(taps) > max_taps:
        return None
    # profitability: the plane stack touches n_taps * n_post entries per
    # gathered field every step; scattered edge sets that technically fit a
    # tap decomposition (e.g. a few random edges between same-size grids)
    # would pay that full-plane traffic for almost-empty planes — cap the
    # plane-to-edge blowup instead of silently regressing vs padded/dense
    if len(taps) * n_post > 64 * len(src):
        return None
    return fr, fc, taps, dr, dc


def _resample_pad(static):
    (R1, C1, R2, C2, fr, fc, taps) = static
    pr = max((abs(t[0]) for t in taps), default=0)
    pc = max((abs(t[1]) for t in taps), default=0)
    return pr, pc


def _resample_planes(static, x):
    """Pre-grid values x (n_pre, ...) -> per-tap post-aligned planes
    (n_taps, R2, C2, ...) using only pads, strided slices, and broadcasts."""
    (R1, C1, R2, C2, fr, fc, taps) = static
    pr, pc = _resample_pad(static)
    trailing = x.shape[1:]
    xg = x.reshape((R1, C1) + trailing)
    pads = ((pr, pr), (pc, pc)) + ((0, 0),) * len(trailing)
    xp = jnp.pad(xg, pads)

    def tap_plane(dr, dc):
        # rows
        if fr > 0:
            y = jax.lax.slice_in_dim(xp, pr + dr, pr + dr + fr * (R2 - 1) + 1,
                                     stride=fr, axis=0)
        else:
            k = -fr
            y = jax.lax.slice_in_dim(xp, pr + dr, pr + dr + R1, axis=0)
            y = jnp.broadcast_to(y[:, None], (R1, k) + y.shape[1:])
            y = y.reshape((R2,) + y.shape[2:])
        # cols
        if fc > 0:
            y = jax.lax.slice_in_dim(y, pc + dc, pc + dc + fc * (C2 - 1) + 1,
                                     stride=fc, axis=1)
        else:
            k = -fc
            y = jax.lax.slice_in_dim(y, pc + dc, pc + dc + C1, axis=1)
            y = jnp.broadcast_to(y[:, :, None, ...],
                                 y.shape[:2] + (k,) + y.shape[2:])
            y = y.reshape((R2, C2) + trailing)
        return y

    return jnp.stack([tap_plane(dr, dc) for dr, dc in taps])


PADDED_MIN_ENTRIES = 1_000_000           # plastic blocks: padded above this
DENSE_MAX_ENTRIES = 32 * 1024 * 1024     # static blocks: dense up to 128MB


def classify_connection(src, dst, w, n_pre, n_post, plastic=True,
                        pre_shape=None, post_shape=None):
    if len(src) == 0:
        return EmptyBlock(n_post)
    if len(src) <= n_post and n_pre == n_post and (src == dst).all():
        return OneToOne(src, dst, w, n_post)
    res = _detect_resample(src, dst, n_pre, n_post, pre_shape, post_shape)
    if res is not None:
        fr, fc, taps, dr, dc = res
        return ResampleBlock(src, dst, w,
                             pre_shape + post_shape, fr, fc, taps, dr, dc)
    if len(src):
        counts = np.zeros(n_post, np.int64)
        np.add.at(counts, dst, 1)
        # STATIC low-K blocks go dense up to the memory cap: one matvec in
        # place of (n_post, K) scalar gathers (the plan cache keeps the
        # matrix device-resident; not yet measured on a GPU).  PLASTIC
        # blocks stay padded above 1M entries: their weights change every
        # step, and the dense layout would pull the full (n_pre, n_post)
        # matrix back to host after every run on top of the dense edge
        # update
        threshold = PADDED_MIN_ENTRIES if plastic else DENSE_MAX_ENTRIES
        if counts.max() <= PaddedBlock.MAX_K and n_pre * n_post > threshold:
            return PaddedBlock(src, dst, w, n_pre, n_post)
        if n_pre * n_post > DENSE_MAX_ENTRIES:
            # a dense block here would be gigabytes; the padded layout is
            # bounded at (n_post, max in-degree) regardless of MAX_K
            return PaddedBlock(src, dst, w, n_pre, n_post)
    return DenseBlock(src, dst, w, n_pre, n_post)


# kind-dispatched device-side connection ops (aux is a dynamic pytree)

def _conn_gather(kind, aux, w, a_src, sub_src, v_post):
    if kind == "empty":
        return jnp.zeros_like(v_post)
    if kind == "one2one":
        return jnp.where(aux["mask"], w * (a_src - sub_src * v_post), 0.0)
    if isinstance(kind, tuple):  # ("resample", *static)
        static = kind[1:]
        R2, C2 = static[2], static[3]
        pair = _resample_planes(static, jnp.stack([a_src, sub_src], axis=-1))
        a, sub = pair[..., 0], pair[..., 1]       # (n_taps, R2, C2)
        contrib = w * (a - sub * v_post.reshape(1, R2, C2))
        return jnp.sum(contrib, axis=0).reshape(-1)
    if kind == "padded":
        # one gather for both fields instead of two scalar takes
        pair = jnp.stack([a_src, sub_src], axis=-1)[aux["idx"]]
        a, sub = pair[..., 0], pair[..., 1]         # (n_post, K)
        contrib = jnp.where(aux["mask"],
                            w * (a - sub * v_post[:, None]), 0.0)
        return jnp.sum(contrib, axis=1)
    return (jnp.matmul(a_src, w, precision=HIGHEST)
            - v_post * jnp.matmul(sub_src, w, precision=HIGHEST))


def _conn_gather_chemical(kind, aux, w, t_src, m_src):
    if kind == "empty":
        n_post = aux["in_deg"].shape[0]
        z = jnp.zeros((n_post, t_src.shape[-1]), jnp.float32)
        return z, z
    if kind == "one2one":
        sums = jnp.where(aux["mask"][:, None],
                         w[:, None] * t_src * m_src, 0.0)
        cnts = jnp.where(aux["mask"][:, None], m_src, 0.0)
        return sums, cnts
    if isinstance(kind, tuple):  # ("resample", *static)
        static = kind[1:]
        T = t_src.shape[-1]
        both = _resample_planes(static,
                                jnp.concatenate([t_src * m_src, m_src],
                                                axis=-1))
        tm, mm = both[..., :T], both[..., T:]     # (n_taps, R2, C2, T)
        gate = aux["mask"][..., None]
        sums = jnp.sum(jnp.where(gate, w[..., None] * tm, 0.0), axis=0)
        cnts = jnp.sum(jnp.where(gate, mm, 0.0), axis=0)
        return sums.reshape(-1, T), cnts.reshape(-1, T)
    if kind == "padded":
        # one fused gather: concat weighted concentrations and validity
        # masks along the T axis, take once, split after
        T = t_src.shape[-1]
        both = jnp.concatenate([t_src * m_src, m_src], axis=-1)[aux["idx"]]
        tm, mm = both[..., :T], both[..., T:]       # (n_post, K, T)
        gate = aux["mask"][:, :, None]
        sums = jnp.sum(jnp.where(gate, w[:, :, None] * tm, 0.0), axis=1)
        cnts = jnp.sum(jnp.where(gate, mm, 0.0), axis=1)
        return sums, cnts
    sums = jnp.matmul(w.T, t_src * m_src, precision=HIGHEST)
    cnts = jnp.matmul(aux["mask"].astype(jnp.float32).T, m_src,
                      precision=HIGHEST)
    return sums, cnts


def _edge_layout(kind, aux, pre_vals, post_vals):
    """Broadcast per-node value dicts into the connection op's edge layout.

    For the padded kind the per-field takes fuse into ONE gather; f32
    holds last_firing_time exactly up to 2^24 steps, beyond which STDP time
    diffs round to +-2 steps — irrelevant at tau ~ 4.5."""
    if kind == "one2one":
        return dict(pre_vals), dict(post_vals)
    if isinstance(kind, tuple):  # ("resample", *static)
        static = kind[1:]
        R2, C2 = static[2], static[3]
        keys = list(pre_vals)
        stacked = _resample_planes(
            static, jnp.stack([pre_vals[k].astype(jnp.float32)
                               for k in keys], axis=-1))
        pre = {k: stacked[..., f] for f, k in enumerate(keys)}
        post = {k: v.reshape(1, R2, C2) for k, v in post_vals.items()}
        return pre, post
    if kind == "padded":
        keys = list(pre_vals)
        stacked = jnp.stack([pre_vals[k].astype(jnp.float32) for k in keys],
                            axis=-1)[aux["idx"]]    # (n_post, K, F)
        pre = {k: stacked[..., f] for f, k in enumerate(keys)}
        post = {k: v[:, None] for k, v in post_vals.items()}
        return pre, post
    pre = {k: v[:, None] for k, v in pre_vals.items()}
    post = {k: v[None, :] for k, v in post_vals.items()}
    return pre, post


def _conn_edge_update(kind, aux, w, delta_fn, pre_vals, post_vals):
    if kind == "empty":
        return w
    pre, post = _edge_layout(kind, aux, pre_vals, post_vals)
    dw = delta_fn(w, pre, post)
    return jnp.where(aux["mask"], w + dw, w)


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------


def compile_structured(net):
    lat_ids = sorted(net.lattices)
    st_ids = sorted(net.spike_train_lattices)
    conns = []
    for (pre_id, post_id), (src, dst, w) in sorted(net.connections.items()):
        pre = net.lattices.get(pre_id) or net.spike_train_lattices.get(pre_id)
        post = net.lattices[post_id]
        pre_is_st = pre_id in net.spike_train_lattices
        plastic = bool(post.do_plasticity) or (
            not pre_is_st and bool(pre.do_plasticity))
        op = classify_connection(np.asarray(src), np.asarray(dst),
                                 np.asarray(w), pre.n, post.n, plastic,
                                 pre_shape=(pre.rows, pre.cols),
                                 post_shape=(post.rows, post.cols))
        conns.append(dict(pre=pre_id, post=post_id, op=op,
                          pre_is_st=pre_is_st, plastic=plastic,
                          key=(pre_id, post_id)))
    return dict(lat_ids=lat_ids, st_ids=st_ids, conns=conns)


def run_structured(net, iterations, nt_flags=None, sink=None):
    # the compiled plan (connection ops with device-resident aux + weights)
    # is cached against the network's connection version: repeated
    # run_lattices calls skip host-side op construction AND the
    # host<->device weight round trip (which costs ~0.6s/call for
    # dense-block matrices)
    #
    # ``nt_flags`` / ``sink``: host pulls of CHUNKED runs
    # (network.run_lattices).  The nt-mask pull is invariant across
    # chunks (the step never writes nt$mask), so the caller pulls it once
    # and passes it in; with ``sink`` (a dict) the per-chunk host pulls —
    # history ys, plastic-weight mirrors — are DEFERRED: device handles
    # are appended to the sink and `flush_structured_sink` makes ONE
    # jax.device_get for the whole run.
    plan = resolve_structured_plan(net)
    lat_ids, st_ids, conns = plan["lat_ids"], plan["st_ids"], plan["conns"]
    lattices = [net.lattices[i] for i in lat_ids]
    sts = [net.spike_train_lattices[i] for i in st_ids]

    model = lattices[0].model
    st_model = sts[0].model if sts else None
    plasticity = net._plasticity()
    do_plast = tuple(bool(l.do_plasticity) for l in lattices)
    if nt_flags is None:
        nt_flags = structured_nt_flags(net)
    skip_nt = not lattices or not any(bool(f) for f in nt_flags)
    hist = tuple(
        (i, l.grid_history.kind, _freeze(l.grid_history), (l.rows, l.cols))
        for i, l in zip(lat_ids, lattices) if l.update_grid_history)
    st_hist = tuple(
        (i, s.grid_history.kind, _freeze(s.grid_history), (s.rows, s.cols))
        for i, s in zip(st_ids, sts) if s.update_grid_history)
    # per-lattice graph (weight) histories (lattice.update_graph_history,
    # updated inside the network step in the reference, mod.rs:2443)
    ghist = tuple(i for i, l in zip(lat_ids, lattices)
                  if getattr(l, "update_graph_history", False))

    conn_meta = tuple(
        (c["pre"], c["post"], c["op"].kind, c["pre_is_st"]) for c in conns)
    graph_types = tuple(type(l.graph) for l in lattices)

    runner = _build_structured_runner(
        model, st_model, tuple(lat_ids), tuple(st_ids), conn_meta,
        graph_types, net.electrical_synapse, net.chemical_synapse,
        do_plast, type(plasticity), skip_nt, hist, st_hist,
        int(iterations), ghist,
        resolve_unroll(net.scan_unroll))

    states = tuple(l.state for l in lattices)
    st_states = tuple(s.state for s in sts)
    graphs = tuple(l.graph for l in lattices)
    conn_ws = tuple(c["op"].w0 for c in conns)
    conn_aux = tuple(c["op"].aux for c in conns)
    pparams = {k: jnp.float32(v) for k, v in plasticity.params.items()}

    out = runner(states, st_states, graphs, conn_ws, conn_aux, net.key,
                 jnp.int32(net.internal_clock), pparams)
    states, st_states, graphs, conn_ws, net.key, ys = out
    net.internal_clock += iterations

    for lat, state, graph in zip(lattices, states, graphs):
        lat.state = dict(state)
        lat.graph = graph
        lat.internal_clock = net.internal_clock
    for st, state in zip(sts, st_states):
        st.state = dict(state)
        st.internal_clock = net.internal_clock
    for c, w in zip(conns, conn_ws):
        # keep the weights device-resident for the next run — conn_ws is a
        # DONATED argument, so the previous array is invalidated and the
        # returned buffer must replace it even when the values are unchanged
        c["op"].w0 = w
    if sink is not None:
        # defer every host pull of this chunk; the host weight mirror only
        # needs the LAST chunk's values, so overwrite rather than append
        sink["hist"].append((hist, st_hist, ghist, ys))
        sink["last"] = (conns, conn_ws)
        return
    # batch the plastic-weight host pulls into one transfer
    pulled = jax.device_get([w for c, w in zip(conns, conn_ws)
                             if c["plastic"]])
    pi = 0
    for c, w in zip(conns, conn_ws):
        if not c["plastic"]:
            continue                     # weights unchanged: no host pull
        src, dst, _old = net.connections[c["key"]]
        # the host mirror stays the user-visible source of truth (writing it
        # here must not invalidate the plan cache, hence no version bump)
        net.connections[c["key"]] = (src, dst, c["op"].extract(pulled[pi]))
        pi += 1
    for (i, kind, sig, shape) in hist:
        net.lattices[i].grid_history.extend(ys[("lat", i)])
    for (i, kind, sig, shape) in st_hist:
        net.spike_train_lattices[i].grid_history.extend(ys[("st", i)])
    for i in ghist:
        net.lattices[i].graph_history.extend(np.asarray(ys[("gw", i)]))


def resolve_structured_plan(net):
    """The cached compiled plan, rebuilt when the connection version or
    the per-lattice plasticity flags changed."""
    plast_key = tuple(bool(net.lattices[i].do_plasticity)
                      for i in sorted(net.lattices))
    version = (getattr(net, "_conn_version", None), plast_key)
    cached = getattr(net, "_structured_plan", None)
    if cached is not None and cached[0] == version:
        return cached[1]
    plan = compile_structured(net)
    net._structured_plan = (version, plan)
    return plan


def structured_nt_flags(net):
    """One batched pull of every lattice's nt-mask flag, for chunked
    callers to pass into `run_structured` (invariant across chunks)."""
    plan = resolve_structured_plan(net)
    return jax.device_get(
        [jnp.any(net.lattices[i].state["nt$mask"])
         for i in plan["lat_ids"]])


def flush_structured_sink(net, sink):
    """ONE jax.device_get for every deferred per-chunk host pull of a
    chunked `run_structured` run: all chunks' history ys plus the last
    chunk's plastic-weight mirrors, then the same extends/updates the
    eager path does."""
    if not sink["hist"] and sink["last"] is None:
        return
    handles = []
    for (hist, st_hist, ghist, ys) in sink["hist"]:
        for (i, kind, sig, shape) in hist:
            handles.append(ys[("lat", i)])
        for (i, kind, sig, shape) in st_hist:
            handles.append(ys[("st", i)])
        for i in ghist:
            handles.append(ys[("gw", i)])
    conns, conn_ws = sink["last"]
    n_hist = len(handles)
    handles += [w for c, w in zip(conns, conn_ws) if c["plastic"]]
    pulled = jax.device_get(handles)
    hi = 0
    for (hist, st_hist, ghist, ys) in sink["hist"]:
        for (i, kind, sig, shape) in hist:
            net.lattices[i].grid_history.extend(pulled[hi])
            hi += 1
        for (i, kind, sig, shape) in st_hist:
            net.spike_train_lattices[i].grid_history.extend(pulled[hi])
            hi += 1
        for i in ghist:
            net.lattices[i].graph_history.extend(pulled[hi])
            hi += 1
    pi = n_hist
    for c in conns:
        if not c["plastic"]:
            continue
        src, dst, _old = net.connections[c["key"]]
        net.connections[c["key"]] = (src, dst, c["op"].extract(pulled[pi]))
        pi += 1


@functools.lru_cache(maxsize=None)
def _build_structured_runner(model, st_model, lat_ids, st_ids, conn_meta,
                             graph_types, electrical, chemical, do_plast,
                             plasticity_cls, skip_nt, hist, st_hist, length,
                             ghist=(), unroll=1):
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

    def one_step(pparams, carry, _):
        states, st_states, graphs, conn_ws, conn_aux, key, clock = carry
        states = list(states)
        st_states = list(st_states)
        graphs = list(graphs)
        conn_ws = list(conn_ws)

        # per-spike-train refractoriness effects (sources)
        effects = [refractoriness_effect(st_model.refractoriness, s, clock)
                   for s in st_states] if st_states else []

        # ---- Phase A (shared helper) ----
        inputs, chem_sums, chem_cnts = _phase_a(
            lat_ids, lat_index, st_index, states, st_states, graphs,
            [(m_, conn_aux[ci], conn_ws[ci])
             for ci, m_ in enumerate(conn_meta)],
            effects, electrical, chemical)

        # ---- Phase B: step every lattice ----
        states, spikes_list = _phase_b(model, states, inputs, chem_sums,
                                       chem_cnts, chemical, skip_nt, clock)

        # ---- deferred plasticity per structured component ----
        if any(do_plast):
            for k in range(len(lat_ids)):
                if do_plast[k]:
                    vals = {key_: states[k][key_]
                            for key_ in plasticity_cls.NODE_KEYS}
                    graphs[k] = graphs[k].apply_edge_update(
                        lambda w, pre, post: plasticity_cls.apply_visits(
                            w, pre, post, pparams,
                            pre["is_spiking"].astype(jnp.float32)
                            + post["is_spiking"].astype(jnp.float32)) - w,
                        vals, vals)
            for ci, (pre_id, post_id, kind, pre_is_st) in enumerate(conn_meta):
                post_k = lat_index[post_id]
                pre_plastic = (not pre_is_st
                               and do_plast[lat_index[pre_id]])
                post_plastic = do_plast[post_k]
                if not (pre_plastic or post_plastic):
                    continue
                if pre_is_st:
                    src_state = st_states[st_index[pre_id]]
                else:
                    src_state = states[lat_index[pre_id]]
                # spike-train states lack some plasticity node fields
                # (e.g. BCM's current_activity): zero-pad like the flat
                # runner's node_vals (network.py)
                zero = jnp.zeros_like(src_state["v"])
                pre_vals = {key_: src_state.get(key_, zero)
                            for key_ in plasticity_cls.NODE_KEYS}
                post_vals = {key_: states[post_k][key_]
                             for key_ in plasticity_cls.NODE_KEYS}

                def gated_delta(w, pre, post,
                                pre_plastic=pre_plastic,
                                post_plastic=post_plastic):
                    count = (pre["is_spiking"].astype(jnp.float32)
                             * (1.0 if pre_plastic else 0.0)
                             + post["is_spiking"].astype(jnp.float32)
                             * (1.0 if post_plastic else 0.0))
                    return plasticity_cls.apply_visits(
                        w, pre, post, pparams, count) - w

                conn_ws[ci] = _conn_edge_update(
                    conn_meta[ci][2], conn_aux[ci], conn_ws[ci],
                    gated_delta, pre_vals, post_vals)

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
                tuple(conn_ws), conn_aux, key, clock), ys

    def run(states, st_states, graphs, conn_ws, conn_aux, key, clock,
            pparams):
        step = functools.partial(one_step, pparams)
        carry, ys = jax.lax.scan(
            step, (states, st_states, graphs, conn_ws, conn_aux, key, clock),
            None, length=length, unroll=unroll)
        return carry[0], carry[1], carry[2], carry[3], carry[5], ys

    return jax.jit(run, donate_argnums=(0, 1, 2, 3))


def _phase_a(lat_ids, lat_index, st_index, states, st_states, graphs,
             conns, effects, electrical, chemical):
    """Per-lattice summed structured contributions (Phase A,
    neuron/mod.rs:2115-2212): the intra gather re-expanded to sums plus
    every connection op targeting the lattice.  ``conns`` is a sequence of
    ((pre_id, post_id, kind, pre_is_st), aux, w) triples; shared by the
    plain and reward structured runners."""
    inputs, chem_sums, chem_cnts = [], [], []
    for k, i in enumerate(lat_ids):
        s = states[k]
        total = jnp.zeros_like(s["v"])
        cnt = jnp.zeros_like(s["v"])
        csum = jnp.zeros_like(s["nt$t"]) if chemical else None
        ccnt = jnp.zeros_like(s["nt$t"]) if chemical else None

        # intra edges: native graph backend
        if electrical:
            g = graphs[k]
            total = total + g.gather_electrical(
                s["v"], jnp.ones_like(s["v"]), s["v"],
                jnp.ones_like(s["v"])) * jnp.maximum(g.in_degree(), 1.0)
            cnt = cnt + g.in_degree()
        if chemical:
            g = graphs[k]
            t, m = get_neurotransmitter_concentrations(s)
            t_in, valid = g.gather_chemical(t, m.astype(jnp.float32))
            # re-expand averages back to sums for cross-component merge
            gc = _chem_counts(g, m.astype(jnp.float32))
            csum = csum + t_in * jnp.maximum(gc, 1.0) * (gc > 0)
            ccnt = ccnt + gc

        # connection operators targeting this lattice
        for (pre_id, post_id, kind, pre_is_st), aux, w in conns:
            if post_id != i:
                continue
            if pre_is_st:
                a_src = effects[st_index[pre_id]]
                sub = jnp.zeros_like(a_src)
                src_state = st_states[st_index[pre_id]]
            else:
                src_state = states[lat_index[pre_id]]
                a_src = src_state["v"]
                sub = jnp.ones_like(a_src)
            if electrical:
                total = total + _conn_gather(kind, aux, w, a_src, sub,
                                             s["v"])
                cnt = cnt + aux["in_deg"]
            if chemical:
                t, m = get_neurotransmitter_concentrations(src_state)
                sums, cnts = _conn_gather_chemical(
                    kind, aux, w, t, m.astype(jnp.float32))
                csum = csum + sums
                ccnt = ccnt + cnts

        inputs.append(s["gap_conductance"] * total / jnp.maximum(cnt, 1.0)
                      if electrical else jnp.zeros_like(s["v"]))
        if chemical:
            chem_sums.append(csum)
            chem_cnts.append(ccnt)
    return inputs, chem_sums, chem_cnts


def _phase_b(model, states, inputs, chem_sums, chem_cnts, chemical, skip_nt,
             clock):
    """Step every lattice of a network (Phase B, neuron/mod.rs:2420-2444).

    A per-lattice loop.  Stepping the CONCATENATION of all lattice states
    in one model call is exact (the update is elementwise) but pays
    per-leaf concat/split copies and breaks carry-donation aliasing
    (slices of the concatenated output cannot alias the donated
    per-lattice carries); which wins on a GPU has not been measured."""
    out_states, spikes_list = [], []
    for k in range(len(states)):
        if chemical:
            t_in = chem_sums[k] / jnp.maximum(chem_cnts[k], 1.0)
            s, spk = model.step(states[k], inputs[k], t_in,
                                chem_cnts[k] > 0.0, skip_nt=skip_nt)
        else:
            s, spk = model.step(states[k], inputs[k], skip_nt=skip_nt)
        s["last_firing_time"] = jnp.where(spk, clock, s["last_firing_time"])
        out_states.append(s)
        spikes_list.append(spk)
    return out_states, spikes_list


def _chem_counts(graph, nt_mask_src):
    """Per-type incoming counts for an intra graph (to convert the averaged
    gather back into sums for cross-component merging)."""
    from ..ops.graph import DenseGraph, SparseGraph, StencilGraph
    if isinstance(graph, DenseGraph):
        return jnp.matmul(graph.mask.astype(jnp.float32).T, nt_mask_src,
                          precision=HIGHEST)
    if isinstance(graph, SparseGraph):
        return jax.ops.segment_sum(nt_mask_src[graph.src], graph.dst,
                                   num_segments=graph.n_post)
    rows, cols = graph.shape
    k = nt_mask_src.shape[-1]
    mp = graph._padded(nt_mask_src.reshape(rows, cols, k))
    cnts = jnp.zeros((rows, cols, k), jnp.float32)
    for o, (dr, dc) in enumerate(graph.offsets):
        em = graph.mask[o][:, :, None]
        cnts = cnts + em * graph._shifted(mp, dr, dc)
    return cnts.reshape(-1, k)
