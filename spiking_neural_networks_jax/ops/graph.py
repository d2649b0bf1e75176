"""Synaptic connectivity graphs and on-device input-gather ops.

JAX redesign of the reference's graph layer
(`reference/backend/src/graph/mod.rs`: `AdjacencyMatrix` :139,
`AdjacencyList` :974) and the per-neuron input gathers
(`reference/backend/src/neuron/mod.rs:702-846`).

Three device-resident representations, all registered as pytrees so they can
live in a `lax.scan` carry (plasticity mutates weights on-device):

* :class:`DenseGraph`   — (N_pre, N_post) weight + mask matrices.  The gather
  is a float32 matmul at ``highest`` precision (no TF32 on GPUs).  Right
  choice for small/densely connected lattices and a direct analog of the
  reference's `AdjacencyMatrix`.
* :class:`SparseGraph`  — COO edge list (src, dst, w) + `segment_sum`.  For
  large sparse topologies of arbitrary shape.
* :class:`StencilGraph` — per-neuron per-offset weights for translation-local
  connectivity on a (rows, cols) grid.  The gather is a handful of shifted
  fused multiply-adds: zero gathers, zero scatters — the speed-of-light
  layout for the reference's "connect within radius r" lattices.

Semantics preserved from the reference (neuron/mod.rs:710-729):

* electrical input to j = g_j * sum_i w_ij * (v_i - v_j) / max(indegree_j, 1)
  — note the *averaging* over presynaptic count.
* chemical input per type k = sum_i w_ij * t_ik / (count of presynaptic i
  that carry type k), with a validity flag when that count is zero
  (`aggregate_neurotransmitter_concentrations`,
  iterate_and_spike/mod.rs:2846-2866).

For mixed neuron/spike-train source populations (network case,
neuron/mod.rs:2115-2167) the electrical gather takes per-source values
``a_src`` and a per-source flag ``sub_v``: a neuron source contributes
``w * (v_src - v_post)`` (sub_v=1) while a spike-train source contributes
``w * effect_src`` (sub_v=0).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class


# float32 matmuls run at full precision: the default lets a GPU use TF32,
# which keeps ~3 decimal digits and breaks the golden tolerances
HIGHEST = jax.lax.Precision.HIGHEST


def _f32(x):
    return jnp.asarray(x, dtype=jnp.float32)


# ---------------------------------------------------------------------------
# Per-edge query/edit API (Graph trait, graph/mod.rs:42-72)
#
# `lookup_weight(src, dst)` -> float | None; `edit_weight(src, dst, w)` ->
# new graph (functional; `None` removes the edge); `get_incoming_
# connections(dst)` / `get_outgoing_connections(src)` -> set[int].  These
# are HOST-side conveniences (device pull per call) mirroring the
# reference's per-synapse access — simulation hot paths never use them.
# ---------------------------------------------------------------------------


def _check_node(graph, idx, n):
    if not (0 <= idx < n):
        from ..errors import GraphError
        raise GraphError(f"position {idx} not in graph (n={n})")


# ---------------------------------------------------------------------------
# Dense graph
# ---------------------------------------------------------------------------


@register_pytree_node_class
class DenseGraph:
    """Dense (N_pre, N_post) weight matrix; ``mask[i, j]`` marks edge i -> j."""

    def __init__(self, weights, mask):
        self.weights = weights
        self.mask = mask

    # -- pytree plumbing ----------------------------------------------------
    def tree_flatten(self):
        return (self.weights, self.mask), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- constructors -------------------------------------------------------
    @classmethod
    def empty(cls, n_pre, n_post=None):
        n_post = n_pre if n_post is None else n_post
        return cls(jnp.zeros((n_pre, n_post), jnp.float32),
                   jnp.zeros((n_pre, n_post), bool))

    @property
    def n_pre(self):
        return self.weights.shape[0]

    @property
    def n_post(self):
        return self.weights.shape[1]

    def in_degree(self):
        return jnp.sum(self.mask.astype(jnp.float32), axis=0)

    # -- gathers ------------------------------------------------------------
    def gather_electrical(self, a_src, sub_v, v_post, g_post):
        w = jnp.where(self.mask, self.weights, 0.0)
        # sum_i w_ij * a_i  and  sum_i w_ij * sub_i  (two matvecs)
        wa = jnp.matmul(a_src, w, precision=HIGHEST)
        wsub = jnp.matmul(sub_v, w, precision=HIGHEST)
        cnt = jnp.maximum(self.in_degree(), 1.0)
        return g_post * (wa - v_post * wsub) / cnt

    def gather_chemical(self, t_src, nt_mask_src):
        w = jnp.where(self.mask, self.weights, 0.0)
        sums = jnp.matmul(w.T, t_src * nt_mask_src,
                          precision=HIGHEST)                     # (N_post, K)
        cnts = jnp.matmul(self.mask.T.astype(jnp.float32), nt_mask_src,
                          precision=HIGHEST)                     # (N_post, K)
        t_in = sums / jnp.maximum(cnts, 1.0)
        return t_in, cnts > 0.0

    # -- plasticity ---------------------------------------------------------
    def edge_pre_post(self, pre_vals, post_vals):
        """Per-node value dicts broadcast to the edge plane (weights.shape)."""
        pre = {k: v[:, None] for k, v in pre_vals.items()}
        post = {k: v[None, :] for k, v in post_vals.items()}
        return pre, post

    @property
    def edge_mask(self):
        return self.mask

    def replace_weights(self, weights):
        return DenseGraph(weights, self.mask)

    # -- per-edge API (graph/mod.rs:42-72) -----------------------------------
    def lookup_weight(self, src, dst):
        _check_node(self, src, self.n_pre)
        _check_node(self, dst, self.n_post)
        if not bool(np.asarray(self.mask[src, dst])):
            return None
        return float(np.asarray(self.weights[src, dst]))

    def edit_weight(self, src, dst, w):
        _check_node(self, src, self.n_pre)
        _check_node(self, dst, self.n_post)
        weights = np.asarray(self.weights).copy()
        mask = np.asarray(self.mask).copy()
        if w is None:
            weights[src, dst] = 0.0
            mask[src, dst] = False
        else:
            weights[src, dst] = w
            mask[src, dst] = True
        return DenseGraph(jnp.asarray(weights), jax.device_put(mask))

    def get_incoming_connections(self, dst):
        _check_node(self, dst, self.n_post)
        return set(np.nonzero(np.asarray(self.mask[:, dst]))[0].tolist())

    def get_outgoing_connections(self, src):
        _check_node(self, src, self.n_pre)
        return set(np.nonzero(np.asarray(self.mask[src, :]))[0].tolist())

    def apply_edge_update(self, edge_dw, pre_vals, post_vals):
        """Apply ``edge_dw(w, pre, post) -> dw`` over all edges.

        ``pre_vals`` / ``post_vals`` are dicts of per-node (N,) arrays; they
        are broadcast to the (N_pre, N_post) edge plane.
        """
        pre, post = self.edge_pre_post(pre_vals, post_vals)
        dw = edge_dw(self.weights, pre, post)
        return DenseGraph(jnp.where(self.mask, self.weights + dw, self.weights),
                          self.mask)


# ---------------------------------------------------------------------------
# Sparse COO graph
# ---------------------------------------------------------------------------


@register_pytree_node_class
class SparseGraph:
    """COO edge list: ``src``, ``dst`` int32 (E,), ``weights`` f32 (E,).

    ``n_pre`` / ``n_post`` are static.  The reference's input averaging
    requires per-destination in-degree, precomputed as ``in_deg``.
    """

    def __init__(self, src, dst, weights, n_pre, n_post, in_deg=None):
        self.src = src
        self.dst = dst
        self.weights = weights
        self.n_pre = int(n_pre)
        self.n_post = int(n_post)
        if in_deg is None:
            in_deg = jax.ops.segment_sum(
                jnp.ones_like(weights), dst, num_segments=self.n_post)
        self.in_deg = in_deg

    def tree_flatten(self):
        return (self.src, self.dst, self.weights, self.in_deg), (self.n_pre, self.n_post)

    @classmethod
    def tree_unflatten(cls, aux, children):
        src, dst, w, in_deg = children
        return cls(src, dst, w, aux[0], aux[1], in_deg)

    @classmethod
    def from_arrays(cls, src, dst, weights, n_pre, n_post=None):
        n_post = n_pre if n_post is None else n_post
        order = np.argsort(np.asarray(dst), kind="stable")
        return cls(jnp.asarray(np.asarray(src)[order], jnp.int32),
                   jnp.asarray(np.asarray(dst)[order], jnp.int32),
                   _f32(np.asarray(weights)[order]), n_pre, n_post)

    @classmethod
    def empty(cls, n_pre, n_post=None):
        """Zero-edge graph — the O(1) default for a freshly populated
        lattice (a dense (N, N) default would allocate N^2 floats: 274 GB
        at 512x512)."""
        n_post = n_pre if n_post is None else n_post
        return cls(jnp.zeros(0, jnp.int32), jnp.zeros(0, jnp.int32),
                   jnp.zeros(0, jnp.float32), n_pre, n_post,
                   jnp.zeros(n_post, jnp.float32))

    def in_degree(self):
        return self.in_deg

    def gather_electrical(self, a_src, sub_v, v_post, g_post):
        contrib = self.weights * (a_src[self.src] - sub_v[self.src] * v_post[self.dst])
        summed = jax.ops.segment_sum(contrib, self.dst, num_segments=self.n_post)
        cnt = jnp.maximum(self.in_deg, 1.0)
        return g_post * summed / cnt

    def gather_chemical(self, t_src, nt_mask_src):
        vals = self.weights[:, None] * t_src[self.src] * nt_mask_src[self.src]
        sums = jax.ops.segment_sum(vals, self.dst, num_segments=self.n_post)
        cnts = jax.ops.segment_sum(nt_mask_src[self.src], self.dst,
                                   num_segments=self.n_post)
        t_in = sums / jnp.maximum(cnts, 1.0)
        return t_in, cnts > 0.0

    def edge_pre_post(self, pre_vals, post_vals):
        pre = {k: v[self.src] for k, v in pre_vals.items()}
        post = {k: v[self.dst] for k, v in post_vals.items()}
        return pre, post

    @property
    def edge_mask(self):
        return jnp.ones_like(self.weights, dtype=bool)

    def replace_weights(self, weights):
        return SparseGraph(self.src, self.dst, weights,
                           self.n_pre, self.n_post, self.in_deg)

    # -- per-edge API (graph/mod.rs:42-72) -----------------------------------
    def _edge_index(self, src, dst):
        hits = np.nonzero((np.asarray(self.src) == src)
                          & (np.asarray(self.dst) == dst))[0]
        return int(hits[0]) if len(hits) else None

    def lookup_weight(self, src, dst):
        _check_node(self, src, self.n_pre)
        _check_node(self, dst, self.n_post)
        e = self._edge_index(src, dst)
        return None if e is None else float(np.asarray(self.weights[e]))

    def edit_weight(self, src, dst, w):
        _check_node(self, src, self.n_pre)
        _check_node(self, dst, self.n_post)
        e = self._edge_index(src, dst)
        if w is None:
            if e is None:
                return self
            keep = np.ones(self.weights.shape[0], bool)
            keep[e] = False
            return SparseGraph.from_arrays(
                np.asarray(self.src)[keep], np.asarray(self.dst)[keep],
                np.asarray(self.weights)[keep], self.n_pre, self.n_post)
        if e is not None:
            weights = np.asarray(self.weights).copy()
            weights[e] = w
            return self.replace_weights(jnp.asarray(weights))
        return SparseGraph.from_arrays(
            np.append(np.asarray(self.src), src),
            np.append(np.asarray(self.dst), dst),
            np.append(np.asarray(self.weights), np.float32(w)),
            self.n_pre, self.n_post)

    def get_incoming_connections(self, dst):
        _check_node(self, dst, self.n_post)
        sel = np.asarray(self.dst) == dst
        return set(np.asarray(self.src)[sel].tolist())

    def get_outgoing_connections(self, src):
        _check_node(self, src, self.n_pre)
        sel = np.asarray(self.src) == src
        return set(np.asarray(self.dst)[sel].tolist())

    def apply_edge_update(self, edge_dw, pre_vals, post_vals):
        pre, post = self.edge_pre_post(pre_vals, post_vals)
        dw = edge_dw(self.weights, pre, post)
        return SparseGraph(self.src, self.dst, self.weights + dw,
                           self.n_pre, self.n_post, self.in_deg)


# ---------------------------------------------------------------------------
# Stencil graph (translation-local connectivity on a 2-D grid)
# ---------------------------------------------------------------------------


def radius_offsets(radius, include_self=False):
    """All (dr, dc) with Euclidean distance <= radius (the reference example's
    `connection_conditional`, backend/examples/lattice/main.rs:18-23)."""
    r = int(np.ceil(radius))
    out = []
    for dr in range(-r, r + 1):
        for dc in range(-r, r + 1):
            if not include_self and dr == 0 and dc == 0:
                continue
            if np.sqrt(dr * dr + dc * dc) <= radius:
                out.append((dr, dc))
    return tuple(out)


@register_pytree_node_class
class StencilGraph:
    """Local connectivity: dst (r, c) receives from src (r + dr, c + dc).

    ``weights``: (n_offsets, rows, cols) f32 — per-destination per-offset
    weight; ``mask`` same shape bool.  Out-of-grid offsets are masked at
    construction.  The gather is `n_offsets` shifted multiply-adds; XLA fuses
    them into one pass over the grid with no gather/scatter.
    """

    def __init__(self, offsets, weights, mask, in_deg=None):
        self.offsets = tuple(map(tuple, offsets))
        self.weights = weights
        self.mask = mask
        if in_deg is None:
            in_deg = jnp.sum(mask.astype(jnp.float32), axis=0)
        self.in_deg = in_deg

    def tree_flatten(self):
        return (self.weights, self.mask, self.in_deg), self.offsets

    @classmethod
    def tree_unflatten(cls, aux, children):
        w, m, d = children
        return cls(aux, w, m, d)

    @property
    def shape(self):
        return self.weights.shape[1:]

    @property
    def n_pre(self):
        r, c = self.shape
        return r * c

    n_post = n_pre

    @classmethod
    def build(cls, rows, cols, offsets, weight_fn=None, keep_prob=1.0, seed=0):
        """Construct local connectivity.

        ``weight_fn(dr, dc, rr, cc)`` -> weight array (vectorized over the
        destination grids rr, cc); default 1.  ``keep_prob`` drops edges
        i.i.d. (the reference example's 80%-chance connect).
        """
        offsets = tuple(map(tuple, offsets))
        n_off = len(offsets)
        w = np.zeros((n_off, rows, cols), np.float32)
        m = np.zeros((n_off, rows, cols), bool)
        rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        rng = np.random.default_rng(seed)
        for o, (dr, dc) in enumerate(offsets):
            sr, sc = rr + dr, cc + dc
            valid = (sr >= 0) & (sr < rows) & (sc >= 0) & (sc < cols)
            if keep_prob < 1.0:
                valid &= rng.random((rows, cols)) <= keep_prob
            if weight_fn is None:
                wo = np.ones((rows, cols), np.float32)
            else:
                wo = np.asarray(weight_fn(dr, dc, rr, cc), np.float32)
            w[o] = np.where(valid, wo, 0.0)
            m[o] = valid
        in_deg = jax.device_put(m.sum(axis=0).astype(np.float32))
        return cls(offsets, jax.device_put(w), jax.device_put(m), in_deg)

    def in_degree(self):
        return self.in_deg.reshape(-1)

    @property
    def _pad(self):
        """Static halo width covering every offset."""
        m = 0
        for dr, dc in self.offsets:
            m = max(m, abs(dr), abs(dc))
        return m

    def _padded(self, x, fill=0.0):
        """Zero-pad by the halo width.  Shifted reads become *static slices*
        of the padded array, which XLA fuses into the consumer."""
        p = self._pad
        pads = ((p, p), (p, p)) + ((0, 0),) * (x.ndim - 2)
        return jnp.pad(x, pads, constant_values=fill)

    def _shifted(self, padded, dr, dc):
        """padded view such that out[r, c] = x[r + dr, c + dc] (0 off-grid)."""
        p = self._pad
        rows, cols = self.shape
        return jax.lax.slice_in_dim(
            jax.lax.slice_in_dim(padded, p + dr, p + dr + rows, axis=0),
            p + dc, p + dc + cols, axis=1)

    def gather_electrical(self, a_src, sub_v, v_post, g_post):
        """All offsets in one fusion: the shifted (a, sub) planes are
        stacked and reduced over the offset axis.  On an H100 (400 W
        limit) this measured faster than chaining one multiply-add per
        offset at every size tried: 70.4k vs 65.9k steps/s at 512x512 and
        1,470 vs 1,440 at 4096x4096 (electrical Izhikevich), 65.1k vs
        60.9k at 128x128 (Hodgkin-Huxley + STDP, which also takes
        `apply_edge_update`'s batched form)."""
        rows, cols = self.shape
        v = v_post.reshape(rows, cols)
        pair = jnp.stack([a_src.reshape(rows, cols),
                          sub_v.reshape(rows, cols)], axis=-1)
        pp = self._padded(pair)
        planes = jnp.stack([self._shifted(pp, dr, dc)
                            for dr, dc in self.offsets])
        contrib = self.weights * (planes[..., 0] - planes[..., 1] * v)
        acc = jnp.sum(contrib, axis=0)
        cnt = jnp.maximum(self.in_deg, 1.0)
        out = g_post.reshape(rows, cols) * acc / cnt
        return out.reshape(-1)

    def gather_chemical(self, t_src, nt_mask_src):
        rows, cols = self.shape
        k = t_src.shape[-1]
        tp = self._padded(t_src.reshape(rows, cols, k))
        mp = self._padded(nt_mask_src.reshape(rows, cols, k))
        sums = jnp.zeros((rows, cols, k), jnp.float32)
        cnts = jnp.zeros((rows, cols, k), jnp.float32)
        for o, (dr, dc) in enumerate(self.offsets):
            w = self.weights[o][:, :, None]
            em = self.mask[o][:, :, None]
            sums = sums + w * self._shifted(tp, dr, dc) * self._shifted(mp, dr, dc)
            cnts = cnts + em * self._shifted(mp, dr, dc)
        t_in = sums / jnp.maximum(cnts, 1.0)
        return t_in.reshape(-1, k), (cnts > 0.0).reshape(-1, k)

    def edge_pre_post(self, pre_vals, post_vals):
        """Views broadcastable to the (n_offsets, rows, cols) weight array."""
        rows, cols = self.shape
        post = {k: v.reshape(rows, cols)[None] for k, v in post_vals.items()}
        pre = {}
        for k, v in pre_vals.items():
            p = self._padded(v.reshape(rows, cols))
            pre[k] = jnp.stack([self._shifted(p, dr, dc)
                                for (dr, dc) in self.offsets])
        return pre, post

    @property
    def edge_mask(self):
        return self.mask

    def replace_weights(self, weights):
        return StencilGraph(self.offsets, weights, self.mask, self.in_deg)

    # -- per-edge API (graph/mod.rs:42-72) -----------------------------------
    def _edge_slot(self, src, dst):
        rows, cols = self.shape
        dr = src // cols - dst // cols
        dc = src % cols - dst % cols
        try:
            o = self.offsets.index((int(dr), int(dc)))
        except ValueError:
            return None
        return (o, dst // cols, dst % cols)

    def lookup_weight(self, src, dst):
        _check_node(self, src, self.n_pre)
        _check_node(self, dst, self.n_post)
        slot = self._edge_slot(src, dst)
        if slot is None or not bool(np.asarray(self.mask[slot])):
            return None
        return float(np.asarray(self.weights[slot]))

    def edit_weight(self, src, dst, w):
        _check_node(self, src, self.n_pre)
        _check_node(self, dst, self.n_post)
        rows, cols = self.shape
        slot = self._edge_slot(src, dst)
        weights = np.asarray(self.weights)
        mask = np.asarray(self.mask)
        if slot is None:
            if w is None:
                return self
            # new offset support: append a plane
            dr = src // cols - dst // cols
            dc = src % cols - dst % cols
            offsets = self.offsets + ((int(dr), int(dc)),)
            weights = np.concatenate(
                [weights, np.zeros((1, rows, cols), np.float32)])
            mask = np.concatenate([mask, np.zeros((1, rows, cols), bool)])
            slot = (len(offsets) - 1, dst // cols, dst % cols)
        else:
            offsets = self.offsets
            weights = weights.copy()
            mask = mask.copy()
        if w is None:
            weights[slot] = 0.0
            mask[slot] = False
        else:
            weights[slot] = w
            mask[slot] = True
        return StencilGraph(offsets, jnp.asarray(weights),
                            jax.device_put(mask),
                            jnp.asarray(mask.sum(axis=0, dtype=np.float32)))

    def _connections_of(self, idx, incoming):
        rows, cols = self.shape
        r, c = idx // cols, idx % cols
        mask = np.asarray(self.mask)
        out = set()
        for o, (dr, dc) in enumerate(self.offsets):
            if incoming:
                sr, sc = r + dr, c + dc
                if 0 <= sr < rows and 0 <= sc < cols and mask[o, r, c]:
                    out.add(sr * cols + sc)
            else:
                # outgoing: idx is the source of dst (r-dr, c-dc)
                tr, tc = r - dr, c - dc
                if 0 <= tr < rows and 0 <= tc < cols and mask[o, tr, tc]:
                    out.add(tr * cols + tc)
        return out

    def get_incoming_connections(self, dst):
        _check_node(self, dst, self.n_post)
        return self._connections_of(dst, incoming=True)

    def get_outgoing_connections(self, src):
        _check_node(self, src, self.n_pre)
        return self._connections_of(src, incoming=False)

    def apply_edge_update(self, edge_dw, pre_vals, post_vals):
        """Batched over the offset axis: one (n_off, rows, cols)
        elementwise pass (see `gather_electrical` for the measurement)."""
        pre, post = self.edge_pre_post(pre_vals, post_vals)
        dw = edge_dw(self.weights, pre, post)
        return StencilGraph(self.offsets,
                            jnp.where(self.mask, self.weights + dw,
                                      self.weights),
                            self.mask, self.in_deg)


# ---------------------------------------------------------------------------
# Host-side builders mirroring Lattice::connect (neuron/mod.rs:1134-1157)
# ---------------------------------------------------------------------------


def positions(rows, cols):
    """All (r, c) grid positions, row-major (matches graph node ordering)."""
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    return np.stack([rr.reshape(-1), cc.reshape(-1)], axis=-1)


def connect_dense_host(rows, cols, connecting_conditional, weight_logic=None):
    """`connect_dense`'s host half: the (w, mask) NumPy pair, no device
    traffic.  Callers that may re-represent the graph (stencil
    decomposition) stay host-side until the final form is known and ship
    it once."""
    pos = positions(rows, cols)
    n = len(pos)
    mask = np.zeros((n, n), bool)
    w = np.zeros((n, n), np.float32)
    for i in range(n):
        pi = (int(pos[i, 0]), int(pos[i, 1]))
        for j in range(n):
            pj = (int(pos[j, 0]), int(pos[j, 1]))
            if connecting_conditional(pi, pj):
                mask[i, j] = True
                w[i, j] = 1.0 if weight_logic is None else weight_logic(pi, pj)
    return w, mask


def connect_dense(rows, cols, connecting_conditional, weight_logic=None):
    """Evaluate a pairwise predicate over all position pairs -> DenseGraph.

    The predicate / weight function take ((r1, c1), (r2, c2)) like the
    reference's `connect`.  O(N^2) host work — use for small lattices only;
    large lattices should use `StencilGraph.build` or explicit edge lists.
    """
    w, mask = connect_dense_host(rows, cols, connecting_conditional,
                                 weight_logic)
    from ..utils.transfer import device_put_state
    d = device_put_state({"w": w, "m": mask})
    return DenseGraph(d["w"], d["m"])


def dense_to_sparse(graph):
    mask = np.asarray(graph.mask)
    w = np.asarray(graph.weights)
    src, dst = np.nonzero(mask)
    return SparseGraph.from_arrays(src, dst, w[src, dst],
                                   graph.n_pre, graph.n_post)


def stencil_planes_host(w, mask, rows, cols, max_offsets=128):
    """`dense_to_stencil`'s host half on NumPy (w, mask): the
    (offsets, weight_planes, mask_planes) triple, or None when the offset
    support is too wide.  No device traffic."""
    if w.shape != (rows * cols, rows * cols):
        return None
    src, dst = np.nonzero(mask)
    if len(src) == 0:
        return None
    dr = src // cols - dst // cols
    dc = src % cols - dst % cols
    offsets = np.unique(np.stack([dr, dc], axis=1), axis=0)
    # wide support: n_off shifted adds would cost more than one matvec
    if len(offsets) > max_offsets or len(offsets) >= rows * cols // 2:
        return None
    index = {(int(a), int(b)): o for o, (a, b) in enumerate(offsets)}
    n_off = len(offsets)
    wp = np.zeros((n_off, rows, cols), np.float32)
    mp = np.zeros((n_off, rows, cols), bool)
    o_idx = np.array([index[(int(a), int(b))] for a, b in zip(dr, dc)])
    wp[o_idx, dst // cols, dst % cols] = w[src, dst]
    mp[o_idx, dst // cols, dst % cols] = True
    return tuple(map(tuple, offsets)), wp, mp


def connect_auto(rows, cols, connecting_conditional, weight_logic=None):
    """`connect`'s full pipeline with one device transfer: evaluate the
    pairwise predicate host-side, decompose into stencil planes host-side
    when the offset support is small, and ship only the final
    representation."""
    from ..utils.transfer import device_put_state
    w, mask = connect_dense_host(rows, cols, connecting_conditional,
                                 weight_logic)
    st = stencil_planes_host(w, mask, rows, cols)
    if st is None:
        d = device_put_state({"w": w, "m": mask})
        return DenseGraph(d["w"], d["m"])
    offsets, wp, mp = st
    d = device_put_state({"w": wp, "m": mp})
    return StencilGraph(offsets, d["w"], d["m"])


def dense_to_stencil(graph, rows, cols, max_offsets=128):
    """Decompose a square dense graph into per-offset planes when its edge
    set has small offset support (any radius-style predicate, including
    randomly-dropped edges).  The stencil gather is shifted multiply-adds —
    no gather/scatter, no (N, N) memory traffic — so this is the fastest
    backend whenever it applies.  Returns None if the support is too wide.
    """
    if graph.n_pre != rows * cols or graph.n_post != rows * cols:
        return None
    st = stencil_planes_host(np.asarray(graph.weights),
                             np.asarray(graph.mask), rows, cols,
                             max_offsets)
    if st is None:
        return None
    offsets, wp, mp = st
    from ..utils.transfer import device_put_state
    d = device_put_state({"w": wp, "m": mp})
    return StencilGraph(offsets, d["w"], d["m"])


def sparse_radius_graph(rows, cols, radius, keep_prob=1.0, seed=0,
                        weight_mode="constant", wparam0=1.0, wparam1=0.0):
    """Radius-limited lattice connectivity as a SparseGraph, built by the
    native C++ graph builder when available (fast host path for >=10^5
    neurons), NumPy otherwise."""
    from .. import _native
    n = rows * cols
    if _native.available:
        src, dst, w = _native.radius_edges(rows, cols, radius, keep_prob,
                                           seed, weight_mode, wparam0, wparam1)
        return SparseGraph.from_arrays(src, dst, w, n)
    rng = np.random.default_rng(seed + 1)

    def weight_fn(dr, dc, rr, cc):
        # mirrors _native/graphlib.cpp edge_weight (values, not RNG bits;
        # uniform_random draws are statistical like the Poisson paths)
        dist = float(np.hypot(dr, dc))
        if weight_mode == "distance":
            v = dist * wparam0
        elif weight_mode == "inv_distance":
            v = wparam0 / dist if dist > 0 else wparam0
        elif weight_mode == "gaussian":
            v = wparam1 * np.exp(-dist * dist / (2.0 * wparam0 * wparam0))
        elif weight_mode == "uniform_random":
            return rng.uniform(wparam0, wparam1, rr.shape).astype(np.float32)
        else:
            v = wparam0
        return np.full(rr.shape, v, np.float32)

    g = StencilGraph.build(rows, cols, radius_offsets(radius),
                           weight_fn=weight_fn, keep_prob=keep_prob,
                           seed=seed)
    return dense_to_sparse_from_stencil(g)


def dense_to_sparse_from_stencil(graph):
    """Convert a StencilGraph to COO (NumPy fallback path)."""
    from ..core.network import _graph_to_coo
    src, dst, w, _ = _graph_to_coo(graph)
    return SparseGraph.from_arrays(src, dst, w, graph.n_pre, graph.n_post)
