"""Multi-lattice network runtime: lattices + spike-train lattices + connecting
edges, flattened into one global index space on device.

JAX rebuild of `LatticeNetwork` (`reference/backend/src/neuron/
mod.rs:1538-2717`) and `SpikeTrainLattice` (:1292-1428).  The reference's own
GPU path already proves the layout used here: all lattices concatenated into a
single flat node space with spike-train flags (`InterleavingGraphGPU`,
graph/mod.rs:579-612).  We go further: the whole network — neuron states,
spike-train states, and a single COO edge list covering intra-lattice and
connecting edges — lives in the `lax.scan` carry, so a full `run_lattices`
is one device program with no host round trips.

Step semantics preserved (neuron/mod.rs:2420-2479):
  1. Phase A: gather electrical + chemical inputs from the *previous* state;
     spike-train sources contribute `w * g_post * refractoriness_effect`
     (no v_post subtraction), neuron sources `w * g_post * (v_pre - v_post)`,
     averaged together over the total in-degree (:2115-2167).
  2. Phase B: all neurons advance; last-firing-times set from the network
     clock; per-lattice histories update.
  3. Deferred plasticity across + within lattices (:2458-2461): edge (i, j)
     is updated once per spiking endpoint whose lattice has plasticity on.
  4. Clock increments; lattice clocks sync (:2467-2471).
  5. Spike-train lattices iterate LAST (:2473-2476) with their pre-increment
     clock as the firing timestamp.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..models.base import NEVER, get_neurotransmitter_concentrations
from ..models.spike_train import refractoriness_effect
from ..ops.graph import (HIGHEST, DenseGraph, SparseGraph, StencilGraph,
                         positions)
from .history import GridVoltageHistory
from .lattice import Lattice, _freeze, removed_setting, resolve_unroll
from .plasticity import STDP
from ..errors import LatticeNetworkError


class SpikeTrainLattice:
    """A grid of spike-train generators (no incoming connections allowed).

    Mirrors `SpikeTrainLattice` (neuron/mod.rs:1292-1428)."""

    def __init__(self, model, id=0):
        self.model = model
        self.id = id
        self.state = None
        self.rows = self.cols = 0
        self.update_grid_history = False
        self.grid_history = GridVoltageHistory()
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

    populate_host = populate

    def apply(self, fn):
        self.state = dict(fn(dict(self.state)))

    def apply_given_position(self, fn):
        rr, cc = np.meshgrid(np.arange(self.rows), np.arange(self.cols),
                             indexing="ij")
        self.state = dict(fn(jnp.asarray(rr.reshape(-1)),
                             jnp.asarray(cc.reshape(-1)), dict(self.state)))

    def shard(self, mesh, axis="tp"):
        """Row-block shard the generator state over a device mesh."""
        from ..parallel.lattice_sharding import shard_lattice
        return shard_lattice(self, mesh, axis)

    def set_dt(self, dt):
        """`SpikeTrainLattice::set_dt` — note PoissonNeuron rescales its
        chance_of_firing by dt ratio (spike_train/mod.rs:340-350)."""
        if "chance_of_firing" in self.state:
            scalar = dt / self.state["dt"]
            self.state["chance_of_firing"] = self.state["chance_of_firing"] * scalar
        from ..utils.transfer import full_like
        self.state["dt"] = full_like(self.state["dt"], dt)

    def reset_timing(self):
        self.internal_clock = 0
        from ..utils.transfer import full_like
        self.state["last_firing_time"] = full_like(
            self.state["last_firing_time"], NEVER)

    def reset_history(self):
        self.grid_history.reset()

    def run_lattice(self, iterations):
        """Standalone run (`RunSpikeTrainLattice`, neuron/mod.rs:1419-1428)."""
        from ..utils.transfer import ensure_device_state
        self.state = ensure_device_state(self.state)  # lazy-populate ship
        from .history import history_step_bytes, resolve_history_chunk
        hchunk = resolve_history_chunk(
            self.history_chunk,
            history_step_bytes(self.grid_history.kind, self.n)
            if self.update_grid_history else 0)
        remaining = iterations
        while remaining > 0:
            chunk = min(remaining, hchunk) \
                if self.update_grid_history else remaining
            self._run_chunk(chunk)
            remaining -= chunk

    def _run_chunk(self, length):

        runner = _build_st_runner(
            self.model,
            tuple((("grid", self.grid_history.kind, _freeze(self.grid_history)),)
                  if self.update_grid_history else ()),
            (self.rows, self.cols), length,
            resolve_unroll(self.scan_unroll))
        state, key, clock, ys = runner(self.state, self.key,
                                       jnp.int32(self.internal_clock))
        self.state, self.key = state, key
        self.internal_clock += length
        if self.update_grid_history:
            self.grid_history.extend(ys["grid"])

    def voltages(self):
        return np.asarray(self.state["v"]).reshape(self.rows, self.cols)


@functools.lru_cache(maxsize=None)
def _build_st_runner(model, history_sig, shape, length, unroll=1):
    from .history import HISTORY_KINDS
    readouts = []
    for name, kind, sig in history_sig:
        cls = HISTORY_KINDS[kind]
        readouts.append((name, cls(*sig[1:]) if len(sig) > 1 else cls()))

    def one_step(carry, _):
        state, key, clock = carry
        state, spikes, key = model.step(state, key, clock)
        state["last_firing_time"] = jnp.where(
            spikes, clock, state["last_firing_time"])
        clock = clock + 1
        ys = {name: h.readout(state, shape) for name, h in readouts}
        return (state, key, clock), ys

    def run(state, key, clock):
        (state, key, clock), ys = jax.lax.scan(
            one_step, (state, key, clock), None, length=length,
            unroll=unroll)
        return state, key, clock, ys

    return jax.jit(run, donate_argnums=(0,))


# ---------------------------------------------------------------------------
# Network
# ---------------------------------------------------------------------------


def _graph_to_coo(graph):
    """Extract (src, dst, w) host arrays from any lattice graph backend."""
    if isinstance(graph, DenseGraph):
        mask = np.asarray(graph.mask)
        w = np.asarray(graph.weights)
        src, dst = np.nonzero(mask)
        return src, dst, w[src, dst], ("dense", None)
    if isinstance(graph, SparseGraph):
        return (np.asarray(graph.src), np.asarray(graph.dst),
                np.asarray(graph.weights), ("sparse", None))
    if isinstance(graph, StencilGraph):
        rows, cols = graph.shape
        mask = np.asarray(graph.mask)
        w = np.asarray(graph.weights)
        srcs, dsts, ws, prov = [], [], [], []
        rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        for o, (dr, dc) in enumerate(graph.offsets):
            m = mask[o]
            r, c = rr[m], cc[m]
            srcs.append((r + dr) * cols + (c + dc))
            dsts.append(r * cols + c)
            ws.append(w[o][m])
            prov.append(np.stack([np.full(r.shape, o), r, c], axis=-1))
        return (np.concatenate(srcs), np.concatenate(dsts),
                np.concatenate(ws), ("stencil", np.concatenate(prov)))
    raise TypeError(f"unsupported graph type {type(graph)}")


def _edge_history_to_layout(graph, prov, src, dst, w_steps):
    """Per-step flat edge values (T, E) -> list of T backend-layout weight
    arrays (what Lattice.graph_history stores)."""
    kind, extra = prov
    T = w_steps.shape[0]
    if kind == "dense":
        out = np.repeat(np.asarray(graph.weights)[None], T, axis=0)
        out[:, src, dst] = w_steps
        return list(out)
    if kind == "sparse":
        return list(w_steps)
    if kind == "stencil":
        out = np.repeat(np.asarray(graph.weights)[None], T, axis=0)
        out[:, extra[:, 0], extra[:, 1], extra[:, 2]] = w_steps
        return list(out)
    raise TypeError(kind)


def _write_back_graph(graph, src, dst, w, prov):
    kind, extra = prov
    if kind == "dense":
        weights = np.asarray(graph.weights).copy()
        weights[src, dst] = w
        return DenseGraph(jnp.asarray(weights), graph.mask)
    if kind == "sparse":
        order = np.argsort(dst, kind="stable")
        return SparseGraph(jnp.asarray(src[order], jnp.int32),
                           jnp.asarray(dst[order], jnp.int32),
                           jnp.asarray(w[order], jnp.float32),
                           graph.n_pre, graph.n_post)
    if kind == "stencil":
        weights = np.asarray(graph.weights).copy()
        weights[extra[:, 0], extra[:, 1], extra[:, 2]] = w
        return StencilGraph(graph.offsets, jnp.asarray(weights), graph.mask,
                            graph.in_deg)
    raise TypeError(kind)


class LatticeNetwork:
    """Lattices + spike-train lattices connected by inter-lattice edges.

    All lattices must share one neuron model config and all spike-train
    lattices one spike-train model config (the reference has the same
    constraint via its single `T`/`W` type parameters,
    neuron/mod.rs:1538-1547).
    """

    use_pallas = removed_setting(
        "use_pallas", "networks and reward-modulated lattices run on the "
        "XLA path, with no fused kernel to choose")

    # densify the edge list for matvec gathers when the matrix fits
    dense_gather = True
    # structure-preserving runner (core/structured.py): keeps stencil blocks
    # as stencils and one-to-one connections elementwise; falls back to the
    # flat COO runner when unsupported
    structured = True

    def __init__(self):
        self.lattices = {}
        self.spike_train_lattices = {}
        # (pre_id, post_id) -> host COO (src_local, dst_local, w)
        self.connections = {}
        self.electrical_synapse = True
        self.chemical_synapse = False
        self.update_connecting_graph_history = False
        self.connecting_graph_history = []
        self.internal_clock = 0
        self.history_chunk = None  # None = auto (core/history)
        self.scan_unroll = None  # step-loop unroll (None=auto; see Lattice)
        self.key = jax.random.PRNGKey(0)
        # bumped on any topology/weight mutation; run_structured caches its
        # compiled plan (and device-resident connection weights) against it
        self._conn_version = 0
        self._structured_plan = None

    # -- construction ----------------------------------------------------------
    @classmethod
    def generate_network(cls, lattices=(), spike_train_lattices=()):
        """`LatticeNetwork::generate_network` (neuron/mod.rs:1625-1640)."""
        net = cls()
        for lat in lattices:
            net.add_lattice(lat)
        for st in spike_train_lattices:
            net.add_spike_train_lattice(st)
        return net

    def _check_id(self, id):
        if id in self.lattices or id in self.spike_train_lattices:
            raise LatticeNetworkError(f"id {id} already present in network")

    def add_lattice(self, lattice):
        self._check_id(lattice.id)
        if self.lattices:
            first = next(iter(self.lattices.values()))
            if first.model != lattice.model:
                raise LatticeNetworkError(
                "all lattices must share one neuron model config")
        lattice.in_network = True
        self.lattices[lattice.id] = lattice
        self._conn_version += 1

    def add_spike_train_lattice(self, lattice):
        self._check_id(lattice.id)
        if self.spike_train_lattices:
            first = next(iter(self.spike_train_lattices.values()))
            if first.model != lattice.model:
                raise LatticeNetworkError(
                    "all spike-train lattices must share one model config")
        lattice.in_network = True
        self.spike_train_lattices[lattice.id] = lattice
        self._conn_version += 1

    def get_lattice(self, id):
        return self.lattices[id]

    def get_spike_train_lattice(self, id):
        return self.spike_train_lattices[id]

    def shard(self, mesh, axis="tp"):
        """Shard every member lattice across the mesh (structured runner
        keeps per-lattice arrays, so each is row-block sharded in place)."""
        from ..parallel.lattice_sharding import shard_network
        return shard_network(self, mesh, axis)

    def set_dt(self, dt):
        for lat in self.lattices.values():
            lat.set_dt(dt)
        for st in self.spike_train_lattices.values():
            st.set_dt(dt)

    def reset_timing(self):
        self.internal_clock = 0
        for lat in self.lattices.values():
            lat.reset_timing()
        for st in self.spike_train_lattices.values():
            st.reset_timing()

    # -- connectivity -----------------------------------------------------------
    def connect(self, presynaptic_id, postsynaptic_id, connecting_conditional,
                weight_logic=None):
        """Connect two different lattices (`LatticeNetwork::connect`,
        neuron/mod.rs:1845-1940): overwrites existing pre->post edges;
        spike-train lattices cannot be postsynaptic."""
        if postsynaptic_id in self.spike_train_lattices:
            raise LatticeNetworkError("spike-train lattices cannot be postsynaptic")
        if postsynaptic_id not in self.lattices:
            raise KeyError(f"unknown postsynaptic id {postsynaptic_id}")
        if presynaptic_id == postsynaptic_id:
            return self.connect_internally(
                presynaptic_id, connecting_conditional, weight_logic)
        pre = self.lattices.get(presynaptic_id) \
            or self.spike_train_lattices.get(presynaptic_id)
        if pre is None:
            raise KeyError(f"unknown presynaptic id {presynaptic_id}")
        post = self.lattices[postsynaptic_id]

        pre_pos = positions(pre.rows, pre.cols)
        post_pos = positions(post.rows, post.cols)
        src, dst, w = [], [], []
        for i, p1 in enumerate(pre_pos):
            t1 = (int(p1[0]), int(p1[1]))
            for j, p2 in enumerate(post_pos):
                t2 = (int(p2[0]), int(p2[1]))
                if connecting_conditional(t1, t2):
                    src.append(i)
                    dst.append(j)
                    w.append(1.0 if weight_logic is None else weight_logic(t1, t2))
        self.connections[(presynaptic_id, postsynaptic_id)] = (
            np.asarray(src, np.int64), np.asarray(dst, np.int64),
            np.asarray(w, np.float32))
        self._conn_version += 1

    def connect_vectorized(self, presynaptic_id, postsynaptic_id, fn):
        """Fast path: fn(pre_r, pre_c, post_r, post_c) -> weight array with
        NaN/None semantics (NaN = no edge), fully vectorized over the
        (N_pre, N_post) position product."""
        pre = self.lattices.get(presynaptic_id) \
            or self.spike_train_lattices.get(presynaptic_id)
        post = self.lattices[postsynaptic_id]
        pre_pos = positions(pre.rows, pre.cols)
        post_pos = positions(post.rows, post.cols)
        w = np.asarray(fn(pre_pos[:, None, 0], pre_pos[:, None, 1],
                          post_pos[None, :, 0], post_pos[None, :, 1]),
                       np.float32)
        src, dst = np.nonzero(~np.isnan(w))
        self.connections[(presynaptic_id, postsynaptic_id)] = (
            src, dst, w[src, dst])
        self._conn_version += 1

    def connect_internally(self, id, connecting_conditional, weight_logic=None):
        """`connect_interally` (neuron/mod.rs:2050-2084)."""
        self.lattices[id].connect(connecting_conditional, weight_logic)

    # -- per-edge connecting-graph access (Graph<K=GraphPosition> trait,
    #    graph/mod.rs:42-72) ---------------------------------------------------
    def _graph_position(self, gp):
        """Accept (id, (r, c)) tuples or objects with .id/.pos."""
        if hasattr(gp, "id") and hasattr(gp, "pos"):
            return gp.id, tuple(gp.pos)
        lid, pos = gp
        return lid, tuple(pos)

    def _node_of(self, gp):
        lid, pos = self._graph_position(gp)
        lat = self.lattices.get(lid) \
            or getattr(self, "reward_modulated_lattices", {}).get(lid) \
            or self.spike_train_lattices.get(lid)
        if lat is None:
            raise LatticeNetworkError(f"unknown lattice id {lid}")
        r, c = pos
        if not (0 <= r < lat.rows and 0 <= c < lat.cols):
            raise LatticeNetworkError(f"position {pos} not in lattice {lid}")
        return lid, r * lat.cols + c

    def _any_lattice(self, lid):
        """Neuron lattice by id, including reward-modulated ones."""
        lat = self.lattices.get(lid) \
            or getattr(self, "reward_modulated_lattices", {}).get(lid)
        if lat is None:
            raise LatticeNetworkError(f"unknown neuron lattice id {lid}")
        return lat

    def lookup_weight(self, presynaptic, postsynaptic):
        """Weight of a connecting edge between two lattices, or None.
        Same-lattice queries delegate to that lattice's graph; reward-
        modulated connecting edges report their weight too."""
        pre_id, src = self._node_of(presynaptic)
        post_id, dst = self._node_of(postsynaptic)
        if pre_id == post_id:
            return self._any_lattice(pre_id).graph.lookup_weight(src, dst)
        conn = self.connections.get((pre_id, post_id))
        if conn is not None:
            hits = np.nonzero((conn[0] == src) & (conn[1] == dst))[0]
            if len(hits):
                return float(conn[2][hits[0]])
        rconn = getattr(self, "reward_connections", {}) \
            .get((pre_id, post_id))
        if rconn is not None:
            hits = np.nonzero((rconn[0] == src) & (rconn[1] == dst))[0]
            if len(hits):
                return float(rconn[2][hits[0]])
        return None

    def edit_weight(self, presynaptic, postsynaptic, weight):
        """Set (or with None: remove) one connecting edge.  An edge that
        exists as a reward-modulated connection is edited IN PLACE there
        (adding a duplicate plain edge would deliver the synapse twice)."""
        pre_id, src = self._node_of(presynaptic)
        post_id, dst = self._node_of(postsynaptic)
        if pre_id == post_id:
            lat = self._any_lattice(pre_id)
            lat.graph = lat.graph.edit_weight(src, dst, weight)
            self._conn_version += 1
            return
        rconns = getattr(self, "reward_connections", {})
        rconn = rconns.get((pre_id, post_id))
        if rconn is not None:
            s, d, w = rconn[0], rconn[1], rconn[2]
            hits = np.nonzero((s == src) & (d == dst))[0]
            if len(hits):
                if weight is None:
                    keep = np.ones(len(s), bool)
                    keep[hits[0]] = False
                    rconns[(pre_id, post_id)] = tuple(
                        a[keep] for a in rconn)
                else:
                    w = np.asarray(w).copy()
                    w[hits[0]] = weight
                    rconns[(pre_id, post_id)] = (s, d, w) + tuple(rconn[3:])
                self._conn_version += 1
                return
        s, d, w = self.connections.get((pre_id, post_id),
                                       (np.zeros(0, np.int64),
                                        np.zeros(0, np.int64),
                                        np.zeros(0, np.float32)))
        hits = np.nonzero((s == src) & (d == dst))[0]
        if weight is None:
            if len(hits):
                keep = np.ones(len(s), bool)
                keep[hits[0]] = False
                self.connections[(pre_id, post_id)] = (s[keep], d[keep],
                                                       w[keep])
        elif len(hits):
            w = w.copy()
            w[hits[0]] = weight
            self.connections[(pre_id, post_id)] = (s, d, w)
        else:
            self.connections[(pre_id, post_id)] = (
                np.append(s, src), np.append(d, dst),
                np.append(w, np.float32(weight)))
        self._conn_version += 1

    def get_incoming_connections(self, pos):
        """All (id, (r, c)) sources of `pos` across connecting edges AND its
        own lattice graph (`get_all_input_positions`, neuron/mod.rs:2086)."""
        post_id, dst = self._node_of(pos)
        out = set()
        lat = self.lattices.get(post_id) \
            or getattr(self, "reward_modulated_lattices", {}).get(post_id)
        if lat is not None and lat.graph is not None:
            for i in lat.graph.get_incoming_connections(dst):
                out.add((post_id, (i // lat.cols, i % lat.cols)))
        reward_items = [(k, v[:3]) for k, v in
                        getattr(self, "reward_connections", {}).items()]
        for (pre_id, pid), (s, d, w) in \
                list(self.connections.items()) + reward_items:
            if pid != post_id:
                continue
            pre = self.lattices.get(pre_id) \
                or getattr(self, "reward_modulated_lattices", {}).get(pre_id) \
                or self.spike_train_lattices.get(pre_id)
            for i in s[d == dst]:
                out.add((pre_id, (int(i) // pre.cols, int(i) % pre.cols)))
        return out

    # -- flattening --------------------------------------------------------------
    def _compile(self):
        lat_ids = sorted(self.lattices)
        st_ids = sorted(self.spike_train_lattices)
        n_offset, st_offset = {}, {}
        off = 0
        for i in lat_ids:
            n_offset[i] = off
            off += self.lattices[i].n
        n_neurons = off
        for i in st_ids:
            st_offset[i] = off
            off += self.spike_train_lattices[i].n
        n_total = off

        # edges: intra-lattice + connecting, one COO list over global ids
        src_all, dst_all, w_all = [], [], []
        provenance = []  # (kind, owner_key, count, extra)
        plastic_all = []
        for i in lat_ids:
            lat = self.lattices[i]
            src, dst, w, prov = _graph_to_coo(lat.graph)
            src_all.append(src + n_offset[i])
            dst_all.append(dst + n_offset[i])
            w_all.append(w)
            plastic_all.append(np.full(len(w), bool(lat.do_plasticity)))
            provenance.append(("intra", i, len(w), prov, src, dst))
        for (pre_id, post_id), (src, dst, w) in sorted(self.connections.items()):
            base = n_offset.get(pre_id, st_offset.get(pre_id))
            src_all.append(src + base)
            dst_all.append(dst + n_offset[post_id])
            w_all.append(w)
            # connecting edges participate in plasticity when EITHER
            # endpoint's lattice has it enabled: a spiking plastic neuron
            # updates its outgoing connecting edges too
            # (neuron/mod.rs:2445-2461 — positions_to_update gathers spiking
            # neurons of plastic lattices, then across-lattice updates visit
            # both in- and out-edges); per-endpoint triggering via
            # node_plastic supplies the actual visit counts
            pre_lat = self.lattices.get(pre_id)
            edge_plastic = bool(self.lattices[post_id].do_plasticity) or (
                pre_lat is not None and bool(pre_lat.do_plasticity))
            plastic_all.append(np.full(len(w), edge_plastic))
            provenance.append(("connecting", (pre_id, post_id), len(w), None,
                               src, dst))

        if src_all:
            src = np.concatenate(src_all)
            dst = np.concatenate(dst_all)
            w = np.concatenate(w_all).astype(np.float32)
            plastic = np.concatenate(plastic_all)
        else:
            src = np.zeros(0, np.int64)
            dst = np.zeros(0, np.int64)
            w = np.zeros(0, np.float32)
            plastic = np.zeros(0, bool)

        # per-node plasticity trigger flag (spiking neuron in a plastic
        # lattice triggers updates on its in/out edges); spike trains never
        # trigger (they are not iterated in the plasticity sweep)
        node_plastic = np.zeros(n_total, np.float32)
        for i in lat_ids:
            if self.lattices[i].do_plasticity:
                node_plastic[n_offset[i]:n_offset[i] + self.lattices[i].n] = 1.0

        nstate = {}
        first = self.lattices[lat_ids[0]]
        for k in first.state:
            nstate[k] = jnp.concatenate(
                [self.lattices[i].state[k] for i in lat_ids], axis=0)
        st_state = None
        if st_ids:
            st0 = self.spike_train_lattices[st_ids[0]]
            st_state = {}
            for k in st0.state:
                st_state[k] = jnp.concatenate(
                    [self.spike_train_lattices[i].state[k] for i in st_ids],
                    axis=0)

        in_deg = np.zeros(n_neurons, np.float32)
        np.add.at(in_deg, dst, 1.0)

        # Dense path: one matvec in place of scatter-adds (segment_sum)
        # while the matrix stays small; above ~8M entries the full-matrix
        # bandwidth dominates and COO is used.  The threshold has not been
        # measured on a GPU.
        dense_w = dense_mask = None
        if self.dense_gather and n_total * n_neurons <= 8_000_000 and len(w):
            dw_ = np.zeros((n_total, n_neurons), np.float32)
            dm_ = np.zeros((n_total, n_neurons), bool)
            dw_[src, dst] = w
            dm_[src, dst] = True
            dense_w = jnp.asarray(dw_)
            dense_mask = jax.device_put(dm_)
            dp_ = np.zeros((n_total, n_neurons), bool)
            dp_[src, dst] = plastic
            dense_plastic = jax.device_put(dp_)
        else:
            dense_plastic = None

        return dict(
            lat_ids=lat_ids, st_ids=st_ids, n_offset=n_offset,
            st_offset=st_offset, n_neurons=n_neurons, n_total=n_total,
            src=jnp.asarray(src, jnp.int32), dst=jnp.asarray(dst, jnp.int32),
            w=jnp.asarray(w), plastic=jnp.asarray(plastic),
            node_plastic=jnp.asarray(node_plastic),
            in_deg=jnp.asarray(in_deg),
            dense_w=dense_w, dense_mask=dense_mask,
            dense_plastic=dense_plastic,
            nstate=nstate, st_state=st_state, provenance=provenance,
            host_src=src, host_dst=dst,
        )

    def _history_signature(self, plan):
        sig = []
        for i in plan["lat_ids"]:
            lat = self.lattices[i]
            if lat.update_grid_history:
                sig.append((("lat", i), lat.grid_history.kind,
                            _freeze(lat.grid_history),
                            (lat.rows, lat.cols),
                            plan["n_offset"][i], lat.n))
        for i in plan["st_ids"]:
            st = self.spike_train_lattices[i]
            if st.update_grid_history:
                sig.append((("st", i), st.grid_history.kind,
                            _freeze(st.grid_history),
                            (st.rows, st.cols),
                            plan["st_offset"][i] - plan["n_neurons"], st.n))
        return tuple(sig)

    def _plasticity(self):
        for i in sorted(self.lattices):
            if self.lattices[i].do_plasticity:
                return self.lattices[i].plasticity
        return STDP()

    def update(self):
        """UnsupervisedAgent impl: one network step."""
        self.run_lattices(1)

    # -- simulation ---------------------------------------------------------------
    def _structured_supported(self):
        return (type(self) is LatticeNetwork
                and not self.update_connecting_graph_history
                and self.lattices)

    def run_lattices(self, iterations):
        """`RunNetwork::run_lattices` (neuron/mod.rs:2667-2674)."""
        if iterations == 0:
            return
        if not self.electrical_synapse and not self.chemical_synapse:
            return
        self._ship_states()
        if self.structured and self._structured_supported():
            from .structured import (run_structured, structured_nt_flags,
                                     flush_structured_sink)
            any_history = any(l.update_grid_history or l.update_graph_history
                              for l in self.lattices.values()) \
                or any(s.update_grid_history
                       for s in self.spike_train_lattices.values())
            # the nt-mask flags are pulled once (invariant across chunks)
            # and every per-chunk host pull (history ys, plastic-weight
            # mirrors) is deferred into one batched device_get after the
            # loop
            nt_flags = structured_nt_flags(self)
            sink = {"hist": [], "last": None}
            hchunk = self._history_chunk()
            remaining = iterations
            while remaining > 0:
                chunk = min(remaining, hchunk) if any_history \
                    else remaining
                run_structured(self, chunk, nt_flags=nt_flags, sink=sink)
                remaining -= chunk
            flush_structured_sink(self, sink)
            return
        plan = self._compile()
        any_history = any(l.update_grid_history or l.update_graph_history
                          for l in self.lattices.values()) \
            or any(s.update_grid_history
                   for s in self.spike_train_lattices.values()) \
            or self.update_connecting_graph_history
        hchunk = self._history_chunk()
        remaining = iterations
        while remaining > 0:
            chunk = min(remaining, hchunk) if any_history else remaining
            plan = self._run_chunk(plan, chunk)
            remaining -= chunk
        self._write_back(plan)

    def _history_chunk(self):
        """Resolved history chunk (core/history.resolve_history_chunk):
        bytes/step summed over every recorded readout in the network."""
        from .history import history_step_bytes, resolve_history_chunk
        bps = 0
        lats = self._neuron_lattices() if hasattr(
            self, "_neuron_lattices") else self.lattices
        for l in lats.values():
            if l.update_grid_history:
                bps += history_step_bytes(l.grid_history.kind, l.n)
            if getattr(l, "update_graph_history", False):
                bps += 4 * int(l.graph.weights.size)
        for s in self.spike_train_lattices.values():
            if s.update_grid_history:
                bps += history_step_bytes(s.grid_history.kind, s.n)
        if getattr(self, "update_connecting_graph_history", False):
            bps += 4 * sum(len(src) for (src, dst, w)
                           in self.connections.values())
        return resolve_history_chunk(self.history_chunk, bps)

    def _ship_states(self):
        """One transfer for every lattice still holding lazy host state
        (utils/transfer.ship_states)."""
        from ..utils.transfer import ship_states
        ship_states(list(self.lattices.values())
                    + list(self.spike_train_lattices.values()))

    def run_lattices_pipelined(self, iterations, mesh=None, order=None):
        """Pipeline-parallel `run_lattices` for chain-topology networks:
        one lattice per device of a ``("pp",)`` mesh, previous-stage fields
        delivered by `ppermute` (parallel/pipeline.py)."""
        if iterations == 0:
            return
        self._ship_states()
        from ..parallel.pipeline import run_pipelined
        run_pipelined(self, iterations, mesh=mesh, order=order)

    def _run_chunk(self, plan, length):
        neuron_model = next(iter(self.lattices.values())).model
        st_model = (next(iter(self.spike_train_lattices.values())).model
                    if plan["st_ids"] else None)
        do_plasticity = any(l.do_plasticity for l in self.lattices.values())
        plasticity = self._plasticity()
        skip_nt = not bool(jnp.any(plan["nstate"]["nt$mask"]))
        hist_sig = self._history_signature(plan)

        # per-lattice graph-history slices into the flat edge list
        ghist = []
        goffset = 0
        for entry in plan["provenance"]:
            kind_, owner_, count_, prov_, src_, dst_ = entry
            if kind_ == "intra" \
                    and getattr(self.lattices[owner_], "update_graph_history",
                                False):
                ghist.append((owner_, goffset, count_))
            goffset += count_

        dense = plan.get("dense_w") is not None
        runner = _build_network_runner(
            neuron_model, st_model, self.electrical_synapse,
            self.chemical_synapse, do_plasticity, type(plasticity),
            hist_sig, plan["n_neurons"], plan["n_total"], skip_nt,
            self.update_connecting_graph_history, length, dense,
            tuple(ghist),
            resolve_unroll(self.scan_unroll))

        edges = dict(src=plan["src"], dst=plan["dst"], plastic=plan["plastic"],
                     node_plastic=plan["node_plastic"], in_deg=plan["in_deg"])
        if dense:
            edges["dense_mask"] = plan["dense_mask"]
            edges["plastic"] = plan["dense_plastic"]
        w_arg = plan["dense_w"] if dense else plan["w"]
        pparams = {k: jnp.float32(v) for k, v in plasticity.params.items()}
        carry, ys = runner(
            plan["nstate"], plan["st_state"], w_arg, self.key,
            jnp.int32(self.internal_clock), edges, pparams)
        plan["nstate"], plan["st_state"] = carry[0], carry[1]
        if dense:
            plan["dense_w"] = carry[2]
            plan["w"] = carry[2][plan["src"], plan["dst"]]
        else:
            plan["w"] = carry[2]
        self.key = carry[3]
        self.internal_clock += length

        for (key_id, kind, fsig, shape, off, n) in hist_sig:
            scope, i = key_id
            hist = (self.lattices[i].grid_history if scope == "lat"
                    else self.spike_train_lattices[i].grid_history)
            hist.extend(ys[key_id])
        if self.update_connecting_graph_history:
            self.connecting_graph_history.extend(np.asarray(ys[("__w__", -1)]))
        for (i, start, count) in ghist:
            lat = self.lattices[i]
            for entry in plan["provenance"]:
                if entry[0] == "intra" and entry[1] == i:
                    _, _, _, prov_, src_, dst_ = entry
                    break
            lat.graph_history.extend(_edge_history_to_layout(
                lat.graph, prov_, src_, dst_, np.asarray(ys[("gw", i)])))
        return plan

    def _write_back(self, plan):
        # states back into the individual lattices
        for i in plan["lat_ids"]:
            lat = self.lattices[i]
            off = plan["n_offset"][i]
            lat.state = {k: v[off:off + lat.n] for k, v in plan["nstate"].items()}
            lat.internal_clock = self.internal_clock
        for i in plan["st_ids"]:
            st = self.spike_train_lattices[i]
            off = plan["st_offset"][i] - plan["n_neurons"]
            st.state = {k: v[off:off + st.n] for k, v in plan["st_state"].items()}
            st.internal_clock = self.internal_clock
        # weights back into graphs / connection lists
        w = np.asarray(plan["w"])
        offset = 0
        for entry in plan["provenance"]:
            kind, owner, count, prov, src, dst = entry
            wslice = w[offset:offset + count]
            if kind == "intra":
                lat = self.lattices[owner]
                lat.graph = _write_back_graph(lat.graph, src, dst, wslice, prov)
            else:
                self.connections[owner] = (src, dst, wslice.copy())
                self._conn_version += 1
            offset += count


@functools.lru_cache(maxsize=None)
def _build_network_runner(neuron_model, st_model, electrical, chemical,
                          do_plasticity, plasticity_cls, history_sig,
                          n_neurons, n_total, skip_nt, w_history, length,
                          dense=False, ghist=(), unroll=1):
    from .history import HISTORY_KINDS

    readouts = []
    for (key_id, kind, fsig, shape, off, n) in history_sig:
        cls = HISTORY_KINDS[kind]
        h = cls(*fsig[1:]) if len(fsig) > 1 else cls()
        readouts.append((key_id, h, shape, off, n))

    def one_step(edges, pparams, carry, _):
        nstate, st_state, w, key, clock = carry
        src, dst = edges["src"], edges["dst"]
        cnt = jnp.maximum(edges["in_deg"], 1.0)
        # (dense w keeps exact zeros on non-edges: STDP writes are gated on
        # the plastic mask, a subset of the edge mask — no re-masking needed)

        # ---- Phase A: gathers from previous state ----
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
            if dense:
                summed = (jnp.matmul(a_src, w, precision=HIGHEST)
                          - nstate["v"] * jnp.matmul(sub_v, w,
                                                     precision=HIGHEST))
            else:
                contrib = w * (a_src[src] - sub_v[src] * nstate["v"][dst])
                summed = jax.ops.segment_sum(contrib, dst,
                                             num_segments=n_neurons)
            elec = nstate["gap_conductance"] * summed / cnt
        else:
            elec = jnp.zeros_like(nstate["v"])

        if chemical:
            t_n, m_n = get_neurotransmitter_concentrations(nstate)
            if st_state is not None:
                t_s, m_s = get_neurotransmitter_concentrations(st_state)
                t_src = jnp.concatenate([t_n, t_s])
                m_src = jnp.concatenate([m_n, m_s]).astype(jnp.float32)
            else:
                t_src, m_src = t_n, m_n.astype(jnp.float32)
            if dense:
                sums = jnp.matmul(w.T, t_src * m_src, precision=HIGHEST)
                cnts = jnp.matmul(edges["dense_mask"].astype(jnp.float32).T,
                                  m_src, precision=HIGHEST)
            else:
                vals = w[:, None] * t_src[src] * m_src[src]
                sums = jax.ops.segment_sum(vals, dst, num_segments=n_neurons)
                cnts = jax.ops.segment_sum(m_src[src], dst,
                                           num_segments=n_neurons)
            t_in = sums / jnp.maximum(cnts, 1.0)
            nstate, spikes = neuron_model.step(
                nstate, elec, t_in, cnts > 0.0, skip_nt=skip_nt)
        else:
            nstate, spikes = neuron_model.step(nstate, elec, skip_nt=skip_nt)

        nstate["last_firing_time"] = jnp.where(
            spikes, clock, nstate["last_firing_time"])

        # ---- deferred plasticity across + within lattices ----
        # An edge is visited once per spiking endpoint whose lattice has
        # plasticity enabled (incoming edges of spiking j + outgoing edges of
        # spiking i, neuron/mod.rs:2308-2461); spike trains never trigger.
        if do_plasticity:
            def node_vals(key_name):
                nv = nstate[key_name] if key_name != "is_spiking" else spikes
                if st_state is not None and key_name in st_state:
                    return jnp.concatenate([nv, st_state[key_name]])
                if st_state is not None:
                    pad = jnp.zeros((n_total - n_neurons,), nv.dtype)
                    return jnp.concatenate([nv, pad])
                return nv

            if dense:
                pre = {k: node_vals(k)[:, None]
                       for k in plasticity_cls.NODE_KEYS}
                post = {k: (spikes if k == "is_spiking" else nstate[k])[None, :]
                        for k in plasticity_cls.NODE_KEYS}
                trig = spikes.astype(jnp.float32) \
                    * edges["node_plastic"][:n_neurons]
                if st_state is not None:
                    trig = jnp.concatenate(
                        [trig, jnp.zeros((n_total - n_neurons,), jnp.float32)])
                count = trig[:, None] + trig[None, :n_neurons]
                w_new = plasticity_cls.apply_visits(w, pre, post, pparams,
                                                    count)
                w = jnp.where(edges["plastic"], w_new, w)
            else:
                pre = {k: node_vals(k)[src] for k in plasticity_cls.NODE_KEYS}
                post = {k: (spikes if k == "is_spiking" else nstate[k])[dst]
                        for k in plasticity_cls.NODE_KEYS}
                trig = spikes.astype(jnp.float32) \
                    * edges["node_plastic"][:n_neurons]
                if st_state is not None:
                    trig = jnp.concatenate(
                        [trig, jnp.zeros((n_total - n_neurons,), jnp.float32)])
                count = trig[src] + trig[dst]
                w_new = plasticity_cls.apply_visits(w, pre, post, pparams,
                                                    count)
                w = jnp.where(edges["plastic"], w_new, w)

        clock = clock + 1

        # ---- spike trains iterate last ----
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
            ys[("__w__", -1)] = w[src, dst] if dense else w
        for (i, start, count) in ghist:
            if dense:
                ys[("gw", i)] = w[src[start:start + count],
                                  dst[start:start + count]]
            else:
                ys[("gw", i)] = jax.lax.slice_in_dim(w, start, start + count)
        return (nstate, st_state, w, key, clock), ys

    def run(nstate, st_state, w, key, clock, edges, pparams):
        step = functools.partial(one_step, edges, pparams)
        carry, ys = jax.lax.scan(step, (nstate, st_state, w, key, clock),
                                 None, length=length, unroll=unroll)
        return carry, ys

    return jax.jit(run, donate_argnums=(0, 1, 2))
