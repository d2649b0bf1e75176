"""Single-lattice simulation runtime.

JAX rebuild of the reference's `Lattice` CPU runtime
(`reference/backend/src/neuron/mod.rs:556-1219`) and its OpenCL mirror
(`gpu_lattices/mod.rs:327-1064`), redesigned for XLA:

* the cell grid is one struct-of-arrays state pytree resident in HBM;
* the reference's two-phase step — Phase A gathers all synaptic inputs from
  the *previous* state (neuron/mod.rs:1035-1050), Phase B updates all
  neurons — becomes gather ops + a fused vectorized model step;
* `run_lattice(iterations)` is a `lax.scan` jitted once per (model config,
  graph type, flags); state is donated so iteration is fully in-place on
  device, eliminating the reference GPU path's per-run host round trip
  (gpu_lattices/mod.rs:792/887);
* histories are scan outputs, pulled to host in chunks.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import stencil_kernel
from ..ops.graph import (SparseGraph, StencilGraph, connect_dense,
                         dense_to_stencil, radius_offsets)
from ..models.base import NEVER, get_neurotransmitter_concentrations
from .history import GridVoltageHistory
from .plasticity import STDP
from ..errors import GraphError


def resolve_unroll(setting):
    """Resolve a `scan_unroll` setting: the number of steps per iteration
    of the step loop's `lax.scan`.

    None = auto: 4.  On an H100 (400 W limit) unrolling 4 steps per loop
    iteration measured faster than the rolled loop at every lattice size
    tried, electrical Izhikevich: 186.8k vs 65.0k steps/s at 64x64, 108.6k
    vs 65.9k at 512x512, 6,091 vs 5,417 at 2048x2048 and 1,574 vs 1,440 at
    4096x4096.  Unrolled loops are bit-exact vs rolled (pure scheduling),
    so the ``SNN_SCAN_UNROLL`` env var may force a global value — the test
    suite sets 1 to shrink XLA:CPU compile times."""
    if setting is None:
        import os
        env = os.environ.get("SNN_SCAN_UNROLL")
        return max(1, int(env)) if env else 4
    return max(1, int(setting))


def removed_setting(name, instead):
    """A class attribute that raises when a removed setting is read or
    set, so that code written for it fails instead of being ignored."""
    def refuse(self, *value):
        raise AttributeError(f"{type(self).__name__}.{name} was removed: "
                             f"{instead}")
    return property(refuse, refuse)


class Lattice:
    """A 2-D grid of one neuron model plus a weighted synapse graph.

    API mirrors the reference `Lattice` (populate / connect / apply /
    run_lattice / histories, neuron/mod.rs:556-1219).
    """

    use_pallas = removed_setting(
        "use_pallas", "use_kernel chooses the CUDA stencil kernel (None "
        "auto, True demands it, False keeps the XLA path)")

    def __init__(self, model, id=0):
        self.model = model
        self.id = id
        self.state = None
        self.graph = None
        self.rows = self.cols = 0
        self.electrical_synapse = True
        self.chemical_synapse = False
        self.do_plasticity = False
        self.plasticity = STDP()
        self.update_grid_history = False
        self.grid_history = GridVoltageHistory()
        self.update_graph_history = False
        self.graph_history = []
        self.internal_clock = 0
        self.key = jax.random.PRNGKey(0)
        # None = auto (core/history.resolve_history_chunk): one chunk
        # whenever the history ys buffer fits ~64 MB on device
        self.history_chunk = None
        self.in_network = False
        self.mesh = None  # set by shard(); informational
        # lax.scan unroll factor for the step loop (resolve_unroll)
        self.scan_unroll = None
        # the CUDA stencil kernel for electrical Izhikevich lattices
        # (ops/stencil_kernel.py).  None = auto: on for a GPU backend
        # wherever why_not finds no reason; True demands it (raises if it
        # cannot run)
        self.use_kernel = None
        # whether the last _run_chunk ran the kernel (observability)
        self._last_run_kernel = False

    # -- construction ---------------------------------------------------------
    @property
    def n(self):
        return self.rows * self.cols

    def populate(self, rows, cols, **overrides):
        """`Lattice::populate` (neuron/mod.rs:1105-1126): (re)build the cell
        grid from the base model; state fields can be overridden per neuron.

        The fresh state stays as HOST NumPy arrays until the first run entry
        point ships it (utils/transfer.ensure_device_state), so
        construction-time edits cost no device work.  All host-visible
        mutators (apply / set_dt / reset_timing / insert) are residency-
        agnostic, so the deferral is invisible to callers."""
        if self.in_network and (rows, cols) != (self.rows, self.cols):
            raise GraphError(
                "dimensions must match when lattice is in a network")
        self.rows, self.cols = rows, cols
        from ..utils.transfer import host_state_view
        self.state = host_state_view(
            self.model.init_state_host(rows * cols, **overrides))
        # zero-edge default graph; `connect` replaces it (a dense default
        # would allocate (N, N) -- 274 GB at 512x512)
        self.graph = SparseGraph.empty(self.n)

    # retained name from when host-side init was opt-in (lixirnet callers)
    populate_host = populate

    def connect(self, connecting_conditional, weight_logic=None):
        """`Lattice::connect` (neuron/mod.rs:1134-1157). O(N^2) host-side;
        for big lattices prefer `connect_stencil` / `set_graph`.

        Radius-style predicates (small offset support) are decomposed into
        a StencilGraph automatically — shifted adds instead of an (N, N)
        matvec.  Evaluation AND decomposition run host-side; only the
        final representation ships."""
        from ..ops.graph import connect_auto
        self.graph = connect_auto(self.rows, self.cols,
                                  connecting_conditional, weight_logic)

    def falliable_connect(self, connecting_conditional, weight_logic=None):
        """`falliable_connect` (neuron/mod.rs:1165-1196): same as `connect`;
        Python callables signal failure by raising, which propagates."""
        self.connect(connecting_conditional, weight_logic)

    def connect_stencil(self, radius=None, offsets=None, weight_fn=None,
                        keep_prob=1.0, seed=0):
        """Translation-local connectivity as a `StencilGraph` — the fast path
        for the reference's radius-style `connection_conditional`
        (backend/examples/lattice/main.rs:18-23)."""
        if offsets is None:
            offsets = radius_offsets(radius)
        self.graph = StencilGraph.build(self.rows, self.cols, offsets,
                                        weight_fn=weight_fn,
                                        keep_prob=keep_prob, seed=seed)

    def set_graph(self, graph):
        if graph.n_post != self.n:
            raise GraphError("graph does not match lattice dimensions")
        self.graph = graph

    def shard(self, mesh, axis="tp"):
        """Shard this lattice's state + adjacency across a device mesh
        (row-block model parallelism; parallel/lattice_sharding.py).  Call
        after `populate`/`connect`; subsequent `run_lattice` calls compile
        to SPMD programs whose halo exchanges are collectives between the
        devices."""
        from ..parallel.lattice_sharding import shard_lattice
        return shard_lattice(self, mesh, axis)

    # -- per-edge graph access (Graph trait, graph/mod.rs:42-72) -------------
    def _flat(self, pos):
        r, c = pos
        if not (0 <= r < self.rows and 0 <= c < self.cols):
            raise GraphError(f"position {pos} not in lattice")
        return r * self.cols + c

    def lookup_weight(self, presynaptic, postsynaptic):
        """Weight of the synapse pre -> post, or None if unconnected
        (`Graph::lookup_weight`); positions are (row, col) tuples."""
        return self.graph.lookup_weight(self._flat(presynaptic),
                                        self._flat(postsynaptic))

    def edit_weight(self, presynaptic, postsynaptic, weight):
        """Set (or with None: remove) one synapse (`Graph::edit_weight`)."""
        self.graph = self.graph.edit_weight(self._flat(presynaptic),
                                            self._flat(postsynaptic), weight)

    def get_incoming_connections(self, pos):
        """Presynaptic (row, col) positions of `pos`
        (`Graph::get_incoming_connections`)."""
        flat = self.graph.get_incoming_connections(self._flat(pos))
        return {(i // self.cols, i % self.cols) for i in flat}

    def get_outgoing_connections(self, pos):
        flat = self.graph.get_outgoing_connections(self._flat(pos))
        return {(i // self.cols, i % self.cols) for i in flat}

    # -- per-neuron mutation (`apply` / `apply_given_position`,
    #    neuron/mod.rs:424-452) ------------------------------------------------
    def apply(self, fn):
        """fn(state dict) -> state dict, operating on whole (N,) arrays."""
        self.state = dict(fn(dict(self.state)))

    def apply_given_position(self, fn):
        """fn(rr, cc, state) -> state; rr/cc are (N,) position index arrays."""
        rr, cc = np.meshgrid(np.arange(self.rows), np.arange(self.cols),
                             indexing="ij")
        self.state = dict(fn(jnp.asarray(rr.reshape(-1)),
                             jnp.asarray(cc.reshape(-1)), dict(self.state)))

    def set_dt(self, dt):
        """`Lattice::set_dt` (neuron/mod.rs:649-652)."""
        from ..utils.transfer import full_like
        self.state["dt"] = full_like(self.state["dt"], dt)
        self.plasticity.set_dt(dt)

    def reset_timing(self):
        """`impl_reset_timing!` (neuron/mod.rs:405-420)."""
        self.internal_clock = 0
        from ..utils.transfer import full_like
        self.state["last_firing_time"] = full_like(
            self.state["last_firing_time"], NEVER)

    def reset_history(self):
        self.grid_history.reset()
        self.graph_history.clear()

    # -- simulation -------------------------------------------------------------
    def _history_items(self):
        if not self.update_grid_history:
            return ()
        return (("grid", self.grid_history),)

    def run_lattice(self, iterations):
        """`RunLattice::run_lattice` (neuron/mod.rs:1209-1219)."""
        if iterations == 0 or (not self.electrical_synapse
                               and not self.chemical_synapse):
            return
        from ..utils.transfer import ensure_device_state
        self.state = ensure_device_state(self.state)  # lazy-populate ship
        from .history import history_step_bytes, resolve_history_chunk
        bps = 0
        if self.update_grid_history:
            bps += history_step_bytes(self.grid_history.kind, self.n)
        if self.update_graph_history:
            bps += 4 * int(self.graph.weights.size)
        hchunk = resolve_history_chunk(self.history_chunk, bps)
        remaining = iterations
        while remaining > 0:
            chunk = min(remaining, hchunk) \
                if (self.update_grid_history or self.update_graph_history) \
                else remaining
            self._run_chunk(chunk)
            remaining -= chunk

    def _run_chunk(self, length):
        # Static fast path: no neurotransmitters inserted -> skip the masked
        # no-op (N, K) concentration update inside the scan entirely.
        skip_nt = not bool(jnp.any(self.state["nt$mask"]))
        use_kernel = False
        if stencil_kernel.resolve(self.use_kernel):
            reasons = stencil_kernel.why_not(self,
                                             forced=bool(self.use_kernel))
            if reasons and self.use_kernel:
                raise GraphError("use_kernel=True, but the CUDA stencil "
                                 "kernel cannot run: " + "; ".join(reasons))
            use_kernel = not reasons
        self._last_run_kernel = use_kernel
        runner = _build_lattice_runner(
            self.model, type(self.graph), self.electrical_synapse,
            self.chemical_synapse, self.do_plasticity, type(self.plasticity),
            tuple((name, h.kind, _freeze(h)) for name, h in self._history_items()),
            self.update_graph_history, (self.rows, self.cols), length, skip_nt,
            use_kernel, resolve_unroll(self.scan_unroll))
        pparams = {k: jnp.float32(v) for k, v in self.plasticity.params.items()}
        state, graph, key, clock, ys = runner(
            self.state, self.graph, self.key,
            jnp.int32(self.internal_clock), pparams)
        self.state, self.graph, self.key = state, graph, key
        self.internal_clock += length
        for name, hist in self._history_items():
            hist.extend(ys[name])
        if self.update_graph_history:
            self.graph_history.extend(np.asarray(ys["__weights__"]))

    def update(self):
        """UnsupervisedAgent impl (neuron/mod.rs:1256-1262): one step."""
        self.run_lattice(1)

    # -- views ---------------------------------------------------------------
    def voltages(self):
        return np.asarray(self.state["v"]).reshape(self.rows, self.cols)

    def field(self, name):
        arr = np.asarray(self.state[name])
        if arr.ndim == 1 and arr.shape[0] == self.n:
            return arr.reshape(self.rows, self.cols)
        return arr


def lattice_step(model, electrical, chemical, do_plasticity, skip_nt,
                 plasticity, pparams, state, graph, clock):
    """One single-lattice step (Phase A gather + model update + deferred
    plasticity; neuron/mod.rs:884-982).  Pure; shared by the lattice runner
    and the fused environment loop (interactable.JitEnvironment.run)."""
    if electrical:
        sub_v = jnp.ones_like(state["v"])
        elec = graph.gather_electrical(
            state["v"], sub_v, state["v"], state["gap_conductance"])
    else:
        elec = jnp.zeros_like(state["v"])

    if chemical:
        t, mask = get_neurotransmitter_concentrations(state)
        t_in, t_valid = graph.gather_chemical(t, mask.astype(jnp.float32))
        state, spikes = model.step(state, elec, t_in, t_valid,
                                   skip_nt=skip_nt)
    else:
        state, spikes = model.step(state, elec, skip_nt=skip_nt)

    state["last_firing_time"] = jnp.where(
        spikes, clock, state["last_firing_time"])

    if do_plasticity:
        graph = plasticity.apply(graph, state, pparams)

    return state, graph, clock + 1


def _freeze(hist):
    """Hashable signature of a history readout (for the jit cache)."""
    if hasattr(hist, "reference_voltage"):
        return (hist.kind, hist.reference_voltage, hist.distance,
                hist.conductivity)
    return (hist.kind,)


@functools.lru_cache(maxsize=None)
def _build_lattice_runner(model, graph_cls, electrical, chemical,
                          do_plasticity, plasticity_cls, history_sig,
                          graph_history, shape, length, skip_nt=False,
                          use_kernel=False, unroll=1):
    from .history import HISTORY_KINDS

    # Rebuild readout objects from their frozen signatures.
    readouts = []
    for name, kind, sig in history_sig:
        cls = HISTORY_KINDS[kind]
        h = cls(*sig[1:]) if len(sig) > 1 else cls()
        readouts.append((name, h))

    plasticity = plasticity_cls()

    if use_kernel:
        # electrical Izhikevich on a StencilGraph without histories:
        # launches of K steps of the CUDA kernel (ops/stencil_kernel.py)
        def run_kernel(state, graph, key, clock, pparams):
            state, clock = stencil_kernel.run_lattice_kernel(
                state, graph, clock, length, unroll=unroll)
            return state, graph, key, clock, {}

        return jax.jit(run_kernel, donate_argnums=(0,))

    def one_step(pparams, carry, _):
        state, graph, key, clock = carry

        state, graph, clock = lattice_step(
            model, electrical, chemical, do_plasticity, skip_nt, plasticity,
            pparams, state, graph, clock)

        ys = {name: h.readout(state, shape) for name, h in readouts}
        if graph_history:
            ys["__weights__"] = graph.weights
        return (state, graph, key, clock), ys

    def run(state, graph, key, clock, pparams):
        step = functools.partial(one_step, pparams)
        (state, graph, key, clock), ys = jax.lax.scan(
            step, (state, graph, key, clock), None, length=length,
            unroll=unroll)
        return state, graph, key, clock, ys

    return jax.jit(run, donate_argnums=(0, 1))
