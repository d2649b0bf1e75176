"""Shard ONE lattice's state + adjacency across a device mesh.

This is the scale-out the reference never had (SURVEY.md §2.5
tensor/model-parallel row): its GPU runtime moves the whole problem onto a
single device (`reference/backend/src/neuron/gpu_lattices/mod.rs:
791-896`); here the (rows, cols) neuron grid is split into row blocks, one
per device along a 1-D ``("tp",)`` mesh, and the same jitted `lax.scan`
runners compile to SPMD programs over the mesh.

Design: **sharding by data placement, not by rewritten kernels.**  All
lattice runtimes are already pure elementwise/stencil/matvec programs, so
placing the inputs with `NamedSharding` and letting GSPMD partition the
compiled program is the whole mechanism:

* state leaves ``(N, ...)`` are row-block sharded ``P("tp", ...)`` — the
  flat neuron axis is row-major, so a flat shard boundary coincides with a
  grid row boundary whenever ``rows % n_devices == 0``;
* :class:`~..ops.graph.StencilGraph` planes ``(n_off, rows, cols)`` are
  sharded on the row axis ``P(None, "tp", None)``; the pad + static-slice
  halo reads become XLA collective-permutes of ``halo_p`` boundary rows
  between devices — exactly the halo exchange a hand-written shard_map would do,
  but derived by the partitioner and fused with the neuron update;
* :class:`~..ops.graph.DenseGraph` weight matrices are column-sharded
  ``P(None, "tp")`` (the classic column-parallel matvec: one all-gather of
  the presynaptic vector, weights never move);
* :class:`~..ops.graph.SparseGraph` COO stays replicated (edge scatter
  orders are data-dependent; the segment-sum output adopts the state
  sharding downstream).

Because every runner donates its carry, the output buffers keep these
shardings and subsequent calls reuse the same SPMD executable: calling
:func:`shard_lattice` once after `populate`/`connect` permanently moves the
simulation onto the mesh.  Sharded runs are BIT-IDENTICAL to single-device
runs for stencil/elementwise paths (verified in tests/test_parallel.py):
the partitioned program performs the same per-element arithmetic.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.graph import DenseGraph, SparseGraph, StencilGraph


def make_lattice_mesh(n_devices=None, devices=None, axis="tp"):
    """A 1-D mesh over the neuron/row axis.  Raises when fewer devices
    exist than requested — pass ``devices=jax.devices("cpu")`` explicitly
    for a virtual CPU mesh (a silent CPU substitution would make a GPU
    benchmark transparently run on host)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def _put(leaf, sharding):
    if not sharding.is_fully_addressable and hasattr(leaf, "__array__"):
        # Multi-process mesh: `jax.device_put` accepts only HOST inputs for
        # global (non-fully-addressable) shardings — it assembles the global
        # array from each process's identical copy.  populate/connect build
        # every leaf deterministically host-side, so pulling a locally
        # committed leaf back to NumPy is lossless here.
        leaf = np.asarray(leaf)
    return jax.device_put(leaf, sharding)


def state_spec(mesh, n, leaf, axis="tp", rows=None):
    """Row-block sharding for an (N, ...) state leaf; replicate otherwise.

    When ``rows`` is given (grid-shaped lattices), the flat shard boundary
    must coincide with a grid ROW boundary — otherwise the stencil planes
    stay replicated while the state is sharded mid-row and GSPMD inserts a
    full reshard every step."""
    divisible = (rows % mesh.size == 0) if rows else (n % mesh.size == 0)
    if hasattr(leaf, "ndim") and leaf.ndim >= 1 and leaf.shape[0] == n \
            and divisible:
        return NamedSharding(mesh, P(axis, *([None] * (leaf.ndim - 1))))
    return NamedSharding(mesh, P())


def shard_state(state, mesh, n, axis="tp", rows=None):
    return {k: _put(v, state_spec(mesh, n, v, axis, rows))
            for k, v in sorted(state.items())}


def shard_graph(graph, mesh, axis="tp"):
    if isinstance(graph, StencilGraph):
        rows = graph.shape[0]
        if rows % mesh.size != 0:
            return graph  # unsplittable rows: leave on default placement
        wspec = NamedSharding(mesh, P(None, axis, None))
        dspec = NamedSharding(mesh, P(axis, None))
        return StencilGraph(graph.offsets, _put(graph.weights, wspec),
                            _put(graph.mask, wspec),
                            _put(graph.in_deg, dspec))
    if isinstance(graph, DenseGraph):
        if graph.n_post % mesh.size != 0:
            return graph
        wspec = NamedSharding(mesh, P(None, axis))
        return DenseGraph(_put(graph.weights, wspec), _put(graph.mask, wspec))
    if isinstance(graph, SparseGraph):
        rep = NamedSharding(mesh, P())
        deg = (NamedSharding(mesh, P(axis))
               if graph.n_post % mesh.size == 0 else rep)
        return SparseGraph(_put(graph.src, rep), _put(graph.dst, rep),
                           _put(graph.weights, rep), graph.n_pre,
                           graph.n_post, _put(graph.in_deg, deg))
    return graph


def shard_lattice(lattice, mesh, axis="tp"):
    """Move a Lattice / RewardModulatedLattice / SpikeTrainLattice onto the
    mesh.  Call after `populate`/`connect` (those rebuild host-side arrays);
    idempotent and cheap to re-call."""
    if lattice.state is not None:
        lattice.state = shard_state(lattice.state, mesh, lattice.n, axis,
                                    rows=lattice.rows or None)
    graph = getattr(lattice, "graph", None)
    if graph is not None:
        lattice.graph = shard_graph(graph, mesh, axis)
        trace = getattr(lattice, "trace", None)
        if trace is not None:
            # trace planes are shaped like graph.weights
            spec = (lattice.graph.weights.sharding
                    if hasattr(lattice.graph, "weights")
                    else NamedSharding(mesh, P()))
            lattice.trace = {k: _put(v, spec) for k, v in sorted(trace.items())}
    lattice.mesh = mesh
    return lattice


def shard_network(net, mesh, axis="tp"):
    """Shard every lattice of a LatticeNetwork for the structured runner:
    each lattice's state/graph is row-block sharded independently; the
    flat-COO fallback path replicates connection blocks."""
    for lat in net.lattices.values():
        shard_lattice(lat, mesh, axis)
    for lat in getattr(net, "reward_modulated_lattices", {}).values():
        shard_lattice(lat, mesh, axis)
    for st in net.spike_train_lattices.values():
        shard_lattice(st, mesh, axis)
    net._conn_version += 1  # invalidate cached structured plans
    net.mesh = mesh
    return net
