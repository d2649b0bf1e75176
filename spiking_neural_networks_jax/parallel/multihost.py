"""Multi-host (DCN) scale-out helpers.

The reference is single-process (SURVEY.md §2.5); this module supplies the
multi-host story for the sharded runtimes:

* :func:`initialize` — one-call `jax.distributed` bootstrap so every host
  sees the global device set.
* :func:`make_hybrid_mesh` — a (dcn, ici) mesh laid out so that the OUTER
  axis maps to host groups (traffic crosses the data-center network) and
  the INNER axis stays within each host (its devices' own interconnect,
  NVLink on a GPU host; the names dcn/ici follow the scaling-book recipe).

Sharding recipe (scaling-book layout): put the high-communication axis on
ICI and the low-communication axis on DCN —

* batched training (`parallel.sharding`): dp (independent lattices, no
  cross-talk beyond none) on the DCN axis, tp (column-parallel weights,
  all-gather per step) on the ICI axis;
* one large lattice (`parallel.lattice_sharding`): row-block halo
  exchanges are nearest-neighbor and small (halo_p rows per step), so the
  row axis can span DCN at large grids; prefer filling the ICI axis first
  (`make_hybrid_mesh(..., prefer_ici=True)` collapses both factors into
  one named axis for `Lattice.shard`).

On a single host everything degrades gracefully: `initialize` is a no-op
without a coordinator, and the hybrid mesh is (1, n_local).

The multi-process path executes for real in
`tests/test_parallel.py::test_multihost_two_process`: two coordinated
`jax.distributed` CPU processes build the (dp=2, tp=2) hybrid mesh and
run a 4-way sharded lattice bit-exact vs a process-local run
(tests/_multihost_worker.py).
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh

_initialized = False


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               **kw):
    """Bootstrap `jax.distributed` across hosts.

    All arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, as
    `jax.distributed.initialize` resolves them).  Safe to call more than
    once and on a single host (no-op when no coordinator can be
    resolved)."""
    global _initialized
    if _initialized:
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    # jax.distributed only reads JAX_COORDINATOR_ADDRESS itself; resolve
    # the process-count vars here so the docstring's env contract holds
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return  # single host: multi-process runs are explicit opt-in
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kw)
    _initialized = True


def make_hybrid_mesh(dcn_axis="dp", ici_axis="tp", devices=None,
                     prefer_ici=False):
    """A 2-D (dcn, ici) mesh: outer axis across hosts, inner axis within
    each host's ICI domain.

    With ``prefer_ici=True`` returns a 1-D mesh named ``ici_axis`` whose
    device order still keeps same-host devices adjacent — the layout for
    sharding ONE large lattice where neighboring row blocks should sit on
    ICI neighbors so halo exchanges cross DCN only at host boundaries."""
    if devices is None:
        devices = jax.devices()
    n_hosts = max(d.process_index for d in devices) + 1
    per_host = len(devices) // n_hosts
    if n_hosts > 1:
        from jax.experimental import mesh_utils
        # granules are PROCESSES here (n_hosts counts process_index);
        # the default groups by slice_index, which differs from process
        # count on pod slices and does not exist on CPU/GPU hosts
        dev = mesh_utils.create_hybrid_device_mesh(
            (per_host,), (n_hosts,), devices=devices,
            process_is_granule=True)
        dev = np.asarray(dev).reshape(n_hosts, per_host)
    else:
        dev = np.asarray(devices).reshape(1, len(devices))
    if prefer_ici:
        return Mesh(dev.reshape(-1), (ici_axis,))
    return Mesh(dev, (dcn_axis, ici_axis))
