"""Worker for tests/test_parallel.py::test_multihost_two_process — one of
two coordinated `jax.distributed` CPU processes.  Asserts the global device
set, builds the hybrid DCN×ICI mesh (parallel/multihost.py), runs a sharded
lattice for 50 steps over the 4-device global mesh, and checks bit-exact
agreement with a process-local single-device run.

Usage: python _multihost_worker.py <process_id> <num_processes> <port>
"""

import os
import sys


def main():
    proc_id, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from spiking_neural_networks_jax.parallel.multihost import (
        initialize, make_hybrid_mesh)
    initialize(coordinator_address=f"127.0.0.1:{port}",
               num_processes=nproc, process_id=proc_id)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 2 * nproc, jax.device_count()
    hybrid = make_hybrid_mesh()
    assert dict(hybrid.shape) == {"dp": nproc, "tp": 2}, hybrid.shape

    import numpy as np
    import jax.numpy as jnp
    import spiking_neural_networks_jax as snn
    from jax.experimental import multihost_utils

    def build():
        lat = snn.Lattice(snn.Izhikevich(), id=0)
        lat.populate(8, 8, gap_conductance=10.0)
        lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
        v0 = np.random.default_rng(3).uniform(-65, 30, 64).astype(np.float32)
        lat.apply(lambda s: {**s, "v": jnp.asarray(v0)})
        return lat

    ref = build()
    ref.run_lattice(50)
    ref_v = np.asarray(ref.state["v"])

    lat = build()
    lat.shard(make_hybrid_mesh(prefer_ici=True))
    lat.run_lattice(50)
    got = np.asarray(
        multihost_utils.process_allgather(lat.state["v"], tiled=True))
    assert np.array_equal(got.reshape(-1)[:64], ref_v), (
        np.abs(got.reshape(-1)[:64] - ref_v).max())
    print(f"proc {proc_id}: MULTIHOST_OK", flush=True)


if __name__ == "__main__":
    main()
