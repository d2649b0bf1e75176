"""Pipeline-parallel chain network: one lattice per device.

A 4-stage Izhikevich chain (stage k drives stage k+1 through one-to-one
gap junctions) executes as ONE SPMD program over a ("pp",) mesh: each
device holds a full stage (state + intra-lattice stencil graph) and the
previous stage's membrane voltages arrive by `lax.ppermute` every step.
Because stage k+1 at step t only needs stage k at step t-1 (the two-phase
network semantics), the pipeline has no bubbles — all stages compute
every step.

Run on CPU for a quick look:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/pipelined_network.py
"""

import os

import numpy as np
import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.parallel import make_pipeline_mesh


def build_chain(stages=4, rows=32, cols=32):
    rng = np.random.default_rng(0)
    lats = []
    for k in range(stages):
        lat = snn.Lattice(snn.Izhikevich(), id=k)
        lat.populate(rows, cols, gap_conductance=10.0)
        lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=k)
        v0 = rng.uniform(-65.0, 30.0, rows * cols)
        v0[rng.permutation(rows * cols)[: rows]] = 40.0   # kick stage input
        lat.state["v"] = jnp.asarray(v0, jnp.float32)
        lat.do_plasticity = True
        lats.append(lat)
    net = snn.LatticeNetwork.generate_network(lats, [])
    for k in range(stages - 1):
        net.connect(k, k + 1, lambda a, b: a == b, lambda a, b: 3.0)
    return net


def main():
    stages = min(4, len(jax.devices()))
    net = build_chain(stages=stages)
    mesh = make_pipeline_mesh(stages)
    print(f"pipeline mesh {mesh.devices.shape} on {jax.devices()[0].platform}")

    net.run_lattices_pipelined(1000, mesh=mesh)

    for k in range(stages):
        lat = net.get_lattice(k)
        fired = int((np.asarray(lat.state["last_firing_time"]) >= 0).sum())
        vbar = float(np.asarray(lat.state["v"]).mean())
        print(f"stage {k}: {fired:4d} neurons fired, mean V {vbar:7.2f} mV")


if __name__ == "__main__":
    main()
