"""Shard one large Izhikevich lattice across every available device.

The sharding is pure data placement (parallel/lattice_sharding.py): the
(rows, cols) state and the stencil weight planes are split into row blocks,
one per device, and the existing jitted `lax.scan` runner compiles to an
SPMD program whose halo exchanges ride the inter-chip interconnect.  The
result is bit-identical to the single-device run.

Run on CPU for a quick look:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/sharded_lattice.py
"""

import os

import numpy as np
import jax

import jax.numpy as jnp

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.parallel import make_lattice_mesh, shard_lattice


def build(rows=256, cols=256):
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    lat.do_plasticity = True
    v0 = np.random.default_rng(0).uniform(-65.0, 30.0, rows * cols)
    lat.state["v"] = jnp.asarray(v0, jnp.float32)
    return lat


def main():
    devices = jax.devices()
    print(f"{len(devices)} device(s): {devices[0].platform}")

    single = build()
    single.run_lattice(500)
    v_single = np.asarray(single.state["v"])

    mesh = make_lattice_mesh()
    lat = build()
    shard_lattice(lat, mesh)
    lat.run_lattice(500)
    v_sharded = np.asarray(lat.state["v"])

    fired = int((np.asarray(lat.state["last_firing_time"]) >= 0).sum())
    print(f"mesh {mesh.devices.shape}: {fired} neurons fired; "
          f"bit-exact vs single device: {np.array_equal(v_single, v_sharded)}")
    print("state sharding:", lat.state["v"].sharding)


if __name__ == "__main__":
    main()
