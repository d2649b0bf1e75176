"""Steps per second of the simulator's workloads on one accelerator.

Each workload is a builder that returns a `Workload`: ``run(n)`` advances
the simulation n steps through the normal entry points, ``sync()`` waits
for the device, and ``state()`` names the state to check afterwards.

    python bench.py                # every workload: set-up s and steps/s
    python bench.py --gate         # XLA vs the CUDA stencil kernel at
                                   # 512^2 .. 4096^2 (the kernel's size gate)
    python bench.py --settings     # the kernel's K and launches per loop
                                   # iteration, and XLA's scan unroll
    python bench.py --gate --rounds 20

The default mode warms each workload up once (compilation included, and
reported as set-up time), times one more run, and prints one JSON line per
workload.  --gate and --settings warm every arm up, then time them in
turns for a number of rounds (the order reversed every other round, so
that drift in the card's clock falls on all arms alike) and print each
arm's steps/s of every round.  The last line names the device and the
card's power limit.  chip_smoke.py reuses the builders.  A device-level
benchmark with cells, spreads and a ledger is not here yet.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

import spiking_neural_networks_jax as snn

ROOT = os.path.dirname(os.path.abspath(__file__))


def use_compile_cache():
    """JAX's persistent compile cache: JAX_COMPILATION_CACHE_DIR when set,
    else a fixed directory in the checkout (.jax_cache/ is gitignored)."""
    jax.config.update(
        "jax_compilation_cache_dir",
        os.environ.get("JAX_COMPILATION_CACHE_DIR")
        or os.path.join(ROOT, ".jax_cache", "gpu"))


@dataclass
class Workload:
    name: str
    run: Callable[[int], None]
    state: Callable[[], dict]      # flat state dict of the main lattice
    steps: int                     # steps of one timed run


def _sync(state):
    jax.block_until_ready(state())


def flagship(rows=512, steps=2048, use_kernel=None, seed=7):
    """The reference's lattice example (backend/examples/lattice/main.rs):
    Izhikevich neurons, gap junctions within radius 2 kept with
    probability 0.8, dt 0.1."""
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(rows, rows, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=seed)
    v0 = np.random.default_rng(1).uniform(-65.0, 30.0, rows * rows)
    lat.apply(lambda s: {**s, "v": v0.astype(np.float32)})
    lat.use_kernel = use_kernel
    arm = {None: "default", False: "xla", True: "kernel"}[use_kernel]
    return Workload(f"izhikevich_{rows}x{rows}_{arm}", lat.run_lattice,
                    lambda: lat.state, steps), lat


def kernel_launches(rows, steps, k, unroll):
    """The flagship advanced by the CUDA stencil kernel directly, in
    launches of `k` steps with `unroll` launches per loop iteration (the
    lattice's own runner uses ops/stencil_kernel.STEPS and an unroll of
    `scan_unroll`)."""
    from spiking_neural_networks_jax.ops import stencil_kernel as sk
    from spiking_neural_networks_jax.utils.transfer import ensure_device_state
    _, lat = flagship(rows, steps, use_kernel=False)
    lat.state = ensure_device_state(lat.state)
    step = jax.jit(lambda s, g, c: sk.run_lattice_kernel(
        s, g, c, steps, k=k, unroll=unroll)[0], donate_argnums=(0,))

    def run(n):
        if n != steps:
            raise ValueError(f"compiled for {steps} steps, asked for {n}")
        lat.state = step(lat.state, lat.graph, jnp.int32(lat.internal_clock))
        lat.internal_clock += n

    return Workload(f"izhikevich_{rows}x{rows}_kernel_k{k}_unroll{unroll}",
                    run, lambda: lat.state, steps), lat


def hh_stdp(rows=128, steps=2000):
    """Hodgkin-Huxley lattice with AMPA/NMDA/GABA receptors, chemical and
    electrical synapses and STDP."""
    lat = snn.Lattice(snn.HodgkinHuxley())
    lat.populate(rows, rows, gap_conductance=10.0)
    s = lat.state
    for t in ("AMPA", "NMDA", "GABA"):
        s = lat.model.insert_receptor(s, t)
        s = lat.model.insert_neurotransmitter(s, t)
    lat.state = s
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=11)
    lat.chemical_synapse = True
    lat.do_plasticity = True
    lat.plasticity = snn.STDP()
    return Workload(f"hh_stdp_{rows}x{rows}", lat.run_lattice,
                    lambda: lat.state, steps), lat


def reward_network(n_side=32, steps=1500):
    """RewardModulatedLatticeNetwork: an R-STDP lattice, a plastic plain
    lattice and a Poisson drive, with plain and reward-modulated
    connections.  Under the constant reward 0.5 the R-STDP weights grow
    without bound from about step 1,600 and the lattice's voltages leave
    the float32 range near step 5,750 (the same before and after the GPU
    port), so runs stay short."""
    rng = np.random.default_rng(2)
    rlat = snn.RewardModulatedLattice(snn.Izhikevich(), id=0)
    rlat.populate(n_side, n_side, gap_conductance=10.0)
    rlat.connect(lambda x, y: np.hypot(x[0] - y[0], x[1] - y[1]) <= 2
                 and x != y)
    plain = snn.Lattice(snn.Izhikevich(), id=1)
    plain.populate(n_side, n_side, gap_conductance=10.0)
    plain.connect_stencil(radius=2.0, keep_prob=0.8, seed=4)
    plain.do_plasticity = True
    plain.apply(lambda s: {**s, "v": rng.uniform(
        -65, 25, n_side * n_side).astype(np.float32)})
    st = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(), id=2)
    st.populate(n_side, n_side)
    st.state = st.model.init_from_firing_rate(n_side * n_side, hertz=40.0,
                                              dt=0.1)
    net = snn.RewardModulatedLatticeNetwork()
    net.add_lattice(rlat)
    net.add_lattice(plain)
    net.add_spike_train_lattice(st)
    net.connect(2, 1, lambda a, b: a == b, lambda a, b: 5.0)
    net.connect_with_reward_modulation(1, 0, lambda a, b: a == b,
                                       lambda a, b: 1.0)
    return Workload(
        f"reward_network_{n_side}x{n_side}",
        lambda n: net.run_lattices_with_reward(0.5, n),
        lambda: net.get_reward_modulated_lattice(0).state, steps), net


def chemical_network(rows=64, steps=12800):
    """Two Izhikevich lattices with DopaGluGABA receptors and bounded
    kinetics, glutamate release between them and a Poisson drive: the
    chemical class of the reference's science pipelines."""
    from spiking_neural_networks_jax.ops.receptors import (
        DopaGluGABAReceptors)
    rng = np.random.default_rng(7)
    n = rows * rows
    lats = []
    for lid in range(2):
        model = snn.Izhikevich(nt_kinetics="bounded",
                               rec_kinetics="bounded",
                               receptors=DopaGluGABAReceptors("bounded"))
        lat = snn.Lattice(model, id=lid)
        lat.populate(rows, rows, gap_conductance=10.0)
        lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=3 + lid)
        s = model.insert_receptor(lat.state, "Glutamate")
        s = model.insert_receptor(s, "GABA")
        s = dict(model.insert_neurotransmitter(s, "Glutamate"))
        s["v"] = rng.uniform(-70, -40, n).astype(np.float32)
        lat.state = s
        lats.append(lat)
    st = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(nt_kinetics="bounded"),
                               id=2)
    st.populate(rows, rows)
    st.state = st.model.init_from_firing_rate(n, hertz=50.0, dt=0.1)
    st.state = st.model.insert_neurotransmitter(st.state, "AMPA")
    net = snn.LatticeNetwork.generate_network(lats, [st])
    net.connect(2, 0, lambda x, y: x == y, lambda x, y: 3.0)
    net.connect(0, 1, lambda x, y: x == y, lambda x, y: 1.5)
    net.electrical_synapse = False
    net.chemical_synapse = True
    return Workload(f"chemical_network_{rows}x{rows}", net.run_lattices,
                    lambda: net.get_lattice(0).state, steps), net


def closed_loop(side=10, steps=6400):
    """On-device RL loop (interactable.JitEnvironment): reward, R-STDP
    agent update, environment state and cue encoding in one scan."""
    from spiking_neural_networks_jax.interactable import JitEnvironment

    def encoder(e, s):
        fi = jax.lax.iota(jnp.int32, s["v"].shape[0])
        return {**s, "v": jnp.where(fi < 6, jnp.float32(31.0), s["v"])}

    lat = snn.RewardModulatedLattice(snn.Izhikevich())
    lat.populate(side, side, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=1.0, seed=5)
    v0 = np.random.default_rng(0).uniform(-65, 30, side * side)
    lat.apply(lambda s: {**s, "v": v0.astype(np.float32)})
    env = JitEnvironment(
        lat, {"rate": jnp.float32(0.0)}, encoder,
        lambda e, s: jnp.clip(0.08 - e["rate"], -0.05, 0.05),
        lambda e, s: {"rate": 0.9 * e["rate"]
                      + 0.1 * s["is_spiking"].astype(jnp.float32).mean()})
    return Workload(f"closed_loop_{side}x{side}", env.run_with_reward,
                    lambda: lat.state, steps), env


def bayesian_trial(toml="experiments/bayesian_inf_args/smoke.toml"):
    """One run of experiments/bayesian_inference_rate_based.py on a TOML:
    a 7x7 excitatory Hopfield lattice, a 3x3 inhibitory lattice and rate
    spike trains with DopaGluGABA chemistry, built and analysed per trial.
    Returns the experiment's output dict."""
    sys.path.insert(0, os.path.join(ROOT, "experiments"))
    import bayesian_inference_rate_based as b
    return b.main([None, os.path.join(ROOT, toml)])


def measure(work):
    """(setup seconds, steps/s): one warm-up run that compiles, then one
    timed run of the same length."""
    t0 = time.perf_counter()
    work.run(work.steps)
    _sync(work.state)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    work.run(work.steps)
    _sync(work.state)
    return setup, work.steps / (time.perf_counter() - t0)


def in_turns(builders, rounds):
    """Build and warm up every arm, then time one run of each per round,
    in turns, reversing the order every other round.  Returns
    [(workload, setup seconds, [steps/s of each round])]."""
    arms = []
    for build in builders:
        work, _ = build()
        t0 = time.perf_counter()
        work.run(work.steps)
        _sync(work.state)
        arms.append((work, time.perf_counter() - t0, []))
    for r in range(rounds):
        for work, _, rates in (arms if r % 2 == 0 else arms[::-1]):
            t0 = time.perf_counter()
            work.run(work.steps)
            _sync(work.state)
            rates.append(work.steps / (time.perf_counter() - t0))
    return arms


def gate_arms():
    """XLA and the kernel (forced on below its size gate) at each size."""
    sizes = ((512, 2048), (1024, 1024), (2048, 512), (4096, 256))
    return [lambda r=r, n=n, uk=uk: flagship(r, n, uk)
            for r, n in sizes for uk in (False, True)]


def settings_arms():
    """XLA with scan_unroll 1 and 4; the kernel in launches of K = 2, 3
    and 4 steps, 4 launches per loop iteration, and K = 4 with 1."""
    def xla(rows, steps, unroll):
        work, lat = flagship(rows, steps, False)
        lat.scan_unroll = unroll
        work.name += f"_unroll{unroll}"
        return work, lat
    arms = []
    for rows, steps in ((1024, 1024), (4096, 256)):
        arms += [lambda r=rows, n=steps, u=u: xla(r, n, u) for u in (1, 4)]
        arms += [lambda r=rows, n=steps, k=k, u=u: kernel_launches(r, n, k, u)
                 for k, u in ((2, 4), (3, 4), (4, 4), (4, 1))]
    return arms


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def device_info():
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--gate", action="store_true")
    mode.add_argument("--settings", action="store_true")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    use_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {jax.devices()}")
    if args.gate or args.settings:
        arms = in_turns(gate_arms() if args.gate else settings_arms(),
                        args.rounds)
        for work, setup, rates in arms:
            print(json.dumps({"workload": work.name, "steps": work.steps,
                              "setup_s": setup,
                              "median_steps_per_s": float(np.median(rates)),
                              "steps_per_s": rates}), flush=True)
    else:
        builders = [
            lambda: flagship(512, 2048, False), lambda: flagship(512, 2048),
            lambda: flagship(2048, 512, False), lambda: flagship(2048, 512),
            lambda: flagship(4096, 256, False), lambda: flagship(4096, 256),
            hh_stdp, reward_network, chemical_network, closed_loop]
        for build in builders:
            work, _ = build()
            setup, rate = measure(work)
            print(json.dumps({"workload": work.name, "steps": work.steps,
                              "setup_s": setup, "steps_per_s": rate}),
                  flush=True)
    print(json.dumps({"device": device_info(), "card": card()}), flush=True)


if __name__ == "__main__":
    main()
