"""Run the simulator's main path on a GPU once and check what comes out.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --multi    # four GPUs: the sharded lattice and the
                                    # pipelined chain, and nothing else

Phases, all in this one process; any failed check raises, and the script
exits non-zero without printing a result:

  device         JAX's first device is a GPU; the card's name, power limit
                 and the JAX version.
  flagship       the reference's lattice example: the 10x10 verify flow
                 (5,000 steps with a grid history), then 512x512 and
                 1024x1024 (the kernel's size gate lies between them) for
                 2,048 steps and 4096x4096 for 256 steps, each on the XLA
                 path and on the default path.
  kernel_vs_xla  the CUDA stencil kernel against its plain-JAX reference
                 and the per-step XLA path: one launch at each size within
                 stated tolerances, then 2,048 steps compared statistically.
  reference      a 64x64 DenseGraph lattice (the matmul path) and a 64x64
                 Hopfield recall against tests/reference_impl.py.
  classes        Hodgkin-Huxley + STDP, the reward network, the chemical
                 network, the closed RL loop and the Bayesian trial.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    """A failed check raises (an `assert` would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# -- checks shared by the phases ----------------------------------------------


def lattice_stats(state, steps):
    """V range, neurons that ever fired, neurons that fired in the last 50
    steps (`last_firing_time` counts steps from the lattice's start)."""
    import numpy as np
    v = np.asarray(state["v"])
    lft = np.asarray(state["last_firing_time"])
    check(np.isfinite(v).all(), "non-finite voltages")
    return {"v_min": float(v.min()), "v_max": float(v.max()),
            "fired": int((lft >= 0).sum()),
            "recent": int((lft >= steps - 50).sum())}


def check_statistically_equal(a, b, rel=0.01, v_tol=1.0):
    """Chaotic trajectories diverge bit by bit, so two long runs of one
    lattice are compared by their statistics: the same V range (within
    `v_tol` mV) and firing counts within `rel`."""
    for k in ("v_min", "v_max"):
        check(abs(a[k] - b[k]) <= v_tol, (k, a, b))
    for k in ("fired", "recent"):
        check(abs(a[k] - b[k]) <= rel * max(a[k], b[k], 1), (k, a, b))


# -- phases -------------------------------------------------------------------


def device_phase():
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {devs}")
    import bench   # fails outside the repo
    smi = bench.card()
    log(smi)   # as nvidia-smi prints it: name, power limit (per card)
    log(f"[device] jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}")
    return smi


def verify_flow(rows=10, steps=5000):
    """The 10x10 flow of the verify notes: random initial voltages, grid
    history of every step.  Returns (history shape, V min, V max, fired)."""
    import numpy as np
    import spiking_neural_networks_jax as snn
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(rows, rows, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=42)
    v0 = np.random.default_rng(0).uniform(-65, 30, rows * rows)
    lat.apply(lambda s: {**s, "v": v0.astype(np.float32)})
    lat.update_grid_history = True
    lat.run_lattice(steps)
    hist = np.stack(lat.grid_history.history)
    check(np.isfinite(hist).all(), "non-finite grid history")
    fired = int((np.asarray(lat.state["last_firing_time"]) >= 0).sum())
    return hist.shape, float(hist.min()), float(hist.max()), fired


def flagship_arms(rows, steps, smi=""):
    """The flagship at one size on the XLA path and on the default path
    (which takes the CUDA kernel where it engages): set-up seconds
    (compilation included), steps/s and end statistics of each arm."""
    import bench
    out = {}
    for use_kernel in (False, None):
        work, lat = bench.flagship(rows, steps, use_kernel)
        setup, rate = bench.measure(work)
        stats = lattice_stats(lat.state, 2 * steps)
        stats.update(setup_s=setup, steps_per_s=rate,
                     kernel=bool(lat._last_run_kernel))
        log(f"[flagship] {work.name}: set-up {setup:.2f} s, {rate:.1f} "
            f"steps/s, {rate * rows * rows:.3e} neuron-updates/s, "
            f"kernel={stats['kernel']} ({smi}) {stats}")
        check(stats["fired"] > 0, "the lattice never fired")
        out[use_kernel] = stats
    check_statistically_equal(out[False], out[None])
    return out


def xla_steps_with_margin(state, graph, clock, steps):
    """`steps` per-step XLA updates of an electrical Izhikevich lattice,
    and per neuron the smallest |pre-reset v - v_th| over those steps."""
    import jax
    import jax.numpy as jnp
    import spiking_neural_networks_jax as snn
    from spiking_neural_networks_jax.core.lattice import lattice_step
    model = snn.Izhikevich()

    @jax.jit
    def one(st, ck, margin, graph):
        elec = graph.gather_electrical(st["v"], jnp.ones_like(st["v"]),
                                       st["v"], st["gap_conductance"])
        v_pre = st["v"] + model.deltas(st, elec)["v"]
        margin = jnp.minimum(margin, jnp.abs(v_pre - st["v_th"]))
        st, _, ck = lattice_step(model, True, False, False, True, None, None,
                                 st, graph, ck)
        return st, ck, margin

    margin = jnp.full_like(state["v"], jnp.inf)
    for _ in range(steps):
        state, clock, margin = one(state, clock, margin, graph)
    return state, margin


def compare_launch(lat, impl, n_steps=None, near=1e-3):
    """One launch of `impl` (the kernel or its reference) against the
    per-step XLA path from the lattice's current state.  v and w must agree
    within rtol 1e-5 / atol 1e-4 (float32 elementwise arithmetic with no
    matmul: only FMA contraction and operation order differ), and
    `last_firing_time` exactly, except at neurons whose pre-reset v came
    within `near` of v_th, where one rounding can flip a spike.  Returns
    (max |dv|, max |dw|, excluded neurons)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from spiking_neural_networks_jax.ops import stencil_kernel as sk
    state = {k: jnp.copy(v) for k, v in lat.state.items()}
    k = n_steps or sk.STEPS
    clock = jnp.int32(lat.internal_clock)
    got = jax.jit(lambda s, g: sk.lattice_multistep(s, g, clock, k, impl))(
        state, lat.graph)
    want, margin = xla_steps_with_margin(state, lat.graph, clock, k)
    ok = np.asarray(margin) >= near
    for key, rtol, atol in (("v", 1e-5, 1e-4), ("w", 1e-5, 1e-4),
                            ("last_firing_time", 0, 0),
                            ("is_spiking", 0, 0)):
        a, b = np.asarray(got[key])[ok], np.asarray(want[key])[ok]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=key)
    dv = np.abs(np.asarray(got["v"], np.float64) - np.asarray(want["v"]))
    dw = np.abs(np.asarray(got["w"], np.float64) - np.asarray(want["w"]))
    return float(dv[ok].max()), float(dw[ok].max()), int((~ok).sum())


def kernel_vs_xla_phase(rows, long_steps=2048, impl=None):
    """At one size: one launch of the kernel and of its plain-JAX reference
    against the XLA path, then `long_steps` steps of the kernel against
    XLA, compared statistically.  `impl` replaces the kernel (the CPU
    tests pass its reference)."""
    import bench
    from spiking_neural_networks_jax.ops import stencil_kernel as sk
    impl = impl or sk.izhikevich_multistep
    _, lat = bench.flagship(rows, long_steps, use_kernel=False)
    lat.run_lattice(3)   # ships the state; start from a state with history
    for name, fn in (("kernel", impl),
                     ("reference", sk.izhikevich_multistep_reference)):
        dv, dw, excluded = compare_launch(lat, fn)
        log(f"[kernel_vs_xla] {rows}x{rows} one launch, {name} vs XLA: "
            f"max |dv| {dv:.3g}, max |dw| {dw:.3g}, {excluded} neurons "
            f"within 1e-3 of v_th excluded")
    stats = {}
    for arm in ("xla", "kernel"):
        _, lat = bench.flagship(rows, long_steps, use_kernel=False)
        if arm == "kernel":
            _run_with_impl(lat, long_steps, impl)
        else:
            lat.run_lattice(long_steps)
        stats[arm] = lattice_stats(lat.state, long_steps)
    log(f"[kernel_vs_xla] {rows}x{rows} {long_steps} steps: "
        f"xla {stats['xla']} kernel {stats['kernel']}")
    check_statistically_equal(stats["xla"], stats["kernel"])


def _run_with_impl(lat, steps, impl):
    """Run a flagship lattice through `run_lattice_kernel` with `impl`
    (the kernel, or its reference where there is no GPU), whatever the
    lattice's own engagement rule says."""
    import jax
    import jax.numpy as jnp
    from spiking_neural_networks_jax.ops import stencil_kernel as sk
    from spiking_neural_networks_jax.utils.transfer import ensure_device_state
    lat.state = ensure_device_state(lat.state)
    state, _ = jax.jit(lambda s, g: sk.run_lattice_kernel(
        s, g, jnp.int32(0), steps, impl))(lat.state, lat.graph)
    lat.state = state


def reference_phase(side=64, steps=5, sweeps=2):
    """A DenseGraph lattice (float32 matmuls at highest precision) and a
    Hopfield recall against the object-per-neuron reference."""
    import numpy as np
    import jax.numpy as jnp
    import spiking_neural_networks_jax as snn
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import reference_impl as ref
    n = side * side
    rng = np.random.default_rng(3)
    mask = rng.random((n, n)) < 0.01
    np.fill_diagonal(mask, False)
    w = np.where(mask, rng.uniform(0.5, 1.5, (n, n)), 0.0).astype(np.float32)
    v0 = rng.uniform(-65, 30, n).astype(np.float32)
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(side, side, gap_conductance=10.0, v=v0)
    lat.graph = snn.DenseGraph(jnp.asarray(w), jnp.asarray(mask))
    lat.update_grid_history = True
    lat.run_lattice(steps)
    got = np.stack(lat.grid_history.history).reshape(steps, n)
    neurons = []
    for i in range(n):
        nr = ref.RefIzhikevich(gap_conductance=10.0)
        nr.v = ref.f32(v0[i])
        neurons.append(nr)
    weights = [[None] * n for _ in range(n)]
    for i, j in zip(*np.nonzero(mask)):
        weights[i][j] = float(w[i, j])
    want, _ = ref.run_ref_lattice(neurons, weights, steps)
    # float32 throughout; the sums differ only in order, so a few ulp of
    # the ~100 mV voltages per step
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    dv = float(np.abs(got - want).max())
    log(f"[reference] {side}x{side} DenseGraph lattice, {steps} steps: "
        f"max |dv| vs scalar reference {dv:.3g} (rtol 1e-5, atol 1e-4)")

    pats = snn.attractors.generate_random_patterns(side, side, 3, 0.5,
                                                   seed=4)
    hw = snn.attractors.generate_hopfield_network(pats)
    cue = snn.attractors.distort_pattern(pats[0], 0.1, seed=5)
    net = snn.attractors.DiscreteNeuronLattice(side, side, hw)
    net.input_pattern_into_discrete_grid(cue)
    start = np.asarray(net.state)
    net.iterate(sweeps)
    recalled = np.asarray(net.state)
    want = ref.run_ref_discrete_hopfield(np.asarray(hw), start, sweeps)
    # integer-valued weights and +/-1 states: every dot product is exact
    np.testing.assert_array_equal(recalled, want)
    overlap = float((recalled == np.where(np.asarray(pats[0]).reshape(-1),
                                          1.0, -1.0)).mean())
    log(f"[reference] {side}x{side} Hopfield recall, {sweeps} sweeps: "
        f"equal to the scalar reference, overlap with the stored pattern "
        f"{overlap:.3f}")
    return dv, overlap


# The V range (mV) a healthy run of each class ends in.  No neuron ends
# above its spike peak: Izhikevich neurons reset at v_th = 30 (the closed
# loop's cue clamps six at 31), Hodgkin-Huxley peaks near +40.  The lower
# bound is physical for HH and the chemical network.  The reward network
# and the closed loop have none: under a constant reward of 0.5, and under
# the closed loop's +0.05 while its rate stays below target, their R-STDP
# weights grow without bound (the reference's rule has no weight limit),
# until the gap-junction current makes the explicit Euler step overshoot
# far below rest.  On the CPU the XLA path computes the same voltages as
# before the GPU port to six digits over 4,000 steps: -69,532 mV after
# 3,000 steps of the reward network and -28,166 mV after 4,000 of the
# closed loop.
V_BOUNDS = {"hh_stdp": (-100.0, 60.0), "chemical_network": (-100.0, 35.0),
            "reward_network": (float("-inf"), 35.0),
            "closed_loop": (float("-inf"), 35.0)}


def check_class(name, *size, smi=""):
    """Build the `bench` workload `name` (with `size` overriding its
    builder's size and steps), run it twice, and check that it ends with
    finite voltages inside V_BOUNDS and some spikes.  Returns steps/s."""
    import bench
    work, _ = getattr(bench, name)(*size)
    setup, rate = bench.measure(work)
    stats = lattice_stats(work.state(), 2 * work.steps)
    check(stats["fired"] > 0, f"{name}: no neuron fired")
    lo, hi = V_BOUNDS[name]
    check(lo <= stats["v_min"] and stats["v_max"] <= hi,
          f"{name}: V range {stats['v_min']} .. {stats['v_max']} mV "
          f"outside [{lo}, {hi}]")
    log(f"[classes] {work.name}: set-up {setup:.2f} s, {rate:.1f} "
        f"steps/s ({smi}) {stats}")
    return rate


def check_bayesian(smi=""):
    """The Bayesian trial of experiments/ on smoke.toml: its accuracies
    must be finite numbers.  Returns the wall seconds."""
    import numpy as np
    import bench
    t0 = time.perf_counter()
    out = bench.bayesian_trial()
    wall = time.perf_counter() - t0
    vals = [v for trial in out.values() for v in trial.values()
            if isinstance(v, (int, float))]
    check(vals and np.isfinite(vals).all(), out)
    log(f"[classes] bayesian trial (smoke.toml): {wall:.2f} s wall "
        f"({smi}) {json.dumps(out)[:300]}")
    return wall


def multi_phase(rows=4096, steps=64, n_dev=4, devices=None):
    """The sharded flagship (row blocks over a 1-D mesh of `n_dev` devices)
    bit-equal to the one-device XLA run, and a 4-stage pipelined chain
    against the structured runner."""
    import numpy as np
    import jax
    import bench
    import spiking_neural_networks_jax as snn
    from spiking_neural_networks_jax.parallel import (make_lattice_mesh,
                                                      make_pipeline_mesh,
                                                      run_pipelined)
    devices = devices or jax.devices()
    _, ref = bench.flagship(rows, steps, use_kernel=False)
    ref.run_lattice(steps)
    _, lat = bench.flagship(rows, steps, use_kernel=False)
    lat.shard(make_lattice_mesh(n_dev, devices=devices))
    t0 = time.perf_counter()
    lat.run_lattice(steps)
    jax.block_until_ready(lat.state["v"])
    log(f"[multi] {rows}x{rows} sharded over {n_dev}: {steps} steps in "
        f"{time.perf_counter() - t0:.2f} s (compilation included)")
    shards = lat.state["v"].addressable_shards
    blocks = sorted((s.index[0].start or 0, s.device.id) for s in shards)
    block = rows * rows // n_dev
    check(len(shards) == n_dev and len({d for _, d in blocks}) == n_dev,
          f"{len(shards)} shards on {n_dev} devices")
    check([b for b, _ in blocks] == [i * block for i in range(n_dev)], blocks)
    for k in ("v", "w", "last_firing_time", "is_spiking"):
        np.testing.assert_array_equal(np.asarray(lat.state[k]),
                                      np.asarray(ref.state[k]), err_msg=k)
    log(f"[multi] one row block of {block} neurons on each device; v, w, "
        f"last_firing_time, is_spiking bit-equal to the one-device run")

    def chain():
        rng = np.random.default_rng(5)
        lats = []
        for k in range(4):
            lat = snn.Lattice(snn.Izhikevich(), id=k)
            lat.populate(16, 16, gap_conductance=10.0)
            lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=20 + k)
            v0 = rng.uniform(-65.0, 30.0, 256)
            v0[rng.permutation(256)[:16]] = 40.0
            lat.apply(lambda s, v0=v0: {**s, "v": v0.astype(np.float32)})
            lat.do_plasticity = True
            lats.append(lat)
        net = snn.LatticeNetwork.generate_network(lats, [])
        for k in range(3):
            net.connect(k, k + 1, lambda a, b: a == b, lambda a, b: 3.0)
        return net

    ref_net = chain()
    ref_net.run_lattices(100)
    pp_net = chain()
    run_pipelined(pp_net, 100, mesh=make_pipeline_mesh(4, devices=devices))
    worst = 0.0
    for k in range(4):
        va = np.asarray(ref_net.get_lattice(k).state["v"])
        vb = np.asarray(pp_net.get_lattice(k).state["v"])
        np.testing.assert_allclose(vb, va, rtol=2e-5, atol=2e-4)
        worst = max(worst, float(np.abs(va - vb).max()))
    log(f"[multi] 4-stage pipelined chain vs structured runner: max |dv| "
        f"{worst:.3g} (rtol 2e-5, atol 2e-4)")


def main(argv):
    import jax
    jax.config.update(
        "jax_compilation_cache_dir",
        os.environ.get("JAX_COMPILATION_CACHE_DIR")
        or os.path.join(ROOT, ".jax_cache", "gpu"))
    sys.path.insert(0, ROOT)
    smi = device_phase()
    if "--multi" in argv:
        if len(jax.devices()) < 4:
            raise SystemExit(f"--multi needs 4 GPUs; JAX found "
                             f"{jax.devices()}")
        multi_phase()
    else:
        from spiking_neural_networks_jax.ops import stencil_kernel as sk
        t0 = time.perf_counter()
        log(f"[flagship] CUDA stencil kernel built: {sk.build()} "
            f"({time.perf_counter() - t0:.1f} s)")
        shape, vmin, vmax, fired = verify_flow()
        log(f"[flagship] verify flow: hist {shape} V range {vmin:.2f} "
            f"{vmax:.2f} fired {fired}")
        check(shape == (5000, 10, 10) and fired == 100, (shape, fired))
        check(-66.0 < vmin < -63.0 and 29.0 < vmax <= 30.0, (vmin, vmax))
        flagship_arms(512, 2048, smi)
        flagship_arms(1024, 2048, smi)
        flagship_arms(4096, 256, smi)
        kernel_vs_xla_phase(512)
        kernel_vs_xla_phase(4096, long_steps=1024)
        reference_phase()
        check_class("hh_stdp", smi=smi)
        check_class("reward_network", smi=smi)
        check_class("chemical_network", 64, 2000, smi=smi)
        check_class("closed_loop", 10, 2000, smi=smi)
        check_bayesian(smi=smi)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
