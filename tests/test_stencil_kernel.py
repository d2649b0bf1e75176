"""The CUDA stencil kernel's wrapper (ops/stencil_kernel.py) on the CPU.

CUDA has no interpret mode, so what runs here is everything around the
kernel: the plain-JAX form of its tile-and-discard algorithm (checked bit
for bit against the per-step XLA runner), the fixed tile and K, the
engagement rule, the wrapper's argument checks, the backend rule, and the
build.  chip_smoke.py compares
the compiled kernel with the same reference on a GPU.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import spiking_neural_networks_jax as snn
from spiking_neural_networks_jax.errors import GraphError
from spiking_neural_networks_jax.ops import stencil_kernel as sk
from spiking_neural_networks_jax.utils.transfer import ensure_device_state


def _lattice(rows, cols, radius=2.0, keep_prob=0.8, seed=42, weight_fn=None):
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=radius, keep_prob=keep_prob, seed=seed,
                        weight_fn=weight_fn)
    v0 = np.random.default_rng(seed).uniform(-65, 30, rows * cols)
    lat.apply(lambda s: {**s, "v": v0.astype(np.float32)})
    return lat


def _reference_run(lat, steps, k=sk.STEPS):
    state = ensure_device_state(lat.state)
    lat.state = state
    run = jax.jit(lambda s, g: sk.run_lattice_kernel(
        s, g, jnp.int32(lat.internal_clock), steps,
        impl=sk.izhikevich_multistep_reference, k=k)[0])
    return run(dict(state), lat.graph)


@pytest.mark.parametrize("rows,cols,radius,keep_prob,steps", [
    (10, 10, 2.0, 0.8, 7),      # the verify flow's grid, one block
    (37, 53, 2.0, 0.8, 9),      # odd sizes: two launches and a remainder
    (12, 12, 1.0, 0.9, 20),     # nearest neighbours
    (8, 192, 1.0, 0.9, 20),     # wide rows: several column blocks
    (32, 128, 2.0, 0.7, 5),     # one launch of K plus a remainder of 1
    (100, 130, 2.0, 0.8, 8),    # 3 x 3 blocks with aprons crossing cores
    (70, 70, 1.5, 1.0, 13),     # diagonal stencil, every edge kept
    (5, 130, 3.0, 0.5, 6),      # radius 3: apron of 3 per step, 40 core
    (1, 1, 1.0, 1.0, 10),       # a single neuron with no neighbours
])
def test_reference_matches_xla_runner_bit_exact(rows, cols, radius,
                                                keep_prob, steps):
    """The tile-and-discard algorithm in plain JAX equals the per-step XLA
    lattice runner bit for bit on one backend: the aprons hide every edge
    effect of the tiling."""
    lat = _lattice(rows, cols, radius, keep_prob)
    ref = _reference_run(lat, steps)
    lat.use_kernel = False
    lat.run_lattice(steps)
    for k in ("v", "w", "last_firing_time", "is_spiking"):
        np.testing.assert_array_equal(np.asarray(ref[k]),
                                      np.asarray(lat.state[k]), err_msg=k)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_reference_matches_with_shorter_launches(k):
    """Launches of fewer steps than STEPS (a run's remainder, and the K
    that `bench.py --settings` compares) keep the same core exactly."""
    lat = _lattice(70, 90)
    ref = _reference_run(lat, 11, k=k)
    lat.run_lattice(11)
    for key in ("v", "w", "last_firing_time", "is_spiking"):
        np.testing.assert_array_equal(np.asarray(ref[key]),
                                      np.asarray(lat.state[key]), err_msg=key)


def test_reference_matches_from_a_later_clock():
    """From a state the XLA path has already advanced: the kernel's
    `last_firing_time` continues the lattice's clock."""
    lat = _lattice(40, 36)
    lat.run_lattice(11)
    ref = _reference_run(lat, 9)
    lat.run_lattice(9)
    for k in ("v", "w", "last_firing_time", "is_spiking"):
        np.testing.assert_array_equal(np.asarray(ref[k]),
                                      np.asarray(lat.state[k]), err_msg=k)


def test_reference_matches_with_weight_function():
    """Non-unit weights: where a product no longer is exact, XLA may
    contract a multiply-add into an FMA in one program and not in the
    other, so v and w agree to a few ulp and spikes exactly."""
    lat = _lattice(40, 36, weight_fn=lambda dr, dc, rr, cc:
                   0.5 + 0.01 * (rr % 7) + 0.1 * abs(dr))
    ref = _reference_run(lat, 9)
    lat.run_lattice(9)
    for k in ("v", "w"):
        np.testing.assert_allclose(np.asarray(ref[k]),
                                   np.asarray(lat.state[k]),
                                   rtol=1e-6, atol=1e-5, err_msg=k)
    for k in ("last_firing_time", "is_spiking"):
        np.testing.assert_array_equal(np.asarray(ref[k]),
                                      np.asarray(lat.state[k]), err_msg=k)


def test_reference_ignores_weights_of_off_grid_neighbours():
    """A weight plane that is nonzero where the neighbour lies off the grid
    contributes nothing, as in the XLA gather (zero padding)."""
    lat = _lattice(16, 16, keep_prob=1.0)
    lat.state = ensure_device_state(lat.state)
    g = lat.graph
    full = snn.StencilGraph(g.offsets, jnp.ones_like(g.weights), g.mask,
                            g.in_deg)
    lat.graph = full
    ref = _reference_run(lat, 6)
    lat.run_lattice(6)
    np.testing.assert_array_equal(np.asarray(ref["v"]),
                                  np.asarray(lat.state["v"]))


def test_flagship_tile_is_64_by_64_with_4_steps():
    """The radius-2 stencil (12 offsets reaching 2) on a 64 x 64 tile with
    an apron of 2 K = 8 keeps a 48 x 48 core, at least half the tile, and
    its weight and voltage planes fit a block's 227 KB of shared memory."""
    assert sk.OFFSETS == snn.radius_offsets(2.0)
    assert len(sk.OFFSETS) == 12 and sk.stencil_pad(sk.OFFSETS) == sk.PAD
    assert (sk.TILE, sk.STEPS) == (64, 4)
    core = sk.TILE - 2 * sk.STEPS * sk.PAD
    assert core == 48 and core * core >= 0.5 * sk.TILE * sk.TILE
    smem = 4 * (12 * sk.TILE ** 2 + (sk.TILE + 2 * sk.PAD) ** 2)
    assert smem == 215104 <= 232448


@pytest.mark.parametrize("offsets,n_steps,match", [
    (snn.radius_offsets(1.0), 4, "radius-2"),
    (snn.radius_offsets(2.0)[::-1], 4, "radius-2"),
    (snn.radius_offsets(2.0), 0, "n_steps"),
    (snn.radius_offsets(2.0), 5, "n_steps"),
])
def test_kernel_wrapper_rejects_what_it_does_not_compute(offsets, n_steps,
                                                         match):
    """Another stencil, or more steps than the apron allows, is refused
    before the kernel is built or launched."""
    plane = jnp.zeros((8, 8))
    with pytest.raises(ValueError, match=match):
        sk.izhikevich_multistep(plane, plane, plane.astype(jnp.int32),
                                jnp.zeros((len(offsets), 8, 8)), plane,
                                jnp.zeros(9), 0, offsets, n_steps)


@pytest.mark.parametrize("offsets,pad", [
    (((0, 1), (1, 0)), 1), (((-2, 0), (0, 1)), 2), (((1, -3),), 3)])
def test_stencil_pad(offsets, pad):
    assert sk.stencil_pad(offsets) == pad


def _why(configure, monkeypatch):
    monkeypatch.setattr(sk, "MIN_NEURONS", 0)
    lat = _lattice(16, 16)
    configure(lat)
    return sk.why_not(lat)


def _sharded(lat):
    from spiking_neural_networks_jax.parallel import make_lattice_mesh
    lat.shard(make_lattice_mesh(2, devices=jax.devices("cpu")))


def _insert_nt(lat):
    lat.state = lat.model.insert_neurotransmitter(lat.state, "AMPA")


def _vary_params(lat):
    lat.apply(lambda s: {**s, "a": s["a"].at[3].set(0.03)})


def _dense(lat):
    rng = np.random.default_rng(0)
    lat.connect(lambda x, y: x != y and rng.random() < 0.05)


def _radius(radius):
    return lambda lat: lat.connect_stencil(radius=radius)


@pytest.mark.parametrize("configure,expect", [
    (lambda lat: None, None),
    (_dense, "StencilGraph"),
    (lambda lat: setattr(lat, "model", snn.LeakyIzhikevich()), "Izhikevich"),
    (lambda lat: setattr(lat, "chemical_synapse", True), "electrical"),
    (lambda lat: setattr(lat, "do_plasticity", True), "plasticity"),
    (lambda lat: setattr(lat, "update_grid_history", True), "history"),
    (lambda lat: setattr(lat, "update_graph_history", True), "history"),
    (_sharded, "mesh"),
    (_insert_nt, "neurotransmitters"),
    (_vary_params, "vary"),
    (_radius(1.0), "radius-2"),
    (_radius(1.5), "radius-2"),
    (_radius(2.5), "radius-2"),
    (_radius(3.0), "radius-2"),
    (_radius(6.0), "radius-2"),
], ids=["flagship", "dense", "model", "chemical", "plasticity",
        "grid-history", "graph-history", "sharded", "neurotransmitters",
        "params", "radius-1", "radius-1.5", "radius-2.5", "radius-3",
        "radius-6"])
def test_why_not(configure, expect, monkeypatch):
    """Each condition outside the kernel's class gives a reason naming it;
    the flagship configuration gives none."""
    reasons = _why(configure, monkeypatch)
    if expect is None:
        assert reasons == []
    else:
        assert any(expect in r for r in reasons), reasons


@pytest.mark.parametrize("side,engages", [(512, False), (1024, True)])
def test_size_gate(side, engages):
    """The kernel takes lattices of 2^20 neurons and more, where it
    measured faster than XLA on the card."""
    lat = snn.Lattice(snn.Izhikevich())
    lat.populate(side, side, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8)
    assert (sk.why_not(lat) == []) is engages


def test_forcing_skips_only_the_size_rule():
    """use_kernel=True takes a lattice below MIN_NEURONS (the size rule is
    about speed), but not one outside the kernel's class."""
    lat = _lattice(16, 16)
    assert any("MIN_NEURONS" in r for r in sk.why_not(lat))
    assert sk.why_not(lat, forced=True) == []
    lat.do_plasticity = True
    assert sk.why_not(lat, forced=True) == ["plasticity is on"]


def test_why_not_rejects_other_types():
    with pytest.raises(TypeError):
        sk.why_not(object())


@pytest.mark.parametrize("setting,want", [(None, False), (False, False)])
def test_resolve_on_cpu(setting, want):
    assert sk.resolve(setting) is want


def test_forcing_the_kernel_on_cpu_raises():
    """CUDA has no interpret mode: use_kernel=True on the CPU raises
    instead of falling back."""
    with pytest.raises(RuntimeError, match="GPU"):
        sk.resolve(True)
    lat = _lattice(8, 8)
    lat.use_kernel = True
    with pytest.raises(RuntimeError, match="GPU"):
        lat.run_lattice(2)


def test_forcing_the_kernel_outside_its_class_raises(monkeypatch):
    """With a GPU backend, use_kernel=True on a lattice outside the class
    names the reason instead of running XLA silently."""
    monkeypatch.setattr(sk, "resolve", lambda setting: True)
    monkeypatch.setattr(sk, "MIN_NEURONS", 0)
    lat = _lattice(8, 8)
    lat.do_plasticity = True
    lat.use_kernel = True
    with pytest.raises(GraphError, match="plasticity"):
        lat.run_lattice(2)


def test_auto_runs_xla_on_cpu():
    lat = _lattice(8, 8)
    lat.run_lattice(3)
    assert lat._last_run_kernel is False


def test_engaged_runner_calls_the_kernel(monkeypatch):
    """Where the rule engages, the runner advances the lattice in kernel
    launches of K steps; with the reference standing in for the kernel the
    result equals the XLA run."""
    monkeypatch.setattr(sk, "resolve", lambda setting: True)
    monkeypatch.setattr(sk, "MIN_NEURONS", 0)
    monkeypatch.setattr(sk, "izhikevich_multistep",
                        sk.izhikevich_multistep_reference)
    from spiking_neural_networks_jax.core.lattice import _build_lattice_runner
    _build_lattice_runner.cache_clear()
    a = _lattice(30, 30)
    a.run_lattice(10)
    assert a._last_run_kernel is True
    monkeypatch.undo()
    _build_lattice_runner.cache_clear()
    b = _lattice(30, 30)
    b.use_kernel = False
    b.run_lattice(10)
    for k in ("v", "w", "last_firing_time", "is_spiking"):
        np.testing.assert_array_equal(np.asarray(a.state[k]),
                                      np.asarray(b.state[k]), err_msg=k)
    assert a.internal_clock == b.internal_clock == 10


def test_library_path_follows_the_source(monkeypatch, tmp_path):
    """The build is keyed by the source's hash, so an edited kernel is
    rebuilt instead of loading a stale library."""
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(sk, "_SRC", str(src))
    first = sk._library_path()
    src.write_text("// two")
    assert sk._library_path() != first
    assert os.path.dirname(first) == sk._BUILD_DIR


def test_build_failure_raises_and_leaves_nothing(monkeypatch, tmp_path):
    """A failed nvcc raises with its command line, and no partial library
    stays in the build directory."""
    monkeypatch.setattr(sk, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(sk, "_library_path",
                        lambda: str(tmp_path / "lib.so"))
    monkeypatch.setattr(sk, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="building the CUDA stencil"):
        sk.build()
    assert os.listdir(tmp_path) == []


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(sk.shutil, "which", lambda name: None)
    monkeypatch.setattr(sk.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        sk._nvcc()
