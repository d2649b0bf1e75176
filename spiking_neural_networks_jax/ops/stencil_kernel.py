"""Temporal-blocked electrical Izhikevich lattice kernel (CUDA, Hopper).

The flagship lattice -- Izhikevich neurons coupled by gap junctions over a
local `StencilGraph` -- spends its XLA step streaming every weight plane,
the in-degree plane, nine parameter planes and the state through device
memory once per step.  `ops/cuda/izhikevich_stencil.cu` advances K steps
per launch instead: each block holds an extended tile (its core plus an
apron of K * 2 cells) in shared memory, computes all K steps on it and
keeps only the core, so the weight planes are read once per launch and the
spatially uniform parameters ride as nine scalars.  The kernel computes
the flagship's stencil only, gap junctions within radius 2: the one it was
measured on.

This module builds that kernel with ``nvcc`` (at first use, or by
``python -m spiking_neural_networks_jax.ops.stencil_kernel``) into
``ops/cuda/build/``, registers it with ``jax.ffi``, decides where the
kernel engages (`why_not`), and keeps the plain-JAX form of the same
tile-and-discard algorithm (`izhikevich_multistep_reference`, for any
stencil) that the kernel is compared with on the card and that the CPU
tests check against the per-step XLA path.

CUDA has no interpret mode: asking for the kernel on a backend other than
``gpu`` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import jax
import jax.numpy as jnp

from .graph import radius_offsets

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda",
                    "izhikevich_stencil.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_SRC), "build")
_TARGET = "snn_izhikevich_stencil"

# Izhikevich parameters the kernel takes as scalars, in its order
PARAM_ORDER = ("a", "b", "c", "d", "v_th", "gap_conductance", "tau_m",
               "c_m", "dt")

# The one stencil the kernel computes: gap junctions within radius 2 (the
# flagship's, 12 offsets reaching 2 cells), on extended tiles of 64 x 64
# cells with an apron of 2 K, K = 4 steps per launch (a 48 x 48 core; the
# 12 weight planes and the voltage plane take 215,104 bytes of the 227 KB
# of shared memory a block may have).  The kernel takes K of 1 to 4; a
# run's remainder takes a shorter launch.  `python bench.py --settings` on
# an H100 (700 W limit, read after the run), flagship lattice, median
# steps/s of 5 rounds in turns at 4096x4096: K = 4 2,021, K = 3 1,949,
# K = 2 1,526 (K = 4 ahead of K = 3 by 4-13% in every round); 4 launches
# per loop iteration ahead of 1 by 7-12% (2,021 vs 1,833).  K = 8 (a
# 32 x 32 core) ran 1,755 against K = 4's 2,646 in an earlier run.
OFFSETS = radius_offsets(2.0)
PAD = 2
TILE = 64
STEPS = 4

# Smallest lattice the kernel takes.  `python bench.py --gate --rounds 20`
# on an H100 (700 W limit), flagship lattice, median steps/s of the XLA
# path vs the kernel, and the kernel's median gain over XLA in the same
# round: 101.2k vs 104.7k at 512x512 (1.03x; from 0.58x to 1.34x, 3 rounds
# of 20 lost), 21.5k vs 29.4k at 1024x1024 (1.37x, every round won), 6,146
# vs 9,726 at 2048x2048 (1.58x) and 1,670 vs 2,685 at 4096x4096 (1.61x).
# Below 2^20 neurons the XLA step's planes stay in the 50 MB L2 and XLA
# keeps up.
MIN_NEURONS = 1 << 20


def resolve(setting):
    """Resolve a lattice's ``use_kernel`` setting to a bool.

    None (auto) turns the kernel on where JAX's backend is ``gpu``.
    True demands it and raises elsewhere, since the CUDA kernel has no
    interpret mode; False keeps the XLA path."""
    on_gpu = jax.default_backend() == "gpu"
    if setting is None:
        return on_gpu
    if setting and not on_gpu:
        raise RuntimeError(
            "the CUDA stencil kernel runs only on a GPU backend (JAX "
            f"backend is {jax.default_backend()!r}); set use_kernel=False "
            "or None")
    return bool(setting)


def stencil_pad(offsets):
    """Largest |dr| or |dc| of a stencil: the apron one step needs."""
    return max(max(abs(dr), abs(dc)) for dr, dc in offsets)


def why_not(lat, forced=False):
    """Reasons `lat`'s next run cannot take the kernel; empty when it can.

    The kernel's class: an Izhikevich `Lattice` with electrical synapses
    only, over a StencilGraph of the radius-2 stencil (OFFSETS), with no
    plasticity, no history, no inserted neurotransmitters, one device and
    spatially uniform parameters (checked with one device reduction).
    Unless ``forced`` (``use_kernel=True``), the lattice must also hold at
    least MIN_NEURONS, below which the kernel does not pay."""
    from ..core.lattice import Lattice
    from ..models.integrate_and_fire import Izhikevich
    from .graph import StencilGraph
    if not isinstance(lat, Lattice):
        raise TypeError(f"why_not: expected a Lattice, got {type(lat)!r}")
    reasons = []
    if not forced and lat.n < MIN_NEURONS:
        reasons.append(f"{lat.rows}x{lat.cols} is below MIN_NEURONS, where "
                       "the XLA step is as fast")
    if type(lat.model) is not Izhikevich:
        reasons.append(f"model {type(lat.model).__name__} is not Izhikevich")
    if not isinstance(lat.graph, StencilGraph):
        reasons.append(f"graph {type(lat.graph).__name__} is not a "
                       "StencilGraph")
    elif lat.graph.offsets != OFFSETS:
        reasons.append(f"the stencil of {len(lat.graph.offsets)} offsets is "
                       "not the radius-2 stencil the kernel computes")
    if not lat.electrical_synapse or lat.chemical_synapse:
        reasons.append("synapses are not electrical only")
    if lat.do_plasticity:
        reasons.append("plasticity is on")
    if lat.update_grid_history or lat.update_graph_history:
        reasons.append("a grid or graph history is recorded")
    if lat.mesh is not None:
        reasons.append("the lattice is sharded over a mesh")
    if reasons:
        return reasons
    if bool(jnp.any(lat.state["nt$mask"])):
        reasons.append("neurotransmitters are inserted")
    if not uniform_params(lat.state):
        reasons.append("Izhikevich parameters vary across the lattice")
    return reasons


@functools.partial(jax.jit, static_argnames=("keys",))
def _param_spans(state, keys):
    return [(jnp.min(state[k]), jnp.max(state[k])) for k in keys]


def uniform_params(state, keys=PARAM_ORDER):
    """Whether every parameter plane holds one value (one host fetch)."""
    spans = jax.device_get(_param_spans(state, tuple(keys)))
    return all(float(lo) == float(hi) for lo, hi in spans)


# -- build and registration ---------------------------------------------------


def _library_path():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libsnn_stencil_{digest}.so")


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA stencil kernel cannot be "
                       "built (install the CUDA toolkit or use_kernel=False)")


def build():
    """Compile the kernel for sm_90a unless the build for this source
    exists; returns the shared library's path.  Raises on failure."""
    path = _library_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError("building the CUDA stencil kernel failed:\n"
                           + " ".join(cmd) + "\n" + proc.stderr)
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def _register():
    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.SnnIzhikevichStencil),
        platform="CUDA")
    return True


# -- the kernel and its plain-JAX form ----------------------------------------


def izhikevich_multistep(v, w, lft, wst, in_deg, params, clock, offsets,
                         n_steps):
    """``n_steps`` (1 to STEPS) electrical Izhikevich steps in one kernel
    launch.

    ``v``, ``w``, ``lft`` (int32) and ``in_deg`` are (rows, cols) planes,
    ``wst`` the (12, rows, cols) weights of ``offsets``, which must be
    OFFSETS, ``params`` the (9,) scalars in PARAM_ORDER and ``clock`` the
    step count of the first step.  Returns (v, w, last_firing_time, spikes
    of the last step as bool)."""
    if tuple(map(tuple, offsets)) != OFFSETS:
        raise ValueError("the CUDA stencil kernel computes the radius-2 "
                         f"stencil only, not {offsets}")
    if not 1 <= n_steps <= STEPS:
        raise ValueError(f"n_steps {n_steps} is not 1 to {STEPS}")
    _register()
    rows, cols = v.shape
    plane = functools.partial(jax.ShapeDtypeStruct, (rows, cols))
    call = jax.ffi.ffi_call(
        _TARGET, (plane(jnp.float32), plane(jnp.float32), plane(jnp.int32),
                  plane(jnp.bool_)))
    return call(v, w, lft, wst, in_deg, params,
                jnp.reshape(jnp.asarray(clock, jnp.int32), (1,)),
                n_steps=np.int64(n_steps))


def izhikevich_multistep_reference(v, w, lft, wst, in_deg, params, clock,
                                   offsets, n_steps):
    """The kernel's algorithm in plain JAX, with its signature, for any
    stencil that leaves the TILE x TILE tile a core.

    The grid is cut into the same extended tiles, each tile runs
    ``n_steps`` steps on its own copy with zeros past its edge, and the
    cores are stitched back.  It computes each cell the way
    `core.lattice.lattice_step` does, so on one backend it agrees bit for
    bit with the per-step XLA path; the kernel differs from it only by
    the FMA contraction and operation order of its compiler."""
    rows, cols = v.shape
    pad = stencil_pad(offsets)
    halo = n_steps * pad
    te_h = te_w = TILE
    ch, cw = te_h - 2 * halo, te_w - 2 * halo
    nby, nbx = -(-rows // ch), -(-cols // cw)
    a, b, c, d, v_th, gap, tau_m, c_m, dt = (params[i] for i in range(9))
    dt_cm, dt_tau = dt / c_m, dt / tau_m
    clock = jnp.asarray(clock, jnp.int32)

    # neighbor-off-grid weights are zeroed at load, as in the kernel
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    on_grid = np.stack([(rr + dr >= 0) & (rr + dr < rows) & (cc + dc >= 0)
                        & (cc + dc < cols) for dr, dc in offsets])
    wst = jnp.where(on_grid, wst, 0.0)
    cnt = jnp.maximum(in_deg, 1.0)

    # tile t covers grid rows by*ch - halo + [0, te_h) (same for columns)
    ridx = np.arange(nby)[:, None] * ch - halo + np.arange(te_h)[None]
    cidx = np.arange(nbx)[:, None] * cw - halo + np.arange(te_w)[None]
    live = ((ridx >= 0) & (ridx < rows))[:, None, :, None] \
        & ((cidx >= 0) & (cidx < cols))[None, :, None, :]
    rcl, ccl = np.clip(ridx, 0, rows - 1), np.clip(cidx, 0, cols - 1)

    def tiles(x):          # (..., rows, cols) -> (..., nby, nbx, te_h, te_w)
        t = x[..., rcl[:, None, :, None], ccl[None, :, None, :]]
        return jnp.where(live, t, jnp.zeros((), x.dtype))

    vt, wt, lt = tiles(v), tiles(w), tiles(lft)
    wstt, cntt = tiles(wst), tiles(cnt)
    spk = jnp.zeros(vt.shape, bool)
    for k in range(n_steps):
        vp = jnp.pad(vt, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
        acc = jnp.zeros_like(vt)
        for o, (dr, dc) in enumerate(offsets):
            sv = vp[..., pad + dr:pad + dr + te_h, pad + dc:pad + dc + te_w]
            acc = acc + wstt[o] * (sv - vt)
        i_syn = gap * acc / cntt
        dv = (0.04 * vt * vt + 5.0 * vt + 140.0 - wt + i_syn) * dt_cm
        dw = (a * (b * vt - wt)) * dt_tau
        v_new, w_new = vt + dv, wt + dw
        s = (v_new >= v_th) & live
        vt = jnp.where(live, jnp.where(s, c, v_new), 0.0)
        wt = jnp.where(live, jnp.where(s, w_new + d, w_new), 0.0)
        lt = jnp.where(s, clock + k, lt)
        spk = s

    def stitch(t):         # cores of (nby, nbx, te_h, te_w) -> (rows, cols)
        core = t[:, :, halo:halo + ch, halo:halo + cw]
        return core.transpose(0, 2, 1, 3).reshape(
            nby * ch, nbx * cw)[:rows, :cols]

    return stitch(vt), stitch(wt), stitch(lt), stitch(spk)


def lattice_params(state):
    """The (9,) uniform parameters in PARAM_ORDER, read from neuron 0."""
    return jnp.stack([state[k].reshape(-1)[0] for k in PARAM_ORDER])


def lattice_multistep(state, graph, clock, n_steps, impl, params=None):
    """Advance a flat lattice state ``n_steps`` with ``impl`` (the kernel
    or its reference), returning the new state dict."""
    rows, cols = graph.shape
    if params is None:
        params = lattice_params(state)

    def plane(name):
        return state[name].reshape(rows, cols)

    v, w, lft, spk = impl(
        plane("v"), plane("w"), plane("last_firing_time"), graph.weights,
        graph.in_deg, params, clock, graph.offsets, n_steps)
    new = dict(state)
    new["v"] = v.reshape(-1)
    new["w"] = w.reshape(-1)
    new["last_firing_time"] = lft.reshape(-1)
    new["is_spiking"] = spk.reshape(-1)
    return new


def run_lattice_kernel(state, graph, clock, length, impl=None, unroll=1,
                       k=STEPS):
    """``length`` steps as launches of ``k`` steps (plus one shorter launch
    for the remainder), ``unroll`` launches per loop iteration.
    Traceable: the caller jits it."""
    impl = impl or izhikevich_multistep
    params = lattice_params(state)
    n_launch, rem = divmod(length, k)
    if n_launch:
        def launch(carry, _):
            st, ck = carry
            st = lattice_multistep(st, graph, ck, k, impl, params)
            return (st, ck + k), None

        (state, clock), _ = jax.lax.scan(launch, (state, clock), None,
                                         length=n_launch, unroll=unroll)
    if rem:
        state = lattice_multistep(state, graph, clock, rem, impl, params)
        clock = clock + rem
    return state, clock


if __name__ == "__main__":
    print(build())
