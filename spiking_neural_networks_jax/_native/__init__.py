"""ctypes bindings for the native graph-construction library.

Builds ``graphlib.cpp`` with g++ on first import into ``_native/build/``
(gitignored), keyed by the source content hash (never a binary checked into the
repo — mtime-based staleness checks break on fresh clones, and a shipped
``-march=native`` binary is both unportable and of unverifiable provenance);
falls back to ``available = False`` so pure-NumPy paths take over when no
toolchain exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "graphlib.cpp")

available = False
_lib = None


def _so_path():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    d = os.path.join(_DIR, "build")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"graphlib-{digest}.so")


def _build(so):
    # plain -O3, host-portable: the hot loops are memory/branch bound and
    # gain nothing measurable from -march=native
    tmp = so + f".tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)


def _load():
    global _lib, available
    try:
        so = _so_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.CalledProcessError):
        # no host C++ toolchain: the NumPy graph builders take over
        available = False
        return

    i64, i32p, f32p, u8p = (ctypes.c_int64,
                            np.ctypeslib.ndpointer(np.int32),
                            np.ctypeslib.ndpointer(np.float32),
                            np.ctypeslib.ndpointer(np.uint8))
    lib.build_radius_edges.restype = ctypes.c_int64
    lib.build_radius_edges.argtypes = [
        i64, i64, ctypes.c_double, ctypes.c_double, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_double, ctypes.c_double, i32p, i32p, f32p]
    lib.build_random_edges.restype = ctypes.c_int64
    lib.build_random_edges.argtypes = [
        i64, i64, ctypes.c_double, ctypes.c_int32, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_double, ctypes.c_double, i32p, i32p, f32p, i64]
    lib.hopfield_accumulate.restype = None
    lib.hopfield_accumulate.argtypes = [
        u8p, i64, i64, ctypes.c_double, ctypes.c_double, ctypes.c_double, f32p]
    lib.in_degree.restype = None
    lib.in_degree.argtypes = [i32p, i64, f32p, i64]
    _lib = lib
    available = True


_load()

WEIGHT_MODES = {"constant": 0, "distance": 1, "inv_distance": 2,
                "gaussian": 3, "uniform": 4}


def radius_edges(rows, cols, radius, keep_prob=1.0, seed=0,
                 weight_mode="constant", wparam0=1.0, wparam1=0.0):
    """COO edges for radius-limited lattice connectivity (native)."""
    if not available:
        raise RuntimeError("native graphlib unavailable")
    r = int(np.ceil(radius))
    n_off = sum(1 for dr in range(-r, r + 1) for dc in range(-r, r + 1)
                if (dr, dc) != (0, 0) and dr * dr + dc * dc <= radius * radius)
    cap = rows * cols * n_off
    src = np.empty(cap, np.int32)
    dst = np.empty(cap, np.int32)
    w = np.empty(cap, np.float32)
    n = _lib.build_radius_edges(rows, cols, float(radius), float(keep_prob),
                                int(seed), WEIGHT_MODES[weight_mode],
                                float(wparam0), float(wparam1), src, dst, w)
    return src[:n].copy(), dst[:n].copy(), w[:n].copy()


def random_edges(n_pre, n_post, p, exclude_self=True, seed=0,
                 weight_mode="constant", wparam0=1.0, wparam1=0.0):
    if not available:
        raise RuntimeError("native graphlib unavailable")
    cap = int(n_pre * n_post)
    src = np.empty(cap, np.int32)
    dst = np.empty(cap, np.int32)
    w = np.empty(cap, np.float32)
    n = _lib.build_random_edges(n_pre, n_post, float(p),
                                int(bool(exclude_self)), int(seed),
                                WEIGHT_MODES[weight_mode], float(wparam0),
                                float(wparam1), src, dst, w, cap)
    if n < 0:
        raise RuntimeError("edge capacity exceeded")
    return src[:n].copy(), dst[:n].copy(), w[:n].copy()


def hopfield_weights(patterns, a=0.0, b=0.0, scalar=1.0):
    """Hopfield outer-product weights from (P, n) 0/1 patterns (native)."""
    if not available:
        raise RuntimeError("native graphlib unavailable")
    pats = np.ascontiguousarray(np.asarray(patterns, np.uint8))
    p, n = pats.shape
    w = np.zeros(n * n, np.float32)
    _lib.hopfield_accumulate(pats.reshape(-1), p, n, float(a), float(b),
                             float(scalar), w)
    return w.reshape(n, n)


def in_degree(dst, n_post):
    if not available:
        raise RuntimeError("native graphlib unavailable")
    dst = np.ascontiguousarray(dst, np.int32)
    deg = np.empty(n_post, np.float32)
    _lib.in_degree(dst, len(dst), deg, n_post)
    return deg
