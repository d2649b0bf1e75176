"""Native (C++) graph-builder tests: parity with the NumPy/StencilGraph
constructions."""

import numpy as np
import pytest

from spiking_neural_networks_jax import _native
from spiking_neural_networks_jax import attractors


def test_native_available():
    assert _native.available, "g++ toolchain should build graphlib"


def test_radius_edges_match_stencil_structure():
    rows = cols = 16
    src, dst, w = _native.radius_edges(rows, cols, radius=2.0)
    # structural checks vs an independent python construction
    edges = set()
    for r in range(rows):
        for c in range(cols):
            for dr in range(-2, 3):
                for dc in range(-2, 3):
                    if (dr, dc) == (0, 0) or dr * dr + dc * dc > 4:
                        continue
                    sr, sc = r + dr, c + dc
                    if 0 <= sr < rows and 0 <= sc < cols:
                        edges.add((sr * cols + sc, r * cols + c))
    got = set(zip(src.tolist(), dst.tolist()))
    assert got == edges
    assert (w == 1.0).all()


def test_radius_edges_keep_prob_and_weights():
    src, dst, w = _native.radius_edges(32, 32, 2.0, keep_prob=0.5, seed=9,
                                       weight_mode="uniform",
                                       wparam0=0.5, wparam1=1.5)
    full, _, _ = _native.radius_edges(32, 32, 2.0)
    assert 0.4 < len(src) / len(full) < 0.6
    assert (w >= 0.5).all() and (w < 1.5).all()
    # reproducible
    src2, dst2, w2 = _native.radius_edges(32, 32, 2.0, keep_prob=0.5, seed=9,
                                          weight_mode="uniform",
                                          wparam0=0.5, wparam1=1.5)
    np.testing.assert_array_equal(src, src2)
    np.testing.assert_array_equal(w, w2)


def test_random_edges():
    src, dst, w = _native.random_edges(100, 100, 0.3, seed=2)
    assert 0.25 < len(src) / (100 * 99) < 0.35
    assert not ((src == dst).any())


def test_hopfield_weights_match_python():
    rng = np.random.default_rng(3)
    patterns = (rng.random((3, 25)) < 0.5).astype(np.uint8)
    got = _native.hopfield_weights(patterns, a=0.5, b=0.5, scalar=2.0)
    flat = patterns.astype(np.float64)
    want = np.zeros((25, 25))
    for p in flat:
        want += np.outer(p - 0.5, p - 0.5)
    np.fill_diagonal(want, 0.0)
    want *= 2.0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_in_degree():
    dst = np.array([0, 0, 1, 3, 3, 3], np.int32)
    deg = _native.in_degree(dst, 5)
    np.testing.assert_array_equal(deg, [2, 1, 0, 3, 0])
