"""Lattice history (observability) layer.

JAX rebuild of the reference's pluggable `LatticeHistory` types
(`reference/backend/src/neuron/mod.rs:224-403`).  Each history kind is
a pure per-step readout computed inside the `lax.scan` (the ys), then
accumulated on the host between chunks — the device-resident analog of the
GPU path's preallocated history buffers (gpu_lattices/mod.rs:141-155) without
its end-of-run readback.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp


class GridVoltageHistory:
    """`GridVoltageHistory` (neuron/mod.rs:288-301): full (rows, cols) voltage
    snapshot per step."""

    kind = "grid"

    def __init__(self):
        self.history = []

    def readout(self, state, shape):
        return state["v"].reshape(shape)

    def extend(self, ys):
        self.history.extend(np.asarray(ys))

    def reset(self):
        self.history.clear()


class AverageVoltageHistory:
    """`AverageVoltageHistory` (neuron/mod.rs:305-322)."""

    kind = "average"

    def __init__(self):
        self.history = []

    def readout(self, state, shape):
        return jnp.mean(state["v"])

    def extend(self, ys):
        self.history.extend(np.asarray(ys).tolist())

    def reset(self):
        self.history.clear()


class EEGHistory:
    """`EEGHistory` (neuron/mod.rs:232-284): point-dipole approximation
    ``(1 / (4 pi c d)) * sum(v - reference_voltage)``."""

    kind = "eeg"

    def __init__(self, reference_voltage=0.007, distance=0.8, conductivity=251.0):
        self.history = []
        self.reference_voltage = reference_voltage
        self.distance = distance
        self.conductivity = conductivity

    def readout(self, state, shape):
        total = jnp.sum(state["v"] - self.reference_voltage)
        return (1.0 / (4.0 * math.pi * self.conductivity * self.distance)) * total

    def extend(self, ys):
        self.history.extend(np.asarray(ys).tolist())

    def reset(self):
        self.history.clear()


class SpikeHistory:
    """`SpikeHistory` (neuron/mod.rs:326-378) with firing-rate `aggregate`."""

    kind = "spikes"

    def __init__(self):
        self.history = []

    def readout(self, state, shape):
        return state["is_spiking"].reshape(shape)

    def extend(self, ys):
        self.history.extend(np.asarray(ys))

    def reset(self):
        self.history.clear()

    def aggregate(self):
        """Firing counts per position (neuron/mod.rs:335-359)."""
        if not self.history:
            return np.zeros((0, 0), np.int64)
        return np.sum(np.stack(self.history).astype(np.int64), axis=0)


# SpikeTrainLattice histories (neuron/mod.rs:1266-1290) share the same readouts.
SpikeTrainGridHistory = GridVoltageHistory
SpikeTrainSpikeHistory = SpikeHistory

HISTORY_KINDS = {
    "grid": GridVoltageHistory,
    "average": AverageVoltageHistory,
    "eeg": EEGHistory,
    "spikes": SpikeHistory,
}


def history_step_bytes(kind, n):
    """Per-step bytes a history readout adds to the scan ys (f32)."""
    return 4 * n if kind in ("grid", "spikes") else 4


def resolve_history_chunk(setting, bytes_per_step, budget=64 << 20):
    """Resolve a ``history_chunk`` setting.

    None = auto (the default): size the chunk so the on-device (T, ...)
    history ys buffer stays under ``budget`` (~64 MB), clamped to
    [1024, 65536].  Small-history runs (a 7x7 science trial, an EEG
    scalar readout) then run as ONE chunk — every extra chunk costs a
    dispatch, a host pull of its history and a separate remainder-length
    program compile.  The budget bounds device memory (64 MB is under 0.1%
    of an 80 GB card) and the host copy per chunk; it is not a measured
    speed optimum.  Explicit ints are respected exactly."""
    if setting is not None:
        return setting
    if bytes_per_step <= 0:
        return 65536
    return max(1024, min(65536, int(budget) // int(bytes_per_step)))
