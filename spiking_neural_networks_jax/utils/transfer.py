"""Host->device transfer of state pytrees, and the lazy host state.

`populate` builds a lattice's state as host NumPy arrays and leaves it
there until a run entry point ships it (`ensure_device_state`,
`ship_states`), so construction-time edits cost no device work.  The
`HostArray` view gives those host leaves the ``.at[...]`` update API of a
device array.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def device_put_state(state):
    """Transfer a dict of host arrays to the default device."""
    return jax.device_put({k: np.asarray(v) for k, v in state.items()})


def _is_host_leaf(v):
    return not isinstance(v, jax.Array)


class HostArray(np.ndarray):
    """NumPy array carrying the JAX ``.at[idx].set/add/...`` functional
    update API, so lazy host state leaves (core ``populate`` defers the
    device ship to the first run entry point) are drop-in for user
    callbacks written against device arrays — e.g.
    ``lat.apply(lambda s: {**s, "v": s["v"].at[i].set(30.0)})``.
    All updates copy (functional semantics, like jax.Array.at).

    Supported subset of ``jax.Array.at``: ``get/set/add/multiply(mul)/
    divide(div)/min/max``.  Not implemented: ``apply``, ``power``,
    ``get(fill_value=...)``, and jax's out-of-bounds index clamping —
    out-of-range indices raise IndexError here (NumPy semantics) where a
    shipped device leaf would clamp.  Callbacks relying on those should
    run after the state ships (utils.transfer.ensure_device_state)."""

    @property
    def at(self):
        return _HostAt(self)


class _HostAt:
    def __init__(self, arr):
        self._arr = arr

    def __getitem__(self, idx):
        return _HostAtIndex(self._arr, idx)


class _HostAtIndex:
    def __init__(self, arr, idx):
        self._arr, self._idx = arr, idx

    def __getattr__(self, name):
        raise AttributeError(
            f".at[...].{name} is not implemented on lazy host state leaves "
            "(supported: get/set/add/multiply/divide/min/max); ship the "
            "state first with utils.transfer.ensure_device_state")

    def _updated(self, op, value):
        out = self._arr.copy()
        out[self._idx] = op(out[self._idx], value)
        return out

    def get(self):
        return self._arr[self._idx]

    def set(self, value):
        return self._updated(lambda _, v: v, value)

    def add(self, value):
        return self._updated(lambda a, v: a + v, value)

    def multiply(self, value):
        return self._updated(lambda a, v: a * v, value)

    mul = multiply

    def divide(self, value):
        return self._updated(lambda a, v: a / v, value)

    div = divide

    def min(self, value):
        return self._updated(np.minimum, value)

    def max(self, value):
        return self._updated(np.maximum, value)


def host_state_view(state):
    """Wrap every host NumPy leaf of ``state`` as a HostArray (zero-copy
    view) so the lazy host state exposes the ``.at`` update API."""
    return {k: v.view(HostArray) if isinstance(v, np.ndarray) else v
            for k, v in state.items()}


def set_at(state, key, idx, value):
    """``state[key][idx] = value`` for host- or device-resident leaves
    (lixirnet set_neuron paths run on lazy host states before the first
    ship)."""
    arr = state[key]
    if isinstance(arr, np.ndarray):
        out = arr.copy()
        out[idx] = value
        state[key] = out
    else:
        state[key] = arr.at[idx].set(value)


def set_col(arr, k, v):
    """``arr[:, k] = v`` for host- or device-resident arrays (insert()
    paths run on lazy host states before the first ship)."""
    if isinstance(arr, np.ndarray):
        out = arr.copy()
        out[:, k] = v
        return out
    return arr.at[:, k].set(v)


def full_like(x, v):
    """full_like that keeps lazy host leaves host-side (a jnp.full_like on
    a NumPy leaf would eagerly create a device array mid-construction)."""
    if isinstance(x, np.ndarray):
        return np.full_like(x, v)
    return jnp.full_like(x, v)


def state_is_host(state):
    """True if any leaf is still a host NumPy array (lazy, unshipped)."""
    return any(_is_host_leaf(v) for v in state.values())


def ensure_device_state(state):
    """Ship only the host NumPy leaves of ``state``; device leaves pass
    through untouched.  No-op for fully-device states.

    This is the lazy-ship entry point: lixirnet ``populate``/``apply``
    leave states host-side and the core run paths call this once at run
    time."""
    host = {k: v for k, v in state.items() if _is_host_leaf(v)}
    if not host:
        return state
    out = dict(state)
    out.update(device_put_state(host))
    return out


def device_put_states(states):
    """Ship a list of state dicts in one `jax.device_put`."""
    return jax.device_put([{k: np.asarray(v) for k, v in st.items()}
                           for st in states])


def ship_states(holders):
    """Ship the host leaves of the ``.state`` of every holder that still
    carries some, in one transfer (network run entry points)."""
    pending = [h for h in holders
               if getattr(h, "state", None) and state_is_host(h.state)]
    if not pending:
        return
    hosts = [{k: v for k, v in h.state.items() if _is_host_leaf(v)}
             for h in pending]
    for h, sh in zip(pending, device_put_states(hosts)):
        st = dict(h.state)
        st.update(sh)
        h.state = st
