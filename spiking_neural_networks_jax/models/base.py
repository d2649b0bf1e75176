"""Neuron model base: struct-of-arrays state + pure vectorized step functions.

JAX equivalent of the reference's `IterateAndSpike` trait
(`reference/backend/src/neuron/iterate_and_spike/mod.rs:3079-3098`).
A model instance holds only *static* configuration (kinetics choices,
spike-handling style); all per-neuron data — including every parameter, so
heterogeneous populations work exactly like the reference's per-neuron
structs — lives in a flat ``dict[str, jnp.ndarray]`` state pytree with one
leading neuron axis N.

The two trait methods map to:

* ``iterate_and_spike(input)``                     -> ``step(state, i)``
* ``iterate_with_neurotransmitter_and_spike(i, t)``-> ``step(state, i, t_input, t_valid)``

both pure: ``(state, ...) -> (state, spikes)``, jit/vmap/scan-compatible.

State key conventions follow the reference GPU buffer names
(e.g. ``neurotransmitters$t`` -> ``nt$t``, ``receptors$...`` -> ``rec$...``),
see iterate_and_spike/mod.rs:209-288.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import kinetics as K
from ..ops import receptors as R

# Sentinel for "has not fired yet" (reference: Option<usize> = None).
NEVER = -1


def _full(n, value, dtype=np.float32):
    # Host-side construction: the state is assembled in NumPy and shipped
    # with a single device_put at the end of init_state, not one compiled
    # fill program per field.
    return np.full((n,), value, dtype=dtype)


class NeuronModel:
    """Base class for all spiking neuron models.

    Subclasses define:
      * ``FIELDS``: dict of per-neuron f32 fields -> default value
      * ``INT_FIELDS`` / ``BOOL_FIELDS``: optional extra non-float fields
      * ``deltas(state, i)``: dict of Euler deltas computed from the *old*
        state (at minimum ``{'v': dv}``)
      * ``handle_spiking(state)``: post-integration spike/reset logic
        returning ``(state, spikes)``
    and may override ``step`` entirely (Hodgkin-Huxley, Morris-Lecar).
    """

    name = "base"
    FIELDS: dict = {}
    BOOL_FIELDS: dict = {}
    INT_FIELDS: dict = {}

    def __init__(self, nt_kinetics="approximate", rec_kinetics="approximate",
                 receptors=None):
        assert nt_kinetics in K.NT_KINETICS, nt_kinetics
        assert rec_kinetics in K.REC_KINETICS, rec_kinetics
        self.nt_kinetics = nt_kinetics
        self.rec_kinetics = rec_kinetics
        # pluggable receptor system; the static neurotransmitter-type axis
        # follows it (Ionotropic AMPA/NMDA/GABA by default)
        self.receptors = receptors if receptors is not None \
            else R.IonotropicReceptors(rec_kinetics)

    @property
    def n_types(self):
        return self.receptors.n_types

    @property
    def type_names(self):
        return self.receptors.type_names

    # -- static config used for jit cache keys -------------------------------
    def config_key(self):
        return (type(self), self.nt_kinetics, self.rec_kinetics,
                self.receptors.config_key())

    def __hash__(self):
        return hash(self.config_key())

    def __eq__(self, other):
        return isinstance(other, NeuronModel) and self.config_key() == other.config_key()

    # -- state construction ---------------------------------------------------
    def init_state(self, n, **overrides):
        """Build the SoA state for ``n`` identical neurons (like `populate`
        cloning a base neuron, neuron/mod.rs:1090-1100). ``overrides`` set
        per-field initial values (scalar or (n,) array)."""
        # packed transfer: see utils.transfer for why per-leaf device_put
        # is unsafe here
        from ..utils.transfer import device_put_state
        return device_put_state(self.init_state_host(n, **overrides))

    def init_state_host(self, n, **overrides):
        """`init_state` without the device transfer: plain NumPy arrays,
        for callers that mutate construction-time state host-side and ship
        once (lixirnet.populate)."""
        nk = (n, self.n_types)
        s = {}
        for f, d in self.FIELDS.items():
            s[f] = _full(n, d)
        for f, d in self.BOOL_FIELDS.items():
            s[f] = _full(n, d, bool)
        for f, d in self.INT_FIELDS.items():
            s[f] = _full(n, d, np.int32)
        s["is_spiking"] = np.zeros((n,), bool)
        s["last_firing_time"] = np.full((n,), NEVER, np.int32)

        # Neurotransmitters (empty by default, like Neurotransmitters::default)
        s["nt$t"] = np.zeros(nk, np.float32)
        s["nt$mask"] = np.zeros(nk, bool)
        for f, d in K.NT_PARAM_DEFAULTS[self.nt_kinetics].items():
            s[f] = np.full(nk, d, np.float32)

        # Receptors (empty by default, like Ionotropic::default)
        s.update(self.receptors.init_fields(n))

        for key, val in overrides.items():
            if key not in s:
                raise KeyError(f"unknown state field {key!r} for {self.name}")
            arr = np.asarray(s[key])
            s[key] = np.broadcast_to(
                np.asarray(val, arr.dtype), arr.shape).copy()
        return s

    # -- receptor / neurotransmitter insertion (Receptors::insert,
    #    Neurotransmitters::insert) ------------------------------------------
    def type_index(self, type_name):
        if type_name not in self.type_names:
            raise ValueError(
                f"unknown neurotransmitter type {type_name!r}; "
                f"available types: {self.type_names}")
        return self.type_names.index(type_name)

    def insert_receptor(self, state, type_name, **params):
        self.type_index(type_name)  # validate the name
        return self.receptors.insert(state, type_name, **params)

    def insert_neurotransmitter(self, state, type_name, **params):
        k = self.type_index(type_name)
        state = dict(state)
        from ..utils.transfer import set_col
        state["nt$mask"] = set_col(state["nt$mask"], k, True)
        for p, v in params.items():
            key = f"nt${p}"
            state[key] = set_col(state[key], k, v)
        return state

    # -- hooks ----------------------------------------------------------------
    def pre_update(self, s):
        """Bookkeeping before integration (BCM activity tracking). Default no-op."""
        return s

    def deltas(self, s, i):
        raise NotImplementedError

    def handle_spiking(self, s):
        raise NotImplementedError

    # -- the IterateAndSpike template
    #    (integrate_and_fire/mod.rs:217-255 `impl_iterate_and_spike!`) --------
    def step(self, s, i, t_input=None, t_valid=None, skip_nt=False):
        """One `iterate_and_spike` over all N neurons.  ``skip_nt=True`` is a
        static fast path for lattices with no neurotransmitters inserted
        (the update is a masked no-op there; skipping saves the (N, K)
        read/write bandwidth)."""
        s = dict(s)
        s = self.pre_update(s)

        if t_input is not None:
            # receptors.update_receptor_kinetics(t_total, dt)
            s.update(self.receptors.update_kinetics(s, t_input, t_valid))
            # receptors.set_receptor_currents(current_voltage, dt) — pre-update v
            s.update(self.receptors.set_currents(s, s["v"]))
            rec_dv = self.receptors.receptor_dv(s)
        else:
            rec_dv = 0.0

        d = self.deltas(s, i)
        new = {k: s[k] + dv for k, dv in d.items()}
        new["v"] = new["v"] - rec_dv  # v += dv + (-receptor currents)
        s.update(new)

        # neurotransmitter release: new voltage, PREVIOUS step's spike flag
        # (apply_t_changes runs before handle_spiking in the reference).
        if not skip_nt:
            s["nt$t"] = K.apply_t_changes(
                self.nt_kinetics, s, s["v"], s["is_spiking"])

        s, spikes = self.handle_spiking(s)
        s["is_spiking"] = spikes
        return s, spikes

    # -- common spike handlers -------------------------------------------------

    @staticmethod
    def _handle_refractory_reset(s):
        """LIF-style handler with refractory period
        (integrate_and_fire/mod.rs:83-104 `impl_default_handle_spiking!`)."""
        in_refractory = s["refractory_count"] > 0.0
        crossed = s["v"] >= s["v_th"]
        spikes = jnp.logical_and(jnp.logical_not(in_refractory), crossed)
        s = dict(s)
        s["v"] = jnp.where(in_refractory | spikes, s["v_reset"], s["v"])
        s["refractory_count"] = jnp.where(
            in_refractory, s["refractory_count"] - 1.0,
            jnp.where(spikes, s["tref"] / s["dt"], s["refractory_count"]))
        return s, spikes

    @staticmethod
    def _handle_adaptive(s):
        """Adaptive handler: refractory reset + w += beta on spike
        (integrate_and_fire/mod.rs:1011-1029)."""
        in_refractory = s["refractory_count"] > 0.0
        crossed = s["v"] >= s["v_th"]
        spikes = jnp.logical_and(jnp.logical_not(in_refractory), crossed)
        s = dict(s)
        s["v"] = jnp.where(in_refractory | spikes, s["v_reset"], s["v"])
        s["w"] = jnp.where(spikes, s["w"] + s["beta"], s["w"])
        s["refractory_count"] = jnp.where(
            in_refractory, s["refractory_count"] - 1.0,
            jnp.where(spikes, s["tref"] / s["dt"], s["refractory_count"]))
        return s, spikes

    @staticmethod
    def _handle_izhikevich(s):
        """Izhikevich handler (integrate_and_fire/mod.rs:1235-1247):
        v >= v_th -> v = c, w += d."""
        spikes = s["v"] >= s["v_th"]
        s = dict(s)
        s["v"] = jnp.where(spikes, s["c"], s["v"])
        s["w"] = jnp.where(spikes, s["w"] + s["d"], s["w"])
        return s, spikes

    @staticmethod
    def _handle_simple_reset(s):
        """SimpleLeakyIntegrateAndFire handler
        (integrate_and_fire/mod.rs:1579-1590)."""
        spikes = s["v"] >= s["v_th"]
        s = dict(s)
        s["v"] = jnp.where(spikes, s["v_reset"], s["v"])
        return s, spikes

    @staticmethod
    def _handle_peak_detection(s, last_voltage):
        """HH/Morris-Lecar spike detection (hodgkin_huxley/mod.rs:207-218):
        spike when above threshold, was increasing, and just stopped."""
        increasing_now = last_voltage < s["v"]
        crossed = s["v"] > s["v_th"]
        spikes = crossed & s["was_increasing"] & jnp.logical_not(increasing_now)
        s = dict(s)
        s["was_increasing"] = increasing_now
        return s, spikes


def get_neurotransmitter_concentrations(state):
    """(N, K) concentrations + presence mask — the SoA analog of
    `get_neurotransmitter_concentrations` (iterate_and_spike/mod.rs:2238-2242)."""
    return state["nt$t"], state["nt$mask"]


def run_static_input(model, state, input_current, iterations, key=None,
                     gaussian=None):
    """`run_static_input_integrate_and_fire` equivalent
    (integrate_and_fire/mod.rs:40-58): iterate with a constant current,
    return the (iterations, N) voltage history. Python loop variant for tests;
    production paths use `lax.scan` via the Lattice runner."""
    from ..utils.distribution import limited_distr

    if gaussian is not None and key is None:
        key = jax.random.PRNGKey(0)
    voltages = []
    for it in range(iterations):
        i = input_current
        if gaussian is not None:
            key, sub = jax.random.split(key)
            i = input_current * limited_distr(sub, *gaussian, shape=state["v"].shape)
        state, _ = model.step(state, i)
        voltages.append(state["v"])
    return state, jnp.stack(voltages)
