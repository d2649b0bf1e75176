"""Spike-train stimulus generators + neural refractoriness, vectorized.

JAX rebuild of `reference/backend/src/neuron/spike_train/mod.rs`.
Spike trains are pure sources: ``step(state, key, clock) -> (state, spikes,
key)``.  Poisson randomness uses threaded `jax.random` keys in place of the
reference's thread_rng (:354) / xorshift GPU RNG (:380-388); parity with the
reference is statistical (rates), exactly as the reference's own Python-tier
tests treat it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import NEVER
from ..ops import kinetics as K
from ..ops import receptors as R


# ---------------------------------------------------------------------------
# Neural refractoriness (spike_train/mod.rs:37-178): the shape of a spike
# train's effect on a coupled neuron as a function of time since last firing.
# ---------------------------------------------------------------------------


def delta_dirac_effect(k, a, time_difference, v_resting, dt):
    """`DeltaDiracRefractoriness` (spike_train/mod.rs:84-86):
    a * exp((-1 / (k / dt)) * Δt²) + v_resting."""
    return a * jnp.exp((-1.0 / (k / dt)) * time_difference ** 2) + v_resting


def exponential_decay_effect(k, a, time_difference, v_resting, dt):
    """`ExponentialDecayRefractoriness` (spike_train/mod.rs:174-176)."""
    return a * jnp.exp((-1.0 / (k / dt)) * time_difference) + v_resting


REFRACTORINESS = {
    "delta_dirac": delta_dirac_effect,
    "exponential_decay": exponential_decay_effect,
}


def refractoriness_effect(kind, state, timestep):
    """Vectorized `spike_train_gap_junction` source term
    (neuron/mod.rs:119-137) *without* the postsynaptic conductance: returns
    v_resting where the train never fired, else the refractoriness effect of
    (timestep - last_firing_time)."""
    lft = state["last_firing_time"]
    a = state["v_th"] - state["v_resting"]
    dt_diff = (timestep - lft).astype(jnp.float32)
    effect = REFRACTORINESS[kind](state["refractoriness$k"], a, dt_diff,
                                  state["v_resting"], state["dt"])
    return jnp.where(lft == NEVER, state["v_resting"], effect)


# ---------------------------------------------------------------------------
# Spike train models
# ---------------------------------------------------------------------------


class SpikeTrainModel:
    """Base for spike-train sources (`SpikeTrain` trait,
    spike_train/mod.rs:181-192)."""

    name = "spike_train_base"
    FIELDS: dict = {}
    INT_FIELDS: dict = {}
    n_types = R.N_IONOTROPIC
    type_names = R.IONOTROPIC_TYPES
    needs_rng = False

    def __init__(self, nt_kinetics="approximate", refractoriness="delta_dirac"):
        assert refractoriness in REFRACTORINESS
        self.nt_kinetics = nt_kinetics
        self.refractoriness = refractoriness

    def config_key(self):
        return (type(self), self.nt_kinetics, self.refractoriness)

    def __hash__(self):
        return hash(self.config_key())

    def __eq__(self, other):
        return isinstance(other, SpikeTrainModel) and self.config_key() == other.config_key()

    def init_state(self, n, **overrides):
        # host-side construction, one device_put (see models.base.init_state)
        from ..utils.transfer import device_put_state
        return device_put_state(self.init_state_host(n, **overrides))

    def init_state_host(self, n, **overrides):
        """`init_state` without the device transfer (models.base)."""
        import numpy as np
        nk = (n, self.n_types)
        s = {}
        base = dict(v=0.0, v_th=30.0, v_resting=0.0, dt=0.1)
        base.update(self.FIELDS)
        for f, d in base.items():
            s[f] = np.full((n,), d, np.float32)
        for f, d in self.INT_FIELDS.items():
            s[f] = np.full((n,), d, np.int32)
        s["is_spiking"] = np.zeros((n,), bool)
        s["last_firing_time"] = np.full((n,), NEVER, np.int32)
        # `NeuralRefractoriness` decay default k=10000 (spike_train/mod.rs:48-56)
        s["refractoriness$k"] = np.full((n,), 10000.0, np.float32)
        s["nt$t"] = np.zeros(nk, np.float32)
        s["nt$mask"] = np.zeros(nk, bool)
        for f, d in K.NT_PARAM_DEFAULTS[self.nt_kinetics].items():
            s[f] = np.full(nk, d, np.float32)
        for key, val in overrides.items():
            if key not in s:
                raise KeyError(f"unknown state field {key!r} for {self.name}")
            s[key] = np.broadcast_to(
                np.asarray(val, s[key].dtype), s[key].shape).copy()
        return s

    def type_index(self, type_name):
        if type_name not in self.type_names:
            raise ValueError(
                f"unknown neurotransmitter type {type_name!r}; "
                f"available types: {self.type_names}")
        return self.type_names.index(type_name)

    def insert_neurotransmitter(self, state, type_name, **params):
        k = self.type_index(type_name)
        state = dict(state)
        from ..utils.transfer import set_col
        state["nt$mask"] = set_col(state["nt$mask"], k, True)
        for p, v in params.items():
            state[f"nt${p}"] = set_col(state[f"nt${p}"], k, v)
        return state

    def effect(self, state, timestep):
        return refractoriness_effect(self.refractoriness, state, timestep)

    def _finish(self, s, spikes):
        """Set spike flag/voltage, then release neurotransmitter.

        NOTE: unlike `IterateAndSpike` neurons, spike trains update
        neurotransmitters *after* setting the new spike flag
        (e.g. PoissonNeuron::iterate, spike_train/mod.rs:353-368)."""
        s["is_spiking"] = spikes
        s["v"] = jnp.where(spikes, s["v_th"], s["v_resting"])
        s["nt$t"] = K.apply_t_changes(self.nt_kinetics, s, s["v"], spikes)
        return s

    def step(self, s, key, clock):
        raise NotImplementedError


class PoissonSpikeTrain(SpikeTrainModel):
    """`PoissonNeuron` (spike_train/mod.rs:259-371): fires i.i.d. with
    ``chance_of_firing = 1 / ((1000 / dt) / hertz)`` (:330-337)."""

    name = "poisson"
    FIELDS = dict(chance_of_firing=0.0)
    needs_rng = True

    @staticmethod
    def rate_to_chance(hertz, dt):
        return 1.0 / ((1000.0 / dt) / hertz)

    def init_from_firing_rate(self, n, hertz, dt=0.1, **overrides):
        return self.init_state(
            n, chance_of_firing=self.rate_to_chance(hertz, dt), dt=dt, **overrides)

    def step(self, s, key, clock):
        s = dict(s)
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, s["v"].shape)
        spikes = u <= s["chance_of_firing"]
        s = self._finish(s, spikes)
        return s, spikes, key


class RateSpikeTrain(SpikeTrainModel):
    """`RateSpikeTrain` (spike_train/mod.rs:974-1033): fires deterministically
    every `rate` ms."""

    name = "rate"
    FIELDS = dict(rate=0.0, step=0.0)

    def step(self, s, key, clock):
        s = dict(s)
        stepped = s["step"] + s["dt"]
        spikes = jnp.logical_and(s["rate"] != 0.0, stepped >= s["rate"])
        s["step"] = jnp.where(spikes, 0.0, stepped)
        s = self._finish(s, spikes)
        return s, spikes, key


class PresetSpikeTrain(SpikeTrainModel):
    """`PresetSpikeTrain` (spike_train/mod.rs:752-831): cycles through a list
    of inter-spike intervals.  ``firing_times`` is a padded (N, L) array with
    per-neuron length ``firing_times_len``."""

    name = "preset"
    FIELDS = dict(internal_clock=0.0)
    INT_FIELDS = dict(counter=0)

    def init_state_host(self, n, firing_times=None, **overrides):
        # overridden at the HOST layer (not init_state) so the lazy
        # populate path (core populate -> init_state_host) also gets the
        # firing-times fields; the base init_state ships whatever this
        # returns
        s = super().init_state_host(n, **overrides)
        if firing_times is None:
            firing_times = [[0.0]]
        import numpy as np
        ft = np.asarray(firing_times, np.float32)
        if ft.ndim == 1:
            ft = np.broadcast_to(ft[None, :], (n, ft.shape[0]))
        s["firing_times"] = ft.copy()
        s["firing_times_len"] = np.full((n,), ft.shape[1], np.int32)
        return s

    def step(self, s, key, clock):
        s = dict(s)
        internal = s["internal_clock"] + s["dt"]
        current_target = jnp.take_along_axis(
            s["firing_times"], s["counter"][:, None], axis=1)[:, 0]
        spikes = internal > current_target
        counter = jnp.where(spikes, s["counter"] + 1, s["counter"])
        counter = jnp.where(counter >= s["firing_times_len"], 0, counter)
        s["internal_clock"] = jnp.where(spikes, 0.0, internal)
        s["counter"] = counter
        s = self._finish(s, spikes)
        return s, spikes, key


class BCMPoissonSpikeTrain(PoissonSpikeTrain):
    """`BCMPoissonNeuron` (spike_train/mod.rs:834-972): Poisson source with
    BCM activity bookkeeping (faithful to the reference, including
    `num_spikes` never resetting)."""

    name = "bcm_poisson"
    FIELDS = dict(chance_of_firing=0.0, average_activity=0.0,
                  current_activity=0.0, period=3.0, firing_rate_clock=0.0,
                  firing_rate_window=500.0)
    INT_FIELDS = dict(num_spikes=0)
    needs_rng = True

    def step(self, s, key, clock):
        s = dict(s)
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, s["v"].shape)
        spikes = u <= s["chance_of_firing"]
        # instantaneous activity: voltage delta (spike_train/mod.rs:930-941)
        target = jnp.where(spikes, s["v_th"], s["v_resting"])
        s["current_activity"] = target - s["v"]
        s["num_spikes"] = s["num_spikes"] + spikes.astype(jnp.int32)
        clock_f = s["firing_rate_clock"] + s["dt"]
        hit = clock_f >= s["firing_rate_window"]
        activity = s["num_spikes"].astype(jnp.float32) / \
            (s["firing_rate_window"] * s["dt"])
        s["firing_rate_clock"] = jnp.where(hit, 0.0, clock_f)
        s["current_activity"] = jnp.where(hit, activity, s["current_activity"])
        avg = s["average_activity"]
        s["average_activity"] = jnp.where(
            hit, avg - avg / s["period"] + activity / s["period"], avg)
        s = self._finish(s, spikes)
        return s, spikes, key
