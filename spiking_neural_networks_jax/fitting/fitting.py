"""Fit one neuron model's parameters to another's spiking behavior.

JAX rebuild of `reference/backend/src/fitting/mod.rs`: the GA
population's coupled simulations (spike train -> presynaptic -> postsynaptic
neuron, `iterate_coupled_spiking_neurons_and_spike_train`,
neuron/mod.rs:157-221) run as ONE vmapped `lax.scan` over (population x
spike-train-settings) — the whole generation is a single device program.

The `ActionPotentialSummary` (fitting/mod.rs:26-77) fields reduce to running
statistics (first/last spike time + spike count), since
``mean(diff(peaks)) == (last - first) / len(peaks)``.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..models.base import NEVER
from ..models.spike_train import refractoriness_effect
from .ga import GeneticAlgorithmParameters, genetic_algo


class ActionPotentialSummary:
    """fitting/mod.rs:26-36."""

    def __init__(self, pre_diff, post_diff, num_pre, num_post):
        self.average_pre_spike_time_difference = pre_diff
        self.average_post_spike_time_difference = post_diff
        self.num_pre_spikes = num_pre
        self.num_post_spikes = num_post

    def as_array(self):
        return jnp.asarray([self.average_pre_spike_time_difference,
                            self.average_post_spike_time_difference,
                            self.num_pre_spikes, self.num_post_spikes],
                           jnp.float32)


def summary_from_stats(first_pre, last_pre, n_pre, first_post, last_post,
                       n_post):
    """avg spike-time difference = sum(diff(peaks)) / len(peaks)
    = (last - first) / count (fitting/mod.rs:54-66); 0 when no spikes."""
    pre_diff = jnp.where(n_pre > 0, (last_pre - first_pre) / n_pre, 0.0)
    post_diff = jnp.where(n_post > 0, (last_post - first_post) / n_post, 0.0)
    return jnp.stack([pre_diff, post_diff, n_pre, n_post], axis=-1)


def compare_summary(s1, s2):
    """`compare_summary` (fitting/mod.rs:173-190): sum of squared field
    differences; NaN -> inf."""
    score = jnp.sum((s1 - s2) ** 2, axis=-1)
    return jnp.where(jnp.isnan(score), jnp.inf, score)


class SummaryScalingDefaults:
    """fitting/mod.rs:80-97."""

    def __init__(self, default_amplitude_scale=70.0,
                 default_time_difference_scale=800.0,
                 default_num_peaks_scale=10.0):
        self.default_amplitude_scale = default_amplitude_scale
        self.default_time_difference_scale = default_time_difference_scale
        self.default_num_peaks_scale = default_num_peaks_scale


def scale_summary(summary, time_difference_scale, num_peaks_scale):
    """`scale_summary` (fitting/mod.rs:158-169)."""
    scales = jnp.asarray([time_difference_scale, time_difference_scale,
                          num_peaks_scale, num_peaks_scale], jnp.float32)
    return summary / scales


def run_coupled_trial(neuron_model, st_model, neuron_state, st_state,
                      iterations, electrical=True, chemical=False, key=None):
    """Vectorized `iterate_coupled_spiking_neurons_and_spike_train`
    (neuron/mod.rs:157-221) over any leading batch shape.

    ``neuron_state`` holds the presynaptic AND postsynaptic neuron: fields
    are stacked (..., 2) with index 0 = pre, 1 = post.  Returns the summary
    statistics array (..., 4).
    """
    if key is None:
        key = jax.random.PRNGKey(0)

    def one_step(carry, timestep):
        nstate, ststate, key, stats = carry
        pre_v = nstate["v"][..., 0]
        post_v = nstate["v"][..., 1]

        if electrical:
            effect = refractoriness_effect(st_model.refractoriness, ststate,
                                           timestep)
            # spike_train_gap_junction (neuron/mod.rs:119-137): a train
            # that never fired contributes bare v_resting, WITHOUT the
            # postsynaptic conductance factor
            never = ststate["last_firing_time"] == NEVER
            pre_current = jnp.where(
                never, effect, nstate["gap_conductance"][..., 0] * effect)
            post_current = nstate["gap_conductance"][..., 1] * (pre_v - post_v)
        else:
            pre_current = jnp.zeros_like(pre_v)
            post_current = jnp.zeros_like(post_v)

        if chemical:
            # paired (N, K) fields are (..., 2, K) — pair axis BEFORE the
            # type axis so every (..., K)-trailing convention holds.  The
            # pre slot is driven by the spike train's release, the post
            # slot by the PRE neuron's release (mod.rs:157-221)
            pre_t = ststate["nt$t"]
            pre_valid = ststate["nt$mask"]
            post_t = nstate["nt$t"][..., 0, :]
            post_valid = nstate["nt$mask"][..., 0, :]
            t_in = jnp.stack([pre_t, post_t], axis=-2)
            t_valid = jnp.stack([pre_valid, post_valid], axis=-2)
        else:
            t_in = t_valid = None

        ststate, st_spikes, key = st_model.step(ststate, key, timestep)
        ststate["last_firing_time"] = jnp.where(
            st_spikes, timestep, ststate["last_firing_time"])

        i = jnp.stack([pre_current, post_current], axis=-1)
        if chemical:
            nstate, spikes = neuron_model.step(nstate, i, t_in, t_valid)
        else:
            nstate, spikes = neuron_model.step(nstate, i)
        nstate["last_firing_time"] = jnp.where(
            spikes, timestep, nstate["last_firing_time"])

        ts = jnp.float32(timestep)
        first, last, count = stats
        first = jnp.where(spikes & (count == 0), ts, first)
        last = jnp.where(spikes, ts, last)
        count = count + spikes.astype(jnp.float32)
        return (nstate, ststate, key, (first, last, count)), None

    shape = neuron_state["v"].shape  # (..., 2)
    stats0 = (jnp.zeros(shape), jnp.zeros(shape), jnp.zeros(shape))
    (nstate, ststate, key, (first, last, count)), _ = jax.lax.scan(
        one_step, (neuron_state, st_state, key, stats0),
        jnp.arange(iterations))
    return summary_from_stats(first[..., 0], last[..., 0], count[..., 0],
                              first[..., 1], last[..., 1], count[..., 1])


def _stack_pair(state):
    """Stack a state into the pre/post pair layout: scalar fields become
    (..., 2); (..., K) neurotransmitter fields become (..., 2, K), keeping
    the type axis LAST as every kinetics/receptor op expects."""
    return {k: jnp.stack([v, v], axis=(-2 if v.ndim >= 2 else -1))
            for k, v in state.items()}


class FittingSettings:
    """`FittingSettings` (fitting/mod.rs:248-274).

    ``converter(params)``: maps a decoded (n_params,) vector to state-field
    overrides (dict of scalars/arrays) for the neuron model — evaluated in a
    vectorized way over the population (params arrive as (n_pop, n_params)).
    """

    def __init__(self, neuron_model, st_model, spike_train_states,
                 reference_summaries, scaling_factors, iterations, converter,
                 electrical_synapse=True, chemical_synapse=False):
        self.neuron_model = neuron_model
        self.st_model = st_model
        self.spike_train_states = spike_train_states
        self.reference_summaries = reference_summaries
        self.scaling_factors = scaling_factors
        self.iterations = iterations
        self.converter = converter
        self.electrical_synapse = electrical_synapse
        self.chemical_synapse = chemical_synapse


def get_reference_summary(neuron_model, neuron_state, st_model, st_state,
                          iterations, electrical=True, chemical=False):
    """`get_reference_summary` (fitting/mod.rs:192-246) for a single neuron
    configuration (state holds one neuron; duplicated into pre/post)."""
    paired = _stack_pair(neuron_state)
    summary = run_coupled_trial(neuron_model, st_model, paired, st_state,
                                iterations, electrical, chemical)
    return summary


def fit_neuron_to_neuron(settings, ga_params=None, key=None, verbose=False):
    """`fit_neuron_to_neuron` (fitting/mod.rs:411+): GA minimizing the summed
    scaled-summary distance across all spike-train settings."""
    if ga_params is None:
        ga_params = GeneticAlgorithmParameters()
    if key is None:
        key = jax.random.PRNGKey(0)

    refs = jnp.stack([jnp.asarray(r, jnp.float32)
                      for r in settings.reference_summaries])  # (S, 4)
    scales = jnp.asarray(settings.scaling_factors, jnp.float32)  # (S, 2)

    n_trains = len(settings.spike_train_states)

    # init_state is a host-side constructor (sequential synced transfers);
    # build the template once and apply the converter's overrides
    # functionally inside the traced objective.
    template = {k: v[0] for k, v in
                settings.neuron_model.init_state(1).items()}

    @jax.jit
    def objective(decoded):  # (n_pop, n_params) -> (n_pop,)
        n_pop = decoded.shape[0]

        def build_state(params):
            state = dict(template)
            for k, v in settings.converter(params).items():
                state[k] = jnp.broadcast_to(
                    jnp.asarray(v, state[k].dtype), state[k].shape)
            return state

        base = jax.vmap(build_state)(decoded)          # fields (n_pop, ...)
        paired = _stack_pair(base)                     # fields (n_pop, ..., 2)

        total = jnp.zeros((n_pop,), jnp.float32)
        for s, st_state in enumerate(settings.spike_train_states):
            # spike-train states hold one generator; unbatch then broadcast
            # to the population so shapes align with the neuron fields
            st_b = {k: jnp.broadcast_to(v[0], (n_pop,) + v[0].shape)
                    for k, v in st_state.items()}
            summary = run_coupled_trial(
                settings.neuron_model, settings.st_model, paired, st_b,
                settings.iterations, settings.electrical_synapse,
                settings.chemical_synapse)
            scaled = scale_summary(summary, scales[s, 0], scales[s, 1])
            ref_scaled = scale_summary(refs[s], scales[s, 0], scales[s, 1])
            total = total + compare_summary(scaled, ref_scaled)
        return total

    return genetic_algo(objective, ga_params, key, verbose)
