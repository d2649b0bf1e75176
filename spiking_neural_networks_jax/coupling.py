"""Coupled-neuron utilities.

Vectorized equivalents of the reference's module-level coupling helpers
(`reference/backend/src/neuron/mod.rs:52-221`): gap-junction currents
and the canonical two-neuron / spike-train-driven iteration loops used by
examples and the fitting pipeline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .models.base import get_neurotransmitter_concentrations
from .models.spike_train import refractoriness_effect


def gap_junction(pre_state, post_state):
    """`gap_junction` (neuron/mod.rs:54-60):
    g_post * (v_pre - v_post), vectorized over any batch shape."""
    return post_state["gap_conductance"] * (pre_state["v"] - post_state["v"])


def spike_train_gap_junction(st_model, st_state, post_state, timestep):
    """`spike_train_gap_junction` (neuron/mod.rs:119-137): conductance times
    the refractoriness effect of the train's last firing time."""
    effect = refractoriness_effect(st_model.refractoriness, st_state, timestep)
    return post_state["gap_conductance"] * effect


def iterate_coupled_spiking_neurons(model, pre_state, post_state,
                                    input_current, electrical=True,
                                    chemical=False):
    """One step of `iterate_coupled_spiking_neurons` (neuron/mod.rs:78-114):
    the presynaptic neuron takes a static current, the postsynaptic neuron
    its gap-junction and/or neurotransmitter input.  Returns
    (pre_state, post_state, pre_spiking, post_spiking)."""
    post_current = gap_junction(pre_state, post_state) if electrical else 0.0
    if chemical:
        t, mask = get_neurotransmitter_concentrations(pre_state)
        pre_state, pre_spk = model.step(pre_state, input_current)
        post_state, post_spk = model.step(post_state, post_current, t, mask)
    else:
        pre_state, pre_spk = model.step(pre_state, input_current)
        post_state, post_spk = model.step(post_state, post_current)
    return pre_state, post_state, pre_spk, post_spk


def iterate_coupled_spiking_neurons_and_spike_train(
        st_model, model, st_state, pre_state, post_state, timestep,
        electrical=True, chemical=False, key=None):
    """One step of `iterate_coupled_spiking_neurons_and_spike_train`
    (neuron/mod.rs:157-221): spike train -> presynaptic -> postsynaptic,
    with last-firing-times stamped at ``timestep``."""
    if key is None:
        key = jax.random.PRNGKey(0)

    pre_t = get_neurotransmitter_concentrations(st_state) if chemical else None
    if electrical:
        pre_current = spike_train_gap_junction(st_model, st_state, pre_state,
                                               timestep)
        post_current = gap_junction(pre_state, post_state)
    else:
        pre_current = post_current = 0.0
    post_t = get_neurotransmitter_concentrations(pre_state) if chemical else None

    st_state, st_spk, key = st_model.step(st_state, key, timestep)
    st_state["last_firing_time"] = jnp.where(
        st_spk, timestep, st_state["last_firing_time"])

    if chemical:
        pre_state, pre_spk = model.step(pre_state, pre_current, *pre_t)
        post_state, post_spk = model.step(post_state, post_current, *post_t)
    else:
        pre_state, pre_spk = model.step(pre_state, pre_current)
        post_state, post_spk = model.step(post_state, post_current)
    pre_state["last_firing_time"] = jnp.where(
        pre_spk, timestep, pre_state["last_firing_time"])
    post_state["last_firing_time"] = jnp.where(
        post_spk, timestep, post_state["last_firing_time"])

    return (st_state, pre_state, post_state, st_spk, pre_spk, post_spk, key)
