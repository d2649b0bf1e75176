"""Neurotransmitter and receptor kinetics, vectorized over (N, K) type axes.

JAX redesign of the reference's per-neuron kinetics traits
(`reference/backend/src/neuron/iterate_and_spike/mod.rs:96-533`).
Where the reference stores one kinetics struct per neuron inside a
``HashMap<NeurotransmitterType, T>``, we keep struct-of-arrays state:
every kinetics parameter is an ``(N, K)`` array (``N`` neurons, ``K``
static neurotransmitter types) with a boolean ``mask`` marking which
(neuron, type) slots exist.  All update rules are pure element-wise
functions that XLA fuses into the surrounding neuron-step kernel.

Kinetics are selected *statically* (per model instance) by name, matching
the reference's compile-time generic parameters.
"""

from __future__ import annotations

import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Neurotransmitter kinetics: t(t_prev, v, is_spiking, dt)
#
# NOTE on ordering semantics (mirrors the reference exactly): a neuron's
# `apply_t_changes` runs *after* the voltage update but *before*
# `handle_spiking`, so `is_spiking` here is the spike flag from the
# PREVIOUS step while `v` is the freshly updated voltage
# (`integrate_and_fire/mod.rs:222-232`).
# ---------------------------------------------------------------------------


def _bcast(param, t):
    """Broadcast an (N, K) param against t."""
    return jnp.asarray(param, dtype=t.dtype)


def nt_approximate(t, v, spiking, dt, params):
    """`ApproximateNeurotransmitter` (iterate_and_spike/mod.rs:192-205).

    t += dt * -clearance_constant * t + is_spiking * t_max ; clamp [0, t_max]
    """
    t_max = _bcast(params["nt$t_max"], t)
    clearance = _bcast(params["nt$clearance_constant"], t)
    spike = spiking[..., None].astype(t.dtype)
    new_t = t + dt[..., None] * -clearance * t + spike * t_max
    return jnp.clip(new_t, 0.0, t_max)


def nt_discrete(t, v, spiking, dt, params):
    """`DiscreteSpikeNeurotransmitter` (iterate_and_spike/mod.rs:301-313)."""
    t_max = _bcast(params["nt$t_max"], t)
    return t_max * spiking[..., None].astype(t.dtype)


def _exp_decay(x, l, dt):
    """`exp_decay` helper (iterate_and_spike/mod.rs:348-350): -x * exp(dt / -l)."""
    return -x * jnp.exp(dt / -l)


def nt_exponential_decay(t, v, spiking, dt, params):
    """`ExponentialDecayNeurotransmitter` (iterate_and_spike/mod.rs:352-366)."""
    t_max = _bcast(params["nt$t_max"], t)
    decay = _bcast(params["nt$decay_constant"], t)
    spike = spiking[..., None].astype(t.dtype)
    new_t = t + _exp_decay(t, decay, dt[..., None]) + spike * t_max
    return jnp.clip(new_t, 0.0, t_max)


def nt_destexhe(t, v, spiking, dt, params):
    """`DestexheNeurotransmitter` (iterate_and_spike/mod.rs:147-159).

    t = t_max / (1 + exp(-(v - v_p) / k_p))
    """
    t_max = _bcast(params["nt$t_max"], t)
    v_p = _bcast(params["nt$v_p"], t)
    k_p = _bcast(params["nt$k_p"], t)
    return t_max / (1.0 + jnp.exp(-(v[..., None] - v_p) / k_p))


NT_KINETICS = {
    "approximate": nt_approximate,
    "discrete": nt_discrete,
    "exponential_decay": nt_exponential_decay,
    "destexhe": nt_destexhe,
    # `BoundedNeurotransmitterKinetics` (interface_gpu/lixirnet/src/lib.rs:23-36)
    # is the approximate rule with a smaller default clearance constant.
    "bounded": nt_approximate,
}

# Extra per-(neuron, type) state fields each neurotransmitter kinetics needs,
# with default values (reference `Default` impls).
NT_PARAM_DEFAULTS = {
    "approximate": {"nt$t_max": 1.0, "nt$clearance_constant": 0.01},
    "discrete": {"nt$t_max": 1.0},
    "exponential_decay": {"nt$t_max": 1.0, "nt$decay_constant": 2.0},
    "destexhe": {"nt$t_max": 1.0, "nt$v_p": 2.0, "nt$k_p": 5.0},
    "bounded": {"nt$t_max": 1.0, "nt$clearance_constant": 0.001},
}


def apply_t_changes(kind, state, v, spiking):
    """Update the (N, K) neurotransmitter concentration array in ``state``.

    Mirrors `Neurotransmitters::apply_t_changes`
    (iterate_and_spike/mod.rs:2245-2248); slots not present (mask False)
    keep t = 0 permanently.
    """
    t = state["nt$t"]
    dt = state["dt"]
    new_t = NT_KINETICS[kind](t, v, spiking, dt, state)
    return jnp.where(state["nt$mask"], new_t, 0.0)


# ---------------------------------------------------------------------------
# Receptor kinetics: r(r_prev, t_input, dt)
# ---------------------------------------------------------------------------


def rec_approximate(r, t, dt, params):
    """`ApproximateReceptor` (iterate_and_spike/mod.rs:434-446): r = t."""
    return t


def rec_destexhe(r, t, dt, params):
    """`DestexheReceptor` (iterate_and_spike/mod.rs:403-415).

    r += (alpha * t * (1 - r) - beta * r) * dt
    """
    alpha = _bcast(params["rec$alpha"], r)
    beta = _bcast(params["rec$beta"], r)
    return r + (alpha * t * (1.0 - r) - beta * r) * dt[..., None]


def rec_exponential_decay(r, t, dt, params):
    """`ExponentialDecayReceptor` (iterate_and_spike/mod.rs:510-523)."""
    r_max = _bcast(params["rec$r_max"], r)
    decay = _bcast(params["rec$decay_constant"], r)
    new_r = r + _exp_decay(r, decay, dt[..., None]) + t
    return jnp.clip(new_r, 0.0, r_max)


def rec_bounded(r, t, dt, params):
    """`BoundedReceptorKinetics` (interface_gpu/lixirnet/src/lib.rs:38-43):
    r = clamp(t, 0, r_max)."""
    r_max = _bcast(params["rec$r_max"], r)
    return jnp.clip(t, 0.0, r_max)


REC_KINETICS = {
    "approximate": rec_approximate,
    "destexhe": rec_destexhe,
    "exponential_decay": rec_exponential_decay,
    "bounded": rec_bounded,
}

REC_PARAM_DEFAULTS = {
    "approximate": {},
    "destexhe": {"rec$alpha": 1.0, "rec$beta": 1.0},
    "exponential_decay": {"rec$r_max": 1.0, "rec$decay_constant": 2.0},
    "bounded": {"rec$r_max": 1.0},
}


def update_receptor_kinetics(kind, state, t_input, t_valid):
    """Update (N, K) receptor gating values from aggregated input concentrations.

    Mirrors `Receptors::update_receptor_kinetics`
    (iterate_and_spike/mod.rs:1186-1206): only types present in the input
    map (``t_valid``) *and* inserted on the neuron (``rec$mask``) update.
    """
    r = state["rec$r"]
    new_r = REC_KINETICS[kind](r, t_input, state["dt"], state)
    update = jnp.logical_and(t_valid, state["rec$mask"])
    return jnp.where(update, new_r, r)
