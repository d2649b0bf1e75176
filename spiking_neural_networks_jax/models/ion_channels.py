"""Ion channel library, vectorized over the neuron axis.

JAX rebuild of `reference/backend/src/neuron/ion_channels/mod.rs`.
Channels are pure functions over (N,) state arrays stored with a per-channel
key prefix (e.g. ``na$m_state``), mirroring the reference's
`BasicGatingVariable` (:14-45) Euler update
``state += dt * (alpha * (1 - state) - beta * state)``.
"""

from __future__ import annotations

import jax.numpy as jnp


def gate_update(alpha, beta, state, dt):
    """`BasicGatingVariable::update` (ion_channels/mod.rs:40-44)."""
    return state + dt * (alpha * (1.0 - state) - beta * state)


def gate_init_state(alpha, beta):
    """`BasicGatingVariable::init_state` (ion_channels/mod.rs:35-37)."""
    return alpha / (alpha + beta)


# -- Hodgkin-Huxley channels -------------------------------------------------

NA_DEFAULTS = {"na$g": 120.0, "na$e": 50.0, "na$m_state": 0.0, "na$h_state": 0.0,
               "na$current": 0.0}
K_DEFAULTS = {"k$g": 36.0, "k$e": -77.0, "k$n_state": 0.0, "k$current": 0.0}
KLEAK_DEFAULTS = {"kleak$g": 0.3, "kleak$e": -55.0, "kleak$current": 0.0}


def na_channel_update(s, v, dt):
    """`NaIonChannel` (ion_channels/mod.rs:192-240)."""
    m_alpha = 0.1 * ((v + 40.0) / (1.0 - jnp.exp(-(v + 40.0) / 10.0)))
    m_beta = 4.0 * jnp.exp(-(v + 65.0) / 18.0)
    h_alpha = 0.07 * jnp.exp(-(v + 65.0) / 20.0)
    h_beta = 1.0 / (jnp.exp(-(v + 35.0) / 10.0) + 1.0)
    m = gate_update(m_alpha, m_beta, s["na$m_state"], dt)
    h = gate_update(h_alpha, h_beta, s["na$h_state"], dt)
    current = m ** 3 * h * s["na$g"] * (v - s["na$e"])
    return {"na$m_state": m, "na$h_state": h, "na$current": current}


def k_channel_update(s, v, dt):
    """`KIonChannel` (ion_channels/mod.rs:244-286)."""
    n_alpha = 0.01 * (v + 55.0) / (1.0 - jnp.exp(-(v + 55.0) / 10.0))
    n_beta = 0.125 * jnp.exp(-(v + 65.0) / 80.0)
    n = gate_update(n_alpha, n_beta, s["k$n_state"], dt)
    current = n ** 4 * s["k$g"] * (v - s["k$e"])
    return {"k$n_state": n, "k$current": current}


def k_leak_channel_update(s, v):
    """`KLeakChannel` (ion_channels/mod.rs:289-317), timestep-independent."""
    return {"kleak$current": s["kleak$g"] * (v - s["kleak$e"])}


# -- Morris-Lecar channels -----------------------------------------------------

CA_REDUCED_DEFAULTS = {"ca$g": 4.0, "ca$v": 120.0, "ca$m_ss": 0.0, "ca$v_1": -1.2,
                       "ca$v_2": 18.0, "ca$current": 0.0}
K_SS_DEFAULTS = {"kss$g": 8.0, "kss$v": -84.0, "kss$n": 0.0, "kss$n_ss": 0.0,
                 "kss$t_n": 0.0, "kss$phi": 0.067, "kss$v_3": 12.0,
                 "kss$v_4": 17.4, "kss$current": 0.0}
LEAK_DEFAULTS = {"leak$g": 2.0, "leak$v": -60.0, "leak$current": 0.0}


def reduced_calcium_update(s, v):
    """`ReducedCalciumChannel` (ion_channels/mod.rs:321-359)."""
    m_ss = 0.5 * (1.0 + jnp.tanh((v - s["ca$v_1"]) / s["ca$v_2"]))
    current = s["ca$g"] * m_ss * (v - s["ca$v"])
    return {"ca$m_ss": m_ss, "ca$current": current}


def k_steady_state_update(s, v, dt):
    """`KSteadyStateChannel` (ion_channels/mod.rs:363-421)."""
    n_ss = 0.5 * (1.0 + jnp.tanh((v - s["kss$v_3"]) / s["kss$v_4"]))
    t_n = 1.0 / (s["kss$phi"] * jnp.cosh((v - s["kss$v_3"]) / (2.0 * s["kss$v_4"])))
    n = s["kss$n"] + ((n_ss - s["kss$n"]) / t_n) * dt
    current = s["kss$g"] * n * (v - s["kss$v"])
    return {"kss$n_ss": n_ss, "kss$t_n": t_n, "kss$n": n, "kss$current": current}


def leak_channel_update(s, v):
    """`LeakChannel` (ion_channels/mod.rs:424-452)."""
    return {"leak$current": s["leak$g"] * (v - s["leak$v"])}


# -- Additional library channels -------------------------------------------------

CA_DEFAULTS = {"hva_ca$g": 0.025, "hva_ca$e": 80.0, "hva_ca$s_state": 0.0,
               "hva_ca$current": 0.0}


def calcium_channel_update(s, v, dt):
    """`CalciumIonChannel` (high-voltage activated, ion_channels/mod.rs:142-188)."""
    s_alpha = 1.6 / (1.0 + jnp.exp(-0.072 * (v - 5.0)))
    s_beta = (0.02 * (v + 8.9)) / (jnp.exp(v + 8.9) / 5.0 - 1.0)
    gate = gate_update(s_alpha, s_beta, s["hva_ca$s_state"], dt)
    current = -(gate ** 2) * s["hva_ca$g"] * (v - s["hva_ca$e"])
    return {"hva_ca$s_state": gate, "hva_ca$current": current}
