"""Plasticity rules as vectorized edge updates.

JAX rebuild of `reference/backend/src/neuron/plasticity/mod.rs`.

The reference mutates the incoming *and* outgoing edges of every spiking
neuron during its serial sweep (neuron/mod.rs:849-881); since the STDP/BCM
weight deltas depend only on last-firing-times / activity values (not on the
weights of other edges), the update is order-independent and vectorizes as:

    dw_edge(i, j) = rule(i, j) * (spiking_i + spiking_j)

— an edge is updated once per spiking endpoint (twice when both endpoints
spike, exactly like the serial double visit).  We use the *deferred* variant
the reference itself uses for networks (neuron/mod.rs:2425-2461): all deltas
are computed from post-step state, after every neuron has advanced.

Plasticity parameters are plain dicts of f32 scalars passed as dynamic jit
arguments, so tuning them never triggers recompilation.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.base import NEVER


class STDP:
    """Pair-based spike-time-dependent plasticity (plasticity/mod.rs:16-70).

    t_pre < t_post:  dw = +a_plus  * exp(-|t_pre - t_post| * dt / tau_plus)
    t_pre > t_post:  dw = -a_minus * exp(-|t_post - t_pre| * dt / tau_minus)
    """

    name = "stdp"

    def __init__(self, a_plus=2.0, a_minus=2.0, tau_plus=4.5, tau_minus=4.5,
                 dt=0.1):
        self.params = dict(a_plus=a_plus, a_minus=a_minus, tau_plus=tau_plus,
                           tau_minus=tau_minus, dt=dt)

    def set_dt(self, dt):
        self.params["dt"] = dt

    # per-node values the edge update needs
    PRE_KEYS = ("last_firing_time", "is_spiking")
    POST_KEYS = ("last_firing_time", "is_spiking")

    @staticmethod
    def edge_delta(w, pre, post, p):
        """Raw STDP delta for one visit of `STDP::update_weight`
        (plasticity/mod.rs:46-65), without the per-spiking-endpoint count."""
        t_pre = pre["last_firing_time"]
        t_post = post["last_firing_time"]
        both = jnp.logical_and(t_pre != NEVER, t_post != NEVER)
        diff = jnp.abs((t_pre - t_post).astype(jnp.float32)) * p["dt"]
        # one exp of the selected argument: bitwise identical to the
        # exp-per-branch form, halves the transcendental count
        pre_first = t_pre < t_post
        e = jnp.exp(jnp.where(pre_first, -diff / p["tau_plus"],
                              -diff / p["tau_minus"]))
        dw = jnp.where(pre_first, p["a_plus"] * e,
                       jnp.where(t_pre > t_post, -p["a_minus"] * e, 0.0))
        return jnp.where(both, dw, 0.0)

    @staticmethod
    def edge_dw(w, pre, post, p):
        count = pre["is_spiking"].astype(jnp.float32) \
            + post["is_spiking"].astype(jnp.float32)
        return STDP.edge_delta(w, pre, post, p) * count

    @staticmethod
    def apply_visits(w, pre, post, p, count):
        """Apply ``count`` serial visits of the rule.  The STDP delta is
        weight-independent, so serial visits sum exactly."""
        return w + STDP.edge_delta(w, pre, post, p) * count

    NODE_KEYS = ("last_firing_time", "is_spiking")

    def apply(self, graph, state, params):
        vals = {k: state[k] for k in ("last_firing_time", "is_spiking")}
        return graph.apply_edge_update(
            lambda w, pre, post: self.edge_dw(w, pre, post, params),
            vals, vals)


class BCM:
    """Bienenstock-Cooper-Munro rule (plasticity/mod.rs:82-112).

    dw = (act_post * (act_post - avg_post / average_scalar) * act_pre
          - decay * w) * dt,   gated on postsynaptic spiking (do_update).
    """

    name = "bcm"

    def __init__(self, decay=0.1, average_scalar=0.1, dt=0.1):
        self.params = dict(decay=decay, average_scalar=average_scalar, dt=dt)

    def set_dt(self, dt):
        self.params["dt"] = dt

    @staticmethod
    def edge_delta(w, pre, post, p):
        threshold = post["average_activity"] / p["average_scalar"]
        act = post["current_activity"]
        term = act * (act - threshold) * pre["current_activity"]
        return (term - p["decay"] * w) * p["dt"]

    @staticmethod
    def apply_visits(w, pre, post, p, count):
        """Apply ``count`` serial visits.  Unlike STDP, the BCM delta reads
        the *current* weight through its decay term, so the reference's
        second serial visit (both endpoints spiking,
        neuron/mod.rs:849-881 sweep) computes decay on the already-updated
        weight: two visits are d1 + d2(w + d1), not 2*d1.  Visit order is
        irrelevant (the delta is affine in w)."""
        d1 = BCM.edge_delta(w, pre, post, p)
        d2 = BCM.edge_delta(w + d1, pre, post, p)
        return w + jnp.where(count >= 2.0, d1 + d2, d1 * count)

    @staticmethod
    def edge_dw(w, pre, post, p):
        count = pre["is_spiking"].astype(jnp.float32) \
            + post["is_spiking"].astype(jnp.float32)
        return BCM.apply_visits(w, pre, post, p, count) - w

    NODE_KEYS = ("current_activity", "average_activity", "is_spiking")

    def apply(self, graph, state, params):
        vals = {k: state[k] for k in
                ("current_activity", "average_activity", "is_spiking")}
        return graph.apply_edge_update(
            lambda w, pre, post: self.edge_dw(w, pre, post, params),
            vals, vals)


class RewardModulatedSTDP:
    """R-STDP with dopamine-modulated eligibility traces
    (plasticity/mod.rs:165-242).

    Per-edge trace state (TraceRSTDP, :122-150): ``dw`` accumulator, trace
    ``c``, alternation ``counter``.  Every step (do_update always true):

        dw   += stdp_delta
        every 2nd visit: c = c * exp(-dt / tau_c) + tau_c * dw ; dw = 0
        weight += c * dopamine

    The scalar dopamine state decays as
    ``dopamine = dopamine * exp(-dt / tau_d) + tau_d * reward`` (:204-206).
    """

    name = "rstdp"

    def __init__(self, tau_d=20.0, tau_c=0.0001, a_plus=2.0, a_minus=2.0,
                 tau_plus=4.5, tau_minus=4.5, dt=0.1):
        self.params = dict(tau_d=tau_d, tau_c=tau_c, a_plus=a_plus,
                           a_minus=a_minus, tau_plus=tau_plus,
                           tau_minus=tau_minus, dt=dt)
        self.dopamine = 0.0

    def set_dt(self, dt):
        self.params["dt"] = dt

    @staticmethod
    def update_dopamine(dopamine, reward, p):
        return dopamine * jnp.exp(-p["dt"] / p["tau_d"]) + p["tau_d"] * reward

    @staticmethod
    def trace_step(w, c, dw_acc, counter, delta_w, dopamine, p):
        """Vectorized TraceRSTDP bookkeeping for one visit (plasticity/mod.rs:208-237)."""
        dw_acc = dw_acc + delta_w
        apply_trace = counter != 0
        new_c = jnp.where(apply_trace,
                          c * jnp.exp(-p["dt"] / p["tau_c"]) + p["tau_c"] * dw_acc,
                          c)
        new_dw = jnp.where(apply_trace, 0.0, dw_acc)
        new_counter = jnp.where(apply_trace, 0, 1).astype(counter.dtype)
        new_w = w + new_c * dopamine
        return new_w, new_c, new_dw, new_counter

    @staticmethod
    def stdp_delta(pre, post, p):
        t_pre = pre["last_firing_time"]
        t_post = post["last_firing_time"]
        both = jnp.logical_and(t_pre != NEVER, t_post != NEVER)
        diff = jnp.abs((t_pre - t_post).astype(jnp.float32)) * p["dt"]
        pre_first = t_pre < t_post
        e = jnp.exp(jnp.where(pre_first, -diff / p["tau_plus"],
                              -diff / p["tau_minus"]))
        dw = jnp.where(pre_first, p["a_plus"] * e,
                       jnp.where(t_pre > t_post, -p["a_minus"] * e, 0.0))
        return jnp.where(both, dw, 0.0)
