"""Multi-chip sharding: batched lattices over a (dp, tp) device mesh.

The reference is single-process (SURVEY.md §2.5); this module is the
scale-out design it lacks, as JAX device meshes:

* **dp** (data parallel): a batch axis of independent lattices — the analog
  of the reference's per-experiment grid searches (e.g. the Bayesian
  inference pipeline's trial sweeps) run simultaneously.
* **tp** (tensor/model parallel): the *postsynaptic* neuron axis.  Neuron
  state is sharded over tp; the dense synaptic weight matrix (B, N_pre,
  N_post) is sharded on its column (post) axis, so the gap-junction gather
  ``einsum('bi,bij->bj', v, W)`` keeps each weight shard local and XLA
  inserts one all-gather of the (small) presynaptic voltage vector
  — the classic column-parallel layout from the scaling-book recipe.

Plasticity (STDP) is the "training step" of an SNN: the outer-product weight
update ``dw[b, i, j] = f(lft[b, i], lft[b, j])`` is computed directly in the
sharded layout (lft broadcast, dw column-sharded like W), with zero extra
communication.

Everything is expressed with `NamedSharding` constraints under `jax.jit`;
no per-device hand scheduling.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.base import NEVER
from ..core.plasticity import STDP


def make_mesh(n_devices=None, dp=None, devices=None):
    """Build a (dp, tp) mesh.  Picks dp=2 when the device count is even and
    >2, else dp=1 (pure tensor parallelism)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    if n_devices is not None and len(devices) < n_devices:
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} available")
    n = len(devices)
    if dp is None:
        dp = 2 if (n % 2 == 0 and n > 2) else 1
    tp = n // dp
    assert dp * tp == n, f"cannot factor {n} devices into dp={dp}"
    dev_array = np.asarray(devices).reshape(dp, tp)
    return Mesh(dev_array, ("dp", "tp"))


def state_sharding(mesh):
    """Neuron-state arrays are (B, N[, K]): batch over dp, neurons over tp."""
    def spec(arr):
        if arr.ndim >= 2:
            return NamedSharding(mesh, P("dp", "tp", *([None] * (arr.ndim - 2))))
        return NamedSharding(mesh, P("dp"))
    return spec


def batched_state(model, batch, n, **overrides):
    """Init a (B, N)-leading SoA state (batch of identical lattices)."""
    s = model.init_state(n, **overrides)
    return {k: jnp.broadcast_to(v[None], (batch,) + v.shape) for k, v in s.items()}


def _batched_electrical_gather(v, g_post, weights, mask):
    """Dense batched gap-junction gather with in-degree averaging
    (semantics of neuron/mod.rs:710-729, batched)."""
    w = jnp.where(mask, weights, 0.0)
    wa = jnp.einsum("bi,bij->bj", v, w, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    wsub = jnp.sum(w, axis=1)
    cnt = jnp.maximum(jnp.sum(mask, axis=1).astype(jnp.float32), 1.0)
    return g_post * (wa - v * wsub) / cnt


def make_sharded_training_step(mesh, model):
    """Build a jitted one-step training function over the mesh.

    step(state, weights, mask, clock, pparams) -> (state, weights, spikes)

    `state` fields are (B, N); `weights`/`mask` are (B, N, N) column-sharded.
    One step = Phase A gather, Phase B neuron update, deferred STDP weight
    update (the reference's lattice step + plasticity as one fused program).
    """
    wspec = NamedSharding(mesh, P("dp", None, "tp"))
    sspec = NamedSharding(mesh, P("dp", "tp"))
    stdp = STDP()

    def step(state, weights, mask, clock, pparams):
        v = jax.lax.with_sharding_constraint(state["v"], sspec)
        elec = _batched_electrical_gather(
            v, state["gap_conductance"], weights, mask)
        elec = jax.lax.with_sharding_constraint(elec, sspec)

        state, spikes = model.step(state, elec, skip_nt=True)
        state["last_firing_time"] = jnp.where(
            spikes, clock, state["last_firing_time"])

        # STDP on every edge touching a spiking endpoint — the shared edge
        # rule from core/plasticity.py in outer-product (B, N_pre, N_post)
        # form (pre broadcast over columns, post over rows): zero extra
        # communication, dw is column-sharded like W.
        pre = {"last_firing_time": state["last_firing_time"][:, :, None],
               "is_spiking": spikes[:, :, None]}
        post = {"last_firing_time": state["last_firing_time"][:, None, :],
                "is_spiking": spikes[:, None, :]}
        count = (spikes[:, :, None].astype(jnp.float32)
                 + spikes[:, None, :].astype(jnp.float32))
        w_new = STDP.apply_visits(weights, pre, post, pparams, count)
        weights = jnp.where(mask, w_new, weights)
        weights = jax.lax.with_sharding_constraint(weights, wspec)

        return state, weights, spikes

    # state keeps per-leaf inferred shardings (donated inputs carry them);
    # pin the weight/spike outputs to the canonical layout
    jitted = jax.jit(step, donate_argnums=(0, 1),
                     out_shardings=(None, wspec, sspec))
    return jitted, stdp


def shard_batched_inputs(mesh, state, weights, mask):
    """Place host arrays onto the mesh with the canonical shardings."""
    spec = state_sharding(mesh)
    state = {k: jax.device_put(v, spec(v)) for k, v in state.items()}
    wspec = NamedSharding(mesh, P("dp", None, "tp"))
    return state, jax.device_put(weights, wspec), jax.device_put(mask,
                                                                 wspec)
