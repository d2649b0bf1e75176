"""Receptor (ligand-gated channel) systems, vectorized over (N, K).

JAX equivalent of the reference's `Receptors` /
`IonotropicReception` traits (`reference/backend/src/neuron/
iterate_and_spike/mod.rs:885-920`) and their implementations:

* :class:`IonotropicReceptors` — AMPA/NMDA/GABA
  (iterate_and_spike/mod.rs:1068-1313)
* :class:`DopaGluGABAReceptors` — the lixirnet flagship receptor set with
  D1/D2 dopamine receptors modulating NMDA/AMPA/GABA gain
  (`reference/interface_gpu/lixirnet/src/lib.rs:45-66`)

A receptor system is a *static* config object; all per-neuron values live in
the state dict under ``rec$``-prefixed keys.  The reference keeps a HashMap
of receptor structs per neuron; here the static type axis K indexes the
system's neurotransmitter types, with a boolean (N, K) mask for inserted
receptors.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import kinetics as K

# Static neurotransmitter-type axis for the Ionotropic receptor set
# (IonotropicNeurotransmitterType, iterate_and_spike/mod.rs:1068-1073 and the
# GPU numbering at :1322-1329).
AMPA, NMDA, GABA = 0, 1, 2
IONOTROPIC_TYPES = ("AMPA", "NMDA", "GABA")
N_IONOTROPIC = 3

# Reference `Default` impls (iterate_and_spike/mod.rs:1085-1094, 1115-1125, 1148-1157)
DEFAULT_G = (1.0, 0.6, 1.2)
DEFAULT_E = (0.0, 0.0, -80.0)
DEFAULT_MG = 0.3


class ReceptorSystem:
    """Static receptor-set configuration.  Subclasses define the type axis,
    the per-neuron state fields, gating-kinetics updates, and currents."""

    type_names: tuple = ()

    @property
    def n_types(self):
        return len(self.type_names)

    def config_key(self):
        return (type(self),)

    def __hash__(self):
        return hash(self.config_key())

    def __eq__(self, other):
        return isinstance(other, ReceptorSystem) \
            and self.config_key() == other.config_key()

    def init_fields(self, n):
        raise NotImplementedError

    def insert(self, state, type_name, **params):
        """`Receptors::insert`: mark the (neuron, type) slots as present and
        optionally override per-receptor params."""
        k = self.type_names.index(type_name)
        state = dict(state)
        from ..utils.transfer import set_col, full_like
        state["rec$mask"] = set_col(state["rec$mask"], k, True)
        for p, v in params.items():
            key = f"rec${p}"
            arr = state[key]
            if arr.ndim == 2:
                state[key] = set_col(arr, k, v)
            else:
                state[key] = full_like(arr, v)
        return state

    def update_kinetics(self, state, t_input, t_valid):
        raise NotImplementedError

    def set_currents(self, state, v):
        raise NotImplementedError

    def receptor_dv(self, state):
        """Total receptor current scaled by dt / c_m
        (`get_receptor_currents`, applied as ``v += dv - receptor_dv``)."""
        raise NotImplementedError


class IonotropicReceptors(ReceptorSystem):
    """AMPA / NMDA / GABA ligand-gated channels.

    Currents (iterate_and_spike/mod.rs:1101-1166):
      AMPA / GABA : I = g * r * (v - e)
      NMDA        : I = B(v) * g * r * (v - e),
                    B(v) = 1 / (1 + exp(-0.062 v) * mg / 3.75)
    """

    type_names = IONOTROPIC_TYPES

    def __init__(self, kinetics="approximate"):
        assert kinetics in K.REC_KINETICS, kinetics
        self.kinetics = kinetics

    def config_key(self):
        return (type(self), self.kinetics)

    def init_fields(self, n):
        # host-side construction (see models.base.init_state)
        nk = (n, self.n_types)
        s = {
            "rec$r": np.zeros(nk, np.float32),
            "rec$current": np.zeros(nk, np.float32),
            "rec$g": np.broadcast_to(np.asarray(DEFAULT_G, np.float32), nk).copy(),
            "rec$e": np.broadcast_to(np.asarray(DEFAULT_E, np.float32), nk).copy(),
            "rec$mg": np.full(nk, DEFAULT_MG, np.float32),
            "rec$mask": np.zeros(nk, bool),
        }
        for f, d in K.REC_PARAM_DEFAULTS[self.kinetics].items():
            s[f] = np.full(nk, d, np.float32)
        return s

    def update_kinetics(self, state, t_input, t_valid):
        return {"rec$r": K.update_receptor_kinetics(
            self.kinetics, state, t_input, t_valid)}

    def set_currents(self, state, v):
        """`Ionotropic::set_receptor_currents`
        (iterate_and_spike/mod.rs:1259-1284): uses the pre-update voltage."""
        r = state["rec$r"]
        g = state["rec$g"]
        e = state["rec$e"]
        mg = state["rec$mg"]
        vk = v[..., None]
        base = g * r * (vk - e)
        nmda_block = 1.0 / (1.0 + jnp.exp(-0.062 * v) * mg[..., NMDA] / 3.75)
        block = jnp.ones_like(base).at[..., NMDA].set(nmda_block)
        currents = base * block
        return {"rec$current": jnp.where(state["rec$mask"], currents, 0.0)}

    def receptor_dv(self, state):
        total = jnp.sum(state["rec$current"], axis=-1)
        return total * (state["dt"] / state["c_m"])


class DopaGluGABAReceptors(ReceptorSystem):
    """Glutamate / GABA / Dopamine receptor set with dopamine gain modulation
    (lixirnet `DopaGluGABA`, interface_gpu/lixirnet/src/lib.rs:45-66).

    Per step (declaration order — Glutamate, GABA, Dopamine):
      glu_current  = inh_mod * g_ampa * ampa_r * (v - e_ampa)
                   + B(v) * inh_mod * g_nmda * nmda_r^nmda_mod * (v - e_nmda)
                   with B(v) = 1 / (1 + exp(-0.062 v) * mg / 3.57)   [sic 3.57]
      gaba_current = g_gaba * gaba_r * (v - e_gaba)
      inh_mod      = 1 - r_d2 * s_d2          (for the NEXT current update)
      nmda_mod     = 1 - r_d1 * s_d1

    All five gating values (ampa_r, nmda_r, gaba_r, r_d1, r_d2) follow the
    same receptor kinetics, driven per type: Glutamate input drives ampa_r
    and nmda_r, GABA drives gaba_r, Dopamine drives r_d1 and r_d2.
    """

    type_names = ("Glutamate", "GABA", "Dopamine")
    GLU, GABA_T, DOPA = 0, 1, 2

    def __init__(self, kinetics="bounded"):
        assert kinetics in K.REC_KINETICS, kinetics
        self.kinetics = kinetics

    def config_key(self):
        return (type(self), self.kinetics)

    def init_fields(self, n):
        # host-side construction (see models.base.init_state)
        nk = (n, self.n_types)
        s = {
            # one gating value per (neuron, slot): slots on the type axis are
            # [ampa_r | gaba_r | r_d1] and the auxiliary [nmda_r | - | r_d2]
            "rec$r": np.zeros(nk, np.float32),
            "rec$r2": np.zeros(nk, np.float32),
            "rec$mask": np.zeros(nk, bool),
            "rec$current": np.zeros(nk, np.float32),
            "rec$inh_modifier": np.ones((n,), np.float32),
            "rec$nmda_modifier": np.ones((n,), np.float32),
            "rec$g_ampa": np.full((n,), 1.0, np.float32),
            "rec$g_nmda": np.full((n,), 0.6, np.float32),
            "rec$e_ampa": np.zeros((n,), np.float32),
            "rec$e_nmda": np.zeros((n,), np.float32),
            "rec$mg": np.full((n,), 0.3, np.float32),
            "rec$g_gaba": np.full((n,), 1.2, np.float32),
            "rec$e_gaba": np.full((n,), -80.0, np.float32),
            "rec$s_d1": np.zeros((n,), np.float32),
            "rec$s_d2": np.zeros((n,), np.float32),
        }
        for f, d in K.REC_PARAM_DEFAULTS[self.kinetics].items():
            s[f] = np.full(nk, d, np.float32)
            # the secondary gating slot (nmda_r / r_d2) carries its OWN
            # kinetics params — e.g. a GlutamateReceptor whose nmda_r has a
            # different r_max than its ampa_r (lixirnet prototype objects)
            s[f.replace("rec$", "rec$r2$", 1)] = np.full(nk, d, np.float32)
        return s

    def update_kinetics(self, state, t_input, t_valid):
        r = K.update_receptor_kinetics(self.kinetics, state, t_input, t_valid)
        s2 = dict(state)
        s2["rec$r"] = state["rec$r2"]
        for f in K.REC_PARAM_DEFAULTS[self.kinetics]:
            s2[f] = state[f.replace("rec$", "rec$r2$", 1)]
        r2 = K.update_receptor_kinetics(self.kinetics, s2, t_input, t_valid)
        return {"rec$r": r, "rec$r2": r2}

    def set_currents(self, state, v):
        mask = state["rec$mask"]
        inh = state["rec$inh_modifier"]
        nmda_mod = state["rec$nmda_modifier"]

        ampa_r = state["rec$r"][..., self.GLU]
        nmda_r = state["rec$r2"][..., self.GLU]
        block = 1.0 / (1.0 + jnp.exp(-0.062 * v) * state["rec$mg"] / 3.57)
        glu_current = inh * state["rec$g_ampa"] * ampa_r * (v - state["rec$e_ampa"]) \
            + block * inh * state["rec$g_nmda"] * (nmda_r ** nmda_mod) \
            * (v - state["rec$e_nmda"])
        glu_current = jnp.where(mask[..., self.GLU], glu_current, 0.0)

        gaba_r = state["rec$r"][..., self.GABA_T]
        gaba_current = state["rec$g_gaba"] * gaba_r * (v - state["rec$e_gaba"])
        gaba_current = jnp.where(mask[..., self.GABA_T], gaba_current, 0.0)

        # dopamine group: update the shared modifiers for subsequent steps
        r_d1 = state["rec$r"][..., self.DOPA]
        r_d2 = state["rec$r2"][..., self.DOPA]
        new_inh = jnp.where(mask[..., self.DOPA],
                            1.0 - r_d2 * state["rec$s_d2"], inh)
        new_nmda_mod = jnp.where(mask[..., self.DOPA],
                                 1.0 - r_d1 * state["rec$s_d1"], nmda_mod)

        current = jnp.zeros_like(state["rec$current"])
        current = current.at[..., self.GLU].set(glu_current)
        current = current.at[..., self.GABA_T].set(gaba_current)
        return {"rec$current": current,
                "rec$inh_modifier": new_inh,
                "rec$nmda_modifier": new_nmda_mod}

    def receptor_dv(self, state):
        total = jnp.sum(state["rec$current"], axis=-1)
        return total * (state["dt"] / state["c_m"])


# ---------------------------------------------------------------------------
# Backwards-compatible module-level helpers (used by HH / Morris-Lecar)
# ---------------------------------------------------------------------------

_DEFAULT_SYSTEM = IonotropicReceptors()


def set_receptor_currents(state, v):
    return _DEFAULT_SYSTEM.set_currents(state, v)["rec$current"]


def get_receptor_currents(state, currents):
    total = jnp.sum(currents, axis=-1)
    return total * (state["dt"] / state["c_m"])
