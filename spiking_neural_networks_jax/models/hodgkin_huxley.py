"""Hodgkin-Huxley conductance model, vectorized.

JAX rebuild of `reference/backend/src/neuron/hodgkin_huxley/mod.rs`.
"""

from __future__ import annotations

import jax.numpy as jnp

from .base import NeuronModel
from ..ops import kinetics as K
from ..ops import receptors as R
from . import ion_channels as ch


class HodgkinHuxley(NeuronModel):
    """`HodgkinHuxleyNeuron` (hodgkin_huxley/mod.rs:49-242).

    Step order (hodgkin_huxley/mod.rs:188-201): [receptor update if chemical]
    -> gate updates from old v -> voltage update
    ``v += dt * (i - (i_na + i_k + i_kleak)) / c_m - i_ligand_gates``
    -> neurotransmitter release -> peak-detection spike flag.

    Note: the reference's default kinetics here are Destexhe
    (`HodgkinHuxleyNeuron::default_impl`, :101-106).
    """

    name = "hodgkin_huxley"
    FIELDS = dict(
        v=-65.0, gap_conductance=7.0, dt=0.01, c_m=1.0, v_th=0.0,
        **ch.NA_DEFAULTS, **ch.K_DEFAULTS, **ch.KLEAK_DEFAULTS,
    )
    BOOL_FIELDS = dict(was_increasing=False)

    def __init__(self, nt_kinetics="destexhe", rec_kinetics="destexhe"):
        super().__init__(nt_kinetics=nt_kinetics, rec_kinetics=rec_kinetics)

    def step(self, s, i, t_input=None, t_valid=None, skip_nt=False):
        s = dict(s)
        if t_input is not None:
            s.update(self.receptors.update_kinetics(s, t_input, t_valid))
            s.update(self.receptors.set_currents(s, s["v"]))

        last_voltage = s["v"]

        # update_gates (hodgkin_huxley/mod.rs:182-186)
        s.update(ch.na_channel_update(s, s["v"], s["dt"]))
        s.update(ch.k_channel_update(s, s["v"], s["dt"]))
        s.update(ch.k_leak_channel_update(s, s["v"]))

        # update_cell_voltage (hodgkin_huxley/mod.rs:156-165); note the ligand
        # current uses the stored receptor currents even in the electrical path.
        i_ligand = self.receptors.receptor_dv(s)
        i_sum = i - (s["na$current"] + s["k$current"] + s["kleak$current"])
        s["v"] = s["v"] + s["dt"] * i_sum / s["c_m"] - i_ligand

        if not skip_nt:
            s["nt$t"] = K.apply_t_changes(
                self.nt_kinetics, s, s["v"], s["is_spiking"])

        s, spikes = self._handle_peak_detection(s, last_voltage)
        s["is_spiking"] = spikes
        return s, spikes
