"""The lixirnet flagship neuron: Izhikevich with DopaGluGABA receptors.

JAX rebuild of the `neuron_builder!` model embedded in
`reference/interface_gpu/lixirnet/src/lib.rs:22-79`:
`IzhikevichNeuron` with `BoundedNeurotransmitterKinetics`,
`BoundedReceptorKinetics` and the `DopaGluGABA` receptor set
(Glutamate / GABA / Dopamine with D1/D2 gain modulation).
"""

from __future__ import annotations

from .base import NeuronModel
from ..ops.receptors import DopaGluGABAReceptors


class DopaIzhikevich(NeuronModel):
    """lixirnet `IzhikevichNeuron` (interface_gpu/lixirnet/src/lib.rs:68-79):

        du/dt = (a (b v - u)) / tau_m
        dv/dt = (0.04 v^2 + 5 v + 140 - u + i) / c_m
        spike: v >= v_th -> v = c, u += d

    ``u`` is stored as ``w`` for consistency with the Izhikevich family.
    The DSL auto-injects gap_conductance = 10 (nb_macro/src/lib.rs:2209-2210).
    """

    name = "dopa_izhikevich"
    FIELDS = dict(
        v=-65.0, w=30.0, a=0.02, b=0.2, c=-55.0, d=8.0, v_th=30.0,
        tau_m=1.0, c_m=100.0, gap_conductance=10.0, dt=0.1,
    )

    def __init__(self, nt_kinetics="bounded", rec_kinetics="bounded",
                 receptors=None):
        if receptors is None:
            receptors = DopaGluGABAReceptors(rec_kinetics)
        super().__init__(nt_kinetics=nt_kinetics, rec_kinetics=rec_kinetics,
                         receptors=receptors)

    def deltas(self, s, i):
        dw = (s["a"] * (s["b"] * s["v"] - s["w"])) * (s["dt"] / s["tau_m"])
        dv = (0.04 * s["v"] * s["v"] + 5.0 * s["v"] + 140.0 - s["w"] + i) \
            * (s["dt"] / s["c_m"])
        return {"v": dv, "w": dw}

    def handle_spiking(self, s):
        return self._handle_izhikevich(s)
