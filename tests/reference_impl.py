"""Independent scalar (object-per-neuron) reference implementation.

Pure-NumPy float32 re-implementation of the reference Rust semantics
(equations cited per class), used as the golden model for the vectorized JAX
framework.  Deliberately written object-per-neuron like the Rust crate so it
shares no code with the framework under test.
"""

import numpy as np

f32 = np.float32

AMPA, NMDA, GABA = 0, 1, 2
NEVER = None


# --------------------------------------------------------------------------
# Kinetics
# --------------------------------------------------------------------------

class ApproxNT:
    def __init__(self, t_max=1.0, clearance=0.01):
        self.t = f32(0.0)
        self.t_max = f32(t_max)
        self.clearance = f32(clearance)

    def apply_t_change(self, v, is_spiking, dt):
        t = self.t + dt * -self.clearance * self.t \
            + (f32(1.0) if is_spiking else f32(0.0)) * self.t_max
        self.t = min(self.t_max, max(t, f32(0.0)))


class DestexheNT:
    def __init__(self, t_max=1.0, v_p=2.0, k_p=5.0):
        self.t = f32(0.0)
        self.t_max = f32(t_max)
        self.v_p = f32(v_p)
        self.k_p = f32(k_p)

    def apply_t_change(self, v, is_spiking, dt):
        self.t = self.t_max / (f32(1.0) + np.exp(-(v - self.v_p) / self.k_p, dtype=f32))


class ExpDecayNT:
    def __init__(self, t_max=1.0, decay=2.0):
        self.t = f32(0.0)
        self.t_max = f32(t_max)
        self.decay = f32(decay)

    def apply_t_change(self, v, is_spiking, dt):
        t = self.t + (-self.t * np.exp(dt / -self.decay, dtype=f32)) \
            + (f32(1.0) if is_spiking else f32(0.0)) * self.t_max
        self.t = min(self.t_max, max(t, f32(0.0)))


class ApproxR:
    def __init__(self):
        self.r = f32(0.0)

    def apply_r_change(self, t, dt):
        self.r = f32(t)


class DestexheR:
    def __init__(self, alpha=1.0, beta=1.0):
        self.r = f32(0.0)
        self.alpha = f32(alpha)
        self.beta = f32(beta)

    def apply_r_change(self, t, dt):
        self.r = self.r + (self.alpha * t * (f32(1.0) - self.r)
                           - self.beta * self.r) * dt


class ExpDecayR:
    def __init__(self, r_max=1.0, decay=2.0):
        self.r = f32(0.0)
        self.r_max = f32(r_max)
        self.decay = f32(decay)

    def apply_r_change(self, t, dt):
        r = self.r + (-self.r * np.exp(dt / -self.decay, dtype=f32)) + t
        self.r = min(self.r_max, max(r, f32(0.0)))


NT_KINDS = {"approximate": ApproxNT, "destexhe": DestexheNT,
            "exponential_decay": ExpDecayNT}
R_KINDS = {"approximate": ApproxR, "destexhe": DestexheR,
           "exponential_decay": ExpDecayR}


class Receptor:
    """AMPA/NMDA/GABA receptor with pluggable gating kinetics."""

    def __init__(self, kind, g, e, mg=0.3, rk="approximate"):
        self.kind = kind
        self.g = f32(g)
        self.e = f32(e)
        self.mg = f32(mg)
        self.current = f32(0.0)
        self.r = R_KINDS[rk]()

    def iterate(self, v):
        if self.kind == NMDA:
            block = f32(1.0) / (f32(1.0) + (np.exp(f32(-0.062) * v, dtype=f32)
                                            * self.mg) / f32(3.75))
            self.current = (block * self.g * self.r.r) * (v - self.e)
        else:
            self.current = (self.g * self.r.r) * (v - self.e)


DEFAULT_RECEPTOR = {
    AMPA: dict(g=1.0, e=0.0),
    NMDA: dict(g=0.6, e=0.0, mg=0.3),
    GABA: dict(g=1.2, e=-80.0),
}


class ReceptorSet:
    def __init__(self, kinds=(), rk="approximate"):
        self.receptors = {k: Receptor(k, rk=rk, **DEFAULT_RECEPTOR[k])
                          for k in kinds}

    def update_kinetics(self, t_total, dt):
        for k, conc in t_total.items():
            if k in self.receptors:
                self.receptors[k].r.apply_r_change(conc, dt)

    def set_currents(self, v):
        for rec in self.receptors.values():
            rec.iterate(v)

    def get_currents(self, dt, c_m):
        total = f32(0.0)
        for rec in self.receptors.values():
            total = total + rec.current
        return total * (dt / c_m)


class NTSet:
    def __init__(self, kinds=(), nt="approximate"):
        self.nts = {k: NT_KINDS[nt]() for k in kinds}

    def apply_t_changes(self, v, is_spiking, dt):
        for x in self.nts.values():
            x.apply_t_change(v, is_spiking, dt)

    def concentrations(self):
        return {k: x.t for k, x in self.nts.items()}


def weight_concentrations(conc, w):
    return {k: v * f32(w) for k, v in conc.items()}


def aggregate_concentrations(maps):
    out, counts = {}, {}
    for m in maps:
        for k, v in m.items():
            out[k] = out.get(k, f32(0.0)) + v
            counts[k] = counts.get(k, 0) + 1
    return {k: out[k] / f32(counts[k]) for k in out}


# --------------------------------------------------------------------------
# Neurons
# --------------------------------------------------------------------------

class RefNeuronBase:
    nt_types = ()
    rec_types = ()
    nt_kind = "approximate"
    rec_kind = "approximate"

    def init_synapses(self):
        self.nts = NTSet(self.nt_types, self.nt_kind)
        self.receptors = ReceptorSet(self.rec_types, self.rec_kind)
        self.is_spiking = False
        self.last_firing_time = NEVER

    def get_concentrations(self):
        return self.nts.concentrations()


class RefIzhikevich(RefNeuronBase):
    """integrate_and_fire/mod.rs:1159-1268."""

    def __init__(self, **kw):
        self.v = f32(-65.0); self.v_th = f32(30.0)
        self.a = f32(0.02); self.b = f32(0.2); self.c = f32(-55.0); self.d = f32(8.0)
        self.w = f32(30.0); self.gap_conductance = f32(7.0)
        self.tau_m = f32(1.0); self.c_m = f32(100.0); self.dt = f32(0.1)
        for k, v in kw.items():
            setattr(self, k, f32(v))
        self.init_synapses()

    def dv(self, i):
        return (f32(0.04) * self.v * self.v + f32(5.0) * self.v + f32(140.0)
                - self.w + i) * (self.dt / self.c_m)

    def dw(self):
        return (self.a * (self.b * self.v - self.w)) * (self.dt / self.tau_m)

    def handle_spiking(self):
        spiking = bool(self.v >= self.v_th)
        if spiking:
            self.v = self.c
            self.w = self.w + self.d
        self.is_spiking = spiking
        return spiking

    def iterate_and_spike(self, i):
        dv, dw = self.dv(f32(i)), self.dw()
        self.v = self.v + dv
        self.w = self.w + dw
        self.nts.apply_t_changes(self.v, self.is_spiking, self.dt)
        return self.handle_spiking()

    def iterate_with_neurotransmitter_and_spike(self, i, t_total):
        self.receptors.update_kinetics(t_total, self.dt)
        self.receptors.set_currents(self.v)
        dv, dw = self.dv(f32(i)), self.dw()
        rec_dv = -self.receptors.get_currents(self.dt, self.c_m)
        self.v = self.v + dv + rec_dv
        self.w = self.w + dw
        self.nts.apply_t_changes(self.v, self.is_spiking, self.dt)
        return self.handle_spiking()


class RefLIF(RefNeuronBase):
    """integrate_and_fire/mod.rs:108-215."""

    def __init__(self, **kw):
        self.v = f32(-75.0); self.v_th = f32(-55.0); self.v_reset = f32(-75.0)
        self.refractory_count = f32(0.0); self.tref = f32(10.0)
        self.leak_constant = f32(-1.0); self.integration_constant = f32(1.0)
        self.gap_conductance = f32(7.0); self.e_l = f32(-75.0)
        self.g_l = f32(10.0); self.tau_m = f32(10.0); self.c_m = f32(100.0)
        self.dt = f32(0.1)
        for k, v in kw.items():
            setattr(self, k, f32(v))
        self.init_synapses()

    def dv(self, i):
        return ((self.leak_constant * (self.v - self.e_l))
                + (self.integration_constant * (i / self.g_l))) \
            * (self.dt / self.tau_m)

    def handle_spiking(self):
        spiking = False
        if self.refractory_count > 0:
            self.v = self.v_reset
            self.refractory_count = self.refractory_count - f32(1.0)
        elif self.v >= self.v_th:
            spiking = True
            self.v = self.v_reset
            self.refractory_count = self.tref / self.dt
        self.is_spiking = spiking
        return spiking

    def iterate_and_spike(self, i):
        self.v = self.v + self.dv(f32(i))
        self.nts.apply_t_changes(self.v, self.is_spiking, self.dt)
        return self.handle_spiking()

    def iterate_with_neurotransmitter_and_spike(self, i, t_total):
        self.receptors.update_kinetics(t_total, self.dt)
        self.receptors.set_currents(self.v)
        dv = self.dv(f32(i))
        rec_dv = -self.receptors.get_currents(self.dt, self.c_m)
        self.v = self.v + dv + rec_dv
        self.nts.apply_t_changes(self.v, self.is_spiking, self.dt)
        return self.handle_spiking()


class RefAdaptiveLIF(RefLIF):
    """integrate_and_fire/mod.rs:921-1051."""

    def __init__(self, **kw):
        self.alpha = f32(6.0); self.beta = f32(10.0); self.w = f32(0.0)
        super().__init__(**kw)

    def dv(self, i):
        return ((self.leak_constant * (self.v - self.e_l))
                + (self.integration_constant * (i / self.g_l))
                - (self.w / self.g_l)) * (self.dt / self.c_m)

    def dw(self):
        return (self.alpha * (self.v - self.e_l) - self.w) * (self.dt / self.tau_m)

    def handle_spiking(self):
        spiking = False
        if self.refractory_count > 0:
            self.v = self.v_reset
            self.refractory_count = self.refractory_count - f32(1.0)
        elif self.v >= self.v_th:
            spiking = True
            self.v = self.v_reset
            self.w = self.w + self.beta
            self.refractory_count = self.tref / self.dt
        self.is_spiking = spiking
        return spiking

    def iterate_and_spike(self, i):
        dv, dw = self.dv(f32(i)), self.dw()
        self.v = self.v + dv
        self.w = self.w + dw
        self.nts.apply_t_changes(self.v, self.is_spiking, self.dt)
        return self.handle_spiking()

    def iterate_with_neurotransmitter_and_spike(self, i, t_total):
        self.receptors.update_kinetics(t_total, self.dt)
        self.receptors.set_currents(self.v)
        dv, dw = self.dv(f32(i)), self.dw()
        rec_dv = -self.receptors.get_currents(self.dt, self.c_m)
        self.v = self.v + dv + rec_dv
        self.w = self.w + dw
        self.nts.apply_t_changes(self.v, self.is_spiking, self.dt)
        return self.handle_spiking()


class RefAdExLIF(RefAdaptiveLIF):
    """integrate_and_fire/mod.rs:1055-1155."""

    def __init__(self, **kw):
        self.slope_factor = f32(1.0)
        super().__init__(**kw)

    def dv(self, i):
        return ((self.leak_constant * (self.v - self.e_l))
                + (self.slope_factor * np.exp((self.v - self.v_th) / self.slope_factor, dtype=f32))
                + (self.integration_constant * (i / self.g_l))
                - (self.w / self.g_l)) * (self.dt / self.c_m)


class RefQIF(RefLIF):
    """integrate_and_fire/mod.rs:259-365."""

    def __init__(self, **kw):
        self.alpha = f32(1.0); self.v_c = f32(-60.0)
        super().__init__(**kw)
        if "tau_m" not in kw:
            self.tau_m = f32(100.0)

    def dv(self, i):
        return ((self.alpha * (self.v - self.v_reset) * (self.v - self.v_c))
                + self.integration_constant * i) * (self.dt / self.tau_m)


class RefSimpleLIF(RefNeuronBase):
    """integrate_and_fire/mod.rs:1523-1633."""

    def __init__(self, **kw):
        self.v = f32(-75.0); self.g = f32(-0.1); self.e = f32(0.0)
        self.v_th = f32(-55.0); self.v_reset = f32(-75.0)
        self.gap_conductance = f32(10.0); self.c_m = f32(100.0); self.dt = f32(0.1)
        for k, v in kw.items():
            setattr(self, k, f32(v))
        self.init_synapses()

    def iterate_and_spike(self, i):
        self.v = self.v + (self.g * (self.v - self.e) + f32(i)) * self.dt
        self.nts.apply_t_changes(self.v, self.is_spiking, self.dt)
        spiking = bool(self.v >= self.v_th)
        if spiking:
            self.v = self.v_reset
        self.is_spiking = spiking
        return spiking

    def iterate_with_neurotransmitter_and_spike(self, i, t_total):
        self.receptors.update_kinetics(t_total, self.dt)
        self.receptors.set_currents(self.v)
        rec_dv = -self.receptors.get_currents(self.dt, self.c_m)
        self.v = self.v + (self.g * (self.v - self.e) + f32(i)) * self.dt + rec_dv
        self.nts.apply_t_changes(self.v, self.is_spiking, self.dt)
        spiking = bool(self.v >= self.v_th)
        if spiking:
            self.v = self.v_reset
        self.is_spiking = spiking
        return spiking


class Gate:
    def __init__(self):
        self.alpha = f32(0.0)
        self.beta = f32(0.0)
        self.state = f32(0.0)

    def update(self, dt):
        self.state = self.state + dt * (self.alpha * (f32(1.0) - self.state)
                                        - self.beta * self.state)


class RefHodgkinHuxley(RefNeuronBase):
    """hodgkin_huxley/mod.rs:49-242 + ion_channels/mod.rs:192-317."""

    nt_kind = "destexhe"
    rec_kind = "destexhe"

    def __init__(self, **kw):
        self.v = f32(-65.0); self.gap_conductance = f32(7.0)
        self.dt = f32(0.01); self.c_m = f32(1.0); self.v_th = f32(0.0)
        self.g_na = f32(120.0); self.e_na = f32(50.0)
        self.g_k = f32(36.0); self.e_k = f32(-77.0)
        self.g_kleak = f32(0.3); self.e_kleak = f32(-55.0)
        for k, v in kw.items():
            setattr(self, k, f32(v))
        self.m = Gate(); self.h = Gate(); self.n = Gate()
        self.i_na = f32(0.0); self.i_k = f32(0.0); self.i_kleak = f32(0.0)
        self.was_increasing = False
        self.init_synapses()

    def update_gates(self):
        v = self.v
        self.m.alpha = f32(0.1) * ((v + f32(40.0)) / (f32(1.0) - np.exp(-(v + f32(40.0)) / f32(10.0), dtype=f32)))
        self.m.beta = f32(4.0) * np.exp(-(v + f32(65.0)) / f32(18.0), dtype=f32)
        self.h.alpha = f32(0.07) * np.exp(-(v + f32(65.0)) / f32(20.0), dtype=f32)
        self.h.beta = f32(1.0) / (np.exp(-(v + f32(35.0)) / f32(10.0), dtype=f32) + f32(1.0))
        self.m.update(self.dt)
        self.h.update(self.dt)
        self.i_na = self.m.state ** 3 * self.h.state * self.g_na * (v - self.e_na)
        self.n.alpha = f32(0.01) * (v + f32(55.0)) / (f32(1.0) - np.exp(-(v + f32(55.0)) / f32(10.0), dtype=f32))
        self.n.beta = f32(0.125) * np.exp(-(v + f32(65.0)) / f32(80.0), dtype=f32)
        self.n.update(self.dt)
        self.i_k = self.n.state ** 4 * self.g_k * (v - self.e_k)
        self.i_kleak = self.g_kleak * (v - self.e_kleak)

    def _advance(self, i):
        last_v = self.v
        self.update_gates()
        i_ligand = self.receptors.get_currents(self.dt, self.c_m)
        i_sum = f32(i) - (self.i_na + self.i_k + self.i_kleak)
        self.v = self.v + self.dt * i_sum / self.c_m - i_ligand
        self.nts.apply_t_changes(self.v, self.is_spiking, self.dt)
        increasing = last_v < self.v
        spiking = bool(self.v > self.v_th) and self.was_increasing and not increasing
        self.was_increasing = bool(increasing)
        self.is_spiking = spiking
        return spiking

    def iterate_and_spike(self, i):
        return self._advance(i)

    def iterate_with_neurotransmitter_and_spike(self, i, t_total):
        self.receptors.update_kinetics(t_total, self.dt)
        self.receptors.set_currents(self.v)
        return self._advance(i)


class RefMorrisLecar(RefNeuronBase):
    """morris_lecar/mod.rs:19-139 + ion_channels/mod.rs:321-452."""

    nt_kind = "destexhe"
    rec_kind = "destexhe"

    def __init__(self, **kw):
        self.v = f32(-70.0); self.v_th = f32(25.0); self.gap_conductance = f32(10.0)
        self.c_m = f32(6.6); self.dt = f32(0.01)
        self.g_ca = f32(4.0); self.v_ca = f32(120.0); self.v_1 = f32(-1.2); self.v_2 = f32(18.0)
        self.g_k = f32(8.0); self.v_k = f32(-84.0); self.phi = f32(0.067)
        self.v_3 = f32(12.0); self.v_4 = f32(17.4)
        self.g_l = f32(2.0); self.v_l = f32(-60.0)
        for k, v in kw.items():
            setattr(self, k, f32(v))
        self.n = f32(0.0)
        self.i_ca = f32(0.0); self.i_k = f32(0.0); self.i_l = f32(0.0)
        self.was_increasing = False
        self.init_synapses()

    def update_channels(self):
        v = self.v
        m_ss = f32(0.5) * (f32(1.0) + np.tanh((v - self.v_1) / self.v_2, dtype=f32))
        self.i_ca = self.g_ca * m_ss * (v - self.v_ca)
        n_ss = f32(0.5) * (f32(1.0) + np.tanh((v - self.v_3) / self.v_4, dtype=f32))
        t_n = f32(1.0) / (self.phi * np.cosh((v - self.v_3) / (f32(2.0) * self.v_4), dtype=f32))
        self.n = self.n + ((n_ss - self.n) / t_n) * self.dt
        self.i_k = self.g_k * self.n * (v - self.v_k)
        self.i_l = self.g_l * (v - self.v_l)

    def _advance(self, i, rec_dv):
        self.update_channels()
        last_v = self.v
        dv = (f32(i) - self.i_l - self.i_ca - self.i_k) * (self.dt / self.c_m)
        self.v = self.v + dv + rec_dv
        self.nts.apply_t_changes(self.v, self.is_spiking, self.dt)
        increasing = last_v < self.v
        spiking = bool(self.v > self.v_th) and self.was_increasing and not increasing
        self.was_increasing = bool(increasing)
        self.is_spiking = spiking
        return spiking

    def iterate_and_spike(self, i):
        return self._advance(i, f32(0.0))

    def iterate_with_neurotransmitter_and_spike(self, i, t_total):
        self.receptors.update_kinetics(t_total, self.dt)
        self.receptors.set_currents(self.v)
        rec_dv = -self.receptors.get_currents(self.dt, self.c_m)
        return self._advance(i, rec_dv)


# --------------------------------------------------------------------------
# Scalar lattice simulator (two-phase step, neuron/mod.rs:1035-1088)
# --------------------------------------------------------------------------

def gap_junction(pre, post):
    return post.gap_conductance * (pre.v - post.v)


def run_ref_lattice(neurons, weights, iterations, electrical=True,
                    chemical=False, stdp=None, do_plasticity=False):
    """Simulate a flat list of scalar neurons with dense (N, N) weights
    (None = no edge).  Returns (voltage history [T, N], weights)."""
    n = len(neurons)
    weights = [row[:] for row in weights]
    history = []
    clock = 0
    for _ in range(iterations):
        # Phase A — inputs from previous state
        elec_inputs = [f32(0.0)] * n
        chem_inputs = [dict() for _ in range(n)]
        for j in range(n):
            in_idx = [i for i in range(n) if weights[i][j] is not None]
            if electrical:
                total = f32(0.0)
                for i in in_idx:
                    total = total + gap_junction(neurons[i], neurons[j]) * f32(weights[i][j])
                total = total / f32(max(len(in_idx), 1))
                elec_inputs[j] = total
            if chemical:
                maps = [weight_concentrations(neurons[i].get_concentrations(),
                                              weights[i][j]) for i in in_idx]
                chem_inputs[j] = aggregate_concentrations(maps)
        # Phase B — update all neurons
        spikes = [False] * n
        for j in range(n):
            if chemical:
                s = neurons[j].iterate_with_neurotransmitter_and_spike(
                    elec_inputs[j], chem_inputs[j])
            else:
                s = neurons[j].iterate_and_spike(elec_inputs[j])
            if s:
                neurons[j].last_firing_time = clock
            spikes[j] = s
        # deferred plasticity, network-style (neuron/mod.rs:2425-2461)
        if do_plasticity and stdp is not None:
            updates = []
            for j in range(n):
                if spikes[j]:
                    for i in range(n):
                        if weights[i][j] is not None:
                            updates.append((i, j))
                    for k in range(n):
                        if weights[j][k] is not None:
                            updates.append((j, k))
            for (i, j) in updates:
                weights[i][j] = f32(weights[i][j] + stdp_dw(stdp, neurons[i], neurons[j]))
        clock += 1
        history.append([nr.v for nr in neurons])
    return np.asarray(history, f32), weights


def stdp_dw(stdp, pre, post):
    """plasticity/mod.rs:46-65."""
    if pre.last_firing_time is None or post.last_firing_time is None:
        return f32(0.0)
    t_pre, t_post = f32(pre.last_firing_time), f32(post.last_firing_time)
    if t_pre < t_post:
        return f32(stdp["a_plus"]) * np.exp(
            f32(-1.0) * abs((t_pre - t_post) * f32(stdp["dt"])) / f32(stdp["tau_plus"]), dtype=f32)
    if t_pre > t_post:
        return f32(-1.0) * f32(stdp["a_minus"]) * np.exp(
            f32(-1.0) * abs((t_post - t_pre) * f32(stdp["dt"])) / f32(stdp["tau_minus"]), dtype=f32)
    return f32(0.0)


# --------------------------------------------------------------------------
# Spike trains (spike_train/mod.rs) and the network simulator
# --------------------------------------------------------------------------

class RefRateSpikeTrain:
    """spike_train/mod.rs:974-1033 (deterministic => usable for golden tests)."""

    def __init__(self, rate=0.0, v_th=30.0, v_resting=0.0, dt=0.1, k=10000.0,
                 nt_kinds=(), nt="approximate"):
        self.rate = f32(rate)
        self.v = f32(0.0)
        self.v_th = f32(v_th)
        self.v_resting = f32(v_resting)
        self.step_acc = f32(0.0)
        self.dt = f32(dt)
        self.k = f32(k)
        self.is_spiking = False
        self.last_firing_time = NEVER
        self.nts = NTSet(nt_kinds, nt)

    def iterate(self):
        self.step_acc = self.step_acc + self.dt
        if self.rate != 0.0 and self.step_acc >= self.rate:
            self.step_acc = f32(0.0)
            self.v = self.v_th
            self.is_spiking = True
        else:
            self.v = self.v_resting
            self.is_spiking = False
        self.nts.apply_t_changes(self.v, self.is_spiking, self.dt)
        return self.is_spiking

    def get_concentrations(self):
        return self.nts.concentrations()

    def effect(self, timestep):
        """spike_train_gap_junction source term (neuron/mod.rs:119-137) with
        DeltaDiracRefractoriness (spike_train/mod.rs:84-86)."""
        if self.last_firing_time is NEVER:
            return self.v_resting
        a = self.v_th - self.v_resting
        td = f32(timestep - self.last_firing_time)
        return a * np.exp((f32(-1.0) / (self.k / self.dt)) * td * td,
                          dtype=f32) + self.v_resting


def run_ref_network(neurons, spike_trains, weights, iterations,
                    electrical=True, chemical=False, stdp=None,
                    do_plasticity=False):
    """Scalar network sim: `neurons` list (flat), `spike_trains` list (flat,
    global index = len(neurons) + k), `weights` (N+S, N) dense with None.
    Mirrors LatticeNetwork::iterate_with_neurotransmission
    (neuron/mod.rs:2420-2479)."""
    n = len(neurons)
    m = n + len(spike_trains)
    weights = [row[:] for row in weights]
    clock = 0
    history = []
    for _ in range(iterations):
        elec_inputs = [f32(0.0)] * n
        chem_inputs = [dict() for _ in range(n)]
        for j in range(n):
            in_idx = [i for i in range(m) if weights[i][j] is not None]
            if electrical:
                total = f32(0.0)
                for i in in_idx:
                    if i < n:
                        val = gap_junction(neurons[i], neurons[j])
                    else:
                        val = neurons[j].gap_conductance * \
                            spike_trains[i - n].effect(clock)
                    total = total + val * f32(weights[i][j])
                elec_inputs[j] = total / f32(max(len(in_idx), 1))
            if chemical:
                maps = []
                for i in in_idx:
                    src = neurons[i] if i < n else spike_trains[i - n]
                    maps.append(weight_concentrations(
                        src.get_concentrations(), weights[i][j]))
                chem_inputs[j] = aggregate_concentrations(maps)
        spikes = [False] * n
        for j in range(n):
            if chemical:
                s = neurons[j].iterate_with_neurotransmitter_and_spike(
                    elec_inputs[j], chem_inputs[j])
            else:
                s = neurons[j].iterate_and_spike(elec_inputs[j])
            if s:
                neurons[j].last_firing_time = clock
            spikes[j] = s
        if do_plasticity and stdp is not None:
            updates = []
            for j in range(n):
                if spikes[j]:
                    for i in range(m):
                        if weights[i][j] is not None:
                            updates.append((i, j))
                    for k2 in range(n):
                        if weights[j][k2] is not None:
                            updates.append((j, k2))
            for (i, j) in updates:
                pre = neurons[i] if i < n else spike_trains[i - n]
                weights[i][j] = f32(weights[i][j] + stdp_dw(stdp, pre, neurons[j]))
        clock += 1
        for st in spike_trains:
            if st.iterate():
                st.last_firing_time = clock - 1
        history.append([nr.v for nr in neurons])
    return np.asarray(history, f32), weights


# --------------------------------------------------------------------------
# R-STDP (plasticity/mod.rs:115-242) scalar reference
# --------------------------------------------------------------------------

class TraceW:
    """TraceRSTDP weight (plasticity/mod.rs:122-150)."""

    def __init__(self, w):
        self.w = f32(w)
        self.c = f32(0.0)
        self.dw = f32(0.0)
        self.counter = 0


def rstdp_visit_scalar(tw, delta, dopamine, p):
    """One RewardModulatedSTDP::update_weight visit (plasticity/mod.rs:208-237)."""
    tw.dw = f32(tw.dw + delta)
    if tw.counter == 0:
        tw.counter = 1
    else:
        tw.c = f32(tw.c * np.exp(-f32(p["dt"]) / f32(p["tau_c"]), dtype=f32)
                   + f32(p["tau_c"]) * tw.dw)
        tw.counter = 0
        tw.dw = f32(0.0)
    tw.w = f32(tw.w + tw.c * f32(dopamine))


def run_ref_rstdp_lattice(neurons, weights, rewards, p,
                          electrical=True, do_modulation=True):
    """Scalar RewardModulatedLattice run (neuron/mod.rs:3190-3260 semantics,
    deferred visit order)."""
    n = len(neurons)
    dopamine = f32(0.0)
    history = []
    clock = 0
    for reward in rewards:
        elec_inputs = [f32(0.0)] * n
        for j in range(n):
            in_idx = [i for i in range(n) if weights[i][j] is not None]
            if electrical:
                total = f32(0.0)
                for i in in_idx:
                    total = total + gap_junction(neurons[i], neurons[j]) \
                        * weights[i][j].w
                elec_inputs[j] = total / f32(max(len(in_idx), 1))
        dopamine = f32(dopamine * np.exp(-f32(p["dt"]) / f32(p["tau_d"]), dtype=f32)
                       + f32(p["tau_d"]) * f32(reward))
        for j in range(n):
            if neurons[j].iterate_and_spike(elec_inputs[j]):
                neurons[j].last_firing_time = clock
        if do_modulation:
            for i in range(n):
                for j in range(n):
                    if weights[i][j] is not None:
                        delta = stdp_dw(p, neurons[i], neurons[j])
                        rstdp_visit_scalar(weights[i][j], delta, dopamine, p)
                        rstdp_visit_scalar(weights[i][j], delta, dopamine, p)
        clock += 1
        history.append([nr.v for nr in neurons])
    return np.asarray(history, f32), weights, dopamine


class RefBCMIzhikevich(RefIzhikevich):
    """integrate_and_fire/mod.rs:1360-1520 (electrical-path normalization)."""

    def __init__(self, **kw):
        self.average_activity = f32(0.0)
        self.current_activity = f32(0.0)
        self.period = 3
        self.num_spikes = 0
        self.firing_rate_clock = f32(0.0)
        self.firing_rate_window = f32(500.0)
        super().__init__(**kw)

    def _bookkeep(self):
        if self.is_spiking:
            self.num_spikes += 1
        self.firing_rate_clock = f32(self.firing_rate_clock + self.dt)
        if self.firing_rate_clock >= self.firing_rate_window:
            self.firing_rate_clock = f32(0.0)
            self.current_activity = f32(
                self.num_spikes / (self.firing_rate_window * self.dt))
            self.average_activity = f32(
                self.average_activity - self.average_activity / f32(self.period))
            self.average_activity = f32(
                self.average_activity + self.current_activity / f32(self.period))

    def iterate_and_spike(self, i):
        self._bookkeep()
        return super().iterate_and_spike(i)


def bcm_dw(p, w, pre, post):
    """plasticity/mod.rs:102-107."""
    thresh = post.average_activity / f32(p["average_scalar"])
    term = post.current_activity * (post.current_activity - thresh)
    return f32((term * pre.current_activity - f32(p["decay"]) * w) * f32(p["dt"]))


def run_ref_lattice_bcm(neurons, weights, iterations, p):
    """Electrical lattice with deferred BCM plasticity."""
    n = len(neurons)
    weights = [row[:] for row in weights]
    history = []
    clock = 0
    for _ in range(iterations):
        elec = [f32(0.0)] * n
        for j in range(n):
            in_idx = [i for i in range(n) if weights[i][j] is not None]
            total = f32(0.0)
            for i in in_idx:
                total = total + gap_junction(neurons[i], neurons[j]) * f32(weights[i][j])
            elec[j] = total / f32(max(len(in_idx), 1))
        spikes = []
        for j in range(n):
            s = neurons[j].iterate_and_spike(elec[j])
            if s:
                neurons[j].last_firing_time = clock
            spikes.append(s)
        updates = []
        for j in range(n):
            if spikes[j]:
                for i in range(n):
                    if weights[i][j] is not None:
                        updates.append((i, j))
                for k in range(n):
                    if weights[j][k] is not None:
                        updates.append((j, k))
        for (i, j) in updates:
            weights[i][j] = f32(weights[i][j]
                                + bcm_dw(p, weights[i][j], neurons[i], neurons[j]))
        clock += 1
        history.append([nr.v for nr in neurons])
    return np.asarray(history, f32), weights


def run_ref_discrete_hopfield(weights, state, sweeps):
    """Sequential sign updates of a bipolar discrete-neuron lattice in
    row-major order (`DiscreteNeuronLattice::iterate`,
    attractors/mod.rs:443-461; `DiscreteNeuron::update` :280-285): node i
    becomes +1 when sum_j w[j][i] * s_j > 0, else -1, and later nodes see
    the updated value."""
    w = np.asarray(weights, np.float64)
    s = np.asarray(state, np.float64).copy()
    for _ in range(sweeps):
        for i in range(s.shape[0]):
            s[i] = 1.0 if float(s @ w[:, i]) > 0.0 else -1.0
    return s.astype(f32)
