"""Compile parsed `.nb` blocks into vectorized JAX model classes.

JAX equivalent of the `neuron_builder!` codegen
(`reference/build_test/nb_macro/src/lib.rs`): where the reference
emits Rust structs + OpenCL kernel strings + PyO3 classes from one model
definition, here the definition compiles to a :class:`NeuronModel` /
:class:`SpikeTrainModel` subclass whose step function traces straight into
the jitted lattice scan — the "kernel" is XLA's output.

Semantics preserved from the codegen (nb_macro/src/lib.rs:106-260,
2255-2360):

* ``v`` -> membrane potential, ``i`` -> input current; injected defaults
  current_voltage=0, dt=0.1, c_m=1, gap_conductance=10 (:2201-2210).
* ``dX/dt = expr`` computes ``dX = expr * dt`` in statement order and applies
  all deltas after the statement list (:195, :678-699).
* ``r^`` is the clipped power ``max(x, 0) ^ p`` (:136).
* electrochemical template: receptor kinetics update -> receptor currents
  from pre-update v -> on_iteration -> ``v -= get_receptor_currents`` ->
  neurotransmitter update -> spike handling (:2321-2356).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import parser as P
from ..models.base import NeuronModel
from ..models.spike_train import SpikeTrainModel, REFRACTORINESS
from ..ops import kinetics as K
from ..ops.receptors import ReceptorSystem

FUNCTIONS = {
    "exp": jnp.exp, "ln": jnp.log, "log": jnp.log, "log10": jnp.log10,
    "sqrt": jnp.sqrt, "abs": jnp.abs, "tanh": jnp.tanh, "sinh": jnp.sinh,
    "cosh": jnp.cosh, "sin": jnp.sin, "cos": jnp.cos,
    "min": jnp.minimum, "max": jnp.maximum, "tan": jnp.tan,
    "floor": jnp.floor, "ceil": jnp.ceil,
    "heaviside": lambda x: (x > 0).astype(jnp.float32),
}


def eval_expr(expr, env):
    if isinstance(expr, P.Num):
        return jnp.float32(expr.value)
    if isinstance(expr, P.Var):
        name = expr.name
        if name == "true":
            return True
        if name == "false":
            return False
        if name not in env:
            raise NameError(f"unknown variable {name!r} in DSL expression")
        return env[name]
    if isinstance(expr, P.Unary):
        val = eval_expr(expr.operand, env)
        if expr.op == "-":
            return -val
        return jnp.logical_not(val)
    if isinstance(expr, P.BinOp):
        a = eval_expr(expr.left, env)
        b = eval_expr(expr.right, env)
        op = expr.op
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "^":
            return a ** b
        if op == "r^":  # clipped power (nb_macro/src/lib.rs:136)
            return jnp.maximum(a, 0.0) ** b
        if op == "==":
            return a == b
        if op == "!=":
            return a != b
        if op == "<":
            return a < b
        if op == ">":
            return a > b
        if op == "<=":
            return a <= b
        if op == ">=":
            return a >= b
        if op == "&&":
            return jnp.logical_and(a, b)
        if op == "||":
            return jnp.logical_or(a, b)
    if isinstance(expr, P.Call):
        ufn = env.get("__userfns__", {}).get(expr.name)
        if ufn is not None:
            # user `f(x, y) = expr` declaration: evaluate its body with the
            # parameters bound over the current env (free variables resolve
            # to model state, like the generated Rust local fn)
            params, body = ufn
            if len(params) != len(expr.args):
                raise TypeError(
                    f"DSL function {expr.name!r} takes {len(params)} args,"
                    f" got {len(expr.args)}")
            call_env = dict(env)
            for prm, arg in zip(params, expr.args):
                call_env[prm] = eval_expr(arg, env)
            return eval_expr(body, call_env)
        fn = FUNCTIONS.get(expr.name)
        if fn is not None:
            return fn(*[eval_expr(a, env) for a in expr.args])
        # struct calls in expression position, e.g.
        # `receptors.get_receptor_currents(dt, c_m)` — resolved through the
        # env's function table (nb_macro/src/lib.rs struct-call codegen)
        efn = env.get("__fns__", {}).get(expr.name)
        if efn is None:
            raise NameError(f"unknown DSL function {expr.name!r}")
        return efn(env, [eval_expr(a, env) for a in expr.args])
    raise TypeError(f"cannot evaluate {expr!r}")


def run_statements(stmts, env, mask=None, methods=None):
    """Execute a statement list on ``env`` (dict name -> array).

    DiffEq deltas are accumulated and applied after the list (matching the
    codegen's deferred `self.X += dX`).  ``mask`` (bool array or None)
    conditions every write — used for [if] branches, vectorized with
    `jnp.where` instead of control flow.  ``methods`` resolves struct calls
    (`l.update_current(v)`): dict path -> fn(env, arg_values) mutating env.
    """
    env = dict(env)
    deltas = {}

    def write(name, value):
        if mask is not None and name in env:
            # jnp.where broadcasts in BOTH directions (a scalar-initialized
            # temp can be overwritten by an (N,) value inside an [if])
            env[name] = jnp.where(mask, value, env[name])
        else:
            env[name] = value

    for stmt in stmts:
        if isinstance(stmt, P.FuncDef):
            fns = dict(env.get("__userfns__", {}))
            fns[stmt.name] = (stmt.params, stmt.expr)
            env["__userfns__"] = fns
        elif isinstance(stmt, P.Assign):
            write(stmt.target, eval_expr(stmt.expr, env))
        elif isinstance(stmt, P.DiffEq):
            delta = eval_expr(stmt.expr, env) * env["dt"]
            if mask is not None:
                delta = jnp.where(mask, delta, 0.0)
            deltas[stmt.target] = deltas.get(stmt.target, 0.0) + delta
        elif isinstance(stmt, P.MethodCall):
            if methods is None or stmt.path not in methods:
                raise NameError(f"unknown struct call {stmt.path!r}")
            methods[stmt.path](env, [eval_expr(a, env) for a in stmt.args])
        elif isinstance(stmt, P.If):
            taken = None
            for cond_expr, body in zip(stmt.conditions, stmt.bodies):
                cond = eval_expr(cond_expr, env)
                branch = cond if taken is None \
                    else jnp.logical_and(cond, jnp.logical_not(taken))
                branch_mask = branch if mask is None \
                    else jnp.logical_and(branch, mask)
                sub_env, sub_deltas = run_statements(body, env, branch_mask,
                                                     methods)
                env.update(sub_env)
                for k, v in sub_deltas.items():
                    deltas[k] = deltas.get(k, 0.0) + v
                taken = branch if taken is None else jnp.logical_or(taken, branch)
            if stmt.else_body:
                else_mask = jnp.logical_not(taken)
                if mask is not None:
                    else_mask = jnp.logical_and(else_mask, mask)
                sub_env, sub_deltas = run_statements(stmt.else_body, env,
                                                     else_mask, methods)
                env.update(sub_env)
                for k, v in sub_deltas.items():
                    deltas[k] = deltas.get(k, 0.0) + v
        else:
            raise TypeError(f"unknown statement {stmt!r}")
    return env, deltas


def _apply_deltas(env, deltas):
    for k, v in deltas.items():
        env[k] = env[k] + v
    return env


# ---------------------------------------------------------------------------
# Neuron compilation
# ---------------------------------------------------------------------------

NEURON_RESERVED = {"v", "i", "dt", "is_spiking", "last_firing_time"}


def build_neuron(block, registry):
    """Compile a [neuron] block into a NeuronModel subclass."""
    fields = dict(block.vars)
    # injected defaults (nb_macro/src/lib.rs:2149-2210); `v` stored as 'v'
    fields.setdefault("v", block.vars.get("current_voltage", 0.0))
    fields.pop("current_voltage", None)
    fields.setdefault("dt", 0.1)
    fields.setdefault("c_m", 1.0)
    fields.setdefault("gap_conductance", 10.0)

    on_iteration = block.sections.get("on_iteration", [])
    on_electrochemical = block.sections.get("on_electrochemical_iteration")
    on_spike = block.sections.get("on_spike", [])
    spike_detection = block.sections.get("spike_detection")
    if spike_detection is None:
        raise SyntaxError(f"[neuron] {block.type_name} needs spike_detection")
    # `spike_detection: continuous()` — HH/Morris-Lecar peak detection
    # (pest grammar's continuous marker; hodgkin_huxley/mod.rs:207-218):
    # spike when above v_th, was increasing, and just stopped increasing.
    from .parser import Call as _Call
    continuous = (isinstance(spike_detection, _Call)
                  and spike_detection.name == "continuous"
                  and not spike_detection.args)
    if continuous:
        fields.setdefault("v_th", 30.0)

    kinetics_spec = block.sections.get("kinetics", "")
    nt_kind, rec_kind = "approximate", "approximate"
    if kinetics_spec:
        parts = [p.strip() for p in kinetics_spec.split(",")]
        if len(parts) >= 1 and parts[0]:
            nt_kind = registry.get(parts[0], parts[0])
        if len(parts) >= 2:
            rec_kind = registry.get(parts[1], parts[1])
    receptors_spec = block.sections.get("receptors", "")
    receptor_factory = registry.get(("receptors", receptors_spec)) \
        if receptors_spec else None

    # ion_channels: l = TestLeak, k = KChan (nb_macro lib.rs:2172-2196)
    channels = {}
    chan_spec = block.sections.get("ion_channels", "")
    if chan_spec:
        for part in chan_spec.split(","):
            alias, type_name = [x.strip() for x in part.split("=")]
            chan = registry.get(("ion_channel", type_name))
            if chan is None:
                raise NameError(f"unknown ion channel type {type_name!r}")
            channels[alias] = chan
            fields.update(chan.field_defaults(alias))

    class GeneratedNeuron(NeuronModel):
        name = block.type_name
        FIELDS = fields
        BOOL_FIELDS = dict(was_increasing=False) if continuous else {}

        def __init__(self, nt_kinetics=nt_kind, rec_kinetics=rec_kind,
                     receptors=None):
            if receptors is None and receptor_factory is not None:
                receptors = receptor_factory(rec_kinetics)
            super().__init__(nt_kinetics=nt_kinetics,
                             rec_kinetics=rec_kinetics, receptors=receptors)

        def _env(self, s, i):
            env = {k: v for k, v in s.items()}
            env["i"] = i
            # dotted views of ion-channel fields
            for alias, chan in channels.items():
                for dotted, key in chan.env_keys(alias):
                    env[dotted] = s[key]
            return env

        def _writeback(self, s, env):
            s.update({k: v for k, v in env.items() if k in s})
            for alias, chan in channels.items():
                for dotted, key in chan.env_keys(alias):
                    s[key] = env[dotted]
            return s

        def _methods(self, env):
            methods = {}
            for alias, chan in channels.items():
                def call(e, args, alias=alias, chan=chan):
                    v = args[0] if args else e["v"]
                    dt = args[1] if len(args) > 1 else e["dt"]
                    chan.update_current(e, alias, v, dt)
                methods[f"{alias}.update_current"] = call
            return methods

        def _run_electrochemical(self, s, i, t_input, t_valid):
            env = self._env(s, i)
            env["t"] = 0.0   # placeholder so `...(t, dt)` args evaluate
            methods = self._methods(env)

            def upd_kinetics(e, args):
                e.update(self.receptors.update_kinetics(e, t_input, t_valid))

            def set_currents(e, args):
                v = args[0] if args else e["v"]
                e.update(self.receptors.set_currents(e, v))

            def apply_t(e, args):
                if "nt$t" in e:
                    e["nt$t"] = K.apply_t_changes(
                        self.nt_kinetics, e, e["v"], e["is_spiking"])

            methods["receptors.update_receptor_kinetics"] = upd_kinetics
            methods["receptors.set_receptor_currents"] = set_currents
            methods["synaptic_neurotransmitters.apply_t_changes"] = apply_t
            env["__fns__"] = {
                "receptors.get_receptor_currents":
                    lambda e, args: self.receptors.receptor_dv(e),
            }
            env, deltas = run_statements(on_electrochemical, env,
                                         methods=methods)
            for k in ("i", "t", "__fns__"):
                env.pop(k, None)
            s = self._writeback(s, env)
            return _apply_deltas(s, deltas)

        def step(self, s, i, t_input=None, t_valid=None, skip_nt=False):
            s = dict(s)
            last_voltage = s["v"]
            if t_input is not None and on_electrochemical is not None:
                # custom electrochemical body replaces the default template
                # (nb_macro neuron_receptor_integration.rs idiom: explicit
                # receptors.update_receptor_kinetics / set_receptor_currents /
                # get_receptor_currents / synaptic_neurotransmitters.
                # apply_t_changes calls inside the statement list)
                s = self._run_electrochemical(s, i, t_input, t_valid)
            else:
                if t_input is not None:
                    s.update(self.receptors.update_kinetics(
                        s, t_input, t_valid))
                    s.update(self.receptors.set_currents(s, s["v"]))
                    rec_dv = self.receptors.receptor_dv(s)
                else:
                    rec_dv = 0.0

                env = self._env(s, i)
                env, deltas = run_statements(on_iteration, env,
                                             methods=self._methods(env))
                env.pop("i", None)
                s = self._writeback(s, env)
                s = _apply_deltas(s, deltas)
                s["v"] = s["v"] - rec_dv

                if not skip_nt:
                    s["nt$t"] = K.apply_t_changes(
                        self.nt_kinetics, s, s["v"], s["is_spiking"])

            if continuous:
                s, spikes = self._handle_peak_detection(s, last_voltage)
            else:
                spikes = eval_expr(spike_detection, self._env(s, 0.0))
            if on_spike:
                env = self._env(s, 0.0)
                env, deltas2 = run_statements(on_spike, env, mask=spikes,
                                              methods=self._methods(env))
                env.pop("i", None)
                s = self._writeback(s, env)
                s = _apply_deltas(s, deltas2)
            s["is_spiking"] = spikes
            return s, spikes

    GeneratedNeuron.__name__ = block.type_name
    return GeneratedNeuron


def build_spike_train(block, registry):
    """Compile a [spike_train] block into a SpikeTrainModel subclass.

    Injected fields (nb_macro/src/lib.rs:4831-4850): current_voltage=0,
    v_th=30, v_resting=0, dt=0.1.
    """
    fields = dict(block.vars)
    fields.setdefault("v_th", 30.0)
    fields.setdefault("v_resting", 0.0)
    on_iteration = block.sections.get("on_iteration", [])
    kinetics_spec = block.sections.get("kinetics", "").strip()
    nt_kind = registry.get(kinetics_spec, kinetics_spec) if kinetics_spec \
        else "approximate"

    class GeneratedSpikeTrain(SpikeTrainModel):
        name = block.type_name
        FIELDS = {k: v for k, v in fields.items()}

        def __init__(self, nt_kinetics=nt_kind, refractoriness="delta_dirac"):
            super().__init__(nt_kinetics=nt_kinetics,
                             refractoriness=refractoriness)

        def step(self, s, key, clock):
            s = dict(s)
            env = dict(s)
            env["current_voltage"] = env.pop("v")
            env, deltas = run_statements(on_iteration, env)
            env = _apply_deltas(env, deltas)
            env["v"] = env.pop("current_voltage")
            s.update({k: v for k, v in env.items() if k in s})
            s["is_spiking"] = jnp.asarray(s["is_spiking"], bool)
            spikes = s["is_spiking"]
            s["nt$t"] = K.apply_t_changes(self.nt_kinetics, s, s["v"], spikes)
            return s, spikes, key

    GeneratedSpikeTrain.__name__ = block.type_name
    return GeneratedSpikeTrain


class IonChannelDef:
    """Compiled [ion_channel] block (nb_macro IonChannelDefinition,
    lib.rs:3959): per-channel vars (+ implicit `current` = 0), optional
    gating variables (BasicGatingVariable: alpha/beta/state with the Euler
    `update(dt)` rule, ion_channels/mod.rs:33-45), and an update_current
    body."""

    def __init__(self, block):
        self.type_name = block.type_name
        self.vars = dict(block.vars)
        self.vars.setdefault("current", 0.0)
        gating = block.sections.get("gating_vars", "")
        self.gating = [g.strip() for g in gating.split(",") if g.strip()]
        self.stmts = block.sections.get("on_iteration", [])
        self.uses_dt = "dt" in _names_in(self.stmts)

    def field_defaults(self, alias):
        out = {f"{alias}${v}": d for v, d in self.vars.items()}
        for g in self.gating:
            for attr in ("alpha", "beta", "state"):
                out[f"{alias}${g}${attr}"] = 0.0
        return out

    def env_keys(self, alias):
        """(dotted env name, state key) pairs for a channel instance."""
        pairs = [(f"{alias}.{v}", f"{alias}${v}") for v in self.vars]
        for g in self.gating:
            for attr in ("alpha", "beta", "state"):
                pairs.append((f"{alias}.{g}.{attr}", f"{alias}${g}${attr}"))
        return pairs

    def update_current(self, env, alias, v, dt):
        """Run the channel body in the neuron env (dotted keys)."""
        sub = {v_name: env[f"{alias}.{v_name}"] for v_name in self.vars}
        for g in self.gating:
            for attr in ("alpha", "beta", "state"):
                sub[f"{g}.{attr}"] = env[f"{alias}.{g}.{attr}"]
        sub["v"] = v
        sub["current_voltage"] = v
        sub["dt"] = dt

        methods = {}
        for g in self.gating:
            def gate_update(e, args, g=g):
                # BasicGatingVariable::update (ion_channels/mod.rs:40-44)
                d = args[0] if args else e["dt"]
                a, b, st = e[f"{g}.alpha"], e[f"{g}.beta"], e[f"{g}.state"]
                e[f"{g}.state"] = st + d * (a * (1.0 - st) - b * st)
            def gate_init(e, args, g=g):
                # BasicGatingVariable::init_state (ion_channels/mod.rs:35-37)
                a, b = e[f"{g}.alpha"], e[f"{g}.beta"]
                e[f"{g}.state"] = a / (a + b)
            methods[f"{g}.update"] = gate_update
            methods[f"{g}.init_state"] = gate_init

        sub, deltas = run_statements(self.stmts, sub, methods=methods)
        sub = _apply_deltas(sub, deltas)
        for v_name in self.vars:
            env[f"{alias}.{v_name}"] = sub[v_name]
        for g in self.gating:
            for attr in ("alpha", "beta", "state"):
                env[f"{alias}.{g}.{attr}"] = sub[f"{g}.{attr}"]


def _names_in(stmts):
    names = set()

    def walk_expr(e):
        if isinstance(e, P.Var):
            names.add(e.name)
        elif isinstance(e, P.Unary):
            walk_expr(e.operand)
        elif isinstance(e, P.BinOp):
            walk_expr(e.left)
            walk_expr(e.right)
        elif isinstance(e, P.Call):
            for a in e.args:
                walk_expr(a)

    def walk(sts):
        for st in sts:
            if isinstance(st, (P.Assign, P.DiffEq, P.FuncDef)):
                walk_expr(st.expr)
            elif isinstance(st, P.MethodCall):
                names.add(st.path.split(".")[-1])
                for a in st.args:
                    walk_expr(a)
            elif isinstance(st, P.If):
                for c in st.conditions:
                    walk_expr(c)
                for b in st.bodies:
                    walk(b)
                walk(st.else_body)

    walk(stmts)
    return names


def build_ion_channel(block, registry):
    chan = IonChannelDef(block)

    class GeneratedIonChannel:
        """Standalone channel usable like the generated Rust struct."""

        _def = chan

        def __init__(self, n=1, **overrides):
            self.n = n
            self.state = {}
            for k, d in chan.field_defaults("ch").items():
                self.state[k.split("$", 1)[1]] = jnp.full((n,), d, jnp.float32)
            for k, v in overrides.items():
                key = k.replace(".", "$")
                self.state[key] = jnp.full((n,), v, jnp.float32)

        def __getattr__(self, name):
            state = object.__getattribute__(self, "state")
            key = name.replace(".", "$")
            if key in state:
                arr = state[key]
                return float(arr[0]) if arr.shape == (1,) else arr
            raise AttributeError(name)

        def __setattr__(self, name, value):
            if name in ("n", "state"):
                object.__setattr__(self, name, value)
                return
            key = name.replace(".", "$")
            if key in self.state:
                self.state[key] = jnp.broadcast_to(
                    jnp.asarray(value, jnp.float32), self.state[key].shape)
            else:
                object.__setattr__(self, name, value)

        def set_gating(self, g, **attrs):
            for a, v in attrs.items():
                self.state[f"{g}${a}"] = jnp.full((self.n,), v, jnp.float32)

        def update_current(self, v, dt=0.1):
            env = {("ch." + k.replace("$", ".")): val
                   for k, val in self.state.items()}
            v = jnp.broadcast_to(jnp.asarray(v, jnp.float32), (self.n,))
            dt = jnp.broadcast_to(jnp.asarray(dt, jnp.float32), (self.n,))
            chan.update_current(env, "ch", v, dt)
            self.state = {k[len("ch."):].replace(".", "$"): val
                          for k, val in env.items()}
            return self.current

    GeneratedIonChannel.__name__ = block.type_name
    return chan, GeneratedIonChannel


def build_nt_kinetics(block):
    """Compile a [neurotransmitter_kinetics] block: registers a new kind in
    the kinetics registry operating on (N, K) arrays."""
    on_iteration = block.sections["on_iteration"]
    params = {f"nt${k}": v for k, v in block.vars.items() if k != "t"}

    def update(t, v, spiking, dt, state_params):
        env = {"t": t, "v": v[:, None] if v.ndim == 1 else v,
               "current_voltage": v[:, None] if v.ndim == 1 else v,
               "is_spiking": spiking[:, None] if spiking.ndim == 1 else spiking,
               "dt": dt[:, None] if dt.ndim == 1 else dt}
        for k in block.vars:
            if k != "t":
                env[k] = state_params[f"nt${k}"]
        env, deltas = run_statements(on_iteration, env)
        env = _apply_deltas(env, deltas)
        return env["t"]

    K.NT_KINETICS[block.type_name] = update
    K.NT_PARAM_DEFAULTS[block.type_name] = params
    return block.type_name


def build_receptor_kinetics(block):
    """Compile a [receptor_kinetics] block into the receptor-kinetics
    registry (operates on (N, K) gating arrays)."""
    on_iteration = block.sections["on_iteration"]
    params = {f"rec${k}": v for k, v in block.vars.items() if k != "r"}

    def update(r, t, dt, state_params):
        env = {"r": r, "t": t,
               "dt": dt[:, None] if dt.ndim == 1 else dt}
        for k in block.vars:
            if k != "r":
                env[k] = state_params[f"rec${k}"]
        env, deltas = run_statements(on_iteration, env)
        env = _apply_deltas(env, deltas)
        return env["r"]

    K.REC_KINETICS[block.type_name] = update
    K.REC_PARAM_DEFAULTS[block.type_name] = params
    return block.type_name


def build_refractoriness(block):
    """Compile a [neural_refractoriness] block (effect expression over
    timestep difference; spike_train/mod.rs:37-46 trait)."""
    effect_expr = block.sections["effect"]
    defaults = dict(block.vars)

    def effect(k, a, time_difference, v_resting, dt):
        # the grammar's effect scope exposes v_th/v_max alongside the
        # amplitude (caller passes a = v_th - v_resting,
        # spike_train/mod.rs:84-86 / delta_dirac_refractoriness.rs:9-12)
        env = {"decay": k, "k": k, "a": a, "time_difference": time_difference,
               "v_resting": v_resting, "dt": dt,
               "v_th": a + v_resting, "v_max": a + v_resting}
        env.update({name: jnp.float32(v) for name, v in defaults.items()
                    if name not in env})
        return eval_expr(effect_expr, env)

    REFRACTORINESS[block.type_name] = effect
    return block.type_name


def build_receptors(block, registry):
    """Compile a [receptors] block into a ReceptorSystem subclass with
    per-neurotransmitter groups (lixirnet DopaGluGABA-style)."""
    type_names = tuple(g["neurotransmitter"] for g in block.groups)
    top_vars = dict(block.vars)
    default_kinetics = registry.get(block.sections.get("kinetics", ""),
                                    block.sections.get("kinetics", "approximate"))

    class GeneratedReceptors(ReceptorSystem):
        pass

    GeneratedReceptors.type_names = type_names
    GeneratedReceptors.__name__ = block.type_name

    groups = block.groups

    def __init__(self, kinetics=default_kinetics or "approximate"):
        self.kinetics = kinetics

    def config_key(self):
        return (type(self), self.kinetics)

    def init_fields(self, n):
        # host-side NumPy construction (CLAUDE.md: eager per-field device
        # arrays are forbidden; models/base ships the dict in one pass)
        import numpy as np
        s = {"rec$mask": np.zeros((n, len(type_names)), bool),
             "rec$current": np.zeros((n, len(type_names)), np.float32)}
        for name, d in top_vars.items():
            s[f"rec${name}"] = np.full((n,), d, np.float32)
        max_slots = max(len(g["receptors"]) if g["receptors"] else 1
                        for g in groups)
        for slot in range(max_slots):
            key = "rec$r" if slot == 0 else f"rec$r{slot + 1}"
            s[key] = np.zeros((n, len(type_names)), np.float32)
        for f, d in K.REC_PARAM_DEFAULTS[self.kinetics].items():
            s[f] = np.full((n, len(type_names)), d, np.float32)
        for gi, g in enumerate(groups):
            for name, d in g["vars"].items():
                s[f"rec${g['neurotransmitter']}${name}"] = \
                    np.full((n,), d, np.float32)
        return s

    def update_kinetics(self, state, t_input, t_valid):
        out = {}
        max_slots = max(len(g["receptors"]) if g["receptors"] else 1
                        for g in groups)
        for slot in range(max_slots):
            key = "rec$r" if slot == 0 else f"rec$r{slot + 1}"
            sp = dict(state)
            sp["rec$r"] = state[key]
            out[key] = K.update_receptor_kinetics(
                self.kinetics, sp, t_input, t_valid)
        return out

    def set_currents(self, state, v):
        out = {}
        env = {"v": v, "current_voltage": v, "dt": state["dt"]}
        for name in top_vars:
            env[name] = state[f"rec${name}"]
        mask = state["rec$mask"]
        currents = []
        for gi, g in enumerate(groups):
            genv = dict(env)
            slot_names = g["receptors"] if g["receptors"] else ["r"]
            for slot, rname in enumerate(slot_names):
                key = "rec$r" if slot == 0 else f"rec$r{slot + 1}"
                genv[rname] = state[key][:, gi]
            if not g["receptors"]:
                genv["r"] = state["rec$r"][:, gi]
            for name in g["vars"]:
                genv[name] = state[f"rec${g['neurotransmitter']}${name}"]
            genv, deltas = run_statements(g["on_iteration"], genv)
            genv = _apply_deltas(genv, deltas)
            gmask = mask[:, gi]
            # write back group vars + shared top-level vars (masked)
            for name in g["vars"]:
                key = f"rec${g['neurotransmitter']}${name}"
                out[key] = jnp.where(gmask, genv[name], state[key])
            for name in top_vars:
                prev = out.get(f"rec${name}", state[f"rec${name}"])
                out[f"rec${name}"] = jnp.where(gmask, genv[name], prev)
                env[name] = out[f"rec${name}"]
            cur = genv.get("current")
            currents.append(jnp.where(gmask, cur, 0.0)
                            if cur is not None else jnp.zeros_like(v))
        out["rec$current"] = jnp.stack(currents, axis=-1)
        return out

    def receptor_dv(self, state):
        total = jnp.sum(state["rec$current"], axis=-1)
        return total * (state["dt"] / state["c_m"])

    GeneratedReceptors.__init__ = __init__
    GeneratedReceptors.config_key = config_key
    GeneratedReceptors.init_fields = init_fields
    GeneratedReceptors.update_kinetics = update_kinetics
    GeneratedReceptors.set_currents = set_currents
    GeneratedReceptors.receptor_dv = receptor_dv
    return GeneratedReceptors


def neuron_builder(source):
    """Compile `.nb` source; returns a dict of generated classes / kinds
    (the JAX equivalent of `neuron_builder!`, nb_macro/src/lib.rs:9303-9365)."""
    blocks = P.parse(source)
    # two definitions with one type name would be a Rust name collision in
    # the reference (nb_macro emits a struct per block); reject up front
    seen = set()
    for b in blocks:
        if b.type_name in seen:
            raise SyntaxError(f"duplicate definition: {b.type_name!r}")
        seen.add(b.type_name)
    out = {}
    registry = {}
    # kinetics first (neurons reference them by name)
    for b in blocks:
        if b.kind == "neurotransmitter_kinetics":
            kind = build_nt_kinetics(b)
            registry[b.type_name] = kind
            out[b.type_name] = kind
        elif b.kind == "receptor_kinetics":
            kind = build_receptor_kinetics(b)
            registry[b.type_name] = kind
            out[b.type_name] = kind
        elif b.kind == "neural_refractoriness":
            out[b.type_name] = build_refractoriness(b)
    for b in blocks:
        if b.kind == "ion_channel":
            chan, cls = build_ion_channel(b, registry)
            registry[("ion_channel", b.type_name)] = chan
            out[b.type_name] = cls
        elif b.kind == "receptors":
            cls = build_receptors(b, registry)
            registry[("receptors", b.type_name)] = cls
            out[b.type_name] = cls
    for b in blocks:
        if b.kind == "neuron":
            out[b.type_name] = build_neuron(b, registry)
        elif b.kind == "spike_train":
            out[b.type_name] = build_spike_train(b, registry)
    return out


def neuron_builder_from_file(path):
    """`neuron_builder_from_file!` equivalent."""
    with open(path) as f:
        return neuron_builder(f.read())
