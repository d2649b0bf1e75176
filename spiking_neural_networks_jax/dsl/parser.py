"""Parser for the `.nb` model-definition language.

JAX rebuild of the reference's `neuron_builder!` front end
(`reference/build_test/nb_macro/src/pest_ast/mod.rs` grammar;
`nb_macro/src/lib.rs` codegen): the same block language —

    [neuron] / [spike_train] / [neurotransmitter_kinetics] /
    [receptor_kinetics] / [neural_refractoriness] / [ion_channel]

with ``type:``, ``vars: x = default``, ``on_iteration:``, ``on_spike:``,
``spike_detection:``, ``effect:`` sections, ``dX/dt = ...`` Euler
derivatives, and ``[if] cond [then] ... [elseif] ... [else] ... [end]``
conditionals — parsed with a hand-written Pratt parser and compiled to
vectorized jnp expressions (instead of the reference's Rust+OpenCL+PyO3
codegen: here a *traced jit function* is the kernel).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# Expression AST
# ---------------------------------------------------------------------------

@dataclass
class Num:
    value: float


@dataclass
class Var:
    name: str


@dataclass
class Unary:
    op: str
    operand: object


@dataclass
class BinOp:
    op: str
    left: object
    right: object


@dataclass
class Call:
    name: str
    args: list


@dataclass
class Assign:
    target: str
    expr: object


@dataclass
class MethodCall:
    """`l.update_current(v)` / `n.update(dt)` statement (DSL struct calls,
    nb_macro Ast::StructFunctionCall)."""
    path: str
    args: list


@dataclass
class DiffEq:
    """dX/dt = expr  ->  X += dt * expr (Euler)."""
    target: str
    expr: object


@dataclass
class FuncDef:
    """User function declaration `f(x, y) = expr`
    (`func_declaration`, pest_ast/mod.rs:54-55): binds a named function
    usable in subsequent expressions of the same statement scope."""
    name: str
    params: list
    expr: object


@dataclass
class If:
    """[if] c1 [then] body1 [elseif] c2 [then] body2 [else] body3 [end]"""
    conditions: list
    bodies: list
    else_body: list = field(default_factory=list)


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

TOKEN_RE = re.compile(r"""
    (?P<skip>\s+)
  | (?P<kw>\[(?:if|then|elseif|else|end)\])
  | (?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?)
  | (?P<rpow>r\^(?=\s|$))
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*(?:[.$][A-Za-z0-9_]+)*)
  | (?P<op><=|>=|==|!=|&&|\|\||[-+*/^(),<>=!])
""", re.VERBOSE)


def tokenize(text):
    tokens = []
    pos = 0
    while pos < len(text):
        m = TOKEN_RE.match(text, pos)
        if not m:
            raise SyntaxError(f"cannot tokenize at: {text[pos:pos+30]!r}")
        pos = m.end()
        if m.lastgroup == "skip":
            continue
        tokens.append((m.lastgroup, m.group()))
    return tokens


# Pratt binding powers (prefix/infix); `r^`/`^` are the DSL's power operators.
INFIX_BP = {
    "||": (1, 2), "&&": (3, 4),
    "==": (5, 6), "!=": (5, 6), "<": (5, 6), ">": (5, 6),
    "<=": (5, 6), ">=": (5, 6),
    "+": (7, 8), "-": (7, 8),
    "*": (9, 10), "/": (9, 10),
    "^": (12, 11), "r^": (12, 11),   # right-assoc power
}


class ExprParser:
    def __init__(self, tokens):
        self.tokens = tokens
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else (None, None)

    def next(self):
        tok = self.peek()
        self.pos += 1
        return tok

    def expect(self, value):
        kind, tok = self.next()
        if tok != value:
            raise SyntaxError(f"expected {value!r}, got {tok!r}")

    def parse_expr(self, min_bp=0):
        kind, tok = self.next()
        if kind == "num":
            lhs = Num(float(tok))
        elif kind == "name":
            if self.peek()[1] == "(":
                self.next()
                args = []
                if self.peek()[1] != ")":
                    args.append(self.parse_expr())
                    while self.peek()[1] == ",":
                        self.next()
                        args.append(self.parse_expr())
                self.expect(")")
                lhs = Call(tok, args)
            else:
                lhs = Var(tok)
        elif tok == "(":
            lhs = self.parse_expr()
            self.expect(")")
        elif tok == "-":
            lhs = Unary("-", self.parse_expr(11))
        elif tok == "!":
            lhs = Unary("!", self.parse_expr(11))
        else:
            raise SyntaxError(f"unexpected token {tok!r}")

        while True:
            kind, tok = self.peek()
            if tok not in INFIX_BP:
                break
            l_bp, r_bp = INFIX_BP[tok]
            if l_bp < min_bp:
                break
            self.next()
            rhs = self.parse_expr(r_bp)
            lhs = BinOp(tok, lhs, rhs)
        return lhs


def parse_expression(text):
    p = ExprParser(tokenize(text))
    expr = p.parse_expr()
    if p.pos != len(p.tokens):
        raise SyntaxError(f"trailing tokens in expression: {text!r}")
    return expr


# ---------------------------------------------------------------------------
# Statement parsing (on_iteration / on_spike bodies)
# ---------------------------------------------------------------------------

DIFF_RE = re.compile(r"^d([A-Za-z_][A-Za-z0-9_$]*)/dt$")

FUNC_DEF_RE = re.compile(
    r"^([A-Za-z_][A-Za-z0-9_]*)\(\s*([A-Za-z_][A-Za-z0-9_]*"
    r"(?:\s*,\s*[A-Za-z_][A-Za-z0-9_]*)*)\s*,?\s*\)$")


METHOD_CALL_RE = re.compile(r"^([A-Za-z_][A-Za-z0-9_.]*)\((.*)\)$")


def _parse_statement_line(line):
    if "=" not in line:
        m = METHOD_CALL_RE.match(line.strip())
        if m and "." in m.group(1):
            args_src = m.group(2).strip()
            args = []
            if args_src:
                # split top-level commas
                depth, start = 0, 0
                for i, ch in enumerate(args_src + ","):
                    if ch == "(":
                        depth += 1
                    elif ch == ")":
                        depth -= 1
                    elif ch == "," and depth == 0:
                        args.append(parse_expression(args_src[start:i]))
                        start = i + 1
            return MethodCall(m.group(1), args)
        raise SyntaxError(f"expected assignment: {line!r}")
    # careful with ==, <=, >=, != inside the RHS: split on the first bare `=`
    idx = None
    i = 0
    while i < len(line):
        if line[i] == "=" and (i == 0 or line[i - 1] not in "<>=!") \
                and (i + 1 >= len(line) or line[i + 1] != "="):
            idx = i
            break
        i += 1
    if idx is None:
        raise SyntaxError(f"expected assignment: {line!r}")
    target = line[:idx].strip()
    rhs = line[idx + 1:].strip()
    aug = None
    if target.endswith(("+", "-", "*", "/")):
        aug = target[-1]
        target = target[:-1].strip()
    m = DIFF_RE.match(target)
    expr = parse_expression(rhs)
    if m:
        return DiffEq(m.group(1), expr)
    fm = FUNC_DEF_RE.match(target)
    if fm and aug is None:
        params = [x.strip() for x in fm.group(2).split(",")]
        return FuncDef(fm.group(1), params, expr)
    if aug:
        return Assign(target, BinOp(aug, Var(target), expr))
    return Assign(target, expr)


def parse_statements(lines):
    """Parse a statement block: assignments / diff-eqs / [if] chains.

    ``lines`` is a list of raw lines (already stripped of the section
    header).  [if]/[then]/[elseif]/[else]/[end] may span lines.
    """
    text = "\n".join(lines)
    # split into a flat token stream of statements and control markers
    out = []
    pos = 0
    stack = []  # open If nodes

    def emit(stmt):
        if stack:
            node, mode = stack[-1]
            if mode == "then":
                node.bodies[-1].append(stmt)
            else:
                node.else_body.append(stmt)
        else:
            out.append(stmt)

    for raw_chunk in _split_control(text):
        kind, payload = raw_chunk
        if kind == "stmt":
            for line in payload.split("\n"):
                line = line.strip()
                if line:
                    emit(_parse_statement_line(line))
        elif kind == "if":
            node = If(conditions=[parse_expression(payload)], bodies=[[]])
            stack.append((node, "then"))
        elif kind == "elseif":
            node, _ = stack[-1]
            node.conditions.append(parse_expression(payload))
            node.bodies.append([])
            stack[-1] = (node, "then")
        elif kind == "else":
            node, _ = stack[-1]
            stack[-1] = (node, "else")
        elif kind == "end":
            node, _ = stack.pop()
            emit(node)
    if stack:
        raise SyntaxError("unterminated [if] block")
    return out


def _split_control(text):
    """Yield ('stmt', chunk) / ('if', cond) / ('elseif', cond) / ('else', '')
    / ('end', '') segments."""
    pattern = re.compile(
        r"\[if\](?P<ifc>.*?)\[then\]|\[elseif\](?P<elifc>.*?)\[then\]"
        r"|\[else\]|\[end\]", re.DOTALL)
    pos = 0
    for m in pattern.finditer(text):
        if m.start() > pos:
            yield ("stmt", text[pos:m.start()])
        if m.group("ifc") is not None:
            yield ("if", m.group("ifc").strip())
        elif m.group("elifc") is not None:
            yield ("elseif", m.group("elifc").strip())
        elif m.group().startswith("[else"):
            yield ("else", "")
        else:
            yield ("end", "")
        pos = m.end()
    if pos < len(text):
        yield ("stmt", text[pos:])


# ---------------------------------------------------------------------------
# Block-level parsing
# ---------------------------------------------------------------------------

@dataclass
class Block:
    kind: str                       # neuron / spike_train / ...
    type_name: str = ""
    vars: dict = field(default_factory=dict)
    sections: dict = field(default_factory=dict)   # name -> statements/expr/raw
    # receptors blocks: per-neurotransmitter sub-groups
    groups: list = field(default_factory=list)


BLOCK_KINDS = ("neuron", "spike_train", "neurotransmitter_kinetics",
               "receptor_kinetics", "neural_refractoriness", "ion_channel",
               "receptors")

STATEMENT_SECTIONS = ("on_iteration", "on_spike",
                      "on_electrochemical_iteration")
EXPR_SECTIONS = ("spike_detection", "effect")
RAW_SECTIONS = ("type", "kinetics", "receptors", "neurotransmitter",
                "gating_vars", "ion_channels")


def _merge_vars(target, new):
    """Merge a parsed `vars:` section, rejecting redeclarations across
    sections of the same block (the reference macro would emit duplicate
    struct fields — a compile error)."""
    dup = set(target) & set(new)
    if dup:
        raise SyntaxError(
            f"duplicate variable declaration: {sorted(dup)[0]!r}")
    target.update(new)


def _parse_vars(text):
    out = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, val = part.split("=", 1)
            name = name.strip()
            val = val.strip()
            # bool defaults (`flag = false`, grammar variables_assignment =
            # name = (signed_number | bool)) stored as 0/1 f32 state
            if val in ("true", "false"):
                value = 1.0 if val == "true" else 0.0
            else:
                value = float(val)
        else:
            name, value = part, 0.0
        if name in out:
            # the reference rejects duplicate variable declarations at
            # macro-expansion time (nb_macro/tests/duplicate_variables.rs
            # compile_fail doctest)
            raise SyntaxError(f"duplicate variable declaration: {name!r}")
        out[name] = value
    return out


def parse(text):
    """Parse full `.nb` source into a list of :class:`Block`.

    A block terminates at the ``[end]`` that closes it, tracked by counting
    statement-level ``[if]``/``[end]`` nesting.
    """
    blocks = []
    block_re = re.compile(
        r"^[ \t]*\[(" + "|".join(BLOCK_KINDS) + r")\][ \t]*$", re.MULTILINE)

    pos = 0
    while True:
        m = block_re.search(text, pos)
        if not m:
            break
        kind = m.group(1)
        body_start = m.end()
        depth = 0
        end_at = None
        scan = body_start
        for line in text[body_start:].split("\n"):
            opens = line.count("[if]")
            closes = line.count("[end]")
            if depth + opens - closes < 0:
                # the last [end] on this line closes the block
                end_at = scan + line.rindex("[end]")
                break
            depth += opens - closes
            scan += len(line) + 1
        if end_at is None:
            raise SyntaxError(f"[{kind}] block missing [end]")
        body = text[body_start:end_at]
        pos = end_at + len("[end]")
        blocks.append(_parse_block(kind, body))
    return blocks


SECTION_RE = re.compile(
    r"^\s*(type|vars|kinetics|receptors|neurotransmitter|gating_vars|"
    r"ion_channels|on_iteration|on_spike|on_electrochemical_iteration|"
    r"spike_detection|effect)\s*:", re.MULTILINE)


def _parse_block(kind, body):
    block = Block(kind=kind)
    matches = list(SECTION_RE.finditer(body))
    sections = []
    for i, m in enumerate(matches):
        end = matches[i + 1].start() if i + 1 < len(matches) else len(body)
        sections.append((m.group(1), body[m.end():end].strip()))

    if kind == "receptors":
        _parse_receptors_block(block, sections)
        return block

    for name, content in sections:
        if name == "type":
            block.type_name = content.strip()
        elif name == "vars":
            _merge_vars(block.vars, _parse_vars(content))
        elif name in STATEMENT_SECTIONS:
            block.sections[name] = parse_statements(content.split("\n"))
        elif name in EXPR_SECTIONS:
            block.sections[name] = parse_expression(content)
        else:
            block.sections[name] = content.strip()
    return block


def _parse_receptors_block(block, sections):
    """[receptors] blocks interleave top-level settings with per-
    `neurotransmitter:` groups (lixirnet/src/lib.rs:45-66)."""
    current = None
    for name, content in sections:
        if name == "type":
            block.type_name = content
        elif name == "kinetics":
            block.sections["kinetics"] = content
        elif name == "neurotransmitter":
            current = {"neurotransmitter": content, "vars": {},
                       "receptors": [], "on_iteration": []}
            block.groups.append(current)
        elif name == "vars":
            if current is None:
                _merge_vars(block.vars, _parse_vars(content))
            else:
                current["vars"].update(_parse_vars(content))
        elif name == "receptors":
            current["receptors"] = [r.strip() for r in content.split(",")]
        elif name == "on_iteration":
            stmts = parse_statements(content.split("\n"))
            if current is None:
                block.sections["on_iteration"] = stmts
            else:
                current["on_iteration"] = stmts
