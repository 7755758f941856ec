"""AirScript frontend: compiles AirScript source text to an AirSchema.

Counterpart of ``genstark_tpu/air/script.py`` (a copy whose imports point
at the port; `lib128.aa` / `lib224.aa` imports resolve to the port's
stdlib).  It replaces `@guildofweavers/air-script` (consumed at the
reference's index.ts:43).  The grammar surface implemented here is the one
exercised by the reference's examples:

    define NAME over prime field (modulus-expr) {
        const name: scalar | [vector] | [[matrix]];
        static name: cycle [..] | cycle prng(sha256, 0xSEED, n) | [cycle.., ..];
        (secret|public) input name: (element|boolean)[width]([1])*;
        transition R registers { <loop nest> }
        enforce C constraints { <loop nest> | for all steps {..} }
    }

with expressions over + - * / ^ # (matrix product), unary / (elementwise
inverse), ternary `? :`, spreads `...v`, slices `x[a..b]`, trace registers
`$r/$rI/$r[a..b]` and next-step `$n/...`, intermediate values `name <- expr`.

Loop lowering follows the same recipe the reference's compiler uses — the
hand-written AirAssembly mirror of a compiled AirScript program documents it
exactly (the reference's assembly/lib128.aa ComputeMerkleRoot vs
the reference's examples/poseidon/merkleProof.ts):

- every input register is shifted by -1 (the next cycle's value is visible
  one step early, so the transition at a cycle's last step can compute the
  next cycle's first row);
- each `for each` level contributes a mask register over its first input,
  selecting that level's `init` expression;
- each `for steps [..]` segment contributes a cyclic 0/1 control register
  (shifted by -1: `steps [1..4]` fires at cycle positions 0..3);
- transition = sum of mask-selected init terms plus the control-selected
  segment terms, nested exactly as $merkleTransition (lib128.aa:49-86).

Validated against independent Poseidon/Rescue/MiMC oracles in
tests/test_script*.py.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..field import create_prime_field
from .ir import (AirSchema, Const, CyclicRegister, Expr, InputRegister,
                 MaskRegister, NextReg, StaticReg, TraceReg, _wrap)


class AirScriptError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|//[^\n]*)
  | (?P<reg>\$[rn]\d*)
  | (?P<str>'[^']*')
  | (?P<hex>0x[0-9a-fA-F]+)
  | (?P<num>\d+)
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><-|\.\.\.|\.\.|[{}()\[\],;:?#^*/+\-=<>])
""", re.X)


def tokenize(text: str) -> List[str]:
    tokens, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise AirScriptError(f"unexpected character {text[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup != "ws":
            tokens.append(m.group())
    return tokens


# ---------------------------------------------------------------------------
# Declarations collected during parse
# ---------------------------------------------------------------------------

@dataclass
class InputDecl:
    name: str
    secret: bool
    width: int
    rank: int
    binary: bool
    regs: List[int] = dc_field(default_factory=list)   # static register indices


@dataclass
class StaticDecl:
    name: str
    cycles: List[List[int]]          # one value list per component
    regs: List[int] = dc_field(default_factory=list)


@dataclass
class Segment:
    ranges: List[Tuple[int, int]]
    result: List[Expr]               # transition: yielded vector;
                                     # enforce: (rhs - lhs) vector


@dataclass
class LoopLevel:
    input_names: List[str]
    init_result: Optional[List[Expr]]    # yielded vector / (rhs-lhs) vector
    inline: Optional[List[Expr]] = None  # with-body: full-width transition
                                         # (component init selection embedded)


@dataclass
class LoopNest:
    levels: List[LoopLevel]
    segments: List[Segment]
    cycle_len: int


@dataclass
class ComponentInfo:
    """An AirAssembly export imported into AirScript
    (`import { Name as Alias } from '...aa'`,
    the reference's examples/assembly/merkleProof.ts:39)."""
    schema: AirSchema
    input_regs: List[int]
    mask_regs: List[int]
    cycle_regs: List[int]


_TRANSITION_CALL = object()          # marker for `transition($r)` in enforce


# ---------------------------------------------------------------------------
# Compile-time value algebra: int | Expr | vector | matrix
# ---------------------------------------------------------------------------

Value = Union[int, Expr, list]


def _is_vec(v) -> bool:
    return isinstance(v, list) and (not v or not isinstance(v[0], list))


def _is_mat(v) -> bool:
    return isinstance(v, list) and v and isinstance(v[0], list)


def _binop(op, a: Value, b: Value) -> Value:
    if isinstance(a, list) or isinstance(b, list):
        if _is_mat(a) or _is_mat(b):
            if not (_is_mat(a) and _is_mat(b)):
                raise AirScriptError("cannot broadcast matrix against non-matrix")
            return [[_binop(op, x, y) for x, y in zip(ra, rb)]
                    for ra, rb in zip(a, b)]
        if isinstance(a, list) and isinstance(b, list):
            if len(a) != len(b):
                raise AirScriptError(
                    f"vector length mismatch: {len(a)} vs {len(b)}")
            return [_binop(op, x, y) for x, y in zip(a, b)]
        if isinstance(a, list):
            return [_binop(op, x, b) for x in a]
        return [_binop(op, a, y) for y in b]
    if isinstance(a, int) and isinstance(b, int):
        return {"+": a + b, "-": a - b, "*": a * b}[op] if op in "+-*" else \
            _binop_expr(op, a, b)
    return _binop_expr(op, a, b)


def _binop_expr(op, a, b) -> Expr:
    ea, eb = _wrap(a) if not isinstance(a, Expr) else a, \
        _wrap(b) if not isinstance(b, Expr) else b
    if op == "+":
        return ea + eb
    if op == "-":
        return ea - eb
    if op == "*":
        return ea * eb
    if op == "/":
        return ea / eb
    raise AirScriptError(f"unknown operator {op}")


def _matmul(a: Value, b: Value) -> Value:
    if not _is_mat(a):
        raise AirScriptError("`#` requires a matrix on the left")
    if _is_mat(b):
        n = len(b)
        return [[_dot(row, [b[k][j] for k in range(n)]) for j in range(len(b[0]))]
                for row in a]
    if not isinstance(b, list):
        raise AirScriptError("`#` requires a vector or matrix on the right")
    if any(len(row) != len(b) for row in a):
        raise AirScriptError("matrix/vector dimension mismatch in `#`")
    return [_dot(row, b) for row in a]


def _dot(row: Sequence[Value], vec: Sequence[Value]) -> Value:
    acc = None
    for x, y in zip(row, vec):
        term = _binop("*", x, y)
        acc = term if acc is None else _binop("+", acc, term)
    return acc


def _elementwise_inv(v: Value) -> Value:
    if isinstance(v, list):
        return [_elementwise_inv(x) for x in v]
    return _binop_expr("/", 1, v)


def _ternary(cond: Value, a: Value, b: Value) -> Value:
    if isinstance(cond, list):
        raise AirScriptError("ternary condition must be a scalar")
    # cond is binary: cond*a + (1-cond)*b
    return _binop("+", _binop("*", cond, a),
                  _binop("*", _binop("-", 1, cond), b))


def _power(base: Value, e: Value, p: int) -> Value:
    if not isinstance(e, int):
        raise AirScriptError("exponent must be a compile-time constant")
    if isinstance(base, list):
        return [_power(x, e, p) for x in base]
    if isinstance(base, int):
        return pow(base, e, p)
    return base ** e


def _as_exprs(v: Value, p: int) -> List[Expr]:
    """Flatten a scalar/vector Value into a list of Expr (ints wrapped)."""
    items = v if isinstance(v, list) else [v]
    out = []
    for x in items:
        if isinstance(x, list):
            raise AirScriptError("matrix cannot be yielded/enforced")
        out.append(Const(x % p) if isinstance(x, int) else x)
    return out


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.i = 0

    # --- token plumbing -----------------------------------------------------
    def peek(self, k: int = 0) -> Optional[str]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise AirScriptError("unexpected end of input")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, tok: str) -> str:
        t = self.next()
        if t != tok:
            raise AirScriptError(f"expected {tok!r}, got {t!r} "
                                 f"(near ...{' '.join(self.toks[max(0, self.i-6):self.i+4])})")
        return t

    def accept(self, tok: str) -> bool:
        if self.peek() == tok:
            self.i += 1
            return True
        return False

    # --- int expressions (modulus etc.) --------------------------------------
    def parse_int_expr(self) -> int:
        v = self._int_add()
        return v

    def _int_add(self) -> int:
        v = self._int_mul()
        while self.peek() in ("+", "-"):
            op = self.next()
            r = self._int_mul()
            v = v + r if op == "+" else v - r
        return v

    def _int_mul(self) -> int:
        v = self._int_pow()
        while self.peek() == "*":
            self.next()
            v = v * self._int_pow()
        return v

    def _int_pow(self) -> int:
        v = self._int_atom()
        if self.peek() == "^":
            self.next()
            return v ** self._int_pow()
        return v

    def _int_atom(self) -> int:
        t = self.next()
        if t == "(":
            v = self._int_add()
            self.expect(")")
            return v
        if t == "-":
            return -self._int_atom()
        if t.startswith("0x"):
            return int(t, 16)
        if t.isdigit():
            return int(t)
        raise AirScriptError(f"expected integer term, got {t!r}")


class ScriptCompiler:
    def __init__(self, source: str, base_path: Optional[str] = None):
        self.p = _Parser(tokenize(source))
        self.base_path = base_path
        self.consts: Dict[str, Value] = {}
        self.statics: Dict[str, StaticDecl] = {}
        self.inputs: Dict[str, InputDecl] = {}
        self.input_order: List[str] = []
        self.imports: Dict[str, ComponentInfo] = {}
        self.trace_width = 0
        self.constraint_count = 0
        self.field = None
        self.name = "default"
        # static register table under construction
        self.static_defs: List = []
        # loop structures
        self.transition_nest: Optional[LoopNest] = None
        self.level_masks: Dict[int, int] = {}   # loop level -> mask register
        self.ctrl_regs: List[int] = []          # per transition segment
        self._cycle_cache: Dict[tuple, int] = {}  # imported cycle dedup

    # --------------------------------------------------------------- imports
    def _parse_imports(self):
        """`import { A [as B], ... } from 'path.aa';` — compiles each named
        export of the AirAssembly module into a ComponentInfo."""
        from pathlib import Path
        from .assembly import compile_assembly
        p = self.p
        while p.peek() == "import":
            p.next()
            p.expect("{")
            names = []                         # (exported, alias)
            while True:
                exported = p.next()
                alias = exported
                if p.accept("as"):
                    alias = p.next()
                names.append((exported, alias))
                if not p.accept(","):
                    break
            p.expect("}")
            p.expect("from")
            path_tok = p.next()
            if not (path_tok.startswith("'") and path_tok.endswith("'")):
                raise AirScriptError("import path must be a quoted string")
            p.expect(";")
            rel = path_tok[1:-1]
            # lib128.aa / lib224.aa always resolve to the port's generated
            # stdlib, whatever directory they are named under, so the AIR
            # never depends on a file beside the checkout.  Any other
            # import resolves against `base_path` only, never the working
            # directory.
            from .. import stdlib
            builtin = {"lib128.aa": stdlib.lib128_source,
                       "lib224.aa": stdlib.lib224_source}
            gen = builtin.get(Path(rel).name)
            if gen is not None:
                source = gen()
            else:
                path = Path(self.base_path) / rel if self.base_path else None
                if path is None or not path.is_file():
                    raise AirScriptError(f"cannot resolve import path {rel!r}")
                source = path.read_text()
            for exported, alias in names:
                schema = compile_assembly(source, exported)
                inputs, masks, cycles = [], [], []
                for k, reg in enumerate(schema.static_registers):
                    if isinstance(reg, InputRegister):
                        inputs.append(k)
                    elif isinstance(reg, MaskRegister):
                        masks.append(k)
                    else:
                        cycles.append(k)
                self.imports[alias] = ComponentInfo(schema, inputs, masks, cycles)

    # ------------------------------------------------------------------ main
    def compile(self) -> AirSchema:
        p = self.p
        self._parse_imports()
        p.expect("define")
        self.name = p.next()
        p.expect("over"); p.expect("prime"); p.expect("field"); p.expect("(")
        modulus = p.parse_int_expr()
        p.expect(")")
        self.field = create_prime_field(modulus)
        p.expect("{")

        transition_tokens = None
        enforce_tokens = None
        while not p.accept("}"):
            t = p.peek()
            if t == "const":
                self._parse_const()
            elif t == "static":
                self._parse_static()
            elif t in ("secret", "public"):
                self._parse_input()
            elif t == "transition":
                transition_tokens = self._skip_block_after_header()
            elif t == "enforce":
                enforce_tokens = self._skip_block_after_header()
            else:
                raise AirScriptError(f"unexpected declaration {t!r}")

        if transition_tokens is None or enforce_tokens is None:
            raise AirScriptError("both transition and enforce blocks are required")

        # whole-body component alias: `for each (all inputs) { yield Comp(all
        # inputs); }` re-exports the AirAssembly component under the caller's
        # input declarations (merkleUpdate.ts:36-58)
        alias = self._try_component_alias(transition_tokens, enforce_tokens)
        if alias is not None:
            return alias

        # inputs own the first static registers (declaration order, width-major)
        self._assign_input_registers()

        # transition first: it defines the loop structure (masks/controls)
        init_exprs, transition_exprs = self._compile_transition(transition_tokens)
        constraint_exprs = self._compile_enforce(enforce_tokens, transition_exprs)

        if len(constraint_exprs) != self.constraint_count:
            raise AirScriptError(
                f"enforce declares {self.constraint_count} constraints but "
                f"produces {len(constraint_exprs)}")

        return AirSchema(
            field=self.field,
            trace_width=self.trace_width,
            static_registers=self.static_defs,
            init=init_exprs,
            transition=transition_exprs,
            constraints=constraint_exprs,
            base_steps=self.transition_nest.cycle_len,
            name=self.name,
        )

    def _try_component_alias(self, transition_tokens: List[str],
                             enforce_tokens: List[str]) -> Optional[AirSchema]:
        """Detect `for each (<inputs>) { yield Comp(<inputs>); }` (and the
        matching enforce form) and return the component schema with the
        caller's input flags applied."""
        def body_call(tokens: List[str], terminal: str) -> Optional[str]:
            # for each ( names ) { terminal NAME ( names ) ; }
            want = ["for", "each", "("]
            for n in self.input_order:
                want += [n, ","]
            want[-1] = ")"
            want += ["{", terminal]
            if tokens[:len(want)] != want:
                return None
            rest = tokens[len(want):]
            if len(rest) < 4 or rest[0] not in self.imports or rest[1] != "(":
                return None
            args = ["("] + [t for n in self.input_order for t in (n, ",")]
            args[-1] = ")"
            if rest[1:1 + len(args)] != args or \
                    rest[1 + len(args):] != [";", "}"]:
                return None
            return rest[0]

        t_name = body_call(transition_tokens, "yield")
        e_name = body_call(enforce_tokens, "enforce")
        if t_name is None and e_name is None:
            return None
        if t_name is None or t_name != e_name:
            raise AirScriptError(
                "transition and enforce must call the same component")
        comp = self.imports[t_name]
        schema = comp.schema
        if schema.trace_width != self.trace_width:
            raise AirScriptError(
                f"component has {schema.trace_width} registers, "
                f"declared {self.trace_width}")
        if len(schema.constraints) != self.constraint_count:
            raise AirScriptError(
                f"component has {len(schema.constraints)} constraints, "
                f"declared {self.constraint_count}")
        # apply the caller's input declarations (secret/public, binary) to
        # the component's input registers, width-major in order
        slot = 0
        for name in self.input_order:
            decl = self.inputs[name]
            for _ in range(decl.width):
                if slot >= len(comp.input_regs):
                    raise AirScriptError("more declared inputs than the "
                                         "component accepts")
                reg: InputRegister = schema.static_registers[comp.input_regs[slot]]
                reg.secret = decl.secret
                reg.binary = decl.binary
                slot += 1
        if slot != len(comp.input_regs):
            raise AirScriptError("fewer declared inputs than the component accepts")
        schema.name = self.name
        return schema

    # ----------------------------------------------------------- declarations
    def _parse_const(self):
        p = self.p
        p.expect("const")
        name = p.next()
        p.expect(":")
        self.consts[name] = self._parse_const_value()
        p.expect(";")

    def _parse_const_value(self) -> Value:
        p = self.p
        if p.peek() == "[":
            p.next()
            if p.peek() == "[":                     # matrix
                rows = []
                while True:
                    p.expect("[")
                    row = [p.parse_int_expr()]
                    while p.accept(","):
                        row.append(p.parse_int_expr())
                    p.expect("]")
                    rows.append(row)
                    if not p.accept(","):
                        break
                p.expect("]")
                return rows
            vals = [p.parse_int_expr()]
            while p.accept(","):
                vals.append(p.parse_int_expr())
            p.expect("]")
            return vals
        return p.parse_int_expr()

    def _parse_cycle_values(self) -> List[int]:
        """After the `cycle` keyword: `[v, ...]` or `prng(sha256, 0xSEED, n)`
        or `power(b, n)`."""
        p = self.p
        if p.accept("prng"):
            p.expect("(")
            alg = p.next()
            if alg != "sha256":
                raise AirScriptError("only sha256 prng is supported")
            p.expect(",")
            seed_tok = p.next()
            if not seed_tok.startswith("0x"):
                raise AirScriptError("prng seed must be a hex literal")
            p.expect(",")
            count = p.parse_int_expr()
            p.expect(")")
            hex_str = seed_tok[2:]
            if len(hex_str) % 2:                    # Node Buffer.from(str,'hex')
                hex_str = hex_str[:-1]              # silently drops odd nibble
            return self.field.prng(bytes.fromhex(hex_str), count)
        if p.accept("power"):
            p.expect("(")
            base = p.parse_int_expr()
            p.expect(",")
            count = p.parse_int_expr()
            p.expect(")")
            pm = self.field.modulus
            out, v = [], 1
            for _ in range(count):
                out.append(v)
                v = v * base % pm
            return out
        p.expect("[")
        vals = [p.parse_int_expr()]
        while p.accept(","):
            vals.append(p.parse_int_expr())
        p.expect("]")
        return [v % self.field.modulus for v in vals]

    def _parse_static(self):
        p = self.p
        p.expect("static")
        name = p.next()
        p.expect(":")
        cycles = []
        if p.peek() == "[" and p.peek(1) == "cycle":    # vector of cycles
            p.next()
            while True:
                p.expect("cycle")
                cycles.append(self._parse_cycle_values())
                if not p.accept(","):
                    break
            p.expect("]")
        else:
            p.expect("cycle")
            cycles.append(self._parse_cycle_values())
        p.expect(";")
        self.statics[name] = StaticDecl(name, cycles)

    def _parse_input(self):
        p = self.p
        secret = p.next() == "secret"
        p.expect("input")
        name = p.next()
        p.expect(":")
        kind = p.next()
        if kind not in ("element", "boolean"):
            raise AirScriptError(f"unknown input type {kind!r}")
        dims = []
        while p.accept("["):
            dims.append(p.parse_int_expr())
            p.expect("]")
        p.expect(";")
        if not dims:
            raise AirScriptError(f"input {name} needs at least one [width]")
        width, rank = dims[0], len(dims)
        self.inputs[name] = InputDecl(name, secret, width, rank,
                                      binary=(kind == "boolean"))
        self.input_order.append(name)

    def _assign_input_registers(self):
        for name in self.input_order:
            decl = self.inputs[name]
            for _ in range(decl.width):
                decl.regs.append(len(self.static_defs))
                # structural fields (parent/steps) are filled in during loop
                # lowering once levels are known
                self.static_defs.append(InputRegister(
                    secret=decl.secret, rank=decl.rank, binary=decl.binary,
                    shift=-1))
        for name, st in self.statics.items():
            for values in st.cycles:
                st.regs.append(len(self.static_defs))
                self.static_defs.append(CyclicRegister(list(values)))

    def _skip_block_after_header(self) -> List[str]:
        """Consume `transition N registers { ... }` / `enforce N constraints
        { ... }`, returning the body tokens; records the declared counts."""
        p = self.p
        kw = p.next()
        count = p.parse_int_expr()
        unit = p.next()
        if kw == "transition":
            if unit not in ("register", "registers"):
                raise AirScriptError("expected `registers`")
            self.trace_width = count
        else:
            if unit not in ("constraint", "constraints"):
                raise AirScriptError("expected `constraints`")
            self.constraint_count = count
        p.expect("{")
        depth, start = 1, p.i
        while depth:
            t = p.next()
            if t == "{":
                depth += 1
            elif t == "}":
                depth -= 1
        return p.toks[start:p.i - 1]

    # ------------------------------------------------------- loop structures
    def _ensure_level_mask(self, level: int) -> int:
        """Mask register for a loop level (source: the first input belonging
        to it), allocated on first use so with-body component inlining can
        reference it during parsing."""
        if level not in self.level_masks:
            src = self._level_first_input_reg(level)
            self.level_masks[level] = len(self.static_defs)
            self.static_defs.append(MaskRegister(source=src))
        return self.level_masks[level]

    def _import_cycle(self, values: List[int]) -> int:
        """Caller-side cyclic register for an inlined component's cycle,
        deduplicated by value pattern (two `with` calls of the same component
        share its round-constant cycles)."""
        key = tuple(values)
        if key not in self._cycle_cache:
            self._cycle_cache[key] = len(self.static_defs)
            self.static_defs.append(CyclicRegister(list(values)))
        return self._cycle_cache[key]

    def _compile_transition(self, tokens: List[str]):
        nest = self._parse_loop_nest(tokens, enforce=False)
        self.transition_nest = nest
        self._finalize_input_structure(nest)

        # control register per segment (cycle shifted by -1)
        self.ctrl_regs = []
        for seg in nest.segments:
            pattern = [0] * nest.cycle_len
            for lo, hi in seg.ranges:
                for s in range(lo, hi + 1):
                    pattern[s - 1] = 1
            self.ctrl_regs.append(len(self.static_defs))
            self.static_defs.append(CyclicRegister(pattern))

        transition = self._combine_nest(nest, width=self.trace_width)
        init = nest.levels[0].init_result
        if init is None:
            raise AirScriptError(
                "the top-level `for each` needs an init block (the trace's "
                "first row cannot come from a `with` body)")
        if len(init) != self.trace_width:
            raise AirScriptError("top-level init width != register count")
        return init, transition

    def _compile_enforce(self, tokens: List[str], transition: List[Expr]):
        # `for all steps { enforce ... }`
        if tokens[:3] == ["for", "all", "steps"]:
            p = _Parser(tokens)
            p.expect("for"); p.expect("all"); p.expect("steps"); p.expect("{")
            sub = ScriptExprParser(self, p, env={})
            lhs, rhs = sub.parse_enforce_statement()
            p.expect("}")
            if lhs is _TRANSITION_CALL:
                nxt = rhs if isinstance(rhs, list) else [rhs]
                return [_binop("-", n, t) for n, t in
                        zip(nxt, transition)]
            diff = _binop("-", rhs, lhs)
            return _as_exprs(diff, self.field.modulus)

        if any(l.inline is not None for l in self.transition_nest.levels):
            raise AirScriptError(
                "a transition with `with` bodies requires the "
                "`for all steps { enforce transition($r) = $n; }` form")
        nest = self._parse_loop_nest(tokens, enforce=True)
        tn = self.transition_nest
        if [l.input_names for l in nest.levels] != [l.input_names for l in tn.levels]:
            raise AirScriptError("enforce loop structure must match transition")
        if [s.ranges for s in nest.segments] != [s.ranges for s in tn.segments]:
            raise AirScriptError("enforce segments must match transition segments")
        return self._combine_nest(nest, width=self.constraint_count)

    def _level_first_input_reg(self, level: int) -> int:
        """First register of the first input *belonging* to this level
        (an input of rank r belongs to level r-1)."""
        for name in self.input_order:
            if self.inputs[name].rank - 1 == level:
                return self.inputs[name].regs[0]
        raise AirScriptError(f"no input of rank {level + 1} for loop level {level}")

    def _finalize_input_structure(self, nest: LoopNest):
        """Fill parent/steps on input registers from the loop hierarchy
        (mirrors lib128.aa: child inputs get (childof parent)(steps n),
        top-level width peers get (peerof first))."""
        depth = len(nest.levels)
        for name in self.input_order:
            decl = self.inputs[name]
            if decl.rank > depth:
                raise AirScriptError(
                    f"input {name} rank {decl.rank} exceeds loop depth {depth}")
            level = decl.rank - 1
            parent = None
            if level > 0:
                parent = self._level_first_input_reg(level - 1)
            steps = nest.cycle_len if level == depth - 1 else None
            first = decl.regs[0]
            for j, r in enumerate(decl.regs):
                reg: InputRegister = self.static_defs[r]
                reg.parent = parent
                reg.steps = steps
                if j > 0 and parent is None and steps is None:
                    reg.peer = first       # span via peer when nothing else
                # non-first same-level components of the level-0 input used as
                # a mask source must not self-reference
            # validate level membership against where the name was bound
            for d, lvl in enumerate(nest.levels):
                if name in lvl.input_names and d > level:
                    raise AirScriptError(
                        f"input {name} (rank {decl.rank}) bound at loop "
                        f"level {d}")

    def _combine_nest(self, nest: LoopNest, width: int) -> List[Expr]:
        """Select init terms by masks and segment terms by control cycles:

            sum_d [prod_{j<d} (1-m_j)] * m_d * init_d  +  sum_k ctrl_k * seg_k

        The segment terms need no mask guards: masks fire only at cycle
        positions == cycle_len-1 (every input span is a multiple of the
        innermost cycle), where every control pattern is 0 by construction.
        An inner init term does need guards against *outer* masks -- at an
        outer-cycle boundary both masks fire and the outer init must win
        (lib128.aa $merkleTransition nests them the same way).  Dropping the
        redundant guards keeps constraint degrees minimal (smaller
        composition domain).

        A `with`-body innermost level instead contributes its inlined
        component transitions directly (the component's own mask term embeds
        the per-cycle re-init); outer init terms are layered on top as
        m_d*init_d + (1-m_d)*acc."""
        for lvl in nest.levels:
            for vec, what in [(lvl.init_result, "init"), (lvl.inline, "with body")]:
                if vec is not None and len(vec) != width:
                    raise AirScriptError(
                        f"{what} produces {len(vec)} values, expected {width}")
        for seg in nest.segments:
            if len(seg.result) != width:
                raise AirScriptError(
                    f"segment produces {len(seg.result)} values, expected {width}")

        innermost = nest.levels[-1]
        if innermost.inline is not None:
            acc = innermost.inline
            outer = nest.levels[:-1]
            # nested form: each outer init overrides everything inside it
            for d in range(len(outer) - 1, -1, -1):
                lvl = outer[d]
                if lvl.init_result is None:
                    raise AirScriptError("outer levels above a `with` body "
                                         "need init blocks")
                mask = StaticReg(self.level_masks[d])
                inv = _binop_expr("-", Const(1), mask)
                acc = [_binop_expr("+", _binop_expr("*", mask, i),
                                   _binop_expr("*", inv, a))
                       for i, a in zip(lvl.init_result, acc)]
            return acc

        acc = None
        for k, seg in enumerate(nest.segments):
            ctrl = StaticReg(self.ctrl_regs[k])
            term = [_binop_expr("*", ctrl, e) for e in seg.result]
            acc = term if acc is None else [
                _binop_expr("+", a, t) for a, t in zip(acc, term)]
        if acc is None:
            raise AirScriptError("loop needs at least one `for steps` segment")
        guard = None                         # prod over outer masks of (1-m_j)
        for d in range(len(nest.levels)):
            mask = StaticReg(self.level_masks[d])
            sel = mask if guard is None else _binop_expr("*", guard, mask)
            acc = [_binop_expr("+", a, _binop_expr("*", sel, e))
                   for a, e in zip(acc, nest.levels[d].init_result)]
            inv = _binop_expr("-", Const(1), mask)
            guard = inv if guard is None else _binop_expr("*", guard, inv)
        return acc

    def _parse_loop_nest(self, tokens: List[str], enforce: bool) -> LoopNest:
        p = _Parser(tokens)
        levels: List[LoopLevel] = []
        segments: List[Segment] = []
        cycle_len = 0
        has_inline = False

        def parse_with_body(level_idx: int) -> List[Expr]:
            """Innermost body of statements + `with $r[a..b] yield Comp(..)`
            clauses (the reference's examples/assembly/merkleProof.ts:58-67).
            Returns the full-width transition vector: each component's
            transition is inlined with its trace registers mapped onto the
            target slice, its input registers bound to the argument
            expressions, its mask bound to this level's mask, and its cycles
            imported as caller cyclic registers."""
            nonlocal cycle_len
            blk = ScriptExprParser(self, p, env={})
            out: List[Optional[Expr]] = [None] * self.trace_width
            while p.peek() != "}":
                if p.peek() == "with" or (p.peek() == "yield"
                                          and p.peek(1) in self.imports):
                    if p.accept("with"):
                        p.expect("$r"); p.expect("[")
                        lo = p.parse_int_expr()
                        p.expect("..")
                        hi = p.parse_int_expr()
                        p.expect("]")
                    else:
                        lo, hi = 0, self.trace_width - 1
                    p.expect("yield")
                    comp_name = p.next()
                    if comp_name not in self.imports:
                        raise AirScriptError(f"unknown component {comp_name!r}")
                    p.expect("(")
                    args: List[Value] = []
                    if p.peek() != ")":
                        while True:
                            args.append(blk.parse_expr())
                            if not p.accept(","):
                                break
                    p.expect(")"); p.expect(";")
                    exprs = self._inline_component(
                        self.imports[comp_name], args, lo, hi, level_idx)
                    comp_steps = self.imports[comp_name].schema.base_steps
                    if cycle_len and cycle_len != comp_steps:
                        raise AirScriptError(
                            "all components in a `with` body must share steps")
                    cycle_len = comp_steps
                    for i, e in enumerate(exprs):
                        if out[lo + i] is not None:
                            raise AirScriptError(
                                f"register {lo + i} yielded twice in with body")
                        out[lo + i] = e
                else:
                    name = p.next()
                    p.expect("<-")
                    blk.env[name] = blk.parse_expr()
                    p.expect(";")
            missing = [i for i, e in enumerate(out) if e is None]
            if missing:
                raise AirScriptError(
                    f"with body leaves registers {missing} without a yield")
            return out

        def parse_level():
            nonlocal cycle_len, has_inline
            level_idx = len(levels)
            p.expect("for"); p.expect("each"); p.expect("(")
            names = [p.next()]
            while p.accept(","):
                names.append(p.next())
            p.expect(")")
            for n in names:
                if n not in self.inputs:
                    raise AirScriptError(f"for each over undeclared input {n!r}")
            if not enforce:
                self._ensure_level_mask(level_idx)
            p.expect("{")
            init_result = None
            if p.peek() == "init":
                p.expect("init"); p.expect("{")
                blk = ScriptExprParser(self, p, env={})
                init_result = blk.parse_block(enforce=enforce)
                p.expect("}")
            if p.peek() == "for" and p.peek(1) == "each":
                if init_result is None:
                    raise AirScriptError(
                        "a `for each` level with a nested loop needs an init block")
                levels.append(LoopLevel(names, init_result))
                parse_level()
            elif p.peek() == "for":
                if init_result is None:
                    raise AirScriptError(
                        "a level with `for steps` segments needs an init block")
                levels.append(LoopLevel(names, init_result))
                while p.peek() == "for":
                    p.expect("for"); p.expect("steps"); p.expect("[")
                    ranges = []
                    while True:
                        lo = p.parse_int_expr()
                        p.expect("..")
                        hi = p.parse_int_expr()
                        ranges.append((lo, hi))
                        if not p.accept(","):
                            break
                    p.expect("]")
                    p.expect("{")
                    blk = ScriptExprParser(self, p, env={})
                    result = blk.parse_block(enforce=enforce)
                    p.expect("}")
                    segments.append(Segment(ranges, result))
                    cycle_len = max(cycle_len, max(hi for _, hi in ranges) + 1)
            else:
                if enforce:
                    raise AirScriptError(
                        "`with` bodies are transition-only; use "
                        "`for all steps {{ enforce transition($r) = $n; }}`")
                has_inline = True
                inline = parse_with_body(level_idx)
                levels.append(LoopLevel(names, init_result, inline=inline))
            p.expect("}")

        parse_level()
        if has_inline:
            if segments:
                raise AirScriptError(
                    "`with` bodies and `for steps` segments cannot be mixed")
            if cycle_len < 1 or cycle_len & (cycle_len - 1):
                raise AirScriptError("component steps must be a power of 2")
            return LoopNest(levels, segments, cycle_len)
        if not segments:
            raise AirScriptError("innermost loop needs `for steps` segments")
        if cycle_len & (cycle_len - 1) or cycle_len < 2:
            raise AirScriptError(
                f"cycle length {cycle_len} (max step + 1) must be a power of 2")
        # coverage check: steps 1..cycle_len-1 exactly once
        seen = [0] * cycle_len
        for seg in segments:
            for lo, hi in seg.ranges:
                if lo < 1 or hi >= cycle_len:
                    raise AirScriptError(f"step range {lo}..{hi} out of bounds")
                for s in range(lo, hi + 1):
                    seen[s] += 1
        if any(c != 1 for c in seen[1:]):
            raise AirScriptError("segments must cover steps 1..N-1 exactly once")
        return LoopNest(levels, segments, cycle_len)

    def _inline_component(self, comp: ComponentInfo, args: List[Value],
                          lo: int, hi: int, level_idx: int) -> List[Expr]:
        """Inline a component's transition into the caller
        (`with $r[lo..hi] yield Comp(args)`): trace registers map onto the
        target slice, input registers bind to the (flattened) argument
        expressions, the component's masks bind to the caller level's mask,
        and its cycles become caller cyclic registers."""
        from .ir import substitute
        schema = comp.schema
        if schema.field.modulus != self.field.modulus:
            raise AirScriptError("component field differs from the script field")
        if hi - lo + 1 != schema.trace_width:
            raise AirScriptError(
                f"component spans {schema.trace_width} registers, target "
                f"slice has {hi - lo + 1}")
        flat_args: List[Expr] = []
        for a in args:
            for x in (a if isinstance(a, list) else [a]):
                if isinstance(x, list):
                    raise AirScriptError("component arguments must be scalars "
                                         "or vectors")
                flat_args.append(Const(x % self.field.modulus)
                                 if isinstance(x, int) else x)
        if len(flat_args) != len(comp.input_regs):
            raise AirScriptError(
                f"component takes {len(comp.input_regs)} input values, "
                f"got {len(flat_args)}")
        static_map: Dict[int, Expr] = {}
        for k, arg in zip(comp.input_regs, flat_args):
            static_map[k] = arg
        mask_ref = StaticReg(self._ensure_level_mask(level_idx))
        for k in comp.mask_regs:
            static_map[k] = mask_ref
        for k in comp.cycle_regs:
            values = schema.static_registers[k].values
            static_map[k] = StaticReg(self._import_cycle(values))
        trace_map = {i: TraceReg(lo + i) for i in range(schema.trace_width)}
        cache: Dict = {}
        return [substitute(e, trace_map, static_map, cache)
                for e in schema.transition]


# ---------------------------------------------------------------------------
# Expression / statement parser (evaluates eagerly into Expr values)
# ---------------------------------------------------------------------------

class ScriptExprParser:
    def __init__(self, compiler: ScriptCompiler, parser: _Parser, env: Dict[str, Value]):
        self.c = compiler
        self.p = parser
        self.env = dict(env)

    # --- blocks ---------------------------------------------------------
    def parse_block(self, enforce: bool) -> List[Expr]:
        """Statements then a terminal yield/enforce; returns the result
        vector (for enforce: rhs - lhs)."""
        p = self.p
        while True:
            if p.peek() == "yield":
                if enforce:
                    raise AirScriptError("yield not allowed in enforce block")
                p.next()
                v = self.parse_expr()
                p.expect(";")
                return _as_exprs(v, self.c.field.modulus)
            if p.peek() == "enforce":
                if not enforce:
                    raise AirScriptError("enforce not allowed in transition block")
                lhs, rhs = self.parse_enforce_statement()
                if lhs is _TRANSITION_CALL:
                    raise AirScriptError(
                        "transition($r) is only valid under `for all steps`")
                return _as_exprs(_binop("-", rhs, lhs), self.c.field.modulus)
            name = p.next()
            p.expect("<-")
            self.env[name] = self.parse_expr()
            p.expect(";")

    def parse_enforce_statement(self):
        p = self.p
        p.expect("enforce")
        if p.peek() == "transition" and p.peek(1) == "(":
            p.next(); p.expect("("); p.expect("$r"); p.expect(")")
            lhs = _TRANSITION_CALL
        else:
            lhs = self.parse_expr()
        p.expect("=")
        rhs = self.parse_expr()
        p.expect(";")
        return lhs, rhs

    # --- expressions ------------------------------------------------------
    def parse_expr(self) -> Value:
        v = self._add()
        if self.p.accept("?"):
            a = self.parse_expr()
            self.p.expect(":")
            b = self.parse_expr()
            return _ternary(v, a, b)
        return v

    def _add(self) -> Value:
        v = self._mul()
        while self.p.peek() in ("+", "-"):
            op = self.p.next()
            v = _binop(op, v, self._mul())
        return v

    def _mul(self) -> Value:
        v = self._unary()
        while self.p.peek() in ("*", "/", "#"):
            op = self.p.next()
            r = self._unary()
            v = _matmul(v, r) if op == "#" else _binop(op, v, r)
        return v

    def _unary(self) -> Value:
        if self.p.accept("/"):
            return _elementwise_inv(self._unary())
        if self.p.accept("-"):
            return _binop("-", 0, self._unary())
        return self._pow()

    def _pow(self) -> Value:
        v = self._postfix()
        if self.p.accept("^"):
            e = self._unary()      # right-assoc; must fold to int
            if isinstance(e, Expr) and isinstance(e, Const):
                e = e.value
            if not isinstance(e, int):
                raise AirScriptError("exponent must be a constant")
            return _power(v, e, self.c.field.modulus)
        return v

    def _postfix(self) -> Value:
        v = self._primary()
        while self.p.peek() == "[":
            self.p.next()
            lo = self.p.parse_int_expr()
            if self.p.accept(".."):
                hi = self.p.parse_int_expr()
                self.p.expect("]")
                if not isinstance(v, list):
                    raise AirScriptError("cannot slice a scalar")
                v = v[lo:hi + 1]
            else:
                self.p.expect("]")
                if not isinstance(v, list):
                    raise AirScriptError("cannot index a scalar")
                v = v[lo]
        return v

    def _primary(self) -> Value:
        p = self.p
        t = p.next()
        if t == "(":
            v = self.parse_expr()
            p.expect(")")
            return v
        if t == "[":                                   # vector literal
            items: List[Value] = []
            if p.peek() != "]":
                while True:
                    if p.accept("..."):
                        spread = self.parse_expr()
                        if not isinstance(spread, list):
                            raise AirScriptError("spread of a non-vector")
                        items.extend(spread)
                    else:
                        items.append(self.parse_expr())
                    if not p.accept(","):
                        break
            p.expect("]")
            return items
        if t.startswith("$"):
            kind = t[1]
            ctor = TraceReg if kind == "r" else NextReg
            if len(t) > 2:                              # $r0, $n11
                return ctor(int(t[2:]))
            return [ctor(i) for i in range(self.c.trace_width)]
        if t.startswith("0x"):
            return int(t, 16)
        if t.isdigit():
            return int(t)
        # names: locals, consts, statics, inputs
        if t in self.env:
            return self.env[t]
        if t in self.c.consts:
            return self.c.consts[t]
        if t in self.c.statics:
            regs = self.c.statics[t].regs
            if len(regs) == 1:
                return StaticReg(regs[0])
            return [StaticReg(r) for r in regs]
        if t in self.c.inputs:
            regs = self.c.inputs[t].regs
            if len(regs) == 1:
                return StaticReg(regs[0])
            return [StaticReg(r) for r in regs]
        raise AirScriptError(f"unknown identifier {t!r}")


def compile_script(source: str, base_path: str = None) -> AirSchema:
    """Compile AirScript source text into an AirSchema
    (the reference's `instantiateScript`, the reference's index.ts:35-45).
    `base_path` resolves relative AirAssembly import paths."""
    return ScriptCompiler(source, base_path).compile()
