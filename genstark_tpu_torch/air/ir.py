"""AIR intermediate representation: expression DAG + register schema.

Counterpart of ``genstark_tpu/air/ir.py`` (a copy): the expression nodes,
degree inference, the device batch interpreter `eval_device` (it drives any
`dev` with the DeviceField surface, here the torch one), the host scalar
interpreter `eval_host` (verifier point checks), the host code generator for
trace generation, the static-register descriptors, `AirSchema` and
`substitute` (component inlining).  The AirScript (air/script.py) and
AirAssembly (air/assembly.py) compilers lower to this IR; `air/convert.py`
rebuilds a schema from a JAX-package schema.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

class Expr:
    """Base expression node.  Operators build DAG nodes; exponents must be
    python ints (AirAssembly requires static exponents)."""

    def __add__(self, other):  return Add(self, _wrap(other))
    def __radd__(self, other): return Add(_wrap(other), self)
    def __sub__(self, other):  return Sub(self, _wrap(other))
    def __rsub__(self, other): return Sub(_wrap(other), self)
    def __mul__(self, other):  return Mul(self, _wrap(other))
    def __rmul__(self, other): return Mul(_wrap(other), self)
    def __truediv__(self, other):  return Div(self, _wrap(other))
    def __rtruediv__(self, other): return Div(_wrap(other), self)
    def __pow__(self, e):      return Exp(self, int(e))
    def __neg__(self):         return Neg(self)


def _wrap(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, int):
        return Const(x)
    raise TypeError(f"cannot use {type(x)} in AIR expression")


@dataclass(frozen=True)
class Const(Expr):
    value: int


@dataclass(frozen=True)
class TraceReg(Expr):
    """Trace register value at the current step ($r<i>)."""
    index: int


@dataclass(frozen=True)
class NextReg(Expr):
    """Trace register value at the next step ($n<i>); constraints only."""
    index: int


@dataclass(frozen=True)
class StaticReg(Expr):
    """Static register value at the current step (cyclic/input/mask)."""
    index: int


@dataclass(frozen=True)
class SeedVal(Expr):
    """Init-time seed parameter (AirAssembly `(init (param ...))`)."""
    index: int


@dataclass(frozen=True)
class Add(Expr):
    a: Expr
    b: Expr


@dataclass(frozen=True)
class Sub(Expr):
    a: Expr
    b: Expr


@dataclass(frozen=True)
class Mul(Expr):
    a: Expr
    b: Expr


@dataclass(frozen=True)
class Div(Expr):
    a: Expr
    b: Expr


@dataclass(frozen=True)
class Neg(Expr):
    a: Expr


@dataclass(frozen=True)
class Exp(Expr):
    a: Expr
    e: int


# shorthand constructors for user-facing Python AIR definitions
def trace(i: int) -> Expr: return TraceReg(i)
def nxt(i: int) -> Expr: return NextReg(i)
def static(i: int) -> Expr: return StaticReg(i)
def seed(i: int) -> Expr: return SeedVal(i)
def const(v: int) -> Expr: return Const(v)


# ---------------------------------------------------------------------------
# Degree inference (mirrors air-assembly's per-constraint degree descriptors)
# ---------------------------------------------------------------------------

def degree_of(expr: Expr) -> int:
    if isinstance(expr, Const) or isinstance(expr, SeedVal):
        return 0
    if isinstance(expr, (TraceReg, NextReg, StaticReg)):
        return 1
    if isinstance(expr, (Add, Sub)):
        return max(degree_of(expr.a), degree_of(expr.b))
    if isinstance(expr, Mul):
        return degree_of(expr.a) + degree_of(expr.b)
    if isinstance(expr, Div):
        # division is only well-formed by (effectively) constant values
        return degree_of(expr.a)
    if isinstance(expr, Neg):
        return degree_of(expr.a)
    if isinstance(expr, Exp):
        return degree_of(expr.a) * expr.e
    raise TypeError(f"unknown expr node {type(expr)}")


# ---------------------------------------------------------------------------
# Interpreters
# ---------------------------------------------------------------------------

def eval_device(expr: Expr, env: Dict, cache: Optional[Dict] = None):
    """Batch evaluation over device limb arrays (Montgomery form).

    env keys: 'dev' (DeviceField), 'trace'/'next'/'static' (lists of
    [L, ...] arrays), 'seed' (list of arrays).  Subexpressions are cached by
    object identity so DAG sharing is preserved in the traced graph.
    """
    if cache is None:
        cache = {}
    key = id(expr)
    if key in cache:
        return cache[key]
    dev = env["dev"]
    if isinstance(expr, Const):
        r = dev.const(expr.value, shape=(1,) * env.get("ndim", 1))
    elif isinstance(expr, TraceReg):
        r = env["trace"][expr.index]
    elif isinstance(expr, NextReg):
        r = env["next"][expr.index]
    elif isinstance(expr, StaticReg):
        r = env["static"][expr.index]
    elif isinstance(expr, SeedVal):
        r = env["seed"][expr.index]
    elif isinstance(expr, Add):
        r = dev._add(eval_device(expr.a, env, cache), eval_device(expr.b, env, cache))
    elif isinstance(expr, Sub):
        r = dev._sub(eval_device(expr.a, env, cache), eval_device(expr.b, env, cache))
    elif isinstance(expr, Mul):
        r = dev.mont_mul(eval_device(expr.a, env, cache), eval_device(expr.b, env, cache))
    elif isinstance(expr, Div):
        b = expr.b
        if isinstance(b, Const):
            inv = pow(b.value, dev.p - 2, dev.p)
            r = dev.mont_mul(eval_device(expr.a, env, cache),
                             dev.const(inv, shape=(1,) * env.get("ndim", 1)))
        else:
            r = dev.mont_mul(eval_device(expr.a, env, cache),
                             dev.inv(eval_device(b, env, cache)))
    elif isinstance(expr, Neg):
        r = dev._neg(eval_device(expr.a, env, cache))
    elif isinstance(expr, Exp):
        r = dev._exp_static(eval_device(expr.a, env, cache), expr.e)
    else:
        raise TypeError(f"unknown expr node {type(expr)}")
    cache[key] = r
    return r


def eval_host(expr: Expr, env: Dict, cache: Optional[Dict] = None) -> int:
    """Scalar evaluation with python ints.  env keys: 'field' (HostField),
    'trace', 'next', 'static', 'seed' (lists of ints)."""
    if cache is None:
        cache = {}
    key = id(expr)
    if key in cache:
        return cache[key]
    f = env["field"]
    if isinstance(expr, Const):
        r = expr.value % f.p
    elif isinstance(expr, TraceReg):
        r = env["trace"][expr.index]
    elif isinstance(expr, NextReg):
        r = env["next"][expr.index]
    elif isinstance(expr, StaticReg):
        r = env["static"][expr.index]
    elif isinstance(expr, SeedVal):
        r = env["seed"][expr.index]
    elif isinstance(expr, Add):
        r = f.add(eval_host(expr.a, env, cache), eval_host(expr.b, env, cache))
    elif isinstance(expr, Sub):
        r = f.sub(eval_host(expr.a, env, cache), eval_host(expr.b, env, cache))
    elif isinstance(expr, Mul):
        r = f.mul(eval_host(expr.a, env, cache), eval_host(expr.b, env, cache))
    elif isinstance(expr, Div):
        r = f.div(eval_host(expr.a, env, cache), eval_host(expr.b, env, cache))
    elif isinstance(expr, Neg):
        r = f.neg(eval_host(expr.a, env, cache))
    elif isinstance(expr, Exp):
        r = f.exp(eval_host(expr.a, env, cache), expr.e)
    else:
        raise TypeError(f"unknown expr node {type(expr)}")
    cache[key] = r
    return r


def compile_host_fn(exprs: Sequence[Expr], p: int) -> Callable:
    """Code-generate a host evaluator `fn(trace, static, seed, next) -> list`
    over python ints mod p: the sequential per-step trace recurrence is
    scalar work for the host.  DAG-shared nodes are emitted once
    (common-subexpression order preserved)."""
    lines: List[str] = []
    names: Dict[int, str] = {}
    counter = [0]

    def emit(expr: Expr) -> str:
        key = id(expr)
        if key in names:
            return names[key]
        if isinstance(expr, Const):
            name = str(expr.value % p)
        elif isinstance(expr, TraceReg):
            name = f"trace[{expr.index}]"
        elif isinstance(expr, NextReg):
            name = f"next[{expr.index}]"
        elif isinstance(expr, StaticReg):
            name = f"static[{expr.index}]"
        elif isinstance(expr, SeedVal):
            name = f"seed[{expr.index}]"
        else:
            a = emit(expr.a) if hasattr(expr, "a") else None
            b = emit(expr.b) if hasattr(expr, "b") else None
            name = f"v{counter[0]}"
            counter[0] += 1
            if isinstance(expr, Add):
                lines.append(f"{name} = ({a} + {b}) % {p}")
            elif isinstance(expr, Sub):
                lines.append(f"{name} = ({a} - {b}) % {p}")
            elif isinstance(expr, Mul):
                lines.append(f"{name} = {a} * {b} % {p}")
            elif isinstance(expr, Div):
                lines.append(f"{name} = {a} * pow({b}, {p - 2}, {p}) % {p}")
            elif isinstance(expr, Neg):
                lines.append(f"{name} = (-{a}) % {p}")
            elif isinstance(expr, Exp):
                lines.append(f"{name} = pow({a}, {expr.e}, {p})")
            else:
                raise TypeError(f"unknown expr node {type(expr)}")
        names[key] = name
        return name

    outs = [emit(e) for e in exprs]
    src = "def _fn(trace, static, seed=None, next=None):\n"
    for line in lines:
        src += f"    {line}\n"
    src += f"    return [{', '.join(outs)}]\n"
    ns: Dict = {}
    exec(src, ns)          # noqa: S102 — source is generated from the AIR DAG only
    return ns["_fn"]


# ---------------------------------------------------------------------------
# Static register descriptors
# ---------------------------------------------------------------------------

@dataclass
class CyclicRegister:
    """Repeating pattern of values (AirAssembly `(cycle ...)`, AirScript
    `static k: cycle [...]`).  Period must be a power of 2."""
    values: List[int]


@dataclass
class InputRegister:
    """Input-driven register (AirAssembly `(input secret|public ...)`).

    Value span: a register with `steps` holds each value for that many trace
    steps; a register with children (others declaring `parent` = its index)
    holds each value for (child values per parent) * (child span) steps; a
    `peer` register shares the span and shape of its peer; otherwise the span
    is the schema's base cycle length.  `shift` rotates the expanded column
    (AirAssembly `(shift -1)` makes the next cycle's value visible one step
    early, which is how transitions re-init at cycle boundaries).  `binary`
    requires values in {0, 1}.  Rank-r inputs are nested lists flattened
    leaf-major; their iShape is the per-level dimension list.
    """
    secret: bool
    rank: int = 1
    binary: bool = False
    parent: Optional[int] = None
    peer: Optional[int] = None
    steps: Optional[int] = None
    shift: int = 0


@dataclass
class MaskRegister:
    """1 at the first step of each cycle of the source input register, else 0
    (AirAssembly `(mask (input i))`); `inverted` flips it."""
    source: int
    inverted: bool = False


StaticRegisterDef = Union[CyclicRegister, InputRegister, MaskRegister]


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

@dataclass
class AirSchema:
    """A complete AIR: the analogue of an instantiated air-assembly
    module (minus the proving/verification contexts, built by AirModule)."""

    field: "PrimeField"
    trace_width: int
    static_registers: List[StaticRegisterDef]
    init: List[Expr]              # over SeedVal/StaticReg/TraceReg(prev state)
    transition: List[Expr]        # over TraceReg/StaticReg -> next state
    constraints: List[Expr]       # over TraceReg/NextReg/StaticReg
    base_steps: int               # steps per input cycle / trace length sans inputs
    name: str = "default"

    def __post_init__(self):
        if len(self.transition) != self.trace_width:
            raise ValueError("transition must yield one expression per register")
        if len(self.init) != self.trace_width:
            raise ValueError("init must yield one expression per register")
        if self.base_steps < 1 or self.base_steps & (self.base_steps - 1):
            # cycle length 1 is legal: e.g. pointmul.aa holds each input bit
            # for a single step (the reference's elliptic pointmul.aa)
            raise ValueError("base_steps must be a power of 2 >= 1")
        for reg in self.static_registers:
            if isinstance(reg, CyclicRegister):
                n = len(reg.values)
                if n < 1 or n & (n - 1):
                    raise ValueError("cyclic register length must be a power of 2")

    @property
    def constraint_degrees(self) -> List[int]:
        return [max(1, degree_of(c)) for c in self.constraints]

    @property
    def max_constraint_degree(self) -> int:
        return max(self.constraint_degrees)

    @property
    def input_registers(self) -> List[int]:
        return [i for i, r in enumerate(self.static_registers)
                if isinstance(r, InputRegister)]

    @property
    def secret_input_registers(self) -> List[int]:
        return [i for i, r in enumerate(self.static_registers)
                if isinstance(r, InputRegister) and r.secret]

    @property
    def secret_input_count(self) -> int:
        return len(self.secret_input_registers)


def substitute(expr: Expr, trace_map: Optional[Dict[int, Expr]] = None,
               static_map: Optional[Dict[int, Expr]] = None,
               cache: Optional[Dict] = None) -> Expr:
    """Rewrite an expression DAG, replacing TraceReg/StaticReg leaves by
    index.  Used to inline AirAssembly components into AirScript programs
    (`with $r[a..b] yield Component(...)`): the component's trace registers
    map to the caller's target registers and its static registers map to
    caller statics or argument expressions.  Unmapped leaves pass through;
    DAG sharing is preserved via the cache."""
    if cache is None:
        cache = {}
    key = id(expr)
    if key in cache:
        return cache[key]
    if isinstance(expr, TraceReg) and trace_map and expr.index in trace_map:
        r = trace_map[expr.index]
    elif isinstance(expr, StaticReg) and static_map and expr.index in static_map:
        r = static_map[expr.index]
    elif isinstance(expr, (Const, TraceReg, NextReg, StaticReg, SeedVal)):
        r = expr
    elif isinstance(expr, (Add, Sub, Mul, Div)):
        r = type(expr)(substitute(expr.a, trace_map, static_map, cache),
                       substitute(expr.b, trace_map, static_map, cache))
    elif isinstance(expr, Neg):
        r = Neg(substitute(expr.a, trace_map, static_map, cache))
    elif isinstance(expr, Exp):
        r = Exp(substitute(expr.a, trace_map, static_map, cache), expr.e)
    else:
        raise TypeError(f"unknown expr node {type(expr)}")
    cache[key] = r
    return r
