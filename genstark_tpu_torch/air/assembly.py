"""AirAssembly frontend: s-expression source -> AirSchema.

Counterpart of ``genstark_tpu/air/assembly.py`` (a copy whose imports point
at the port).  Covers the AirAssembly surface exercised by the reference
(its sources assembly/lib128.aa, lib224.aa, examples/elliptic/pointmul.aa
and the inline module of examples/mimc/mimc128Assembly.ts:28-51):

  (module (field prime p)
          (const $name scalar k | vector ... | matrix (row) (row) ...)*
          (function $name (result vector n) (param ...)* (local ...)*
                    (store.local ...)* result-expr)*
          (export Name (registers R) (constraints C) (steps S)
                  (static (input secret|public [(peerof i)|(childof i)]
                                 [(steps n)] [(shift k)] [(binary)])
                          (mask (input i))
                          (cycle v... | (prng sha256 0xSEED n) | (power b n)))
                  (init [(param $x vector n)] expr)
                  (transition [(local ...)]* [(store.local ...)]* expr)
                  (evaluation ...))*)

Elaboration is symbolic: every scalar position becomes an `ir.Expr` DAG node;
vectors/matrices are python lists of them.  Functions are macro-expanded at
call sites.  `(slice v a b)` bounds are INCLUSIVE (lib128.aa:31 slices 0..4 of
a 6-vector).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Union

from ..field import create_prime_field
from . import ir
from .ir import AirSchema, Const, CyclicRegister, InputRegister, MaskRegister


# ---------------------------------------------------------------------------
# s-expression reader
# ---------------------------------------------------------------------------

def tokenize(src: str) -> List[str]:
    out = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c == "#":
            while i < n and src[i] != "\n":
                i += 1
        elif c in "()":
            out.append(c)
            i += 1
        elif c.isspace():
            i += 1
        else:
            j = i
            while j < n and not src[j].isspace() and src[j] not in "()#":
                j += 1
            out.append(src[i:j])
            i = j
    return out


def parse_sexpr(tokens: List[str]):
    """Tokens -> nested lists of atoms (strings)."""
    pos = 0

    def read():
        nonlocal pos
        tok = tokens[pos]
        pos += 1
        if tok == "(":
            items = []
            while tokens[pos] != ")":
                items.append(read())
            pos += 1
            return items
        if tok == ")":
            raise SyntaxError("unexpected ')'")
        return tok

    items = []
    while pos < len(tokens):
        items.append(read())
    return items


def _int(atom: str) -> int:
    return int(atom, 16) if atom.startswith("0x") else int(atom)


# ---------------------------------------------------------------------------
# symbolic values: scalar Expr | vector (list) | matrix (list of lists)
# ---------------------------------------------------------------------------

Value = Union[ir.Expr, List[ir.Expr], List[List[ir.Expr]]]


def _is_vec(v) -> bool:
    return isinstance(v, list) and (not v or not isinstance(v[0], list))


def _is_mat(v) -> bool:
    return isinstance(v, list) and v and isinstance(v[0], list)


def _elementwise(op, a: Value, b: Value) -> Value:
    if isinstance(a, ir.Expr) and isinstance(b, ir.Expr):
        return op(a, b)
    if _is_vec(a) and isinstance(b, ir.Expr):
        return [op(x, b) for x in a]
    if isinstance(a, ir.Expr) and _is_vec(b):
        return [op(a, x) for x in b]
    if _is_vec(a) and _is_vec(b):
        if len(a) != len(b):
            raise ValueError(f"vector length mismatch: {len(a)} vs {len(b)}")
        return [op(x, y) for x, y in zip(a, b)]
    raise TypeError("unsupported operand shapes")


def _const_value(expr: ir.Expr) -> int:
    if isinstance(expr, Const):
        return expr.value
    raise ValueError("expected a compile-time constant")


@dataclass
class _Function:
    name: str
    params: List[tuple]          # (name, size|None) — None means scalar
    locals_: List[tuple]
    body: list                   # raw s-expr statements + result


class _Elaborator:
    """Expands one export's init/transition/evaluation into Expr DAGs."""

    def __init__(self, constants: Dict[str, Value], functions: Dict[str, _Function],
                 trace_width: int, static_count: int):
        self.constants = constants
        self.functions = functions
        self.trace_width = trace_width
        self.static_count = static_count

    def elaborate(self, stmts: list, env: Dict[str, Value], use_next: bool) -> Value:
        """Process a statement list: local decls, store.local, final expr."""
        locals_: Dict[Union[str, int], Value] = {}
        local_order: List[Union[str, int]] = []
        result = None
        for stmt in stmts:
            if isinstance(stmt, list) and stmt and stmt[0] == "local":
                # (local vector n) or (local $name vector n)
                name = stmt[1] if stmt[1].startswith("$") else len(local_order)
                local_order.append(name)
                locals_[name] = None
            elif isinstance(stmt, list) and stmt and stmt[0] == "store.local":
                target = stmt[1]
                key = target if target.startswith("$") else _int(target)
                if isinstance(key, int):
                    key = local_order[key] if key < len(local_order) else key
                locals_[key] = self.expr(stmt[2], env, locals_, use_next)
            else:
                result = self.expr(stmt, env, locals_, use_next)
        if result is None:
            raise ValueError("statement list has no result expression")
        return result

    def expr(self, node, env: Dict[str, Value], locals_: Dict, use_next: bool) -> Value:
        if isinstance(node, str):
            return Const(_int(node))
        op = node[0]
        sub = lambda i: self.expr(node[i], env, locals_, use_next)

        if op == "scalar":
            return Const(_int(node[1]))
        if op in ("add", "sub", "mul", "div"):
            fn = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
                  "mul": lambda a, b: a * b, "div": lambda a, b: a / b}[op]
            return _elementwise(fn, sub(1), sub(2))
        if op == "neg":
            a = sub(1)
            return [-x for x in a] if _is_vec(a) else -a
        if op == "exp":
            base = sub(1)
            e = _const_value(self.expr(node[2], env, locals_, use_next))
            if _is_vec(base):
                return [x ** e for x in base]
            return base ** e
        if op == "prod":
            return self._prod(sub(1), sub(2))
        if op == "get":
            vec = sub(1)
            return vec[_int(node[2])]
        if op == "slice":
            vec = sub(1)
            a, b = _int(node[2]), _int(node[3])
            return vec[a:b + 1]
        if op == "vector":
            out: List[ir.Expr] = []
            for item in node[1:]:
                v = self.expr(item, env, locals_, use_next)
                out.extend(v if _is_vec(v) else [v])
            return out
        if op == "load.const":
            return self.constants[node[1]]
        if op == "load.param":
            return env[node[1]]
        if op == "load.local":
            key = node[1] if node[1].startswith("$") else _int(node[1])
            if isinstance(key, int):
                # positional: resolve through insertion order
                names = [k for k in locals_.keys()]
                key = names[key]
            val = locals_[key]
            if val is None:
                raise ValueError(f"local {node[1]} used before store")
            return val
        if op == "load.trace":
            offset = _int(node[1])
            if offset == 0:
                return [ir.TraceReg(i) for i in range(self.trace_width)]
            if offset == 1:
                if not use_next:
                    raise ValueError("load.trace 1 is only valid in evaluation context")
                return [ir.NextReg(i) for i in range(self.trace_width)]
            raise ValueError(f"unsupported trace offset {offset}")
        if op == "load.static":
            if _int(node[1]) != 0:
                raise ValueError("only static bank 0 is supported")
            return [ir.StaticReg(i) for i in range(self.static_count)]
        if op == "call":
            fn = self.functions[node[1]]
            args = [self.expr(a, env, locals_, use_next) for a in node[2:]]
            if len(args) != len(fn.params):
                raise ValueError(f"function {fn.name}: arg count mismatch")
            fenv = {}
            for (pname, size), arg in zip(fn.params, args):
                if size is None and _is_vec(arg):
                    raise ValueError(f"function {fn.name}: scalar param got vector")
                fenv[pname] = arg
            return self.elaborate(fn.body, fenv, use_next)
        raise ValueError(f"unknown AirAssembly operation: {op}")

    def _prod(self, a: Value, b: Value) -> Value:
        def dot(u, v):
            acc = None
            for x, y in zip(u, v):
                term = x * y
                acc = term if acc is None else acc + term
            return acc
        if _is_mat(a) and _is_vec(b):
            return [dot(row, b) for row in a]
        if _is_mat(a) and _is_mat(b):
            cols = list(zip(*b))
            return [[dot(row, col) for col in cols] for row in a]
        if _is_vec(a) and _is_vec(b):
            return dot(a, b)
        raise TypeError("unsupported prod operands")


# ---------------------------------------------------------------------------
# module compilation
# ---------------------------------------------------------------------------

def _parse_const(items: list, field) -> Value:
    # (const $name scalar k | vector v... | matrix (row)...)
    body = items[2:] if items[1].startswith("$") else items[1:]
    kind = body[0]
    if kind == "scalar":
        return Const(_int(body[1]) % field.modulus)
    if kind == "vector":
        return [Const(_int(v) % field.modulus) for v in body[1:]]
    if kind == "matrix":
        return [[Const(_int(v) % field.modulus) for v in row] for row in body[1:]]
    raise ValueError(f"unknown const kind {kind}")


def _parse_function(items: list) -> _Function:
    name = items[1]
    params, locals_, body = [], [], []
    for item in items[2:]:
        if isinstance(item, list) and item[0] == "result":
            continue
        if isinstance(item, list) and item[0] == "param":
            size = None if item[2] == "scalar" else _int(item[3])
            params.append((item[1], size))
        elif isinstance(item, list) and item[0] == "local" and len(item) >= 3 \
                and item[1].startswith("$"):
            locals_.append((item[1], _int(item[3]) if len(item) > 3 else None))
            body.append(item)        # keep decl in body for ordering
        else:
            body.append(item)
    return _Function(name=name, params=params, locals_=locals_, body=body)


def _resolve_cycle_values(items: list, field) -> List[int]:
    if len(items) >= 2 and isinstance(items[1], list):
        spec = items[1]
        if spec[0] == "prng":
            if spec[1] != "sha256":
                raise ValueError("only sha256 prng cycles are supported")
            seed_hex = spec[2][2:] if spec[2].startswith("0x") else spec[2]
            if len(seed_hex) % 2:
                seed_hex = "0" + seed_hex
            return field.prng(bytes.fromhex(seed_hex), _int(spec[3]))
        if spec[0] == "power":
            base, count = _int(spec[1]), _int(spec[2])
            return [pow(base, i, field.modulus) for i in range(count)]
        raise ValueError(f"unknown cycle spec {spec[0]}")
    return [_int(v) % field.modulus for v in items[1:]]


def _parse_static_registers(items: list, field):
    regs = []
    for item in items[1:]:
        kind = item[0]
        if kind == "input":
            secret = item[1] == "secret"
            steps = shift = None
            parent = peer = None
            binary = False
            rank = 1
            for attr in item[2:]:
                if isinstance(attr, list):
                    if attr[0] == "steps":
                        steps = _int(attr[1])
                    elif attr[0] == "shift":
                        shift = _int(attr[1])
                    elif attr[0] == "childof":
                        parent = _int(attr[1])
                        rank = regs[parent].rank + 1
                    elif attr[0] == "peerof":
                        peer = _int(attr[1])
                        parent = regs[peer].parent
                        rank = regs[peer].rank
                    elif attr[0] == "binary":
                        binary = True
                elif attr == "binary":
                    binary = True
            regs.append(InputRegister(secret=secret, rank=rank, binary=binary,
                                      parent=parent, peer=peer, steps=steps,
                                      shift=shift or 0))
        elif kind == "mask":
            src = _int(item[1][1])
            inverted = len(item) > 2 and item[2] == "inverted"
            regs.append(MaskRegister(source=src, inverted=inverted))
        elif kind == "cycle":
            regs.append(CyclicRegister(_resolve_cycle_values(item, field)))
        else:
            raise ValueError(f"unknown static register kind {kind}")
    return regs


def compile_assembly(source: str, component: str = "default") -> AirSchema:
    """Compile AirAssembly source and instantiate the named export."""
    tree = parse_sexpr(tokenize(source))
    if len(tree) != 1 or tree[0][0] != "module":
        raise ValueError("expected a single (module ...) form")
    module = tree[0]

    field = None
    constants: Dict[str, Value] = {}
    functions: Dict[str, _Function] = {}
    exports: Dict[str, list] = {}
    for item in module[1:]:
        head = item[0]
        if head == "field":
            assert item[1] == "prime"
            field = create_prime_field(_int(item[2]))
        elif head == "const":
            constants[item[1]] = _parse_const(item, field)
        elif head == "function":
            fn = _parse_function(item)
            functions[fn.name] = fn
        elif head == "export":
            exports[item[1]] = item
        else:
            raise ValueError(f"unknown module element {head}")
    if field is None:
        raise ValueError("module has no field declaration")

    if component not in exports:
        if component == "default" and len(exports) == 1:
            component = next(iter(exports))
        else:
            raise ValueError(
                f"export {component!r} not found; available: {list(exports)}")
    exp = exports[component]

    registers = constraint_count = steps = None
    statics: list = []
    init_stmts = transition_stmts = evaluation_stmts = None
    seed_params = 0
    for item in exp[2:]:
        head = item[0]
        if head == "registers":
            registers = _int(item[1])
        elif head == "constraints":
            constraint_count = _int(item[1])
        elif head == "steps":
            steps = _int(item[1])
        elif head == "static":
            statics = _parse_static_registers(item, field)
        elif head == "init":
            body = item[1:]
            if body and isinstance(body[0], list) and body[0][0] == "param":
                seed_params = _int(body[0][3]) if body[0][2] == "vector" else 1
                body = body[1:]
            init_stmts = body
        elif head == "transition":
            transition_stmts = item[1:]
        elif head == "evaluation":
            evaluation_stmts = item[1:]
        else:
            raise ValueError(f"unknown export element {head}")

    elab = _Elaborator(constants, functions, registers, len(statics))

    seed_env = {}
    if seed_params:
        # the init param binds to the prover-supplied seed vector
        pname = exp_init_param_name(exp)
        seed_env[pname] = [ir.SeedVal(i) for i in range(seed_params)]

    def as_vector(v: Value, expected: int, what: str) -> List[ir.Expr]:
        vec = v if _is_vec(v) else [v]
        if len(vec) != expected:
            raise ValueError(f"{what} produced {len(vec)} values, expected {expected}")
        return vec

    init = as_vector(elab.elaborate(init_stmts, seed_env, use_next=False),
                     registers, "init") if init_stmts else \
        [Const(0)] * registers
    transition = as_vector(elab.elaborate(transition_stmts, {}, use_next=False),
                           registers, "transition")
    constraints = as_vector(elab.elaborate(evaluation_stmts, {}, use_next=True),
                            constraint_count, "evaluation")

    return AirSchema(field=field, trace_width=registers, static_registers=statics,
                     init=init, transition=transition, constraints=constraints,
                     base_steps=_effective_base_steps(steps, statics),
                     name=component)


def exp_init_param_name(exp: list) -> str:
    for item in exp[2:]:
        if item[0] == "init":
            for stmt in item[1:]:
                if isinstance(stmt, list) and stmt[0] == "param":
                    return stmt[1]
    raise ValueError("init has no param")


def _effective_base_steps(steps: int, statics: list) -> int:
    """Export (steps S) is the base cycle length; input registers may carry
    their own (steps n) equal to it."""
    return steps
