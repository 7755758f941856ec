"""A configuration's AIR, evaluated by the plain reference.

A configuration holds the AIR as data (`schema`), or names the module of
this package that builds it from its parameters (`reference_air`): the
trace width, the static registers (cyclic values, input registers with their span
rules, masks) and the constraints as a DAG of nodes, each
["const", v], ["trace", i], ["next", i], ["static", i], ["add"|"sub"|
"mul"|"div", a, b], ["neg", a] or ["exp", a, e], a and b earlier nodes.
A constraint's degree is max(1, its degree) with trace, next and static
registers of degree 1.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Sequence

from .field import Field


def schema_of(config: dict) -> dict:
    """The configuration's AIR as data: frozen in its file (`schema`), or
    built by the plain module of this package that `reference_air` names."""
    if "schema" in config:
        return config["schema"]
    return importlib.import_module(f"{__package__}.{config['reference_air']}").schema(config)


def nested_shape(values, rank: int) -> List[int]:
    if rank <= 1:
        return [len(values)]
    return [len(values)] + nested_shape(values[0], rank - 1)


def flatten(values, rank: int) -> List:
    if rank <= 1:
        return list(values)
    return [v for sub in values for v in flatten(sub, rank - 1)]


class Air:
    def __init__(self, schema: dict, modulus: int, base_steps: int):
        self.field = Field(modulus)
        self.schema = schema
        self.base_steps = base_steps
        self.trace_width = schema["trace_width"]
        self.registers = schema["static_registers"]
        self.inputs = [k for k, r in enumerate(self.registers) if r["kind"] == "input"]
        self.secret = [k for k in self.inputs if self.registers[k]["secret"]]
        self.secret_count = len(self.secret)
        nodes = schema["nodes"]
        degree: List[int] = []
        for n in nodes:
            op = n[0]
            if op in ("const", "seed"):
                degree.append(0)
            elif op in ("trace", "next", "static"):
                degree.append(1)
            elif op in ("add", "sub"):
                degree.append(max(degree[n[1]], degree[n[2]]))
            elif op == "mul":
                degree.append(degree[n[1]] + degree[n[2]])
            elif op in ("div", "neg"):
                degree.append(degree[n[1]])
            elif op == "exp":
                degree.append(degree[n[1]] * n[2])
            else:
                raise ValueError(f"unknown node {op}")
        self.degrees = [max(1, degree[c]) for c in schema["constraints"]]
        arity = {"add": 2, "sub": 2, "mul": 2, "div": 2, "neg": 1, "exp": 1}
        needed = set()
        stack = list(schema["constraints"])
        while stack:
            i = stack.pop()
            if i not in needed:
                needed.add(i)
                stack.extend(nodes[i][1:1 + arity.get(nodes[i][0], 0)])
        self.order = sorted(needed)      # children precede their parents

    def context(self, shapes: Sequence[Sequence[int]], public: Sequence) -> "Context":
        return Context(self, shapes, public)


class Context:
    """The trace length and static-register evaluators of one statement."""

    def __init__(self, air: Air, shapes, public):
        self.air = air
        f = air.field
        regs = air.registers
        if len(shapes) != len(air.inputs):
            raise ValueError("input shape count")
        shape = {k: list(shapes[slot]) for slot, k in enumerate(air.inputs)}
        children: Dict[int, List[int]] = {}
        for k in air.inputs:
            if len(shape[k]) != regs[k]["rank"]:
                raise ValueError(f"input register {k}: rank")
            if regs[k]["parent"] is not None:
                children.setdefault(regs[k]["parent"], []).append(k)
        spans: Dict[int, int] = {}

        def span(k: int) -> int:
            if k not in spans:
                r = regs[k]
                if r["steps"] is not None:
                    spans[k] = r["steps"]
                elif r["peer"] is not None:
                    spans[k] = span(r["peer"])
                elif children.get(k):
                    c0 = children[k][0]
                    spans[k] = shape[c0][-1] * span(c0)
                else:
                    spans[k] = air.base_steps
            return spans[k]

        lengths = set()
        counts = {}
        for k in air.inputs:
            counts[k] = 1
            for d in shape[k]:
                counts[k] *= d
            lengths.add(counts[k] * span(k))
        if len(lengths) > 1:
            raise ValueError("inconsistent input spans")
        T = lengths.pop() if lengths else air.base_steps
        self.trace_length = T

        public_regs = [k for k in air.inputs if not regs[k]["secret"]]
        if len(public) != len(public_regs):
            raise ValueError("public input count")
        self.evaluators = []
        secret_slot = 0
        p = f.p
        for k, r in enumerate(regs):
            if r["kind"] == "input" and r["secret"]:
                self.evaluators.append(("secret", secret_slot))
                secret_slot += 1
                continue
            if r["kind"] == "input":
                values = [int(v) % p for v in flatten(public[public_regs.index(k)], r["rank"])]
                if len(values) != counts[k]:
                    raise ValueError("public input length")
                column = [v for v in values for _ in range(span(k))]
                if r["shift"]:
                    s = (-r["shift"]) % T
                    column = column[s:] + column[:s]
                self.evaluators.append(("poly", (f.interpolate_roots(column), 1)))
                continue
            if r["kind"] == "cyclic":
                pattern = [v % p for v in r["values"]]
            else:                                             # mask
                src_span = span(r["source"])
                pattern = [0] * src_span
                pattern[regs[r["source"]]["shift"] % src_span] = 1
                if r["inverted"]:
                    pattern = [1 - v for v in pattern]
            coeffs = f.interpolate_roots(pattern) if len(pattern) > 1 else pattern
            self.evaluators.append(("poly", (coeffs, T // len(pattern))))

    def constraints_at(self, x: int, trace: List[int], nxt: List[int],
                       secret: List[int]) -> List[int]:
        f = self.air.field
        p = f.p
        static = [secret[arg] if kind == "secret" else f.eval_poly(arg[0], pow(x, arg[1], p))
                  for kind, arg in self.evaluators]
        nodes = self.air.schema["nodes"]
        val: Dict[int, int] = {}
        for i in self.air.order:
            op, *args = nodes[i]
            if op == "const":
                v = args[0] % p
            elif op == "trace":
                v = trace[args[0]]
            elif op == "next":
                v = nxt[args[0]]
            elif op == "static":
                v = static[args[0]]
            elif op == "add":
                v = (val[args[0]] + val[args[1]]) % p
            elif op == "sub":
                v = (val[args[0]] - val[args[1]]) % p
            elif op == "mul":
                v = val[args[0]] * val[args[1]] % p
            elif op == "div":
                v = val[args[0]] * f.inv(val[args[1]]) % p
            elif op == "neg":
                v = -val[args[0]] % p
            else:                                             # exp
                v = pow(val[args[0]], args[1], p)
            val[i] = v
        return [val[c] for c in self.air.schema["constraints"]]
