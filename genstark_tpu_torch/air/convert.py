"""Rebuild the port's AirSchema from a JAX-package AirSchema.

The port must not import ``genstark_tpu``, so this works by duck typing:
class names and attributes.  It carries over the field modulus, the
registers, init, transition, constraints and base steps, with the shared
sub-expressions of the DAG kept shared, so both packages prove the very
same AIR (for example one made by ``examples/mimc.py``).
"""

from __future__ import annotations

from typing import Dict

from ..field import create_prime_field
from . import ir

_LEAVES = {"Const": ("value",), "TraceReg": ("index",), "NextReg": ("index",),
           "StaticReg": ("index",), "SeedVal": ("index",)}
_BINARY = ("Add", "Sub", "Mul", "Div")


def expr_from_reference(e, cache: Dict[int, ir.Expr]) -> ir.Expr:
    key = id(e)
    if key in cache:
        return cache[key]
    name = type(e).__name__
    if name in _LEAVES:
        out = getattr(ir, name)(*(int(getattr(e, a)) for a in _LEAVES[name]))
    elif name in _BINARY:
        out = getattr(ir, name)(expr_from_reference(e.a, cache),
                                expr_from_reference(e.b, cache))
    elif name == "Neg":
        out = ir.Neg(expr_from_reference(e.a, cache))
    elif name == "Exp":
        out = ir.Exp(expr_from_reference(e.a, cache), int(e.e))
    else:
        raise TypeError(f"unknown expression node {name}")
    cache[key] = out
    return out


def register_from_reference(reg):
    name = type(reg).__name__
    if name == "CyclicRegister":
        return ir.CyclicRegister([int(v) for v in reg.values])
    if name == "InputRegister":
        return ir.InputRegister(secret=bool(reg.secret), rank=int(reg.rank),
                                binary=bool(reg.binary), parent=reg.parent,
                                peer=reg.peer, steps=reg.steps, shift=int(reg.shift))
    if name == "MaskRegister":
        return ir.MaskRegister(source=int(reg.source), inverted=bool(reg.inverted))
    raise TypeError(f"unknown static register {name}")


def schema_from_reference(obj) -> ir.AirSchema:
    """The port's AirSchema equal to a JAX-package AirSchema `obj`."""
    cache: Dict[int, ir.Expr] = {}
    conv = lambda exprs: [expr_from_reference(e, cache) for e in exprs]
    return ir.AirSchema(
        field=create_prime_field(int(obj.field.modulus)),
        trace_width=int(obj.trace_width),
        static_registers=[register_from_reference(r) for r in obj.static_registers],
        init=conv(obj.init),
        transition=conv(obj.transition),
        constraints=conv(obj.constraints),
        base_steps=int(obj.base_steps),
        name=str(obj.name),
    )
