"""The system under test: the port's Stark for a configuration, and the
calls the window makes.  This is the only module of the benchmark that
imports the port (`genstark_tpu_torch`), and it does so inside functions.
"""

from __future__ import annotations

from pathlib import Path

from . import statements

CONFIGS = Path(__file__).resolve().parent / "configs"


def _schema(config: dict, traffic: dict):
    """The configuration's frozen schema as the port's AirSchema."""
    from genstark_tpu_torch.air import ir
    from genstark_tpu_torch.field import create_prime_field

    s = config["schema"]
    built = []
    for n in s["nodes"]:
        op, args = n[0], n[1:]
        if op == "const":
            e = ir.Const(args[0])
        elif op in ("trace", "next", "static", "seed"):
            e = {"trace": ir.TraceReg, "next": ir.NextReg, "static": ir.StaticReg,
                 "seed": ir.SeedVal}[op](args[0])
        elif op == "exp":
            e = ir.Exp(built[args[0]], args[1])
        elif op == "neg":
            e = ir.Neg(built[args[0]])
        else:
            e = {"add": ir.Add, "sub": ir.Sub, "mul": ir.Mul, "div": ir.Div}[op](
                built[args[0]], built[args[1]])
        built.append(e)
    registers = []
    for r in s["static_registers"]:
        if r["kind"] == "cyclic":
            registers.append(ir.CyclicRegister(list(r["values"])))
        elif r["kind"] == "mask":
            registers.append(ir.MaskRegister(r["source"], r["inverted"]))
        else:
            registers.append(ir.InputRegister(
                secret=r["secret"], rank=r["rank"], binary=r["binary"], parent=r["parent"],
                peer=r["peer"], steps=r["steps"], shift=r["shift"]))
    return ir.AirSchema(
        field=create_prime_field(config["field"]["modulus"]), trace_width=s["trace_width"],
        static_registers=registers, init=[built[i] for i in s["init"]],
        transition=[built[i] for i in s["transition"]],
        constraints=[built[i] for i in s["constraints"]],
        base_steps=statements.module(config["statements"]).trace_steps(config, traffic),
        name=config["name"])


def build_stark(config: dict, traffic: dict, device: str, options: dict = None):
    """The port's Stark for the configuration, on `device`; `options`
    replaces the configuration's (the control's fewer queries)."""
    from genstark_tpu_torch import instantiate, instantiate_script

    options = dict(options or config["options"])
    program = config["program"]
    if program["build"] == "script":
        text = (CONFIGS / program["file"]).read_text()
        return instantiate_script(text, options, device=device)
    return instantiate(_schema(config, traffic), "default", options, device=device)


def assertions(statement):
    from genstark_tpu_torch.protocol import Assertion
    return [Assertion(step, register, value) for step, register, value in statement.assertions]


def prove(stark, statement, port_assertions) -> bytes:
    """One request: prove, then serialize; ends with the bytes on the host."""
    return stark.serialize(stark.prove(port_assertions, statement.inputs))


def verify(stark, statement, port_assertions, data: bytes) -> bool:
    return stark.verify(port_assertions, stark.parse(data), statement.public)
