"""The port's verifier (`Stark.parse` + `Stark.verify`, host-only) against the
JAX package's on the same proof bytes: port proofs of the pinned toy AIRs
are accepted by both, `parse(serialize(p))` round-trips in both to the same
proof fields, wrong assertions and every tampered section of a proof are
rejected by both with the same exception type.  Inputs come from fixed
seeds; every comparison is exact."""

import numpy as np
import pytest

from examples.mimc import make_mimc_stark as jax_make_mimc_stark
from examples.mimc import round_constants as jax_round_constants
from examples.mimc import run_mimc as jax_run_mimc
from examples.mimc_torch import DIVISORS, make_div_stark, make_mimc_stark, run_mimc
from genstark_tpu import instantiate as jax_instantiate
from genstark_tpu.air import AirSchema as JaxAirSchema
from genstark_tpu.air import CyclicRegister as JaxCyclicRegister
from genstark_tpu.air.ir import nxt as jnxt, seed as jseed, static as jstatic, trace as jtrace
from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu.protocol import Assertion as JaxAssertion
from genstark_tpu_torch.field import P32, P64, P128
from genstark_tpu_torch.protocol import Assertion, StarkError


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' many small ops run faster on one CPU thread, and
    do not fight the other test workers for cores."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


TOY = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}
# ext 16 at 64 steps: Ne = 1024, so the proof has one FRI component
FRI = {"extension_factor": 16, "exe_query_count": 8, "fri_query_count": 6}


def _jax_div_stark(steps):
    """The JAX package's twin of examples/mimc_torch.make_div_stark."""
    field = jax_field(P128)
    schema = JaxAirSchema(
        field=field, trace_width=1,
        static_registers=[JaxCyclicRegister(DIVISORS),
                          JaxCyclicRegister(jax_round_constants(field, 16))],
        init=[jseed(0)], transition=[jtrace(0) ** 3 + jstatic(1)],
        constraints=[(jnxt(0) * jstatic(0)) / jstatic(0) - (jtrace(0) ** 3 + jstatic(1))],
        base_steps=steps, name="mimc_div")
    return jax_instantiate(schema, options={"hash_algorithm": "blake2s256", **TOY})


# name: (port Stark and constants, JAX Stark, proves with a secret input)
CASES = {
    "p32": (lambda: make_mimc_stark(64, "cpu", modulus=P32, use_input=False,
                                    constant_count=16, options=TOY),
            lambda: jax_make_mimc_stark(64, modulus=P32, use_input=False,
                                        constant_count=16, options=TOY)[0], False),
    "p128": (lambda: make_mimc_stark(64, "cpu", modulus=P128, use_input=False,
                                     constant_count=32, options=TOY),
             lambda: jax_make_mimc_stark(64, modulus=P128, use_input=False,
                                         constant_count=32, options=TOY)[0], False),
    "p64_secret_input": (lambda: make_mimc_stark(64, "cpu", modulus=P64, options=TOY),
                         lambda: jax_make_mimc_stark(64, modulus=P64, options=TOY)[0], True),
    "division": (lambda: make_div_stark(64, "cpu"), lambda: _jax_div_stark(64), False),
    "p128_fri": (lambda: make_mimc_stark(64, "cpu", modulus=P128, options=FRI),
                 lambda: jax_make_mimc_stark(64, modulus=P128, options=FRI)[0], True),
}


def _prove(name):
    """(port Stark, JAX Stark, port assertions, JAX assertions, proof bytes)."""
    make_port, make_jax, use_input = CASES[name]
    stark, constants = make_port()
    controls = run_mimc(stark.air.field, 64, constants, 3)
    points = [(0, 0, controls[0]), (63, 0, controls[-1])]
    assertions = [Assertion(*a) for a in points]
    proof = (stark.prove(assertions, [[3]]) if use_input
             else stark.prove(assertions, [], [3]))
    return (stark, make_jax(), assertions, [JaxAssertion(*a) for a in points],
            stark.serialize(proof))


_proofs = {}


def _cached(name):
    if name not in _proofs:
        _proofs[name] = _prove(name)
    return _proofs[name]


def _fields(proof):
    """Every field of a StarkProof of either package, as plain values."""
    mp = lambda m: (tuple(m.values), tuple(tuple(c) for c in m.nodes), m.depth)
    ld = proof.ld_proof
    return (proof.ev_root, mp(proof.ev_proof), ld.lc_root, mp(ld.lc_proof),
            tuple((c.column_root, mp(c.column_proof), mp(c.poly_proof))
                  for c in ld.components),
            tuple(int(v) for v in ld.remainder), tuple(tuple(s) for s in proof.i_shapes))


@pytest.mark.parametrize("name", list(CASES))
def test_port_proof_accepted_by_both_and_round_trips(name):
    stark, jstark, assertions, jassertions, data = _cached(name)
    parsed, jparsed = stark.parse(data), jstark.parse(data)
    assert _fields(parsed) == _fields(jparsed)
    assert stark.serialize(parsed) == data == jstark.serialize(jparsed)
    assert stark.verify(assertions, parsed) is True
    assert jstark.verify(jassertions, jparsed) is True


@pytest.mark.parametrize("change", ["value", "step", "register"])
def test_wrong_assertion_rejected_by_both(change):
    stark, jstark, assertions, jassertions, data = _cached("p64_secret_input")
    step, register, value = assertions[-1].step, assertions[-1].register, assertions[-1].value
    bad = {"value": (step, register, value + 1), "step": (step - 1, register, value),
           "register": (step, register + 1, value)}[change]
    errors = []
    for st, make in ((stark, Assertion), (jstark, JaxAssertion)):
        with pytest.raises(Exception) as err:
            st.verify([make(*(a.step, a.register, a.value)) for a in assertions[:1]]
                      + [make(*bad)], st.parse(data))
        errors.append(err.value)
    assert type(errors[0]).__name__ == type(errors[1]).__name__
    if change != "register":
        assert isinstance(errors[0], StarkError)
    with pytest.raises(TypeError):
        stark.verify([], stark.parse(data))


def _flip(b: bytes, bit: int = 0) -> bytes:
    return bytes([b[0] ^ (1 << bit)]) + b[1:]


def _merkle_tampers(proof_of, tag):
    """One corruption per value and per node of a batch Merkle proof."""
    out = []
    proof = proof_of(None)
    for i in range(len(proof.values)):
        def t(p, i=i):
            m = proof_of(p)
            m.values[i] = _flip(m.values[i])
        out.append((f"{tag}.values[{i}]", t))
    for i, col in enumerate(proof.nodes):
        for j in range(len(col)):
            def t(p, i=i, j=j):
                m = proof_of(p)
                m.nodes[i][j] = _flip(m.nodes[i][j])
            out.append((f"{tag}.nodes[{i}][{j}]", t))
    return out


def _tampers(section, parsed):
    """[(label, mutate(proof))] for one section of a parsed proof."""
    ld = parsed.ld_proof
    if section == "ev_root":
        def t(p):
            p.ev_root = _flip(p.ev_root)
        return [("ev_root", t)]
    if section == "ev_proof":
        return _merkle_tampers(lambda p: (p or parsed).ev_proof, "ev_proof")
    if section == "lc_root":
        def t(p):
            p.ld_proof.lc_root = _flip(p.ld_proof.lc_root)
        return [("lc_root", t)]
    if section == "lc_proof":
        return _merkle_tampers(lambda p: (p or parsed).ld_proof.lc_proof, "lc_proof")
    if section == "fri_roots":
        out = []
        for k in range(len(ld.components)):
            def t(p, k=k):
                c = p.ld_proof.components[k]
                c.column_root = _flip(c.column_root)
            out.append((f"component[{k}].column_root", t))
        return out
    if section in ("fri_columns", "fri_polys"):
        attr = "column_proof" if section == "fri_columns" else "poly_proof"
        out = []
        for k in range(len(ld.components)):
            out += _merkle_tampers(
                lambda p, k=k: getattr((p or parsed).ld_proof.components[k], attr),
                f"component[{k}].{attr}")
        return out
    if section == "remainder":
        rng = np.random.default_rng(7)
        picks = sorted({0, len(ld.remainder) - 1,
                        *rng.integers(0, len(ld.remainder), 6).tolist()})
        out = []
        for i in picks:
            def t(p, i=i):
                p.ld_proof.remainder[i] ^= 1
            out.append((f"remainder[{i}]", t))
        return out
    if section == "i_shapes":
        out = []
        for shapes in ([[2]], [[1, 1]], []):
            def t(p, shapes=shapes):
                p.i_shapes = [list(s) for s in shapes]
            out.append((f"i_shapes={shapes}", t))
        return out
    raise ValueError(section)


SECTIONS = ["ev_root", "ev_proof", "lc_root", "lc_proof", "fri_roots", "fri_columns",
            "fri_polys", "remainder", "i_shapes", "buffer"]


@pytest.mark.parametrize("section", SECTIONS)
def test_tampered_proof_rejected_by_both(section):
    """Each corruption of one section of a port proof (p128, a secret input,
    one FRI component) is rejected by the port's parse + verify and by the
    JAX package's, with the same exception type."""
    stark, jstark, assertions, jassertions, data = _cached("p128_fri")
    if section == "buffer":
        tampered = [("truncated", data[:-1]), ("extended", data + b"\x00"),
                    ("header", data[:32] + b"\x01" + data[33:])]
    else:
        tampered = []
        for label, mutate in _tampers(section, stark.parse(data)):
            proof = stark.parse(data)
            mutate(proof)
            tampered.append((label, stark.serialize(proof)))
    assert tampered
    for label, buf in tampered:
        assert buf != data, label
        errors = []
        for st, asserts in ((stark, assertions), (jstark, jassertions)):
            try:
                st.verify(asserts, st.parse(buf))
            except Exception as err:  # noqa: BLE001 - the rejection under test
                errors.append(err)
            else:
                errors.append(None)
        assert errors[0] is not None, f"port accepted {label}"
        assert errors[1] is not None, f"JAX package accepted {label}"
        assert type(errors[0]).__name__ == type(errors[1]).__name__, (label, errors)


@pytest.mark.slow
def test_jax_proof_accepted_by_port():
    """A p32 proof made by the JAX package (the golden pin's AIR) parses and
    verifies with the port."""
    jstark, constants = jax_make_mimc_stark(64, modulus=P32, use_input=False,
                                            constant_count=16, options=TOY)
    controls = jax_run_mimc(jstark.air.field, 64, constants, 3)
    points = [(0, 0, controls[0]), (63, 0, controls[-1])]
    data = jstark.serialize(jstark.prove([JaxAssertion(*a) for a in points], [], [3]))
    stark, _ = make_mimc_stark(64, "cpu", modulus=P32, use_input=False, constant_count=16,
                               options=TOY)
    parsed = stark.parse(data)
    assert stark.serialize(parsed) == data
    assert stark.verify([Assertion(*a) for a in points], parsed)
