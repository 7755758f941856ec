"""The port's native trace generator (genstark_tpu_torch/native) against the
port's Python interpreter and the JAX package's native generator, bit for
bit (tolerance 0: integer field math), on the same AIR in both packages
(built with the JAX IR and converted) and the same numpy-seeded inputs.

Modelled on tests/test_native.py.  The AIR covers Div, Exp, Neg and SeedVal
nodes, a cyclic register, an input register held 4 steps a value with
shift -1, and a mask over it; the full-column entry of the generator is
held against the pattern-compressed one.  A codegen or build error raises;
only a missing compiler falls back to the interpreter.
"""

import numpy as np
import pytest

from genstark_tpu.air import ir as jir
from genstark_tpu.air.module import AirModule as JaxAirModule
from genstark_tpu_torch.air.convert import schema_from_reference
from genstark_tpu_torch.air.module import AirModule
from genstark_tpu_torch.field import P32, P64, P128, P224, P256
from genstark_tpu_torch.native import NativeCompileError, tracegen


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' many small ops run faster on one CPU thread, and
    do not fight the other test workers for cores."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


FIELDS = {"P32": P32, "P64": P64, "P128": P128, "P224": P224, "P256": P256}
STEPS = 64                      # 16 input values held 4 steps each


def _jax_schema(modulus: int, rng):
    """Two registers over a cyclic register (static 0), a public input held
    4 steps a value with shift -1 (static 1) and its mask (static 2)."""
    from genstark_tpu.field import create_prime_field
    t, s = jir.trace, jir.static
    transition = [
        t(0) ** 3 + s(0) * s(2),
        t(1) * t(0) - s(1) + s(0) / (t(1) + 1) - (-t(0)) + t(1) ** 5,
    ]
    return jir.AirSchema(
        field=create_prime_field(modulus), trace_width=2,
        static_registers=[jir.CyclicRegister([int(v) for v in rng.integers(0, 2 ** 62, 4)]),
                          jir.InputRegister(secret=False, steps=4, shift=-1),
                          jir.MaskRegister(source=1)],
        init=[jir.seed(0), s(1) + jir.seed(0) * 2],
        transition=transition,
        constraints=[jir.nxt(r) - transition[r] for r in range(2)],
        base_steps=4, name="native_mix")


def _case(name: str):
    modulus = FIELDS[name]
    rng = np.random.default_rng(modulus % 1000)
    jschema = _jax_schema(modulus, rng)
    inputs = [[int(v) % modulus for v in rng.integers(0, 2 ** 62, STEPS // 4)]]
    seed = [int(rng.integers(1, 2 ** 62))]
    return jschema, inputs, seed


@pytest.mark.parametrize("name", list(FIELDS))
def test_native_trace_equals_python_and_jax(name):
    jschema, inputs, seed = _case(name)
    ctx = AirModule(schema_from_reference(jschema)).init_proving_context(inputs, seed)
    native = ctx.generate_execution_trace_std()
    L = ctx.field.params.L
    assert ctx.trace_source == "native"
    assert native.dtype == np.uint32 and native.shape == (2, L, STEPS)
    assert np.array_equal(native, ctx._generate_trace_pyhost())
    jctx = JaxAirModule(jschema).init_proving_context(inputs, seed)
    jax_native = jctx._generate_trace_native()          # uint16 [R, L, T]
    assert jax_native is not None
    assert np.array_equal(native, jax_native.astype(np.uint32))
    # the full-column entry (no pattern compression) writes the same trace
    run = tracegen.native_trace_fn(ctx.schema.init, ctx.schema.transition,
                                   ctx.field.modulus, 1, 3)
    assert np.array_equal(run(ctx.static_columns, ctx.seed, STEPS), native)


@pytest.mark.parametrize("span,shift", [(1, 0), (4, 0), (4, -1), (8, 3)])
def test_native_statics_struct_matches_full_columns(span, shift):
    """The pattern-compressed statics stream (values, span, start_pos)
    gives the trace of the equivalent full column."""
    from genstark_tpu_torch.air.ir import seed as seedv, static, trace
    p, T = P128, 64
    rng = np.random.default_rng(11)
    vals = [int(v) for v in rng.integers(0, 2 ** 62, T // span)]
    expanded = [v for v in vals for _ in range(span)]
    s = (-shift) % T
    col = expanded[s:] + expanded[:s] if s else expanded   # col[t] = exp[(t - shift) % T]
    sd = [int(rng.integers(1, 2 ** 62))]
    run = tracegen.native_trace_fn([seedv(0)], [trace(0) * trace(0) + static(0)], p, 1, 1)
    assert np.array_equal(run([col], sd, T),
                          run(None, sd, T, statics_struct=[(vals, span, (-shift) % T)]))


def test_build_error_raises(monkeypatch):
    """A source the compiler refuses raises NativeCompileError: no fallback."""
    jschema, inputs, seed = _case("P64")
    ctx = AirModule(schema_from_reference(jschema)).init_proving_context(inputs, seed)
    monkeypatch.setattr(tracegen, "_generate_source",
                        lambda *args: "this is not C++ ;\n")
    with pytest.raises(NativeCompileError):
        ctx.generate_execution_trace_std()
    assert ctx.trace_source is None


def test_codegen_error_raises():
    """A seed value outside init is a codegen error: it raises."""
    from genstark_tpu_torch.air.ir import seed as seedv, trace
    with pytest.raises(ValueError, match="seed reference outside init"):
        tracegen.native_trace_fn([seedv(0)], [trace(0) + seedv(0)], P128, 1, 0)


def test_missing_compiler_falls_back(monkeypatch):
    """Only a missing compiler falls back to the Python interpreter."""
    jschema, inputs, seed = _case("P32")
    ctx = AirModule(schema_from_reference(jschema)).init_proving_context(inputs, seed)
    monkeypatch.setattr(tracegen, "CXX", "no-such-compiler-on-this-host")
    monkeypatch.setattr(tracegen, "_compile", tracegen._compile.__wrapped__)
    trace = ctx.generate_execution_trace_std()
    assert ctx.trace_source == "python"
    assert np.array_equal(trace, ctx._generate_trace_pyhost())


def test_prove_records_native_source():
    """Stark.prove's context records the generator that ran."""
    from examples.mimc_torch import make_mimc_stark, run_mimc
    from genstark_tpu_torch.protocol import Assertion
    stark, constants = make_mimc_stark(64, "cpu", options={
        "extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6})
    controls = run_mimc(stark.air.field, 64, constants, 3)
    stark.prove([Assertion(0, 0, controls[0]), Assertion(63, 0, controls[-1])], [[3]])
    assert stark.last_context.trace_source == "native"
    assert stark.last_context.trace_seconds > 0
