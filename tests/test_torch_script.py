"""The port's AIR front end (air/script.py, air/assembly.py, stdlib/) against
the JAX package's: the same AirScript and AirAssembly sources compile to
equal schemas (the JAX schema rebuilt with air.convert, the expression DAGs
compared node for node with their sharing), give equal host traces, and at
toy depth and toy options the port's proofs of the three Merkle examples
are accepted by both verifiers.  Every comparison is exact.

The `slow` tests recompute the pins of the reference's Merkle
configurations with the port on the CPU and hold them equal to a JAX prove.
"""

import hashlib
import inspect
import sys

import numpy as np
import pytest

from examples import merkle_import as jax_merkle_import
from examples import elliptic_torch, merkle_import_torch, poseidon_torch, rescue_torch
from examples.mimc import MIMC_SCRIPT
from genstark_tpu import instantiate as jax_instantiate
from genstark_tpu import instantiate_script as jax_instantiate_script
from genstark_tpu.air.assembly import compile_assembly as jax_compile_assembly
from genstark_tpu.air.module import AirModule as JaxAirModule
from genstark_tpu.air.script import compile_script as jax_compile_script
from genstark_tpu.protocol import Assertion as JaxAssertion
from genstark_tpu.stdlib import lib128_source as jax_lib128_source
from genstark_tpu_torch import instantiate, instantiate_script
from genstark_tpu_torch.air.assembly import compile_assembly
from genstark_tpu_torch.air.convert import schema_from_reference
from genstark_tpu_torch.air.module import AirModule
from genstark_tpu_torch.air.script import compile_script
from genstark_tpu_torch.stdlib import lib128_source, lib224_source, pointmul_source
from genstark_tpu_torch.testing import LIB224_PIN, POINTMUL_PIN, POSEIDON16_PIN, RESCUE16_PIN
from test_nested_inputs import TOY_AA


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' many small ops run faster on one CPU thread, and
    do not fight the other test workers for cores."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


TOY_16 = {"hash_algorithm": "blake2s256", "extension_factor": 16,
          "exe_query_count": 8, "fri_query_count": 6}
TOY_32 = dict(TOY_16, extension_factor=32)


def _rescue_hash_source(width):
    field, rescue, _, _, rc = rescue_torch.make_rescue(width)
    from examples.rescue_utils import invert_matrix
    modulus = "2^64 - 21 * 2^30 + 1" if width == 2 else "2^128 - 9 * 2^32 + 1"
    return rescue_torch.hash_source(width, modulus, rescue.alpha, -rescue.inv_alpha,
                                    rescue.mds, invert_matrix(field.host, rescue.mds), rc)


def _rescue_merkle_source():
    field, rescue, _, _, rc = rescue_torch.make_rescue(4)
    from examples.rescue_utils import invert_matrix
    return rescue_torch.merkle_source(rescue.alpha, -rescue.inv_alpha, rescue.mds,
                                      invert_matrix(field.host, rescue.mds), rc)


SCRIPTS = {
    "mimc": lambda: MIMC_SCRIPT.format(last=255),
    "rescue_2x64": lambda: _rescue_hash_source(2),
    "rescue_4x128": lambda: _rescue_hash_source(4),
    "rescue_merkle": _rescue_merkle_source,
    "poseidon_3x128": lambda: poseidon_torch.hash_source(3, *poseidon_torch.poseidon_params(3)[1:]),
    "poseidon_merkle": lambda: poseidon_torch.merkle_source(*poseidon_torch.poseidon_params(6)[1:]),
    "lib224_merkle_proof": lambda: merkle_import_torch.MERKLE_PROOF_SRC,
    "lib224_merkle_update": lambda: merkle_import_torch.MERKLE_UPDATE_SRC,
}
ASSEMBLY = {
    "nested_inputs": (lambda: TOY_AA, "toy"),
    "lib128_merkle_root": (lib128_source, "ComputeMerkleRoot"),
    "lib128_merkle_update": (lib128_source, "ComputeMerkleUpdate"),
    "lib224_poseidon_hash": (lib224_source, "ComputePoseidonHash"),
    "lib224_schnorr": (lib224_source, "VerifySchnorrSignature"),
    "pointmul": (pointmul_source, "default"),
}


def _same_dag(xs, ys) -> bool:
    """Node-for-node equality of two expression lists of either package,
    with the same sharing (a bijection between the two DAGs' nodes)."""
    pair, rev = {}, {}

    def eq(a, b):
        if id(a) in pair or id(b) in rev:
            return pair.get(id(a)) == id(b)
        name = type(a).__name__
        if name != type(b).__name__:
            return False
        if name == "Const":
            ok = a.value == b.value
        elif name in ("TraceReg", "NextReg", "StaticReg", "SeedVal"):
            ok = a.index == b.index
        elif name == "Exp":
            ok = a.e == b.e and eq(a.a, b.a)
        elif name == "Neg":
            ok = eq(a.a, b.a)
        else:
            ok = eq(a.a, b.a) and eq(a.b, b.b)
        pair[id(a)], rev[id(b)] = id(b), id(a)
        return ok

    return len(xs) == len(ys) and all(eq(x, y) for x, y in zip(xs, ys))


def _assert_same_schema(port, jax_schema):
    conv = schema_from_reference(jax_schema)
    assert port.field.modulus == conv.field.modulus
    assert (port.trace_width, port.base_steps, port.name) == \
        (conv.trace_width, conv.base_steps, conv.name)
    assert port.static_registers == conv.static_registers
    assert port.constraint_degrees == jax_schema.constraint_degrees
    for part in ("init", "transition", "constraints"):
        assert _same_dag(getattr(port, part), getattr(jax_schema, part)), part


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_airscript_schema_equals_jax(name):
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))
    src = SCRIPTS[name]()
    _assert_same_schema(compile_script(src), jax_compile_script(src))


@pytest.mark.parametrize("name", list(ASSEMBLY))
def test_airassembly_schema_equals_jax(name):
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))
    source, component = ASSEMBLY[name]
    src = source()
    if source is lib128_source:
        assert src == jax_lib128_source()        # the stdlib emits the same text
    _assert_same_schema(compile_assembly(src, component), jax_compile_assembly(src, component))


def _trace_pair(port_schema, jax_schema, inputs):
    """(port native trace u32 [R, L, T], JAX native trace widened)."""
    ctx = AirModule(port_schema).init_proving_context(inputs)
    port = ctx.generate_execution_trace_std()
    assert ctx.trace_source == "native"
    jax = JaxAirModule(jax_schema).init_proving_context(inputs).generate_execution_trace_u16()
    return port, jax.astype(np.uint32), ctx


def _column_ints(trace, register):
    L = trace.shape[1]
    return [sum(int(trace[register, i, t]) << (16 * i) for i in range(L))
            for t in range(trace.shape[2])]


def test_rescue_2x64_trace_equals_jax_and_documented_value():
    _, assertions, inputs = rescue_torch.hash_case(2, 42, None, "cpu")
    src = _rescue_hash_source(2)
    port, jax, _ = _trace_pair(compile_script(src), jax_compile_script(src), inputs)
    assert np.array_equal(port, jax)
    assert _column_ints(port, 0)[31] == 14354339131598895532    # hash2x64.ts:100-106
    assert assertions[0].value == 14354339131598895532


def test_poseidon_3x128_trace_equals_jax_and_oracle():
    _, assertions, inputs = poseidon_torch.hash_case(3, None, "cpu")
    src = SCRIPTS["poseidon_3x128"]()
    port, jax, _ = _trace_pair(compile_script(src), jax_compile_script(src), inputs)
    assert np.array_equal(port, jax)
    assert [_column_ints(port, r)[63] for r in (0, 1)] == [a.value for a in assertions]


def test_nested_inputs_trace_equals_jax():
    inputs = [[3, 5], [[1, 2, 3, 4], [5, 6, 7, 8]]]
    port, jax, ctx = _trace_pair(compile_assembly(TOY_AA, "toy"),
                                 jax_compile_assembly(TOY_AA, "toy"), inputs)
    assert np.array_equal(port, jax)
    assert np.array_equal(port, ctx._generate_trace_pyhost())


def test_lib224_import_trace_equals_jax():
    stark, assertions, inputs, _ = merkle_import_torch.merkle_proof_case(2, 1, TOY_32, "cpu")
    src = merkle_import_torch.MERKLE_PROOF_SRC
    port, jax, ctx = _trace_pair(compile_script(src), jax_compile_script(src), inputs)
    assert np.array_equal(port, jax)
    assert np.array_equal(port, ctx._generate_trace_pyhost())
    assert _column_ints(port, 0)[-1] == assertions[0].value


def test_import_resolution_reads_nothing_beside_the_checkout(tmp_path, monkeypatch):
    """lib128.aa / lib224.aa resolve to the port's stdlib under any
    directory name: a stray `../assembly/lib224.aa` beside the working
    directory or `base_path` is never read.  Any other import resolves
    against `base_path` only, never against the working directory."""
    from genstark_tpu_torch.air.script import AirScriptError
    src = merkle_import_torch.MERKLE_PROOF_SRC
    want = compile_script(src)
    work = tmp_path / "work"
    work.mkdir()
    (tmp_path / "assembly").mkdir()
    (tmp_path / "assembly" / "lib224.aa").write_text("not AirAssembly")
    monkeypatch.chdir(work)

    def same(schema):
        assert schema.static_registers == want.static_registers
        for part in ("init", "transition", "constraints"):
            assert _same_dag(getattr(schema, part), getattr(want, part)), part

    same(compile_script(src))
    same(compile_script(src, str(work)))
    (work / "mylib.aa").write_text(lib224_source())
    local = src.replace("'../assembly/lib224.aa'", "'mylib.aa'")
    with pytest.raises(AirScriptError, match="cannot resolve"):
        compile_script(local)
    same(compile_script(local, str(work)))


def _jax_stark(name):
    if name == "pointmul":
        from genstark_tpu.stdlib import pointmul_source as jax_pointmul_source
        return jax_instantiate(jax_pointmul_source(), "default", dict(TOY_16))
    if name == "rescue":
        return jax_instantiate_script(_rescue_merkle_source(), dict(TOY_16))
    if name == "poseidon":
        return jax_instantiate_script(SCRIPTS["poseidon_merkle"](), dict(TOY_32))
    return jax_instantiate_script(jax_merkle_import.MERKLE_PROOF_SRC, dict(TOY_32))


MERKLE = {"rescue": lambda: rescue_torch.merkle_case(2, 1, TOY_16, "cpu"),
          "poseidon": lambda: poseidon_torch.merkle_case(2, 1, TOY_32, "cpu"),
          "lib224_import": lambda: merkle_import_torch.merkle_proof_case(2, 1, TOY_32, "cpu")}


def test_pointmul_proof_accepted_by_both():
    """The elliptic-curve point multiplication (constraints that divide by
    registers) at its 256 steps and toy options: the port's proof verifies
    in the port and in the JAX package."""
    stark, assertions, inputs = elliptic_torch.pointmul_case(TOY_16, "cpu")
    data = stark.serialize(stark.prove(assertions, inputs))
    assert stark.last_context.trace_source == "native"
    jassertions = [JaxAssertion(a.step, a.register, a.value) for a in assertions]
    assert stark.verify(assertions, stark.parse(data))
    jstark = _jax_stark("pointmul")
    assert jstark.verify(jassertions, jstark.parse(data))


@pytest.mark.parametrize("name", list(MERKLE))
def test_merkle_example_proof_accepted_by_both(name):
    """Depth 2, toy options: the port's proof (native trace, public index
    bits, nested inputs) verifies in the port and in the JAX package, and
    with wrong public inputs in neither."""
    stark, assertions, inputs, public = MERKLE[name]()
    data = stark.serialize(stark.prove(assertions, inputs))
    assert stark.last_context.trace_source == "native"
    jstark = _jax_stark(name)
    jassertions = [JaxAssertion(a.step, a.register, a.value) for a in assertions]
    assert stark.verify(assertions, stark.parse(data), public)
    assert jstark.verify(jassertions, jstark.parse(data), public)
    wrong = [[[1 - b for b in public[0][0]]]]
    for st, asserts in ((stark, assertions), (jstark, jassertions)):
        with pytest.raises(Exception, match="Verification"):
            st.verify(asserts, st.parse(data), wrong)


def test_instantiate_sources_and_default_device(tmp_path):
    """instantiate / instantiate_script take text, bytes or a path, and
    put the Stark on the CUDA card unless asked for another device."""
    stark = instantiate(lib224_source(), "ComputePoseidonHash", TOY_32, device="cpu")
    assert stark.dev.device.type == "cpu" and stark.air.trace_register_count == 3
    path = tmp_path / "mimc.air"
    path.write_text(MIMC_SCRIPT.format(last=63))
    for source in (str(path), path.read_bytes()):
        assert instantiate_script(source, TOY_16, device="cpu").air.schema.base_steps == 64
    for fn in (instantiate, instantiate_script):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def _pin(data):
    return len(data), hashlib.sha256(data).hexdigest()


# (pin, the port's case, the JAX source, its options)
SLOW_PINS = {
    "rescue16": (RESCUE16_PIN, lambda: rescue_torch.branch_case(16, 42, None, "cpu"),
                 _rescue_merkle_source, rescue_torch.MERKLE_OPTIONS),
    "poseidon16": (POSEIDON16_PIN, lambda: poseidon_torch.branch_case(16, 42, None, "cpu"),
                   SCRIPTS["poseidon_merkle"], poseidon_torch.MERKLE_OPTIONS),
    "lib224_8": (LIB224_PIN, lambda: merkle_import_torch.merkle_proof_case(8, 42, None, "cpu"),
                 lambda: jax_merkle_import.MERKLE_PROOF_SRC, merkle_import_torch.OPTIONS),
}


@pytest.mark.slow
def test_pointmul_pin():
    """POINTMUL_PIN: the port's proof at the published options on
    the CPU, equal to the JAX package's, verified by both."""
    from genstark_tpu.stdlib import pointmul_source as jax_pointmul_source
    stark, assertions, inputs = elliptic_torch.pointmul_case(None, "cpu")
    data = stark.serialize(stark.prove(assertions, inputs))
    assert _pin(data) == POINTMUL_PIN
    jstark = jax_instantiate(jax_pointmul_source(), "default",
                             dict(elliptic_torch.DEFAULT_OPTIONS))
    jassertions = [JaxAssertion(a.step, a.register, a.value) for a in assertions]
    assert jstark.serialize(jstark.prove(jassertions, inputs)) == data
    assert stark.verify(assertions, stark.parse(data))
    assert jstark.verify(jassertions, jstark.parse(data))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SLOW_PINS))
def test_reference_merkle_pins(name):
    """The pins of the reference's Merkle configurations: the
    port's proof on the CPU, equal to the JAX package's proof (minutes of
    XLA:CPU compile each), verified by both."""
    pin, case, source, options = SLOW_PINS[name]
    stark, assertions, inputs, public = case()
    data = stark.serialize(stark.prove(assertions, inputs))
    assert _pin(data) == pin
    jstark = jax_instantiate_script(source(), dict(options))
    jassertions = [JaxAssertion(a.step, a.register, a.value) for a in assertions]
    assert jstark.serialize(jstark.prove(jassertions, inputs)) == data
    assert stark.verify(assertions, stark.parse(data), public)
    assert jstark.verify(jassertions, jstark.parse(data), public)
