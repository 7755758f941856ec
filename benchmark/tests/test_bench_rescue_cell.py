"""The Rescue Merkle-branch cell at toy size on the CPU: the frozen AirScript
and `rescue` section against the port's example, the port's compile against
the plain reference AIR, the port's trace against the reference's
constraints, the statements' roots against the example's hash, the cell
through the port, the reference and a whole run, and the control and the
faults rejected.  Marked `cuda`: one short run of the cell on the card."""

import json
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import control, program, run, statements
from benchmark.reference.air import Air, schema_of
from benchmark.reference.verifier import verify as reference_verify
from benchmark.tests.conftest import toy_cell
from benchmark.tests.test_bench_control import _altered, _stale
from examples.rescue_torch import (MERKLE_OPTIONS, STEPS, make_rescue, merkle_source,
                                   to_binary_array)
from examples.rescue_utils import MerkleTree, invert_matrix, make_hash_function
from genstark_tpu_torch.air.ir import compile_host_fn
from genstark_tpu_torch.field import P128

ROOT = Path(__file__).resolve().parents[2]
CELL = "rescue-merkle-d16"


def family():
    return statements.module("rescue_branch")


def test_frozen_source_and_parameters_are_the_examples():
    c = toy_cell(CELL)
    field, rescue, key_states, _, round_constants = make_rescue(4)
    inv_mds = invert_matrix(field.host, rescue.mds)
    text = (program.CONFIGS / c.config["program"]["file"]).read_text()
    assert text == merkle_source(rescue.alpha, -rescue.inv_alpha, rescue.mds, inv_mds,
                                 round_constants)
    r = c.config["rescue"]
    assert (r["width"], r["alpha"], r["inv_alpha"], r["steps_per_level"]) == \
        (4, rescue.alpha, rescue.inv_alpha, STEPS)
    assert (r["mds"], r["inv_mds"]) == (rescue.mds, inv_mds)
    assert (r["round_constants"], r["key_states"]) == (round_constants, key_states)
    assert c.config["field"]["modulus"] == P128 == field.modulus
    assert c.config["options"] == MERKLE_OPTIONS
    assert c.config["reduced"] == [] and c.traffic["depth"] == 2


def _reference_fn(nodes, constraints, p):
    """fn(trace, static, next) over the reference's DAG at one row."""
    def fn(trace, static, nxt):
        val = []
        for op, *args in nodes:
            if op == "const":
                v = args[0]
            elif op in ("trace", "next", "static"):
                v = {"trace": trace, "next": nxt, "static": static}[op][args[0]]
            elif op == "exp":
                v = pow(val[args[0]], args[1], p)
            else:
                a, b = val[args[0]], val[args[1]]
                v = {"add": a + b, "sub": a - b, "mul": a * b}[op]
            val.append(v % p)
        return [val[i] for i in constraints]
    return fn


def test_compile_is_the_reference_air():
    """The AirScript source compiled by the port has the reference's static
    registers and, tree for tree and at seeded random rows, its constraints."""
    c = toy_cell(CELL)
    compiled = program.build_stark(c.config, c.traffic, "cpu").air.schema
    built = schema_of(c.config)
    plain = program._schema(dict(c.config, schema=dict(built, init=[0] * 8,
                                                        transition=[0] * 8)), c.traffic)
    assert compiled.static_registers == plain.static_registers
    assert compiled.constraints == plain.constraints
    assert compiled.base_steps == plain.base_steps == built["base_steps"]
    port = compile_host_fn(compiled.constraints, P128)
    ref = _reference_fn(built["nodes"], built["constraints"], P128)
    rng = random.Random(2 ** 33 + 5)
    for _ in range(8):
        trace, nxt = ([rng.randrange(P128) for _ in range(8)] for _ in range(2))
        static = [rng.randrange(P128) for _ in range(14)]
        assert port(trace, static, [], nxt) == ref(trace, static, nxt)


def test_port_trace_satisfies_the_reference_constraints():
    """The port's trace of a depth-2 statement meets every reference
    constraint at every step (the last one's next row is the first)."""
    c = toy_cell(CELL)
    st = family().make(c.config, c.traffic, 2 ** 40 + 7, 3)
    stark = program.build_stark(c.config, c.traffic, "cpu")
    ctx = stark.air.init_proving_context(st.inputs)
    T = ctx.trace_length
    rows = [[ctx.trace_value_host(r, t) for r in range(8)] for t in range(T)]
    air = Air(schema_of(c.config), P128, family().trace_steps(c.config, c.traffic))
    ref = air.context(st.shapes, st.public)
    w = air.field.root_of_unity(T)
    leaf, siblings = st.inputs[0][0], st.inputs[1][0]
    span = family().trace_steps(c.config, c.traffic)
    for t in range(T):
        at = (t + 1) % T                 # input registers start one step early
        secret = [leaf, siblings[at // span]]
        assert ref.constraints_at(pow(w, t, P128), rows[t], rows[(t + 1) % T], secret) == [0] * 8
    assert rows[T - 1][0] == st.assertions[0][2]


@pytest.mark.parametrize("seed", [1, 2 ** 40 + 3, 4294967311])
def test_roots_are_the_examples_hash(seed):
    c = toy_cell(CELL)
    field, rescue, key_states, _, _ = make_rescue(4)
    oracle = make_hash_function(rescue, key_states)
    for depth in (2, 5):
        for index in range(3):
            st = family().make(c.config, dict(c.traffic, depth=depth), seed, index)
            bits = st.public[0][0]
            assert st.inputs[2] == [bits] and st.shapes == [[1], [1, depth], [1, depth]]
            position = sum(b << (i - 1) for i, b in enumerate(bits) if i)
            assert position < 2 ** (depth - 1)
            assert bits == [0] + to_binary_array(position, depth)[:-1]
            branch = [st.inputs[0][0]] + st.inputs[1][0]
            assert MerkleTree.verify(st.assertions[0][2], position, branch, oracle)
            assert st.assertions[0][:2] == (STEPS * depth - 1, 0)


def test_statements_depend_on_seed_and_index():
    c = toy_cell(CELL)
    make = family().make
    leaves = {make(c.config, c.traffic, s, i).inputs[0][0] for s in (1, 2 ** 33) for i in (0, 1)}
    assert len(leaves) == 4
    assert make(c.config, c.traffic, 7, 1) == make(c.config, c.traffic, 7, 1)


def test_port_proof_is_accepted_by_the_reference():
    c = toy_cell(CELL)
    stark = program.build_stark(c.config, c.traffic, "cpu")
    air = Air(schema_of(c.config), P128, family().trace_steps(c.config, c.traffic))
    for index in range(2):
        st = family().make(c.config, c.traffic, 2 ** 36 + 1, index)
        a = program.assertions(st)
        data = program.prove(stark, st, a)
        assert stark.last_context.trace_source == "native"
        assert program.verify(stark, st, a, data)
        reference_verify(air, c.config["options"], st, data)


def test_control_and_faults_rejected():
    counts = control.readings(toy_cell(CELL), 2 ** 36 + 13, 3, device="cpu")
    assert counts["sound"] == 0
    assert counts["control"] == counts["altered"] == 3
    assert counts["stale"] == counts["stale_of"] == 2


@pytest.mark.parametrize("trace", [False, True])
def test_run_is_correct(trace):
    """A whole run: the reference judges every sampled proof; traced, the
    trace's products a proof are the depth-2 trace's."""
    c = toy_cell(CELL)
    res = run.run_cell(c, 2 ** 35 + 9, 0.5, trace, device="cpu", log=lambda line: None)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    wanted = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(res["metrics"]) <= wanted
    if trace:
        products = res["metrics"]["trace_products_per_proof"]["value"]
        assert products > 0 and products % (STEPS * 2 - 1) == 0
        assert res["metrics"]["trace_ns_per_product"]["value"] > 0
    else:
        assert {"proofs_per_s", "prove_p90_s", "setup_s"} <= set(res["metrics"])


def _control(real, previous, stark, statement, assertions):
    c = toy_cell(CELL)
    weak = program.build_stark(c.config, c.traffic, "cpu",
                               control.control_options(c.config["options"]))
    return real(weak, statement, assertions)


@pytest.mark.parametrize("fault", [_altered, _stale, _control])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    """The warm-up proves stay sound; every request of the window is
    answered by the fault."""
    c = toy_cell(CELL)
    real = program.prove
    state = {"calls": 0, "previous": None}

    def prove(stark, statement, assertions):
        state["calls"] += 1
        if state["calls"] <= c.traffic["warmup"]:
            data = real(stark, statement, assertions)
        else:
            data = fault(real, state["previous"], stark, statement, assertions)
        state["previous"] = data
        return data
    monkeypatch.setattr(program, "prove", prove)
    res = run.run_cell(c, 2 ** 35 + 10, 0.5, False, device="cpu", log=lambda line: None)
    assert res["correct"] is False
    assert res["failed"] >= 1


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELL,
                          "--seed", "4294967317", "--seconds", "3", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    # the depth-16 trace: 511 steps, the same products in every request
    assert res["metrics"]["trace_products_per_proof"]["value"] % (STEPS * 16 - 1) == 0
