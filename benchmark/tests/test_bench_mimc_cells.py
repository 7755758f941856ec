"""The MiMC cells at 2^18 steps over the 256-bit field and at 2^13 steps
over the 128-bit one, at toy size on the CPU: each configuration's frozen
schema against the port's example, each cell through the port, and the
mimc256 configuration through the control, its faults and a whole run
(the mimc128 ones are test_bench_control's and test_bench_result's).
Marked `cuda`: one short run of each cell on the card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import control, program, run, statements
from benchmark.tests.conftest import toy_cell
from benchmark.tests.test_bench_control import _altered, _stale
from examples.mimc_torch import make_mimc_stark, round_constants, run_mimc
from genstark_tpu_torch.field import P128, P256, create_prime_field

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["mimc256-2p18", "mimc128-2p13"]
MODULUS = {"mimc128": P128, "mimc256": P256}


def test_mimc256_statement_is_the_examples_recurrence():
    c = toy_cell("mimc256-2p18")
    field = create_prime_field(P256)
    constants = round_constants(field)
    assert c.config["field"]["modulus"] == P256
    assert c.config["schema"]["static_registers"][0]["values"] == constants
    for index in (0, 3):
        st = statements.module("mimc").make(c.config, c.traffic, 2 ** 40 + 3, index)
        controls = run_mimc(field, 64, constants, st.inputs[0][0])
        assert st.assertions == [(0, 0, controls[0]), (63, 0, controls[-1])]


@pytest.mark.parametrize("workload", CELLS)
def test_frozen_schema_is_the_examples(workload):
    """The configuration's frozen schema, built as the port's AirSchema,
    equals the one `make_mimc_stark` builds at its modulus, node for node."""
    c = toy_cell(workload)
    frozen = program._schema(c.config, c.traffic)
    stark, _ = make_mimc_stark(c.traffic["steps"], "cpu", modulus=MODULUS[c.config["name"]])
    built = stark.air.schema
    assert frozen.field.modulus == built.field.modulus
    assert frozen.trace_width == built.trace_width
    assert frozen.static_registers == built.static_registers
    assert (frozen.init, frozen.transition, frozen.constraints) == \
        (built.init, built.transition, built.constraints)
    assert frozen.base_steps == built.base_steps


@pytest.mark.parametrize("workload", CELLS)
def test_port_proves_the_statements(workload):
    c = toy_cell(workload)
    stark = program.build_stark(c.config, c.traffic, "cpu")
    st = statements.module(c.config["statements"]).make(c.config, c.traffic, 11, 0)
    a = program.assertions(st)
    assert program.verify(stark, st, a, program.prove(stark, st, a))


def test_mimc256_control_and_faults_rejected():
    # at toy size mimc128-2p13 is mimc128-2p20, which test_bench_control covers
    counts = control.readings(toy_cell("mimc256-2p18"), 2 ** 36 + 11, 3, device="cpu")
    assert counts["sound"] == 0
    assert counts["control"] == counts["altered"] == 3
    assert counts["stale"] == counts["stale_of"] == 2


@pytest.mark.parametrize("trace", [False, True])
def test_mimc256_run_is_correct(trace):
    """A whole run at 32-byte elements: the reference judges every sampled proof."""
    c = toy_cell("mimc256-2p18")
    res = run.run_cell(c, 2 ** 35 + 7, 0.5, trace, device="cpu", log=lambda line: None)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    wanted = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(res["metrics"]) <= wanted
    # a Prover reused from the warm-up reads 0 builds and 0 ms of building
    assert all(m["value"] >= 0 for m in res["metrics"].values())
    core = {"trace_ms", "enqueue_ms", "assemble_ms"} if trace else \
        {"proofs_per_s", "prove_p90_s", "setup_s"}
    assert all(res["metrics"][name]["value"] > 0 for name in core)


def _control(real, previous, stark, statement, assertions):
    c = toy_cell("mimc256-2p18")
    weak = program.build_stark(c.config, c.traffic, "cpu",
                               control.control_options(c.config["options"]))
    return real(weak, statement, assertions)


@pytest.mark.parametrize("fault", [_altered, _stale, _control])
def test_mimc256_broken_timed_path_is_not_correct(monkeypatch, fault):
    """The warm-up proves stay sound; every request of the window is
    answered by the fault."""
    c = toy_cell("mimc256-2p18")
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
    res = run.run_cell(c, 2 ** 35 + 8, 0.5, False, device="cpu", log=lambda line: None)
    assert res["correct"] is False
    assert res["failed"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                          "--seed", "4294967313", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
