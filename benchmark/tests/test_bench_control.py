"""The control and the faults come out not correct, at a size a test run
holds: by the reference alone, and through a whole run of the harness
with the timed path broken underneath."""

import pytest

from benchmark import control, program, run
from benchmark.tests.conftest import toy_cell


@pytest.mark.parametrize("workload", ["mimc128-2p20", "poseidon-merkle-d16"])
def test_control_and_faults_rejected(workload):
    c = toy_cell(workload)
    counts = control.readings(c, 2 ** 36 + 9, 3, device="cpu")
    assert counts["sound"] == 0
    assert counts["control"] == counts["altered"] == 3
    assert counts["stale"] == counts["stale_of"] == 2


def _altered(real, previous, stark, statement, assertions):
    data = bytearray(real(stark, statement, assertions))
    data[len(data) // 3] ^= 0x5A
    return bytes(data)


def _stale(real, previous, stark, statement, assertions):
    return previous


def _control(real, previous, stark, statement, assertions):
    c = toy_cell("mimc128-2p20")
    weak = program.build_stark(c.config, c.traffic, "cpu",
                               control.control_options(c.config["options"]))
    return real(weak, statement, assertions)


@pytest.mark.parametrize("fault", [_altered, _stale, _control])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    """The warm-up proves stay sound; every request of the window is
    answered by the fault."""
    c = toy_cell("mimc128-2p20")
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
    res = run.run_cell(c, 2 ** 35 + 2, 0.5, False, device="cpu", log=lambda line: None)
    assert res["correct"] is False
    assert res["failed"] >= 1


def test_raising_prove_is_not_correct(monkeypatch):
    c = toy_cell("mimc128-2p20")
    real = program.prove
    calls = {"n": 0}

    def prove(stark, statement, assertions):
        calls["n"] += 1
        if calls["n"] > c.traffic["warmup"]:
            raise RuntimeError("planted")
        return real(stark, statement, assertions)
    monkeypatch.setattr(program, "prove", prove)
    res = run.run_cell(c, 2 ** 35 + 3, 0.5, False, device="cpu", log=lambda line: None)
    assert res["correct"] is False and res["checks"]["prove_errors"]["value"] >= 1
