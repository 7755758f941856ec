"""scripts/torch_profile_verify.py (the port of scripts/profile_verify.py)
on the CPU at a small size: it proves MiMC-128 with the plain versions,
times the port's verifier and, with --profile, prints the cProfile table of
repeated verifications."""

import importlib.util
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_profile_verify", os.path.join(ROOT, "scripts", "torch_profile_verify.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profile_verify_smoke_on_cpu(capsys):
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert _script().main(["6", "--profile", "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(saved)
    out = capsys.readouterr().out
    assert "on cpu" in out and "verify best" in out and "at 2^6" in out
    assert "cumulative" in out and "verify" in out.split("cumulative", 1)[1]


def test_profile_verify_without_profile_prints_no_table(capsys):
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert _script().main(["6", "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(saved)
    out = capsys.readouterr().out
    assert "verify best" in out and "at 2^6" in out and "cumulative" not in out
