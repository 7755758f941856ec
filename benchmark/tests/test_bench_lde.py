"""The LDE roofline's byte count."""

import importlib.util
from pathlib import Path

import torch

from genstark_tpu_torch import ntt
from genstark_tpu_torch.field import P128, create_prime_field

_path = Path(__file__).resolve().parents[1] / "metrics" / "lde_roofline.py"
_spec = importlib.util.spec_from_file_location("lde_roofline", _path)
lde_roofline = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(lde_roofline)


def test_lde_bytes_at_the_cell():
    # MiMC-128 at 2^20 steps, [8, 2^20] int32 limbs: the intt reads and
    # writes 32 MiB each, the LDE reads 32 MiB and writes 512 MiB
    assert lde_roofline.lde_bytes(8, 2 ** 20, 2 ** 24) == 637_534_208


def test_lde_bytes_are_the_transforms_tensors():
    field = create_prime_field(P128)
    dev = field.device_field("cpu")
    n, Ne = 64, 1024
    x = dev.from_ints(list(range(n)))
    coeffs = ntt.intt(field, x)
    out = ntt.low_degree_extend(field, coeffs, Ne)
    counted = sum(t.numel() * t.element_size() for t in (x, coeffs, coeffs, out))
    assert counted == lde_roofline.lde_bytes(field.params.L, n, Ne, x.element_size())
    assert torch.equal(out[:, ::Ne // n], x)


def test_no_reading_without_a_card():
    class Run:
        stark, device = None, "cpu"
    assert lde_roofline.read(Run()) is None
