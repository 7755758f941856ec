"""The kernel checks' own instruments, on the CPU: the edge inputs of
`genstark_tpu_torch.testing` meet as the pairs they claim to, in the plain
versions the kernels are held against, and the build report that
chip_smoke.py reads (`ptxas_report`, `word_kernels`) names every
word-product instantiation, also for a library built before.  Numpy and
the plain torch field only; no kernel is built."""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from genstark_tpu_torch import kernels
from genstark_tpu_torch.field import P32, P64, P128, P224, P256, create_prime_field
from genstark_tpu_torch.field.limbs import limbs_to_ints, power_series_mont_np
from genstark_tpu_torch.ntt import radix2
from genstark_tpu_torch.testing import (FIELD_LIMBS, edge_input, edge_pairs, edge_values, mangled,
                                        ptxas_report, word_kernels)

FIELDS = pytest.mark.parametrize("modulus", [96769, P32, P64, P128, P224, P256],
                                 ids=["demo", "p32", "p64", "p128", "p224", "p256"])


def _random(rng, modulus, L, n):
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, modulus >> (16 * (L - 1)), size=n)
    return limbs.astype(np.uint32)


@FIELDS
def test_edge_values_are_canonical_and_distinct_pairs(modulus):
    field = create_prime_field(modulus)
    vals = edge_values(field)
    assert all(0 <= v < modulus for v in vals) and {0, 1, modulus - 1} <= set(vals)
    xs, ys = edge_pairs(field)
    assert sorted(zip(xs, ys)) == sorted((x, y) for x in vals for y in vals)


@FIELDS
def test_stage_pass_edges_meet_at_the_first_butterflies(modulus):
    """With the table's root, the first stage of a pass from m adds and
    subtracts every planted pair itself: lo + w_j hi = x + y and lo - w_j hi
    = x - y at j and m + j, whatever twiddle w_j butterfly j takes."""
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    n, p = 2 ** 9, modulus                 # the demo field's largest power-of-two root
    root = field.get_root_of_unity(n)
    table = dev.from_numpy(np.ascontiguousarray(
        power_series_mont_np(field.params, root, n // 2).T))
    xs, ys = edge_pairs(field)
    for halves in ((64, 128, 256), (16,), (n // 2,)):
        x = edge_input(field, _random(np.random.default_rng(5), p, dev.L, n), halves, root=root)
        count = min(len(xs), min(halves))
        for m in halves:
            out = radix2.butterfly_stage_ref(dev, dev.from_numpy(x)[None].clone(), table, m)[0]
            out = limbs_to_ints(out.numpy().astype(np.uint32))
            assert out[:count] == [(a + b) % p for a, b in zip(xs, ys)][:count]
            assert out[m:m + count] == [(a - b) % p for a, b in zip(xs, ys)][:count]


@FIELDS
def test_transform_edges_meet_at_the_first_butterfly(modulus):
    """Without a root the partner sits where the first stage of a local
    transform meets it against the twiddle 1: over two points (one stage),
    row r shifted by r gives (x_r + y_r, x_r - y_r) for every pair."""
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    p = modulus
    xs, ys = edge_pairs(field)
    rows = [edge_input(field, _random(np.random.default_rng(r), p, dev.L, 2), shift=r)
            for r in range(len(xs))]
    x = dev.from_numpy(np.stack(rows))[None]                  # [1, pairs, L, 2]
    table = dev.from_numpy(power_series_mont_np(field.params, field.get_root_of_unity(2), 1))
    out = radix2.butterfly_ref(dev, x, table)[0].numpy().astype(np.uint32)
    for r, (a, b) in enumerate(zip(xs, ys)):
        assert limbs_to_ints(out[r]) == [(a + b) % p, (a - b) % p]


def test_word_kernel_names_match_their_mangling():
    """word_kernels() names each instantiation by its mangled part:
    60 of them (kernel 5's 24, kernels 8, 7/9 and 10 at eight L, kernel 1's
    12: KS = 1 and 2 at L = 2, 4, 6, 8, KS = 1 at L = 10 to 16, the k steps
    kernels.dft_slice gives), none inside another, each found in a register
    report of the nvcc -Xptxas -v form."""
    assert mangled("field_ew_kernel", 8, 0) == "15field_ew_kernelILi8ELi0EE"
    assert mangled("dft_level_kernel", 16, 1) == "16dft_level_kernelILi16ELi1EE"
    assert FIELD_LIMBS == kernels.FIELD_LS
    parts = word_kernels()
    assert len(set(parts)) == len(parts) == 24 + 8 + 8 + 8 + 12
    assert not [(a, b) for a in parts for b in parts if a != b and a in b]
    log = "\n".join(
        f"ptxas info    : Function properties for _ZN2gs{part}Ev6EwArgsNS_6FieldWE\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {32 + i} registers, used 0 barriers, 380 bytes cmem[0]"
        for i, part in enumerate(parts))
    report = ptxas_report(log)
    assert [next(r for name, r in report if part in name) for part in parts] == [
        f"{32 + i} registers, 0 bytes spilled" for i in range(len(parts))]


def test_build_reads_the_report_of_a_library_built_before(tmp_path, monkeypatch):
    """kernels.build() on a library its source hash already built returns
    it without nvcc and records the register report that build wrote."""
    monkeypatch.setattr(kernels, "_BUILD", str(tmp_path))
    monkeypatch.setattr(kernels, "build_info", {})
    out_dir = tmp_path / kernels._source_hash()
    out_dir.mkdir()
    (out_dir / kernels._LIB_NAME).write_bytes(b"")
    (out_dir / "build.log").write_text("nvcc ...\nptxas info    : Used 40 registers\n")
    assert kernels.build() == os.path.join(str(out_dir), kernels._LIB_NAME)
    assert kernels.build_info["log"].endswith("Used 40 registers\n")
    assert kernels.build_info["seconds"] == 0.0


def test_dft_fragment_budget_is_one_rule():
    """kernels.DFT_FRAGMENT_WORDS mirrors csrc/dft_level.cu's budget, and
    the slices kernels.dft_slice gives from it are two k steps up to L = 8,
    one from L = 10 on."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "genstark_tpu_torch", "csrc", "dft_level.cu")) as fh:
        src = fh.read()
    assert f"constexpr int kDftFragmentWords = {kernels.DFT_FRAGMENT_WORDS};" in src
    assert [kernels.dft_slice(L) for L in kernels.DFT_LS] == [64, 64, 64, 64, 32, 32, 32, 32]


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_each_pin_is_written_once():
    """Every proof or transform digest among the port's files
    (genstark_tpu_torch/, chip_smoke.py, scripts/torch_*.py,
    tests/test_torch_*.py, tests/torch_*.py) is written in one place: a
    pin that several files read lives in genstark_tpu_torch/testing.py."""
    files = glob.glob(os.path.join(ROOT, "genstark_tpu_torch", "**", "*.py"), recursive=True)
    for pattern in ("chip_smoke.py", "scripts/torch_*.py", "tests/test_torch_*.py",
                    "tests/torch_*.py"):
        files += glob.glob(os.path.join(ROOT, pattern))
    seen = {}
    for path in sorted(files):
        with open(path) as fh:
            for digest in re.findall(r'"([0-9a-f]{64})"', fh.read()):
                seen.setdefault(digest, []).append(os.path.relpath(path, ROOT))
    assert len(seen) > 30
    assert {d: where for d, where in seen.items() if len(where) > 1} == {}


def test_instruments_load_by_path_alone():
    """scripts/torch_ew_dram.py loads this tree's testing.py by path to
    measure another tree: the load imports neither torch nor the package."""
    code = ("import sys; sys.path.insert(0, 'scripts'); import torch_ew_dram; "
            "m = torch_ew_dram.load_instrument(); "
            "print(m.DRAM_SETS, m.MEM_BYTES_PER_S, callable(m.device_ms), "
            "'torch' in sys.modules, 'genstark_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60, check=True)
    assert out.stdout.split() == ["8", "3350000000000.0", "True", "False", "False"]
