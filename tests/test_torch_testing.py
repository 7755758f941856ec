"""The kernel checks' own instruments, on the CPU: the edge inputs of
`genstark_tpu_torch.testing` meet as the pairs they claim to, in the plain
versions the kernels are held against, and chip_smoke.py's build report
names every word-product instantiation, also for a library built before.
Numpy and the plain torch field only; no kernel is built."""

import os

import numpy as np
import pytest

import chip_smoke
from genstark_tpu_torch import kernels
from genstark_tpu_torch.field import P32, P64, P128, P224, P256, create_prime_field
from genstark_tpu_torch.field.limbs import limbs_to_ints, power_series_mont_np
from genstark_tpu_torch.ntt import radix2
from genstark_tpu_torch.testing import edge_input, edge_pairs, edge_values

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
    """chip_smoke.WORD_KERNELS names each instantiation by its mangled part:
    30 of them, none inside another, each found in a register report of the
    nvcc -Xptxas -v form."""
    assert chip_smoke.mangled("field_ew_kernel", 8, 0) == "15field_ew_kernelILi8ELi0EE"
    parts = chip_smoke.WORD_KERNELS
    assert len(set(parts)) == len(parts) == 15 + 5 + 5 + 5
    assert not [(a, b) for a in parts for b in parts if a != b and a in b]
    log = "\n".join(
        f"ptxas info    : Function properties for _ZN2gs{part}Ev6EwArgsNS_6FieldWE\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {32 + i} registers, used 0 barriers, 380 bytes cmem[0]"
        for i, part in enumerate(parts))
    report = chip_smoke.ptxas_report(log)
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
