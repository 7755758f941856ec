"""The port's one-fetch prove (protocol/prover.py `_packed_tail`): the
pinned JAX proofs come out of the device-sampled path with no fallback; a
candidate window too small to fill a set forces the host-sampled path with
the same bytes (as tests/test_one_dispatch_paths.py:68 does for the JAX
package); and a prove fetches from its device exactly once, with none of
it inside the batched inverse.  Toy sizes on the CPU, exact comparisons."""

import hashlib

import pytest
import torch

from examples.mimc_torch import prove_div, prove_mimc
from genstark_tpu_torch.field import P32, P128
from genstark_tpu_torch.field.device import DeviceField
from genstark_tpu_torch.protocol.prover import Prover
from genstark_tpu_torch.testing import DIV_PIN, P32_PIN, P128_PIN

TOY = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}
PINS = [(P32, 16, P32_PIN), (P128, 32, P128_PIN)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _prove(modulus, count):
    stark, data = prove_mimc(64, "cpu", modulus=modulus, use_input=False,
                             constant_count=count, options=TOY)
    fallbacks = sum(p.host_fallbacks for p in stark._provers.values())
    return (len(data), hashlib.sha256(data).hexdigest()), fallbacks


@pytest.mark.parametrize("modulus,count,pin", PINS, ids=["p32", "p128"])
def test_one_fetch_gives_the_pins(modulus, count, pin):
    assert _prove(modulus, count) == (pin, 0)


@pytest.mark.parametrize("modulus,count,pin", PINS, ids=["p32", "p128"])
def test_exhausted_window_falls_back_with_the_same_bytes(monkeypatch, modulus, count, pin):
    """A window one shorter than its set's count can never fill it."""
    monkeypatch.setattr(Prover, "_n_cand", staticmethod(lambda c: c - 1))
    assert _prove(modulus, count) == (pin, 1)


def test_disagreeing_positions_fall_back(monkeypatch):
    """Device positions that differ from the host sampler's (one set's
    first index moved) are caught on the host, and the proof is the pin."""
    real = Prover._packed_tail

    def tampered(self, *args):
        packed = real(self, *args)
        base, _, _ = self._tail_layout()
        packed[base] = packed[base] + 1
        return packed

    monkeypatch.setattr(Prover, "_packed_tail", tampered)
    assert _prove(P128, 32) == (P128_PIN, 1)


def test_a_prove_fetches_once(monkeypatch):
    """torch.Tensor.cpu counted inside Prover.prove and DeviceField.inv:
    one fetch a prove (the packed buffer), on the first prove and a warm
    one, and none inside inv (the division AIR divides by a register, so
    its proves run inv)."""
    calls = {"prove": 0, "inv": 0}
    inside = []
    real_cpu, real_prove, real_inv = torch.Tensor.cpu, Prover.prove, DeviceField.inv

    def counted_cpu(self, *args, **kwargs):
        for where in inside:
            calls[where] += 1
        return real_cpu(self, *args, **kwargs)

    def scoped(where, fn):
        def run(*args, **kwargs):
            inside.append(where)
            try:
                return fn(*args, **kwargs)
            finally:
                inside.pop()
        return run

    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    monkeypatch.setattr(Prover, "prove", scoped("prove", real_prove))
    monkeypatch.setattr(DeviceField, "inv", scoped("inv", real_inv))
    stark, data = prove_div(64, "cpu")
    assert (len(data), hashlib.sha256(data).hexdigest()) == DIV_PIN
    assert calls == {"prove": 1, "inv": 0}
    stark.prove(*_div_args(stark))
    assert calls == {"prove": 2, "inv": 0}


def _div_args(stark):
    """The division AIR's assertions and inputs, as prove_div makes them."""
    from examples.mimc_torch import round_constants, run_mimc
    from genstark_tpu_torch.protocol import Assertion
    controls = run_mimc(stark.air.field, 64, round_constants(stark.air.field, 16), 3)
    return [Assertion(0, 0, controls[0]), Assertion(63, 0, controls[-1])], [], [3]


def test_fri_layers_one_fetch_equals_host_path(monkeypatch):
    """128 steps at extension 16 (Ne = 2048: FRI layers of 2048 and 512
    points, so three query sets): the device-sampled proof equals the
    host-sampled one, and the port verifies it."""
    options = {"extension_factor": 16, "exe_query_count": 8, "fri_query_count": 6}
    stark, one = prove_mimc(128, "cpu", modulus=P128, options=options)
    prover = next(iter(stark._provers.values()))
    assert (len(prover.layer_sizes), prover.host_fallbacks) == (2, 0)
    monkeypatch.setattr(Prover, "_n_cand", staticmethod(lambda c: c - 1))
    stark, host = prove_mimc(128, "cpu", modulus=P128, options=options)
    assert next(iter(stark._provers.values())).host_fallbacks == 1
    assert one == host
    from examples.mimc_torch import round_constants, run_mimc
    from genstark_tpu_torch.protocol import Assertion
    controls = run_mimc(stark.air.field, 128, round_constants(stark.air.field, 64), 3)
    assertions = [Assertion(0, 0, controls[0]), Assertion(127, 0, controls[-1])]
    assert stark.verify(assertions, stark.parse(one))
