"""The port's Prover cache (protocol/stark.py `_prover`), keyed as the JAX
package's is, by the trace length, the input shapes and the asserted steps
and registers: a statement B with other values at A's steps reuses A's
Prover and proves the bytes a fresh Stark proves, which are the JAX
package's bytes of B proved after A on one of its Starks (through its own
structure-keyed `_fused_prover`), pinned in JAX_BYTES; the verifier holds
B's proof to B's values; a statement that asserts another step builds a
second Prover.  A Prover holds no asserted value: its boundary stage
divides P by Z with the remainder dropped, which is (P - I) / Z for every
statement, checked on P = I + Z * Q.  Toy sizes on the CPU, exact
comparisons; the `slow` test remakes the pins with the JAX package."""

import hashlib

import pytest
import torch

from examples.mimc import make_mimc_stark as jax_make_mimc_stark
from examples.mimc import run_mimc as jax_run_mimc
from examples.mimc_torch import make_mimc_stark, run_mimc
from examples.poseidon import make_hash_stark as jax_make_hash_stark
from examples.poseidon_torch import STEPS, make_hash_stark
from genstark_tpu.protocol import Assertion as JaxAssertion
from genstark_tpu_torch.field import P32, P128
from genstark_tpu_torch.protocol import Assertion
from genstark_tpu_torch.protocol.boundary import BoundaryConstraints
from genstark_tpu_torch.protocol.fri import StarkError
from genstark_tpu_torch.testing import MIMC128_INPUT_3_5_PINS, P32_PIN

TOY = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}


class Mimc:
    """64 steps; statement k is the run from seed k, its first and last
    values asserted (a secret input register over P128, the seed register
    over P32); `moved` asserts the next-to-last step instead.  `jax` makes
    and proves the same statements with the JAX package's example."""

    def __init__(self, modulus, use_input):
        self.modulus, self.use_input = modulus, use_input

    def make(self, jax=False):
        make = jax_make_mimc_stark if jax else (
            lambda *a, **kw: make_mimc_stark(a[0], "cpu", *a[1:], **kw))
        stark, self.constants = make(64, modulus=self.modulus, use_input=self.use_input,
                                     constant_count=16, options=TOY)
        return stark

    def prove(self, stark, k, moved=False, jax=False):
        point = JaxAssertion if jax else Assertion
        controls = (jax_run_mimc if jax else run_mimc)(stark.air.field, 64, self.constants, k)
        assertions = [point(0, 0, controls[0]),
                      point(62, 0, controls[-2]) if moved else point(63, 0, controls[-1])]
        proof = (stark.prove(assertions, [[k]]) if self.use_input else
                 stark.prove(assertions, [], [k]))
        return assertions, stark.serialize(proof)


class PoseidonHash:
    """examples/poseidon_torch.py's hash3x128 (AirScript, 3 registers, 64
    steps): statement k hashes (k, k + 1), its two outputs asserted on
    registers 0 and 1 at the last step; `moved` asserts register 0 at step
    0 (the first input) instead of at the last.  `jax`: examples/poseidon.py,
    the same source text."""

    options = dict(TOY, extension_factor=16)

    def make(self, jax=False):
        stark, _, self.oracle = (jax_make_hash_stark(3, self.options) if jax else
                                 make_hash_stark(3, self.options, device="cpu"))
        return stark

    def prove(self, stark, k, moved=False, jax=False):
        point = JaxAssertion if jax else Assertion
        out = self.oracle([k, k + 1])
        assertions = [point(0, 0, k) if moved else point(STEPS - 1, 0, out[0]),
                      point(STEPS - 1, 1, out[1])]
        return assertions, stark.serialize(stark.prove(assertions, [[k], [k + 1]]))


CASES = {"p32": Mimc(P32, False), "p128": Mimc(P128, True), "poseidon": PoseidonHash()}
# (bytes, sha256) of the JAX package's proofs of A, B and the moved B, in
# that order on one of its Starks (A over P32 is P32_PIN's statement; A and
# B over P128 are tests/test_torch_static_columns.py's two).
JAX_BYTES = {
    "p32": [P32_PIN,
            (3297, "d623ac1696343bdcaa8ea626bd4262557567aec90af482cf7c327e3fd23ebb27"),
            (3339, "0c6fc6a2916c46a6476fe4ce01bb287624810ffe82fd7dd7d5bda99459dcd372")],
    "p128": MIMC128_INPUT_3_5_PINS + [
        (7558, "2ee0553e2bd29d63677c31699987332fc09c4fc332244e87505ac2c418a037da")],
    "poseidon": [(11645, "7564418b1f5e3881e2b1e205d711d2627d89ac2886f7b96e9c2cd610ba57da3a"),
                 (12029, "79716e7d6fb567383a69c54365140a7c1bd7c524e615c6e2b1bb9a83c90bdb70"),
                 (11677, "37255ef320c523967ec2c764b6500102bf7355e578a3d23031581dde561ea746")],
}


def _digest(data: bytes):
    return len(data), hashlib.sha256(data).hexdigest()


@pytest.fixture(scope="module", params=list(CASES))
def proved(request):
    """One Stark proves A (k = 3), B (k = 5) and the moved B in turn; fresh
    Starks prove B and the moved B alone."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        case = CASES[request.param]
        stark = case.make()
        a, a_bytes = case.prove(stark, 3)
        b, b_bytes = case.prove(stark, 5)
        provers_after_b = len(stark._provers)
        _, b_fresh = case.prove(case.make(), 5)
        moved, moved_bytes = case.prove(stark, 5, moved=True)
        _, moved_fresh = case.prove(case.make(), 5, moved=True)
        return dict(case=case, name=request.param, stark=stark, a=a, a_bytes=a_bytes, b=b,
                    b_bytes=b_bytes, b_fresh=b_fresh, provers_after_b=provers_after_b,
                    moved=moved, moved_bytes=moved_bytes, moved_fresh=moved_fresh)
    finally:
        torch.set_num_threads(saved)


def test_new_values_reuse_the_prover(proved):
    """B after A keeps one Prover, and its bytes are B's from a fresh Stark."""
    assert [(x.step, x.register) for x in proved["a"]] == \
        [(x.step, x.register) for x in proved["b"]]
    assert [x.value for x in proved["a"]] != [x.value for x in proved["b"]]
    assert proved["provers_after_b"] == 1
    assert proved["b_bytes"] == proved["b_fresh"]


def test_bytes_equal_the_jax_package(proved):
    """A, then B and the moved B, each proved on a Stark that proved A
    first, are the JAX package's bytes of the same statements in the same
    order (JAX_BYTES)."""
    assert [_digest(proved[k]) for k in ("a_bytes", "b_bytes", "moved_bytes")] == \
        JAX_BYTES[proved["name"]]


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CASES))
def test_jax_bytes_pins_are_the_jax_packages(name):
    """One JAX Stark proves A, B and the moved B in turn: their digests are
    JAX_BYTES (minutes of XLA:CPU for the Poseidon case)."""
    case = CASES[name]
    jstark = case.make(jax=True)
    got = [_digest(case.prove(jstark, k, moved, jax=True)[1])
           for k, moved in ((3, False), (5, False), (5, True))]
    assert got == JAX_BYTES[name]


def test_the_verifier_holds_the_proof_to_its_values(proved):
    stark = proved["stark"]
    assert stark.verify(proved["b"], stark.parse(proved["b_bytes"]))
    with pytest.raises(StarkError):
        stark.verify(proved["a"], stark.parse(proved["b_bytes"]))


def test_a_new_asserted_step_builds_a_second_prover(proved):
    stark = proved["stark"]
    assert len(stark._provers) == 2
    assert proved["moved_bytes"] == proved["moved_fresh"] != proved["b_bytes"]
    assert stark.verify(proved["moved"], stark.parse(proved["moved_bytes"]))


def test_the_floor_quotient_is_the_exact_quotient(proved):
    """The kept Prover's boundary stage (`evaluate_all_tables` on its own
    tables, the extension left out) takes P = I + Z * Q, with I through
    B's values, to Q; the Prover's boundary constraints hold zeros where
    the values were."""
    stark = proved["stark"]
    structure = tuple((x.step, x.register) for x in proved["b"])
    prover = next(p for key, p in stark._provers.items() if key[2] == structure)
    field, dev = stark.air.field, prover.dev
    f = field.host
    kept = prover.c_poly.b_poly
    assert all(v == 0 for c in kept.polys.values() for v in c["i_poly"])
    T = prover.context.trace_length
    b_poly = BoundaryConstraints(proved["b"], prover.context)
    assert list(b_poly.polys) == list(kept.polys)
    rows, want = {}, []
    for register, c in b_poly.polys.items():
        q = [(7919 * i + 104729 * register + 1) % field.modulus
             for i in range(T - len(c["z_poly"]) + 1)]
        p = f.add_polys(c["i_poly"], f.mul_polys(c["z_poly"], q))
        rows[register] = [v % field.modulus for v in p] + [0] * (T - len(p))
        want.append(q + [0] * (T - len(q)))
    p_polys = torch.stack([dev.from_ints(rows.get(r, [0] * T))
                           for r in range(1 + max(rows))])
    bdiv = [[(prover._table(f"bc{b}_{j}"), prover._table(f"bci{b}_{j}"))
             for j in range(len(c["xs"]))] for b, c in enumerate(kept.polys.values())]
    got = kept.evaluate_all_tables(dev, p_polys, bdiv, lambda x: x)
    assert [dev.to_ints(x) for x in got] == want
