"""The plain version of kernel 4 (the lincomb tail) against the JAX
package's Pallas tail kernel in interpret mode, at the shapes of
tests/test_lcomb_kernel.py, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu.protocol.lincomb_kernel import lcomb_tail as jax_lcomb_tail
from genstark_tpu_torch.field import P128, create_prime_field
from genstark_tpu_torch.field.limbs import power_series_mont_np
from genstark_tpu_torch.protocol.lincomb_kernel import lcomb_tail


def _elements(rng, n):
    limbs = rng.integers(0, 1 << 16, size=(8, n), dtype=np.int64)
    limbs[7] = rng.integers(0, P128 >> 112, size=n)
    return limbs.astype(np.uint32)


@pytest.mark.parametrize("Ne,s,ext,B,V,raised", [
    (4096, 2048, 16, 2, 3, True),     # boundary + raised copies
    (2048, 2048, 8, 0, 1, False),     # no boundary vectors, no incr table
])
def test_lcomb_tail_matches_jax_kernel(Ne, s, ext, B, V, raised):
    field = create_prime_field(P128)
    dev = field.device_field("cpu")
    p = field.modulus
    rng = np.random.default_rng(Ne + B)
    nj = Ne // s
    g = pow(3, (p - 1) // (4 * Ne), p)
    h = pow(7, (p - 1) // (4 * Ne), p)
    arrays = {
        "qe": _elements(rng, Ne),
        "b": np.stack([_elements(rng, Ne) for _ in range(B)]) if B else
        np.zeros((0, 8, Ne), np.uint32),
        "e": np.stack([_elements(rng, Ne) for _ in range(V)]),
        "dom_o": power_series_mont_np(field.params, pow(g, s, p), nj),
        "dom_i": power_series_mont_np(field.params, g, s),
        "inc_o": power_series_mont_np(field.params, pow(h, s, p), nj),
        "inc_i": power_series_mont_np(field.params, h, s),
        "inv": _elements(rng, ext),
        "bc": _elements(rng, 2 * B if raised else B),
        "lc": _elements(rng, 2 * V if raised else V),
    }
    x_last = int(rng.integers(1, 1 << 62))
    t = {k: torch.from_numpy(v.astype(np.int32)) for k, v in arrays.items()}
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    got = lcomb_tail(dev, t["qe"], t["b"], t["e"], (t["dom_o"], t["dom_i"]),
                     (t["inc_o"], t["inc_i"]) if raised else None, t["inv"], x_last,
                     t["bc"], t["lc"], raised, raised, ext)
    want = jax_lcomb_tail(jax_field(P128).device, j["qe"], j["b"], j["e"],
                          (j["dom_o"], j["dom_i"]),
                          (j["inc_o"], j["inc_i"]) if raised else None, j["inv"], x_last,
                          j["bc"], j["lc"], raised, raised, ext, interpret=True)
    assert want is not None
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
