"""Boundary constraints B(x) = (P(x) - I(x)) / Z(x) per asserted register.

Counterpart of ``genstark_tpu/protocol/boundary.py``: the constructor
(:20-44), the verifier's `evaluate_at` (:46) and `z_dens_at` (:62), the
staged prover's `evaluate_all` and the one-fetch prover's tables path of it
(`evaluate_all_tables`), with `_synthetic_divide` (:84-159).  I interpolates the asserted (x_step, value)
points, Z = prod (x - x_step); register order is first-appearance order of
the assertions.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..field.limbs import ints_to_limbs


class BoundaryConstraints:
    def __init__(self, assertions, context):
        self.field = context.field
        f = self.field.host
        ext = context.extension_factor
        r_data: Dict[int, dict] = {}
        for a in assertions:
            x = f.exp(context.root_of_unity, a.step * ext)
            z_factor = [f.neg(x), 1]
            data = r_data.get(a.register)
            if data:
                data["xs"].append(x)
                data["ys"].append(a.value % self.field.modulus)
                data["z_poly"] = f.mul_polys(data["z_poly"], z_factor)
            else:
                r_data[a.register] = {"xs": [x], "ys": [a.value % self.field.modulus],
                                      "z_poly": z_factor}
        self.polys = {}
        for register, data in r_data.items():
            i_poly = f.interpolate(data["xs"], data["ys"])
            self.polys[register] = {"i_poly": i_poly, "z_poly": data["z_poly"],
                                    "xs": data["xs"]}

    @property
    def count(self) -> int:
        return len(self.polys)

    def evaluate_at(self, p_values: List[int], x: int,
                    z_invs: Optional[List[int]] = None) -> List[int]:
        """z_invs: Z_b(x)^-1 per register (insertion order), which the
        verifier batches across query positions (`z_dens_at`); without
        them each Z_b(x) is divided by on the host, as in the JAX package."""
        f = self.field.host
        out = []
        for b, (register, c) in enumerate(self.polys.items()):
            num = f.sub(p_values[register], f.eval_poly_at(c["i_poly"], x))
            if z_invs is not None:
                out.append(f.mul(num, z_invs[b]))
            else:
                out.append(f.div(num, f.eval_poly_at(c["z_poly"], x)))
        return out

    def z_dens_at(self, x: int) -> List[int]:
        """Z_b(x) denominators per register (insertion order), for batched
        inversion by the verifier."""
        f = self.field.host
        return [f.eval_poly_at(c["z_poly"], x) for c in self.polys.values()]

    def i_polys_std(self) -> np.ndarray:
        """Interpolant coefficients as standard-form limbs u32 [B, L, T_pad]
        (zero-padded to the longest interpolant)."""
        L = self.field.params.L
        t_pad = max(len(c["i_poly"]) for c in self.polys.values())
        out = np.zeros((self.count, L, t_pad), dtype=np.uint32)
        for b, c in enumerate(self.polys.values()):
            ints = [v % self.field.modulus for v in c["i_poly"]]
            out[b, :, :len(ints)] = ints_to_limbs(ints, L)
        return out

    def evaluate_all(self, p_polys: torch.Tensor, domain_size: int) -> List[torch.Tensor]:
        """The staged prover's form (JAX :84-126): p_polys [R, L, T] trace
        polynomials (Montgomery) -> the B(x) evaluation vectors [L,
        domain_size] (Montgomery) in register insertion order.  The
        interpolants are uploaded from the host, each quotient's power
        tables made by `power_series`, and each quotient extended by the
        public `ntt.low_degree_extend`."""
        from .. import ntt
        field = self.field
        f = field.host
        dev = field.device_field(p_polys.device)
        out = []
        for register, c in self.polys.items():
            coeffs = p_polys[register]                         # [L, T]
            T = coeffs.shape[-1]
            i_ints = [v % field.modulus for v in c["i_poly"]]
            n_coeffs = dev.sub(coeffs, dev.from_ints(i_ints + [0] * (T - len(i_ints))))
            for root in c["xs"]:
                powers = (dev.power_series(root, T), dev.power_series(f.inv(root), T))
                n_coeffs = _synthetic_divide(dev, f, n_coeffs, root, powers)
            out.append(ntt.low_degree_extend(field, n_coeffs, domain_size))
        return out

    def evaluate_all_tables(self, dev, p_polys: torch.Tensor, bdiv, lde) -> List[torch.Tensor]:
        """p_polys [R, L, T] trace polynomials (Montgomery); bdiv[b][j] =
        (powers of x_j, powers of x_j^-1) [L, T] Montgomery tables; lde(coeffs
        [L, T]) -> evaluations [L, Ne].  Returns the B(x) evaluation vectors
        [L, Ne] (Montgomery) in register insertion order, each extended once.
        B = (P - I) / Z is computed as the floor quotient of P by Z
        (synthetic division by each linear factor, each remainder dropped):
        the floor quotient is linear and I's degree is below Z's, so
        floor((P - I) / Z) = floor(P / Z), which is the exact quotient where
        P meets the assertions.  Only the asserted steps are read, and no
        interpolant is made or uploaded."""
        f = self.field.host
        out = []
        for b, (register, c) in enumerate(self.polys.items()):
            n_coeffs = p_polys[register]                       # [L, T]
            for j, root in enumerate(c["xs"]):
                n_coeffs = _synthetic_divide(dev, f, n_coeffs, root, bdiv[b][j])
            out.append(lde(n_coeffs))
        return out


def _synthetic_divide(dev, f, a: torch.Tensor, c: int, powers) -> torch.Tensor:
    """Exact division of polynomial a (coefficients, [L, T] Montgomery) by
    (x - c), keeping the [L, T] shape (the top coefficient comes out zero):
    b_k = c^-(k+1) * sum_{j>k} a_j c^j, with the suffix sums by
    log-doubling.  powers = (c-powers, c^-1-powers) [L, T] tables."""
    T = a.shape[-1]
    powers_c, powers_cinv = powers
    s = dev.mont_mul(a, powers_c)                              # u_j = a_j c^j
    k = 1
    while k < T:
        shifted = torch.nn.functional.pad(s[:, k:], (0, k))
        s = dev._add(s, shifted)
        k *= 2
    s_excl = torch.nn.functional.pad(s[:, 1:], (0, 1))        # S_k = sum_{j>k}
    return dev.mont_mul(dev.mont_mul(s_excl, powers_cinv),
                        dev.const(f.inv(c), shape=(1,)))
