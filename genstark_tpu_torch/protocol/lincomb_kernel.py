"""The pointwise tail of the composition + linear combination: kernel 4 and
its plain version.

Counterpart of ``genstark_tpu/protocol/lincomb_kernel.py`` (`lcomb_tail`).
Math per position x (the plain version is the unfused body of the JAX
package's `_lcomb_chunked`, fused.py:920-941):

    dom  = outer[pos//s] * inner[pos%s]           (factored power table)
    zinv = (dom - x_last) * inv_series[pos%ext]   (1 / Z(x))
    acc  = qe * zinv                              (D(x) = Q(x)/Z(x))
    incr = outer_i[pos//s] * inner_i[pos%s]       (x^(target-T), optional)
    acc += sum_b b_k * b_coeff_k   (+ b_k*incr * b_coeff_{B+k})
    acc += sum_v e_v * l_coeff_v   (+ e_v*incr * l_coeff_{V+v})

Representation contract: qe and e are STANDARD form, the boundary vectors,
power tables and l_coeffs Montgomery, b_coeffs standard, so every additive
term lands in standard form and the output feeds FRI with no conversion.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..field.limbs import int_to_limbs


def lcomb_tail_ref(dev, qe, b_stack, e_std, dom_parts, incr_parts, inv_series,
                   x_last_int: int, b_coeffs, l_coeffs, b_inc: bool,
                   ps_inc: bool, ext: int) -> torch.Tensor:
    """Plain torch tail: [L, Ne] standard-form L(x).  Built from the plain
    field (`*_ref`), so on the card it launches no kernel of the port."""
    Ne = qe.shape[1]
    B, V = b_stack.shape[0], e_std.shape[0]
    mul, add = dev.mont_mul_ref, dev.add_ref

    def combine(vectors, coeffs):
        acc = None
        for k, v in enumerate(vectors):
            term = mul(v, coeffs[:, k:k + 1])
            acc = term if acc is None else add(acc, term)
        return acc

    dom = dev.outer_table_ref(*dom_parts)
    zinv = mul(dev.sub_ref(dom, dev.const(x_last_int, shape=(1,))),
               inv_series.repeat(1, Ne // ext))
    acc = mul(qe, zinv)
    incr = dev.outer_table_ref(*incr_parts) if incr_parts is not None else None
    ba = [b_stack[k] for k in range(B)]
    if b_inc:
        ba += [mul(v, incr) for v in ba[:B]]
    if ba:
        acc = add(acc, combine(ba, b_coeffs))
    ps = [e_std[v] for v in range(V)]
    if ps_inc:
        ps += [mul(v, incr) for v in ps[:V]]
    return add(acc, combine(ps, l_coeffs))


def lcomb_tail(dev, qe, b_stack, e_std, dom_parts, incr_parts, inv_series,
               x_last_int: int, b_coeffs, l_coeffs, b_inc: bool,
               ps_inc: bool, ext: int) -> torch.Tensor:
    """The tail over [L, Ne] arrays.  dom_parts / incr_parts: (outer [L, nj],
    inner [L, s]) factored tables with nj*s = Ne; inv_series [L, ext];
    b_coeffs [L, B or 2B]; l_coeffs [L, V or 2V].  CPU tensors run
    lcomb_tail_ref; CUDA tensors launch kernel 4 or raise."""
    if qe.device.type == "cpu":
        return lcomb_tail_ref(dev, qe, b_stack, e_std, dom_parts, incr_parts,
                              inv_series, x_last_int, b_coeffs, l_coeffs,
                              b_inc, ps_inc, ext)
    x_last_mont = int_to_limbs((x_last_int * dev.params.R_mod) % dev.p, dev.L)
    contig = lambda t: t.contiguous() if t is not None else None
    return kernels.lcomb_tail(
        dev, qe.contiguous(), b_stack.contiguous(), e_std.contiguous(),
        tuple(contig(t) for t in dom_parts),
        tuple(contig(t) for t in incr_parts) if incr_parts is not None else None,
        inv_series.contiguous(), x_last_mont, b_coeffs.contiguous(),
        l_coeffs.contiguous(), b_inc, ps_inc, ext)
