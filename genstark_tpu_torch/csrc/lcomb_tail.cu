// Kernel 4: the pointwise tail of the composition + linear combination.
//
// Replaces the TPU kernel genstark_tpu/protocol/lincomb_kernel.py
// `_tail_call` (:47, pallas_call :132, reached via lcomb_tail :143).  Plain
// version: genstark_tpu_torch/protocol/lincomb_kernel.py (lcomb_tail_ref).
// Per position x of the evaluation domain:
//
//   dom  = outer[pos / s] * inner[pos % s]            (factored power table)
//   zinv = (dom - x_last) * inv_series[pos % ext]     (1 / Z(x))
//   acc  = qe * zinv
//   incr = outer_i[pos / s] * inner_i[pos % s]        (optional)
//   acc += sum_k b_k * bc_k   (+ b_k * incr * bc_{B+k})
//   acc += sum_v e_v * lc_v   (+ e_v * incr * lc_{V+v})
//
// Representation contract (as on the TPU): qe and e are standard form,
// tables / boundary vectors / lc are Montgomery, bc standard, so every
// term lands in standard form and the output feeds FRI directly.
//
// What bounds it on this card: at p128 one position reads (1 + B + V) * 32
// bytes, writes 32, and runs ~8 + 2B + 2V Montgomery products of ~300
// integer ops each, so it is issue-bound rather than memory-bound.  Design:
// one thread per position; every operand is read once (limb-major, so each
// limb load is contiguous across a warp), all products stay in registers
// and the combined vector is written once — the dozen full-domain passes of
// the unfused formulation become one.  The TPU kernel's 8-sublane guard
// does not apply: any L in {2, 4, 8, 14, 16} (p32 to p256), any Ne, s and
// ext.  At L = 16 a thread holds five 16-limb elements and the 33-word
// product accumulator; ptxas's report (chip_smoke.py prints it) says whether
// that spills.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace gs {

struct TailArgs {
  const int32_t* qe;       // [L, Ne]
  const int32_t* b;        // [B, L, Ne]
  const int32_t* e;        // [V, L, Ne]
  const int32_t* dom_o;    // [L, nj]
  const int32_t* dom_i;    // [L, s]
  const int32_t* inc_o;    // [L, nj] or null
  const int32_t* inc_i;    // [L, s] or null
  const int32_t* inv;      // [L, ext]
  const int32_t* bc;       // [L, nb]
  const int32_t* lc;       // [L, nl]
  int32_t* out;            // [L, Ne]
  long long ne;
  int nj, s, ext, n_b, n_v, nb, nl;
  int b_inc, ps_inc;
  uint32_t x_last[kMaxL];  // Montgomery x at the last trace step
};

template <int L>
__global__ void __launch_bounds__(128) lcomb_tail_kernel(TailArgs a, Field f) {
  const long long pos = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (pos >= a.ne) return;
  const long long j = pos / a.s, q = pos % a.s;
  uint32_t x[L], y[L], acc[L], t[L];

  load_elem<L>(a.dom_o, a.nj, j, x);
  load_elem<L>(a.dom_i, a.s, q, y);
  mont_mul<L>(x, y, f, x);                                  // dom
#pragma unroll
  for (int i = 0; i < L; ++i) y[i] = a.x_last[i];
  sub_mod<L>(x, y, f, x);
  load_elem<L>(a.inv, a.ext, pos % a.ext, y);
  mont_mul<L>(x, y, f, x);                                  // zinv
  load_elem<L>(a.qe, a.ne, pos, y);
  mont_mul<L>(y, x, f, acc);

  uint32_t incr[L] = {};
  if (a.inc_o != nullptr) {
    load_elem<L>(a.inc_o, a.nj, j, x);
    load_elem<L>(a.inc_i, a.s, q, y);
    mont_mul<L>(x, y, f, incr);
  }
  const long long plane = static_cast<long long>(L) * a.ne;
  for (int k = 0; k < a.n_b; ++k) {
    load_elem<L>(a.b + k * plane, a.ne, pos, x);
    load_elem<L>(a.bc, a.nb, k, y);
    mont_mul<L>(x, y, f, t);
    add_mod<L>(acc, t, f, acc);
  }
  if (a.b_inc) {
    for (int k = 0; k < a.n_b; ++k) {
      load_elem<L>(a.b + k * plane, a.ne, pos, x);
      mont_mul<L>(x, incr, f, x);
      load_elem<L>(a.bc, a.nb, a.n_b + k, y);
      mont_mul<L>(x, y, f, t);
      add_mod<L>(acc, t, f, acc);
    }
  }
  for (int v = 0; v < a.n_v; ++v) {
    load_elem<L>(a.e + v * plane, a.ne, pos, x);
    load_elem<L>(a.lc, a.nl, v, y);
    mont_mul<L>(x, y, f, t);
    add_mod<L>(acc, t, f, acc);
    if (a.ps_inc) {
      mont_mul<L>(x, incr, f, x);
      load_elem<L>(a.lc, a.nl, a.n_v + v, y);
      mont_mul<L>(x, y, f, t);
      add_mod<L>(acc, t, f, acc);
    }
  }
  store_elem<L>(a.out, a.ne, pos, acc);
}

template <int L>
cudaError_t launch_tail(const TailArgs& a, const Field& f, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((a.ne + 127) / 128);
  lcomb_tail_kernel<L><<<blocks, 128, 0, st>>>(a, f);
  return cudaGetLastError();
}

}  // namespace gs

// ptrs: qe, b, e, dom_outer, dom_inner, incr_outer, incr_inner, inv, bc, lc,
// out (device pointers; b / incr may be null when absent).  dims: Ne, nj, s,
// ext, B, V, nb, nl, b_inc, ps_inc.  field_words: p limbs [L] then n0p;
// x_last: L limbs (Montgomery).
extern "C" int gs_lcomb_tail(int L, void* const* ptrs, const long long* dims,
                             const uint32_t* field_words,
                             const uint32_t* x_last, void* stream) {
  gs::TailArgs a = {};
  a.qe = static_cast<const int32_t*>(ptrs[0]);
  a.b = static_cast<const int32_t*>(ptrs[1]);
  a.e = static_cast<const int32_t*>(ptrs[2]);
  a.dom_o = static_cast<const int32_t*>(ptrs[3]);
  a.dom_i = static_cast<const int32_t*>(ptrs[4]);
  a.inc_o = static_cast<const int32_t*>(ptrs[5]);
  a.inc_i = static_cast<const int32_t*>(ptrs[6]);
  a.inv = static_cast<const int32_t*>(ptrs[7]);
  a.bc = static_cast<const int32_t*>(ptrs[8]);
  a.lc = static_cast<const int32_t*>(ptrs[9]);
  a.out = static_cast<int32_t*>(ptrs[10]);
  a.ne = dims[0];
  a.nj = static_cast<int>(dims[1]);
  a.s = static_cast<int>(dims[2]);
  a.ext = static_cast<int>(dims[3]);
  a.n_b = static_cast<int>(dims[4]);
  a.n_v = static_cast<int>(dims[5]);
  a.nb = static_cast<int>(dims[6]);
  a.nl = static_cast<int>(dims[7]);
  a.b_inc = static_cast<int>(dims[8]);
  a.ps_inc = static_cast<int>(dims[9]);
  if (a.ne <= 0) return 0;
  if ((a.b_inc || a.ps_inc) && a.inc_o == nullptr) return cudaErrorInvalidValue;
  for (int j = 0; j < L && j < gs::kMaxL; ++j) a.x_last[j] = x_last[j];
  const gs::Field f = gs::field_from_words(field_words, L);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 2: return gs::launch_tail<2>(a, f, st);
    case 4: return gs::launch_tail<4>(a, f, st);
    case 8: return gs::launch_tail<8>(a, f, st);
    case 14: return gs::launch_tail<14>(a, f, st);
    case 16: return gs::launch_tail<16>(a, f, st);
    default: return cudaErrorInvalidValue;
  }
}
