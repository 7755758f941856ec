// Kernels 5 and 6: elementwise field ops and the factored power table.
//
// Kernel 5 (`field_ew`) replaces the TPU kernel genstark_tpu/field/pallas_ops.py
// `_ew_call` (:34, pallas_call :57): Montgomery mul, modular add and sub over
// [L, N] limb tiles.  Kernel 6 (`outer_table`) replaces `_outer_call` (:79,
// pallas_call :96): t[j*s + k] = outer[j] * inner[k].  Plain versions:
// genstark_tpu_torch/field/device.py (mont_mul_ref, add_ref, sub_ref,
// outer_table_ref).
//
// What bounds them on this card: a Montgomery product at L 16-bit limbs is
// ~2 L^2 32-bit multiplies plus the lazy-accumulator adds (~1,500 integer ops
// at L = 16) on 8L bytes in and 4L out, so mul is issue-bound for L >= 8 and
// add / sub (~6L ops) are memory-bound.  The plain torch formulation spends
// ~200 launches and a [2L+1, N] int64 accumulator in device memory per
// product; here one thread owns one element, its limbs and the accumulator
// live in registers, and each operand is read once and the result written
// once.
//
// Design: kernel 5 takes the DeviceField broadcast rule natively.  The
// wrapper (kernels.py field_ew) turns both operands into a limb stride plus
// up to four coalesced (size, stride) batch dims, stride 0 on a broadcast
// dim, so a scalar on either side, a strided view (fri.py's y[:, k]) and a
// batch against a broadcast constant all launch as they are, with no copy.
// Threads run along the flattened output, so the common case (one
// coalesced dim, unit stride) is a contiguous load per limb across a warp.
// None of the TPU's tiling rules (2048-lane tiles, the 2^16-element minimum,
// L >= 8 sublanes, 256 <= s <= 8192) applies.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace gs {

constexpr int kEwDims = 4;

struct EwArgs {
  const int32_t* a;
  const int32_t* b;
  int32_t* out;            // [L, n] contiguous
  long long n;             // elements per limb plane of the output
  long long la, lb;        // limb strides
  long long shape[kEwDims];
  long long sa[kEwDims], sb[kEwDims];
  int nd;
};

template <int L, int OP>
__global__ void __launch_bounds__(256) field_ew_kernel(EwArgs e, Field f) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= e.n) return;
  long long oa = 0, ob = 0, rem = i;
  for (int d = e.nd - 1; d >= 0; --d) {
    const long long k = d ? rem % e.shape[d] : rem;
    rem = d ? rem / e.shape[d] : 0;
    oa += k * e.sa[d];
    ob += k * e.sb[d];
  }
  uint32_t x[L], y[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    x[j] = static_cast<uint32_t>(e.a[j * e.la + oa]);
    y[j] = static_cast<uint32_t>(e.b[j * e.lb + ob]);
  }
  if (OP == 0) {
    mont_mul<L>(x, y, f, x);
  } else if (OP == 1) {
    add_mod<L>(x, y, f, x);
  } else {
    sub_mod<L>(x, y, f, x);
  }
  store_elem<L>(e.out, e.n, i, x);
}

template <int L>
cudaError_t launch_ew(int op, const EwArgs& e, const Field& f, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((e.n + 255) / 256);
  switch (op) {
    case 0: field_ew_kernel<L, 0><<<blocks, 256, 0, st>>>(e, f); break;
    case 1: field_ew_kernel<L, 1><<<blocks, 256, 0, st>>>(e, f); break;
    case 2: field_ew_kernel<L, 2><<<blocks, 256, 0, st>>>(e, f); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int L>
__global__ void __launch_bounds__(256) outer_table_kernel(const int32_t* __restrict__ outer,
                                                          int nj,
                                                          const int32_t* __restrict__ inner,
                                                          int s, int32_t* __restrict__ out,
                                                          Field f) {
  const long long n = static_cast<long long>(nj) * s;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long j = i / s, k = i - j * s;
  uint32_t x[L], y[L];
  load_elem<L>(outer, nj, j, x);
  load_elem<L>(inner, s, k, y);
  mont_mul<L>(x, y, f, x);
  store_elem<L>(out, n, i, x);
}

template <int L>
cudaError_t launch_outer(const int32_t* outer, int nj, const int32_t* inner, int s,
                         int32_t* out, const Field& f, cudaStream_t st) {
  const long long n = static_cast<long long>(nj) * s;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  outer_table_kernel<L><<<blocks, 256, 0, st>>>(outer, nj, inner, s, out, f);
  return cudaGetLastError();
}

}  // namespace gs

// op: 0 mul, 1 add, 2 sub.  a_str / b_str: limb stride then nd batch
// strides (0 on a broadcast dim); shape: nd batch sizes; out: int32 [L, prod].
extern "C" int gs_field_ew(int op, int L, const void* a, const long long* a_str,
                           const void* b, const long long* b_str, void* out, int nd,
                           const long long* shape, const uint32_t* field_words,
                           void* stream) {
  if (nd < 1 || nd > gs::kEwDims) return cudaErrorInvalidValue;
  gs::EwArgs e = {};
  e.a = static_cast<const int32_t*>(a);
  e.b = static_cast<const int32_t*>(b);
  e.out = static_cast<int32_t*>(out);
  e.nd = nd;
  e.la = a_str[0];
  e.lb = b_str[0];
  e.n = 1;
  for (int d = 0; d < nd; ++d) {
    e.shape[d] = shape[d];
    e.sa[d] = a_str[1 + d];
    e.sb[d] = b_str[1 + d];
    e.n *= shape[d];
  }
  if (e.n <= 0) return 0;
  const gs::Field f = gs::field_from_words(field_words, L);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 2: return gs::launch_ew<2>(op, e, f, st);
    case 4: return gs::launch_ew<4>(op, e, f, st);
    case 8: return gs::launch_ew<8>(op, e, f, st);
    case 14: return gs::launch_ew<14>(op, e, f, st);
    case 16: return gs::launch_ew<16>(op, e, f, st);
    default: return cudaErrorInvalidValue;
  }
}

// outer: int32 [L, nj]; inner: int32 [L, s]; out: int32 [L, nj * s].
extern "C" int gs_outer_table(int L, const void* outer, int nj, const void* inner, int s,
                              void* out, const uint32_t* field_words, void* stream) {
  if (nj <= 0 || s <= 0) return 0;
  const gs::Field f = gs::field_from_words(field_words, L);
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int32_t*>(outer);
  auto in = static_cast<const int32_t*>(inner);
  auto t = static_cast<int32_t*>(out);
  switch (L) {
    case 2: return gs::launch_outer<2>(o, nj, in, s, t, f, st);
    case 4: return gs::launch_outer<4>(o, nj, in, s, t, f, st);
    case 8: return gs::launch_outer<8>(o, nj, in, s, t, f, st);
    case 14: return gs::launch_outer<14>(o, nj, in, s, t, f, st);
    case 16: return gs::launch_outer<16>(o, nj, in, s, t, f, st);
    default: return cudaErrorInvalidValue;
  }
}
