// Kernels 5 and 6: elementwise field ops and the factored power table;
// kernel A: a power of each element (the Fermat inverse of `inv`'s total).
//
// Kernel 5 (`field_ew`) replaces the TPU kernel genstark_tpu/field/pallas_ops.py
// `_ew_call` (:34, pallas_call :57): Montgomery mul, modular add and sub over
// [L, N] limb tiles.  Kernel 6 (`outer_table`) replaces `_outer_call` (:79,
// pallas_call :96): t[j*s + k] = outer[j] * inner[k].  Plain versions:
// genstark_tpu_torch/field/device.py (mont_mul_ref, add_ref, sub_ref,
// outer_table_ref).
//
// What bounds them on this card: kernel 5's Montgomery product (the 16-bit
// one, field.cuh mont_mul) at L limbs is ~2 L^2 32-bit multiplies plus the
// lazy-accumulator adds (~1,500 integer ops at L = 16) on 8L bytes in and 4L
// out, so mul is issue-bound for L >= 8 and add / sub (~6L ops) are
// memory-bound.  Kernel 6 writes 4L bytes a product and reads almost nothing
// (its factors are nj + s elements), so its bytes bound is the output alone;
// it runs the word product (mont_mul_w, 4k^2 + k multiplies for k = L/2),
// which sets its time at this code's product rate.  The plain torch
// formulation spends ~200 launches and a [2L+1, N] int64 accumulator in
// device memory per product; here one thread owns one element, its limbs
// and the accumulator live in registers, and each operand is read once and
// the result written once.
//
// Design: kernel 5 takes the DeviceField broadcast rule natively.  The
// wrapper (kernels.py field_ew) turns both operands into a limb stride plus
// up to four coalesced (size, stride) batch dims, stride 0 on a broadcast
// dim, so a scalar on either side, a strided view (fri.py's y[:, k]) and a
// batch against a broadcast constant all launch as they are, with no copy.
// Threads run along the flattened output, so the common case (one
// coalesced dim, unit stride) is a contiguous load per limb across a warp.
// The designs of kernels 6 and A are at their kernels below.  None of the
// TPU's tiling rules (2048-lane tiles, the 2^16-element minimum, L >= 8
// sublanes, 256 <= s <= 8192) applies.
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

// Kernel 6 on the word product (field.cuh mont_mul_w, K = L/2 words).  A
// block is a tile of `rows` consecutive j by kOuterCols consecutive k; thread
// t owns column k = k0 + t.  It reads inner[k] once, as words, into
// registers, and the block stages its rows' outer[j] once, as words, in
// shared memory; then each thread runs along j: one product, then L 4-byte
// stores, one to each limb plane, consecutive k across the warp (coalesced
// runs).  The launcher sizes `rows` so that the grid is one wave of resident
// blocks: a small table gets one or two products a thread and every SM, a
// 2^22-product table 16 a thread (8 blocks an SM at 32 registers).  No
// division by a runtime value.
constexpr int kOuterCols = 256;
constexpr int kOuterMaxRows = 64;

template <int K>
__global__ void __launch_bounds__(kOuterCols)
outer_table_kernel(const int32_t* __restrict__ outer, int nj, const int32_t* __restrict__ inner,
                   int s, int32_t* __restrict__ out, FieldW f, int rows, int k_tiles) {
  __shared__ uint32_t orow[kOuterMaxRows * K];
  const int kt = static_cast<int>(blockIdx.x % static_cast<unsigned>(k_tiles));
  const int j0 = static_cast<int>(blockIdx.x / static_cast<unsigned>(k_tiles)) * rows;
  const int nr = min(rows, nj - j0);
  const int k = kt * kOuterCols + threadIdx.x;
  // inner's loads go out before the staging's, so the two latencies overlap
  uint32_t b[K];
  if (k < s) load_elem_w<K>(inner, s, k, b);
  for (int i = threadIdx.x; i < nr * K; i += kOuterCols) {
    const int r = i / K, w = i % K;   // K is a compile-time constant
    orow[i] = static_cast<uint32_t>(__ldg(outer + (2 * w) * nj + j0 + r)) |
              (static_cast<uint32_t>(__ldg(outer + (2 * w + 1) * nj + j0 + r)) << 16);
  }
  __syncthreads();
  if (k >= s) return;
  const long long n = static_cast<long long>(nj) * s;
  long long i = static_cast<long long>(j0) * s + k;
  for (int r = 0; r < nr; ++r, i += s) {
    uint32_t a[K], t[K];
#pragma unroll
    for (int w = 0; w < K; ++w) a[w] = orow[r * K + w];
    mont_mul_w<K>(a, b, f, t);
    store_elem_w<K>(out, n, i, t);
  }
}

template <int K>
cudaError_t launch_outer(const int32_t* outer, int nj, const int32_t* inner, int s,
                         int32_t* out, const FieldW& f, cudaStream_t st) {
  // resident blocks of this instantiation on the card, read once
  static int resident = 0;
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, outer_table_kernel<K>,
                                                          kOuterCols, 0);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int k_tiles = (s + kOuterCols - 1) / kOuterCols;
  // the fewest rows a block that fit the grid in one wave, at most kOuterMaxRows
  const long long tiles = static_cast<long long>(nj) * k_tiles;
  long long rows = (tiles + resident - 1) / resident;
  rows = rows < 1 ? 1 : (rows > kOuterMaxRows ? kOuterMaxRows : rows);
  const long long blocks = (nj + rows - 1) / rows * k_tiles;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  outer_table_kernel<K><<<static_cast<unsigned>(blocks), kOuterCols, 0, st>>>(
      outer, nj, inner, s, out, f, static_cast<int>(rows), k_tiles);
  return cudaGetLastError();
}

// Kernel A: out = a^e for each element of a Montgomery-form [L, n] array,
// the Fermat ladder of the JAX package's `_fermat_inv_single`
// (genstark_tpu/field/device.py:329, which XLA computes: no Pallas kernel),
// on the word product.  Plain version: field/device.py mont_pow_ref.
// DeviceField.inv raises its total product to p - 2 with one launch of one
// element, so no inverse leaves the card.  What bounds it: nothing of the
// card's rates; one thread runs ~1.5 log2(e) dependent products, so its time
// is that chain's latency (a few microseconds at p256).  Design: one thread
// an element, the exponent's words by value, from the top bit down: square,
// then multiply where the bit is set.
constexpr int kMaxExpWords = 8;

struct PowArgs {
  uint32_t e[kMaxExpWords];   // exponent, little-endian words
  int nbits;                  // bit length of e (>= 1)
};

template <int K>
__global__ void __launch_bounds__(128)
mont_pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, long long n,
                PowArgs pa, FieldW f) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[K], r[K];
  load_elem_w<K>(a, n, i, x);
#pragma unroll
  for (int w = 0; w < K; ++w) r[w] = x[w];
  for (int bit = pa.nbits - 2; bit >= 0; --bit) {
    mont_mul_w<K>(r, r, f, r);
    if ((pa.e[bit >> 5] >> (bit & 31)) & 1u) mont_mul_w<K>(r, x, f, r);
  }
  store_elem_w<K>(out, n, i, r);
}

template <int K>
cudaError_t launch_pow(const int32_t* a, int32_t* out, long long n, const PowArgs& pa,
                       const FieldW& f, cudaStream_t st) {
  const long long blocks = (n + 127) / 128;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  mont_pow_kernel<K><<<static_cast<unsigned>(blocks), 128, 0, st>>>(a, out, n, pa, f);
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
  const gs::FieldW f = gs::fieldw_from_words(field_words, L);
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int32_t*>(outer);
  auto in = static_cast<const int32_t*>(inner);
  auto t = static_cast<int32_t*>(out);
  switch (L) {
    case 2: return gs::launch_outer<1>(o, nj, in, s, t, f, st);
    case 4: return gs::launch_outer<2>(o, nj, in, s, t, f, st);
    case 8: return gs::launch_outer<4>(o, nj, in, s, t, f, st);
    case 14: return gs::launch_outer<7>(o, nj, in, s, t, f, st);
    case 16: return gs::launch_outer<8>(o, nj, in, s, t, f, st);
    default: return cudaErrorInvalidValue;
  }
}

// a, out: int32 [L, n] contiguous (Montgomery); e: n_words little-endian
// words of the exponent, e >= 1.
extern "C" int gs_mont_pow(int L, const void* a, void* out, long long n, const uint32_t* e,
                           int n_words, const uint32_t* field_words, void* stream) {
  if (n <= 0) return 0;
  if (n_words < 1 || n_words > gs::kMaxExpWords) return cudaErrorInvalidValue;
  gs::PowArgs pa = {};
  pa.nbits = 0;
  for (int w = 0; w < n_words; ++w) {
    pa.e[w] = e[w];
    for (int b = 0; b < 32; ++b)
      if ((e[w] >> b) & 1u) pa.nbits = 32 * w + b + 1;
  }
  if (pa.nbits == 0) return cudaErrorInvalidValue;
  const gs::FieldW f = gs::fieldw_from_words(field_words, L);
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int32_t*>(a);
  auto o = static_cast<int32_t*>(out);
  switch (L) {
    case 2: return gs::launch_pow<1>(x, o, n, pa, f, st);
    case 4: return gs::launch_pow<2>(x, o, n, pa, f, st);
    case 8: return gs::launch_pow<4>(x, o, n, pa, f, st);
    case 14: return gs::launch_pow<7>(x, o, n, pa, f, st);
    case 16: return gs::launch_pow<8>(x, o, n, pa, f, st);
    default: return cudaErrorInvalidValue;
  }
}
