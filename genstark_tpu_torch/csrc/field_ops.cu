// Kernels 5 and 6: elementwise field ops and the factored power table;
// kernel A: the inverse of each element (`inv`'s total).
//
// Kernel 5 (`field_ew`) replaces the TPU kernel genstark_tpu/field/pallas_ops.py
// `_ew_call` (:34, pallas_call :57): Montgomery mul, modular add and sub over
// [L, N] limb tiles.  Kernel 6 (`outer_table`) replaces `_outer_call` (:79,
// pallas_call :96): t[j*s + k] = outer[j] * inner[k].  Plain versions:
// genstark_tpu_torch/field/device.py (mont_mul_ref, add_ref, sub_ref,
// outer_table_ref).
//
// What bounds them on this card: kernel 5's Montgomery product (field.cuh
// mont_mul_w on K = L/2 words: 4K^2 + K multiplies in PTX carry chains,
// 264 at L = 16) on 8L bytes in and 4L out, so mul is issue-bound for L >=
// 8 and add / sub (~3K ops) are memory-bound.  Kernel 6 writes 4L bytes a
// product and reads almost nothing (its factors are nj + s elements), so
// its bytes bound is the output alone; it runs the same word product,
// which sets its time at this code's product rate.  The plain torch
// formulation spends ~200 launches and a [2L+1, N] int64 accumulator in
// device memory per product; here one thread owns one element, its words
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

template <int K, int OP>
__global__ void __launch_bounds__(256) field_ew_kernel(EwArgs e, FieldW f) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= e.n) return;
  long long oa = 0, ob = 0, rem = i;
  for (int d = e.nd - 1; d >= 0; --d) {
    const long long k = d ? rem % e.shape[d] : rem;
    rem = d ? rem / e.shape[d] : 0;
    oa += k * e.sa[d];
    ob += k * e.sb[d];
  }
  // each operand at its own limb stride and offset: a strided or broadcast
  // view launches as it is
  uint32_t x[K], y[K];
  load_elem_w<K>(e.a, e.la, oa, x);
  load_elem_w<K>(e.b, e.lb, ob, y);
  if (OP == 0) {
    mont_mul_w<K>(x, y, f, x);
  } else if (OP == 1) {
    add_mod_w<K>(x, y, f, x);
  } else {
    sub_mod_w<K>(x, y, f, x);
  }
  store_elem_w<K>(e.out, e.n, i, x);
}

template <int K>
cudaError_t launch_ew(int op, const EwArgs& e, const FieldW& f, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((e.n + 255) / 256);
  switch (op) {
    case 0: field_ew_kernel<K, 0><<<blocks, 256, 0, st>>>(e, f); break;
    case 1: field_ew_kernel<K, 1><<<blocks, 256, 0, st>>>(e, f); break;
    case 2: field_ew_kernel<K, 2><<<blocks, 256, 0, st>>>(e, f); break;
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
    orow[i] = limb_pair(read_limb(outer + (2 * w) * nj + j0 + r),
                        read_limb(outer + (2 * w + 1) * nj + j0 + r));
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

// Kernel A: out = a^-1 for each element of a Montgomery-form [L, n] array
// (0 -> 0), the inverse that the JAX package's `_fermat_inv_single`
// (genstark_tpu/field/device.py:325, computed by XLA: no Pallas kernel)
// takes as total^(p-2).  Plain version: field/device.py mont_pow_ref(a,
// p - 2); the inverse is unique, so both give the same words.
// DeviceField.inv inverts its total product with one launch of one element,
// so no inverse leaves the card.
//
// What bounds it: nothing of the card's rates.  One element's dependent
// chain, and its instructions issued one a cycle by one warp, are its time;
// the Fermat ladder it replaces was ~1.5 log2(p) dependent word products
// (503 at p256, 0.28 ms).  Design: Pornin's optimized binary GCD (IACR
// ePrint 2020/972, Algorithm 2) on the K = L/2 words of FieldW, four lanes
// an element (a quad of a warp).  a = x, b = p, u = 1, v = 0 keep
// a = u x and b = v x (mod p).  Each of T = ceil((2 len(p) - 1) / 30)
// batches (18 at p256) runs 30 binary-GCD steps on 64-bit approximations
// of a and b (their low 31 bits and top 33 bits, exact once both fit 64
// bits), collecting the steps as a 2x2 matrix of signed 32-bit factors (|f|
// + |g| <= 2^30; the paper's 31 steps would need 2^31, one bit more than an
// int holds).  Every lane of the quad runs the steps alike; then lane q
// applies the matrix to one of the words: a, b <- (f a + g b) / 2^30,
// negated to stay non-negative (lanes 0, 1), and u, v <- (f u + g v) / 2^32
// mod p (one Montgomery word reduction, which is exact; lanes 2, 3, which
// negate where lanes 0, 1 did), and four shuffles a word give every lane
// the new a, b, u, v: the four updates run side by side.  After T
// batches b = 1
// and v = x^-1 2^-2T; the host folds 2^2T and the Montgomery adjustment
// into one constant c = 2^2T R^3 mod p, and one word product v c R^-1 gives
// x^-1 R^2, the Montgomery form of a^-1 for x = a R.  A step's chain is a
// 64-bit subtraction both ways, a select and a shift; the factors' 32-bit
// updates issue beside it.
constexpr int kGcdSteps = 30;

template <int K>
__device__ __forceinline__ unsigned long long gcd_approx(const uint32_t (&x)[K], int s) {
  // (x mod 2^31) + 2^31 floor(x / 2^s), floor(x / 2^s) < 2^33, s >= 31
  const int q = s >> 5, r = s & 31;
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int w = 0; w < K; ++w) {
    if (w == q) lo = x[w];
    if (w == q + 1) hi = x[w];
  }
  const unsigned long long top = ((static_cast<unsigned long long>(hi) << 32) | lo) >> r;
  return (static_cast<unsigned long long>(x[0]) & 0x7FFFFFFFull) | (top << 31);
}

// out = x * f as K + 1 two's complement words, |f| <= 2^30.
template <int K>
__device__ __forceinline__ void gcd_mul_signed(const uint32_t (&x)[K], int f,
                                               uint32_t (&out)[K + 1]) {
  const bool neg = f < 0;
  const uint32_t m = static_cast<uint32_t>(neg ? -f : f);
  unsigned long long c = 0ull;
#pragma unroll
  for (int w = 0; w < K; ++w) {
    c += static_cast<unsigned long long>(x[w]) * m;
    out[w] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  out[K] = static_cast<uint32_t>(c);
  if (neg) {
    c = 1ull;
#pragma unroll
    for (int w = 0; w <= K; ++w) {
      c += static_cast<uint32_t>(~out[w]);
      out[w] = static_cast<uint32_t>(c);
      c >>= 32;
    }
  }
}

// The update that lane q of an element's quad computes, every lane on the
// same instructions but the last few: (x, y) = (a, b) for q = 0, 1 and (u,
// v) for q = 2, 3, and t = x f + y g as K + 1 two's complement words.  q =
// 0, 1: out = |t| / 2^30 (exact), the new a or b; q = 2, 3: out = t 2^-32
// mod p (one Montgomery word on the signed t, |t| < p 2^30, so the quotient
// lies in (-p/4, 5p/4)), the new u or v before the sign fix.  Returns
// whether t < 0.
template <int K>
__device__ __forceinline__ bool gcd_lane_update(int q, const uint32_t (&a)[K],
                                                const uint32_t (&b)[K], const uint32_t (&u)[K],
                                                const uint32_t (&v)[K], int f, int g,
                                                const FieldW& fw, uint32_t (&out)[K]) {
  uint32_t x[K], y[K], px[K + 1], py[K + 1], t[K + 1];
#pragma unroll
  for (int w = 0; w < K; ++w) {
    x[w] = q < 2 ? a[w] : u[w];
    y[w] = q < 2 ? b[w] : v[w];
  }
  gcd_mul_signed<K>(x, f, px);
  gcd_mul_signed<K>(y, g, py);
  unsigned long long c = 0ull;
#pragma unroll
  for (int w = 0; w <= K; ++w) {
    c += static_cast<unsigned long long>(px[w]) + py[w];
    t[w] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  const bool neg = (t[K] >> 31) != 0u;
  if (q < 2) {
    // |t| < 2^(32K + 30): its low K words after the shift, negated if negative
#pragma unroll
    for (int w = 0; w < K; ++w)
      out[w] = (t[w] >> kGcdSteps) | (t[w + 1] << (32 - kGcdSteps));
    if (neg) {
      c = 1ull;
#pragma unroll
      for (int w = 0; w < K; ++w) {
        c += static_cast<uint32_t>(~out[w]);
        out[w] = static_cast<uint32_t>(c);
        c >>= 32;
      }
    }
  } else {
    // s = (t + m p) / 2^32, t's sign word extended above word K
    const uint32_t m = t[0] * fw.n0;
    uint32_t r[K];
    c = (static_cast<unsigned long long>(m) * fw.p[0] + t[0]) >> 32;
#pragma unroll
    for (int w = 1; w < K; ++w) {
      c += static_cast<unsigned long long>(m) * fw.p[w] + t[w];
      r[w - 1] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[K];
    r[K - 1] = static_cast<uint32_t>(c);
    const uint32_t hi = static_cast<uint32_t>(c >> 32) + (neg ? 0xFFFFFFFFu : 0u);
    if (hi == 0xFFFFFFFFu) {   // s < 0: s + p
      c = 0ull;
#pragma unroll
      for (int w = 0; w < K; ++w) {
        c += static_cast<unsigned long long>(r[w]) + fw.p[w];
        out[w] = static_cast<uint32_t>(c);
        c >>= 32;
      }
    } else {                   // 0 <= s < 2p
      cond_sub_p_w<K>(r, hi, fw, out);
    }
  }
  return neg;
}

struct InvArgs {
  uint32_t c[kMaxK];   // 2^2T R^3 mod p, little-endian words
  int batches;         // T
};

template <int K>
__global__ void __launch_bounds__(128)
mont_inv_kernel(const int32_t* __restrict__ x_in, int32_t* __restrict__ out, long long n,
                InvArgs ia, FieldW f) {
  // a quad of lanes an element; a quad past the end works on the last
  // element (the shuffles take whole warps) and stores nothing
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 2;
  const int lane = static_cast<int>(threadIdx.x & 3u);
  uint32_t a[K], b[K], u[K], v[K];
  load_elem_w<K>(x_in, n, i < n ? i : n - 1, a);
#pragma unroll
  for (int w = 0; w < K; ++w) {
    b[w] = f.p[w];
    u[w] = w == 0 ? 1u : 0u;
    v[w] = 0u;
  }
  for (int it = 0; it < ia.batches; ++it) {
    int len = 64;
#pragma unroll
    for (int w = 0; w < K; ++w) {
      const uint32_t o = a[w] | b[w];
      if (o != 0u && 32 * w + 32 - __clz(o) > len) len = 32 * w + 32 - __clz(o);
    }
    unsigned long long ab = gcd_approx<K>(a, len - 33), bb = gcd_approx<K>(b, len - 33);
    int f0 = 1, g0 = 0, f1 = 0, g1 = 1;
#pragma unroll
    for (int j = 0; j < kGcdSteps; ++j) {
      // odd a: a <- |a - b| / 2 and b <- min(a, b) (the swap where a < b);
      // even a: a <- a / 2
      const bool odd = (ab & 1ull) != 0ull;
      const bool swap = odd && ab < bb;
      const unsigned long long d = ab - bb, e = bb - ab;
      const int df = f0 - f1, dg = g0 - g1;
      bb = swap ? ab : bb;
      ab = (odd ? (swap ? e : d) : ab) >> 1;
      const int nf1 = swap ? f0 : f1, ng1 = swap ? g0 : g1;
      f0 = odd ? (swap ? -df : df) : f0;
      g0 = odd ? (swap ? -dg : dg) : g0;
      f1 = nf1 * 2;
      g1 = ng1 * 2;
    }
    // lanes 0-3: the new a, b, u, v; u and v change sign where a and b did
    uint32_t r[K];
    const bool neg = gcd_lane_update<K>(lane, a, b, u, v, (lane & 1) ? f1 : f0,
                                        (lane & 1) ? g1 : g0, f, r);
    const bool flip = __shfl_sync(0xFFFFFFFFu, static_cast<int>(neg), lane & 1, 4) != 0;
    if (lane >= 2 && flip) {
      uint32_t z[K];
#pragma unroll
      for (int w = 0; w < K; ++w) z[w] = 0u;
      sub_mod_w<K>(z, r, f, r);
    }
#pragma unroll
    for (int w = 0; w < K; ++w) {
      a[w] = __shfl_sync(0xFFFFFFFFu, r[w], 0, 4);
      b[w] = __shfl_sync(0xFFFFFFFFu, r[w], 1, 4);
      u[w] = __shfl_sync(0xFFFFFFFFu, r[w], 2, 4);
      v[w] = __shfl_sync(0xFFFFFFFFu, r[w], 3, 4);
    }
  }
  if (lane != 0 || i >= n) return;
  uint32_t c[K], r[K];
#pragma unroll
  for (int w = 0; w < K; ++w) c[w] = ia.c[w];
  mont_mul_w<K>(v, c, f, r);
  store_elem_w<K>(out, n, i, r);
}

template <int K>
cudaError_t launch_inv(const int32_t* a, int32_t* out, long long n, const InvArgs& ia,
                       const FieldW& f, cudaStream_t st) {
  const long long blocks = (4 * n + 127) / 128;     // four lanes an element
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  mont_inv_kernel<K><<<static_cast<unsigned>(blocks), 128, 0, st>>>(a, out, n, ia, f);
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
  const gs::FieldW f = gs::fieldw_from_words(field_words, L);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 2: return gs::launch_ew<1>(op, e, f, st);
    case 4: return gs::launch_ew<2>(op, e, f, st);
    case 8: return gs::launch_ew<4>(op, e, f, st);
    case 14: return gs::launch_ew<7>(op, e, f, st);
    case 16: return gs::launch_ew<8>(op, e, f, st);
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

// a, out: int32 [L, n] contiguous (Montgomery); c: L/2 little-endian words
// of 2^(2 batches) R^3 mod p; batches: ceil((2 len(p) - 1) / 30).
extern "C" int gs_mont_inv(int L, const void* a, void* out, long long n, const uint32_t* c,
                           int batches, const uint32_t* field_words, void* stream) {
  if (n <= 0) return 0;
  if (batches < 1 || batches > 64) return cudaErrorInvalidValue;
  gs::InvArgs ia = {};
  for (int w = 0; w < L / 2 && w < gs::kMaxK; ++w) ia.c[w] = c[w];
  ia.batches = batches;
  const gs::FieldW f = gs::fieldw_from_words(field_words, L);
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int32_t*>(a);
  auto o = static_cast<int32_t*>(out);
  switch (L) {
    case 2: return gs::launch_inv<1>(x, o, n, ia, f, st);
    case 4: return gs::launch_inv<2>(x, o, n, ia, f, st);
    case 8: return gs::launch_inv<4>(x, o, n, ia, f, st);
    case 14: return gs::launch_inv<7>(x, o, n, ia, f, st);
    case 16: return gs::launch_inv<8>(x, o, n, ia, f, st);
    default: return cudaErrorInvalidValue;
  }
}
