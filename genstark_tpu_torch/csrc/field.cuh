// Prime-field arithmetic shared by every kernel of the port: the 32-bit-word
// Montgomery product and modular add / sub.
//
// CUDA counterparts of the JAX package's limb helpers in
// genstark_tpu/ntt/pallas_kernels.py: _mont_mul_limbs (:36), _cond_sub_p
// (:75), _add_mod (:88) and _sub_mod (:99).  At the port's boundary an
// element is L 16-bit limbs, little-endian, limb-major int32 [L, n] (the JAX
// layout); a kernel packs them into K = L/2 32-bit words in registers.  Word
// w of an element is its limb pair (2w, 2w+1): w = limb[2w] | limb[2w+1] <<
// 16.  Every L the port takes (2, 4, 8, 14, 16) is even, so R = 2^(32K) =
// 2^(16L): the Montgomery radix is the JAX package's, and every Montgomery
// table, constant and R mod p of the port holds unchanged.  Every function
// returns the canonical representative (< p), so a kernel built on these
// helpers is bit-identical to the plain torch field
// (genstark_tpu_torch/field/device.py, the 16-bit-limb schedule of
// _mont_mul_limbs) whatever order it applies them in.
//
// Schedule of the product (CIOS, carry chains in PTX): for each word b_i of b,
//   t += a * b_i        (low halves along one carry chain, high halves one
//                        word up along a second)
//   m  = t_0 * n0 mod 2^32
//   t += m * p          (the same two chains; t_0 becomes 0)
//   t >>= 32
// with t in K + 2 words; then one conditional subtract of p.  That is 4K^2
// multiply-adds and K quotient multiplies, the least roofline.mont_min_u32_ops
// counts.  The result is canonical whenever a * b < R p (a < R and b < p
// suffices: fiat_shamir.digest_words_to_field_mont multiplies a digest
// chunk below R by a constant below p).  tests/test_torch_words.py models
// this exact instruction sequence in numpy (carry flag included) against
// Python integers, and a butterfly of them against the plain transform.
//
// The carry flag lives between separate `asm volatile` statements.  nvcc
// keeps volatile asm in order, but it does not promise to emit nothing that
// sets the flag between them, so the compiled code is what is checked:
// every run of chip_smoke.py holds each kernel's instantiations bit for bit
// against the plain field at every L, on inputs with 0, 1 and p - 1 among
// them, as does tests/test_torch_cuda.py on the card.  A broken chain shows
// there.
#pragma once

#include <cstdint>

namespace gs {

constexpr int kMaxL = 16;
constexpr int kMaxK = kMaxL / 2;

struct FieldW {
  uint32_t p[kMaxK];
  uint32_t n0;        // -p^-1 mod 2^32
};

// Word w of an element from its limb pair (2w, 2w + 1).
__host__ __device__ __forceinline__ uint32_t limb_pair(uint32_t lo, uint32_t hi) {
  return lo | (hi << 16);
}

// Field words from host words: p limbs [L], then n0 (kernels._field_words).
inline FieldW fieldw_from_words(const uint32_t* words, int L) {
  FieldW f = {};
  for (int w = 0; w < L / 2 && w < kMaxK; ++w) f.p[w] = limb_pair(words[2 * w], words[2 * w + 1]);
  f.n0 = words[L];
  return f;
}

__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// value = hi * 2^(32K) + t < 2p  ->  out = value mod p (canonical).
template <int K>
__device__ __forceinline__ void cond_sub_p_w(const uint32_t (&t)[K], uint32_t hi,
                                             const FieldW& f, uint32_t (&out)[K]) {
  uint32_t d[K];
  d[0] = sub_cc(t[0], f.p[0]);
#pragma unroll
  for (int j = 1; j < K; ++j) d[j] = subc_cc(t[j], f.p[j]);
  // hi - borrow: all ones exactly when value < p
  const uint32_t top = subc(hi, 0u);
  const bool keep = top == 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < K; ++j) out[j] = keep ? t[j] : d[j];
}

// a * b * 2^(-32K) mod p, canonical.  `out` may alias `a` or `b`.
template <int K>
__device__ __forceinline__ void mont_mul_w(const uint32_t (&a)[K], const uint32_t (&b)[K],
                                           const FieldW& f, uint32_t (&out)[K]) {
  uint32_t t[K + 2];
#pragma unroll
  for (int j = 0; j < K + 2; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const uint32_t bi = b[i];
    t[0] = mad_lo_cc(a[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < K; ++j) t[j] = madc_lo_cc(a[j], bi, t[j]);
    t[K] = addc_cc(t[K], 0u);
    t[K + 1] = addc(t[K + 1], 0u);
    t[1] = mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < K; ++j) t[j + 1] = madc_hi_cc(a[j], bi, t[j + 1]);
    t[K + 1] = addc(t[K + 1], 0u);

    const uint32_t m = t[0] * f.n0;
    t[0] = mad_lo_cc(m, f.p[0], t[0]);
#pragma unroll
    for (int j = 1; j < K; ++j) t[j] = madc_lo_cc(m, f.p[j], t[j]);
    t[K] = addc_cc(t[K], 0u);
    t[K + 1] = addc(t[K + 1], 0u);
    t[1] = mad_hi_cc(m, f.p[0], t[1]);
#pragma unroll
    for (int j = 1; j < K; ++j) t[j + 1] = madc_hi_cc(m, f.p[j], t[j + 1]);
    t[K + 1] = addc(t[K + 1], 0u);
#pragma unroll
    for (int j = 0; j < K + 1; ++j) t[j] = t[j + 1];
    t[K + 1] = 0u;
  }
  uint32_t r[K];
#pragma unroll
  for (int j = 0; j < K; ++j) r[j] = t[j];
  cond_sub_p_w<K>(r, t[K], f, out);
}

// out = a + b mod p (canonical inputs).  `out` may alias `a` or `b`.
template <int K>
__device__ __forceinline__ void add_mod_w(const uint32_t (&a)[K], const uint32_t (&b)[K],
                                          const FieldW& f, uint32_t (&out)[K]) {
  uint32_t s[K];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < K; ++j) s[j] = addc_cc(a[j], b[j]);
  const uint32_t hi = addc(0u, 0u);
  cond_sub_p_w<K>(s, hi, f, out);
}

// out = a - b mod p (canonical inputs).  `out` may alias `a` or `b`.
template <int K>
__device__ __forceinline__ void sub_mod_w(const uint32_t (&a)[K], const uint32_t (&b)[K],
                                          const FieldW& f, uint32_t (&out)[K]) {
  uint32_t d[K];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < K; ++j) d[j] = subc_cc(a[j], b[j]);
  const uint32_t mask = subc(0u, 0u);   // all ones when a < b
  out[0] = add_cc(d[0], f.p[0] & mask);
#pragma unroll
  for (int j = 1; j < K; ++j) out[j] = addc_cc(d[j], f.p[j] & mask);
}

// A limb read: int32 arrays in device memory through the read-only cache (a
// launch must not write what it reads so), uint32 tiles in shared memory
// directly.
__device__ __forceinline__ uint32_t read_limb(const int32_t* p) {
  return static_cast<uint32_t>(__ldg(p));
}
__device__ __forceinline__ uint32_t read_limb(const uint32_t* p) { return *p; }

// Offsets into limb rows: 64-bit in device memory (an [L, n] array may pass
// 2^31 words), 32-bit in a shared-memory tile.
template <typename T> struct RowIndex { using type = long long; };
template <> struct RowIndex<uint32_t> { using type = int; };

// The element at offset `idx` of limb rows `stride` apart, as K = L/2 words:
// a limb-major int32 array in device memory (a contiguous [L, stride], or any
// strided or broadcast view), or a kernel's uint32 limb tile in shared memory.
template <int K, typename T>
__device__ __forceinline__ void load_elem_w(const T* base, typename RowIndex<T>::type stride,
                                            typename RowIndex<T>::type idx,
                                            uint32_t (&out)[K]) {
#pragma unroll
  for (int w = 0; w < K; ++w)
    out[w] = limb_pair(read_limb(base + (2 * w) * stride + idx),
                       read_limb(base + (2 * w + 1) * stride + idx));
}

template <int K, typename T>
__device__ __forceinline__ void store_elem_w(T* base, typename RowIndex<T>::type stride,
                                             typename RowIndex<T>::type idx,
                                             const uint32_t (&v)[K]) {
#pragma unroll
  for (int w = 0; w < K; ++w) {
    base[(2 * w) * stride + idx] = static_cast<T>(v[w] & 0xFFFFu);
    base[(2 * w + 1) * stride + idx] = static_cast<T>(v[w] >> 16);
  }
}

}  // namespace gs
