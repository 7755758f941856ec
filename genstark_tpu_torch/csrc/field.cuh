// 16-bit-limb prime-field arithmetic shared by every kernel of the port.
//
// CUDA counterparts of the JAX package's limb helpers in
// genstark_tpu/ntt/pallas_kernels.py: _mont_mul_limbs (:36), _cond_sub_p
// (:75), _add_mod (:88) and _sub_mod (:99).  An element is L 16-bit limbs,
// little-endian, each held in a uint32_t register.  Every function returns
// the canonical representative (< p), so a kernel built on these helpers is
// bit-identical to the plain torch field (genstark_tpu_torch/field/device.py)
// whatever order it applies them in.
#pragma once

#include <cstdint>

namespace gs {

constexpr int kMaxL = 16;

// Modulus limbs and n0' = -p^-1 mod 2^16, passed to kernels by value.
struct Field {
  uint32_t p[kMaxL];
  uint32_t n0p;
};

// value = carry * 2^(16L) + t < 2p  ->  t := value mod p (canonical).
template <int L>
__device__ __forceinline__ void cond_sub_p(uint32_t (&t)[L], uint32_t carry,
                                           const Field& f) {
  uint32_t diff[L];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint32_t s = t[j] - f.p[j] - borrow;
    diff[j] = s & 0xFFFFu;
    borrow = s >> 31;
  }
  const bool take = (carry != 0u) || (borrow == 0u);
#pragma unroll
  for (int j = 0; j < L; ++j) t[j] = take ? diff[j] : t[j];
}

// SOS Montgomery product a*b*R^-1 mod p with lazy (carry-free) uint32
// accumulators: every partial product is split into 16-bit halves, so no
// accumulator passes 2^22 for L <= 16.  `out` may alias `a` or `b`.
template <int L>
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[L],
                                         const uint32_t (&b)[L],
                                         const Field& f, uint32_t (&out)[L]) {
  uint32_t acc[2 * L + 1];
#pragma unroll
  for (int k = 0; k < 2 * L + 1; ++k) acc[k] = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint32_t prod = a[i] * b[k];
      acc[i + k] += prod & 0xFFFFu;
      acc[i + k + 1] += prod >> 16;
    }
  }
  uint32_t c = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t x = acc[i] + c;
    const uint32_t m = ((x & 0xFFFFu) * f.n0p) & 0xFFFFu;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint32_t mp = m * f.p[k];
      if (k == 0) {
        c = (x + (mp & 0xFFFFu)) >> 16;
      } else {
        acc[i + k] += mp & 0xFFFFu;
      }
      acc[i + k + 1] += mp >> 16;
    }
  }
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const uint32_t s = acc[L + k] + c;
    out[k] = s & 0xFFFFu;
    c = s >> 16;
  }
  cond_sub_p<L>(out, c, f);
}

// out = a + b mod p (canonical inputs).  `out` may alias `a` or `b`.
template <int L>
__device__ __forceinline__ void add_mod(const uint32_t (&a)[L],
                                        const uint32_t (&b)[L],
                                        const Field& f, uint32_t (&out)[L]) {
  uint32_t c = 0u;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t s = a[j] + b[j] + c;
    out[j] = s & 0xFFFFu;
    c = s >> 16;
  }
  cond_sub_p<L>(out, c, f);
}

// out = a - b mod p (canonical inputs).  `out` may alias `a` or `b`.
template <int L>
__device__ __forceinline__ void sub_mod(const uint32_t (&a)[L],
                                        const uint32_t (&b)[L],
                                        const Field& f, uint32_t (&out)[L]) {
  uint32_t t[L];
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t s = a[j] - b[j] - borrow;
    t[j] = s & 0xFFFFu;
    borrow = s >> 31;
  }
  uint32_t c = 0u;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t s = t[j] + f.p[j] + c;
    out[j] = borrow ? (s & 0xFFFFu) : t[j];
    c = s >> 16;
  }
}

// Load element `idx` of a limb-major int32 array [L, stride] into registers.
template <int L>
__device__ __forceinline__ void load_elem(const int32_t* __restrict__ base,
                                          long long stride, long long idx,
                                          uint32_t (&out)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j)
    out[j] = static_cast<uint32_t>(base[j * stride + idx]);
}

template <int L>
__device__ __forceinline__ void store_elem(int32_t* __restrict__ base,
                                           long long stride, long long idx,
                                           const uint32_t (&v)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) base[j * stride + idx] = static_cast<int32_t>(v[j]);
}

// Field from host words: p limbs [L], n0p (16-bit), n0p32 (32-bit).
inline Field field_from_words(const uint32_t* words, int L) {
  Field f = {};
  for (int j = 0; j < L; ++j) f.p[j] = words[j];
  f.n0p = words[L];
  return f;
}

// ------------------------------------------------------------------------
// The word product: K = L/2 32-bit words per element.
//
// Word w of an element is its limb pair (2w, 2w+1): w = limb[2w] |
// limb[2w+1] << 16.  Every L the port takes (2, 4, 8, 14, 16) is even, so
// R = 2^(32K) = 2^(16L): the Montgomery radix is the same as the 16-bit
// product's, and every Montgomery table, constant and R mod p of the port
// holds unchanged.  The results are canonical (< p), so a kernel may mix
// this product with mont_mul above and stay bit-identical to the plain
// field.
//
// Schedule (CIOS, carry chains in PTX): for each word b_i of b,
//   t += a * b_i        (low halves along one carry chain, high halves one
//                        word up along a second)
//   m  = t_0 * n0p32 mod 2^32
//   t += m * p          (the same two chains; t_0 becomes 0)
//   t >>= 32
// with t in K + 2 words; then one conditional subtract of p.  That is 4K^2
// multiply-adds and K quotient multiplies, the least roofline.mont_min_u32_ops
// counts.  tests/test_torch_words.py models this exact instruction sequence
// in numpy (carry flag included) against Python integers.
//
// The carry flag lives between separate `asm volatile` statements.  nvcc
// keeps volatile asm in order, but it does not promise to emit nothing that
// sets the flag between them, so the compiled code is what is checked:
// every run of chip_smoke.py holds each instantiation bit for bit against
// the plain field (kernel 4 and kernel 10's word chain at every L, kernel 1
// at L = 2 and 8 with both of its k-step counts), as does
// tests/test_torch_cuda.py on the card.  A broken chain shows there.
constexpr int kMaxK = kMaxL / 2;

struct FieldW {
  uint32_t p[kMaxK];
  uint32_t n0;        // -p^-1 mod 2^32
};

// Field words from host words: p limbs [L], n0p, n0p32.
inline FieldW fieldw_from_words(const uint32_t* words, int L) {
  FieldW f = {};
  for (int w = 0; w < L / 2; ++w) f.p[w] = words[2 * w] | (words[2 * w + 1] << 16);
  f.n0 = words[L + 1];
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

// Element `idx` of a limb-major int32 array [L, stride] as K = L/2 words.
template <int K>
__device__ __forceinline__ void load_elem_w(const int32_t* __restrict__ base,
                                            long long stride, long long idx,
                                            uint32_t (&out)[K]) {
#pragma unroll
  for (int w = 0; w < K; ++w)
    out[w] = static_cast<uint32_t>(__ldg(base + (2 * w) * stride + idx)) |
             (static_cast<uint32_t>(__ldg(base + (2 * w + 1) * stride + idx)) << 16);
}

template <int K>
__device__ __forceinline__ void store_elem_w(int32_t* __restrict__ base, long long stride,
                                             long long idx, const uint32_t (&v)[K]) {
#pragma unroll
  for (int w = 0; w < K; ++w) {
    base[(2 * w) * stride + idx] = static_cast<int32_t>(v[w] & 0xFFFFu);
    base[(2 * w + 1) * stride + idx] = static_cast<int32_t>(v[w] >> 16);
  }
}

}  // namespace gs
