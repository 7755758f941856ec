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

// Field from host words: p limbs [L] then n0p.
inline Field field_from_words(const uint32_t* words, int L) {
  Field f = {};
  for (int j = 0; j < L; ++j) f.p[j] = words[j];
  f.n0p = words[L];
  return f;
}

}  // namespace gs
