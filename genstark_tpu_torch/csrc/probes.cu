// Kernels 10 and 11: the card's ceiling probes for the field kernels.
//
// Kernel 10 (`mont_chain`) replaces the TPU kernel scripts/roofline.py
// `_mont_chain_kernel` (:78, pallas_call :99): `depth` dependent Montgomery
// squarings per element (v <- v*v, the JAX probe's chain) with the element
// in fast memory; the slope between two depths is the Montgomery-multiply
// rate at L limbs (the fixed memory traffic cancels).  It squares on the
// word product (field.cuh mont_mul_w, K = L/2 words), the one product of
// every field kernel of the port.  A square shares no work with a general
// product there: each step is the same PTX carry chains in `asm volatile`,
// which the compiler neither merges nor reorders (a_i*a_k and a_k*a_i are
// two multiply-adds), so one chain gives the rate of every kernel's
// product.  Kernel 11 (`u32_chain`) replaces scripts/vpu_bound.py `_kernel`
// (:24, pallas_call :40): K = 512 chained u32 ops per element (128
// iterations of add, xor with a shift, rotate by 16, add; counted as 5 ops
// per iteration as the JAX script counts them), the integer-op rate the
// hash kernels are held to; `rounds` repeats the chain, and on one element
// (one thread) the slope between two round counts is the latency of a
// dependent u32 op (4 of the 5 a round are on the chain: the shift of w
// runs beside them), the latency floor of the one-thread and one-block
// kernels A and B.  Plain versions: genstark_tpu_torch/roofline.py
// (mont_chain_ref, the 16-bit-limb product of the plain field;
// u32_chain_ref).
//
// What bounds them: by design, the integer instruction rate.  At depth 16 a
// 16-limb element is read and written once (128 bytes) around 16 products
// of 4K^2 + K = 264 multiply-adds and their carry adds; the chain of 128
// iterations runs on one word read and written once.  One thread per
// element, everything in registers, so the measured rate is the ceiling of
// the same code shape as the field kernels (field.cuh) and the hash kernels
// (hash.cu).
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace gs {

template <int K>
__global__ void __launch_bounds__(256)
mont_chain_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                  int depth, FieldW f) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t v[K];
  load_elem_w<K>(x, n, i, v);
  for (int d = 0; d < depth; ++d) mont_mul_w<K>(v, v, f, v);
  store_elem_w<K>(out, n, i, v);
}

constexpr int kU32ChainK = 512;

__global__ void __launch_bounds__(256)
u32_chain_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, long long n,
                 int rounds) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t v = x[i];
  uint32_t w = v ^ 0x9E3779B9u;
  for (int r = 0; r < rounds; ++r) {
#pragma unroll 16
    for (int k = 0; k < kU32ChainK / 4; ++k) {
      v = v + w;
      v = v ^ (w >> 7);
      v = (v >> 16) | (v << 16);
      w = w + v;
    }
  }
  out[i] = v;
}

template <int K>
cudaError_t launch_mont_chain(const int32_t* x, int32_t* out, long long n, int depth,
                              const FieldW& f, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  mont_chain_kernel<K><<<blocks, 256, 0, st>>>(x, out, n, depth, f);
  return cudaGetLastError();
}

}  // namespace gs

// x, out: int32 [L, n] contiguous (Montgomery limbs): out[:, i] = x[:, i]
// squared `depth` times.  field_words: p limbs [L], n0.
extern "C" int gs_mont_chain(int L, const void* x, void* out, long long n, int depth,
                             const uint32_t* field_words, void* stream) {
  if (depth < 0 || n < 0 || (n + 255) / 256 > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  auto* a = static_cast<const int32_t*>(x);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const gs::FieldW f = gs::fieldw_from_words(field_words, L);
  switch (L) {
    case 2: return gs::launch_mont_chain<1>(a, o, n, depth, f, st);
    case 4: return gs::launch_mont_chain<2>(a, o, n, depth, f, st);
    case 8: return gs::launch_mont_chain<4>(a, o, n, depth, f, st);
    case 14: return gs::launch_mont_chain<7>(a, o, n, depth, f, st);
    case 16: return gs::launch_mont_chain<8>(a, o, n, depth, f, st);
    default: return cudaErrorInvalidValue;
  }
}

// x, out: n u32 words (int32 storage), contiguous; rounds >= 1.
extern "C" int gs_u32_chain(const void* x, void* out, long long n, int rounds, void* stream) {
  if (n < 0 || (n + 255) / 256 > 0x7FFFFFFFLL || rounds < 1) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  gs::u32_chain_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n, rounds);
  return cudaGetLastError();
}
