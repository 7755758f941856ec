// Kernels 10 and 11: the card's ceiling probes for the field kernels.
//
// Kernel 10 (`mont_chain`) replaces the TPU kernel scripts/roofline.py
// `_mont_chain_kernel` (:78, pallas_call :99): `depth` dependent Montgomery
// products per element with the limbs in fast memory; the slope between
// two depths is the Montgomery-multiply rate at L limbs (the fixed memory
// traffic cancels).  Two chains: the 16-bit-limb product squaring (v <- v*v,
// the JAX probe's chain), and the 32-bit-word product on general operands
// (v <- v*w, w the element's input, fixed), the product kernels 1 and 4 use;
// a square lets the compiler share the limb products a_i*a_k and a_k*a_i,
// which a general product cannot.  Kernel 11 (`u32_chain`) replaces
// scripts/vpu_bound.py `_kernel` (:24, pallas_call :40): K = 512 chained u32
// ops per element (128 iterations of add, xor with a shift, rotate by 16,
// add; counted as 5 ops per iteration as the JAX script counts them), the
// integer-op rate the hash kernels are held to; `rounds` repeats the chain,
// and on one element (one thread) the slope between two round counts is
// the latency of a dependent u32 op (4 of the 5 a round are on the chain:
// the shift of w runs beside them), the latency floor of the one-thread
// and one-block kernels A and B.  Plain versions:
// genstark_tpu_torch/roofline.py (mont_chain_ref, u32_chain_ref).
//
// What bounds them: by design, the integer instruction rate.  At depth 16 a
// 16-limb element is read and written once (128 bytes) around 16 products
// of ~1,500 integer ops; the chain of 128 iterations runs on one word read
// and written once.  One thread per element, everything in registers, so
// the measured rate is the ceiling of the same code shape as the field
// kernels (field.cuh) and the hash kernels (hash.cu).
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace gs {

template <int L>
__global__ void __launch_bounds__(256)
mont_chain_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                  int depth, Field f) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t v[L];
  load_elem<L>(x, n, i, v);
  for (int d = 0; d < depth; ++d) mont_mul<L>(v, v, f, v);
  store_elem<L>(out, n, i, v);
}

template <int K>
__global__ void __launch_bounds__(256)
mont_chain_w_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                    int depth, FieldW f) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t v[K], w[K];
  load_elem_w<K>(x, n, i, w);
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = w[j];
  for (int d = 0; d < depth; ++d) mont_mul_w<K>(v, w, f, v);
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

template <int L>
cudaError_t launch_mont_chain(const int32_t* x, int32_t* out, long long n, int depth,
                              int general, const uint32_t* field_words, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  if (general) {
    mont_chain_w_kernel<L / 2><<<blocks, 256, 0, st>>>(x, out, n, depth,
                                                      fieldw_from_words(field_words, L));
  } else {
    mont_chain_kernel<L><<<blocks, 256, 0, st>>>(x, out, n, depth,
                                                 field_from_words(field_words, L));
  }
  return cudaGetLastError();
}

}  // namespace gs

// x, out: int32 [L, n] contiguous (Montgomery limbs).  general = 0:
// out[:, i] = x[:, i] squared `depth` times (16-bit-limb product); general =
// 1: v = x[:, i], then v <- v * x[:, i] `depth` times (word product).
// field_words: p limbs [L], n0p, n0p32.
extern "C" int gs_mont_chain(int L, const void* x, void* out, long long n, int depth,
                             int general, const uint32_t* field_words, void* stream) {
  if (depth < 0 || n < 0 || (n + 255) / 256 > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  auto* a = static_cast<const int32_t*>(x);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 2: return gs::launch_mont_chain<2>(a, o, n, depth, general, field_words, st);
    case 4: return gs::launch_mont_chain<4>(a, o, n, depth, general, field_words, st);
    case 8: return gs::launch_mont_chain<8>(a, o, n, depth, general, field_words, st);
    case 14: return gs::launch_mont_chain<14>(a, o, n, depth, general, field_words, st);
    case 16: return gs::launch_mont_chain<16>(a, o, n, depth, general, field_words, st);
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
