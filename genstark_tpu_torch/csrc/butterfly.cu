// Kernel 8: the local radix-2 transform (every butterfly stage in one block).
//
// Replaces the TPU kernel genstark_tpu/ntt/pallas_kernels.py
// `_make_multistage` (:204, pallas_call :266, reached via `multistage`
// :286): all radix-2 DIT stages of an n-point transform on one block of
// data kept in fast memory.  Plain version: genstark_tpu_torch/ntt/radix2.py
// (butterfly_ref, the JAX package's jnp stage loop, ntt/__init__.py:560-577,
// with the bit reversal of :400-408,534).
//
// What bounds it on this card: a butterfly is one Montgomery product and a
// modular add and sub (~1,600 integer ops at L = 16) on 2 elements, so the
// stages are issue-bound; device memory is touched once per transform (one
// read, one write of L x n limbs).  Design: one block owns one local
// transform of one batch row.  It loads the row into shared memory, bit-
// reversing the index as it loads, runs all log2(n) stages there with one
// barrier between stages (one thread per butterfly, each butterfly's limbs
// in registers), and writes the result back in natural order.  Input and
// output are strided views [B, G, L, n], so the four-step split around the
// kernel (ntt/radix2.py) needs no transposes: the first pass reads columns
// and writes a layout the twiddle multiply (kernel 5) and the second pass
// read directly, and the second pass writes natural order.  Shared memory
// bounds the local size: L x n int32 limbs per block, 128 KB at L = 16 and
// n = 2048 (dynamic shared memory, opted in above 48 KB), so the port's
// local limit is 2048 points at L = 16 (the TPU's _MBLK = 2048 butterflies
// per block was sized for VMEM and is not used).  Twiddles are read from the
// local root's half-table in device memory (L1 / L2 resident).
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace gs {

struct BflyArgs {
  const int32_t* x;        // [B, G, L, n] strided
  int32_t* out;            // [B, G, L, n] strided
  const int32_t* tw;       // [L, n/2] contiguous: w^k, Montgomery
  long long xs[4], os[4];  // element strides of (B, G, L, n)
  int groups;              // G
  int log_n;
};

template <int L>
__global__ void __launch_bounds__(256) butterfly_kernel(BflyArgs a, Field f) {
  extern __shared__ uint32_t sm[];  // [L][n]
  const int n = 1 << a.log_n;
  const int half = n >> 1;
  const long long b = blockIdx.x / a.groups, g = blockIdx.x % a.groups;
  const int32_t* src = a.x + b * a.xs[0] + g * a.xs[1];
  for (int idx = threadIdx.x; idx < L * n; idx += blockDim.x) {
    const int l = idx >> a.log_n, j = idx & (n - 1);
    const int r = static_cast<int>(__brev(static_cast<unsigned>(j)) >> (32 - a.log_n));
    sm[l * n + r] = static_cast<uint32_t>(src[l * a.xs[2] + j * a.xs[3]]);
  }
  __syncthreads();
  for (int lm = 0; lm < a.log_n; ++lm) {
    const int m = 1 << lm;
    const int tstride = half >> lm;  // w_(2m)^r = w^(r * n / 2m)
    for (int bf = threadIdx.x; bf < half; bf += blockDim.x) {
      const int r = bf & (m - 1);
      const int i0 = ((bf >> lm) << (lm + 1)) + r;
      const int i1 = i0 + m;
      uint32_t u[L], v[L], w[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        u[l] = sm[l * n + i0];
        v[l] = sm[l * n + i1];
        w[l] = static_cast<uint32_t>(a.tw[l * half + r * tstride]);
      }
      mont_mul<L>(v, w, f, v);
      add_mod<L>(u, v, f, w);
      sub_mod<L>(u, v, f, v);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        sm[l * n + i0] = w[l];
        sm[l * n + i1] = v[l];
      }
    }
    __syncthreads();
  }
  int32_t* dst = a.out + b * a.os[0] + g * a.os[1];
  for (int idx = threadIdx.x; idx < L * n; idx += blockDim.x) {
    const int l = idx >> a.log_n, j = idx & (n - 1);
    dst[l * a.os[2] + j * a.os[3]] = static_cast<int32_t>(sm[l * n + j]);
  }
}

template <int L>
cudaError_t launch_butterfly(const BflyArgs& a, long long n_blocks, const Field& f,
                             cudaStream_t st) {
  const int n = 1 << a.log_n;
  const size_t smem = static_cast<size_t>(L) * n * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        butterfly_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = n / 2 < 256 ? n / 2 : 256;
  butterfly_kernel<L><<<static_cast<unsigned>(n_blocks), threads, smem, st>>>(a, f);
  return cudaGetLastError();
}

}  // namespace gs

// x_strides / out_strides: element strides of (B, G, L, n); tw: int32 [L, n/2].
extern "C" int gs_butterfly(int L, const void* x, const long long* x_strides, void* out,
                            const long long* out_strides, const void* tw, int batch,
                            int groups, int log_n, const uint32_t* field_words,
                            void* stream) {
  if (log_n < 1 || log_n > 16 || groups <= 0 || batch < 0) return cudaErrorInvalidValue;
  if (batch == 0) return 0;
  gs::BflyArgs a = {};
  a.x = static_cast<const int32_t*>(x);
  a.out = static_cast<int32_t*>(out);
  a.tw = static_cast<const int32_t*>(tw);
  for (int d = 0; d < 4; ++d) {
    a.xs[d] = x_strides[d];
    a.os[d] = out_strides[d];
  }
  a.groups = groups;
  a.log_n = log_n;
  const long long n_blocks = static_cast<long long>(batch) * groups;
  if (n_blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const gs::Field f = gs::field_from_words(field_words, L);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 2: return gs::launch_butterfly<2>(a, n_blocks, f, st);
    case 4: return gs::launch_butterfly<4>(a, n_blocks, f, st);
    case 8: return gs::launch_butterfly<8>(a, n_blocks, f, st);
    case 14: return gs::launch_butterfly<14>(a, n_blocks, f, st);
    case 16: return gs::launch_butterfly<16>(a, n_blocks, f, st);
    default: return cudaErrorInvalidValue;
  }
}
