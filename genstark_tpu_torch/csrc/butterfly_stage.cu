// Kernels 7 and 9: one radix-2 DIT butterfly stage over the whole array.
//
// Replaces two TPU kernels of genstark_tpu/ntt/pallas_kernels.py, reached
// via `butterfly_stage2` (:368) on the JAX package's direct route for
// transforms above 2^21 points (ntt/__init__.py:543-556):
//   - kernel 7, `_make_stage` (:120, pallas_call :177): m <= 4096, blocks of
//     whole 2m-groups;
//   - kernel 9, `_make_stage_split` (:308, pallas_call :342): m > 4096, lo
//     and hi fetched as two block-aligned views and re-interleaved by XLA.
// The two exist only because of VMEM block shapes.  Here one kernel computes
// both: one thread per butterfly, the butterfly's limbs in registers, 64-bit
// offsets, and no pre-broadcast [L, n/2] twiddle panel (the twiddle is read
// from the half-table at stride n/2m).  The wrapper counts its launches
// under the two rows' names by the JAX package's rule (m <= 4096 or not).
// Plain version: genstark_tpu_torch/ntt/radix2.py (butterfly_stage_ref, the
// JAX package's jnp stage, ntt/__init__.py:560-577).
//
// Butterfly j of group g of batch row b reads lo at g*2m + j and hi at
// g*2m + m + j and writes lo + w*hi, lo - w*hi in place, w = tw[j * n/2m].
//
// What bounds it on this card: each stage reads and writes the whole array,
// 2 * L * n * 4 bytes (512 MB at n = 2^22, L = 16: 0.153 ms at 3.35 TB/s),
// and does n/2 Montgomery products (2^21 at n = 2^22); which of the two is
// larger is for the probes of csrc/probes.cu to say.  Neighbouring threads
// take neighbouring j, so every limb load and store is contiguous across a
// warp for m >= 32 (the direct route runs this kernel for m >= 2048 only);
// the twiddle reads are strided for small m, where the m distinct twiddles
// are L2-resident.  One simple pass per stage: fusing several stages per
// pass (radix-4/8 in shared memory) is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace gs {

template <int L>
__global__ void __launch_bounds__(256)
butterfly_stage_kernel(int32_t* x, const int32_t* __restrict__ tw, long long n, int log_m,
                       int log_tstride, Field f) {
  const long long half = n >> 1;
  const long long bf = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (bf >= half) return;
  const long long m = 1LL << log_m;
  const long long j = bf & (m - 1);
  const long long lo = ((bf >> log_m) << (log_m + 1)) + j;
  int32_t* row = x + static_cast<long long>(blockIdx.y) * L * n;
  uint32_t u[L], v[L], w[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    u[l] = static_cast<uint32_t>(row[l * n + lo]);
    v[l] = static_cast<uint32_t>(row[l * n + lo + m]);
    w[l] = static_cast<uint32_t>(tw[l * half + (j << log_tstride)]);
  }
  mont_mul<L>(v, w, f, v);
  add_mod<L>(u, v, f, w);
  sub_mod<L>(u, v, f, v);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    row[l * n + lo] = static_cast<int32_t>(w[l]);
    row[l * n + lo + m] = static_cast<int32_t>(v[l]);
  }
}

template <int L>
cudaError_t launch_stage(int32_t* x, const int32_t* tw, int batch, int log_n, int log_m,
                         const Field& f, cudaStream_t st) {
  const long long half = 1LL << (log_n - 1);
  const dim3 grid(static_cast<unsigned>((half + 255) / 256), static_cast<unsigned>(batch));
  butterfly_stage_kernel<L><<<grid, 256, 0, st>>>(x, tw, 1LL << log_n, log_m,
                                                  log_n - 1 - log_m, f);
  return cudaGetLastError();
}

}  // namespace gs

// x: int32 [batch, L, 2^log_n] contiguous, updated in place; tw: int32
// [L, 2^(log_n - 1)], tw[k] = w^k (Montgomery) for the n-th root w.
extern "C" int gs_butterfly_stage(int L, void* x, const void* tw, int batch, int log_n,
                                  int log_m, const uint32_t* field_words, void* stream) {
  if (log_n < 1 || log_n > 40 || log_m < 0 || log_m >= log_n) return cudaErrorInvalidValue;
  if (batch < 0 || batch > 65535) return cudaErrorInvalidValue;
  if (((1LL << (log_n - 1)) + 255) / 256 > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const gs::Field f = gs::field_from_words(field_words, L);
  auto* d = static_cast<int32_t*>(x);
  auto* t = static_cast<const int32_t*>(tw);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 2: return gs::launch_stage<2>(d, t, batch, log_n, log_m, f, st);
    case 4: return gs::launch_stage<4>(d, t, batch, log_n, log_m, f, st);
    case 8: return gs::launch_stage<8>(d, t, batch, log_n, log_m, f, st);
    case 14: return gs::launch_stage<14>(d, t, batch, log_n, log_m, f, st);
    case 16: return gs::launch_stage<16>(d, t, batch, log_n, log_m, f, st);
    default: return cudaErrorInvalidValue;
  }
}
