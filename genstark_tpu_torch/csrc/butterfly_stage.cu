// Kernels 7 and 9: k consecutive radix-2 DIT butterfly stages over the whole
// array in one pass.
//
// Replaces two TPU kernels of genstark_tpu/ntt/pallas_kernels.py, reached
// via `butterfly_stage2` (:368) on the JAX package's direct route for
// transforms above 2^21 points (ntt/__init__.py:543-556):
//   - kernel 7, `_make_stage` (:120, pallas_call :177): m <= 4096, blocks of
//     whole 2m-groups;
//   - kernel 9, `_make_stage_split` (:308, pallas_call :342): m > 4096, lo
//     and hi fetched as two block-aligned views and re-interleaved by XLA.
// The two exist only because of VMEM block shapes, and each runs one stage
// per pass.  Here one kernel runs the stages m, 2m, ..., 2^(k-1) m in one
// pass (k = 1 is a single stage); the wrapper counts a launch under the two
// rows' names by the JAX package's rule applied to its lowest m (m <= 4096
// or not).  Plain version: genstark_tpu_torch/ntt/radix2.py
// (butterfly_stages_ref: k successive butterfly_stage_ref, the JAX package's
// jnp stage, ntt/__init__.py:560-577).
//
// Stage m: butterfly j of group g of batch row b takes lo at g*2m + j and hi
// at g*2m + m + j to lo + w*hi, lo - w*hi in place, w = tw[j * n/2m].
//
// What bounds it on this card: one stage per pass read and wrote the whole
// array every stage (2 * L * n * 4 bytes, 512 MB at n = 2^22, L = 16), and
// read each twiddle's L limbs as L sectors of the limb-major table.  Here a
// pass reads and writes the array once for k stages and does k * n/2
// Montgomery products, so at k = 5 or 6 the products (field.cuh's word
// product: 4K^2 + K = 264 multiplies each at L = 16, K = L/2) bound it, not
// the bytes.  Design:
//   - the elements i = base + t * m + c, t < 2^k, c < C (C = 16 columns,
//     64 bytes per limb row: two full sectors; so m >= 16, and the route's
//     lowest m is 2048) close under the k stages, so
//     one block loads that 2^k x C tile of every limb into shared memory
//     (64 KB at L = 16, k = 6), runs the k stages there with one barrier
//     between stages, and writes the tile back in place; a block reads each
//     row of 16 columns as 16-byte loads;
//   - the twiddles come from the element-major table [n/2, L] (one twiddle
//     is L contiguous limbs: 4 16-byte loads at L = 16), straight from
//     device memory or L2: a stage of half-size m' uses m' of them;
//   - a butterfly packs its elements' limb pairs from the tile, and the
//     twiddle's, into K words in registers for the word product, and
//     unpacks the results into the tile, which keeps 16-bit limb rows;
//   - 256 threads a block, 2 blocks an SM (16 warps, at most 128 registers a
//     thread); shared memory holds tile word w at w ^ (bit 5 of w) << 4, so
//     the two rows a warp's butterflies touch at the first stage (2 apart,
//     16 words each) fall in different banks; the other stages' rows are 1
//     apart and the vector accesses stay 16-byte aligned.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace gs {

constexpr int kStageThreads = 256;
constexpr int kVBatch = 8;  // 16-byte loads in flight per thread
constexpr int kLogCols = 4, kCols = 1 << kLogCols;  // C = 16 columns a tile

__device__ __forceinline__ int tile_swz(int w) { return w ^ (((w >> 5) & 1) << 4); }

// Twiddle `idx` of the element-major table [n/2, L] into registers as K =
// L/2 words (limb_pair).
template <int L>
__device__ __forceinline__ void load_twiddle(const int32_t* __restrict__ tw, long long idx,
                                             uint32_t (&w)[L / 2]) {
  const int32_t* p = tw + idx * L;
  if constexpr (L % 4 == 0) {
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p) + q);
      w[2 * q] = limb_pair(static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y));
      w[2 * q + 1] = limb_pair(static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w));
    }
  } else {
#pragma unroll
    for (int q = 0; q < L / 2; ++q) {
      const int2 v = __ldg(reinterpret_cast<const int2*>(p) + q);
      w[q] = limb_pair(static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y));
    }
  }
}

template <int L>
__global__ void __launch_bounds__(kStageThreads, 2)
butterfly_stages_kernel(int32_t* x, const int32_t* __restrict__ tw, int log_n, int log_m, int k,
                        FieldW f) {
  constexpr int K = L / 2;
  extern __shared__ uint4 smem_raw[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem_raw);  // [L][2^k * C], swizzled
  const long long n = 1LL << log_n, m = 1LL << log_m;
  const int log_tile = k + kLogCols, tile = 1 << log_tile;
  const long long col_blocks = m >> kLogCols;
  const long long c0 = (blockIdx.x % col_blocks) << kLogCols;
  const long long base = ((blockIdx.x / col_blocks) << (log_m + k)) + c0;
  int32_t* row = x + static_cast<long long>(blockIdx.y) * L * n + base;

  for (int q0 = threadIdx.x; q0 < (L << log_tile) >> 2; q0 += kVBatch * blockDim.x) {
    uint4 v[kVBatch];
#pragma unroll
    for (int b = 0; b < kVBatch; ++b) {
      const int e = (q0 + b * blockDim.x) << 2, l = e >> log_tile, w = e & (tile - 1);
      if (e < (L << log_tile))
        v[b] = *reinterpret_cast<const uint4*>(row + l * n + (w >> kLogCols) * m +
                                               (w & (kCols - 1)));
    }
#pragma unroll
    for (int b = 0; b < kVBatch; ++b) {
      const int e = (q0 + b * blockDim.x) << 2, l = e >> log_tile, w = e & (tile - 1);
      if (e < (L << log_tile))
        *reinterpret_cast<uint4*>(sm + (l << log_tile) + tile_swz(w)) = v[b];
    }
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    const int log_tstride = log_n - 1 - (log_m + j);  // stage m_j = m << j: w^(r * n/2m_j)
    for (int q = threadIdx.x; q < tile >> 1; q += blockDim.x) {
      const int c = q & (kCols - 1), tq = q >> kLogCols;
      const int low = tq & ((1 << j) - 1);
      const int t0 = ((tq >> j) << (j + 1)) | low;
      const int p0 = tile_swz((t0 << kLogCols) | c);
      const int p1 = tile_swz(((t0 + (1 << j)) << kLogCols) | c);
      const long long r = (static_cast<long long>(low) << log_m) + c0 + c;  // j-th in the group
      // the tile's 16-bit limb rows, packed into K words in registers
      uint32_t u[K], v[K], w[K];
      load_twiddle<L>(tw, r << log_tstride, w);
      load_elem_w<K>(sm, tile, p1, v);
      mont_mul_w<K>(v, w, f, v);
      load_elem_w<K>(sm, tile, p0, u);
      add_mod_w<K>(u, v, f, w);
      sub_mod_w<K>(u, v, f, v);
      store_elem_w<K>(sm, tile, p0, w);
      store_elem_w<K>(sm, tile, p1, v);
    }
    __syncthreads();
  }

  for (int q = threadIdx.x; q < (L << log_tile) >> 2; q += blockDim.x) {
    const int e = q << 2, l = e >> log_tile, w = e & (tile - 1);
    const long long off = l * n + (w >> kLogCols) * m + (w & (kCols - 1));
    *reinterpret_cast<uint4*>(row + off) =
        *reinterpret_cast<const uint4*>(sm + (l << log_tile) + tile_swz(w));
  }
}

template <int L>
cudaError_t launch_stages(int32_t* x, const int32_t* tw, int batch, int log_n, int log_m, int k,
                          const FieldW& f, cudaStream_t st) {
  const size_t smem = (static_cast<size_t>(L) << (k + kLogCols)) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(butterfly_stages_kernel<L>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int half_tile = 1 << (k + kLogCols - 1);
  const int threads = half_tile < kStageThreads ? half_tile : kStageThreads;
  const dim3 grid(static_cast<unsigned>(1LL << (log_n - k - kLogCols)),
                  static_cast<unsigned>(batch));
  butterfly_stages_kernel<L><<<grid, threads, smem, st>>>(x, tw, log_n, log_m, k, f);
  return cudaGetLastError();
}

}  // namespace gs

// x: int32 [batch, L, 2^log_n] contiguous and 16-byte aligned, updated in
// place: the stages of half-size 2^log_m .. 2^(log_m + k - 1), m >= 16.
// tw: int32 [2^(log_n - 1), L] element-major, 16-byte aligned, tw[k] = w^k
// (Montgomery) for the n-th root w.
extern "C" int gs_butterfly_stages(int L, void* x, const void* tw, int batch, int log_n,
                                   int log_m, int k, const uint32_t* field_words,
                                   void* stream) {
  if (log_n < 1 || log_n > 40 || log_m < gs::kLogCols || k < 1 || log_m + k > log_n)
    return cudaErrorInvalidValue;
  if (batch < 0 || batch > 65535) return cudaErrorInvalidValue;
  if (log_n - k - gs::kLogCols > 31) return cudaErrorInvalidValue;
  if (batch == 0) return 0;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(tw) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const gs::FieldW f = gs::fieldw_from_words(field_words, L);
  auto* d = static_cast<int32_t*>(x);
  auto* t = static_cast<const int32_t*>(tw);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 2: return gs::launch_stages<2>(d, t, batch, log_n, log_m, k, f, st);
    case 4: return gs::launch_stages<4>(d, t, batch, log_n, log_m, k, f, st);
    case 8: return gs::launch_stages<8>(d, t, batch, log_n, log_m, k, f, st);
    case 14: return gs::launch_stages<14>(d, t, batch, log_n, log_m, k, f, st);
    case 16: return gs::launch_stages<16>(d, t, batch, log_n, log_m, k, f, st);
    default: return cudaErrorInvalidValue;
  }
}
