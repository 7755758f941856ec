// Kernel 8: the local radix-2 transform (every butterfly stage in one block).
//
// Replaces the TPU kernel genstark_tpu/ntt/pallas_kernels.py
// `_make_multistage` (:204, pallas_call :266, reached via `multistage`
// :286): all radix-2 DIT stages of an n-point transform on one block of
// data kept in fast memory.  Plain version: genstark_tpu_torch/ntt/radix2.py
// (butterfly_ref, the JAX package's jnp stage loop, ntt/__init__.py:560-577,
// with the bit reversal of :400-408,534).  Two entries: natural-order input
// (bit-reversed as it loads: the local route and the four-step passes), or
// input already in bit-reversed order (`bitrev_in`, the contract of
// `multistage`: the direct route's local pass over the contiguous blocks of
// a globally bit-reversed array, which must not be reversed again).
//
// What bounds it on this card: a butterfly is one Montgomery product and a
// modular add and sub (field.cuh's word product: 4K^2 + K = 264 multiplies
// at L = 16, K = L/2, and their carry adds) on 2 elements, so the stages
// are bound by the instruction rate; device memory is touched once
// per transform (one read, one write of L x n limbs, one read of the
// twiddles).  Design:
//   - one block owns C local transforms of neighbouring groups (columns) of
//     one batch row: it loads them into shared memory (bit-reversing the
//     index as it loads), runs all log2(n) stages there with one barrier
//     between stages, and writes the results back in natural order.  C = 2
//     for a column view (a side strided along n whose groups are adjacent
//     words, as the four-step passes give it), where the grid still covers
//     the SMs and the tile fits: a warp's 4-byte accesses then use 8 bytes
//     of each 32-byte sector, not 4.  Tiles of 4 or 8 columns (up to a whole
//     sector) measured no faster on the H100 at the four-step shapes: fewer,
//     larger blocks an SM;
//   - the local root's half-table [L, n/2] is loaded into shared memory once
//     per block beside the data (64 KB at L = 16, n = 2048: 192 KB in all),
//     so no stage goes back to device memory for a twiddle;
//   - up to 512 threads a block (each thread takes every 512th butterfly of
//     a stage), capped at 128 registers by __launch_bounds__: 16 warps per SM
//     at L = 16 and n = 2048 (one block), and at the four-step's 256- and
//     512-point rows (several blocks);
//   - a butterfly reads its elements' 16-bit limbs from the tile, packs
//     each limb pair into a word (field.cuh's load_elem_w on the tile; the
//     twiddle likewise) for the word product, and unpacks the results into
//     the tile (store_elem_w): the tile keeps 16-bit limb rows, so the
//     layout, swizzle and vector accesses below are those of the limb tile;
//   - shared memory holds limb l of element i of column c at
//     (c * L + l) * n + swz(i), where swz XORs the 5-bit chunks above bit 4
//     into the bank bits (swz below).  The bit-reversed store (32
//     neighbouring j give indices n/32 apart: one bank for all 32 in the
//     plain layout), the stage reads and writes (32 consecutive indices, or
//     pairs 2 apart at m = 1), the twiddle reads (32 indices 2^s apart) and
//     the vector load / store below are all free of bank conflicts; stages
//     m = 2 .. 16 keep a 2-way conflict (the index bit m of i0 is fixed, and
//     bit 5 folds onto bank bit 0, not bit log2 m), and a column view's load
//     and store a C-way one (once per transform, not per stage);
//   - 16-byte global loads and stores where the view is contiguous along n
//     (the local route, the bit-reversed entry, the four-step's second-pass
//     reads), 4-byte accesses otherwise (the four-step's column views).
// Input and output are strided views [B, G, L, n], so the four-step split
// around the kernel (ntt/radix2.py) needs no transposes.  Shared memory bounds
// the local size: 1.5 x L x n int32 words per block at C = 1
// (kernels.butterfly_max_n: 2048 points at every L up to 16, the port's
// LOCAL_MAX; the TPU's _MBLK = 2048 butterflies per block was sized for VMEM
// and is not used).
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace gs {

constexpr int kBflyThreads = 512;
constexpr int kBatch = 16;        // 4-byte loads in flight per thread (strided views)
constexpr int kVBatch = 4;        // 16-byte loads in flight per thread
constexpr size_t kSmemMax = 232448;

struct BflyArgs {
  const int32_t* x;        // [B, G, L, n] strided
  int32_t* out;            // [B, G, L, n] strided
  const int32_t* tw;       // [L, n/2] contiguous: w^k, Montgomery
  long long xs[4], os[4];  // element strides of (B, G, L, n)
  int groups;              // G
  int log_cols;            // a block takes 2^log_cols neighbouring groups
  int log_n;
  int bitrev_in;           // 1: x is already in bit-reversed order
  int vec_x, vec_out, vec_tw;  // 1: 16-byte accesses (contiguous along n, aligned)
};

// Shared-memory position of index i (< 2^20): the 5-bit chunks of i above
// bit 4 XORed into its low 5 bits (the bank).  A bijection that keeps every
// aligned run of 32 (and of 4) in place.  Indices i0 + t * 2^s (t < 32, i0's
// bits s .. s+4 clear) land in 32 banks for every s: bits s .. s+4 fold onto
// 5 distinct bank bits.
__device__ __forceinline__ int swz(int i) {
  return i ^ (((i >> 5) ^ (i >> 10) ^ (i >> 15)) & 31);
}

__device__ __forceinline__ int bitrev(int j, int log_n) {
  return static_cast<int>(__brev(static_cast<unsigned>(j)) >> (32 - log_n));
}

template <int L>
__global__ void __launch_bounds__(kBflyThreads) butterfly_kernel(BflyArgs a, FieldW f) {
  constexpr int K = L / 2;
  extern __shared__ uint32_t sm[];  // data [C][L][n], then twiddles [L][n/2], all swizzled
  const int log_n = a.log_n, log_cols = a.log_cols;
  const int n = 1 << log_n;
  const int half = n >> 1;
  const int rows = L << log_cols;  // (column, limb) rows of n words
  uint32_t* tws = sm + rows * n;
  const int tiles = a.groups >> log_cols;
  const long long b = blockIdx.x / tiles;
  const long long g = static_cast<long long>(blockIdx.x % tiles) << log_cols;
  const int32_t* src = a.x + b * a.xs[0] + g * a.xs[1];

  if (a.vec_tw) {
    const int4* t4 = reinterpret_cast<const int4*>(a.tw);
    const int total = (L * half) >> 2;
    for (int q0 = threadIdx.x; q0 < total; q0 += kVBatch * blockDim.x) {
      int4 v[kVBatch];
#pragma unroll
      for (int e = 0; e < kVBatch; ++e)
        if (q0 + e * blockDim.x < total) v[e] = __ldg(t4 + q0 + e * blockDim.x);
#pragma unroll
      for (int e = 0; e < kVBatch; ++e) {
        const int idx = (q0 + e * blockDim.x) << 2, l = idx >> (log_n - 1), k = idx & (half - 1);
        if (idx < L * half) {
          uint32_t* row = tws + l * half;
          row[swz(k)] = v[e].x;
          row[swz(k + 1)] = v[e].y;
          row[swz(k + 2)] = v[e].z;
          row[swz(k + 3)] = v[e].w;
        }
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < L * half; idx += blockDim.x) {
      const int l = idx >> (log_n - 1), k = idx & (half - 1);
      tws[l * half + swz(k)] = static_cast<uint32_t>(__ldg(a.tw + idx));
    }
  }
  if (a.vec_x) {
    // row r = c * L + l, quads along n
    const int total = (rows * n) >> 2;
    for (int q0 = threadIdx.x; q0 < total; q0 += kVBatch * blockDim.x) {
      int4 v[kVBatch];
#pragma unroll
      for (int e = 0; e < kVBatch; ++e) {
        const int idx = (q0 + e * blockDim.x) << 2, r = idx >> log_n, c = r / L;
        if (idx < rows * n)
          v[e] = *reinterpret_cast<const int4*>(src + c * a.xs[1] + (r - c * L) * a.xs[2] +
                                                (idx & (n - 1)));
      }
#pragma unroll
      for (int e = 0; e < kVBatch; ++e) {
        const int idx = (q0 + e * blockDim.x) << 2, j = idx & (n - 1);
        if (idx < rows * n) {
          const int vals[4] = {v[e].x, v[e].y, v[e].z, v[e].w};
          uint32_t* row = sm + (idx >> log_n) * n;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            row[swz(a.bitrev_in ? j + k : bitrev(j + k, log_n))] = static_cast<uint32_t>(vals[k]);
        }
      }
    }
  } else {
    // strided view, columns fastest (neighbouring words when the group
    // stride is 1): kBatch independent 4-byte loads in flight per thread
    for (int idx0 = threadIdx.x; idx0 < rows * n; idx0 += kBatch * blockDim.x) {
      uint32_t vals[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int idx = idx0 + e * blockDim.x, c = idx & ((1 << log_cols) - 1),
                  lj = idx >> log_cols, l = lj >> log_n, j = lj & (n - 1);
        if (idx < rows * n) vals[e] = static_cast<uint32_t>(src[c * a.xs[1] + l * a.xs[2] +
                                                                j * a.xs[3]]);
      }
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int idx = idx0 + e * blockDim.x, c = idx & ((1 << log_cols) - 1),
                  lj = idx >> log_cols, l = lj >> log_n, j = lj & (n - 1);
        if (idx < rows * n)
          sm[(c * L + l) * n + swz(a.bitrev_in ? j : bitrev(j, log_n))] = vals[e];
      }
    }
  }
  __syncthreads();

  for (int lm = 0; lm < log_n; ++lm) {
    const int m = 1 << lm;
    const int log_ts = log_n - 1 - lm;  // w_(2m)^r = w^(r * n / 2m)
    for (int bf = threadIdx.x; bf < half << log_cols; bf += blockDim.x) {
      const int k = bf & (half - 1), r = k & (m - 1);
      const int i0 = ((k >> lm) << (lm + 1)) + r;
      uint32_t* col = sm + (bf >> (log_n - 1)) * L * n;
      const int p0 = swz(i0), p1 = swz(i0 + m), pt = swz(r << log_ts);
      // the tile's 16-bit limb rows, packed into K words in registers
      uint32_t u[K], v[K], w[K];
      load_elem_w<K>(col, n, p1, v);
      load_elem_w<K>(tws, half, pt, w);
      mont_mul_w<K>(v, w, f, v);
      load_elem_w<K>(col, n, p0, u);
      add_mod_w<K>(u, v, f, w);
      sub_mod_w<K>(u, v, f, v);
      store_elem_w<K>(col, n, p0, w);
      store_elem_w<K>(col, n, p1, v);
    }
    __syncthreads();
  }

  int32_t* dst = a.out + b * a.os[0] + g * a.os[1];
  if (a.vec_out) {
    for (int q = threadIdx.x; q < (rows * n) >> 2; q += blockDim.x) {
      const int idx = q << 2, r = idx >> log_n, c = r / L, j = idx & (n - 1);
      const uint32_t* row = sm + r * n;
      const int4 v = make_int4(static_cast<int>(row[swz(j)]), static_cast<int>(row[swz(j + 1)]),
                               static_cast<int>(row[swz(j + 2)]),
                               static_cast<int>(row[swz(j + 3)]));
      *reinterpret_cast<int4*>(dst + c * a.os[1] + (r - c * L) * a.os[2] + j) = v;
    }
  } else {
    for (int idx0 = threadIdx.x; idx0 < rows * n; idx0 += kBatch * blockDim.x) {
      uint32_t vals[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int idx = idx0 + e * blockDim.x, c = idx & ((1 << log_cols) - 1),
                  lj = idx >> log_cols;
        if (idx < rows * n) vals[e] = sm[(c * L + (lj >> log_n)) * n + swz(lj & (n - 1))];
      }
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int idx = idx0 + e * blockDim.x, c = idx & ((1 << log_cols) - 1),
                  lj = idx >> log_cols, l = lj >> log_n, j = lj & (n - 1);
        if (idx < rows * n)
          dst[c * a.os[1] + l * a.os[2] + j * a.os[3]] = static_cast<int32_t>(vals[e]);
      }
    }
  }
}

template <int L>
size_t butterfly_smem(int log_n, int log_cols) {
  return static_cast<size_t>(L) * (((1 << log_n) << log_cols) + (1 << log_n) / 2) *
         sizeof(uint32_t);
}

template <int L>
cudaError_t launch_butterfly(BflyArgs a, long long transforms, const FieldW& f,
                             cudaStream_t st) {
  const int n = 1 << a.log_n;
  // A column view takes 2 neighbouring columns a block if the grid still
  // gives 15/16 of the SMs a block and the tile fits in shared memory.
  a.log_cols = 0;
  if (a.log_n >= 6 && a.groups % 2 == 0 &&
      ((!a.vec_x && a.xs[1] == 1) || (!a.vec_out && a.os[1] == 1)) &&
      butterfly_smem<L>(a.log_n, 1) <= kSmemMax) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (16 * (transforms / 2) >= 15LL * sms) a.log_cols = 1;
  }
  const size_t smem = butterfly_smem<L>(a.log_n, a.log_cols);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        butterfly_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // 512 threads where one block fills the SM's shared memory, else 256 (two
  // or more blocks an SM: one block's loads overlap another's stages)
  const int butterflies = (n / 2) << a.log_cols;
  int threads = butterflies < kBflyThreads ? butterflies : kBflyThreads;
  if (threads > 256 && 2 * smem <= kSmemMax) threads = 256;
  if (threads < 32) threads = 32;
  const long long n_blocks = transforms >> a.log_cols;
  butterfly_kernel<L><<<static_cast<unsigned>(n_blocks), threads, smem, st>>>(a, f);
  return cudaGetLastError();
}

// A view takes 16-byte accesses when it is contiguous along n and every row
// it starts (b, g, l) is 16-byte aligned.
bool vec_view(const void* base, const long long* s, int log_n) {
  return log_n >= 2 && s[3] == 1 && s[0] % 4 == 0 && s[1] % 4 == 0 && s[2] % 4 == 0 &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

}  // namespace gs

// x_strides / out_strides: element strides of (B, G, L, n); tw: int32 [L, n/2].
// out may be x itself: a block reads its whole transforms before it writes.
extern "C" int gs_butterfly(int L, const void* x, const long long* x_strides, void* out,
                            const long long* out_strides, const void* tw, int batch,
                            int groups, int log_n, int bitrev_in,
                            const uint32_t* field_words, void* stream) {
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
  a.bitrev_in = bitrev_in ? 1 : 0;
  a.vec_x = gs::vec_view(x, a.xs, log_n);
  a.vec_out = gs::vec_view(out, a.os, log_n);
  a.vec_tw = log_n >= 3 && reinterpret_cast<uintptr_t>(tw) % 16 == 0;
  const long long transforms = static_cast<long long>(batch) * groups;
  if (transforms > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const gs::FieldW f = gs::fieldw_from_words(field_words, L);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 2: return gs::launch_butterfly<2>(a, transforms, f, st);
    case 4: return gs::launch_butterfly<4>(a, transforms, f, st);
    case 6: return gs::launch_butterfly<6>(a, transforms, f, st);
    case 8: return gs::launch_butterfly<8>(a, transforms, f, st);
    case 10: return gs::launch_butterfly<10>(a, transforms, f, st);
    case 12: return gs::launch_butterfly<12>(a, transforms, f, st);
    case 14: return gs::launch_butterfly<14>(a, transforms, f, st);
    case 16: return gs::launch_butterfly<16>(a, transforms, f, st);
    default: return cudaErrorInvalidValue;
  }
}
