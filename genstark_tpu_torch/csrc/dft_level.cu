// Kernel 1: one digit-matmul DFT level with the level twiddle fused in.
//
// Replaces the TPU kernel genstark_tpu/ntt/mxu.py `_make_dft_kernel`
// (pallas_call at :441, reached via run_dft_level :514).  Contract and plain
// version: genstark_tpu_torch/ntt/dft.py (run_dft_level_ref).
//
//   out[k, col] = (sum_j W[k, j] x[j, col]) * w_l^(k * (col % rest))  mod p
//
// W arrives as D = 2L+1 balanced base-256 int8 digit planes; x as such
// planes too, or as canonical int32 limbs whose digits the kernel encodes
// while it loads them (the transform's first level).  Either input is a
// strided view [planes, pre, m, r] (col = b * r + q), so the transform
// hands each level its input without a transposing copy.  The D*D digit
// products of one (k, j) pair sum into 2D-1 int32 diagonals, exactly as the
// TPU kernel's s8 x s8 -> s32 matmuls do.
//
// Instantiated for every limb count of a modulus up to 256 bits, so for
// every modulus the host sends to the digit route (ntt.digit_dft_field: a
// solinas_spec whose L is the field's): L = 2 (p32), 4 (2^64 - 2^32 + 1), 6,
// 8 (p128), 10, 12, 14 (p224) and 16 (p256), as the TPU kernel is generic
// in L.
//
// What bounds it on this card: the digit multiply-adds, m * D^2 per output
// (18,496 at m = 64, D = 17; 69,696 at D = 33), which the int8 tensor cores
// run at 1,979 TOP/s; the level's bytes are a few MB.  Design:
//   - a block owns 16 rows k (one mma M tile) by 32 columns (4 warps, one
//     16 x 8 tile each); it stages the D W-digit planes of its rows (16-byte
//     cp.async) and the D x-digit planes of its columns in shared memory,
//     x transposed to [col][j] while staging (the mma's B operand wants K
//     contiguous per column, and sm_90 has no 8-bit ldmatrix.trans), j in
//     slices of 64 (32 at L >= 10, dft_slice), zero-padded below 16 rows, 32
//     j and past the last column.  Rows of shared memory are 16 bytes longer
//     than the slice, so the fragment reads of a warp hit 32 distinct banks;
//   - for each diagonal d a warp accumulates sum_i W_i x_{d-i} with
//     mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (no .satfinite: the s32 sums
//     stay exact, |S_d| < 2^30) and folds the sum at once into lazy 16-bit
//     limbs, so the 2D-1 diagonal sums are never live together.  Four
//     accumulators are taken in turn (four mma chains in flight) and added
//     before the fold;
//   - registers: the A fragments of the block's 16 rows stay there for the
//     slice (4 * D words a k step of 32), so a product reads only its B
//     fragment from shared memory; a diagonal folds into a window of three
//     limbs an output, and each limb leaves the window once a slice for the
//     lazy limbs in shared memory (4 outputs x N_LAZY words a thread).  Two
//     k steps a slice while their fragments fit kDftFragmentWords (L <= 8:
//     at most 136 words); from L = 10 on they would hold 168 to 264 words
//     of the 255 registers a thread has, so those limb counts stage slices
//     of 32 (one k step, 84 to 132 words, dft_ks).  Two blocks an SM where
//     their shared memory fits (L <= 12: at most 110 KB a block), one at L
//     >= 14 (130-148 KB).  No spills at any L;
//   - the epilogue reduces the wide integer in L-limb chunks with the
//     32-bit-word product (field.cuh mont_mul_w) and applies the twiddle
//     with it.
//
// Epilogue: the biased diagonals are recombined into lazy 16-bit limbs of
// one wide integer (each j slice adds its own 2^30 bias per diagonal; the
// host's correction constant cancels n_slices of them mod p); the integer
// is cut into L-limb chunks, chunk j >= 1 is Montgomery-multiplied by
// 2^(16Lj) * R mod p (host constants) and the chunks are summed mod p.  The
// result is the canonical residue, the same bits as the JAX epilogue's
// static solinas folds.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace gs {

constexpr int kDigitBias = 1 << 30;
constexpr int kMaxChunks = 5;
constexpr int kDftRows = 16;      // rows k of a block: one mma M tile
constexpr int kDftCols = 32;      // columns of a block: 4 warps x 8
constexpr int kDftThreads = 128;

// Words of A fragments a thread may hold (kernels.DFT_FRAGMENT_WORDS): 4 a
// digit plane and k step of 32.  k steps a slice: two while they fit, else
// one; j staged at once (kernels.dft_slice): 32 per k step.
constexpr int kDftFragmentWords = 160;
__host__ __device__ constexpr int dft_ks(int L) {
  return 4 * (2 * L + 1) * 2 <= kDftFragmentWords ? 2 : 1;
}
__host__ __device__ constexpr int dft_slice(int L) { return 32 * dft_ks(L); }

struct DftEpilogue {
  uint32_t corr[kMaxL];                 // (-n_slices * BIAS * sum_k 2^(8k)) mod p, limbs
  uint32_t chunk[kMaxChunks][kMaxK];    // 2^(16Lj) * R mod p, j = 1..n_ch-1, words
};

template <int L>
struct DftShape {
  static constexpr int D = 2 * L + 1;
  static constexpr int ND = 2 * D - 1;
  static constexpr int N_LAZY = (8 * (ND - 1) + 31) / 16 + 2;
  static constexpr int N_STRICT = N_LAZY + 2;
  static constexpr int N_CH = (N_STRICT + L - 1) / L;
};

struct DftArgs {
  const int8_t* w8;       // [D, m, m]
  const void* x;          // int8 digits [D, ...] or int32 limbs [L, ...], a view
  long long xs[4];        // element strides: plane, pre block, j, column in block
  int arest;              // columns per pre block: col = b * arest + q
  int in_limbs;
  int m, cols, n_slices, w_vec;
  int mode;               // 0: no twiddle; 1: direct panel [L, m, tc]; 2: A [rest/s, L, m] x B [L, m, s]
  const int32_t* tw_a;
  const int32_t* tw_b;
  int rest, s, tc;
  int out_digits;
  void* out;              // int32 [L, m, cols] or int8 [D, m, cols]
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Add one biased diagonal sum (weight 2^(8d)) into lazy 16-bit limbs.
// Diagonal d touches limbs d/2 .. d/2 + 2 only, so the limbs live in a
// window of three registers, win[r] = limb d/2 + r; after an odd d the
// lowest limb is final for this slice and leaves the window for shared
// memory (limb i at limbs[i * kDftThreads], this thread's column).
__device__ __forceinline__ void fold_diag(int d, int32_t sum, uint32_t (&win)[3],
                                          volatile uint32_t* limbs) {
  const uint32_t v = static_cast<uint32_t>(sum + kDigitBias);  // < 2^31
  const uint32_t parts[2] = {v & 0xFFFFu, v >> 16};
  const int off = (d % 2) * 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t sh = parts[h] << off;  // <= 24 bits
    win[h] += sh & 0xFFFFu;
    win[h + 1] += sh >> 16;
  }
  if (d % 2) {
    limbs[(d / 2) * kDftThreads] += win[0];
    win[0] = win[1];
    win[1] = win[2];
    win[2] = 0u;
  }
}

// Shared memory of one block: the staged digit planes, then the lazy limbs
// of the 4 outputs of each thread.
template <int L>
__host__ __device__ constexpr int dft_smem_bytes(int staged_depth) {
  return (2 * L + 1) * (kDftRows + kDftCols) * (staged_depth + 16) +
         4 * DftShape<L>::N_LAZY * kDftThreads * 4;
}

// Blocks an SM (the launch bound): two where two blocks' shared memory at
// the slice depth, and the 1 KB the card reserves for each, fit the SM's 228
// KB; else one.
template <int L>
__host__ __device__ constexpr int dft_blocks_per_sm() {
  return 2 * (dft_smem_bytes<L>(dft_slice(L)) + 1024) <= 228 * 1024 ? 2 : 1;
}

// Lazy limbs -> canonical words of the residue mod p.
template <int L>
__device__ __forceinline__ void lazy_to_words(const uint32_t (&lz)[DftShape<L>::N_LAZY],
                                              const FieldW& f, const DftEpilogue& epi,
                                              uint32_t (&out)[L / 2]) {
  using S = DftShape<L>;
  constexpr int K = L / 2;
  uint32_t st[S::N_CH * L];
  uint32_t c = 0u;
#pragma unroll
  for (int i = 0; i < S::N_CH * L; ++i) {
    const uint32_t s = (i < S::N_LAZY ? lz[i] : 0u) + c;
    st[i] = i < S::N_STRICT ? (s & 0xFFFFu) : 0u;
    c = s >> 16;
  }
  // chunk 0 < 2^(16L) < 2p: one conditional subtract makes it canonical
  uint32_t w0[K];
#pragma unroll
  for (int w = 0; w < K; ++w) w0[w] = st[2 * w] | (st[2 * w + 1] << 16);
  cond_sub_p_w<K>(w0, 0u, f, out);
#pragma unroll
  for (int ch = 1; ch < S::N_CH; ++ch) {
    uint32_t part[K], cst[K];
#pragma unroll
    for (int w = 0; w < K; ++w) {
      part[w] = st[ch * L + 2 * w] | (st[ch * L + 2 * w + 1] << 16);
      cst[w] = epi.chunk[ch - 1][w];
    }
    mont_mul_w<K>(part, cst, f, part);
    add_mod_w<K>(out, part, f, out);
  }
}

// KS: k steps of 32 a slice (1 for m <= 32 or where dft_ks(L) is 1, else
// 2), fixed at compile time so the mma loop has no predicates and its loads
// can be scheduled ahead.
template <int L, int KS>
__global__ void __launch_bounds__(kDftThreads, dft_blocks_per_sm<L>())
dft_level_kernel(DftArgs a, FieldW f, DftEpilogue epi) {
  using S = DftShape<L>;
  constexpr int D = S::D;
  constexpr int K = L / 2;
  extern __shared__ __align__(16) uint8_t sm[];
  constexpr int kp = 32 * KS;                        // staged depth
  constexpr int rs = kp + 16;                        // bytes a shared row
  uint8_t* ws = sm;                                  // [D][16 rows][rs]
  uint8_t* xs = sm + D * kDftRows * rs;              // [D][32 cols][rs]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = blockIdx.y * kDftRows, c0 = blockIdx.x * kDftCols;
  const int nrow = min(kDftRows, a.m - r0);
  const int total = D * (kDftRows + kDftCols) * rs;
  // lazy limbs of output o, limb i: lzs[(o * N_LAZY + i) * kDftThreads + tid]
  // (volatile: the compiler must not keep them in registers across diagonals)
  volatile uint32_t* lzs = reinterpret_cast<uint32_t*>(sm + total) + tid;

  // the column this thread stages, and its offset in the input view
  const int sc = tid & 31, col_s = c0 + sc;
  const long long col_off = col_s < a.cols
      ? static_cast<long long>(col_s / a.arest) * a.xs[1] +
            static_cast<long long>(col_s % a.arest) * a.xs[3]
      : 0;

#pragma unroll
  for (int o = 0; o < 4; ++o) {
#pragma unroll
    for (int i = 0; i < S::N_LAZY; ++i)
      lzs[(o * S::N_LAZY + i) * kDftThreads] = i < L ? epi.corr[i] : 0u;
  }

  for (int sl = 0; sl < a.n_slices; ++sl) {
    const int j0 = sl * kp;
    const int jn = min(kp, a.m - j0);
    __syncthreads();                                 // the last slice's reads are done
    for (int i = tid * 16; i < total; i += kDftThreads * 16)
      *reinterpret_cast<int4*>(sm + i) = make_int4(0, 0, 0, 0);
    __syncthreads();
    if (a.w_vec) {
      const int segs = jn / 16;
      for (int i = tid; i < D * nrow * segs; i += kDftThreads) {
        const int seg = i % segs, rr = (i / segs) % nrow, pl = i / (segs * nrow);
        cp_async16(ws + (pl * kDftRows + rr) * rs + seg * 16,
                   a.w8 + (static_cast<long long>(pl) * a.m + r0 + rr) * a.m + j0 + seg * 16);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    } else {
      for (int i = tid; i < D * nrow * jn; i += kDftThreads) {
        const int jj = i % jn, rr = (i / jn) % nrow, pl = i / (jn * nrow);
        ws[(pl * kDftRows + rr) * rs + jj] = static_cast<uint8_t>(
            a.w8[(static_cast<long long>(pl) * a.m + r0 + rr) * a.m + j0 + jj]);
      }
    }
    if (col_s < a.cols) {
      const int plane = kDftCols * rs;
#pragma unroll 4
      for (int jj = tid >> 5; jj < jn; jj += kDftThreads / 32) {
        const long long off = col_off + static_cast<long long>(j0 + jj) * a.xs[2];
        uint8_t* dst = xs + sc * rs + jj;
        if (a.in_limbs) {
          const int32_t* src = static_cast<const int32_t*>(a.x) + off;
          int32_t carry = 0;
#pragma unroll
          for (int t = 0; t < L; ++t) {
            const uint32_t limb = static_cast<uint32_t>(__ldg(src + t * a.xs[0]));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int32_t sum = static_cast<int32_t>((limb >> (8 * h)) & 0xFFu) + carry;
              const bool ge = sum >= 128;
              dst[(2 * t + h) * plane] = static_cast<uint8_t>(ge ? sum - 256 : sum);
              carry = ge ? 1 : 0;
            }
          }
          dst[(2 * L) * plane] = static_cast<uint8_t>(carry);
        } else {
          const int8_t* src = static_cast<const int8_t*>(a.x) + off;
#pragma unroll
          for (int i = 0; i < D; ++i) dst[i * plane] = static_cast<uint8_t>(__ldg(src + i * a.xs[0]));
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // fragment bases: A rows g (+8), k bytes t4*4 (+16); B column warp*8+g.
    // The A fragments of every W plane stay in registers for the slice (4
    // words per plane and k step); B comes from shared memory.
    const uint8_t* fa = ws + g * rs + t4 * 4;
    const uint8_t* fb = xs + (warp * 8 + g) * rs + t4 * 4;
    uint32_t af[D][KS][4];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint8_t* pa = fa + i * kDftRows * rs + ks * 32;
        af[i][ks][0] = lds32(pa);
        af[i][ks][1] = lds32(pa + 8 * rs);
        af[i][ks][2] = lds32(pa + 16);
        af[i][ks][3] = lds32(pa + 8 * rs + 16);
      }
    }
    uint32_t win[4][3] = {};
#pragma unroll
    for (int d = 0; d < S::ND; ++d) {
      // four accumulators taken in turn, so four mma chains are in flight
      // and the fragment loads of one overlap the others' products
      int32_t c[4][4] = {};
      constexpr int last = D - 1;
#pragma unroll
      for (int i = (d > last ? d - last : 0); i <= (d < last ? d : last); ++i) {
        const uint8_t* pb = fb + (d - i) * kDftCols * rs;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int kb = ks * 32;
          mma_s8(c[(KS * i + ks) & 3], af[i][ks][0], af[i][ks][1], af[i][ks][2], af[i][ks][3],
                 lds32(pb + kb), lds32(pb + kb + 16));
        }
      }
#pragma unroll
      for (int o = 0; o < 4; ++o)
        fold_diag(d, c[0][o] + c[1][o] + c[2][o] + c[3][o], win[o],
                  lzs + o * S::N_LAZY * kDftThreads);
    }
    // the last diagonal (even) leaves limbs ND/2 .. ND/2 + 2 in the window
    static_assert(S::ND % 2 == 1 && S::ND / 2 + 3 <= S::N_LAZY, "window");
#pragma unroll
    for (int o = 0; o < 4; ++o) {
#pragma unroll
      for (int r = 0; r < 3; ++r)
        lzs[(o * S::N_LAZY + S::ND / 2 + r) * kDftThreads] += win[o][r];
    }
  }

  // fragment element o: row g + 8 * (o >> 1), column 2 * t4 + (o & 1)
  const long long plane_x = static_cast<long long>(a.m) * a.cols;
#pragma unroll 1
  for (int o = 0; o < 4; ++o) {
    const int k = r0 + g + 8 * (o >> 1);
    const int col = c0 + warp * 8 + 2 * t4 + (o & 1);
    if (k >= a.m || col >= a.cols) continue;
    uint32_t lz[S::N_LAZY], v[K];
#pragma unroll
    for (int i = 0; i < S::N_LAZY; ++i) lz[i] = lzs[(o * S::N_LAZY + i) * kDftThreads];
    lazy_to_words<L>(lz, f, epi, v);
    if (a.mode != 0) {
      const int c = col % a.rest;
      uint32_t t[K];
      if (a.mode == 1) {
        const int32_t* p = a.tw_a + static_cast<long long>(k) * a.tc + c;
        const long long ls = static_cast<long long>(a.m) * a.tc;
#pragma unroll
        for (int w = 0; w < K; ++w)
          t[w] = static_cast<uint32_t>(__ldg(p + (2 * w) * ls)) |
                 (static_cast<uint32_t>(__ldg(p + (2 * w + 1) * ls)) << 16);
      } else {
        const int h = c / a.s, q = c % a.s;
        const int32_t* pa = a.tw_a + static_cast<long long>(h) * L * a.m + k;
        const int32_t* pb = a.tw_b + static_cast<long long>(k) * a.s + q;
        const long long lb = static_cast<long long>(a.m) * a.s;
        uint32_t u[K];
#pragma unroll
        for (int w = 0; w < K; ++w) {
          u[w] = static_cast<uint32_t>(__ldg(pa + (2 * w) * a.m)) |
                 (static_cast<uint32_t>(__ldg(pa + (2 * w + 1) * a.m)) << 16);
          t[w] = static_cast<uint32_t>(__ldg(pb + (2 * w) * lb)) |
                 (static_cast<uint32_t>(__ldg(pb + (2 * w + 1) * lb)) << 16);
        }
        mont_mul_w<K>(u, t, f, t);
      }
      mont_mul_w<K>(v, t, f, v);
    }
    const long long idx = static_cast<long long>(k) * a.cols + col;
    if (a.out_digits) {
      int8_t* out8 = static_cast<int8_t*>(a.out);
      int32_t carry = 0;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const uint32_t limb = (v[t / 2] >> (16 * (t & 1))) & 0xFFFFu;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int32_t sum = static_cast<int32_t>((limb >> (8 * h)) & 0xFFu) + carry;
          const bool ge = sum >= 128;
          out8[(2 * t + h) * plane_x + idx] = static_cast<int8_t>(ge ? sum - 256 : sum);
          carry = ge ? 1 : 0;
        }
      }
      out8[(2 * L) * plane_x + idx] = static_cast<int8_t>(carry);
    } else {
      int32_t* out32 = static_cast<int32_t*>(a.out);
#pragma unroll
      for (int t = 0; t < L; ++t)
        out32[t * plane_x + idx] = static_cast<int32_t>((v[t / 2] >> (16 * (t & 1))) & 0xFFFFu);
    }
  }
}

template <int L, int KS>
cudaError_t launch_ks(const DftArgs& a, const FieldW& f, const DftEpilogue& epi,
                      cudaStream_t stream) {
  const size_t smem = dft_smem_bytes<L>(32 * KS);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dft_level_kernel<L, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((a.cols + kDftCols - 1) / kDftCols, (a.m + kDftRows - 1) / kDftRows);
  dft_level_kernel<L, KS><<<grid, kDftThreads, smem, stream>>>(a, f, epi);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch(const DftArgs& a, const FieldW& f, const DftEpilogue& epi,
                   cudaStream_t stream) {
  if constexpr (dft_ks(L) == 1) {
    return launch_ks<L, 1>(a, f, epi, stream);
  } else {
    return a.m <= 32 ? launch_ks<L, 1>(a, f, epi, stream) : launch_ks<L, 2>(a, f, epi, stream);
  }
}

template <int L>
cudaError_t launch_checked(const DftArgs& a, const FieldW& f, const DftEpilogue& epi,
                           int n_chunk_consts, cudaStream_t stream) {
  if (n_chunk_consts != DftShape<L>::N_CH - 1) return cudaErrorInvalidValue;
  if (a.n_slices != (a.m + dft_slice(L) - 1) / dft_slice(L)) return cudaErrorInvalidValue;
  return launch<L>(a, f, epi, stream);
}

}  // namespace gs

// x_strides: the input view's element strides (plane, pre block, j, column
// in block); arest: columns per pre block.  field_words: p limbs [L], n0.
// epi_words: the bias correction for n_slices slices [L] then n_ch - 1
// chunk constants of L limbs each.  Returns the launch's
// cudaError_t.
extern "C" int gs_dft_level(int L, const void* w8, const void* x, const long long* x_strides,
                            int arest, int in_limbs, int m, int cols, int n_slices, int mode,
                            const void* tw_a, const void* tw_b, int rest, int s, int tc,
                            int out_digits, void* out, const uint32_t* field_words,
                            const uint32_t* epi_words, int n_chunk_consts, void* stream) {
  if (n_chunk_consts > gs::kMaxChunks || m < 1 || cols < 1 || arest < 1 || rest < 1)
    return cudaErrorInvalidValue;
  if ((m + 15) / 16 > 65535) return cudaErrorInvalidValue;
  if (mode < 0 || mode > 2) return cudaErrorInvalidValue;
  gs::DftArgs a = {};
  a.w8 = static_cast<const int8_t*>(w8);
  a.x = x;
  for (int i = 0; i < 4; ++i) a.xs[i] = x_strides[i];
  a.arest = arest;
  a.in_limbs = in_limbs;
  a.m = m;
  a.cols = cols;
  a.n_slices = n_slices;
  a.w_vec = (m % 16 == 0) && (reinterpret_cast<uintptr_t>(w8) % 16 == 0);
  a.mode = mode;
  a.tw_a = static_cast<const int32_t*>(tw_a);
  a.tw_b = static_cast<const int32_t*>(tw_b);
  a.rest = rest;
  a.s = s;
  a.tc = tc;
  a.out_digits = out_digits;
  a.out = out;
  const gs::FieldW f = gs::fieldw_from_words(field_words, L);
  gs::DftEpilogue epi = {};
  for (int j = 0; j < L; ++j) epi.corr[j] = epi_words[j];
  for (int c = 0; c < n_chunk_consts; ++c)
    for (int w = 0; w < L / 2; ++w)
      epi.chunk[c][w] = epi_words[L + c * L + 2 * w] | (epi_words[L + c * L + 2 * w + 1] << 16);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 2: return gs::launch_checked<2>(a, f, epi, n_chunk_consts, st);
    case 4: return gs::launch_checked<4>(a, f, epi, n_chunk_consts, st);
    case 6: return gs::launch_checked<6>(a, f, epi, n_chunk_consts, st);
    case 8: return gs::launch_checked<8>(a, f, epi, n_chunk_consts, st);
    case 10: return gs::launch_checked<10>(a, f, epi, n_chunk_consts, st);
    case 12: return gs::launch_checked<12>(a, f, epi, n_chunk_consts, st);
    case 14: return gs::launch_checked<14>(a, f, epi, n_chunk_consts, st);
    case 16: return gs::launch_checked<16>(a, f, epi, n_chunk_consts, st);
    default:
      return cudaErrorInvalidValue;
  }
}
