// Kernel 1: one digit-matmul DFT level with the level twiddle fused in.
//
// Replaces the TPU kernel genstark_tpu/ntt/mxu.py `_make_dft_kernel`
// (pallas_call at :441, reached via run_dft_level :514).  Contract and plain
// version: genstark_tpu_torch/ntt/dft.py (run_dft_level_ref).
//
//   out[k, col] = (sum_j W[k, j] x[j, col]) * w_l^(k * (col % rest))  mod p
//
// W and x arrive as D = 2L+1 balanced base-256 int8 digit planes; the D*D
// digit products of one (k, j) pair accumulate into 2D-1 int32 diagonal
// sums, exactly as the TPU kernel's s8 x s8 -> s32 matmuls do.
//
// What bounds it on this card: integer multiply-adds.  One output costs
// m * D^2 int32 MACs (18,496 at m = 64, D = 17) against 17 bytes of x
// digits and 17 of W digits per j, so the kernel sits far above the memory
// roofline and below the INT32 issue rate.  Design: one thread per output
// (k, col), threads of a block along col so the x-digit loads of a warp are
// contiguous and the W digits (the same k for the whole block) are
// broadcast loads; all 2D-1 accumulators, the epilogue, the twiddle
// multiply and the optional digit re-encode stay in registers, so the
// level reads its input and writes its output once.  The int8 tensor-core
// path (IMMA / wgmma) is later work.
//
// Epilogue: the biased diagonals are recombined into lazy 16-bit limbs of
// one wide integer; the integer is cut into L-limb chunks, chunk j >= 1 is
// Montgomery-multiplied by 2^(16Lj) * R mod p (host constants) and the
// chunks are summed mod p.  The result is the canonical residue, the same
// bits as the JAX epilogue's static solinas folds.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace gs {

constexpr int kDigitBias = 1 << 30;
constexpr int kMaxChunks = 5;

struct DftEpilogue {
  uint32_t corr[kMaxL];                 // (-BIAS * sum_k 2^(8k)) mod p
  uint32_t chunk[kMaxChunks][kMaxL];    // 2^(16Lj) * R mod p, j = 1..n_ch-1
};

template <int L>
struct DftShape {
  static constexpr int D = 2 * L + 1;
  static constexpr int ND = 2 * D - 1;
  static constexpr int N_LAZY = (8 * (ND - 1) + 31) / 16 + 2;
  static constexpr int N_STRICT = N_LAZY + 2;
  static constexpr int N_CH = (N_STRICT + L - 1) / L;
};

template <int L>
__device__ __forceinline__ void diags_to_limbs(const int32_t (&acc)[DftShape<L>::ND],
                                               const Field& f,
                                               const DftEpilogue& epi,
                                               uint32_t (&out)[L]) {
  using S = DftShape<L>;
  uint32_t limbs[S::N_CH * L];
#pragma unroll
  for (int i = 0; i < S::N_CH * L; ++i) limbs[i] = 0u;
#pragma unroll
  for (int j = 0; j < L; ++j) limbs[j] = epi.corr[j];
#pragma unroll
  for (int k = 0; k < S::ND; ++k) {
    const uint32_t v = static_cast<uint32_t>(acc[k] + kDigitBias);  // < 2^31
    const uint32_t parts[2] = {v & 0xFFFFu, v >> 16};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int bit = k * 8 + h * 16;
      const int pidx = bit / 16, off = bit % 16;
      const uint32_t sh = parts[h] << off;  // <= 24 bits
      limbs[pidx] += sh & 0xFFFFu;
      limbs[pidx + 1] += sh >> 16;
    }
  }
  // lazy -> strict 16-bit limbs (the two extra limbs take the last carry)
  uint32_t c = 0u;
#pragma unroll
  for (int i = 0; i < S::N_STRICT; ++i) {
    const uint32_t s = limbs[i] + c;
    limbs[i] = s & 0xFFFFu;
    c = s >> 16;
  }
  // chunk 0 < 2^(16L) < 2p: one conditional subtract makes it canonical
#pragma unroll
  for (int j = 0; j < L; ++j) out[j] = limbs[j];
  cond_sub_p<L>(out, 0u, f);
#pragma unroll
  for (int ch = 1; ch < S::N_CH; ++ch) {
    uint32_t part[L], cst[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      part[j] = limbs[ch * L + j];
      cst[j] = epi.chunk[ch - 1][j];
    }
    mont_mul<L>(part, cst, f, part);
    add_mod<L>(out, part, f, out);
  }
}

// MODE 0: no twiddle; 1: direct panel [L, m, tc]; 2: factored A [rest/s, L, m]
// times B [L, m, s].
template <int L, int MODE, bool OUT_DIGITS>
__global__ void __launch_bounds__(128)
dft_level_kernel(const int8_t* __restrict__ w8, const int8_t* __restrict__ x8,
                 int m, int cols, const int32_t* __restrict__ tw_a,
                 const int32_t* __restrict__ tw_b, int rest, int s, int tc,
                 void* __restrict__ out, Field f, DftEpilogue epi) {
  using S = DftShape<L>;
  constexpr int D = S::D;
  // col < cols, an int (the wrapper refuses 2^31 columns or more); the plane
  // offsets below are 64-bit
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (col >= cols) return;
  const long long plane_w = static_cast<long long>(m) * m;
  const long long plane_x = static_cast<long long>(m) * cols;
  const int8_t* wrow = w8 + static_cast<long long>(k) * m;
  const int8_t* xcol = x8 + col;

  int32_t acc[S::ND];
#pragma unroll
  for (int i = 0; i < S::ND; ++i) acc[i] = 0;
  for (int j = 0; j < m; ++j) {
    int32_t wd[D], xd[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      wd[i] = wrow[i * plane_w + j];
      xd[i] = xcol[i * plane_x + static_cast<long long>(j) * cols];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int jj = 0; jj < D; ++jj) acc[i + jj] += wd[i] * xd[jj];
    }
  }

  uint32_t v[L];
  diags_to_limbs<L>(acc, f, epi, v);

  if (MODE != 0) {
    const int c = col % rest;
    uint32_t t[L];
    if (MODE == 1) {
#pragma unroll
      for (int i = 0; i < L; ++i)
        t[i] = static_cast<uint32_t>(tw_a[(static_cast<long long>(i) * m + k) * tc + c]);
    } else {
      const int h = c / s, q = c % s;
      uint32_t a[L];
#pragma unroll
      for (int i = 0; i < L; ++i) {
        a[i] = static_cast<uint32_t>(tw_a[(static_cast<long long>(h) * L + i) * m + k]);
        t[i] = static_cast<uint32_t>(tw_b[(static_cast<long long>(i) * m + k) * s + q]);
      }
      mont_mul<L>(a, t, f, t);
    }
    mont_mul<L>(v, t, f, v);
  }

  const long long o = static_cast<long long>(k) * cols + col;
  if (OUT_DIGITS) {
    int8_t* out8 = static_cast<int8_t*>(out);
    int32_t carry = 0;
#pragma unroll
    for (int t = 0; t < L; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int32_t sum = static_cast<int32_t>((v[t] >> (8 * half)) & 0xFFu) + carry;
        const bool ge = sum >= 128;
        out8[(2 * t + half) * plane_x + o] = static_cast<int8_t>(ge ? sum - 256 : sum);
        carry = ge ? 1 : 0;
      }
    }
    out8[(2 * L) * plane_x + o] = static_cast<int8_t>(carry);
  } else {
    int32_t* out32 = static_cast<int32_t*>(out);
#pragma unroll
    for (int i = 0; i < L; ++i) out32[i * plane_x + o] = static_cast<int32_t>(v[i]);
  }
}

template <int L, int MODE, bool OUT_DIGITS>
cudaError_t launch(const int8_t* w8, const int8_t* x8, int m, int cols,
                   const int32_t* tw_a, const int32_t* tw_b, int rest, int s,
                   int tc, void* out, const Field& f, const DftEpilogue& epi,
                   cudaStream_t stream) {
  dim3 block(128);
  dim3 grid((cols + 127) / 128, m);
  dft_level_kernel<L, MODE, OUT_DIGITS><<<grid, block, 0, stream>>>(
      w8, x8, m, cols, tw_a, tw_b, rest, s, tc, out, f, epi);
  return cudaGetLastError();
}

template <int L>
cudaError_t dispatch(int mode, int out_digits, const int8_t* w8,
                     const int8_t* x8, int m, int cols, const int32_t* tw_a,
                     const int32_t* tw_b, int rest, int s, int tc, void* out,
                     const Field& f, const DftEpilogue& epi, cudaStream_t st) {
  if (mode == 0)
    return out_digits ? launch<L, 0, true>(w8, x8, m, cols, tw_a, tw_b, rest, s, tc, out, f, epi, st)
                      : launch<L, 0, false>(w8, x8, m, cols, tw_a, tw_b, rest, s, tc, out, f, epi, st);
  if (mode == 1)
    return out_digits ? launch<L, 1, true>(w8, x8, m, cols, tw_a, tw_b, rest, s, tc, out, f, epi, st)
                      : launch<L, 1, false>(w8, x8, m, cols, tw_a, tw_b, rest, s, tc, out, f, epi, st);
  if (mode == 2)
    return out_digits ? launch<L, 2, true>(w8, x8, m, cols, tw_a, tw_b, rest, s, tc, out, f, epi, st)
                      : launch<L, 2, false>(w8, x8, m, cols, tw_a, tw_b, rest, s, tc, out, f, epi, st);
  return cudaErrorInvalidValue;
}

}  // namespace gs

// field_words: p limbs [L] then n0p.  epi_words: corr [L] then n_ch - 1
// chunk constants of L limbs each.  Returns the launch's cudaError_t.
extern "C" int gs_dft_level(int L, const void* w8, const void* x8, int m,
                            int cols, int mode, const void* tw_a,
                            const void* tw_b, int rest, int s, int tc,
                            int out_digits, void* out,
                            const uint32_t* field_words,
                            const uint32_t* epi_words, int n_chunk_consts,
                            void* stream) {
  if (n_chunk_consts > gs::kMaxChunks) return cudaErrorInvalidValue;
  const gs::Field f = gs::field_from_words(field_words, L);
  gs::DftEpilogue epi = {};
  for (int j = 0; j < L; ++j) epi.corr[j] = epi_words[j];
  for (int c = 0; c < n_chunk_consts; ++c)
    for (int j = 0; j < L; ++j) epi.chunk[c][j] = epi_words[L + c * L + j];
  const auto* w = static_cast<const int8_t*>(w8);
  const auto* x = static_cast<const int8_t*>(x8);
  const auto* a = static_cast<const int32_t*>(tw_a);
  const auto* b = static_cast<const int32_t*>(tw_b);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 2:
      if (n_chunk_consts != gs::DftShape<2>::N_CH - 1) return cudaErrorInvalidValue;
      return gs::dispatch<2>(mode, out_digits, w, x, m, cols, a, b, rest, s, tc, out, f, epi, st);
    case 8:
      if (n_chunk_consts != gs::DftShape<8>::N_CH - 1) return cudaErrorInvalidValue;
      return gs::dispatch<8>(mode, out_digits, w, x, m, cols, a, b, rest, s, tc, out, f, epi, st);
    default:
      return cudaErrorInvalidValue;
  }
}
