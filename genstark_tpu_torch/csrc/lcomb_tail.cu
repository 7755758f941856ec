// Kernel 4: the pointwise tail of the composition + linear combination.
//
// Replaces the TPU kernel genstark_tpu/protocol/lincomb_kernel.py
// `_tail_call` (:47, pallas_call :132, reached via lcomb_tail :143).  Plain
// version: genstark_tpu_torch/protocol/lincomb_kernel.py (lcomb_tail_ref).
// Per position x of the evaluation domain:
//
//   dom  = outer[pos / s] * inner[pos % s]            (factored power table)
//   zinv = (dom - x_last) * inv_series[pos % ext]     (1 / Z(x))
//   acc  = qe * zinv
//   incr = outer_i[pos / s] * inner_i[pos % s]        (optional)
//   acc += sum_k b_k * bc_k   (+ b_k * incr * bc_{B+k})
//   acc += sum_v e_v * lc_v   (+ e_v * incr * lc_{V+v})
//
// Representation contract (as on the TPU): qe and e are standard form,
// tables / boundary vectors / lc are Montgomery, bc standard, so every
// term lands in standard form and the output feeds FRI directly.
//
// What bounds it on this card: the Montgomery products.  With B = 1, V = 2
// and both raised copies a position takes 13 of them (4k^2 + k 32-bit
// multiplies each, k = L/2 words) against (2 + B + V) * 4L bytes read and
// written, so it sits above the memory roofline at every L.  Design:
//   - the products run on the 32-bit-word product (field.cuh mont_mul_w:
//     4k^2 + k multiplies in PTX carry chains, where a 16-bit-limb product
//     does 2L^2 = 8k^2 multiplies and splits each one);
//   - a block first copies the per-launch constants (x_last, bc, lc and
//     the ext-periodic inv series) into shared memory as words, so no
//     product reloads a constant from device memory limb by limb;
//   - a thread takes P consecutive positions (4 at k <= 4, 2 at k >= 7):
//     the limb planes of qe, b, e and out are read and written as P-wide
//     vectors (16 or 8 bytes, each limb plane coalesced across the warp)
//     where Ne % P == 0 and the arrays are aligned, else element by element;
//     the loads of one operand group overlap the products of the other
//     positions;
//   - the small factored tables (dom, incr) stay in device memory, read
//     through the read-only cache.
// Any L in {2, 4, 8, 14, 16} (p32 to p256), any Ne and s, B >= 0, and any
// ext whose constants, (1 + nb + nl + ext) elements of L/2 words, fit in a
// block's shared memory (kernels.lcomb_tail raises ValueError otherwise).
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace gs {

struct TailArgs {
  const int32_t* qe;       // [L, Ne]
  const int32_t* b;        // [B, L, Ne]
  const int32_t* e;        // [V, L, Ne]
  const int32_t* dom_o;    // [L, nj]
  const int32_t* dom_i;    // [L, s]
  const int32_t* inc_o;    // [L, nj] or null
  const int32_t* inc_i;    // [L, s] or null
  const int32_t* inv;      // [L, ext]
  const int32_t* bc;       // [L, nb]
  const int32_t* lc;       // [L, nl]
  int32_t* out;            // [L, Ne]
  long long ne;
  int nj, s, ext, n_b, n_v, nb, nl;
  int b_inc, ps_inc, vec;
  uint32_t x_last[kMaxK];  // Montgomery x at the last trace step, as words
};

template <int P>
__device__ __forceinline__ void load_vec(const int32_t* __restrict__ p, int32_t (&v)[P]) {
  if constexpr (P == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const int2 q = __ldg(reinterpret_cast<const int2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
}

template <int P>
__device__ __forceinline__ void store_vec(int32_t* __restrict__ p, const int32_t (&v)[P]) {
  if constexpr (P == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  }
}

// Positions pos0 .. pos0+P-1 of a limb-major [L, ne] array as words;
// positions past ne read as 0.
template <int K, int P>
__device__ __forceinline__ void load_group(const int32_t* __restrict__ base, long long ne,
                                           long long pos0, bool vec, uint32_t (&x)[P][K]) {
  if (vec) {
#pragma unroll
    for (int w = 0; w < K; ++w) {
      int32_t lo[P], hi[P];
      load_vec<P>(base + (2 * w) * ne + pos0, lo);
      load_vec<P>(base + (2 * w + 1) * ne + pos0, hi);
#pragma unroll
      for (int p = 0; p < P; ++p)
        x[p][w] = static_cast<uint32_t>(lo[p]) | (static_cast<uint32_t>(hi[p]) << 16);
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (pos0 + p < ne) {
        load_elem_w<K>(base, ne, pos0 + p, x[p]);
      } else {
#pragma unroll
        for (int w = 0; w < K; ++w) x[p][w] = 0u;
      }
    }
  }
}

template <int K, int P>
__device__ __forceinline__ void store_group(int32_t* __restrict__ base, long long ne,
                                            long long pos0, bool vec, const uint32_t (&x)[P][K]) {
  if (vec) {
#pragma unroll
    for (int w = 0; w < K; ++w) {
      int32_t lo[P], hi[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        lo[p] = static_cast<int32_t>(x[p][w] & 0xFFFFu);
        hi[p] = static_cast<int32_t>(x[p][w] >> 16);
      }
      store_vec<P>(base + (2 * w) * ne + pos0, lo);
      store_vec<P>(base + (2 * w + 1) * ne + pos0, hi);
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (pos0 + p < ne) store_elem_w<K>(base, ne, pos0 + p, x[p]);
  }
}

template <int K>
__device__ __forceinline__ void smem_elem(const uint32_t* cs, int e, uint32_t (&v)[K]) {
#pragma unroll
  for (int w = 0; w < K; ++w) v[w] = cs[e * K + w];
}

// Shared memory: words of x_last (element 0), bc (1 .. nb), lc (1 + nb ..
// nb + nl), inv (1 + nb + nl .. + ext), K words each.
template <int K, int P>
__global__ void __launch_bounds__(128) lcomb_tail_kernel(TailArgs a, FieldW f) {
  extern __shared__ uint32_t cs[];
  const int e_bc = 1, e_lc = 1 + a.nb, e_inv = 1 + a.nb + a.nl;
  const int n_words = (e_inv + a.ext) * K;
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) {
    const int e = i / K, w = i % K;
    uint32_t v;
    if (e == 0) {
      v = a.x_last[w];
    } else {
      const int32_t* tab = e < e_lc ? a.bc : (e < e_inv ? a.lc : a.inv);
      const int cols = e < e_lc ? a.nb : (e < e_inv ? a.nl : a.ext);
      const int c = e - (e < e_lc ? e_bc : (e < e_inv ? e_lc : e_inv));
      v = static_cast<uint32_t>(__ldg(tab + (2 * w) * cols + c)) |
          (static_cast<uint32_t>(__ldg(tab + (2 * w + 1) * cols + c)) << 16);
    }
    cs[i] = v;
  }
  __syncthreads();

  const long long pos0 = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * P;
  if (pos0 >= a.ne) return;
  const bool vec = a.vec != 0;
  const bool raised = a.b_inc || a.ps_inc;
  uint32_t acc[P][K], inc[P][K], x[P][K];

  load_group<K, P>(a.qe, a.ne, pos0, vec, x);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long pos = pos0 + p < a.ne ? pos0 + p : a.ne - 1;
    const long long j = pos / a.s, q = pos % a.s;
    uint32_t d[K], y[K];
    load_elem_w<K>(a.dom_o, a.nj, j, d);
    load_elem_w<K>(a.dom_i, a.s, q, y);
    mont_mul_w<K>(d, y, f, d);                                  // dom
    smem_elem<K>(cs, 0, y);
    sub_mod_w<K>(d, y, f, d);
    smem_elem<K>(cs, e_inv + static_cast<int>(pos % a.ext), y);
    mont_mul_w<K>(d, y, f, d);                                  // zinv
    mont_mul_w<K>(x[p], d, f, acc[p]);
    if (raised) {
      load_elem_w<K>(a.inc_o, a.nj, j, d);
      load_elem_w<K>(a.inc_i, a.s, q, y);
      mont_mul_w<K>(d, y, f, inc[p]);
    }
  }

  const long long plane = static_cast<long long>(2 * K) * a.ne;
  for (int k = 0; k < a.n_b; ++k) {
    load_group<K, P>(a.b + k * plane, a.ne, pos0, vec, x);
    uint32_t c0[K], c1[K], t[K];
    smem_elem<K>(cs, e_bc + k, c0);
    if (a.b_inc) smem_elem<K>(cs, e_bc + a.n_b + k, c1);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      mont_mul_w<K>(x[p], c0, f, t);
      add_mod_w<K>(acc[p], t, f, acc[p]);
      if (a.b_inc) {
        mont_mul_w<K>(x[p], inc[p], f, t);
        mont_mul_w<K>(t, c1, f, t);
        add_mod_w<K>(acc[p], t, f, acc[p]);
      }
    }
  }
  for (int v = 0; v < a.n_v; ++v) {
    load_group<K, P>(a.e + v * plane, a.ne, pos0, vec, x);
    uint32_t c0[K], c1[K], t[K];
    smem_elem<K>(cs, e_lc + v, c0);
    if (a.ps_inc) smem_elem<K>(cs, e_lc + a.n_v + v, c1);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      mont_mul_w<K>(x[p], c0, f, t);
      add_mod_w<K>(acc[p], t, f, acc[p]);
      if (a.ps_inc) {
        mont_mul_w<K>(x[p], inc[p], f, t);
        mont_mul_w<K>(t, c1, f, t);
        add_mod_w<K>(acc[p], t, f, acc[p]);
      }
    }
  }
  store_group<K, P>(a.out, a.ne, pos0, vec, acc);
}

// Positions a thread takes: 4 for narrow elements, 2 where five K-word
// element groups would crowd the registers.
template <int K>
constexpr int tail_positions() { return K <= 4 ? 4 : 2; }

template <int K>
cudaError_t launch_tail(TailArgs a, const FieldW& f, cudaStream_t st) {
  constexpr int P = tail_positions<K>();
  const size_t smem = static_cast<size_t>(1 + a.nb + a.nl + a.ext) * K * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lcomb_tail_kernel<K, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const uintptr_t align = 4 * P;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.qe) | reinterpret_cast<uintptr_t>(a.e) |
                         reinterpret_cast<uintptr_t>(a.out) |
                         (a.b != nullptr ? reinterpret_cast<uintptr_t>(a.b) : 0);
  a.vec = (a.ne % P == 0) && (addr % align == 0);
  const long long groups = (a.ne + P - 1) / P;
  const long long blocks = (groups + 127) / 128;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  lcomb_tail_kernel<K, P><<<static_cast<unsigned>(blocks), 128, smem, st>>>(a, f);
  return cudaGetLastError();
}

}  // namespace gs

// ptrs: qe, b, e, dom_outer, dom_inner, incr_outer, incr_inner, inv, bc, lc,
// out (device pointers; b / incr may be null when absent).  dims: Ne, nj, s,
// ext, B, V, nb, nl, b_inc, ps_inc.  field_words: p limbs [L], n0;
// x_last: L limbs (Montgomery).
extern "C" int gs_lcomb_tail(int L, void* const* ptrs, const long long* dims,
                             const uint32_t* field_words,
                             const uint32_t* x_last, void* stream) {
  gs::TailArgs a = {};
  a.qe = static_cast<const int32_t*>(ptrs[0]);
  a.b = static_cast<const int32_t*>(ptrs[1]);
  a.e = static_cast<const int32_t*>(ptrs[2]);
  a.dom_o = static_cast<const int32_t*>(ptrs[3]);
  a.dom_i = static_cast<const int32_t*>(ptrs[4]);
  a.inc_o = static_cast<const int32_t*>(ptrs[5]);
  a.inc_i = static_cast<const int32_t*>(ptrs[6]);
  a.inv = static_cast<const int32_t*>(ptrs[7]);
  a.bc = static_cast<const int32_t*>(ptrs[8]);
  a.lc = static_cast<const int32_t*>(ptrs[9]);
  a.out = static_cast<int32_t*>(ptrs[10]);
  a.ne = dims[0];
  a.nj = static_cast<int>(dims[1]);
  a.s = static_cast<int>(dims[2]);
  a.ext = static_cast<int>(dims[3]);
  a.n_b = static_cast<int>(dims[4]);
  a.n_v = static_cast<int>(dims[5]);
  a.nb = static_cast<int>(dims[6]);
  a.nl = static_cast<int>(dims[7]);
  a.b_inc = static_cast<int>(dims[8]);
  a.ps_inc = static_cast<int>(dims[9]);
  if (a.ne <= 0) return 0;
  if ((a.b_inc || a.ps_inc) && (a.inc_o == nullptr || a.inc_i == nullptr))
    return cudaErrorInvalidValue;
  if (L % 2 || L > gs::kMaxL) return cudaErrorInvalidValue;
  for (int w = 0; w < L / 2; ++w) a.x_last[w] = x_last[2 * w] | (x_last[2 * w + 1] << 16);
  const gs::FieldW f = gs::fieldw_from_words(field_words, L);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 2: return gs::launch_tail<1>(a, f, st);
    case 4: return gs::launch_tail<2>(a, f, st);
    case 8: return gs::launch_tail<4>(a, f, st);
    case 14: return gs::launch_tail<7>(a, f, st);
    case 16: return gs::launch_tail<8>(a, f, st);
    default: return cudaErrorInvalidValue;
  }
}
