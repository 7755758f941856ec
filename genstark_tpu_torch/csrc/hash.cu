// Kernels 2 and 3: batched blake2s-256 / sha256 of equal-length messages.
//
// Replace the TPU kernels in genstark_tpu/hash/pallas_hash.py:
//   kernel 2, `_digest_call` (:182, pallas_call :186; bodies _blake2s_kernel
//     :90 and _sha256_kernel :132): messages given as word-major LE words
//     uint32[W, B] -> digests uint32[8, B] (Merkle pair levels);
//   kernel 3, `_digest_limbs_call` (:200, pallas_call :223): messages built
//     in the kernel from standard-form 16-bit limb arrays, word = lo | hi<<16
//     (evaluation-tree leaves and, in its stride-4 view, FRI layer rows).
// Plain versions: genstark_tpu_torch/hash/__init__.py.
//
// What bounds it on this card: 32-bit add/xor/rotate issue.  A blake2s
// compression is ~1,300 integer ops on 64 bytes in and 32 out, far above
// the memory roofline.  Design: one thread per message, the whole
// compression unrolled over register words (sigma and the sha256 schedule
// ring resolve to compile-time register indices), padding synthesized from
// static word positions, so a thread reads its message once and writes 8
// words.  Threads run along the batch, so each message word is one
// contiguous load across a warp (the word-major layout).
//
// Kernel 3 has a compile-time form for the layouts the prover hashes
// (`digest_limbs_kernel`): the algorithm, L and the vector count are
// template parameters and the layout is one of two, so every message word's
// two limb planes are constants, the message length and block count are
// constants, and a block's 16 loads issue together ahead of its rounds with
// no index arithmetic.  Its launch bound caps a thread at 64 registers, so
// four 256-thread blocks fit an SM and a batch of 2^17 messages is one wave
// on the 132 SMs.  Leaves of another vector count take the runtime form
// (`LimbSource`).
#include <cuda_runtime.h>

#include <cstdint>

namespace gs {

__constant__ uint32_t kB2IV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                                  0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
                                  0x1F83D9ABu, 0x5BE0CD19u};

__constant__ uint32_t kShaK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__constant__ uint32_t kShaH0[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                                   0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                                   0x1f83d9abu, 0x5be0cd19u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// Index widths: word, block and limb indices (i, blk, v, k, n_words) stay
// below a few hundred; every product with a stride or the batch is taken in
// 64 bits (long long), so the [2, 16, 2^24] vectors of a 2^20-step prove fit.
//
// Message words from a word-major [n_words, batch] array.
struct WordSource {
  const uint32_t* words;
  long long batch;
  int n_words;
  __device__ __forceinline__ uint32_t operator()(int i, long long b) const {
    return i < n_words ? words[i * batch + b] : 0u;
  }
};

// Message words from V limb vectors: element (v, limb, b) lies at
// base[v * vec_stride + limb * limb_stride + b]; word i is LE word k of
// vector v (i = v * L/2 + k) = limb 2k | limb 2k+1 << 16.
struct LimbSource {
  const uint32_t* base;
  long long vec_stride, limb_stride;
  int half_l;
  int n_words;
  __device__ __forceinline__ uint32_t operator()(int i, long long b) const {
    if (i >= n_words) return 0u;
    const int v = i / half_l, k = i % half_l;
    const uint32_t* e = base + v * vec_stride + b;
    return e[(2 * k) * limb_stride] | (e[(2 * k + 1) * limb_stride] << 16);
  }
};

// Kernel 3's compile-time layouts: element (v, limb, b) lies in limb plane
// plane(v, limb), at base[plane * batch + b].  Leaves, [V, L, N] contiguous
// with batch = N: plane = v * L + limb.  Stride-4 rows, [L, N] read as four
// vectors of M = N / 4 with batch = M: element (v, limb, r) is at limb * N +
// v * M + r, so plane = v + 4 * limb.  Once the compression is unrolled, i,
// v, k and both planes are constants.
template <int L, int V, bool ROWS>
struct FixedLimbSource {
  static constexpr int kWords = V * L / 2;
  static constexpr int kBytes = 4 * kWords;
  const uint32_t* base;
  long long batch;
  static __device__ __forceinline__ int plane(int v, int limb) {
    return ROWS ? v + 4 * limb : v * L + limb;
  }
  __device__ __forceinline__ uint32_t operator()(int i, long long b) const {
    if (i >= kWords) return 0u;
    const int v = i / (L / 2), k = i % (L / 2);
    const uint32_t* e = base + b;
    return __ldg(e + plane(v, 2 * k) * batch) | (__ldg(e + plane(v, 2 * k + 1) * batch) << 16);
  }
};

#define GS_B2_G(a, b, c, d, x, y) \
  do {                            \
    a = a + b + (x);              \
    d = rotr(d ^ a, 16);          \
    c = c + d;                    \
    b = rotr(b ^ c, 12);          \
    a = a + b + (y);              \
    d = rotr(d ^ a, 8);           \
    c = c + d;                    \
    b = rotr(b ^ c, 7);           \
  } while (0)

#define GS_B2_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  do {                                                                                  \
    GS_B2_G(v[0], v[4], v[8], v[12], m[s0], m[s1]);                                     \
    GS_B2_G(v[1], v[5], v[9], v[13], m[s2], m[s3]);                                     \
    GS_B2_G(v[2], v[6], v[10], v[14], m[s4], m[s5]);                                    \
    GS_B2_G(v[3], v[7], v[11], v[15], m[s6], m[s7]);                                    \
    GS_B2_G(v[0], v[5], v[10], v[15], m[s8], m[s9]);                                    \
    GS_B2_G(v[1], v[6], v[11], v[12], m[s10], m[s11]);                                  \
    GS_B2_G(v[2], v[7], v[8], v[13], m[s12], m[s13]);                                   \
    GS_B2_G(v[3], v[4], v[9], v[14], m[s14], m[s15]);                                   \
  } while (0)

// BLAKE2s-256, no key: parameter word 0x01010020 (digest length 32,
// fanout 1, depth 1); t is the byte count so far (the message length on
// the last block).  Output words are the LE digest words.
template <class Src>
__device__ __forceinline__ void blake2s(const Src& src, long long b,
                                        int msg_bytes, uint32_t (&h)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = kB2IV[i];
  h[0] ^= 0x01010020u;
  const int n_blocks = msg_bytes > 64 ? (msg_bytes + 63) / 64 : 1;
  // unrolled where msg_bytes is a constant (kernel 3's fixed forms); a loop
  // where it is an argument
#pragma unroll
  for (int blk = 0; blk < n_blocks; ++blk) {
    const bool last = blk == n_blocks - 1;
    const uint32_t t = last ? static_cast<uint32_t>(msg_bytes) : (blk + 1) * 64u;
    uint32_t m[16], v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) m[j] = src(blk * 16 + j, b);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = h[i];
      v[i + 8] = kB2IV[i];
    }
    v[12] ^= t;
    if (last) v[14] ^= 0xFFFFFFFFu;
    GS_B2_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    GS_B2_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
    GS_B2_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
    GS_B2_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
    GS_B2_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
    GS_B2_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
    GS_B2_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
    GS_B2_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
    GS_B2_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
    GS_B2_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
  }
}

// SHA-256 of LE-word messages: each word is byte-swapped in, the 0x80
// terminator and the 64-bit big-endian bit length are synthesized at their
// static word positions, and the state is byte-swapped out to LE words.
template <class Src>
__device__ __forceinline__ void sha256(const Src& src, long long b,
                                       int msg_bytes, uint32_t (&out)[8]) {
  const int n_raw = msg_bytes / 4;
  const int n_blocks = (msg_bytes + 9 + 63) / 64;
  const int term_word = msg_bytes / 4;
  const uint32_t term_be = bswap(0x80u << ((msg_bytes % 4) * 8));
  const unsigned long long bitlen = static_cast<unsigned long long>(msg_bytes) * 8ull;
  const int total = n_blocks * 16;
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = kShaH0[i];
#pragma unroll
  for (int blk = 0; blk < n_blocks; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = blk * 16 + j;
      uint32_t x = i < n_raw ? bswap(src(i, b)) : 0u;
      if (i == term_word) x ^= term_be;
      if (i == total - 1) x ^= static_cast<uint32_t>(bitlen & 0xFFFFFFFFull);
      if (i == total - 2) x ^= static_cast<uint32_t>(bitlen >> 32);
      w[j] = x;
    }
    uint32_t a = st[0], bb = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      if (r >= 16) {
        const uint32_t w1 = w[(r + 1) % 16], w9 = w[(r + 9) % 16];
        const uint32_t w14 = w[(r + 14) % 16];
        const uint32_t s0 = rotr(w1, 7) ^ rotr(w1, 18) ^ (w1 >> 3);
        const uint32_t s1 = rotr(w14, 17) ^ rotr(w14, 19) ^ (w14 >> 10);
        w[r % 16] = w[r % 16] + s0 + w9 + s1;
      }
      const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint32_t t1 = h + S1 + ch + kShaK[r] + w[r % 16];
      const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const uint32_t maj = (a & bb) ^ (a & c) ^ (bb & c);
      h = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = bb;
      bb = a;
      a = t1 + S0 + maj;
    }
    st[0] += a; st[1] += bb; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = bswap(st[i]);
}

template <class Src>
__global__ void __launch_bounds__(256)
digest_kernel(Src src, int algo, int msg_bytes, long long batch,
              uint32_t* __restrict__ out) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  uint32_t h[8];
  if (algo == 1) {
    blake2s(src, b, msg_bytes, h);
  } else {
    sha256(src, b, msg_bytes, h);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i * batch + b] = h[i];
}

template <class Src>
cudaError_t launch_digest(const Src& src, int algo, int msg_bytes,
                          long long batch, void* out, void* stream) {
  const unsigned blocks = static_cast<unsigned>((batch + 255) / 256);
  digest_kernel<Src><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      src, algo, msg_bytes, batch, static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

constexpr int kHashThreads = 256;
// 4 blocks of 256 threads an SM: at most 64 registers a thread
constexpr int kHashMinBlocks = 4;

template <int ALGO, int L, int V, bool ROWS>
__global__ void __launch_bounds__(kHashThreads, kHashMinBlocks)
digest_limbs_kernel(const uint32_t* __restrict__ base, long long batch,
                    uint32_t* __restrict__ out) {
  using Src = FixedLimbSource<L, V, ROWS>;
  const long long b = static_cast<long long>(blockIdx.x) * kHashThreads + threadIdx.x;
  if (b >= batch) return;
  const Src src{base, batch};
  uint32_t h[8];
  if (ALGO == 1) {
    blake2s(src, b, Src::kBytes, h);
  } else {
    sha256(src, b, Src::kBytes, h);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i * batch + b] = h[i];
}

// Kernel 3 for one algorithm and L: stride-4 rows, leaves of 1, 2 or 4
// vectors in the compile-time form; leaves of any other count at run time.
template <int ALGO, int L>
cudaError_t launch_limbs(const uint32_t* base, int n_vec, bool rows, long long batch,
                         uint32_t* out, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((batch + kHashThreads - 1) / kHashThreads);
  if (rows) {
    digest_limbs_kernel<ALGO, L, 4, true><<<blocks, kHashThreads, 0, st>>>(base, batch, out);
  } else if (n_vec == 1) {
    digest_limbs_kernel<ALGO, L, 1, false><<<blocks, kHashThreads, 0, st>>>(base, batch, out);
  } else if (n_vec == 2) {
    digest_limbs_kernel<ALGO, L, 2, false><<<blocks, kHashThreads, 0, st>>>(base, batch, out);
  } else if (n_vec == 4) {
    digest_limbs_kernel<ALGO, L, 4, false><<<blocks, kHashThreads, 0, st>>>(base, batch, out);
  } else {
    const LimbSource src{base, L * batch, batch, L / 2, n_vec * L / 2};
    return launch_digest(src, ALGO, 2 * n_vec * L, batch, out, st);
  }
  return cudaGetLastError();
}

template <int ALGO>
cudaError_t launch_limbs_algo(int L, const uint32_t* base, int n_vec, bool rows,
                              long long batch, uint32_t* out, cudaStream_t st) {
  switch (L) {
    case 2: return launch_limbs<ALGO, 2>(base, n_vec, rows, batch, out, st);
    case 4: return launch_limbs<ALGO, 4>(base, n_vec, rows, batch, out, st);
    case 8: return launch_limbs<ALGO, 8>(base, n_vec, rows, batch, out, st);
    case 14: return launch_limbs<ALGO, 14>(base, n_vec, rows, batch, out, st);
    case 16: return launch_limbs<ALGO, 16>(base, n_vec, rows, batch, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gs

// algo: 0 = sha256, 1 = blake2s256.  words: int32 [n_words, batch] LE words
// (n_words = msg_bytes / 4); out: int32 [8, batch].
extern "C" int gs_hash_words(int algo, const void* words, int n_words,
                             int msg_bytes, long long batch, void* out,
                             void* stream) {
  if (batch <= 0) return 0;
  if (msg_bytes != 4 * n_words) return cudaErrorInvalidValue;
  gs::WordSource src{static_cast<const uint32_t*>(words), batch, n_words};
  return gs::launch_digest(src, algo, msg_bytes, batch, out, stream);
}

// Kernel 3.  Leaves (rows = 0): base int32 [n_vec, L, batch] contiguous;
// the message of column b is the LE bytes of every vector's element b,
// concatenated.  Stride-4 rows (rows = 1, n_vec = 4): base int32 [L, 4 *
// batch] contiguous; the message of row r is elements r, r + batch, r + 2
// batch, r + 3 batch.  out: int32 [8, batch].
extern "C" int gs_hash_limbs(int algo, const void* base, int n_vec, int L, int rows,
                             long long batch, void* out, void* stream) {
  if (batch <= 0) return 0;
  if (n_vec < 1 || (rows && n_vec != 4)) return cudaErrorInvalidValue;
  auto b = static_cast<const uint32_t*>(base);
  auto o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (algo) {
    case 0: return gs::launch_limbs_algo<0>(L, b, n_vec, rows != 0, batch, o, st);
    case 1: return gs::launch_limbs_algo<1>(L, b, n_vec, rows != 0, batch, o, st);
    default: return cudaErrorInvalidValue;
  }
}
