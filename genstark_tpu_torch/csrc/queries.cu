// Kernel B: the Fiat-Shamir query sampler of a whole proof in one launch.
//
// The port's counterpart of the JAX package's `sample_indexes_dev`
// (genstark_tpu/protocol/device_queries.py:53), which XLA computes (it has
// no Pallas kernel), bit for bit with the host sampler
// protocol/queries.py get_pseudorandom_indexes: state = sha256(seed); for
// i = 0, 1, ...: index = int_be(sha256(hex bytes of state + i)) mod max_,
// where the hex bytes drop a trailing odd nibble (the Node
// Buffer.from(hex) quirk); an index that is a multiple of
// exclude_multiples_of, or already taken, is skipped, until `count` are
// taken.  Plain version: protocol/device_queries.py sample_sets_ref.
//
// Two differences from the JAX function: indexes are written as 64-bit
// integers (the JAX one casts them to int32, which wraps at indexes >= 2^31
// when max_ = 2^32), and every set of a proof (the execution set and one
// set per FRI layer, each seeded by its own root) is one block of one
// launch.
//
// What bounds it on this card: two dependent SHA-256 compressions (the
// state's, then a candidate's, ~2,200 32-bit ops each) and one scan, the
// latency of one block; its bytes are a few hundred and its operations fill
// no SM.  Design: a block of 256 threads a set, one candidate a thread.  The
// first window holds 64, 128 or 256 candidates, the fewest that hold a
// quarter more than the largest set takes (`kernels.sample_window`): one
// warp hashes a candidate in about the time a whole SM does, but 256 of them
// are issue-bound, so a small first window finishes sooner; later windows
// (an odd hex length) take all 256.  Warp 0 hashes the state; then every
// thread of the window hashes its
// candidate into shared memory and decides on its own whether it is the
// window's first valid occurrence of its index, comparing it with every
// earlier candidate of the window (all lanes of a warp read the same word:
// a broadcast, no bank conflict; an excluded or out-of-range candidate
// never equals a valid one that comes after it) and, in a later window
// only, with the indexes already taken.  A block-wide exclusive scan of the
// keep flags (a ballot and popc in each warp, then the 8 warp totals) gives
// each survivor its place; the first `count` go to the taken list.  The
// block stops after the window in which its set is complete (the first,
// unless the state's hex length is odd: then runs of ~16 candidates hash
// alike), or at n_cand candidates, where found < count tells the caller to
// sample on the host.
#include <cuda_runtime.h>

#include <cstdint>

namespace gs {
namespace {

__constant__ uint32_t kSampleShaK[64] = {
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

__constant__ uint32_t kSampleShaH0[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                                         0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                                         0x1f83d9abu, 0x5be0cd19u};

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One SHA-256 compression from the initial state over a padded big-endian
// block w (overwritten by the message schedule): the digest as big-endian
// words, most significant first.
__device__ __forceinline__ void sha256_block(uint32_t (&w)[16], uint32_t (&out)[8]) {
  uint32_t a = kSampleShaH0[0], b = kSampleShaH0[1], c = kSampleShaH0[2];
  uint32_t d = kSampleShaH0[3], e = kSampleShaH0[4], f = kSampleShaH0[5];
  uint32_t g = kSampleShaH0[6], h = kSampleShaH0[7];
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    if (r >= 16) {
      const uint32_t w1 = w[(r + 1) % 16], w9 = w[(r + 9) % 16], w14 = w[(r + 14) % 16];
      const uint32_t s0 = rotr32(w1, 7) ^ rotr32(w1, 18) ^ (w1 >> 3);
      const uint32_t s1 = rotr32(w14, 17) ^ rotr32(w14, 19) ^ (w14 >> 10);
      w[r % 16] = w[r % 16] + s0 + w9 + s1;
    }
    const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + kSampleShaK[r] + w[r % 16];
    const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  out[0] = a + kSampleShaH0[0];
  out[1] = b + kSampleShaH0[1];
  out[2] = c + kSampleShaH0[2];
  out[3] = d + kSampleShaH0[3];
  out[4] = e + kSampleShaH0[4];
  out[5] = f + kSampleShaH0[5];
  out[6] = g + kSampleShaH0[6];
  out[7] = h + kSampleShaH0[7];
}

// Candidate i of a set whose state is st (8 big-endian words, most
// significant first): the low bits (mask = max_ - 1) of sha256 over the
// hex bytes of st + i.
__device__ __forceinline__ uint32_t candidate(const uint32_t (&st)[8], uint32_t i,
                                              uint32_t mask) {
  // v = st + i as 9 big-endian words, v[0] the carry out of 2^256
  uint32_t v[9];
  unsigned long long s = static_cast<unsigned long long>(st[7]) + i;
  v[8] = static_cast<uint32_t>(s);
#pragma unroll
  for (int w = 6; w >= 0; --w) {
    s = static_cast<unsigned long long>(st[w]) + (s >> 32);
    v[w + 1] = static_cast<uint32_t>(s);
  }
  v[0] = static_cast<uint32_t>(s >> 32);
  // k: v's hex digits (0 for v = 0); the most significant nonzero word
  // writes last
  int k = 0;
#pragma unroll
  for (int w = 8; w >= 0; --w)
    if (v[w] != 0u) k = (8 - w) * 8 + (32 - __clz(v[w]) + 3) / 4;
  // an odd digit count drops the last digit: v >>= 4
  if (k & 1) {
#pragma unroll
    for (int w = 8; w > 0; --w) v[w] = (v[w] >> 4) | (v[w - 1] << 28);
    v[0] >>= 4;
  }
  // the message: v's ell = k / 2 low bytes, big-endian (byte b < ell is
  // byte o + b of v's 36, o = 36 - ell), then the 0x80 terminator at byte
  // ell (ell <= 32: one block), the bit length in word 15.  Word j is v's
  // words q + j and q + j + 1 (q = o / 4) funnel-shifted by o mod 4 bytes;
  // the words move down by q in four select stages, in registers (an index
  // known only at run time would put v in local memory).
  const int ell = k >> 1, o = 36 - ell, q = o >> 2, r8 = 8 * (o & 3);
  uint32_t W[10];
#pragma unroll
  for (int t = 0; t < 9; ++t) W[t] = v[t];
  W[9] = 0u;
#pragma unroll
  for (int bit = 0; bit < 4; ++bit) {
    const bool on = ((q >> bit) & 1) != 0;
#pragma unroll
    for (int t = 0; t < 10; ++t) {
      const uint32_t next = t + (1 << bit) < 10 ? W[t + (1 << bit)] : 0u;
      W[t] = on ? next : W[t];
    }
  }
  uint32_t m[16];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int keep = ell - 4 * j;   // message bytes in word j
    const uint32_t w = __funnelshift_l(W[j + 1], W[j], r8);
    m[j] = keep >= 4 ? w : (keep <= 0 ? 0u : w & (0xFFFFFFFFu << (32 - 8 * keep)));
    if (keep >= 0 && keep < 4) m[j] |= 0x80u << (24 - 8 * keep);
  }
#pragma unroll
  for (int j = 9; j < 15; ++j) m[j] = 0u;
  m[15] = static_cast<uint32_t>(ell) * 8u;
  uint32_t d[8];
  sha256_block(m, d);
  return d[7] & mask;
}

}  // namespace

constexpr int kSampleMaxSets = 32;
constexpr int kSampleMaxCount = 1024;
constexpr int kSampleThreads = 256;

struct SampleSpec {
  int count[kSampleMaxSets];
  int n_cand[kSampleMaxSets];
  int excl[kSampleMaxSets];             // 0: no exclusion
  uint32_t mask[kSampleMaxSets];        // max_ - 1
  uint32_t excl_mask[kSampleMaxSets];   // exclude_multiples_of - 1
};

// One block a set: a first window of `first` candidates (64, 128 or 256),
// then windows of 256.  roots: [S, 8] LE words; idx: int64 [S, cap];
// found: [S].
__global__ void __launch_bounds__(kSampleThreads)
sample_queries_kernel(const uint32_t* __restrict__ roots, SampleSpec spec, int cap, int first,
                      long long* __restrict__ idx, int32_t* __restrict__ found_out) {
  constexpr int kWarps = kSampleThreads / 32;
  __shared__ uint32_t st_s[8];
  __shared__ __align__(16) uint32_t cand_s[kSampleThreads];
  __shared__ uint32_t taken[kSampleMaxCount];
  __shared__ int warp_s[kWarps];
  const int set = blockIdx.x;
  const int count = spec.count[set];
  const int n_cand = spec.n_cand[set];
  const uint32_t mask = spec.mask[set];
  const bool excl = spec.excl[set] != 0;
  const uint32_t excl_mask = spec.excl_mask[set];
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid >> 5, lane = tid & 31;
  if (warp == 0) {
    // state = sha256(the 32-byte root): LE words in, one padded block
    uint32_t m[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = __byte_perm(roots[set * 8 + j], 0, 0x0123);
    m[8] = 0x80000000u;
#pragma unroll
    for (int j = 9; j < 15; ++j) m[j] = 0u;
    m[15] = 256u;
    uint32_t d[8];
    sha256_block(m, d);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) st_s[j] = d[j];
    }
  }
  __syncthreads();
  uint32_t st[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j] = st_s[j];
  // every thread keeps `found` itself, from the same warp totals: uniform
  int found = 0;
  for (int base = 0, win = first; base < n_cand && found < count;
       base += win, win = kSampleThreads) {
    const int i = base + tid;
    uint32_t c = 0u;
    bool keep = false;
    if (tid < win && i < n_cand) {
      c = candidate(st, static_cast<uint32_t>(i), mask);
      keep = !excl || (c & excl_mask) != 0u;
    }
    cand_s[tid] = c;
    __syncthreads();
    // the window's first occurrence: no earlier candidate j < tid equals c
    // (an excluded one has an excluded value; one past n_cand comes after
    // every candidate in range)
    const uint4* c4 = reinterpret_cast<const uint4*>(cand_s);
    bool dup = false;
#pragma unroll 4
    for (int q = 0; keep && q < (warp + 1) * 8; ++q) {
      const uint4 e = c4[q];
      const int j = 4 * q;
      dup |= (j < tid) & (e.x == c);
      dup |= (j + 1 < tid) & (e.y == c);
      dup |= (j + 2 < tid) & (e.z == c);
      dup |= (j + 3 < tid) & (e.w == c);
    }
    keep = keep && !dup;
    for (int t = 0; base > 0 && keep && t < found; ++t) keep = taken[t] != c;
    const unsigned kmask = __ballot_sync(0xFFFFFFFFu, keep);
    if (lane == 0) warp_s[warp] = __popc(kmask);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_s[w] : 0;
      total += warp_s[w];
    }
    const int pos = found + before + __popc(kmask & ((1u << lane) - 1u));
    if (keep && pos < count) taken[pos] = c;
    found = min(count, found + total);
    __syncthreads();
  }
  for (int t = tid; t < cap; t += kSampleThreads)
    idx[static_cast<long long>(set) * cap + t] =
        t < found ? static_cast<long long>(taken[t]) : 0LL;
  if (tid == 0) found_out[set] = found;
}

}  // namespace gs

// roots: int32 [S, 8] on the card; counts, masks (max_ - 1), excls
// (exclude_multiples_of, 0 for none) and n_cands: S host values each; idx:
// int64 [S, cap]; found: int32 [S]; window: the first window's candidates,
// 64, 128 or 256.
extern "C" int gs_sample_queries(const void* roots, int S, const long long* counts,
                                 const long long* masks, const long long* excls,
                                 const long long* n_cands, int cap, int window, void* idx,
                                 void* found, void* stream) {
  if (S < 1 || S > gs::kSampleMaxSets || cap < 1) return cudaErrorInvalidValue;
  if (window != 64 && window != 128 && window != gs::kSampleThreads)
    return cudaErrorInvalidValue;
  gs::SampleSpec spec = {};
  for (int s = 0; s < S; ++s) {
    if (counts[s] < 1 || counts[s] > gs::kSampleMaxCount || counts[s] > cap)
      return cudaErrorInvalidValue;
    if (n_cands[s] < 1 || n_cands[s] > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    if (masks[s] < 0 || masks[s] > 0xFFFFFFFFLL || excls[s] < 0 || excls[s] > 0x100000000LL)
      return cudaErrorInvalidValue;
    spec.count[s] = static_cast<int>(counts[s]);
    spec.n_cand[s] = static_cast<int>(n_cands[s]);
    spec.mask[s] = static_cast<uint32_t>(masks[s]);
    spec.excl[s] = excls[s] != 0;
    spec.excl_mask[s] = static_cast<uint32_t>(excls[s] - 1);
  }
  gs::sample_queries_kernel<<<S, gs::kSampleThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(roots), spec, cap, window, static_cast<long long*>(idx),
      static_cast<int32_t*>(found));
  return cudaGetLastError();
}
