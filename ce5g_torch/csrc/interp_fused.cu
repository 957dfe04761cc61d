// Fused grid-form scattered interpolation: masked pilot values (B, R, S, K)
// + pilot mask (B, S, K) → interpolated grid (B, R, S, K).
//
// Replaces the TPU kernel ce5g_tpu/ops/interp_fused_pallas.py::_kernel and
// computes exactly the XLA branch of ce5g_tpu/estimators/interpolate.py::
// interpolate_grid (:264-326):
//   (a) per source row, the nearest pilot column at or left of each column
//       and at or right of it ('linear': also the second nearest on each
//       side);
//   (b) per output point (s, k), a tied-shell k-NN over the 2·S
//       ('nearest') or 4·S ('linear') row candidates with squared distance
//       (s − row)² + Δk²: the distinct shell values m1 < m2 < m3, weights
//       1/(m + 1e-6) ('linear') or 1 ('nearest') for every candidate in a
//       shell, a pilot exactly at the column counted once (the right-side
//       nearest is dropped when it is the left-side nearest), and the
//       weighted mean normalised by max(Σw, 1e-12); an empty mask gives 0.
// A missing candidate never enters a shell (the XLA branch gives it +inf;
// here it is INT_MAX), so the weights are the same.
//
// Design. One launch; a block takes one frame and a tile of ≤ 128 columns
// (5 tiles of 120 at K = 599), so any batch gives the card enough blocks.
// One frame's values with R = 4 take ≈ 302 KB, more than a block's shared
// memory, so only pilot POSITIONS are kept on chip; the value of a
// candidate is values[r, row, col], read from device memory (L2) by index.
//   A. The frame's mask becomes bits, one 32-column word per ballot, with 8
//      loads in flight a lane (the ballots would otherwise wait for each).
//   B. One thread per row and direction walks the row's words and notes,
//      for every word, the two nearest pilots outside it on that side.
//   C. One thread per (row, column) of the tile finds its four candidates
//      by bit arithmetic on its own word (__clz from the left, __ffs from
//      the right) or takes the word's carried ones, and stores them side by
//      side as one 8-byte short4 {nearest left, nearest right, second left,
//      second right}, −1 = none. The rule that a pilot at the column counts
//      once is settled here: its right-side entry is −1.
//   D. One thread per output point. Distances are integers (exact). Pass 1
//      visits the source rows outwards from the point's own (0, ±1, ±2, …)
//      and keeps the smallest distinct squared distances with a branch-free
//      min/max network; a candidate of row `row` has d² ≥ (s − row)², so
//      the walk stops once (s − row)² exceeds the top shell (m3 for
//      'linear', m1 for 'nearest'; INT_MAX while a shell is empty, so
//      nothing stops early then). This pruning is exact at every density:
//      at 10% pilots about half the rows are left, at 1% all of them.
//      Pass 2 walks the same rows, and each thread LISTS the candidates
//      inside its shells (up to 8, in shared memory) instead of applying
//      them where it finds them: lanes accept different candidates, and
//      applying in place made a warp run the apply body for every slot
//      some lane accepted. The listed candidates are then applied in a
//      loop that the lanes of a warp run together; a thread with more than
//      8 (many tied distances, a regular lattice) applies the rest in
//      place. A candidate inside the shells lies on one of them, so its
//      weight 1/(d² + 1e-6) needs no shell lookup.
//   R is a template argument for 1, 2 and 4 (unguarded, unrolled R-loops),
//   with one body that reads R at run time for any other R ≤ 8; 'linear'
//   is a template argument too: 8 instances.
//
// Bound on the H100 at the main-path shape (B = 256, R = 4, S = 14,
// K = 599): bytes are the mask (8.6 MB) and values (68.7 MB) read once and
// the output (68.7 MB) written once, 146 MB, so ≥ 44 µs at 3.35 TB/s. The
// selection costs ≈ 5 operations for each of the S·C·K (C = 4·S)
// candidate distances per frame, ≈ 0.6 GFLOP at B = 256, ≈ 9 µs at the
// float32 peak, and the pruning does less than that: the kernel is bound
// by bytes. What it spends is instruction issue in D, not memory: with the
// value loads removed altogether it ran 6% faster on the H100.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;
constexpr int kMaxS = 127;  // a listed candidate packs its row into 7 bits
constexpr int kBlocksPerSM = 6;  // caps the kernel at 40 registers a thread
constexpr int kTile = 128;       // most columns a block takes
constexpr int kList = 8;         // accepted candidates a thread lists before it applies them

__device__ __forceinline__ int hi_bit(unsigned v) { return 31 - __clz(v); }
__device__ __forceinline__ int lo_bit(unsigned v) { return __ffs(v) - 1; }

// Squared distance of the candidate at column p (−1: none) of a row dr2 = Δrow²
// away from output column k; INT_MAX for a missing candidate.
__device__ __forceinline__ int cand_d2(int p, int k, int dr2) {
  const int dk = p - k;
  return p < 0 ? INT_MAX : dr2 + dk * dk;
}

// Keep the smallest distinct values m1 < m2 < m3 (LINEAR) or the smallest (else).
template <bool LINEAR>
__device__ __forceinline__ void insert(int d2, int& m1, int& m2, int& m3) {
  if (LINEAR) {
    if (d2 == m1 || d2 == m2) d2 = INT_MAX;
    const int t = max(m1, d2);
    m1 = min(m1, d2);
    const int u = max(m2, t);
    m2 = min(m2, t);
    m3 = min(m3, u);
  } else {
    m1 = min(m1, d2);
  }
}

// RC: R fixed at compile time (1, 2, 4), or 0 for the body that reads R at run time
template <bool LINEAR, int RC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
interp_fused_kernel(const float* __restrict__ mask, const float2* __restrict__ vals,
                    float2* __restrict__ out, int R_arg, int S, int K, int TK, int tiles) {
  constexpr int kR = RC > 0 ? RC : kMaxR;  // the R-loops' trip count
  const int R = RC > 0 ? RC : R_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) / 32;
  short4* fills = reinterpret_cast<short4*>(smem);               // [S][TK] {p1l, p1r, p2l, p2r}
  unsigned* bits = reinterpret_cast<unsigned*>(fills + S * TK);  // [S][W] mask bits
  int* l1 = reinterpret_cast<int*>(bits + S * W);                // [S][W] last pilot left of word
  int* l2 = l1 + S * W;                                          // second last
  int* r1 = l2 + S * W;                                          // first pilot right of word
  int* r2 = r1 + S * W;                                          // second
  unsigned* list = reinterpret_cast<unsigned*>(r2 + S * W);      // [kList][kThreads] (row << 16) | col

  const int SK = S * K;
  const int tile = blockIdx.x % tiles;
  const size_t frame = blockIdx.x / tiles;
  const int k0 = tile * TK;
  const int tk = min(TK, K - k0);
  const float* m_f = mask + frame * SK;
  const float2* v_f = vals + frame * R * SK;
  float2* o_f = out + frame * R * SK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // A. the frame's mask as bits
  // kLoads loads in flight a lane: the ballots wait for none but their own
  constexpr int kLoads = 8;
  for (int base = warp * kLoads; base < S * W; base += kWarps * kLoads) {
    float x[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int item = base + u;
      const int row = item / W, col = (item - row * W) * 32 + lane;
      x[u] = item < S * W && col < K ? m_f[row * K + col] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const unsigned bal = __ballot_sync(0xffffffffu, x[u] > 0.0f);
      if (lane == 0 && base + u < S * W) bits[base + u] = bal;
    }
  }
  __syncthreads();

  // B. per row, the two nearest pilots outside each word, from either side
  if (tid < kThreads / 2) {
    for (int row = tid; row < S; row += kThreads / 2) {
      const unsigned* b = bits + row * W;
      int c1 = -1, c2 = -1;
      for (int w = 0; w < W; ++w) {
        l1[row * W + w] = c1;
        l2[row * W + w] = c2;
        const unsigned word = b[w];
        if (word) {
          const int h = hi_bit(word);
          const unsigned rest = word & ~(1u << h);
          c2 = rest ? w * 32 + hi_bit(rest) : c1;
          c1 = w * 32 + h;
        }
      }
    }
  } else {
    for (int row = tid - kThreads / 2; row < S; row += kThreads / 2) {
      const unsigned* b = bits + row * W;
      int c1 = -1, c2 = -1;
      for (int w = W - 1; w >= 0; --w) {
        r1[row * W + w] = c1;
        r2[row * W + w] = c2;
        const unsigned word = b[w];
        if (word) {
          const unsigned rest = word & (word - 1);
          c2 = rest ? w * 32 + lo_bit(rest) : c1;
          c1 = w * 32 + lo_bit(word);
        }
      }
    }
  }
  __syncthreads();

  // C. the four candidates of every (row, column) of the tile
  for (int i = tid; i < S * tk; i += kThreads) {
    const int row = i / tk, cl = i - row * tk;
    const int col = k0 + cl, w = col >> 5, bit = col & 31, at = row * W + w;
    const unsigned word = bits[at];
    const unsigned upto = word & (0xffffffffu >> (31 - bit));
    const unsigned from = word & (0xffffffffu << bit);
    int a1 = l1[at], a2 = l2[at], b1 = r1[at], b2 = r2[at];
    if (upto) {
      const int h = hi_bit(upto);
      const unsigned rest = upto & ~(1u << h);
      a2 = rest ? w * 32 + hi_bit(rest) : a1;
      a1 = w * 32 + h;
    }
    if (from) {
      const unsigned rest = from & (from - 1);
      b2 = rest ? w * 32 + lo_bit(rest) : b1;
      b1 = w * 32 + lo_bit(from);
    }
    if (b1 == a1) b1 = -1;  // a pilot at the column itself counts once
    fills[row * TK + cl] = make_short4((short)a1, (short)b1, (short)a2, (short)b2);
  }
  __syncthreads();

  // D. one thread per output point of the tile
  for (int i = tid; i < S * tk; i += kThreads) {
    const int s = i / tk, cl = i - s * tk, k = k0 + cl;

    int m1 = INT_MAX, m2 = INT_MAX, m3 = INT_MAX;
    for (int dr = 0; dr < S; ++dr) {
      const int dr2 = dr * dr;
      if (dr2 > (LINEAR ? m3 : m1)) break;
#pragma unroll
      for (int sgn = 0; sgn < 2; ++sgn) {
        const int row = sgn ? s + dr : s - dr;
        if (row < 0 || row >= S || (sgn && dr == 0)) continue;
        const short4 f = fills[row * TK + cl];
        insert<LINEAR>(cand_d2(f.x, k, dr2), m1, m2, m3);
        insert<LINEAR>(cand_d2(f.y, k, dr2), m1, m2, m3);
        if (LINEAR) {
          insert<LINEAR>(cand_d2(f.z, k, dr2), m1, m2, m3);
          insert<LINEAR>(cand_d2(f.w, k, dr2), m1, m2, m3);
        }
      }
    }
    const int top = LINEAR ? m3 : m1;

    float wsum = 0.0f;
    float acc_re[kR], acc_im[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc_re[r] = acc_im[r] = 0.0f;
    // a candidate inside the shells lies on one of them: its weight is its own
    auto apply = [&](int row, int p, int d2) {
      const float w = LINEAR ? __fdividef(1.0f, (float)d2 + 1e-6f) : 1.0f;
      wsum += w;
      const float2* v = v_f + row * K + p;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (RC == 0 && r >= R) break;
        const float2 x = v[(size_t)r * SK];
        acc_re[r] = fmaf(w, x.x, acc_re[r]);
        acc_im[r] = fmaf(w, x.y, acc_im[r]);
      }
    };
    int n = 0;
    for (int dr = 0; dr < S; ++dr) {
      const int dr2 = dr * dr;
      if (dr2 > top) break;
#pragma unroll
      for (int sgn = 0; sgn < 2; ++sgn) {
        const int row = sgn ? s + dr : s - dr;
        if (row < 0 || row >= S || (sgn && dr == 0)) continue;
        const short4 f = fills[row * TK + cl];
        const int ps[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int side = 0; side < (LINEAR ? 4 : 2); ++side) {
          const int p = ps[side];
          const int d2 = cand_d2(p, k, dr2);
          if (d2 > top || d2 == INT_MAX) continue;
          if (n < kList) {
            list[n * kThreads + tid] = ((unsigned)row << 16) | (unsigned)p;
          } else {
            apply(row, p, d2);
          }
          ++n;
        }
      }
    }
    n = min(n, kList);
    for (int j = 0; j < n; ++j) {
      const unsigned e = list[j * kThreads + tid];
      const int row = (int)(e >> 16), p = (int)(e & 0xffffu);
      const int dr = s - row, dk = p - k;
      apply(row, p, dr * dr + dk * dk);
    }
    const float inv = 1.0f / fmaxf(wsum, 1e-12f);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (RC > 0 || r < R) {
        o_f[(size_t)r * SK + s * K + k] = make_float2(acc_re[r] * inv, acc_im[r] * inv);
      }
    }
  }
}

template <bool LINEAR, int RC>
int launch(const float* mask, const float2* vals, float2* out, int batch, int R, int S, int K,
           cudaStream_t stream) {
  const int tiles = (K + kTile - 1) / kTile;
  const int TK = (K + tiles - 1) / tiles;
  const int W = (K + 31) / 32;
  size_t smem = (size_t)8 * S * TK + (size_t)4 * 5 * S * W + (size_t)4 * kList * kThreads;
  cudaError_t err = cudaFuncSetAttribute(interp_fused_kernel<LINEAR, RC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return 0;
  interp_fused_kernel<LINEAR, RC><<<(unsigned)(batch * tiles), kThreads, smem, stream>>>(
      mask, vals, out, R, S, K, TK, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mask: (batch, S, K) float32; vals, out: (batch, R, S, K) complex64; all
// contiguous on the device. linear: 1 for 'linear', 0 for 'nearest'.
// Returns cudaGetLastError() after the launch.
int interp_fused_launch(const void* mask, const void* vals, void* out, int batch, int R,
                        int S, int K, int linear, void* stream) {
  if (R < 1 || R > kMaxR || S < 1 || S > kMaxS || K < 1 || K > 32767) {
    return (int)cudaErrorInvalidValue;
  }
  const float* m = (const float*)mask;
  const float2* v = (const float2*)vals;
  float2* o = (float2*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (R) {
    case 1: return linear ? launch<true, 1>(m, v, o, batch, R, S, K, st)
                          : launch<false, 1>(m, v, o, batch, R, S, K, st);
    case 2: return linear ? launch<true, 2>(m, v, o, batch, R, S, K, st)
                          : launch<false, 2>(m, v, o, batch, R, S, K, st);
    case 4: return linear ? launch<true, 4>(m, v, o, batch, R, S, K, st)
                          : launch<false, 4>(m, v, o, batch, R, S, K, st);
  }
  return linear ? launch<true, 0>(m, v, o, batch, R, S, K, st)
                : launch<false, 0>(m, v, o, batch, R, S, K, st);
}

const char* ce5g_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
