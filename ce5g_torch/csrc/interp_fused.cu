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
// A missing candidate has distance +inf (the XLA branch's sentinel, not the
// Pallas kernel's 3e30); it never enters a shell, so the weights are the same.
//
// Design. One block per frame, one launch. One frame's values with R = 4
// take 9 planes × 14 × 599 × 4 B ≈ 302 KB, more than a block's 227 KB of
// shared memory, so only the pilot POSITIONS are kept on chip: the value of
// a candidate is values[r, row, pos], read from device memory (L2) by index.
//   1. Fill: one warp per source row scans the row in 32-column chunks. A
//      ballot of the chunk's mask gives each lane its nearest pilots inside
//      the chunk by bit arithmetic (__clz from the left, __ffs from the
//      right); the two nearest pilots of the chunks already passed are
//      carried. Results go to shared memory as int16 columns, −1 = none:
//      4 · S · K · 2 B = 67 KB at S = 14, K = 599.
//   2. Select and apply: one thread per output point (s, k) of the frame.
//      One pass over the candidates keeps the three smallest distinct
//      squared distances; a second pass accumulates the weighted values of
//      the candidates inside the shells for all R antennas at once.
//
// Bound on the H100 at the main-path shape (B = 256, R = 4, S = 14,
// K = 599): bytes are the mask (8.6 MB) and values (68.7 MB) read once and
// the output (68.7 MB) written once, 146 MB, so ≥ 44 µs at 3.35 TB/s. The
// selection does ≈ 5 float operations for each of the S·C·K (C = 4·S)
// candidate distances per frame, ≈ 0.6 GFLOP at B = 256, ≈ 9 µs at the
// float32 peak: the kernel is bound by bytes. The design reads each value
// a few times from L2 but moves each byte through device memory once and
// writes no intermediate there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;

__device__ __forceinline__ int hi_bit(unsigned v) { return 31 - __clz(v); }
__device__ __forceinline__ int lo_bit(unsigned v) { return __ffs(v) - 1; }

// Nearest and second-nearest pilot column at-or-left (p1l, p2l) and
// at-or-right (p1r, p2r) of every column of one row; −1 where there is none.
__device__ void fill_row(const float* __restrict__ mask_row, int K, int16_t* p1l,
                         int16_t* p2l, int16_t* p1r, int16_t* p2r, int lane) {
  int c1 = -1, c2 = -1;  // two nearest pilots of the chunks passed
  for (int base = 0; base < K; base += 32) {
    const int col = base + lane;
    const bool ok = col < K && mask_row[col] > 0.0f;
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    const unsigned upto = bal & (0xffffffffu >> (31 - lane));  // lanes ≤ this one
    int a1 = c1, a2 = c2;
    if (upto) {
      const int h = hi_bit(upto);
      const unsigned rest = upto & ~(1u << h);
      a1 = base + h;
      a2 = rest ? base + hi_bit(rest) : c1;
    }
    if (col < K) {
      p1l[col] = (int16_t)a1;
      p2l[col] = (int16_t)a2;
    }
    if (bal) {
      const int h = hi_bit(bal);
      const unsigned rest = bal & ~(1u << h);
      c2 = rest ? base + hi_bit(rest) : c1;
      c1 = base + h;
    }
  }
  c1 = -1;
  c2 = -1;
  for (int base = ((K - 1) / 32) * 32; base >= 0; base -= 32) {
    const int col = base + lane;
    const bool ok = col < K && mask_row[col] > 0.0f;
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    const unsigned from = bal & (0xffffffffu << lane);  // lanes ≥ this one
    int a1 = c1, a2 = c2;
    if (from) {
      const unsigned rest = from & (from - 1);
      a1 = base + lo_bit(from);
      a2 = rest ? base + lo_bit(rest) : c1;
    }
    if (col < K) {
      p1r[col] = (int16_t)a1;
      p2r[col] = (int16_t)a2;
    }
    if (bal) {
      const unsigned rest = bal & (bal - 1);
      c2 = rest ? base + lo_bit(rest) : c1;
      c1 = base + lo_bit(bal);
    }
  }
}

// Column of candidate `side` of row `row` for output column k, and its
// |Δk| (or +inf when absent). Sides: 0 = nearest left, 1 = nearest right,
// 2 = second left, 3 = second right.
__device__ __forceinline__ float cand(const int16_t* fills, int SK, int idx, int side,
                                      int k, int* pos) {
  const int p = fills[side * SK + idx];
  *pos = p;
  if (p < 0) return INFINITY;
  if (side == 1 && p == fills[idx]) return INFINITY;  // pilot at k counted once
  return (float)((side & 1) ? p - k : k - p);
}

__global__ void __launch_bounds__(kThreads)
interp_fused_kernel(const float* __restrict__ mask, const float2* __restrict__ vals,
                    float2* __restrict__ out, int R, int S, int K, int linear) {
  extern __shared__ int16_t fills[];  // [side][row][col], side order as cand()
  const int SK = S * K;
  const size_t frame = blockIdx.x;
  const float* m_f = mask + frame * SK;
  const float2* v_f = vals + frame * R * SK;
  float2* o_f = out + frame * R * SK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int row = warp; row < S; row += kWarps) {
    const int o = row * K;
    fill_row(m_f + o, K, fills + o, fills + 2 * SK + o, fills + SK + o,
             fills + 3 * SK + o, lane);
  }
  __syncthreads();

  const int n_sides = linear ? 4 : 2;
  for (int idx = threadIdx.x; idx < SK; idx += kThreads) {
    const int s = idx / K;
    const int k = idx - s * K;

    // three smallest distinct squared distances (m2, m3 unused for nearest)
    float m1 = INFINITY, m2 = INFINITY, m3 = INFINITY;
    for (int row = 0; row < S; ++row) {
      const float dr = (float)(s - row);
      const int at = row * K + k;
      for (int side = 0; side < n_sides; ++side) {
        int p;
        const float d = cand(fills, SK, at, side, k, &p);
        const float d2 = dr * dr + d * d;
        if (d2 < m1) {
          m3 = m2; m2 = m1; m1 = d2;
        } else if (d2 > m1 && d2 < m2) {
          m3 = m2; m2 = d2;
        } else if (d2 > m2 && d2 < m3) {
          m3 = d2;
        }
      }
    }
    const float top = linear ? m3 : m1;
    const float w1 = linear ? 1.0f / (m1 + 1e-6f) : 1.0f;
    const float w2 = 1.0f / (m2 + 1e-6f);
    const float w3 = 1.0f / (m3 + 1e-6f);

    float wsum = 0.0f;
    float acc_re[kMaxR], acc_im[kMaxR];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) acc_re[r] = acc_im[r] = 0.0f;
    for (int row = 0; row < S; ++row) {
      const float dr = (float)(s - row);
      const int at = row * K + k;
      for (int side = 0; side < n_sides; ++side) {
        int p;
        const float d = cand(fills, SK, at, side, k, &p);
        const float d2 = dr * dr + d * d;
        if (!(d2 <= top) || d2 == INFINITY) continue;
        const float w = d2 <= m1 ? w1 : (d2 <= m2 ? w2 : w3);
        wsum += w;
        const float2* v = v_f + row * K + p;
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r < R) {
            const float2 x = v[(size_t)r * SK];
            acc_re[r] += w * x.x;
            acc_im[r] += w * x.y;
          }
        }
      }
    }
    const float denom = fmaxf(wsum, 1e-12f);
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r < R) o_f[(size_t)r * SK + idx] = make_float2(acc_re[r] / denom, acc_im[r] / denom);
    }
  }
}

}  // namespace

extern "C" {

// mask: (batch, S, K) float32; vals, out: (batch, R, S, K) complex64; all
// contiguous on the device. linear: 1 for 'linear', 0 for 'nearest'.
// Returns cudaGetLastError() after the launch.
int interp_fused_launch(const void* mask, const void* vals, void* out, int batch, int R,
                        int S, int K, int linear, void* stream) {
  if (R < 1 || R > kMaxR || S < 1 || K < 1 || K > 32767) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)4 * S * K * sizeof(int16_t);
  cudaError_t err = cudaFuncSetAttribute(
      interp_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return 0;
  interp_fused_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)mask, (const float2*)vals, (float2*)out, R, S, K, linear);
  return (int)cudaGetLastError();
}

const char* ce5g_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
