// Slot-form scattered interpolation: pilot-slot values (B, R, P) complex64,
// positions (B, P, 2) int32 and validity (B, P) float32 → grid (B, R, S, K).
//
// Replaces the TPU kernel ce5g_tpu/ops/interp_pallas.py::_interp_kernel and
// computes exactly the XLA branch of ce5g_tpu/estimators/interpolate.py::
// interpolate (:129-145), not the Pallas tiling:
//   (a) the valid pilots of a frame sorted by subcarrier, ties in slot order
//       (jnp.argsort is stable);
//   (b) for grid column k, the window of C = min(128, P) sorted pilots from
//       start = clip(searchsorted_left(k) − C/2, 0, max(n_valid − C, 0));
//       window entries past n_valid are invalid slots and never count;
//   (c) per output point (s, k), squared distances d² = (s − sy)² + (k − sc)²
//       (integers, exact) and weights: tied shells m1 < m2 < m3 of distinct
//       d² with weight 1 ('nearest', one shell) or 1/(m + 1e-6) ('linear',
//       three shells); for 'cubic' exp(−(d² − m)/(4(m + 1))) with m the
//       smallest d²; the weighted mean normalised by max(Σw, 1e-12). A frame
//       with no valid slot gives zeros.
// The Pallas kernel's 128-column tiles, 384-pilot windows and 8-aligned
// starts are TPU constraints; above ≈20% density they make it approximate.
//
// Design. One block per frame, one launch; everything after the inputs'
// first read stays in shared memory.
//   1. Sort. Each valid slot's column is counted into a per-column tally
//      (shared atomics); warp 0 turns the tally into the exclusive prefix
//      sum, which is searchsorted-left of every column, and n_valid. Warp 0
//      then walks the slots in order, 32 at a time: __match_any_sync groups
//      the lanes of one column, and each lane's place is its column's start
//      + the column's pilots placed so far + the lower lanes of its group.
//      That is a stable counting sort, and it needs no assumption about the
//      pilots' layout. The sorted (symbol, subcarrier) pairs and the 2R
//      floats of each sorted pilot's values are then gathered into shared
//      memory: at P = 2096 that is 8 KB + 34 KB (R = 2), 67 KB at R = 4.
//   2. Select and apply. One thread per output point, symbol fastest, so the
//      lanes of one column read the same candidate at once (a shared-memory
//      broadcast). 'nearest'/'linear': one pass keeps the smallest distinct
//      shells, a second accumulates the weighted values of those shells.
//      'cubic': one pass for the smallest d², a second accumulating the
//      Gaussian weights times the values of all R antennas at once.
//   The antenna count R is a template argument for R = 1, 2 and 4, the
//   counts the configurations use: the fixed trip count lets the R-loops
//   unroll with no guard (at R = 2 the guarded body took 0.93 ms instead
//   of 0.50 on the H100). Any other R ≤ 8 goes to one body that takes R
//   at run time, with arrays of 8 and an r < R guard.
//
// Bound on the H100 at the parity study's shape (B = 256, R = 2, P = 2096,
// S = 14, K = 599, 'cubic', 10% pilots): bytes are values (8.6 MB),
// positions (4.3 MB) and validity (2.1 MB) read once and the output
// (34.3 MB) written once, 49 MB, ≥ 15 µs at 3.35 TB/s. Operations: 2.15 M
// output points × 128 candidates × ≈17 float operations (distance 4, min 1,
// weight 3, sum 1, 4·R multiply-adds) ≈ 4.7 GFLOP, ≥ 70 µs at the 67 TFLOP/s
// float32 peak: the kernel is bound by operations. The weighted apply is a
// (S, C) × (C, 2R) product per column, which tensor cores could take later.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kCandidates = 128;
constexpr int kMaxR = 8;
enum { kNearest = 0, kLinear = 1, kCubic = 2 };

// starts[c] = Σ_{c' < c} counts[c'] for c ≤ K (starts[K] is the total), by
// one warp in chunks of 32 columns.
__device__ void exclusive_scan_warp(const int* counts, int* starts, int K, int lane) {
  int carry = 0;
  for (int base = 0; base < K; base += 32) {
    const int c = base + lane;
    const int v = c < K ? counts[c] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
    if (c < K) starts[c] = carry + incl - v;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) starts[K] = carry;
}

__device__ __forceinline__ int dist2(int coord, int s, int k) {
  const int dy = s - (coord >> 16);
  const int dk = k - (coord & 0xffff);
  return dy * dy + dk * dk;
}

// RC: R fixed at compile time, or 0 for the body that reads R at run time
template <int RC, int METHOD>
__global__ void __launch_bounds__(kThreads)
interp_kernel(const float2* __restrict__ vals, const int* __restrict__ positions,
              const float* __restrict__ valid, float2* __restrict__ out, int R_arg, int P,
              int S, int K) {
  constexpr int kR = RC > 0 ? RC : kMaxR;  // the R-loops' trip count
  const int R = RC > 0 ? RC : R_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s_val = reinterpret_cast<float2*>(smem);            // [P][R], sorted order
  int* s_coord = reinterpret_cast<int*>(s_val + (size_t)P * R);  // [P] (sy << 16) | sc, sorted
  int* s_key = s_coord + P;                                   // [P] column of each slot, −1 if invalid
  int* s_slot = s_key + P;                                    // [P] slot at each sorted place
  int* colstart = s_slot + P;                                 // [K + 1]
  int* colrun = colstart + K + 1;                             // [K]

  const size_t b = blockIdx.x;
  const float2* v_f = vals + b * R * P;
  const int* p_f = positions + b * P * 2;
  const float* ok_f = valid + b * P;
  float2* o_f = out + b * R * S * K;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // 1a. the column of every valid slot, and the pilots of each column. A
  // valid slot off the grid is outside the contract; it is dropped here so
  // that no shared-memory index leaves its array.
  for (int c = tid; c < K; c += kThreads) colrun[c] = 0;
  __syncthreads();
  for (int i = tid; i < P; i += kThreads) {
    const int sy = p_f[2 * i], sc = p_f[2 * i + 1];
    const bool on = ok_f[i] > 0.0f && sy >= 0 && sy < S && sc >= 0 && sc < K;
    s_key[i] = on ? sc : -1;
    if (on) atomicAdd(&colrun[sc], 1);
  }
  __syncthreads();
  if (warp == 0) exclusive_scan_warp(colrun, colstart, K, lane);
  __syncthreads();
  for (int c = tid; c < K; c += kThreads) colrun[c] = 0;
  __syncthreads();

  // 1b. stable placement in slot order
  if (warp == 0) {
    const unsigned below = (1u << lane) - 1u;
    for (int base = 0; base < P; base += 32) {
      const int i = base + lane;
      const int key = i < P ? s_key[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      int at = 0;
      if (key >= 0) at = colstart[key] + colrun[key] + __popc(peers & below);
      __syncwarp();
      if (key >= 0) {
        s_slot[at] = i;
        if (lane == 31 - __clz(peers)) colrun[key] += __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  const int n_valid = colstart[K];

  // 1c. sorted coordinates and values
  for (int q = tid; q < n_valid; q += kThreads) {
    const int i = s_slot[q];
    s_coord[q] = (p_f[2 * i] << 16) | p_f[2 * i + 1];
  }
  for (int e = tid; e < n_valid * R; e += kThreads) {
    const int q = e / R;
    s_val[e] = v_f[(size_t)(e - q * R) * P + s_slot[q]];
  }
  __syncthreads();

  // 2. one thread per output point (s, k), symbol fastest
  const int C = min(kCandidates, P);
  const int last_start = max(n_valid - C, 0);
  const int SK = S * K;
  for (int idx = tid; idx < SK; idx += kThreads) {
    const int k = idx / S;
    const int s = idx - k * S;
    const int lo = min(max(colstart[k] - C / 2, 0), last_start);
    const int hi = min(lo + C, n_valid);

    float acc_re[kR], acc_im[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc_re[r] = acc_im[r] = 0.0f;
    float wsum = 0.0f;

    if (METHOD == kCubic) {
      int m = INT_MAX;
      for (int q = lo; q < hi; ++q) m = min(m, dist2(s_coord[q], s, k));
      const float mf = (float)m;
      const float sigma2 = 4.0f * (mf + 1.0f);
      for (int q = lo; q < hi; ++q) {
        const float w = expf(-((float)dist2(s_coord[q], s, k) - mf) / sigma2);
        wsum += w;
        const float2* v = s_val + (size_t)q * R;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (RC > 0 || r < R) {
            const float2 x = v[r];
            acc_re[r] += w * x.x;
            acc_im[r] += w * x.y;
          }
        }
      }
    } else {
      // the smallest distinct squared distances (m2, m3 unused for nearest)
      int m1 = INT_MAX, m2 = INT_MAX, m3 = INT_MAX;
      for (int q = lo; q < hi; ++q) {
        const int d2 = dist2(s_coord[q], s, k);
        if (d2 < m1) {
          m3 = m2; m2 = m1; m1 = d2;
        } else if (METHOD == kLinear) {
          if (d2 > m1 && d2 < m2) {
            m3 = m2; m2 = d2;
          } else if (d2 > m2 && d2 < m3) {
            m3 = d2;
          }
        }
      }
      const int top = METHOD == kLinear ? m3 : m1;
      const float w1 = METHOD == kLinear ? 1.0f / ((float)m1 + 1e-6f) : 1.0f;
      const float w2 = 1.0f / ((float)m2 + 1e-6f);
      const float w3 = 1.0f / ((float)m3 + 1e-6f);
      for (int q = lo; q < hi; ++q) {
        const int d2 = dist2(s_coord[q], s, k);
        if (d2 > top) continue;
        const float w = d2 <= m1 ? w1 : (d2 <= m2 ? w2 : w3);
        wsum += w;
        const float2* v = s_val + (size_t)q * R;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (RC > 0 || r < R) {
            const float2 x = v[r];
            acc_re[r] += w * x.x;
            acc_im[r] += w * x.y;
          }
        }
      }
    }
    const float denom = fmaxf(wsum, 1e-12f);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (RC > 0 || r < R) {
        o_f[((size_t)r * S + s) * K + k] = make_float2(acc_re[r] / denom, acc_im[r] / denom);
      }
    }
  }
}

struct Args {
  const void* vals;
  const void* positions;
  const void* valid;
  void* out;
  int batch, R, P, S, K;
  cudaStream_t stream;
};

template <int RC, int METHOD>
int launch(const Args& a) {
  const size_t smem = (size_t)8 * a.R * a.P + (size_t)12 * a.P + (size_t)4 * (2 * a.K + 1);
  cudaError_t err = cudaFuncSetAttribute(
      interp_kernel<RC, METHOD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.batch == 0) return 0;
  interp_kernel<RC, METHOD><<<a.batch, kThreads, smem, a.stream>>>(
      (const float2*)a.vals, (const int*)a.positions, (const float*)a.valid, (float2*)a.out,
      a.R, a.P, a.S, a.K);
  return (int)cudaGetLastError();
}

template <int RC>
int launch_method(int method, const Args& a) {
  switch (method) {
    case kNearest: return launch<RC, kNearest>(a);
    case kLinear: return launch<RC, kLinear>(a);
    case kCubic: return launch<RC, kCubic>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// vals: (batch, R, P) complex64; positions: (batch, P, 2) int32; valid:
// (batch, P) float32; out: (batch, R, S, K) complex64; all contiguous on the
// device. method: 0 'nearest', 1 'linear', 2 'cubic'. Returns
// cudaGetLastError() after the launch.
int interp_launch(const void* vals, const void* positions, const void* valid, void* out,
                  int batch, int R, int P, int S, int K, int method, void* stream) {
  if (R < 1 || R > kMaxR || P < 1 || S < 1 || K < 1 || S > 32767 || K > 32767) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{vals, positions, valid, out, batch, R, P, S, K, (cudaStream_t)stream};
  switch (R) {
    case 1: return launch_method<1>(method, a);
    case 2: return launch_method<2>(method, a);
    case 4: return launch_method<4>(method, a);
  }
  return launch_method<0>(method, a);
}

const char* ce5g_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
