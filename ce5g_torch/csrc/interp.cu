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
//       (small integers, exact in float32) and weights: tied shells
//       m1 < m2 < m3 of distinct d² with weight 1 ('nearest', one shell) or
//       1/(m + 1e-6) ('linear', three shells); for 'cubic'
//       exp(−(d² − m)/(4(m + 1))) with m the smallest d²; the weighted mean
//       normalised by max(Σw, 1e-12). A frame with no valid slot gives zeros.
// The Pallas kernel's 128-column tiles, 384-pilot windows and 8-aligned
// starts are TPU constraints; above ≈20% density they make it approximate.
//
// Design. One block of 256 threads per frame, two blocks an SM, one launch;
// everything after the inputs' first read stays in shared memory.
//   1. Sort. Each valid slot's column is counted into a per-column tally
//      (shared atomics); warp 0 turns the tally into the exclusive prefix
//      sum, which is searchsorted-left of every column, and n_valid. Warp 0
//      then walks the slots in order, 32 at a time: __match_any_sync groups
//      the lanes of one column, and each lane's place is its column's start
//      + the column's pilots placed so far + the lower lanes of its group.
//      That is a stable counting sort, and it needs no assumption about the
//      pilots' layout. It stays on one warp: it measured below 1% of the
//      kernel. The sorted (symbol, subcarrier) pairs, as floats, and the 2R
//      floats of each sorted pilot's values are then gathered into shared
//      memory: at P = 2096 that is 17 KB + 34 KB (R = 2), 67 KB at R = 4.
//   2. Select and apply, with the candidates in registers. All S symbols
//      of column k share one window and one (k − sc)² per candidate, so a
//      warp takes 16 columns at once, two lanes a column, and each lane
//      carries 7 symbols of its column (symbols 0-6 and 7-13 at S = 14;
//      more symbols take another round). A lane loads a candidate's
//      coordinates (one 8-byte load) and its values (16-byte loads) once
//      and uses them for its 7 symbols, whose 7·(2·RC + 1) sums live in
//      registers: shared loads per (point, candidate) fall from 2 + R to
//      under 1, and (k − sc)² is computed once per column. Every column's
//      window holds the same number of candidates, so the lanes of a warp
//      run the loops together. 'cubic': one pass for the smallest d², one
//      for the weights, 2^(m·c − d²·c) with c = log2(e)/(4(m + 1)) hoisted
//      out of the loop and ex2.approx (relative error 2^-22: the weights
//      change in their last bits, far inside the 1e-5 tolerance).
//      'nearest'/'linear': one pass keeps the smallest distinct shells with
//      a branch-free min/max network, a second applies every candidate
//      inside them with its own weight 1/(d² + 1e-6).
//   The kernel takes RC antennas at a time, RC = 4, 2 or 1, whichever
//   divides R (a template argument: unrolled, unguarded R-loops); any
//   other R ≤ 8 runs the passes R/RC times. 9 instances.
//   Not taken: the apply as an mma.sync TF32 product. Plain TF32 keeps
//   three digits and breaks the tolerance, the three-product split would
//   remove the 4·R multiply-adds but nothing of the weight computation,
//   which is now the larger part (5 of the 9 operations issued per
//   candidate at R = 2, one of them on the SFU); wgmma's 64-row tiles do not fit a
//   14-row product.
//
// Bound on the H100 at the parity study's shape (B = 256, R = 2, P = 2096,
// S = 14, K = 599, 'cubic', 10% pilots): bytes are values (8.6 MB),
// positions (4.3 MB) and validity (2.1 MB) read once and the output
// (34.3 MB) written once, 49 MB, ≥ 15 µs at 3.35 TB/s. Operations: 2.15 M
// output points × 128 candidates × ≈17 float operations (distance 4, min 1,
// weight 3, sum 1, 4·R multiply-adds) ≈ 4.7 GFLOP, ≥ 70 µs at the 67 TFLOP/s
// float32 peak: the kernel is bound by operations. One ex2 per (point,
// candidate) on the SM's 16 special-function lanes alone takes ≈ 77 µs.

#include <cfloat>
#include <cuda_runtime.h>


namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCandidates = 128;
constexpr int kMaxR = 8;
constexpr int kSym = 7;    // symbols a lane carries in registers
constexpr int kCols = 16;  // columns a warp takes at once: 2 lanes a column
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

// 2^x, relative error 2^-22; −inf and anything below −126 give 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// RC antennas at a time (R is a multiple of RC)
template <int RC, int METHOD>
__global__ void __launch_bounds__(kThreads, 2)
interp_kernel(const float2* __restrict__ vals, const int* __restrict__ positions,
              const float* __restrict__ valid, float2* __restrict__ out, int R, int P, int S,
              int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s_val = reinterpret_cast<float2*>(smem);          // [P][R], sorted order
  float2* s_coord = s_val + (size_t)P * R;                  // [P] (symbol, subcarrier), sorted
  int* s_key = reinterpret_cast<int*>(s_coord + P);         // [P] column of each slot, −1 if invalid
  int* s_slot = s_key + P;                                  // [P] slot at each sorted place
  int* colstart = s_slot + P;                               // [K + 1]
  int* colrun = colstart + K + 1;                           // [K]

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
    s_coord[q] = make_float2((float)p_f[2 * i], (float)p_f[2 * i + 1]);
  }
  for (int e = tid; e < n_valid * R; e += kThreads) {
    const int q = e / R;
    s_val[e] = v_f[(size_t)(e - q * R) * P + s_slot[q]];
  }
  __syncthreads();

  // 2. a warp takes kCols columns at once, two lanes a column, each lane
  // kSym symbols of it: a candidate is loaded once and used kSym times
  const int C = min(kCandidates, P);
  const int n_c = min(C, n_valid);  // every column's window holds as many
  const int last_start = max(n_valid - C, 0);
  const int col = lane % kCols, half = lane / kCols;
  for (int r0 = 0; r0 < R; r0 += RC) {
    for (int s0 = half * kSym; s0 < S; s0 += 2 * kSym) {
      for (int k = warp * kCols + col; k < K; k += kWarps * kCols) {
        const int lo = min(max(colstart[k] - C / 2, 0), last_start);
        const float2* cq = s_coord + lo;
        const float2* vq = s_val + (size_t)lo * R + r0;
        const float kf = (float)k;
        float sf[kSym];
#pragma unroll
        for (int t = 0; t < kSym; ++t) sf[t] = (float)(s0 + t);

        // top[t]: the largest squared distance that still counts ('nearest',
        // 'linear'), or the smallest ('cubic')
        float top[kSym];
        if (METHOD == kLinear) {
          float m1[kSym], m2[kSym];
#pragma unroll
          for (int t = 0; t < kSym; ++t) m1[t] = m2[t] = top[t] = FLT_MAX;
          for (int j = 0; j < n_c; ++j) {
            const float2 co = cq[j];
            const float dk = kf - co.y, dk2 = dk * dk;
#pragma unroll
            for (int t = 0; t < kSym; ++t) {
              const float dy = sf[t] - co.x;
              float d2 = fmaf(dy, dy, dk2);
              if (d2 == m1[t] || d2 == m2[t]) d2 = FLT_MAX;  // shells are distinct values
              const float a = fmaxf(m1[t], d2);
              m1[t] = fminf(m1[t], d2);
              const float c2 = fmaxf(m2[t], a);
              m2[t] = fminf(m2[t], a);
              top[t] = fminf(top[t], c2);
            }
          }
        } else {
#pragma unroll
          for (int t = 0; t < kSym; ++t) top[t] = FLT_MAX;
          for (int j = 0; j < n_c; ++j) {
            const float2 co = cq[j];
            const float dk = kf - co.y, dk2 = dk * dk;
#pragma unroll
            for (int t = 0; t < kSym; ++t) {
              const float dy = sf[t] - co.x;
              top[t] = fminf(top[t], fmaf(dy, dy, dk2));
            }
          }
        }

        float wsum[kSym], acc_re[kSym][RC], acc_im[kSym][RC];
        // cubic: w = exp(−(d² − m)/(4(m + 1))) = 2^(off − d²·cs)
        float cs[kSym], off[kSym];
#pragma unroll
        for (int t = 0; t < kSym; ++t) {
          wsum[t] = 0.0f;
          cs[t] = 1.4426950408889634f / (4.0f * (top[t] + 1.0f));
          off[t] = top[t] * cs[t];
#pragma unroll
          for (int r = 0; r < RC; ++r) acc_re[t][r] = acc_im[t][r] = 0.0f;
        }
        for (int j = 0; j < n_c; ++j) {
          const float2 co = cq[j];
          const float dk = kf - co.y, dk2 = dk * dk;
          float2 x[RC];
          if (RC % 2 == 0) {
            const float4* v4 = reinterpret_cast<const float4*>(vq + (size_t)j * R);
#pragma unroll
            for (int r = 0; r < RC / 2; ++r) {
              const float4 y = v4[r];
              x[2 * r] = make_float2(y.x, y.y);
              x[2 * r + 1] = make_float2(y.z, y.w);
            }
          } else {
#pragma unroll
            for (int r = 0; r < RC; ++r) x[r] = vq[(size_t)j * R + r];
          }
#pragma unroll
          for (int t = 0; t < kSym; ++t) {
            const float dy = sf[t] - co.x;
            const float d2 = fmaf(dy, dy, dk2);
            if (METHOD == kCubic) {
              const float w = ex2(fmaf(-d2, cs[t], off[t]));
              wsum[t] += w;
#pragma unroll
              for (int r = 0; r < RC; ++r) {
                acc_re[t][r] = fmaf(w, x[r].x, acc_re[t][r]);
                acc_im[t][r] = fmaf(w, x[r].y, acc_im[t][r]);
              }
            } else if (d2 <= top[t]) {
              // a candidate inside the shells lies on one of them: its weight is its own
              const float w = METHOD == kLinear ? 1.0f / (d2 + 1e-6f) : 1.0f;
              wsum[t] += w;
#pragma unroll
              for (int r = 0; r < RC; ++r) {
                acc_re[t][r] = fmaf(w, x[r].x, acc_re[t][r]);
                acc_im[t][r] = fmaf(w, x[r].y, acc_im[t][r]);
              }
            }
          }
        }
#pragma unroll
        for (int t = 0; t < kSym; ++t) {
          const int s = s0 + t;
          if (s < S) {
            const float inv = 1.0f / fmaxf(wsum[t], 1e-12f);
#pragma unroll
            for (int r = 0; r < RC; ++r) {
              o_f[((size_t)(r0 + r) * S + s) * K + k] =
                  make_float2(acc_re[t][r] * inv, acc_im[t][r] * inv);
            }
          }
        }
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
  const size_t smem = (size_t)8 * a.R * a.P + (size_t)16 * a.P + (size_t)4 * (2 * a.K + 1);
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
  // squared distances are held in float32: exact while S² + K² ≤ 2^24
  if (R < 1 || R > kMaxR || P < 1 || S < 1 || K < 1 || S > 4096 || K > 4096 ||
      S * S + K * K > (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{vals, positions, valid, out, batch, R, P, S, K, (cudaStream_t)stream};
  if (R % 4 == 0) return launch_method<4>(method, a);
  if (R % 2 == 0) return launch_method<2>(method, a);
  return launch_method<1>(method, a);
}

const char* ce5g_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
