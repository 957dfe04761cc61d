// Batched complex Hermitian-positive-definite solve, A_b · X_b = B_b.
//
// Replaces the TPU kernel ce5g_tpu/ops/hpd_solve_pallas.py::_kernel, which
// solves the mmse_full Woodbury system (n = paths × time rank = 45 at the
// default config, R = rx antennas ≤ 8 right-hand sides) with the batch on
// the TPU's 128 lanes.
//
// What bounds it on the H100. At the bench shape (B = 256, n = 45, R = 4)
// the bytes (A read, B read, X written: 4.9 MB, 1.5 µs at 3.35 TB/s) and
// the operations (≈ 50 MFLOP, under 1 µs at the float32 peak) are both
// below the ≈ 2 µs that an empty launch takes. All systems of a batch run
// at once (a block each, the whole launch is one wave), so the kernel's
// time is the length of ONE system's chain of n dependent elimination
// steps, and the design is about making a step short:
//
//  * A step costs a block barrier, a shared-memory read, a reciprocal, a
//    multiply-subtract and a shared-memory write, whatever the work in it. So
//    there is ONE barrier a column, not six: the factorization is LDLᴴ
//    (no square root, the column is not scaled before the update: the
//    update multiplies by the reciprocal pivot itself), and the forward
//    substitution rides on it: the working matrix is the lower trapezoid
//    of [[A], [Bᴴ]], n + R rows by n columns, and row n + c (the conjugate
//    of column c of B) is eliminated by the same rule as a row of A, which
//    turns it into conj(y) with L·D·y' = b.
//  * The working matrix lives in REGISTERS. The threads of a block form a
//    TG × TG grid; thread (ri, cv) owns the elements (ri + TG·a, cv + TG·b)
//    of the lower trapezoid for b ≤ a, all indices known at compile time
//    (NB = ⌈n / TG⌉ column blocks, NB + 1 row blocks are template
//    arguments). A step reads column j from shared memory (NB + 1 values
//    by row, NB by column: broadcasts or conflict-free, the row stride is
//    odd), updates the owned elements with a complex multiply-subtract each
//    and no index arithmetic, and writes to shared memory only what became final:
//    column j + 1. Every element is written to shared memory once.
//  * The loop over columns is cut into NB phases so that the blocks left
//    of column j are dropped at compile time: no branch stands between the
//    loads of a step (a branch there serialised their latencies and cost
//    more than the arithmetic), and the work shrinks as j grows.
//  * The backward substitution needs no block barrier: the R columns are
//    independent, a warp takes a column (or several), a lane holds its
//    entries i ≡ lane (mod 32) in registers, x_j goes round by
//    __shfl_sync, and row j of L is read contiguously, one step ahead.
//  * TG = 16: 256 threads a system. An 8 × 8 grid has a longer chain but a
//    quarter of the threads, and measured faster only for more systems than
//    the card runs side by side (from between 384 and 512 at n = 16, 45 and
//    64; PERF.md has the times). No caller sends such a batch, so there is
//    one thread count.
//
// A pivot ≤ 0 or NaN makes that system's whole solution NaN, as the
// reference's Cholesky failure does; the other systems are not touched.
// No padding: the grid is B blocks. n ≤ 128 and R ≤ 8 keep the published
// matrix within 140 KB of dynamic shared memory and cover every mmse_full
// configuration including full rank (n = 126). They do not cover the blind
// prior fit (ce5g_tpu/estimators/blind.py): its ≈ 75 × 75 ridge system has
// R + 2·75 ≈ 154 right-hand sides and is a plain XLA solve outside any
// kernel in the JAX package; the slice that ports it decides between the
// plain solve there and a wider R here.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kMaxR = 8;
constexpr int kMaxSmem = (kMaxN + kMaxR) * (kMaxN | 1) * (int)sizeof(float2);
constexpr int kMaxDevices = 64;
constexpr int TG = 16;  // the threads of a block form a TG × TG grid

template <int NB>
__global__ void __launch_bounds__(TG * TG)
hpd_solve_kernel(const float2* __restrict__ A, const float2* __restrict__ B,
                 float2* __restrict__ X, int n, int r) {
  constexpr int NA = NB + 1;                  // row blocks: n + R ≤ TG·NB + 8 ≤ TG·NA
  constexpr int NW = TG * TG / 32;            // warps
  constexpr int NC = (kMaxR + NW - 1) / NW;   // right-hand sides a warp may hold
  constexpr int NE = (TG * NB + 31) / 32;     // entries of a column a lane holds
  // Published matrix, (n + r) rows of ld: row i < n holds L·D up to the
  // diagonal, row n + c the conjugate of column c of y'. Written a column
  // at a time as it becomes final.
  extern __shared__ float2 w[];
  __shared__ float dinv[kMaxN];
  __shared__ int bad;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ri = tid / TG, cv = tid % TG;
  const int ld = n | 1, rows = n + r;
  const size_t sys = blockIdx.x;
  const float2* a_g = A + sys * n * n;
  const float2* b_g = B + sys * n * r;
  const float2 zero = make_float2(0.0f, 0.0f);

  // The owned elements, straight from device memory; column 0 is final.
  float2 x[NA][NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int a = b; a < NA; ++a) {
      const int i = ri + TG * a, v = cv + TG * b;
      x[a][b] = zero;
      if (v <= i && v < n && i < rows) {
        if (i < n) {
          x[a][b] = a_g[i * n + v];
        } else {
          const float2 t = b_g[v * r + i - n];
          x[a][b] = make_float2(t.x, -t.y);
        }
      }
    }
  }
  if (tid == 0) bad = 0;
  if (cv == 0) {
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const int i = ri + TG * a;
      if (i < rows) w[i * ld] = x[a][0];
    }
  }
  // Offsets of the thread's rows and columns, clamped into the matrix: an
  // element outside it computes on a neighbour's values and is never
  // published.
  int fo[NA], go[NB];
#pragma unroll
  for (int a = 0; a < NA; ++a) fo[a] = min(ri + TG * a, rows - 1) * ld;
#pragma unroll
  for (int b = 0; b < NB; ++b) go[b] = min(cv + TG * b, n - 1) * ld;
  __syncthreads();

  // Elimination: x[i][v] -= W[i][j] · conj(W[v][j]) / d_j for j < v ≤ i.
#pragma unroll
  for (int ph = 0; ph < NB; ++ph) {
    const int jend = min(TG * (ph + 1), n);
    for (int j = TG * ph; j < jend; ++j) {
      const float d = w[j * ld + j].x;
      float2 f[NA], g[NB];
#pragma unroll
      for (int a = ph; a < NA; ++a) f[a] = w[fo[a] + j];
#pragma unroll
      for (int b = ph; b < NB; ++b) g[b] = w[go[b] + j];
      float inv;
      asm("rcp.approx.f32 %0, %1;" : "=f"(inv) : "f"(d));
      if (tid == 0) {
        dinv[j] = inv;
        if (!(d > 0.0f)) bad = 1;  // NaN too
      }
#pragma unroll
      for (int b = ph; b < NB; ++b) {
        g[b] = make_float2(g[b].x * inv, -g[b].y * inv);
#pragma unroll
        for (int a = b; a < NA; ++a) {
          // The product is rounded at its own magnitude and then subtracted:
          // two multiply-adds straight into the element round twice at the
          // element's magnitude, measured as 30% more error in the solution.
          x[a][b].x -= fmaf(-f[a].y, g[b].y, f[a].x * g[b].x);
          x[a][b].y -= fmaf(f[a].y, g[b].x, f[a].x * g[b].y);
        }
      }
      // Column p = j + 1 is final: its owners publish it. It lies in column
      // block ph, or is the first column of block ph + 1.
      const int p = j + 1;
      const int pc = p - TG * ph;
      if (p < n && cv == (pc & (TG - 1))) {
        if (pc < TG) {
#pragma unroll
          for (int a = ph; a < NA; ++a) {
            const int i = ri + TG * a;
            if (p <= i && i < rows) w[i * ld + p] = x[a][ph];
          }
        } else if (ph + 1 < NB) {
#pragma unroll
          for (int a = ph + 1; a < NA; ++a) {
            const int i = ri + TG * a;
            if (i < rows) w[i * ld + p] = x[a][min(ph + 1, NB - 1)];
          }
        }
      }
      __syncthreads();
    }
  }

  // Backward substitution Lᴴ·x = D⁻¹·y', by columns of Lᴴ = rows of L. A
  // lane holds u_i = (y'_i − Σ_{j>i} conj(W[j][i])·x_j) / d_i for its rows;
  // at step j it is x_j for the lane that owns row j.
  const int nq = warp < r ? (r - warp + NW - 1) / NW : 0;  // columns of this warp
  float2 u[NC][NE];
  float di[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int i = lane + 32 * e;
    di[e] = i < n ? dinv[i] : 0.0f;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int c = warp + q * NW;
      const float2 y = (i < n && c < r) ? w[(n + c) * ld + i] : zero;
      u[q][e] = make_float2(y.x * di[e], -y.y * di[e]);
    }
  }
  if (nq > 0) {
#pragma unroll
    for (int e = NE - 1; e >= 0; --e) {
      const int top = min(31, n - 1 - 32 * e);
      if (top < 0) continue;
      float2 l[NE], ln[NE];  // row j of L and, read a step ahead, row j − 1
#pragma unroll
      for (int e2 = 0; e2 <= e; ++e2) {
        const int i = lane + 32 * e2;
        l[e2] = i < 32 * e + top ? w[(32 * e + top) * ld + i] : zero;
      }
      for (int jj = top; jj >= 0; --jj) {
        const int j = 32 * e + jj;
#pragma unroll
        for (int e2 = 0; e2 <= e; ++e2) {
          const int i = lane + 32 * e2;
          ln[e2] = (jj > 0 && i < j - 1) ? w[(j - 1) * ld + i] : zero;
        }
        float2 xj[NC];
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          if (q < nq) {
            xj[q].x = __shfl_sync(0xffffffffu, u[q][e].x, jj);
            xj[q].y = __shfl_sync(0xffffffffu, u[q][e].y, jj);
          }
        }
#pragma unroll
        for (int e2 = 0; e2 <= e; ++e2) {
          const float2 ls = make_float2(l[e2].x * di[e2], l[e2].y * di[e2]);
#pragma unroll
          for (int q = 0; q < NC; ++q) {
            if (q < nq) {  // u_i −= conj(W[j][i]) / d_i · x_j; zero for i ≥ j
              u[q][e2].x -= ls.x * xj[q].x + ls.y * xj[q].y;
              u[q][e2].y -= ls.x * xj[q].y - ls.y * xj[q].x;
            }
          }
          l[e2] = ln[e2];
        }
      }
    }
  }

  float2* x_g = X + sys * n * r;
  const bool isbad = bad != 0;
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int i = lane + 32 * e;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int c = warp + q * NW;
      if (i < n && c < r) x_g[i * r + c] = isbad ? make_float2(nan, nan) : u[q][e];
    }
  }
}

template <int NB>
int launch_instance(const float2* A, const float2* B, float2* X, int batch, int n, int r,
                    cudaStream_t stream) {
  // The attribute is set once an instance and device, for the largest system.
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !ready[dev]) {
    err = cudaFuncSetAttribute(hpd_solve_kernel<NB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) ready[dev] = true;
  }
  const size_t smem = (size_t)(n + r) * (n | 1) * sizeof(float2);
  hpd_solve_kernel<NB><<<batch, TG * TG, smem, stream>>>(A, B, X, n, r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// A: (batch, n, n) complex64, B and X: (batch, n, r) complex64, all
// contiguous on the device. Returns cudaGetLastError() after the launch.
int hpd_solve_launch(const void* A, const void* B, void* X, int batch, int n, int r,
                     void* stream) {
  if (n < 1 || n > kMaxN || r < 1 || r > kMaxR) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const float2* a = (const float2*)A;
  const float2* b = (const float2*)B;
  float2* x = (float2*)X;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((n + TG - 1) / TG) {
    case 1: return launch_instance<1>(a, b, x, batch, n, r, s);
    case 2: return launch_instance<2>(a, b, x, batch, n, r, s);
    case 3: return launch_instance<3>(a, b, x, batch, n, r, s);
    case 4: return launch_instance<4>(a, b, x, batch, n, r, s);
    case 5: return launch_instance<5>(a, b, x, batch, n, r, s);
    case 6: return launch_instance<6>(a, b, x, batch, n, r, s);
    case 7: return launch_instance<7>(a, b, x, batch, n, r, s);
    default: return launch_instance<8>(a, b, x, batch, n, r, s);
  }
}

const char* ce5g_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
