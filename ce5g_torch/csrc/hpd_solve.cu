// Batched complex Hermitian-positive-definite solve, A_b · X_b = B_b.
//
// Replaces the TPU kernel ce5g_tpu/ops/hpd_solve_pallas.py::_kernel, which
// solves the mmse_full Woodbury system (n = paths × time rank = 45 at the
// default config, R = rx antennas ≤ 8 right-hand sides) with the batch on
// the TPU's 128 lanes.
//
// Design: one thread block per system. The block copies A into shared
// memory as interleaved complex float, runs a right-looking Cholesky in
// place (column j is scaled by 1/L[j][j], then the threads share the
// trailing lower-triangle update), then forward substitution L·y = b and
// backward substitution Lᴴ·x = y on the R columns held in shared memory.
// A non-positive (or NaN) pivot makes the whole solution NaN, as in the
// reference's Cholesky failure signalling. No padding: the grid is B
// blocks. n ≤ 128 keeps A within 128 KB of dynamic shared memory, which
// covers every mmse_full configuration including full rank (n = 126).
//
// Bound on the H100 at the bench shape (B = 256, n = 45, R = 4): memory
// is read A (256·45²·8 B ≈ 4.1 MB), read B and write X (≈ 0.37 MB each),
// a few µs at 3.35 TB/s; arithmetic is ≈ 50 MFLOP, under 1 µs at the
// float32 peak. Neither is what limits it: each system is a chain of
// ≈ 6n dependent steps (n Cholesky columns, n forward and n backward
// substitution steps, each with a barrier), so the kernel is bound by
// that latency. The design keeps every step in shared memory and runs
// all systems at once (one block each, several blocks per SM), so the
// chain is paid once per launch, not once per system.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 128;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a · conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__global__ void __launch_bounds__(kThreads)
hpd_solve_kernel(const float2* __restrict__ A, const float2* __restrict__ B,
                 float2* __restrict__ X, int n, int r) {
  extern __shared__ float2 smem[];
  float2* a = smem;          // n × n, row-major; L overwrites the lower triangle
  float2* x = smem + n * n;  // n × r right-hand sides → solution
  __shared__ float diag[kMaxN];
  __shared__ int bad;

  const int tid = threadIdx.x;
  const size_t sys = blockIdx.x;
  const float2* a_g = A + sys * n * n;
  const float2* b_g = B + sys * n * r;
  for (int i = tid; i < n * n; i += kThreads) a[i] = a_g[i];
  for (int i = tid; i < n * r; i += kThreads) x[i] = b_g[i];
  if (tid == 0) bad = 0;
  __syncthreads();

  // Cholesky, right-looking: A = L·Lᴴ, L in the lower triangle of a.
  for (int j = 0; j < n; ++j) {
    const float d = a[j * n + j].x;  // every thread reads the pivot
    const bool ok = d > 0.0f;         // false for NaN too
    const float ljj = ok ? sqrtf(d) : __int_as_float(0x7fc00000);
    if (tid == 0) {
      diag[j] = ljj;
      if (!ok) bad = 1;
    }
    for (int i = j + 1 + tid; i < n; i += kThreads) {
      float2 v = a[i * n + j];
      a[i * n + j] = make_float2(v.x / ljj, v.y / ljj);
    }
    __syncthreads();
    // trailing update of the lower triangle: a[i][k] -= L[i][j]·conj(L[k][j])
    const int m = n - 1 - j;
    for (int t = tid; t < m * m; t += kThreads) {
      const int i = j + 1 + t / m;
      const int k = j + 1 + t % m;
      if (k <= i) {
        const float2 p = cmul_conj(a[i * n + j], a[k * n + j]);
        float2 v = a[i * n + k];
        a[i * n + k] = make_float2(v.x - p.x, v.y - p.y);
      }
    }
    __syncthreads();
  }

  // Forward substitution L·y = b (y overwrites x).
  for (int j = 0; j < n; ++j) {
    for (int c = tid; c < r; c += kThreads) {
      float2 v = x[j * r + c];
      x[j * r + c] = make_float2(v.x / diag[j], v.y / diag[j]);
    }
    __syncthreads();
    const int m = n - 1 - j;
    for (int t = tid; t < m * r; t += kThreads) {
      const int i = j + 1 + t / r;
      const int c = t % r;
      const float2 p = cmul(a[i * n + j], x[j * r + c]);
      float2 v = x[i * r + c];
      x[i * r + c] = make_float2(v.x - p.x, v.y - p.y);
    }
    __syncthreads();
  }

  // Backward substitution Lᴴ·x = y: column j of Lᴴ above the diagonal is
  // conj(L[j][i]) for i < j.
  for (int j = n - 1; j >= 0; --j) {
    for (int c = tid; c < r; c += kThreads) {
      float2 v = x[j * r + c];
      x[j * r + c] = make_float2(v.x / diag[j], v.y / diag[j]);
    }
    __syncthreads();
    for (int t = tid; t < j * r; t += kThreads) {
      const int i = t / r;
      const int c = t % r;
      const float2 p = cmul_conj(x[j * r + c], a[j * n + i]);  // conj(L[j][i])·x[j]
      float2 v = x[i * r + c];
      x[i * r + c] = make_float2(v.x - p.x, v.y - p.y);
    }
    __syncthreads();
  }

  float2* x_g = X + sys * n * r;
  const float nan = __int_as_float(0x7fc00000);
  for (int i = tid; i < n * r; i += kThreads) x_g[i] = bad ? make_float2(nan, nan) : x[i];
}

}  // namespace

extern "C" {

// A: (batch, n, n) complex64, B and X: (batch, n, r) complex64, all
// contiguous on the device. Returns cudaGetLastError() after the launch.
int hpd_solve_launch(const void* A, const void* B, void* X, int batch, int n, int r,
                     void* stream) {
  if (n < 1 || n > kMaxN || r < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(n * n + n * r) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      hpd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return 0;
  hpd_solve_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)A, (const float2*)B, (float2*)X, n, r);
  return (int)cudaGetLastError();
}

const char* ce5g_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
