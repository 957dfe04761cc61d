// Batched complex Hermitian-positive-definite solve, A_b · X_b = B_b.
//
// Replaces the TPU kernel ce5g_tpu/ops/hpd_solve_pallas.py::_kernel, which
// solves the mmse_full Woodbury system (n = paths × time rank = 45 at the
// default config, R = rx antennas right-hand sides) with the batch on the
// TPU's 128 lanes.
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
// No padding: the grid is B blocks.
//
// Any number of right-hand sides. The first kMaxR = 8 ride the elimination
// as rows of the trapezoid; each further column is solved by one warp on
// its own against the factor that the elimination left in shared memory:
// a forward substitution L·y' = b by columns of L (x_j goes round by
// __shfl_sync, column j of W read conflict-free, the row stride being odd),
// then the same backward substitution. That loop is a second instance, for
// R > 8 only: carried in the instances for R ≤ 8 it made them 6–8% slower
// at the bench shape (PERF.md §6). The factor is computed once per
// system whatever R is, and shared memory holds the factor and at most
// kMaxR rows of y', (n + 8)·(n | 1)·8 B ≤ 140 KB at n = 128. n ≤ 128
// covers every mmse_full configuration of 14 symbols, full rank included
// (n = 126).
//
// Larger systems (n > 128: mmse_full over one LTE radio frame of 140
// symbols takes time rank 15 at 200 Hz, n = 135, and 19 at ETU 300 Hz,
// n = 171) take hpd_solve_cluster_kernel, the same elimination over C = 1,
// 2, 4 or 8 blocks of 256 threads a system (C = 1: one block, no cluster;
// C > 1: a thread block cluster). It is bound as above by the chain of n
// dependent steps, and a step costs the exchange of a column plus its
// arithmetic, ≈ n²/C multiply-subtracts over 256·C threads:
//  * The trapezoid, all of it, stays in registers. Row i of [[A], [Bᴴ]] is
//    owned by block i mod C; the threads form a 16 × 16 grid over the
//    cluster's rows (i ≡ q + C·ri mod 16·C) and the columns (v ≡ cv mod
//    16), so that every block's share of a step shrinks alike as j grows.
//    NA row blocks and NB column blocks are template arguments; element
//    (a, b) is held when b < C·(a + 1), the band over the diagonal being
//    computed and never published. A thread holds at most 56 elements.
//  * No published matrix: column j lives in a column buffer of shared
//    memory, one copy in each block; every block derives the pivots, and
//    so the NaN flag, from its own copy. One block: two buffers, the
//    owners of column j + 1 write it after step j, one block barrier.
//  * A cluster exchanges its columns without a cluster barrier, which
//    costs ≈ 1.2 µs a column (PERF.md). Each block has three buffers, each
//    with an mbarrier. At step j the owners of column j + 1 compute it
//    first, store their rows into their own block's buffer (and arrive on
//    its barrier) and into the other blocks' with st.async, whose bytes
//    each receiving barrier counts; one thread of each block expects the
//    bytes of the rows that the other blocks own. The step's arithmetic
//    then hides the exchange; step j + 1 starts when the block's barrier
//    says the column is there, and a block barrier keeps the block's
//    threads within a step of each other. Three buffers suffice: a block
//    writes column j + 1 only once every block has published column j,
//    so all have read column j − 2. One block still beats a cluster of 2
//    by 1.3× at n = 135, so plan() takes one block wherever it holds the
//    system.
//  * Each element of L·D, when final, is also stored once into the block
//    that holds its row for the backward substitution: block q holds rows
//    [lo_q, lo_{q+1}) packed, lo_q the least m with m²·C ≥ q·n², about
//    n² / (2C) entries a block. The last block keeps y'/d.
//  * The backward substitution runs block after block, from the last rows
//    up, a warp a right-hand side as above, reading its rows from its own
//    shared memory; X carries the partial sums to the next block, with one
//    cluster barrier between blocks.
//  * At most 8 right-hand sides ride the elimination; more are chunks of 8,
//    each a cluster of its own (the factor is recomputed in each, side by
//    side on other SMs).
// The registers bound the sizes: the instances listed below take n + R ≤
// 384 (8 blocks of 256 threads, 48 elements a thread). A larger system
// takes hpd_solve_blocked_kernel, which keeps the factor in a device
// workspace, one block a system:
//  * a blocked right-looking LDLᴴ: a panel of 32 columns is eliminated a
//    column at a time (one barrier a column, every row of the panel's
//    columns updated), then the trailing lower triangle takes the panel's
//    rank-32 update in 32 × 32 tiles staged in shared memory, so that an
//    element is read and written once a panel, not once a column;
//  * a pass turns W = L·D into the unit L (lower) and its conjugate
//    transpose (upper), so that both substitutions read rows, not columns;
//    the diagonal keeps (d, 1/d);
//  * a warp per right-hand side then runs the forward and the backward
//    substitution through a (R, n) workspace, one warp barrier a step.
// The pivots' rule and the NaN contract are the same in all three.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kMaxR = 8;  // right-hand sides that ride the elimination
constexpr int kMaxSmem = (kMaxN + kMaxR) * (kMaxN | 1) * (int)sizeof(float2);
constexpr int kMaxDevices = 64;
constexpr int TG = 16;  // the threads of a block form a TG × TG grid
constexpr int NW = TG * TG / 32;  // warps: one right-hand side each at a time
constexpr int kPanel = 32;  // n > kMaxN: columns of a panel, the side of an update tile
static_assert(NW == kMaxR, "a warp takes one of the right-hand sides that ride the elimination");

// Forward substitution L·y' = b of one column held by a warp (entry i in
// lane i mod 32, slot i / 32), with L[i][j] = W[i][j] / d_j for i > j.
template <int NE>
__device__ __forceinline__ void forward_substitute(float2 (&u)[NE], const float2* w,
                                                   const float* dinv, int ld, int n, int lane) {
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int top = min(31, n - 1 - 32 * e);
    if (top < 0) continue;
    for (int jj = 0; jj <= top; ++jj) {
      const int j = 32 * e + jj;
      const float dj = dinv[j];
      const float2 t = make_float2(__shfl_sync(0xffffffffu, u[e].x, jj) * dj,
                                   __shfl_sync(0xffffffffu, u[e].y, jj) * dj);
#pragma unroll
      for (int e2 = e; e2 < NE; ++e2) {
        const int i = lane + 32 * e2;
        if (i > j && i < n) {  // y_i −= W[i][j] / d_j · y_j, rounded as the elimination rounds
          const float2 l = w[i * ld + j];
          u[e2].x -= fmaf(-l.y, t.y, l.x * t.x);
          u[e2].y -= fmaf(l.y, t.x, l.x * t.y);
        }
      }
    }
  }
}

// Backward substitution Lᴴ·x = D⁻¹·y', by columns of Lᴴ = rows of L, of one
// column held by a warp as above: on entry u_i = y'_i / d_i; at step j it is
// x_j for the lane that owns row j.
template <int NE>
__device__ __forceinline__ void back_substitute(float2 (&u)[NE], const float (&di)[NE],
                                                const float2* w, int ld, int n, int lane) {
  const float2 zero = make_float2(0.0f, 0.0f);
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
      float2 xj;
      xj.x = __shfl_sync(0xffffffffu, u[e].x, jj);
      xj.y = __shfl_sync(0xffffffffu, u[e].y, jj);
#pragma unroll
      for (int e2 = 0; e2 <= e; ++e2) {
        const float2 ls = make_float2(l[e2].x * di[e2], l[e2].y * di[e2]);
        // u_i −= conj(W[j][i]) / d_i · x_j; zero for i ≥ j
        u[e2].x -= ls.x * xj.x + ls.y * xj.y;
        u[e2].y -= ls.x * xj.y - ls.y * xj.x;
        l[e2] = ln[e2];
      }
    }
  }
}

// WIDE: R > kMaxR, the further right-hand sides solved by warps after the
// elimination (a separate instance, so that the R ≤ kMaxR ones carry none of it)
template <int NB, bool WIDE>
__global__ void __launch_bounds__(TG * TG)
hpd_solve_kernel(const float2* __restrict__ A, const float2* __restrict__ B,
                 float2* __restrict__ X, int n, int r) {
  constexpr int NA = NB + 1;                  // row blocks: n + 8 ≤ TG·NB + 8 ≤ TG·NA
  constexpr int NE = (TG * NB + 31) / 32;     // entries of a column a lane holds
  // Published matrix, (n + r0) rows of ld: row i < n holds L·D up to the
  // diagonal, row n + c the conjugate of column c of y' for the first r0
  // right-hand sides. Written a column at a time as it becomes final.
  extern __shared__ float2 w[];
  __shared__ float dinv[kMaxN];
  __shared__ int bad;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ri = tid / TG, cv = tid % TG;
  const int r0 = WIDE ? kMaxR : r;  // right-hand sides that ride the elimination
  const int ld = n | 1, rows = n + r0;
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

  // Warp c finishes right-hand side c < r0 from its row of y' (the
  // backward substitution needs no block barrier); with WIDE it then takes
  // the columns c + NW, c + 2·NW, … from device memory.
  float di[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int i = lane + 32 * e;
    di[e] = i < n ? dinv[i] : 0.0f;
  }
  float2* x_g = X + sys * n * r;
  const bool isbad = bad != 0;
  const float nan = __int_as_float(0x7fc00000);
  auto write = [&](const float2 (&u)[NE], int c) {
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int i = lane + 32 * e;
      if (i < n) x_g[i * r + c] = isbad ? make_float2(nan, nan) : u[e];
    }
  };
  if (warp < r0) {
    float2 u[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int i = lane + 32 * e;
      const float2 y = i < n ? w[(n + warp) * ld + i] : zero;
      u[e] = make_float2(y.x * di[e], -y.y * di[e]);
    }
    back_substitute(u, di, w, ld, n, lane);
    write(u, warp);
  }
  if (WIDE) {
    for (int c = kMaxR + warp; c < r; c += NW) {
      float2 u[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int i = lane + 32 * e;
        u[e] = i < n ? b_g[i * r + c] : zero;
      }
      forward_substitute(u, w, dinv, ld, n, lane);
#pragma unroll
      for (int e = 0; e < NE; ++e) u[e] = make_float2(u[e].x * di[e], u[e].y * di[e]);
      back_substitute(u, di, w, ld, n, lane);
      write(u, c);
    }
  }
}

// hpd_solve_cluster_kernel: rows lo … hi − 1 of W are packed in a block's
// `ls`, row i (its i entries left of the diagonal) at i(i − 1)/2 − lo(lo − 1)/2.
__device__ __forceinline__ int row_offset(int i, int lo) {
  return i * (i - 1) / 2 - lo * (lo - 1) / 2;
}

// The first row that block q of c holds for the backward substitution:
// the least m with m²·c ≥ q·n² (q = c gives n).
__host__ __device__ inline int first_row(int n, int q, int c) {
  const long long want = (long long)q * n * n;
  int m = (int)sqrt((double)want / c);
  while (m > 0 && (long long)(m - 1) * (m - 1) * c >= want) --m;
  while ((long long)m * m * c < want) ++m;
  return m;
}

// Backward substitution over rows hi − 1 … lo, by columns of Lᴴ = rows of
// L read from `ls`, of one column held by a warp (entry i in lane i mod 32,
// slot i / 32). On entry u_i is y'_i / d_i less the updates of the rows at
// and past hi; on exit it is x_i for lo ≤ i < hi, and the entries below lo
// carry the updates of rows lo … hi − 1.
template <int NE>
__device__ __forceinline__ void back_substitute_rows(float2 (&u)[NE], const float (&di)[NE],
                                                     const float2* ls, int lo, int hi,
                                                     int lane) {
  const float2 zero = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int e = NE - 1; e >= 0; --e) {
    const int top = min(32 * e + 31, hi - 1), bot = max(32 * e, lo);
    if (top < bot) continue;
    float2 l[NE], ln[NE];  // row j of L·D and, read a step ahead, row j − 1
    const float2* row = ls + row_offset(top, lo);
#pragma unroll
    for (int e2 = 0; e2 <= e; ++e2) {
      const int i = lane + 32 * e2;
      l[e2] = i < top ? row[i] : zero;
    }
    for (int j = top; j >= bot; --j) {
      row = ls + row_offset(j - 1, lo);
#pragma unroll
      for (int e2 = 0; e2 <= e; ++e2) {
        const int i = lane + 32 * e2;
        ln[e2] = (j > bot && i < j - 1) ? row[i] : zero;
      }
      float2 xj;
      xj.x = __shfl_sync(0xffffffffu, u[e].x, j - 32 * e);
      xj.y = __shfl_sync(0xffffffffu, u[e].y, j - 32 * e);
#pragma unroll
      for (int e2 = 0; e2 <= e; ++e2) {
        const float2 ls2 = make_float2(l[e2].x * di[e2], l[e2].y * di[e2]);
        // u_i −= conj(W[j][i]) / d_i · x_j; zero for i ≥ j
        u[e2].x -= ls2.x * xj.x + ls2.y * xj.y;
        u[e2].y -= ls2.x * xj.y - ls2.y * xj.x;
        l[e2] = ln[e2];
      }
    }
  }
}

// A cluster's column exchange: each block waits on an mbarrier of its own
// for the column's rows that the other blocks store into its shared memory
// with st.async (their bytes counted by the barrier's transaction count)
// and for the arrivals of its own 16 owners of the column.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned cluster_addr(unsigned local, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(unsigned bar, int parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, P1;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  // A column that never arrives is a fault: fail the launch, do not hang the card.
  for (long long spin = 0; !mbar_try_wait(bar, parity); ++spin) {
    if (spin > (1ll << 28)) __trap();
  }
}
__device__ __forceinline__ void st_async(unsigned remote, float2 v, unsigned remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
               ::"r"(remote), "f"(v.x), "f"(v.y), "r"(remote_bar) : "memory");
}

// n > kMaxN: C blocks a system (blockIdx.x / C), each chunk of kMaxR
// right-hand sides (blockIdx.y) its own cluster; see the note at the top.
template <int C, int NA, int NB>
__global__ void __launch_bounds__(TG * TG, 1)
hpd_solve_cluster_kernel(const float2* __restrict__ A, const float2* __restrict__ B,
                         float2* __restrict__ X, int n, int r) {
  constexpr int ROWS = TG * C * NA;        // row slots of the cluster: n + rc ≤ ROWS
  constexpr int NE = (TG * NB + 31) / 32;  // entries of a column a lane holds
  constexpr int NBUF = C == 1 ? 2 : 3;     // column j in col[j % NBUF], rows j … n + rc − 1
  extern __shared__ float2 ls[];           // W's rows [lo, hi), packed
  __shared__ float2 col[NBUF][ROWS];
  __shared__ __align__(8) unsigned long long full[NBUF];  // C > 1: column j has arrived
  __shared__ float2 yd[kMaxR][TG * NB];    // the last block's y'_j / d_j
  __shared__ float dinv[TG * NB];
  __shared__ int first[C + 1];             // block q's rows are first[q] … first[q + 1] − 1
  __shared__ int bad;

  namespace cg = cooperative_groups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ri = tid / TG, cv = tid % TG;
  const int q = C == 1 ? 0 : (int)cg::this_cluster().block_rank();
  const int rho = q + C * ri;              // rows rho + TG·C·a
  const size_t sys = blockIdx.x / C;
  const int c0 = kMaxR * blockIdx.y, rc = min(kMaxR, r - c0);
  const int rows = n + rc;
  const float2* a_g = A + sys * n * n;
  const float2* b_g = B + sys * n * r;
  float2* x_g = X + sys * n * r;
  const float2 zero = make_float2(0.0f, 0.0f);

  auto sync = [] {
    if constexpr (C == 1) {
      __syncthreads();
    } else {
      cg::this_cluster().sync();
    }
  };

  if (tid <= C) first[tid] = first_row(n, tid, C);
  if (tid == 0) bad = 0;
  if constexpr (C > 1) {
    if (tid < NBUF) {
      mbar_init(smem_addr(&full[tid]), 1 + TG);  // the expect, the 16 owners
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  // The owned elements, straight from device memory; column 0 is final.
  float2 x[NA][NB];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b >= C * (a + 1)) continue;
      const int i = rho + TG * C * a, v = cv + TG * b;
      x[a][b] = zero;
      if (v <= i && v < n && i < rows) {
        if (i < n) {
          x[a][b] = a_g[(size_t)i * n + v];
        } else {
          const float2 t = b_g[(size_t)v * r + c0 + i - n];
          x[a][b] = make_float2(t.x, -t.y);
        }
      }
    }
  }
  // Every block of the cluster has started (its shared memory may be
  // written) and first[] is set.
  sync();
  // Where each owned row of L·D goes: (block << 24) | its offset there.
  int dest[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int i = rho + TG * C * a;
    int k = 0;
#pragma unroll
    for (int t = 1; t < C; ++t) k += i >= first[t];
    dest[a] = i < n ? (k << 24) | row_offset(i, first[k]) : -1;
  }
  // Element (i, p), final, into every block's column buffer (the other
  // blocks' by st.async, counted by their barrier) and, below the diagonal,
  // into the block that holds row i.
  auto publish = [&](float2 val, int i, int p, int dst) {
    float2* slot = &col[p % NBUF][i];
    *slot = val;
    if constexpr (C == 1) {
      if (p < i && dst >= 0) ls[dst + p] = val;
    } else {
      const unsigned local = smem_addr(slot), bar = smem_addr(&full[p % NBUF]);
#pragma unroll
      for (int t = 1; t < C; ++t) {
        const int rank = (q + t) & (C - 1);
        st_async(cluster_addr(local, rank), val, cluster_addr(bar, rank));
      }
      if (p < i && dst >= 0) {
        *cg::this_cluster().map_shared_rank(ls + (dst & 0xffffff) + p, dst >> 24) = val;
      }
    }
  };
  // The bytes of column p that the other blocks send this one: its rows
  // p … rows − 1 that are not i ≡ q (mod C).
  auto expect = [&](int p) {
    auto own = [&](int m) { return m > q ? (m - q + C - 1) / C : 0; };
    mbar_arrive_expect(smem_addr(&full[p % NBUF]),
                       (int)sizeof(float2) * (rows - p - (own(rows) - own(p))));
  };
  if constexpr (C > 1) {
    if (tid == 0) expect(0);
  }
  if (cv == 0) {
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const int i = rho + TG * C * a;
      if (i < rows) publish(x[a][0], i, 0, dest[a]);
    }
    if constexpr (C > 1) mbar_arrive(smem_addr(&full[0]));
  }
  if constexpr (C == 1) sync();

  // Elimination: x[i][v] -= W[i][j] · conj(W[v][j]) / d_j for j < v ≤ i.
#pragma unroll
  for (int ph = 0; ph < NB; ++ph) {
    const int jend = min(TG * (ph + 1), n);
    for (int j = TG * ph; j < jend; ++j) {
      if constexpr (C > 1) {
        // The block's threads stay within a step of each other, so that
        // col[(j + 1) % 3], written this step, was read two steps ago by all.
        mbar_wait(smem_addr(&full[j % NBUF]), (j / NBUF) & 1);
        __syncthreads();
      }
      const float2* cj = col[j % NBUF];
      const float d = cj[j].x;
      float2 f[NA], g[NB];
#pragma unroll
      for (int a = ph / C; a < NA; ++a) f[a] = cj[rho + TG * C * a];
#pragma unroll
      for (int b = ph; b < NB; ++b) g[b] = cj[cv + TG * b];
      float inv;
      asm("rcp.approx.f32 %0, %1;" : "=f"(inv) : "f"(d));
      if (tid == 0) {
        dinv[j] = inv;
        if (!(d > 0.0f)) bad = 1;  // NaN too
      }
      // y'_j / d_j of each right-hand side, where the backward substitution starts
      if (q == C - 1 && tid < rc) {
        const float2 y = cj[n + tid];
        yd[tid][j] = make_float2(y.x * inv, -y.y * inv);
      }
#pragma unroll
      for (int b = ph; b < NB; ++b) g[b] = make_float2(g[b].x * inv, -g[b].y * inv);
      // Column p = j + 1 is final after this step: its owners publish it.
      // It lies in column block ph, or is the first column of block ph + 1.
      // A cluster publishes it ahead of the step's arithmetic, computing the
      // owned elements of column p first (the step updates them again, to
      // the same values), so that the arithmetic hides the exchange; one
      // block publishes after it.
      const int p = j + 1;
      const int pc = p - TG * ph;
      if constexpr (C > 1) {
        if (tid == 0 && p < n) expect(p);
      }
      auto publish_column = [&] {
        if (p >= n || cv != (pc & (TG - 1))) return;
        auto put = [&](int i, int dst, float2 t, float2 fa, float2 gb) {
          if (p > i || i >= rows) return;
          if constexpr (C > 1) {
            t.x -= fmaf(-fa.y, gb.y, fa.x * gb.x);
            t.y -= fmaf(fa.y, gb.x, fa.x * gb.y);
          }
          publish(t, i, p, dst);
        };
        if (pc < TG) {
#pragma unroll
          for (int a = ph / C; a < NA; ++a) put(rho + TG * C * a, dest[a], x[a][ph], f[a], g[ph]);
        } else if (ph + 1 < NB) {
          const int b1 = min(ph + 1, NB - 1);
#pragma unroll
          for (int a = (ph + 1) / C; a < NA; ++a) {
            put(rho + TG * C * a, dest[a], x[a][b1], f[a], g[b1]);
          }
        }
        if constexpr (C > 1) mbar_arrive(smem_addr(&full[p % NBUF]));
      };
      if constexpr (C > 1) publish_column();
#pragma unroll
      for (int b = ph; b < NB; ++b) {
#pragma unroll
        for (int a = b / C; a < NA; ++a) {
          // rounded as the register kernel rounds: the product, then the difference
          x[a][b].x -= fmaf(-f[a].y, g[b].y, f[a].x * g[b].x);
          x[a][b].y -= fmaf(f[a].y, g[b].x, f[a].x * g[b].y);
        }
      }
      if constexpr (C == 1) {
        publish_column();
        sync();
      }
    }
  }
  // The rows of L·D stored into other blocks, before the backward substitution
  if constexpr (C > 1) sync();

  // Warp c of each block takes right-hand side c0 + c, the blocks in turn
  // from the last rows up; X carries the partial sums between them.
  float di[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int i = lane + 32 * e;
    di[e] = i < n ? dinv[i] : 0.0f;
  }
  const bool isbad = bad != 0;
  const float nan = __int_as_float(0x7fc00000);
  const int lo = first[q], hi = first[q + 1];
#pragma unroll
  for (int k = C - 1; k >= 0; --k) {
    if (k == q && warp < rc) {
      float2* xc = x_g + c0 + warp;
      float2 u[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int i = lane + 32 * e;
        u[e] = i >= hi ? zero : k == C - 1 ? yd[warp][i] : xc[(size_t)i * r];
      }
      back_substitute_rows(u, di, ls, lo, hi, lane);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int i = lane + 32 * e;
        if (i < hi) xc[(size_t)i * r] = (isbad && i >= lo) ? make_float2(nan, nan) : u[e];
      }
    }
    if constexpr (C > 1) {
      if (k > 0) {
        __threadfence();  // the partial sums in X
        sync();
      }
    }
  }
}

// Past every instance of hpd_solve_cluster_kernel: the factor in the device workspace `work` (batch, n, n), the
// right-hand sides in `zwork` (batch, r, n); see the note at the top.
__global__ void __launch_bounds__(TG * TG)
hpd_solve_blocked_kernel(const float2* __restrict__ A, const float2* __restrict__ B,
                         float2* __restrict__ X, float2* work, float2* zwork, int n, int r) {
  constexpr int kNT = TG * TG;
  __shared__ float2 p_s[kPanel][kPanel + 1];  // a tile's rows of the panel
  __shared__ float2 g_s[kPanel][kPanel + 1];  // its columns' rows, conjugated, over d
  __shared__ int bad;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t sys = blockIdx.x, nn = (size_t)n * n;
  const float2* a_g = A + sys * nn;
  float2* w = work + sys * nn;
  const float2 zero = make_float2(0.0f, 0.0f);

  for (size_t e = tid; e < nn; e += kNT) w[e] = a_g[e];
  if (tid == 0) bad = 0;
  __syncthreads();

  for (int c0 = 0; c0 < n; c0 += kPanel) {
    const int c1 = min(c0 + kPanel, n), np = c1 - c0;
    // the panel: W[i][v] −= W[i][j] · conj(W[v][j]) / d_j for j < v < c1, v ≤ i
    for (int j = c0; j < c1; ++j) {
      const float d = w[(size_t)j * n + j].x;
      const float inv = 1.0f / d;
      const int wc = c1 - j - 1;
      const int total = (n - j - 1) * wc;
      for (int e = tid; e < total; e += kNT) {
        const int i = j + 1 + e / wc, v = j + 1 + e % wc;
        if (v <= i) {
          const float2 f = w[(size_t)i * n + j], g = w[(size_t)v * n + j];
          const float2 gi = make_float2(g.x * inv, -g.y * inv);
          float2 x = w[(size_t)i * n + v];
          // rounded as the register kernel rounds: the product, then the difference
          x.x -= fmaf(-f.y, gi.y, f.x * gi.x);
          x.y -= fmaf(f.y, gi.x, f.x * gi.y);
          w[(size_t)i * n + v] = x;
        }
      }
      if (tid == 0) {
        w[(size_t)j * n + j].y = inv;
        if (!(d > 0.0f)) bad = 1;  // NaN too
      }
      __syncthreads();
    }
    // the trailing triangle, c1 ≤ v ≤ i, a 32 × 32 tile (ti, tv ≤ ti) at a time
    const int nt = (n - c1 + kPanel - 1) / kPanel;
    for (int ti = 0; ti < nt; ++ti) {
      for (int tv = 0; tv <= ti; ++tv) {
        const int i0 = c1 + kPanel * ti, v0 = c1 + kPanel * tv;
        for (int e = tid; e < kPanel * kPanel; e += kNT) {
          const int q = e / kPanel, k = e % kPanel;
          float2 pv = zero, gv = zero;
          if (k < np) {
            if (i0 + q < n) pv = w[(size_t)(i0 + q) * n + c0 + k];
            if (v0 + q < n) {
              const float2 g = w[(size_t)(v0 + q) * n + c0 + k];
              const float inv = w[(size_t)(c0 + k) * n + c0 + k].y;
              gv = make_float2(g.x * inv, -g.y * inv);
            }
          }
          p_s[q][k] = pv;
          g_s[q][k] = gv;
        }
        __syncthreads();
        const int tx = tid % kPanel, v = v0 + tx;
        for (int q = tid / kPanel; q < kPanel; q += kNT / kPanel) {
          const int i = i0 + q;
          if (i < n && v <= i) {
            float2 acc = zero;
            for (int k = 0; k < np; ++k) {
              const float2 f = p_s[q][k], g = g_s[tx][k];
              acc.x = fmaf(f.x, g.x, fmaf(-f.y, g.y, acc.x));
              acc.y = fmaf(f.x, g.y, fmaf(f.y, g.x, acc.y));
            }
            float2 x = w[(size_t)i * n + v];
            x.x -= acc.x;
            x.y -= acc.y;
            w[(size_t)i * n + v] = x;
          }
        }
        __syncthreads();
      }
    }
  }

  // L = W / D below the diagonal, its conjugate transpose above
  for (size_t e = tid; e < nn; e += kNT) {
    const int i = (int)(e / n), j = (int)(e % n);
    if (j < i) {
      const float2 x = w[e];
      const float inv = w[(size_t)j * n + j].y;
      w[e] = make_float2(x.x * inv, x.y * inv);
      w[(size_t)j * n + i] = make_float2(x.x * inv, -x.y * inv);
    }
  }
  __syncthreads();

  // a warp a right-hand side: L·z = b, z /= D, Lᴴ·x = z
  const float2* b_g = B + sys * n * r;
  float2* x_g = X + sys * n * r;
  const bool isbad = bad != 0;
  const float nan = __int_as_float(0x7fc00000);
  for (int c = warp; c < r; c += NW) {
    float2* z = zwork + (sys * r + c) * n;
    for (int i = lane; i < n; i += 32) z[i] = b_g[(size_t)i * r + c];
    __syncwarp();
    for (int j = 0; j < n; ++j) {  // z_i −= L[i][j] z_j, row j of the upper copy
      const float2 zj = z[j];
      const float2* u = w + (size_t)j * n;
      for (int i = j + 1 + lane; i < n; i += 32) {
        const float2 l = u[i];  // conj(L[i][j])
        float2 t = z[i];
        t.x -= fmaf(l.y, zj.y, l.x * zj.x);
        t.y -= fmaf(-l.y, zj.x, l.x * zj.y);
        z[i] = t;
      }
      __syncwarp();
    }
    for (int i = lane; i < n; i += 32) {
      const float inv = w[(size_t)i * n + i].y;
      z[i] = make_float2(z[i].x * inv, z[i].y * inv);
    }
    __syncwarp();
    for (int j = n - 1; j > 0; --j) {  // z_i −= conj(L[j][i]) x_j, row j of L
      const float2 xj = z[j];
      const float2* l_row = w + (size_t)j * n;
      for (int i = lane; i < j; i += 32) {
        const float2 l = l_row[i];
        float2 t = z[i];
        t.x -= fmaf(l.y, xj.y, l.x * xj.x);
        t.y -= fmaf(-l.y, xj.x, l.x * xj.y);
        z[i] = t;
      }
      __syncwarp();
    }
    for (int i = lane; i < n; i += 32) {
      x_g[(size_t)i * r + c] = isbad ? make_float2(nan, nan) : z[i];
    }
  }
}

template <int NB, bool WIDE>
int launch_instance(const float2* A, const float2* B, float2* X, int batch, int n, int r,
                    cudaStream_t stream) {
  // The attribute is set once an instance and device, for the largest system.
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !ready[dev]) {
    err = cudaFuncSetAttribute(hpd_solve_kernel<NB, WIDE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) ready[dev] = true;
  }
  const size_t smem = (size_t)(n + min(r, kMaxR)) * (n | 1) * sizeof(float2);
  hpd_solve_kernel<NB, WIDE><<<batch, TG * TG, smem, stream>>>(A, B, X, n, r);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_r(const float2* A, const float2* B, float2* X, int batch, int n, int r,
             cudaStream_t stream) {
  return r > kMaxR ? launch_instance<NB, true>(A, B, X, batch, n, r, stream)
                   : launch_instance<NB, false>(A, B, X, batch, n, r, stream);
}

// The instances of hpd_solve_cluster_kernel as X(C, NA, NB). An instance
// takes any n ≤ 16·NB with n + min(R, 8) ≤ 16·C·NA; plan() in
// ops/hpd_solve.py picks the least C, then the least instance that takes
// (n, R). Columns past n cost their arithmetic and no steps, so a cluster,
// bound by its exchange, loses little to a wide instance; one block, the
// fastest where it holds the system, keeps two close fits. (2, 7, 14) and
// (8, 3, 24) spill a few hundred bytes of registers.
#define HPD_CLUSTER_INSTANCES(X) \
  X(1, 9, 9) X(1, 10, 10) X(2, 6, 11) X(2, 7, 14) X(4, 4, 16) X(8, 3, 20) X(8, 3, 24)

template <int C, int NA, int NB>
int launch_cluster(const float2* A, const float2* B, float2* X, int batch, int n, int r,
                   cudaStream_t stream) {
  auto kernel = hpd_solve_cluster_kernel<C, NA, NB>;
  // The block's packed rows of W: the largest share of the cluster.
  size_t smem = 0;
  for (int q = 0; q < C; ++q) {
    const size_t lo = first_row(n, q, C), hi = first_row(n, q + 1, C);
    const size_t share = (hi * (hi - 1) - lo * (lo - 1)) / 2 * sizeof(float2);
    smem = share > smem ? share : smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * C, (r + kMaxR - 1) / kMaxR, 1);
  cfg.blockDim = dim3(TG * TG, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  // Once an instance and device: allow the largest share shared memory
  // holds and check that a cluster of C such blocks can be resident.
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !ready[dev]) {
    int optin = 0;
    cudaFuncAttributes fa;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)fa.sharedSizeBytes);
    if (err != cudaSuccess) return (int)err;
    if (C > 1) {
      cudaLaunchConfig_t most = cfg;
      most.dynamicSmemBytes = optin - fa.sharedSizeBytes;
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &most);
      if (err != cudaSuccess) return (int)err;
      if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    }
    if (dev < kMaxDevices) ready[dev] = true;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, A, B, X, n, r);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_cluster_for(const float2* A, const float2* B, float2* X, int batch, int n, int r,
                       int c, int na, int nb, cudaStream_t stream) {
  if (n <= kMaxN || n > TG * nb || n + min(r, kMaxR) > TG * c * na) return (int)cudaErrorInvalidValue;
#define HPD_CLUSTER_CASE(C_, NA_, NB_) \
  if (c == C_ && na == NA_ && nb == NB_) return launch_cluster<C_, NA_, NB_>(A, B, X, batch, n, r, stream);
  HPD_CLUSTER_INSTANCES(HPD_CLUSTER_CASE)
#undef HPD_CLUSTER_CASE
  return (int)cudaErrorInvalidValue;  // no such instance
}

}  // namespace

extern "C" {

// A: (batch, n, n) complex64, B and X: (batch, n, r) complex64, all
// contiguous on the device; n ≥ 1, r ≥ 1. blocks = 0: n ≤ 128 takes the
// register kernel, n > 128 the blocked kernel with work (batch, n, n) and
// zwork (batch, r, n) complex64 device scratch (else unused, may be null);
// blocks = C ∈ {1, 2, 4, 8}: the cluster kernel's instance (C, na, nb), C
// blocks a system. Returns the launch's CUDA error code.
int hpd_solve_launch(const void* A, const void* B, void* X, void* work, void* zwork, int batch,
                     int n, int r, int blocks, int na, int nb, void* stream) {
  if (n < 1 || r < 1) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const float2* a = (const float2*)A;
  const float2* b = (const float2*)B;
  float2* x = (float2*)X;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) return launch_cluster_for(a, b, x, batch, n, r, blocks, na, nb, s);
  if (n > kMaxN) {
    if (work == nullptr || zwork == nullptr) return (int)cudaErrorInvalidValue;
    hpd_solve_blocked_kernel<<<batch, TG * TG, 0, s>>>(a, b, x, (float2*)work, (float2*)zwork, n,
                                                      r);
    return (int)cudaGetLastError();
  }
  switch ((n + TG - 1) / TG) {
    case 1: return launch_r<1>(a, b, x, batch, n, r, s);
    case 2: return launch_r<2>(a, b, x, batch, n, r, s);
    case 3: return launch_r<3>(a, b, x, batch, n, r, s);
    case 4: return launch_r<4>(a, b, x, batch, n, r, s);
    case 5: return launch_r<5>(a, b, x, batch, n, r, s);
    case 6: return launch_r<6>(a, b, x, batch, n, r, s);
    case 7: return launch_r<7>(a, b, x, batch, n, r, s);
    default: return launch_r<8>(a, b, x, batch, n, r, s);
  }
}

const char* ce5g_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
