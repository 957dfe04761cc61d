// The pilot sums of the Wiener MMSE (estimators/mmse.py, mmse_full_estimate
// with the profile tables) straight from the received grid, each frame
// against its own profile c_b:
//
//   g[b,r,s,k] = m[b,s,k] · rx[b,s,r,k] / (tx[b,s,k] + 1e-12)     complex64
//   E[b,r,s,p] = Σ_k g · conj F[c_b,p,k]                           float64 sums
//   D[b,s,p,q] = Σ_k m · conj F[c_b,p,k] · F[c_b,q,k]              float64 sums, Hermitian
//
// Replaces no TPU kernel. The JAX package's masked-grid sums
// (ce5g_tpu/estimators/mmse.py:324-376) are jnp expressions that XLA fuses.
// PyTorch ran them eagerly as estimators/ls.py's masked LS grid (a transposed
// copy, the division, the mask product: three dense passes over (B, R, S, K)),
// its widening to complex128, a float64 [Re | Im] copy, float64 products
// against the E and D tables of every profile and a per-frame select: at 64
// frames of 14 × 3275 on 64 antennas ≈ 9.5 ms a batch for ≈ 0.45 ms of
// necessary traffic.
//
// Bound on the H100: bytes. The received grid read once (8·B·R·S·K), the
// mask once (4·B·S·K), E and D written once in complex128: 1.52 GB, 0.45 ms
// at 3.35 TB/s at the shape above. About 10% of the grid are pilots, so the
// float64 sums (8·R·P a pilot for E, 4·P(P + 1) for D) are a small share of
// the float64 peak.
//
// Design.
//   * A task is a (frame, symbol) row and a share of its R antennas (the plan
//     of ops/profile_gram.py: `groups` tasks a row of `rows` antennas). The
//     grid holds as many blocks as the card keeps resident, and a block takes
//     every gridDim-th task. A task's antennas are one contiguous run of the
//     (B, S, R, K) grid: the block copies it into shared memory whole,
//     `round_rows` antennas a round, by cp.async in 16-byte words (a run that
//     starts 8 bytes off a 16-byte boundary copies its first element alone).
//     Every byte of the rows is read, pilot or not.
//   * Two stage buffers: while a round is summed, the next round's copies
//     are in flight, and after a task's last round the next task's mask row
//     and first round, so that a block waits on device memory once, at its
//     first task.
//   * A task begins with its mask row on chip: the block finds the row's
//     pilots (each thread counts a slice, a block-wide scan places them, in
//     increasing k) and stages, for each, the
//     frame's own F values from a (C, K, P) copy of the table, its TX value
//     and its mask value, all copies in flight at once (the TX grid is read
//     at the pilots alone); then the divisor's coefficients (Smith's
//     algorithm as c10::complex divides: g is rounded as the masked LS grid
//     rounds it). `chunk` pilots are staged at a time; a row with more is
//     summed chunk by chunk, each chunk staged again with the block waiting.
//   * E: first g, once an (antenna, pilot) of the round, into shared memory;
//     then the threads take (antenna, path, stride): each sums its path over
//     every `strides`-th pilot in float64 registers (two sums, so that a
//     thread holds few registers and four blocks fit a multiprocessor), and
//     the strides of a path are added in order. D: the task of a row's first
//     antennas, threads over (pair, stride) for the P(P + 1)/2 pairs; each
//     term conj F_p·F_q rounded to float32 as the plain version's tables
//     round it, summed in float64. No atomics, and no order that the batch
//     sets: `strides` is a function of K and P, and every sum runs in an
//     order fixed by K, P and the row's pilots, so a frame's E and D are the
//     same bits alone and inside any batch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPaths = 9;  // the profile table's paths (physics/profiles.py MAX_PATHS)
constexpr int kMaxK = 65535;  // pilot indices are kept as 16 bits
constexpr size_t kMaxShared = 232448;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void copy8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void copy4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 1 where a run starts 8 bytes off a 16-byte boundary: its element e then lies
// at buf[shift + e], so that the 16-byte words of the run and of the buffer
// coincide.
__device__ __forceinline__ int shift_of(const float2* run) {
  return (int)((reinterpret_cast<uintptr_t>(run) >> 3) & 1);
}

// Every element of the run src[0 .. n) into buf[shift_of(src) + e], by this
// block's threads, in 16-byte words and at most two 8-byte ones.
__device__ __forceinline__ void copy_run(float2* buf, const float2* src, int n) {
  const int head = shift_of(src);
  float2* dst = buf + head;
  if (head && threadIdx.x == 0 && n > 0) copy8(dst, src);
  const int pairs = (n - head) / 2;
  for (int v = threadIdx.x; v < pairs; v += kThreads) {
    copy16(dst + head + 2 * v, src + head + 2 * v);
  }
  const int tail = head + 2 * pairs;
  if (tail < n && threadIdx.x == kThreads - 1) copy8(dst + tail, src + tail);
}

// The coefficients of a division by x + 1e-12 as c10::complex divides
// (Smith's algorithm, the branch in z), and the mask value m in w.
__device__ __forceinline__ float4 divisor(float2 x, float m) {
  const float c = x.x + 1e-12f, d = x.y + 0.f;
  const float ac = fabsf(c), ad = fabsf(d);
  if (ac >= ad) {
    if (ac == 0.f && ad == 0.f) return make_float4(ac, ad, 2.f, m);
    const float rat = d / c;
    return make_float4(rat, 1.f / (c + d * rat), 0.f, m);
  }
  const float rat = c / d;
  return make_float4(rat, 1.f / (d + c * rat), 1.f, m);
}

// m · y / (x + 1e-12) from the coefficients of divisor(x, m).
__device__ __forceinline__ float2 ls_value(float2 y, float4 cf) {
  float gr, gi;
  if (cf.z == 0.f) {
    gr = (y.x + y.y * cf.x) * cf.y;
    gi = (y.y - y.x * cf.x) * cf.y;
  } else if (cf.z == 1.f) {
    gr = (y.x * cf.x + y.y) * cf.y;
    gi = (y.y * cf.x - y.x) * cf.y;
  } else {
    gr = y.x / cf.x;
    gi = y.y / cf.y;
  }
  return make_float2(cf.w * gr, cf.w * gi);
}


// A block's task: antennas [r_begin, r_begin + r_count) of the (frame,
// symbol) row bs, in `rounds` rounds.
struct Task {
  long long bs, b;
  int s, grp, r_begin, r_count, rounds;
};

__device__ __forceinline__ Task task_of(long long t, int S, int R, int groups, int rows,
                                        int round_rows) {
  Task tk;
  tk.grp = (int)(t % groups);
  tk.bs = t / groups;
  tk.s = (int)(tk.bs % S);
  tk.b = tk.bs / S;
  tk.r_begin = tk.grp * rows;
  tk.r_count = min(rows, R - tk.r_begin);
  tk.rounds = (tk.r_count + round_rows - 1) / round_rows;
  return tk;
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ __forceinline__ int stride_of(int K, int round_rows) {
  return (round_rows * K + 2) & ~1;  // a round's run and one element of slack, 16-byte words
}

// The g values of a round's antennas at the staged pilots ([round_rows][chunk]
// float2), then the threads' partial sums (double2 [kThreads]): one region.
__host__ __device__ __forceinline__ size_t scratch_bytes(int round_rows, int chunk) {
  const size_t g = (size_t)round_rows * chunk * 8, partials = (size_t)kThreads * 16;
  return align16(g > partials ? g : partials);
}

__host__ __device__ __forceinline__ size_t shared_bytes(int K, int P, int round_rows,
                                                        int chunk) {
  return 2 * (size_t)stride_of(K, round_rows) * 8 + (size_t)chunk * 16 +
         align16((size_t)chunk * P * 8) + align16((size_t)K * 4) +
         scratch_bytes(round_rows, chunk) + (size_t)K * 2;
}

// Four blocks a multiprocessor where shared memory allows.
__global__ void __launch_bounds__(kThreads, 4)
    profile_gram_kernel(const float2* __restrict__ rx, const float2* __restrict__ tx,
                        long long tx_b, long long tx_s, const float* __restrict__ mask,
                        const float2* __restrict__ fkp, long long C,
                        const long long* __restrict__ pidx, int S, int R, int P, int K,
                        int groups, int rows, int round_rows, int strides, int chunk,
                        long long tasks, double2* __restrict__ E, double2* __restrict__ D) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int counts[kWarps];
  const int stride = stride_of(K, round_rows);
  unsigned char* at = smem;
  float2* stage = reinterpret_cast<float2*>(at);  // two buffers of `stride` elements
  at += 2 * (size_t)stride * 8;
  float4* coef = reinterpret_cast<float4*>(at);  // [chunk]: TX and mask value, then divisor
  at += (size_t)chunk * 16;
  float2* fst = reinterpret_cast<float2*>(at);  // [chunk][P]: the frame's F at the pilots
  at += align16((size_t)chunk * P * 8);
  float* msh = reinterpret_cast<float*>(at);  // [K]: the mask row of the task being begun
  at += align16((size_t)K * 4);
  float2* gsh = reinterpret_cast<float2*>(at);  // [round_rows][chunk]: g at the pilots
  double2* part = reinterpret_cast<double2*>(at);  // [kThreads]: partial sums
  at += scratch_bytes(round_rows, chunk);
  unsigned short* kidx = reinterpret_cast<unsigned short*>(at);  // [K]: the row's pilots

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float nan = __int_as_float(0x7fffffff);
  const long long step = gridDim.x;
  long long t = blockIdx.x;
  if (t >= tasks) return;
  // Threads of the sums: E, (antenna of the round, path, stride) with
  // `strides` strides of the pilots a path; D, (pair, stride) with as many
  // strides a pair as the block holds. Both fixed by K and P alone.
  const int pairs = P * (P + 1) / 2, d_strides = kThreads / pairs;
  const int e_row = tid / (P * strides), e_p = tid / strides % P, e_first = tid % strides;
  const int d_pair = tid / d_strides, d_first = tid % d_strides;
  int d_p = 0, d_rest = d_pair;
  while (d_p < P && d_rest >= P - d_p) {
    d_rest -= P - d_p;
    ++d_p;
  }
  const int d_q = d_p + d_rest;
  // Elements of the mask row a thread scans, a contiguous slice.
  const int per = (K + kThreads - 1) / kThreads, k_lo = min(K, tid * per),
            k_hi = min(K, k_lo + per);

  // The copies of a task's mask row, and of a round's antennas into buffer
  // `buf` (the round's run of the (B, S, R, K) grid, contiguous).
  auto copy_mask = [&](const Task& tk) {
    const float* mrow = mask + tk.bs * K;
    for (int k = tid; k < K; k += kThreads) copy4(msh + k, mrow + k);
  };
  auto run_of = [&](const Task& tk, int rd) {
    return rx + (tk.bs * R + tk.r_begin + rd * round_rows) * (long long)K;
  };
  auto copy_round = [&](const Task& tk, int rd, int buf) {
    copy_run(stage + (size_t)buf * stride, run_of(tk, rd),
             min(round_rows, tk.r_count - rd * round_rows) * K);
  };

  Task tk = task_of(t, S, R, groups, rows, round_rows);
  copy_mask(tk);
  copy_round(tk, 0, 0);
  commit();
  int buf = 0;  // the stage buffer of the round being summed
  for (; t < tasks; t += step) {
    tk = task_of(t, S, R, groups, rows, round_rows);
    const float* mrow = mask + tk.bs * K;
    const float2* txrow = tx + tk.b * tx_b + tk.s * tx_s;
    wait_copies<0>();  // the task's mask row and its round 0
    __syncthreads();

    // The row's pilots, in increasing k: each thread counts its slice, a
    // block-wide scan places them.
    int mine = 0;
    for (int k = k_lo; k < k_hi; ++k) mine += msh[k] != 0.f;
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) counts[warp] = incl;
    __syncthreads();
    int slot = incl - mine, n = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) slot += counts[w];
      n += counts[w];
    }
    for (int k = k_lo; k < k_hi; ++k) {
      if (msh[k] != 0.f) kidx[slot++] = (unsigned short)k;
    }
    __syncthreads();

    const long long c = pidx[tk.b];
    const bool bad = c < 0 || c >= C;
    const int chunks = (n + chunk - 1) / chunk;
    // The copies of pilots [ch·chunk, ...), a thread a pilot: the frame's F
    // values, [j][p] (NaN for a profile index outside [0, C)), the TX value
    // and the mask value (the TX grid is read at the pilots alone).
    auto copy_pilots = [&](int ch) {
      const int j0 = ch * chunk, nj = min(chunk, n - j0);
      for (int jl = tid; jl < nj; jl += kThreads) {
        const int k = kidx[j0 + jl];
        for (int p = 0; p < P; ++p) {
          if (bad) {
            fst[jl * P + p] = make_float2(nan, nan);
          } else {
            copy8(fst + jl * P + p, fkp + (c * K + k) * P + p);
          }
        }
        copy8(&coef[jl].x, txrow + k);
        copy4(&coef[jl].w, mrow + k);
      }
    };
    // The divisors of the staged pilots, in place; the block synchronised.
    auto form_divisors = [&](int ch) {
      const int nj = min(chunk, n - ch * chunk);
      for (int jl = tid; jl < nj; jl += kThreads) {
        const float4 v = coef[jl];
        coef[jl] = divisor(make_float2(v.x, v.y), v.w);
      }
      __syncthreads();
    };
    // Before each chunk's sums where the row has more than one: the chunk
    // staged, waiting for every copy of the block.
    auto next_chunk = [&](int ch) {
      if (chunks > 1) {
        __syncthreads();
        copy_pilots(ch);
        commit();
        wait_copies<0>();
        __syncthreads();
        form_divisors(ch);
      }
    };
    if (chunks == 1) copy_pilots(0);
    commit();

    for (int rd = 0; rd < tk.rounds; ++rd) {
      // The next round's copies (the next task's mask and round 0 after the
      // last), in flight while this one is summed.
      if (rd + 1 < tk.rounds) {
        copy_round(tk, rd + 1, buf ^ 1);
      } else if (t + step < tasks) {
        const Task next = task_of(t + step, S, R, groups, rows, round_rows);
        copy_mask(next);
        copy_round(next, 0, buf ^ 1);
      }
      commit();
      wait_copies<1>();  // this round's antennas and, at round 0, the pilots
      __syncthreads();

      if (rd == 0) {
        if (chunks == 1) form_divisors(0);
        if (tk.grp == 0) {  // D, once a row: float32 products as the plain tables round them
          double re = 0.0, im = 0.0;
          for (int ch = 0; ch < chunks; ++ch) {
            next_chunk(ch);
            const int nj = min(chunk, n - ch * chunk);
            if (d_pair < pairs) {
              for (int j = d_first; j < nj; j += d_strides) {
                const float2 fp = fst[j * P + d_p], fq = fst[j * P + d_q];
                const double m = coef[j].w;
                const float a = __fadd_rn(__fmul_rn(fp.x, fq.x), __fmul_rn(fp.y, fq.y));
                const float b = __fsub_rn(__fmul_rn(fp.x, fq.y), __fmul_rn(fp.y, fq.x));
                re = fma(m, (double)a, re);
                im = fma(m, (double)b, im);
              }
            }
          }
          part[tid] = make_double2(re, im);
          __syncthreads();
          if (tid < pairs) {  // the pair's strides, in order
            int p = 0, rest = tid;
            while (rest >= P - p) {
              rest -= P - p;
              ++p;
            }
            const int q = p + rest;
            double sr = 0.0, si = 0.0;
            for (int i = 0; i < d_strides; ++i) {
              const double2 v = part[tid * d_strides + i];
              sr += v.x;
              si += v.y;
            }
            double2* drow = D + tk.bs * P * P;
            drow[p * P + q] = make_double2(sr, si);
            if (q != p) drow[q * P + p] = make_double2(sr, -si);
          }
          __syncthreads();
        }
      }

      // E, the round's antennas.
      const int r0 = rd * round_rows, in_round = min(round_rows, tk.r_count - r0);
      const float2* ybuf = stage + (size_t)buf * stride + shift_of(run_of(tk, rd));
      double re = 0.0, im = 0.0;
      for (int ch = 0; ch < chunks; ++ch) {
        next_chunk(ch);
        const int nj = min(chunk, n - ch * chunk);
        for (int i = tid; i < in_round * nj; i += kThreads) {  // g, once an (antenna, pilot)
          const int row = i / nj, j = i - row * nj;
          gsh[row * chunk + j] = ls_value(ybuf[(size_t)row * K + kidx[ch * chunk + j]], coef[j]);
        }
        __syncthreads();
        if (e_row < in_round) {
          const float2* g = gsh + e_row * chunk;
          for (int j = e_first; j < nj; j += strides) {
            const float2 f = fst[j * P + e_p];
            const double gr = g[j].x, gi = g[j].y, fr = f.x, fi = f.y;
            re = fma(gr, fr, fma(gi, fi, re));
            im = fma(gi, fr, fma(-gr, fi, im));
          }
        }
        __syncthreads();  // gsh is free again
      }
      part[tid] = make_double2(re, im);
      __syncthreads();
      if (tid < in_round * P) {  // the path's strides, in order
        const double2* v = part + tid * strides;
        double sr = 0.0, si = 0.0;
        for (int i = 0; i < strides; ++i) {
          sr += v[i].x;
          si += v[i].y;
        }
        const int rr = tid / P, p = tid - rr * P;
        E[((tk.b * R + tk.r_begin + r0 + rr) * S + tk.s) * P + p] = make_double2(sr, si);
      }
      __syncthreads();  // this round's buffer, the partials, the pilots and the mask are free
      buf ^= 1;
    }
  }
}

}  // namespace

extern "C" {

// rx: (B, S, R, K) complex64, contiguous; tx: (B, S, K) complex64 at the
// strides tx_b, tx_s (elements; the subcarrier stride 1); mask: (B, S, K)
// float32, fkp: the profile table as (C, K, P) complex64 and pidx: (B,)
// int64, contiguous. The plan of ops/profile_gram.py: `groups` tasks a
// (frame, symbol) row of `rows` antennas each (the last may hold fewer),
// `round_rows` antennas staged a round, `strides` threads a path of an
// antenna (round_rows · P · strides at most the block's threads), `chunk`
// pilots staged at a time. Each of the card's multiprocessors is given as
// many blocks as fit, and each block takes every gridDim-th task. e: (B, R,
// S, P) and d: (B, S, P, P) complex128, contiguous. Returns
// cudaGetLastError() after the launch.
int profile_gram_launch(const void* rx, const void* tx, long long tx_b, long long tx_s,
                        const void* mask, const void* fkp, long long C, const void* pidx,
                        long long B, int S, int R, int P, int K, int groups, int rows,
                        int round_rows, int strides, int chunk, void* e, void* d,
                        void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || S < 1 || R < 1 || P < 1 || P > kMaxPaths || K < 1 || K > kMaxK || C < 1 ||
      groups < 1 || rows < 1 || (long long)groups * rows < R ||
      (long long)(groups - 1) * rows >= R || round_rows < 1 || strides < 1 ||
      round_rows * P * strides > kThreads || chunk < 1 || chunk > K) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t shared = shared_bytes(K, P, round_rows, chunk);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  const long long tasks = B * S * groups;
  if (tasks == 0) return 0;
  err = cudaFuncSetAttribute(profile_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shared);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, profile_gram_kernel, kThreads,
                                                      shared);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long most = (long long)sms * per_sm, grid = tasks < most ? tasks : most;
  profile_gram_kernel<<<(unsigned)grid, kThreads, shared, (cudaStream_t)stream>>>(
      (const float2*)rx, (const float2*)tx, tx_b, tx_s, (const float*)mask, (const float2*)fkp,
      C, (const long long*)pidx, S, R, P, K, groups, rows, round_rows, strides, chunk, tasks,
      (double2*)e, (double2*)d);
  return (int)cudaGetLastError();
}

const char* ce5g_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
