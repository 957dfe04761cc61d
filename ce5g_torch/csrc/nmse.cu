// The score's two sums in one pass: Σ|H − Ĥ|² and Σ|H|² over the reduced
// axes of a complex64 channel H and its estimate Ĥ, and the NMSE
// (Σ|H − Ĥ|²/N) / (Σ|H|²/N + eps) of each output row.
//
// Replaces no TPU kernel. The JAX package's score (ce5g_tpu/utils/
// metrics.py:33-38) is a jnp expression that XLA fuses into one pass over H
// and Ĥ. PyTorch runs the same expression eagerly as seven operators (a
// subtraction, two abs, two squares, two means), each writing its
// full-size result to device memory: at 64 frames of 14 × 3275 on 64 × 4
// antennas, H is 6.0 GB and Ĥ a broadcast along TX of 1.5 GB of distinct
// values, and the chain moves ≈ 49 GB a batch. This kernel moves what the
// score needs: H read once and Ĥ's distinct values read once.
//
// Bound on the H100: bytes. 8·|H| + 8·distinct(Ĥ) over 3.35 TB/s: 7.51 GB,
// 2.24 ms at (64, 14, 64, 4, 3275); 0.344 GB, 0.103 ms at
// (256, 14, 4, 4, 599). The ≈ 10 operations an element are 0.11 ms of the
// float32 peak at the larger shape.
//
// Layout (ops/nmse.py::plan). The reduced axes are the last, with no copy:
// the wrapper permutes the two tensors' strides, merges neighbouring axes
// where both tensors allow it, and hands the kernel
//   * outer axes (up to kMaxDims, the kept ones first) whose index is a
//     "line": rows × lines_per_row lines, the lines of one output row
//     consecutive;
//   * a repeat axis (T, stride hT in H): a reduced axis along which Ĥ has
//     stride 0 (the TX axis of the estimators' broadcast), T = 1 where none;
//   * the inner axis (K, strides hK and eK), taken in `pieces` pieces of
//     `piece` elements (the last shorter): one piece, unless the lines are
//     too few to give every team of the grid several (a contiguous Ĥ, one
//     TX antenna: everything merges into the inner axis).
// A line is the T rows of H (one a repeat) against one row of Ĥ; a team
// takes a piece of a line at a time.
//
// Design.
//   * Ĥ's distinct values once: a thread loads an Ĥ value into registers
//     and subtracts it from the T values of H that share it before it
//     loads the next; the repeat axis is never read from device memory.
//   * Loads. Route 'pairs' (hK = eK = 1): a thread takes two neighbouring
//     elements, 16 bytes. K is odd at both shapes above, so a row starts on
//     a 16-byte boundary or 8 bytes off one. The pairs are aligned to Ĥ's
//     row (its first element alone where the row starts off a boundary, its
//     last where the rest is odd); an H row of the same parity is read in
//     16-byte loads, one of the other parity in two 8-byte loads. A thread
//     issues Ĥ's load and four rows of H's before it adds any: 80 bytes in
//     flight a thread at T = 4. At T = 1 (no repeat axis: a contiguous Ĥ,
//     one TX antenna) it issues four pairs of each before it adds any: 128
//     bytes. Route 'strided' (any inner strides) reads one element at a
//     time.
//   * A persistent grid: as many blocks as the card keeps resident, at
//     least kMinBlocks an SM (the registers capped to allow it). A block
//     of 256 threads holds 256/team teams of `team` threads (32-256, from
//     K: ≥ 8 passes over a row). The pieces of each output row's lines are
//     cut into `chunks` contiguous runs, each a work item; a team takes
//     work items w, w + teams, ... and walks the pieces of one, the lines
//     by an odometer over the outer axes (64-bit offsets: H passes 2³¹
//     bytes). Lines taken whole run an instance with no piece bookkeeping,
//     whose registers set the grid at the benchmark's layouts.
//   * Exact and deterministic. Each |·|² is a float32 term, added to float64
//     sums in a fixed order: a thread's sums, then a warp's by shuffles,
//     written as one partial a warp and work item; a second kernel adds the
//     partials of each row in a fixed order and writes the sums and the
//     NMSE. No atomics: two calls give the same bits. NaN and Inf pass
//     through as in the plain expression.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;  // resident blocks an SM, at least: at most 85 registers a thread
constexpr int kMaxDims = 6;

struct Outer {
  long long size[kMaxDims];  // outermost first; unused leading axes are 1
  long long hs[kMaxDims];    // strides in elements: H
  long long es[kMaxDims];    // and Ĥ
};

__device__ __forceinline__ void add(float hr, float hi, float er, float ei, double& se,
                                    double& sp) {
  const float dr = hr - er, di = hi - ei;
  se += (double)fmaf(dr, dr, di * di);
  sp += (double)fmaf(hr, hr, hi * hi);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0's is the warp's sum, in a fixed order
}

__device__ __forceinline__ float4 load_pair(const float2* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) return *reinterpret_cast<const float4*>(p);
  const float2 a = p[0], b = p[1];
  return make_float4(a.x, a.y, b.x, b.y);
}

// Both sums over one line: the T rows of H at h (row t at h + t·hT) against
// the row of Ĥ at e. ONE: T = 1, where a thread keeps four pairs of each in
// flight rather than one of Ĥ and four rows of H.
template <bool PAIRS, bool ONE>
__device__ __forceinline__ void line(const float2* __restrict__ h, const float2* __restrict__ e,
                                     long long T, long long hT, long long K, long long hK,
                                     long long eK, int lane, int team, double& se, double& sp) {
  if (!PAIRS) {
    for (long long k = lane; k < K; k += team) {
      const float2 ev = e[k * eK];
      for (long long t = 0; t < T; ++t) {
        const float2 hv = h[t * hT + k * hK];
        add(hv.x, hv.y, ev.x, ev.y, se, sp);
      }
    }
    return;
  }
  // Ĥ[q] starts a 16-byte word
  const long long q = (long long)((reinterpret_cast<uintptr_t>(e) >> 3) & 1);
  const long long pairs = K > q ? (K - q) >> 1 : 0;
  if (ONE) {
    for (long long m0 = lane; m0 < pairs; m0 += 4 * team) {
      float4 ev[4], hv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long k = q + 2 * (m0 + u * team);
        if (m0 + u * team < pairs) {
          ev[u] = *reinterpret_cast<const float4*>(e + k);
          hv[u] = load_pair(h + k);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (m0 + u * team < pairs) {
          add(hv[u].x, hv[u].y, ev[u].x, ev[u].y, se, sp);
          add(hv[u].z, hv[u].w, ev[u].z, ev[u].w, se, sp);
        }
      }
    }
  }
  for (long long m = ONE ? pairs : lane; m < pairs; m += team) {
    const long long k = q + 2 * m;
    const float4 ev = *reinterpret_cast<const float4*>(e + k);
    for (long long t0 = 0; t0 < T; t0 += 4) {
      float4 hv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (t0 + u < T) hv[u] = load_pair(h + (t0 + u) * hT + k);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (t0 + u < T) {
          add(hv[u].x, hv[u].y, ev.x, ev.y, se, sp);
          add(hv[u].z, hv[u].w, ev.z, ev.w, se, sp);
        }
      }
    }
  }
  // the element before the first pair, and the one after the last
  const long long tail = q + 2 * pairs;
  long long k = -1;
  if (lane == 0 && q == 1 && K > 0) k = 0;
  if (lane == team - 1 && tail < K) k = tail;
  if (k >= 0) {
    const float2 ev = e[k];
    for (long long t = 0; t < T; ++t) {
      const float2 hv = h[t * hT + k];
      add(hv.x, hv.y, ev.x, ev.y, se, sp);
    }
  }
}

// CUT: the lines are taken in pieces (pieces > 1); else whole, as the
// benchmark's layouts take them, with no piece bookkeeping.
template <bool PAIRS, bool CUT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    nmse_kernel(const float2* __restrict__ H, const float2* __restrict__ E, const Outer outer,
                long long T, long long hT, long long K, long long hK, long long eK,
                long long lines_per_row, long long pieces, long long piece, long long chunks,
                long long items, int team, double* __restrict__ partials) {
  const int teams_per_block = kThreads / team;
  const int lane = threadIdx.x % team;
  const int warps_per_team = team / 32;
  const long long teams = (long long)gridDim.x * teams_per_block;
  for (long long w = (long long)blockIdx.x * teams_per_block + threadIdx.x / team; w < items;
       w += teams) {
    const long long row = w / chunks, c = w % chunks, per_row = lines_per_row * pieces;
    const long long first = c * per_row / chunks, last = (c + 1) * per_row / chunks;
    double se = 0.0, sp = 0.0;
    if (first < last) {
      long long idx[kMaxDims];
      long long p = CUT ? first % pieces : 0;  // the piece of the line
      long long ho = 0, eo = 0, rest = row * lines_per_row + (CUT ? first / pieces : first);
#pragma unroll
      for (int d = kMaxDims - 1; d >= 0; --d) {
        idx[d] = rest % outer.size[d];
        rest /= outer.size[d];
        ho += idx[d] * outer.hs[d];
        eo += idx[d] * outer.es[d];
      }
      for (long long l = first; l < last; ++l) {
        if (CUT) {
          const long long k0 = p * piece, n = K - k0 < piece ? K - k0 : piece;
          if (T == 1) {
            line<PAIRS, true>(H + ho + k0 * hK, E + eo + k0 * eK, 1, hT, n, hK, eK, lane, team,
                              se, sp);
          } else {
            line<PAIRS, false>(H + ho + k0 * hK, E + eo + k0 * eK, T, hT, n, hK, eK, lane, team,
                               se, sp);
          }
          if (++p < pieces) continue;
          p = 0;
        } else {
          line<PAIRS, false>(H + ho, E + eo, T, hT, K, hK, eK, lane, team, se, sp);
        }
#pragma unroll
        for (int d = kMaxDims - 1; d >= 0; --d) {  // the next line
          ++idx[d];
          ho += outer.hs[d];
          eo += outer.es[d];
          if (idx[d] < outer.size[d]) break;
          idx[d] = 0;
          ho -= outer.size[d] * outer.hs[d];
          eo -= outer.size[d] * outer.es[d];
        }
      }
    }
    se = warp_sum(se);
    sp = warp_sum(sp);
    if ((threadIdx.x & 31) == 0) {
      double* out = partials + 2 * (w * warps_per_team + lane / 32);
      out[0] = se;
      out[1] = sp;
    }
  }
}

// Row r's partials (per_row of them) in a fixed order → its two sums and
// its NMSE over n elements.
__global__ void __launch_bounds__(kThreads)
    nmse_finish_kernel(const double* __restrict__ partials, long long rows, long long per_row,
                       double n, double eps, double* __restrict__ sums, float* __restrict__ out) {
  __shared__ double se_w[kThreads / 32], sp_w[kThreads / 32];
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const double* p = partials + 2 * r * per_row;
    double se = 0.0, sp = 0.0;
    for (long long j = threadIdx.x; j < per_row; j += kThreads) {
      se += p[2 * j];
      sp += p[2 * j + 1];
    }
    se = warp_sum(se);
    sp = warp_sum(sp);
    if ((threadIdx.x & 31) == 0) {
      se_w[threadIdx.x / 32] = se;
      sp_w[threadIdx.x / 32] = sp;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double e = 0.0, q = 0.0;
      for (int i = 0; i < kThreads / 32; ++i) {
        e += se_w[i];
        q += sp_w[i];
      }
      sums[2 * r] = e;
      sums[2 * r + 1] = q;
      out[r] = (float)((e / n) / (q / n + eps));
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Blocks of nmse_kernel the device keeps resident at once, all SMs: the
// least over its instances, so that every launch's grid is resident.
int nmse_resident_blocks(int device, int* blocks) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const void* kernels[] = {(const void*)nmse_kernel<true, false>,
                           (const void*)nmse_kernel<true, true>,
                           (const void*)nmse_kernel<false, false>,
                           (const void*)nmse_kernel<false, true>};
  int least = 0;
  for (int i = 0; i < 4; ++i) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernels[i], kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (i == 0 || per_sm < least) least = per_sm;
  }
  *blocks = sms * (least > 0 ? least : 1);
  return 0;
}

// h, e: complex64 on the device; outer: kMaxDims sizes, then kMaxDims H
// strides, then kMaxDims Ĥ strides (elements, outermost first). The plan
// of ops/nmse.py: rows × lines_per_row lines, the inner axis in `pieces`
// pieces of `piece` elements, the pieces of a row cut into `chunks` work
// items; `team` threads a work item (32, 64, 128 or 256); `grid` blocks;
// pairs: route 'pairs' (hK = eK = 1), else 'strided'. partials: rows ·
// chunks · team/32 pairs of doubles; sums: rows pairs of doubles; out:
// rows floats. Returns cudaGetLastError() after the launches.
int nmse_launch(const void* h, const void* e, const long long* outer, long long T, long long hT,
                long long K, long long hK, long long eK, long long rows, long long lines_per_row,
                long long pieces, long long piece, long long chunks, int team, int grid,
                int pairs, double eps, void* partials, void* sums, void* out, void* stream) {
  if (rows < 0 || lines_per_row < 0 || pieces < 1 || piece < 0 || pieces * piece < K ||
      chunks < 1 || T < 1 || K < 0 || grid < 1 ||
      (team != 32 && team != 64 && team != 128 && team != 256)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  Outer o;
  for (int d = 0; d < kMaxDims; ++d) {
    o.size[d] = outer[d];
    o.hs[d] = outer[kMaxDims + d];
    o.es[d] = outer[2 * kMaxDims + d];
    if (o.size[d] < 1) return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const long long items = rows * chunks;
  auto kernel = pairs ? (pieces > 1 ? nmse_kernel<true, true> : nmse_kernel<true, false>)
                      : (pieces > 1 ? nmse_kernel<false, true> : nmse_kernel<false, false>);
  kernel<<<grid, kThreads, 0, s>>>((const float2*)h, (const float2*)e, o, T, hT, K, hK, eK,
                                   lines_per_row, pieces, piece, chunks, items, team,
                                   (double*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const double n = (double)lines_per_row * (double)T * (double)K;
  const unsigned finish = (unsigned)(rows < 65536 ? rows : 65536);
  nmse_finish_kernel<<<finish, kThreads, 0, s>>>((const double*)partials, rows,
                                                 chunks * (team / 32), n, eps, (double*)sums,
                                                 (float*)out);
  return (int)cudaGetLastError();
}

const char* ce5g_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
