// Scattered pilots in one pass: for each frame of float32 uniforms u (B, T),
// T = S·K, keep the n smallest (n from the frame's density), ties broken by
// linear index, and write the pilot mask (B, T), the compacted positions
// (B, P, 2) and the validity table (B, P).
//
// Replaces no TPU kernel. The JAX package's pattern (ce5g_tpu/physics/
// pilots.py:37-77) is a jnp expression: 25 rounds of float32 threshold
// bisection, a cumsum rank and a scatter, which XLA fuses. PyTorch runs the
// same rule eagerly as ≈ 228 launches a batch, each round a full pass over
// the uniforms and an int64 sum, ≈ 25 passes over 172 MB and 343 MB of int64
// temporaries at 512 frames of 140 × 599.
//
// What it computes, exactly as the plain rule: 25 rounds of
// mid = 0.5f·(lo + hi), keeping hi = mid where count(u < mid) ≥ n, else
// lo = mid; then the elements with u < hi, in linear-index order up to rank
// n. Counts and ranks are integers and every comparison is a float32 one, so
// the result is the plain rule's bit for bit on any input, ties, repeats and
// values exactly on a midpoint included.
//
// Bound on the H100: bytes. The uniforms read once, the mask, the positions
// and the validity table written once: 4·B·T + 4·B·T + 12·B·P bytes, 0.42 GB
// (0.13 ms at 3.35 TB/s) at (512, 83 860), P = 12 579; the 26 comparisons an
// element are 0.02 ms of the float32 peak there.
//
// Design.
//   * Each frame is read from device memory once, in 16-byte words, and kept
//     on chip. A frame may start at any 4-byte offset (T need not be a
//     multiple of 4): its words are the aligned 16-byte words it touches, the
//     elements of a word outside the frame read as 2.0f, which no threshold
//     (≤ 1) passes, and are never written.
//   * Route 'block' (cluster = 1): one block holds a frame's words in shared
//     memory. Route 'cluster' (2, 4 or 8): a thread block cluster holds a
//     frame too large for one block (at 140 × 599, 335 KB on two blocks),
//     each block a contiguous run of its words; or, where the frames are too
//     few to give every SM a block, a frame that one block would hold. Route
//     'global': a frame too large for 8 blocks is read again from L2 or device
//     memory in each round by a cluster of 8, so that every T is taken.
//   * A round is a count per thread over its words, a warp sum, a block
//     barrier, the block's sum by its first warp, then one cluster barrier (a
//     second block barrier where the cluster is one block) after which every
//     thread reads every block's count (distributed shared memory, kept in
//     two buffers by round parity, so that no third barrier guards them): the
//     frame's count, and the count of the blocks before its own, kept for
//     the hi that the round leaves. A first round at the threshold 1 gives
//     the counts of the starting hi.
//   * Then one sweep over the block's words in order, 4·threads elements a
//     tile: each thread's flags (u < hi) for its word, a block-wide exclusive
//     scan of their counts, plus the count of the earlier blocks and tiles,
//     gives each flagged element its rank; the mask is written in 16-byte
//     stores where the mask and the uniforms share their alignment, and a
//     kept element of rank r < P writes slot r of the positions. The blocks
//     of a cluster then split the P slots: the validity (r < n) and zeros in
//     every slot past the kept count.
//   * Frames per block: where frames are small and many, a block takes
//     several in turn (cluster = 1), so that blocks do not dwarf their work.
//   * It writes every output element itself and allocates nothing.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRounds = 25;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPad = 2.0f;  // an element outside the frame: above every threshold

// Word s of a frame that starts `phase` elements past a 16-byte boundary:
// frame elements 4s − phase … 4s − phase + 3, kPad outside [0, T).
__device__ __forceinline__ float4 load_word(const float* __restrict__ f, long long T, int phase,
                                            long long s) {
  const long long e = 4 * s - phase;
  if (e >= 0 && e + 4 <= T) return *reinterpret_cast<const float4*>(f + e);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = (e + j >= 0 && e + j < T) ? f[e + j] : kPad;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ int below(float4 v, float t) {
  return (v.x < t) + (v.y < t) + (v.z < t) + (v.w < t);
}

// The frame's count from each thread's count c: the sum over the cluster's
// blocks, and in `before` the sum over the blocks ranked before this one.
__device__ __forceinline__ int exchange(int c, int C, int q, int& parity,
                                        int* __restrict__ warp_part, int* __restrict__ counts,
                                        int& before) {
  c = __reduce_add_sync(kFull, c);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    int s = (int)threadIdx.x < (int)(blockDim.x >> 5) ? warp_part[threadIdx.x] : 0;
    s = __reduce_add_sync(kFull, s);
    if (threadIdx.x == 0) counts[parity] = s;
  }
  if (C > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  int total = 0;
  before = 0;
  for (int r = 0; r < C; ++r) {
    const int v = r == q ? counts[parity] : *cg::this_cluster().map_shared_rank(counts + parity, r);
    total += v;
    if (r < q) before += v;
  }
  parity ^= 1;
  return total;
}

// RESIDENT: the block's words are kept in shared memory (routes 'block' and
// 'cluster'); else read again from memory in each round (route 'global').
template <bool RESIDENT>
__global__ void __launch_bounds__(kMaxThreads)
    pilot_select_kernel(const float* __restrict__ u, const int* __restrict__ npil,
                        float* __restrict__ mask, int2* __restrict__ pos,
                        float* __restrict__ valid, long long batch, long long T, int K,
                        long long P, int C, int F, long long per) {
  extern __shared__ float4 held[];  // RESIDENT: the block's words of the frame
  __shared__ int warp_part[32];
  __shared__ int counts[2];
  __shared__ int warp_scan[32];
  __shared__ int tile_sum;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const int q = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const long long first = (long long)(blockIdx.x / C) * F;
  int parity = 0;
  for (long long b = first; b < first + F && b < batch; ++b) {
    const float* f = u + b * T;
    const int phase = (int)((reinterpret_cast<uintptr_t>(f) >> 2) & 3);
    const long long words = (T + phase + 3) >> 2;
    const long long s0 = min((long long)q * per, words);
    const int mine = (int)(min((long long)(q + 1) * per, words) - s0);
    const int n = npil[b];
    auto word = [&](int m) -> float4 {
      if (RESIDENT) return held[m];
      return load_word(f, T, phase, s0 + m);
    };
    if (RESIDENT) {
#pragma unroll 4
      for (int m = tid; m < mine; m += threads) held[m] = load_word(f, T, phase, s0 + m);
      __syncthreads();
    }
    auto count = [&](float t) {
      int c = 0;
#pragma unroll 4
      for (int m = tid; m < mine; m += threads) c += below(word(m), t);
      return c;
    };

    int before_hi = 0;
    int total_hi = exchange(count(1.0f), C, q, parity, warp_part, counts, before_hi);
    float lo = 0.0f, hi = 1.0f;
    for (int r = 0; r < kRounds; ++r) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      int before = 0;
      const int total = exchange(count(mid), C, q, parity, warp_part, counts, before);
      if (total >= n) {
        hi = mid;
        total_hi = total;
        before_hi = before;
      } else {
        lo = mid;
      }
    }

    // the sweep: ranks by linear index, the mask and the kept positions
    float* g = mask + b * T;
    const bool wide = ((reinterpret_cast<uintptr_t>(g) >> 2) & 3) == (uintptr_t)phase;
    int2* slots = pos + b * P;
    int run = before_hi;  // rank of the tile's first element below hi
    for (int m0 = 0; m0 < mine; m0 += threads) {
      const int m = m0 + tid;
      const float4 v = m < mine ? word(m) : make_float4(kPad, kPad, kPad, kPad);
      const unsigned flags = (unsigned)(v.x < hi) | (unsigned)(v.y < hi) << 1 |
                             (unsigned)(v.z < hi) << 2 | (unsigned)(v.w < hi) << 3;
      const int cnt = __popc(flags);
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) warp_scan[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const int w = lane < warps ? warp_scan[lane] : 0;
        int wi = w;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(kFull, wi, off);
          if (lane >= off) wi += y;
        }
        if (lane < warps) warp_scan[lane] = wi - w;
        if (lane == 31) tile_sum = wi;
      }
      __syncthreads();
      if (m < mine) {
        const long long e = 4 * (s0 + m) - phase;  // frame index of the word's first element
        int r = run + warp_scan[warp] + incl - cnt;
        float out[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bool keep = false;
          if ((flags >> j) & 1u) {
            keep = r < n;
            if (keep && r < P) {
              const int idx = (int)(e + j);
              slots[r] = make_int2(idx / K, idx % K);
            }
            ++r;
          }
          out[j] = keep ? 1.0f : 0.0f;
        }
        if (wide && e >= 0 && e + 4 <= T) {
          *reinterpret_cast<float4*>(g + e) = make_float4(out[0], out[1], out[2], out[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (e + j >= 0 && e + j < T) g[e + j] = out[j];
          }
        }
      }
      run += tile_sum;
      __syncthreads();  // warp_scan and tile_sum are written again by the next tile
    }

    // the slots: validity, and zeros past the kept elements
    const long long kept = min((long long)n, (long long)total_hi);
    const long long share = (P + C - 1) / C;
    const long long r1 = min((long long)(q + 1) * share, P);
    for (long long r = (long long)q * share + tid; r < r1; r += threads) {
      valid[b * P + r] = r < n ? 1.0f : 0.0f;
      if (r >= kept) slots[r] = make_int2(0, 0);
    }
  }
  // no block leaves while another of its cluster may read its counts
  if (C > 1) cg::this_cluster().sync();
}

}  // namespace

extern "C" {

// u: (batch, T) float32 uniforms; n: (batch,) int32 pilots a frame; mask:
// (batch, T) float32; pos: (batch, P) int32 pairs; valid: (batch, P)
// float32, all contiguous on the device. The plan of ops/pilot_select.py:
// `cluster` blocks a frame (1, 2, 4 or 8), `frames` frames a block
// (cluster = 1 only), `per` words of a frame a block, `threads` a block,
// resident: the words kept in shared memory (per · 16 bytes a block).
// Returns the launch's CUDA error code.
int pilot_select_launch(const void* u, const void* n, void* mask, void* pos, void* valid,
                        long long batch, long long T, int K, long long P, int cluster, int frames,
                        long long per, int threads, int resident, void* stream) {
  if (batch < 0 || T < 1 || T > 0x7fffffffLL || K < 1 || T % K != 0 || P < 0 || per < 1 ||
      frames < 1 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (cluster > 1 && frames != 1) || threads < 32 || threads > kMaxThreads || threads % 32 ||
      per * cluster < ((T + 6) >> 2)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) return 0;
  const long long grid = cluster > 1 ? batch * cluster : (batch + frames - 1) / frames;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = resident ? pilot_select_kernel<true> : pilot_select_kernel<false>;
  const size_t smem = resident ? (size_t)per * sizeof(float4) : 0;
  // Once a device: allow the largest shared memory a block can have.
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !ready[dev]) {
    int optin = 0;
    cudaFuncAttributes fa;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, pilot_select_kernel<true>);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pilot_select_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)fa.sharedSizeBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, (const float*)u, (const int*)n, (float*)mask,
                           (int2*)pos, (float*)valid, batch, T, K, P, cluster, frames, per);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* ce5g_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
