// The channel and the received grid of a batch of frames in two passes
// over the grid and a small step between them:
//
//   H[b,s,r,t,k] = Σ_p g[b,s,r,t,p] · F[c_b,p,k]           (c_b: frame b's profile)
//   y[b,s,r,k]   = Σ_t H[b,s,r,t,k] · x[b,s,t,k]
//   rx           = y + (n_re + j·n_im) · sqrt(mean|y|² / 10^(snr/10) / 2)
//
// the noise scaled to each frame's measured mean received power, as
// physics/mimo.py's frequency_response, apply_channel(_common_grid) and
// _add_awgn compute them.
//
// Replaces no TPU kernel. The JAX package's physics (ce5g_tpu/physics/
// mimo.py:27-110) is jnp expressions that XLA fuses. PyTorch runs the same
// expressions eagerly: the packed matmul writes a real (…, 2K) product,
// torch.complex copies it into complex64, and the received grid makes about
// ten passes over the (B, S, R, K) grid (the product, its complex copy,
// × x, abs, the square, the mean, the complex noise, its scaling, the sum).
// At 64 frames of 14 × 3275 on 64 × 4 antennas that is ≈ 17 ms a batch for
// ≈ 2.7 ms of necessary traffic.
//
// Bound on the H100: bytes. H written once (8·BSRTK), the two noise planes
// read once and rx written once (16·BSRK): 9.0 GB, 2.69 ms at 3.35 TB/s at
// the shape above; 8.2 GB, 2.46 ms at 512 frames of 140 × 599 at 4 × 4. The
// 8·P operations an element of H (P = 9 paths) are ≈ 0.8 ms of the float32
// peak at the first shape, hidden under the stores.
//
// Design.
//   * H is never read back and no real temporary exists: pass 1 forms each
//     H value in registers from the gains (the block's rows in shared
//     memory, read as broadcasts) and the frame's delay→bin matrix (a
//     thread's two columns in registers for all the block's rows; F stays
//     in L2), stores it once, and takes y and its power from the same
//     registers. Pass 2 forms y again from the gains, TX-summed first where
//     every TX antenna sends one grid (route 'common', as the plain path),
//     reads the noise once and writes rx once.
//   * Stores. A thread holds elements 2m and 2m + 1 of a row. K is odd at
//     both shapes above, so a row starts on a 16-byte boundary or 8 bytes
//     off one: the first stores the pair in one 16-byte store, the second
//     pairs the thread's second element with the next lane's first (a warp
//     shuffle), lane 0's first and lane 31's second stored alone. Stores
//     and the noise loads are marked streaming, so that F and the gains keep
//     their place in L2.
//   * Exact and deterministic power. Each |y|² is a float32 term, added into
//     a float64 sum a thread, then a warp by shuffles, then a block in a
//     fixed order: one partial a block, no atomics. Between the passes one
//     warp a frame adds the frame's partials in a fixed order into its noise
//     scale, so that two calls give the same bits.
//   * A block takes `group` (s, r) rows of one frame (T rows of H each) over
//     a tile of 2·threads subcarriers; the plan (ops/channel.py) sizes the
//     tiles to K and the group to about 32 rows of H, so that a thread's F
//     registers serve many stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxPaths = 9;  // the profile table's paths (physics/profiles.py MAX_PATHS)
constexpr int kMaxShared = 48 * 1024;  // bytes of gains a block stages
constexpr unsigned kFull = 0xffffffffu;

struct GainStrides {
  long long b, s, r, t, p;  // elements
};

struct GridStrides {
  long long b, s, t;  // elements; the subcarrier stride is 1, t's may be 0
};

__device__ __forceinline__ float2 cmac(float2 acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
  return acc;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;  // lane 0's is the warp's sum, in a fixed order
}

// Elements k0 = 2m and k0 + 1 of a row of K (a and b, held by this thread)
// in 16-byte stores where the row's alignment allows (see the note). Every
// lane of the warp calls it on the same row.
__device__ __forceinline__ void store_pair(float2* row, long long K, long long k0, int lane,
                                           float2 a, float2 b) {
  if (((reinterpret_cast<uintptr_t>(row) >> 3) & 1) == 0) {
    if (k0 + 1 < K) {
      __stcs(reinterpret_cast<float4*>(row + k0), make_float4(a.x, a.y, b.x, b.y));
    } else if (k0 < K) {
      __stcs(row + k0, a);
    }
    return;
  }
  const float nx = __shfl_down_sync(kFull, a.x, 1);
  const float ny = __shfl_down_sync(kFull, a.y, 1);
  if (lane == 0 && k0 < K) __stcs(row + k0, a);
  if (k0 + 1 < K) {
    if (lane < 31 && k0 + 2 < K) {
      __stcs(reinterpret_cast<float4*>(row + k0 + 1), make_float4(b.x, b.y, nx, ny));
    } else {
      __stcs(row + k0 + 1, b);
    }
  }
}

// Elements k0 and k0 + 1 of a float32 row of K (0 past K), streaming: one
// 8-byte load where the pair is aligned to it, else two.
__device__ __forceinline__ float2 load_pair(const float* row, long long K, long long k0) {
  if (k0 + 1 < K && (reinterpret_cast<uintptr_t>(row + k0) & 7) == 0) {
    return __ldcs(reinterpret_cast<const float2*>(row + k0));
  }
  float2 v = make_float2(0.f, 0.f);
  if (k0 < K) v.x = __ldcs(row + k0);
  if (k0 + 1 < K) v.y = __ldcs(row + k0 + 1);
  return v;
}

// Columns k0 and k0 + 1 of frame profile c's delay→bin matrix, zero past P
// and K; NaN for a profile index outside [0, C).
__device__ __forceinline__ void load_f(const float2* __restrict__ F, long long c, long long C,
                                       int P, long long K, long long k0,
                                       float2 (&f)[kMaxPaths][2]) {
  const bool bad = c < 0 || c >= C;
  const float nan = __int_as_float(0x7fffffff);
#pragma unroll
  for (int p = 0; p < kMaxPaths; ++p) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float2 v = make_float2(0.f, 0.f);
      if (p < P && k0 + e < K) v = bad ? make_float2(nan, nan) : F[(c * P + p) * K + k0 + e];
      f[p][e] = v;
    }
  }
}

// The block's (frame, group, tile) from its index: tiles fastest, then the
// groups of a frame. Its partial is partials[blockIdx.x].
struct Block {
  long long b;
  int sr0, rows, tile;
};

__device__ __forceinline__ Block block_of(int S, int R, int group, int chunks, int tiles) {
  Block blk;
  const long long bid = blockIdx.x;
  blk.tile = (int)(bid % tiles);
  const long long rest = bid / tiles;
  blk.sr0 = (int)(rest % chunks) * group;
  blk.b = rest / chunks;
  blk.rows = min(group, S * R - blk.sr0);
  return blk;
}

// The gains of the block's rows into shared memory, [row][t][kMaxPaths]
// (SUM: the TX sum, [row][kMaxPaths], t added in order), zero past P. The
// path is the slowest index of the walk, as in the Jakes stage's layout
// (B, S, P, R, T), so that neighbouring threads read neighbouring gains there.
template <bool SUM>
__device__ __forceinline__ void stage_gains(float2* gsh, const float2* __restrict__ g,
                                            const GainStrides gs, const Block& blk, int R, int T,
                                            int P) {
  const int per_path = SUM ? blk.rows : blk.rows * T;
  for (int i = threadIdx.x; i < kMaxPaths * per_path; i += blockDim.x) {
    const int p = i / per_path, jt = i % per_path;
    const int j = SUM ? jt : jt / T, t = SUM ? 0 : jt % T;
    const int sr = blk.sr0 + j, s = sr / R, r = sr % R;
    const float2* base = g + blk.b * gs.b + s * gs.s + r * gs.r + p * gs.p;
    float2 v = make_float2(0.f, 0.f);
    if (p < P) {
      if (SUM) {
        for (int u = 0; u < T; ++u) {
          const float2 w = base[u * gs.t];
          v.x += w.x;
          v.y += w.y;
        }
      } else {
        v = base[t * gs.t];
      }
    }
    gsh[(SUM ? j : j * T + t) * kMaxPaths + p] = v;
  }
}

// Pass 1: H, stored once, and each block's Σ|y|².
template <bool PER_TX>
__global__ void __launch_bounds__(kMaxThreads)
    channel_response_kernel(const float2* __restrict__ g, const GainStrides gs,
                            const float2* __restrict__ F, long long C,
                            const long long* __restrict__ pidx, const float2* __restrict__ x,
                            const GridStrides xs, int S, int R, int T, int P, long long K,
                            int group, int chunks, int tiles, float2* __restrict__ H,
                            double* __restrict__ partials) {
  extern __shared__ float2 gsh[];  // [group][T][kMaxPaths]
  __shared__ double red[kMaxThreads / 32];
  const Block blk = block_of(S, R, group, chunks, tiles);
  const int lane = threadIdx.x & 31;
  const long long k0 = 2 * ((long long)blk.tile * blockDim.x + threadIdx.x);
  stage_gains<false>(gsh, g, gs, blk, R, T, P);
  float2 f[kMaxPaths][2];
  load_f(F, pidx[blk.b], C, P, K, k0, f);
  __syncthreads();

  double power = 0.0;
  for (int j = 0; j < blk.rows; ++j) {
    const int sr = blk.sr0 + j, s = sr / R, r = sr % R;
    const float2* xrow = x + blk.b * xs.b + s * xs.s;
    float2 x0 = make_float2(0.f, 0.f), x1 = x0;
    if (!PER_TX) {
      if (k0 < K) x0 = xrow[k0];
      if (k0 + 1 < K) x1 = xrow[k0 + 1];
    }
    float2 y0 = make_float2(0.f, 0.f), y1 = y0;
    float2* hrow = H + ((blk.b * S + s) * R + r) * T * K;
    for (int t = 0; t < T; ++t) {
      const float2* gj = gsh + (j * T + t) * kMaxPaths;
      float2 h0 = make_float2(0.f, 0.f), h1 = h0;
#pragma unroll
      for (int p = 0; p < kMaxPaths; ++p) {
        const float2 gv = gj[p];
        h0 = cmac(h0, gv, f[p][0]);
        h1 = cmac(h1, gv, f[p][1]);
      }
      store_pair(hrow + t * K, K, k0, lane, h0, h1);
      if (PER_TX) {
        const float2* xt = xrow + t * xs.t;
        if (k0 < K) y0 = cmac(y0, h0, xt[k0]);
        if (k0 + 1 < K) y1 = cmac(y1, h1, xt[k0 + 1]);
      } else {
        y0.x += h0.x;
        y0.y += h0.y;
        y1.x += h1.x;
        y1.y += h1.y;
      }
    }
    if (!PER_TX) {
      y0 = cmul(y0, x0);
      y1 = cmul(y1, x1);
    }
    if (k0 < K) power += (double)fmaf(y0.x, y0.x, y0.y * y0.y);
    if (k0 + 1 < K) power += (double)fmaf(y1.x, y1.x, y1.y * y1.y);
  }
  power = warp_sum(power);
  if (lane == 0) red[threadIdx.x / 32] = power;
  __syncthreads();
  if (threadIdx.x == 0) {
    double sum = 0.0;
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) sum += red[w];
    partials[blockIdx.x] = sum;
  }
}

// Each frame's noise scale, sqrt(mean|y|² / 10^(snr/10) / 2), from its
// partials added in a fixed order: one warp a frame.
__global__ void __launch_bounds__(kMaxThreads)
    channel_scale_kernel(const double* __restrict__ partials, int per_frame, double n,
                         const float* __restrict__ snr_db, long long B,
                         float* __restrict__ scale) {
  const long long b = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  const double* part = partials + b * per_frame;
  double sum = 0.0;
  for (int i = lane; i < per_frame; i += 32) sum += part[i];
  sum = warp_sum(sum);
  if (lane == 0) {
    const double linear = pow(10.0, (double)snr_db[b] / 10.0);
    scale[b] = (float)sqrt(sum / n / linear / 2.0);
  }
}

// Pass 2: y again from the gains, rx = y + n·scale written once.
template <bool PER_TX>
__global__ void __launch_bounds__(kMaxThreads)
    channel_received_kernel(const float2* __restrict__ g, const GainStrides gs,
                            const float2* __restrict__ F, long long C,
                            const long long* __restrict__ pidx, const float2* __restrict__ x,
                            const GridStrides xs, const float* __restrict__ scale,
                            const float* __restrict__ n_re, const float* __restrict__ n_im,
                            int S, int R, int T, int P, long long K, int group, int chunks,
                            int tiles, float2* __restrict__ rx) {
  extern __shared__ float2 gsh[];  // PER_TX [group][T][kMaxPaths], else summed over T
  const Block blk = block_of(S, R, group, chunks, tiles);
  const int lane = threadIdx.x & 31;
  const long long k0 = 2 * ((long long)blk.tile * blockDim.x + threadIdx.x);
  const float sd = scale[blk.b];
  stage_gains<!PER_TX>(gsh, g, gs, blk, R, T, P);
  float2 f[kMaxPaths][2];
  load_f(F, pidx[blk.b], C, P, K, k0, f);
  __syncthreads();

  for (int j = 0; j < blk.rows; ++j) {
    const int sr = blk.sr0 + j, s = sr / R, r = sr % R;
    const float2* xrow = x + blk.b * xs.b + s * xs.s;
    float2 y0 = make_float2(0.f, 0.f), y1 = y0;
    if (PER_TX) {
      for (int t = 0; t < T; ++t) {
        const float2* gj = gsh + (j * T + t) * kMaxPaths;
        float2 h0 = make_float2(0.f, 0.f), h1 = h0;
#pragma unroll
        for (int p = 0; p < kMaxPaths; ++p) {
          const float2 gv = gj[p];
          h0 = cmac(h0, gv, f[p][0]);
          h1 = cmac(h1, gv, f[p][1]);
        }
        const float2* xt = xrow + t * xs.t;
        if (k0 < K) y0 = cmac(y0, h0, xt[k0]);
        if (k0 + 1 < K) y1 = cmac(y1, h1, xt[k0 + 1]);
      }
    } else {
      const float2* gj = gsh + j * kMaxPaths;
#pragma unroll
      for (int p = 0; p < kMaxPaths; ++p) {
        const float2 gv = gj[p];
        y0 = cmac(y0, gv, f[p][0]);
        y1 = cmac(y1, gv, f[p][1]);
      }
      if (k0 < K) y0 = cmul(y0, xrow[k0]);
      if (k0 + 1 < K) y1 = cmul(y1, xrow[k0 + 1]);
    }
    const long long row = (blk.b * S + s) * R + r;
    const float2 re = load_pair(n_re + row * K, K, k0);
    const float2 im = load_pair(n_im + row * K, K, k0);
    y0 = make_float2(fmaf(re.x, sd, y0.x), fmaf(im.x, sd, y0.y));
    y1 = make_float2(fmaf(re.y, sd, y1.x), fmaf(im.y, sd, y1.y));
    store_pair(rx + row * K, K, k0, lane, y0, y1);
  }
}

template <bool PER_TX>
int launch(const float2* g, const GainStrides& gs, const float2* F, long long C,
           const long long* pidx, const float2* x, const GridStrides& xs, const float* snr,
           const float* n_re, const float* n_im, long long B, int S, int R, int T, int P,
           long long K, int threads, int tiles, int group, int chunks, double* partials,
           float2* H, float2* rx, cudaStream_t stream) {
  const unsigned grid = (unsigned)(B * chunks * tiles);
  const size_t staged = (size_t)group * T * kMaxPaths * sizeof(float2);
  channel_response_kernel<PER_TX><<<grid, threads, staged, stream>>>(
      g, gs, F, C, pidx, x, xs, S, R, T, P, K, group, chunks, tiles, H, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* scale = reinterpret_cast<float*>(partials + grid);
  const int frames_a_block = kMaxThreads / 32;
  channel_scale_kernel<<<(unsigned)((B + frames_a_block - 1) / frames_a_block), kMaxThreads, 0,
                         stream>>>(partials, chunks * tiles, (double)S * (double)R * (double)K,
                                   snr, B, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t staged_rx = PER_TX ? staged : (size_t)group * kMaxPaths * sizeof(float2);
  channel_received_kernel<PER_TX><<<grid, threads, staged_rx, stream>>>(
      g, gs, F, C, pidx, x, xs, scale, n_re, n_im, S, R, T, P, K, group, chunks, tiles, rx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g: the gains (B, S, R, T, P) complex64 at the strides gstrides (5, in
// elements); f: the delay→bin table (C, P, K) complex64, contiguous; pidx:
// (B,) int64 profile indices; x: the TX grid (B, S, 1 or T, K) complex64 at
// the strides xstrides (b, s, t; the subcarrier stride 1); per_tx: x holds
// one grid a TX antenna (else one for all, route 'common'); snr: (B,)
// float32 dB; n_re, n_im: (B, S, R, K) float32, contiguous. The plan of
// ops/channel.py: `threads` a block (a multiple of 32, at most 256), `tiles`
// tiles of 2·threads subcarriers, `group` (s, r) rows a block. partials:
// B · ceil(S·R / group) · tiles doubles, then B more (the frames' noise
// scales, as floats); h: (B, S, R, T, K) and rx:
// (B, S, R, K) complex64, contiguous. Returns cudaGetLastError() after the
// three launches.
int channel_launch(const void* g, const long long* gstrides, const void* f, long long C,
                   const void* pidx, const void* x, const long long* xstrides, int per_tx,
                   const void* snr, const void* n_re, const void* n_im, long long B, int S, int R,
                   int T, int P, long long K, int threads, int tiles, int group, void* partials,
                   void* h, void* rx, void* stream) {
  if (B < 0 || S < 1 || R < 1 || T < 1 || P < 1 || P > kMaxPaths || K < 1 || C < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || tiles < 1 ||
      2LL * threads * tiles < K || group < 1 ||
      (size_t)group * T * kMaxPaths * sizeof(float2) > (size_t)kMaxShared) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunks = (S * R + group - 1) / group;
  if (B * chunks * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const GainStrides gs{gstrides[0], gstrides[1], gstrides[2], gstrides[3], gstrides[4]};
  const GridStrides xs{xstrides[0], xstrides[1], xstrides[2]};
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* gp = (const float2*)g;
  const auto* fp = (const float2*)f;
  const auto* ip = (const long long*)pidx;
  const auto* xp = (const float2*)x;
  const auto* sp = (const float*)snr;
  const auto* nr = (const float*)n_re;
  const auto* ni = (const float*)n_im;
  auto* part = (double*)partials;
  auto* hp = (float2*)h;
  auto* rp = (float2*)rx;
  return per_tx ? launch<true>(gp, gs, fp, C, ip, xp, xs, sp, nr, ni, B, S, R, T, P, K, threads,
                               tiles, group, chunks, part, hp, rp, s)
                : launch<false>(gp, gs, fp, C, ip, xp, xs, sp, nr, ni, B, S, R, T, P, K, threads,
                                tiles, group, chunks, part, hp, rp, s);
}

const char* ce5g_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
