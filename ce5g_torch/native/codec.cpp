// ce5g native chunk codec: threaded block compression for dataset I/O.
// A copy of ce5g_tpu/native/codec.cpp, so that the port builds its own.
//
//   * byte-shuffle filter (HDF5-shuffle-style): transposes the bytes of
//     fixed-size items so same-significance bytes are contiguous — float
//     wire data compresses both faster and smaller;
//   * zstd per block on a std::thread pool — every block is independent, so
//     compression and decompression scale with cores and blocks can be
//     decompressed selectively.
//
// The container layout (JSON header + per-array block tables) lives in
// Python (ce5g_torch/data/ce5g_format.py); this file is pure buffer→buffer
// block transforms behind a minimal C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 codec.cpp -l:libzstd.so.1 -lpthread -o libce5gcodec.so
// (the versioned runtime library, so a host without zstd's development
// package builds it too).

#if __has_include(<zstd.h>)
#include <zstd.h>
#else
// zstd's runtime library without its header: the four functions of its
// stable ABI (zstd.h, ZSTDLIB_API) that this file calls.
#include <cstddef>
extern "C" {
size_t ZSTD_compressBound(size_t srcSize);
size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src, size_t srcSize,
                     int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src, size_t compressedSize);
unsigned ZSTD_isError(size_t code);
}
#endif

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// Byte-shuffle `n_items` items of `itemsize` bytes from src to dst:
// dst[b * n_items + i] = src[i * itemsize + b].
void shuffle_bytes(const uint8_t* src, uint8_t* dst, int64_t n_items,
                   int itemsize) {
  for (int b = 0; b < itemsize; ++b) {
    const uint8_t* s = src + b;
    uint8_t* d = dst + static_cast<int64_t>(b) * n_items;
    for (int64_t i = 0; i < n_items; ++i) d[i] = s[i * itemsize];
  }
}

void unshuffle_bytes(const uint8_t* src, uint8_t* dst, int64_t n_items,
                     int itemsize) {
  for (int b = 0; b < itemsize; ++b) {
    const uint8_t* s = src + static_cast<int64_t>(b) * n_items;
    uint8_t* d = dst + b;
    for (int64_t i = 0; i < n_items; ++i) d[i * itemsize] = s[i];
  }
}

struct BlockRange {
  int64_t raw_off;   // offset into raw buffer
  int64_t raw_len;   // uncompressed length
  int64_t dst_off;   // offset into destination buffer (compressed stream)
};

void run_pool(int nthreads, int64_t nblocks,
              const std::function<void(int64_t)>& work) {
  if (nthreads <= 1 || nblocks <= 1) {
    for (int64_t i = 0; i < nblocks; ++i) work(i);
    return;
  }
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= nblocks) return;
      work(i);
    }
  };
  std::vector<std::thread> threads;
  int n = static_cast<int>(std::min<int64_t>(nthreads, nblocks));
  threads.reserve(n);
  for (int t = 0; t < n; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// Worst-case compressed size of one block (for sizing the dst buffer).
int64_t ce5g_bound(int64_t block_size) {
  return static_cast<int64_t>(ZSTD_compressBound(block_size));
}

// Compress `n` bytes of `src` in independent `block_size`-byte blocks
// (trailing block may be short). If `itemsize > 1`, each block is
// byte-shuffled before compression (block_size must be a multiple of
// itemsize; the trailing partial block is shuffled over its own items and
// any remainder bytes < itemsize are stored verbatim at the block's end).
//
// dst must hold nblocks * ce5g_bound(block_size) bytes; block_sizes must
// hold nblocks int64s. Blocks are written PACKED in order (block i starts
// at sum of block_sizes[0..i)). Returns total compressed bytes, or -1 on
// compression error / -2 on bad args.
int64_t ce5g_compress(const uint8_t* src, int64_t n, int64_t block_size,
                      int level, int itemsize, int nthreads, uint8_t* dst,
                      int64_t* block_sizes) {
  if (n < 0 || block_size <= 0 || itemsize <= 0 ||
      (itemsize > 1 && block_size % itemsize != 0))
    return -2;
  const int64_t nblocks = n == 0 ? 0 : (n + block_size - 1) / block_size;
  const int64_t bound = ce5g_bound(block_size);
  std::atomic<bool> failed{false};

  // Stage compressed blocks at stride `bound`, then pack afterwards.
  std::vector<uint8_t> staged(static_cast<size_t>(nblocks * bound));

  run_pool(nthreads, nblocks, [&](int64_t i) {
    if (failed.load(std::memory_order_relaxed)) return;
    const int64_t off = i * block_size;
    const int64_t len = std::min(block_size, n - off);
    const uint8_t* in = src + off;
    std::vector<uint8_t> shuf;
    if (itemsize > 1) {
      shuf.resize(len);
      const int64_t items = len / itemsize;
      const int64_t tail = len - items * itemsize;
      shuffle_bytes(in, shuf.data(), items, itemsize);
      if (tail) std::memcpy(shuf.data() + items * itemsize, in + items * itemsize, tail);
      in = shuf.data();
    }
    size_t c = ZSTD_compress(staged.data() + i * bound, bound, in, len, level);
    if (ZSTD_isError(c)) {
      failed.store(true, std::memory_order_relaxed);
      return;
    }
    block_sizes[i] = static_cast<int64_t>(c);
  });
  if (failed.load()) return -1;

  int64_t total = 0;
  for (int64_t i = 0; i < nblocks; ++i) {
    std::memmove(dst + total, staged.data() + i * bound, block_sizes[i]);
    total += block_sizes[i];
  }
  return total;
}

// Decompress packed blocks back into `dst` (raw_total bytes). block_sizes
// as produced by ce5g_compress. Returns raw_total, or -1 on error.
int64_t ce5g_decompress(const uint8_t* src, const int64_t* block_sizes,
                        int64_t nblocks, int64_t block_size, int64_t raw_total,
                        int itemsize, int nthreads, uint8_t* dst) {
  if (raw_total < 0 || block_size <= 0 || itemsize <= 0 ||
      (itemsize > 1 && block_size % itemsize != 0))
    return -2;
  std::vector<int64_t> src_off(nblocks + 1, 0);
  for (int64_t i = 0; i < nblocks; ++i) src_off[i + 1] = src_off[i] + block_sizes[i];
  std::atomic<bool> failed{false};

  run_pool(nthreads, nblocks, [&](int64_t i) {
    if (failed.load(std::memory_order_relaxed)) return;
    const int64_t off = i * block_size;
    const int64_t len = std::min(block_size, raw_total - off);
    std::vector<uint8_t> tmp;
    uint8_t* out = dst + off;
    if (itemsize > 1) {
      tmp.resize(len);
      out = tmp.data();
    }
    size_t d = ZSTD_decompress(out, len, src + src_off[i], block_sizes[i]);
    if (ZSTD_isError(d) || static_cast<int64_t>(d) != len) {
      failed.store(true, std::memory_order_relaxed);
      return;
    }
    if (itemsize > 1) {
      const int64_t items = len / itemsize;
      const int64_t tail = len - items * itemsize;
      unshuffle_bytes(tmp.data(), dst + off, items, itemsize);
      if (tail)
        std::memcpy(dst + off + items * itemsize, tmp.data() + items * itemsize,
                    tail);
    }
  });
  return failed.load() ? -1 : raw_total;
}

}  // extern "C"
