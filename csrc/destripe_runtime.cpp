// Native runtime for aind_smartspim_destripe_tpu: blosc1 chunk codec
// (byte/bit-shuffle + zstd via system libzstd).
//
// This is the hot host-side path of the streaming pipeline: every Zarr chunk
// read/written crosses this codec. Calls are made through ctypes (which drops
// the GIL), so a Python thread pool fans chunk encode/decode across cores.
//
// Frame format: c-blosc 1.x (see io/blosc.py docstring). Flags bit 0x10
// advertises the non-split block layout used by zstd frames.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <algorithm>
#include <vector>
#include <thread>
#include <atomic>

#if __has_include(<zstd.h>) && !defined(DESTRIPE_DECLARE_ZSTD)
#define ZSTD_STATIC_LINKING_ONLY  // ZSTD_c_literalCompressionMode
#include <zstd.h>
#else
// Hosts that ship only the zstd runtime library (libzstd.so.1) lack the
// development header. Declare the subset used here, with the values of
// zstd.h 1.5 (ZSTD_c_literalCompressionMode is ZSTD_c_experimentalParam5;
// a library that does not know it rejects the parameter and keeps its
// default literal coding, which only costs ratio on the gated planes).
extern "C" {
typedef struct ZSTD_CCtx_s ZSTD_CCtx;
typedef struct ZSTD_DCtx_s ZSTD_DCtx;
typedef enum {
  ZSTD_c_compressionLevel = 100,
  ZSTD_c_literalCompressionMode = 1002,
} ZSTD_cParameter;
typedef enum {
  ZSTD_reset_session_only = 1,
  ZSTD_reset_parameters = 2,
  ZSTD_reset_session_and_parameters = 3,
} ZSTD_ResetDirective;
typedef enum { ZSTD_ps_auto = 0, ZSTD_ps_enable = 1, ZSTD_ps_disable = 2 }
    ZSTD_paramSwitch_e;
ZSTD_CCtx* ZSTD_createCCtx(void);
size_t ZSTD_freeCCtx(ZSTD_CCtx* cctx);
ZSTD_DCtx* ZSTD_createDCtx(void);
size_t ZSTD_freeDCtx(ZSTD_DCtx* dctx);
size_t ZSTD_CCtx_reset(ZSTD_CCtx* cctx, ZSTD_ResetDirective reset);
size_t ZSTD_CCtx_setParameter(ZSTD_CCtx* cctx, ZSTD_cParameter param,
                              int value);
size_t ZSTD_compress2(ZSTD_CCtx* cctx, void* dst, size_t dstCapacity,
                      const void* src, size_t srcSize);
size_t ZSTD_decompressDCtx(ZSTD_DCtx* dctx, void* dst, size_t dstCapacity,
                           const void* src, size_t srcSize);
unsigned ZSTD_isError(size_t code);
}
#endif

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr size_t kHeaderSize = 16;
constexpr size_t kDefaultBlock = 1 << 18;  // 256 KiB

inline void store_u32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xff; p[1] = (v >> 8) & 0xff; p[2] = (v >> 16) & 0xff; p[3] = (v >> 24) & 0xff;
}
inline uint32_t load_u32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

// --- SIMD byte (de)interleave ------------------------------------------------
// typesize 2 is the pipeline's hot case (every uint16 Zarr chunk); typesize 4
// composes from two stride-2 stages. Scalar loops remain as the generic
// fallback and the sub-vector tail. AVX2 bodies compile away on other ISAs.

// dst[0..nelem) = src[2i], dst[nelem..2*nelem) = src[2i+1]
void deinterleave2(const uint8_t* src, uint8_t* d0, uint8_t* d1,
                   size_t nelem) {
  size_t i = 0;
#if defined(__AVX2__)
  const __m256i mask = _mm256_set1_epi16(0x00FF);
  for (; i + 32 <= nelem; i += 32) {
    __m256i a = _mm256_loadu_si256((const __m256i*)(src + 2 * i));
    __m256i b = _mm256_loadu_si256((const __m256i*)(src + 2 * i + 32));
    __m256i ev = _mm256_packus_epi16(_mm256_and_si256(a, mask),
                                     _mm256_and_si256(b, mask));
    __m256i od = _mm256_packus_epi16(_mm256_srli_epi16(a, 8),
                                     _mm256_srli_epi16(b, 8));
    // packus works per 128-bit lane: un-cross the qwords
    ev = _mm256_permute4x64_epi64(ev, 0xD8);
    od = _mm256_permute4x64_epi64(od, 0xD8);
    _mm256_storeu_si256((__m256i*)(d0 + i), ev);
    _mm256_storeu_si256((__m256i*)(d1 + i), od);
  }
#endif
  for (; i < nelem; ++i) { d0[i] = src[2 * i]; d1[i] = src[2 * i + 1]; }
}

// dst[2i] = s0[i], dst[2i+1] = s1[i]
void interleave2(const uint8_t* s0, const uint8_t* s1, uint8_t* dst,
                 size_t nelem) {
  size_t i = 0;
#if defined(__AVX2__)
  for (; i + 32 <= nelem; i += 32) {
    __m256i a = _mm256_permute4x64_epi64(
        _mm256_loadu_si256((const __m256i*)(s0 + i)), 0xD8);
    __m256i b = _mm256_permute4x64_epi64(
        _mm256_loadu_si256((const __m256i*)(s1 + i)), 0xD8);
    _mm256_storeu_si256((__m256i*)(dst + 2 * i),
                        _mm256_unpacklo_epi8(a, b));
    _mm256_storeu_si256((__m256i*)(dst + 2 * i + 32),
                        _mm256_unpackhi_epi8(a, b));
  }
#endif
  for (; i < nelem; ++i) { dst[2 * i] = s0[i]; dst[2 * i + 1] = s1[i]; }
}

// 16-bit-element variants for the typesize-4 two-stage decomposition.
void deinterleave2_u16(const uint8_t* src, uint8_t* d0, uint8_t* d1,
                       size_t nelem) {  // nelem 16-bit pairs
  size_t i = 0;
#if defined(__AVX2__)
  const __m256i mask = _mm256_set1_epi32(0x0000FFFF);
  for (; i + 16 <= nelem; i += 16) {
    __m256i a = _mm256_loadu_si256((const __m256i*)(src + 4 * i));
    __m256i b = _mm256_loadu_si256((const __m256i*)(src + 4 * i + 32));
    __m256i ev = _mm256_packus_epi32(_mm256_and_si256(a, mask),
                                     _mm256_and_si256(b, mask));
    __m256i od = _mm256_packus_epi32(_mm256_srli_epi32(a, 16),
                                     _mm256_srli_epi32(b, 16));
    ev = _mm256_permute4x64_epi64(ev, 0xD8);
    od = _mm256_permute4x64_epi64(od, 0xD8);
    _mm256_storeu_si256((__m256i*)(d0 + 2 * i), ev);
    _mm256_storeu_si256((__m256i*)(d1 + 2 * i), od);
  }
#endif
  for (; i < nelem; ++i) {
    d0[2 * i] = src[4 * i];     d0[2 * i + 1] = src[4 * i + 1];
    d1[2 * i] = src[4 * i + 2]; d1[2 * i + 1] = src[4 * i + 3];
  }
}

void interleave2_u16(const uint8_t* s0, const uint8_t* s1, uint8_t* dst,
                     size_t nelem) {
  size_t i = 0;
#if defined(__AVX2__)
  for (; i + 16 <= nelem; i += 16) {
    __m256i a = _mm256_permute4x64_epi64(
        _mm256_loadu_si256((const __m256i*)(s0 + 2 * i)), 0xD8);
    __m256i b = _mm256_permute4x64_epi64(
        _mm256_loadu_si256((const __m256i*)(s1 + 2 * i)), 0xD8);
    _mm256_storeu_si256((__m256i*)(dst + 4 * i),
                        _mm256_unpacklo_epi16(a, b));
    _mm256_storeu_si256((__m256i*)(dst + 4 * i + 32),
                        _mm256_unpackhi_epi16(a, b));
  }
#endif
  for (; i < nelem; ++i) {
    dst[4 * i] = s0[2 * i];     dst[4 * i + 1] = s0[2 * i + 1];
    dst[4 * i + 2] = s1[2 * i]; dst[4 * i + 3] = s1[2 * i + 1];
  }
}

// Per-thread scratch for the typesize-4 two-stage shuffle.
thread_local std::vector<uint8_t> g_shuf_tmp;

void byte_shuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t ts) {
  if (ts <= 1 || n < ts) { std::memcpy(dst, src, n); return; }
  const size_t nelem = n / ts;
  if (ts == 2) {
    deinterleave2(src, dst, dst + nelem, nelem);
  } else if (ts == 4) {
    // stage 1: split 16-bit halves (planes {b0b1}, {b2b3}); stage 2: split
    // bytes of each half -> planes b0 b1 b2 b3
    if (g_shuf_tmp.size() < nelem * 4) g_shuf_tmp.resize(nelem * 4);
    uint8_t* t = g_shuf_tmp.data();
    deinterleave2_u16(src, t, t + 2 * nelem, nelem);
    deinterleave2(t, dst, dst + nelem, nelem);
    deinterleave2(t + 2 * nelem, dst + 2 * nelem, dst + 3 * nelem, nelem);
  } else {
    for (size_t j = 0; j < ts; ++j) {
      const uint8_t* s = src + j;
      uint8_t* d = dst + j * nelem;
      for (size_t i = 0; i < nelem; ++i) d[i] = s[i * ts];
    }
  }
  std::memcpy(dst + nelem * ts, src + nelem * ts, n - nelem * ts);
}

void byte_unshuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t ts) {
  if (ts <= 1 || n < ts) { std::memcpy(dst, src, n); return; }
  const size_t nelem = n / ts;
  if (ts == 2) {
    interleave2(src, src + nelem, dst, nelem);
  } else if (ts == 4) {
    if (g_shuf_tmp.size() < nelem * 4) g_shuf_tmp.resize(nelem * 4);
    uint8_t* t = g_shuf_tmp.data();
    interleave2(src, src + nelem, t, nelem);
    interleave2(src + 2 * nelem, src + 3 * nelem, t + 2 * nelem, nelem);
    interleave2_u16(t, t + 2 * nelem, dst, nelem);
  } else {
    for (size_t j = 0; j < ts; ++j) {
      const uint8_t* s = src + j * nelem;
      uint8_t* d = dst + j;
      for (size_t i = 0; i < nelem; ++i) d[i * ts] = s[i];
    }
  }
  std::memcpy(dst + nelem * ts, src + nelem * ts, n - nelem * ts);
}

// 8x8 bit-matrix transpose (Hacker's Delight). With rows packed as the bytes
// of x (row i = byte i, bit j = column j), output byte b holds, at bit j,
// bit b of input byte j.
inline uint64_t trans_bit_8x8(uint64_t x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAULL; x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCULL; x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ULL; x = x ^ t ^ (t << 28);
  return x;
}

// c-blosc bitshuffle of one block: full bit-plane transpose (bit b of every
// element grouped, LSB-first) — but ONLY when the block is a whole number of
// 8-element groups; c-blosc's shuffle.c passes unaligned blocks through
// unchanged (verified against libblosc with crafted raw-stored frames).
// Bytes of a block c-blosc's bitshuffle actually bit-transposes: iff the
// whole-element count (n/ts) is a multiple of 8 (any typesize), the
// transpose covers those elements and the sub-element tail (n % ts bytes,
// ragged final block only) is memcpy'd raw behind it; otherwise the whole
// block passes through raw (c-blosc 1.x shuffle.c, verified against
// libblosc 1.21 frames both ways).
static size_t bitshuffle_extent(size_t n, size_t ts) {
  if (ts < 1) return 0;
  const size_t nelem = n / ts;
  if (nelem == 0 || nelem % 8 != 0) return 0;
  return nelem * ts;
}

void bit_shuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t ts) {
  const size_t aligned = bitshuffle_extent(n, ts);
  if (aligned == 0) { std::memcpy(dst, src, n); return; }
  if (aligned < n) std::memcpy(dst + aligned, src + aligned, n - aligned);
  n = aligned;
  const size_t ngroups = n / (ts * 8);
  for (size_t g = 0; g < ngroups; ++g) {
    const uint8_t* base = src + g * 8 * ts;
    for (size_t k = 0; k < ts; ++k) {
      uint64_t x = 0;
      for (size_t j = 0; j < 8; ++j)
        x |= uint64_t(base[j * ts + k]) << (8 * j);
      x = trans_bit_8x8(x);
      for (size_t b = 0; b < 8; ++b) {
        dst[(k * 8 + b) * ngroups + g] = uint8_t(x & 0xff);
        x >>= 8;
      }
    }
  }
}

void bit_unshuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t ts) {
  const size_t aligned = bitshuffle_extent(n, ts);
  if (aligned == 0) { std::memcpy(dst, src, n); return; }
  if (aligned < n) std::memcpy(dst + aligned, src + aligned, n - aligned);
  n = aligned;
  const size_t ngroups = n / (ts * 8);
  for (size_t g = 0; g < ngroups; ++g) {
    uint8_t* base = dst + g * 8 * ts;
    for (size_t k = 0; k < ts; ++k) {
      uint64_t x = 0;
      for (size_t b = 0; b < 8; ++b)
        x |= uint64_t(src[(k * 8 + b) * ngroups + g]) << (8 * b);
      x = trans_bit_8x8(x);
      for (size_t j = 0; j < 8; ++j) {
        base[j * ts + k] = uint8_t(x & 0xff);
        x >>= 8;
      }
    }
  }
}

// Per-thread ZSTD contexts: ZSTD_compress/ZSTD_decompress allocate and
// tear down a full context (~MBs of tables) per call, which costs ~10-15%
// at 256 KiB blocks. One context per pool thread, freed at thread exit.
struct CCtxHolder {
  ZSTD_CCtx* c = nullptr;
  ~CCtxHolder() { if (c) ZSTD_freeCCtx(c); }
};
struct DCtxHolder {
  ZSTD_DCtx* d = nullptr;
  ~DCtxHolder() { if (d) ZSTD_freeDCtx(d); }
};
ZSTD_CCtx* tls_cctx() {
  thread_local CCtxHolder h;
  if (!h.c) h.c = ZSTD_createCCtx();
  return h.c;
}
ZSTD_DCtx* tls_dctx() {
  thread_local DCtxHolder h;
  if (!h.d) h.d = ZSTD_createDCtx();
  return h.d;
}

// Sampled byte entropy (bits/byte) over ~8 KiB of stride-spaced 64-byte runs.
// Cheap compressibility probe: ~5 us per 256 KiB block.
double sampled_entropy(const uint8_t* p, size_t n) {
  uint32_t hist[256] = {0};
  size_t total;
  constexpr size_t kRun = 64, kRuns = 128;  // 8 KiB sample
  if (n <= kRun * kRuns) {
    for (size_t i = 0; i < n; ++i) ++hist[p[i]];
    total = n;
  } else {
    const size_t stride = (n - kRun) / (kRuns - 1);
    for (size_t r = 0; r < kRuns; ++r) {
      const uint8_t* q = p + r * stride;
      for (size_t i = 0; i < kRun; ++i) ++hist[q[i]];
    }
    total = kRun * kRuns;
  }
  if (!total) return 0.0;
  double h = 0.0;
  const double inv = 1.0 / double(total);
  for (int i = 0; i < 256; ++i)
    if (hist[i]) {
      const double pr = hist[i] * inv;
      h -= pr * std::log2(pr);
    }
  return h;
}

// Literal-Huffman gate for the byte-shuffled uint16 hot path. After the
// per-block shuffle the block is [low-byte plane | high-byte plane]. On
// real microscopy planes the low half is shot-noise (near 8 bits/byte —
// zstd's Huffman pass burns ~60% of encode time discovering it cannot
// code it) while the high half is smooth (match-dominated, few literals).
// Only for that shape is disabling literal compression a measured win
// (+15-19% encode at -0.6% ratio on stripes chunks, hot-cache C A/B
// best-of-40 x5 alternations); dim planes (signal lives in the low byte,
// H_lo ~6.4) and cell/gradient planes (high half carries literal
// structure) keep Huffman on. Thresholds from measured half-entropies at
// production chunk geometry: stripes H_lo 7.6-7.9 / H_hi 0.2-0.9;
// cells H_hi 2.0-2.7, smooth-gradient H_hi 1.9, dim H_lo 6.3-6.5 — the
// 7.3/1.5 cut separates all four with margin, and a misjudged block
// costs only that block's literal coding (<1% of its bytes).
// DESTRIPE_ZSTD_ADAPTIVE=0 disables the probe.
bool literals_wasted(const uint8_t* shuffled, size_t neblock, size_t ts) {
  if (ts != 2 || neblock < 4096) return false;
  const size_t half = neblock / 2;
  return sampled_entropy(shuffled, half) > 7.3 &&
         sampled_entropy(shuffled + half, neblock - half) < 1.5;
}

bool adaptive_literals() {
  static const bool on = [] {
    const char* e = std::getenv("DESTRIPE_ZSTD_ADAPTIVE");
    return !(e && *e == '0');
  }();
  return on;
}

size_t pick_blocksize(size_t nbytes, size_t ts, bool bitshuf) {
  size_t bs = std::min(kDefaultBlock, nbytes ? nbytes : size_t(1));
  // Element-aligned blocks; bitshuffle wants whole 8-element groups so the
  // non-final blocks actually get transposed.
  const size_t align = bitshuf ? ts * 8 : ts;
  bs = std::max(bs, align);
  if (align > 1) bs -= bs % align;
  bs = std::max(bs, align);
  // c-blosc rejects frames whose header blocksize exceeds nbytes.
  if (nbytes && bs > nbytes) bs = nbytes;
  return bs;
}

}  // namespace

extern "C" {

// Encode one blosc1 frame. shuffle: 0=none, 1=byte, 2=bit. Returns frame
// length or negative on error (-1 dest too small, -2 bad args).
long long blosc1_compress(const char* src_, size_t nbytes, int typesize,
                          int clevel, int shuffle, char* dst_, size_t dstsize) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(src_);
  uint8_t* dst = reinterpret_cast<uint8_t*>(dst_);
  if (typesize < 1 || typesize > 255 || nbytes > 0xffffffffULL) return -2;
  if (dstsize < kHeaderSize + nbytes + 4096) return -1;

  const size_t ts = size_t(typesize);
  const bool do_bitshuffle = (shuffle == 2);
  const size_t bs = pick_blocksize(nbytes, ts, do_bitshuffle);
  const size_t nblocks = nbytes ? (nbytes + bs - 1) / bs : 1;

  uint8_t flags = 0x10;  // non-split layout
  const bool do_shuffle = (shuffle == 1) && typesize > 1;
  if (do_shuffle) flags |= 0x01;
  if (do_bitshuffle) flags |= 0x04;
  flags |= 4 << 5;  // zstd

  dst[0] = 2; dst[1] = 1; dst[2] = flags; dst[3] = uint8_t(typesize);
  store_u32(dst + 4, uint32_t(nbytes));
  store_u32(dst + 8, uint32_t(bs));

  // Internal zstd level map (the frame is self-describing, so this is a
  // codec tuning knob, exactly as c-blosc remaps its clevel to codec
  // levels): on byte-shuffled uint16 microscopy planes zstd-1 measures
  // equal-or-BETTER ratio than zstd-3 (4.34 vs 3.72 on dim noisy planes,
  // 1.96 vs 1.96 on cell-rich ones) at 1.2-5x the speed — level 3's lazy
  // matching buys nothing on byte-plane content. Higher clevels pass
  // through for callers that ask for deep compression.
  // DESTRIPE_ZSTD_LEVEL overrides the fast-path level (negative = zstd
  // --fast: ~1.8x encode speed at a few % ratio on these planes).
  static const int fast_level = [] {
    const char* e = std::getenv("DESTRIPE_ZSTD_LEVEL");
    return e && *e ? atoi(e) : 1;
  }();
  const int zlevel = clevel <= 3 ? fast_level : clevel;
  size_t pos = kHeaderSize + 4 * nblocks;
  thread_local std::vector<uint8_t> work;
  if (work.size() < bs) work.resize(bs);
  ZSTD_CCtx* cctx = tls_cctx();

  for (size_t b = 0; b < nblocks; ++b) {
    const size_t off = b * bs;
    const size_t neblock = std::min(bs, nbytes - off);
    const uint8_t* blk = src + off;
    if (do_shuffle) {
      byte_shuffle(blk, work.data(), neblock, ts);
      blk = work.data();
    } else if (do_bitshuffle) {
      bit_shuffle(blk, work.data(), neblock, ts);
      blk = work.data();
    }
    // compress straight into the frame (no bounce buffer): the caller's
    // capacity contract (nbytes + 4 KiB slack) caps the payload at
    // neblock, so a too-big result falls back to a raw store exactly like
    // the csize >= neblock case
    if (pos + 4 + neblock > dstsize) return -1;
    // Advanced one-shot API so the literal-Huffman pass can be gated per
    // block (see literals_wasted). Only the fast tier probes: clevel > 3
    // callers asked for depth, leave their streams untouched.
    ZSTD_CCtx_reset(cctx, ZSTD_reset_session_and_parameters);
    ZSTD_CCtx_setParameter(cctx, ZSTD_c_compressionLevel, zlevel);
    if (do_shuffle && clevel <= 3 && adaptive_literals() &&
        literals_wasted(blk, neblock, ts))
      ZSTD_CCtx_setParameter(cctx, ZSTD_c_literalCompressionMode,
                             ZSTD_ps_disable);
    size_t plen =
        ZSTD_compress2(cctx, dst + pos + 4, neblock, blk, neblock);
    if (ZSTD_isError(plen) || plen >= neblock) {
      std::memcpy(dst + pos + 4, blk, neblock);  // stored raw
      plen = neblock;
    }
    store_u32(dst + kHeaderSize + 4 * b, uint32_t(pos));
    store_u32(dst + pos, uint32_t(plen));
    pos += 4 + plen;
  }

  if (pos >= nbytes + kHeaderSize) {
    // Incompressible: memcpy frame.
    dst[2] = uint8_t((flags & 0xF0) | 0x02);
    store_u32(dst + 12, uint32_t(nbytes + kHeaderSize));
    std::memcpy(dst + kHeaderSize, src, nbytes);
    return (long long)(nbytes + kHeaderSize);
  }
  store_u32(dst + 12, uint32_t(pos));
  return (long long)pos;
}

// Raw LZ4 block decode (the stable public block format, shared by lz4 and
// lz4hc frames — compression level changes only the encoder's search).
// Dependency-free so the runtime links against libzstd alone. Returns bytes
// written or -1 on malformed input.
static long long lz4_block_decompress(const uint8_t* src, size_t slen,
                                      uint8_t* dst, size_t dcap) {
  size_t ip = 0, op = 0;
  while (ip < slen) {
    const uint8_t token = src[ip++];
    size_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= slen) return -1;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > slen || op + lit > dcap) return -1;
    std::memcpy(dst + op, src + ip, lit);
    ip += lit;
    op += lit;
    if (ip >= slen) break;  // final sequence carries literals only
    if (ip + 2 > slen) return -1;
    const size_t off = src[ip] | (size_t(src[ip + 1]) << 8);
    ip += 2;
    if (off == 0 || off > op) return -1;
    size_t mlen = token & 0x0F;
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= slen) return -1;
        b = src[ip++];
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (op + mlen > dcap) return -1;
    const uint8_t* m = dst + op - off;
    if (off >= mlen) {
      std::memcpy(dst + op, m, mlen);
    } else {  // overlapping match: byte-serial self-reference
      for (size_t k = 0; k < mlen; ++k) dst[op + k] = m[k];
    }
    op += mlen;
  }
  return (long long)op;
}

// Decode one blosclz block (c-blosc's own default codec, FastLZ-derived
// format version 1). Near matches: distance = ((ctrl & 31) << 8) + code + 1;
// far matches (code == 255 with the 13-bit offset saturated): two extra
// bytes, distance = ofs16 + 8192. Pinned empirically against libblosc 1.21
// streams. Returns bytes written or -1 on malformed input.
static long long blosclz_block_decompress(const uint8_t* src, size_t slen,
                                          uint8_t* dst, size_t dcap) {
  if (slen == 0) return -1;
  size_t ip = 0, op = 0;
  uint32_t ctrl = src[ip++] & 31;
  while (true) {
    if (ctrl < 32) {
      const size_t lit = size_t(ctrl) + 1;
      if (ip + lit > slen || op + lit > dcap) return -1;
      std::memcpy(dst + op, src + ip, lit);
      ip += lit;
      op += lit;
    } else {
      size_t mlen = (ctrl >> 5) - 1;
      const uint32_t ofs = (ctrl & 31) << 8;
      if (mlen == 6) {
        uint8_t c;
        do {
          if (ip >= slen) return -1;
          c = src[ip++];
          mlen += c;
        } while (c == 255);
      }
      if (ip >= slen) return -1;
      const uint8_t code = src[ip++];
      size_t dist;
      if (code == 255 && ofs == (31u << 8)) {
        if (ip + 2 > slen) return -1;
        dist = ((size_t(src[ip]) << 8) | src[ip + 1]) + 8192;
        ip += 2;
      } else {
        dist = size_t(ofs) + code + 1;
      }
      mlen += 3;
      if (dist > op || op + mlen > dcap) return -1;
      const uint8_t* m = dst + op - dist;
      if (dist >= mlen) {
        std::memcpy(dst + op, m, mlen);
      } else {  // overlapping match: byte-serial self-reference
        for (size_t k = 0; k < mlen; ++k) dst[op + k] = m[k];
      }
      op += mlen;
    }
    if (ip >= slen) break;
    ctrl = src[ip++];
  }
  return (long long)op;
}

// Decode one raw snappy block (public format: varint uncompressed length,
// then literal/copy elements). Returns bytes written or -1 on malformed
// input.
static long long snappy_block_decompress(const uint8_t* src, size_t slen,
                                         uint8_t* dst, size_t dcap) {
  size_t ip = 0, op = 0;
  uint64_t ulen = 0;
  int shift = 0;
  while (true) {
    if (ip >= slen || shift > 32) return -1;
    const uint8_t b = src[ip++];
    ulen |= uint64_t(b & 0x7F) << shift;
    shift += 7;
    if (!(b & 0x80)) break;
  }
  if (ulen != dcap) return -1;
  while (ip < slen) {
    const uint8_t tag = src[ip++];
    const int kind = tag & 0x03;
    if (kind == 0) {  // literal
      size_t ln = tag >> 2;
      if (ln >= 60) {
        const size_t nb = ln - 59;
        if (ip + nb > slen) return -1;
        ln = 0;
        for (size_t k = 0; k < nb; ++k) ln |= size_t(src[ip + k]) << (8 * k);
        ip += nb;
      }
      ln += 1;
      if (ip + ln > slen || op + ln > dcap) return -1;
      std::memcpy(dst + op, src + ip, ln);
      ip += ln;
      op += ln;
      continue;
    }
    size_t ln, off;
    if (kind == 1) {
      if (ip >= slen) return -1;
      ln = ((tag >> 2) & 0x07) + 4;
      off = (size_t(tag >> 5) << 8) | src[ip++];
    } else if (kind == 2) {
      if (ip + 2 > slen) return -1;
      ln = (tag >> 2) + 1;
      off = size_t(src[ip]) | (size_t(src[ip + 1]) << 8);
      ip += 2;
    } else {
      if (ip + 4 > slen) return -1;
      ln = (tag >> 2) + 1;
      off = size_t(src[ip]) | (size_t(src[ip + 1]) << 8) |
            (size_t(src[ip + 2]) << 16) | (size_t(src[ip + 3]) << 24);
      ip += 4;
    }
    if (off == 0 || off > op || op + ln > dcap) return -1;
    const uint8_t* m = dst + op - off;
    if (off >= ln) {
      std::memcpy(dst + op, m, ln);
    } else {
      for (size_t k = 0; k < ln; ++k) dst[op + k] = m[k];
    }
    op += ln;
  }
  return (long long)op;
}

// Decode one blosc1 frame (zstd/lz4/lz4hc/blosclz/snappy or memcpy;
// byte/bit shuffle; the "split" sub-stream layout of c-blosc writers).
// Returns the number of bytes written or negative on error.
long long blosc1_decompress(const char* src_, size_t srclen, char* dst_,
                            size_t dstsize) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(src_);
  uint8_t* dst = reinterpret_cast<uint8_t*>(dst_);
  if (srclen < kHeaderSize) return -2;
  const uint8_t flags = src[2];
  const size_t ts = src[3];
  const size_t nbytes = load_u32(src + 4);
  const size_t bs = load_u32(src + 8);
  if (dstsize < nbytes) return -1;

  if (flags & 0x02) {  // memcpyed
    if (srclen < kHeaderSize + nbytes) return -2;
    std::memcpy(dst, src + kHeaderSize, nbytes);
    return (long long)nbytes;
  }
  const int codec = (flags >> 5) & 0x7;
  if (codec != 4 && codec != 1 && codec != 0 && codec != 2)
    return -3;  // zstd + lz4/lz4hc + blosclz + snappy decode
  if (bs == 0) return -2;  // corrupt header: nblocks division below

  const size_t nblocks = nbytes ? (nbytes + bs - 1) / bs : 1;
  if (srclen < kHeaderSize + 4 * nblocks) return -2;

  // c-blosc lz4/blosclz writers "split" each full block into ts
  // independently-coded sub-streams; >= 1.14 advertises non-split with
  // flag 0x10 (blosc_d's exact conditions mirrored here)
  const bool may_split = !(flags & 0x10) && ts > 1 && ts <= 16 &&
                         bs % ts == 0 && bs / ts >= 128;
  const bool shuffled = (flags & 0x01) || (flags & 0x04);
  thread_local std::vector<uint8_t> work;
  if (shuffled && work.size() < bs) work.resize(bs);
  ZSTD_DCtx* dctx = tls_dctx();
  for (size_t b = 0; b < nblocks; ++b) {
    const size_t out_off = b * bs;
    const size_t neblock = std::min(bs, nbytes - out_off);
    uint8_t* out = shuffled ? work.data() : dst + out_off;
    const size_t nsplits = (may_split && neblock == bs) ? ts : 1;
    const size_t ssize = neblock / nsplits;
    size_t p = load_u32(src + kHeaderSize + 4 * b);
    for (size_t j = 0; j < nsplits; ++j) {
      if (p + 4 > srclen) return -2;
      const size_t csize = load_u32(src + p);
      if (p + 4 + csize > srclen) return -2;
      uint8_t* outj = out + j * ssize;
      if (csize == ssize) {
        std::memcpy(outj, src + p + 4, ssize);
      } else if (codec == 4) {
        const size_t r =
            ZSTD_decompressDCtx(dctx, outj, ssize, src + p + 4, csize);
        if (ZSTD_isError(r) || r != ssize) return -4;
      } else {
        long long r;
        if (codec == 1)
          r = lz4_block_decompress(src + p + 4, csize, outj, ssize);
        else if (codec == 0)
          r = blosclz_block_decompress(src + p + 4, csize, outj, ssize);
        else
          r = snappy_block_decompress(src + p + 4, csize, outj, ssize);
        if (r != (long long)ssize) return -4;
      }
      p += 4 + csize;
    }
    if (flags & 0x01) byte_unshuffle(work.data(), dst + out_off, neblock, ts);
    else if (flags & 0x04) bit_unshuffle(work.data(), dst + out_off, neblock, ts);
  }
  return (long long)nbytes;
}

// Parallel batch encode: n frames, concatenated IO through offset arrays.
// Returns 0 on success; per-frame lengths written to out_lens.
int blosc1_compress_batch(int n, const char** srcs, const size_t* lens,
                          int typesize, int clevel, int shuffle, char** dsts,
                          const size_t* dst_caps, long long* out_lens,
                          int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  std::atomic_int next_idx{0};
  auto worker = [&]() {
    for (;;) {
      int i = next_idx.fetch_add(1);
      if (i >= n) return;
      out_lens[i] = blosc1_compress(srcs[i], lens[i], typesize, clevel, shuffle,
                                    dsts[i], dst_caps[i]);
    }
  };
  const int nt = std::min(n, n_threads);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; ++i)
    if (out_lens[i] < 0) return int(out_lens[i]);
  return 0;
}

// --- Strided slab <-> chunk-grid codecs --------------------------------------
// The streaming pipeline's slab writes/reads move (64, H, W) uint16 slabs
// against a (cz, cy, cx) chunk grid. Routing each chunk through a separate
// gather copy (numpy "assemble"/scatter) costs a full extra pass over the
// slab through cold memory (~0.32 s per 400 MB slab measured on the dev
// host). These entry points fuse the gather/scatter with the codec: each
// worker copies one chunk's rows into a thread-local buffer (pad cells =
// fill) and encodes while the bytes are still cache-hot — one pass, no
// intermediate chunk array, no per-chunk Python.
//
// Grid order matches numpy np.ndindex (C order over the chunk grid):
// i = (gz * ny + gy) * nx + gx. Strides are in BYTES; x must be contiguous
// (stride_x == typesize). `fill`'s low `typesize` bytes pattern pad cells.

namespace {

inline void fill_bytes(uint8_t* dst, size_t nbytes, unsigned long long fill,
                       int typesize) {
  uint8_t pat[8];
  for (int k = 0; k < typesize; ++k) pat[k] = (fill >> (8 * k)) & 0xff;
  bool uniform = true;
  for (int k = 1; k < typesize; ++k) uniform &= (pat[k] == pat[0]);
  if (uniform) {
    std::memset(dst, pat[0], nbytes);
    return;
  }
  for (size_t i = 0; i < nbytes; i += typesize)
    std::memcpy(dst + i, pat, std::min<size_t>(typesize, nbytes - i));
}

}  // namespace

// Gather each grid chunk from the strided slab and encode it. One dst/cap
// per chunk, grid order as above. Returns 0 or the first error code.
int blosc1_compress_slab(const char* base, long long sz, long long sy,
                         long long sx, long long stride_z, long long stride_y,
                         int cz, int cy, int cx, int typesize, int clevel,
                         int shuffle, unsigned long long fill, char** dsts,
                         const size_t* dst_caps, long long* out_lens,
                         int n_threads) {
  const long long nz = (sz + cz - 1) / cz, ny = (sy + cy - 1) / cy,
                  nx = (sx + cx - 1) / cx;
  const int n = int(nz * ny * nx);
  const size_t chunk_bytes = size_t(cz) * cy * cx * typesize;
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  std::atomic_int next_idx{0};
  auto worker = [&]() {
    thread_local std::vector<uint8_t> buf;
    if (buf.size() < chunk_bytes) buf.resize(chunk_bytes);
    for (;;) {
      int i = next_idx.fetch_add(1);
      if (i >= n) return;
      const long long gx = i % nx, gy = (i / nx) % ny, gz = i / (nx * ny);
      const long long z0 = gz * cz, y0 = gy * cy, x0 = gx * cx;
      const long long vz = std::min<long long>(cz, sz - z0);
      const long long vy = std::min<long long>(cy, sy - y0);
      const long long vx = std::min<long long>(cx, sx - x0);
      const size_t row_bytes = size_t(vx) * typesize;
      const size_t crow_bytes = size_t(cx) * typesize;
      const bool ragged = (vz < cz) || (vy < cy) || (vx < cx);
      if (ragged) fill_bytes(buf.data(), chunk_bytes, fill, typesize);
      for (long long z = 0; z < vz; ++z) {
        const char* srow = base + (z0 + z) * stride_z + y0 * stride_y +
                           x0 * typesize;
        uint8_t* drow = buf.data() + size_t(z) * cy * crow_bytes;
        for (long long y = 0; y < vy; ++y)
          std::memcpy(drow + size_t(y) * crow_bytes, srow + y * stride_y,
                      row_bytes);
      }
      out_lens[i] = blosc1_compress(reinterpret_cast<const char*>(buf.data()),
                                    chunk_bytes, typesize, clevel, shuffle,
                                    dsts[i], dst_caps[i]);
    }
  };
  const int nt = std::min(n, n_threads);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; ++i)
    if (out_lens[i] < 0) return int(out_lens[i]);
  return 0;
}

// Decode each grid chunk and scatter its valid extent into the strided
// slab; NULL srcs[i] marks a missing chunk (its slab region gets `fill`).
int blosc1_decompress_slab(const char** srcs, const size_t* lens, char* base,
                           long long sz, long long sy, long long sx,
                           long long stride_z, long long stride_y, int cz,
                           int cy, int cx, int typesize,
                           unsigned long long fill, int n_threads) {
  const long long nz = (sz + cz - 1) / cz, ny = (sy + cy - 1) / cy,
                  nx = (sx + cx - 1) / cx;
  const int n = int(nz * ny * nx);
  const size_t chunk_bytes = size_t(cz) * cy * cx * typesize;
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  std::atomic_int next_idx{0};
  std::atomic_int err{0};
  auto worker = [&]() {
    thread_local std::vector<uint8_t> buf;
    if (buf.size() < chunk_bytes) buf.resize(chunk_bytes);
    for (;;) {
      int i = next_idx.fetch_add(1);
      if (i >= n) return;
      const long long gx = i % nx, gy = (i / nx) % ny, gz = i / (nx * ny);
      const long long z0 = gz * cz, y0 = gy * cy, x0 = gx * cx;
      const long long vz = std::min<long long>(cz, sz - z0);
      const long long vy = std::min<long long>(cy, sy - y0);
      const long long vx = std::min<long long>(cx, sx - x0);
      const size_t row_bytes = size_t(vx) * typesize;
      const size_t crow_bytes = size_t(cx) * typesize;
      const bool missing = srcs[i] == nullptr;
      if (!missing) {
        long long r = blosc1_decompress(srcs[i], lens[i],
                                        reinterpret_cast<char*>(buf.data()),
                                        chunk_bytes);
        if (r != (long long)chunk_bytes) {
          err.store(int(r < 0 ? r : -4));
          return;
        }
      }
      for (long long z = 0; z < vz; ++z) {
        char* drow =
            base + (z0 + z) * stride_z + y0 * stride_y + x0 * typesize;
        const uint8_t* srow = buf.data() + size_t(z) * cy * crow_bytes;
        for (long long y = 0; y < vy; ++y) {
          if (missing)
            fill_bytes(reinterpret_cast<uint8_t*>(drow + y * stride_y),
                       row_bytes, fill, typesize);
          else
            std::memcpy(drow + y * stride_y, srow + size_t(y) * crow_bytes,
                        row_bytes);
        }
      }
    }
  };
  const int nt = std::min(n, n_threads);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return err.load();
}

int blosc1_decompress_batch(int n, const char** srcs, const size_t* lens,
                            char** dsts, const size_t* dst_caps,
                            long long* out_lens, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  std::atomic_int next_idx{0};
  auto worker = [&]() {
    for (;;) {
      int i = next_idx.fetch_add(1);
      if (i >= n) return;
      out_lens[i] = blosc1_decompress(srcs[i], lens[i], dsts[i], dst_caps[i]);
    }
  };
  const int nt = std::min(n, n_threads);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; ++i)
    if (out_lens[i] < 0) return int(out_lens[i]);
  return 0;
}

}  // extern "C"
