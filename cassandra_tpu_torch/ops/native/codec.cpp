// Native chunk codecs for the SSTable I/O path.
//
// Role parity: the reference's chunk codecs are JNI libraries (lz4-java,
// snappy-java, zstd-jni; see reference io/compress/LZ4Compressor.java:39,
// SnappyCompressor.java:33). Here they are first-party C++: LZ4 block
// format and Snappy raw format, implemented from the public format specs
// (lz4_Block_format.md; snappy/format_description.txt), exposed via a C ABI
// consumed with ctypes (ops/codec.py). Batch entry points compress many
// chunks per call so the Python layer crosses the FFI once per flush, not
// once per 16KiB chunk.
//
// Build: ops/native/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <cstddef>

#include <dlfcn.h>
#include <pthread.h>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------- LZ4 -----
// LZ4 block format: sequences of
//   [token][lit-len ext*][literals][offset LE16][match-len ext*]
// token = (lit_len<<4) | (match_len-4), nibble 15 => extension bytes.
// Constraints honoured: last sequence is literals-only; matches end >= 12
// bytes before the end; offset in [1, 65535].

static const int MINMATCH = 4;

// Restricted distance candidate set for the POLICY match search (see
// lz4_compress below). All short lags 1..64 (columnar 25-byte META
// strides, shuffled lane byte-planes, periodic text) plus power-of-two
// long lags up to the format's 64KiB window. Ascending order is load-
// bearing: ties on run length resolve to the SMALLEST distance.
static const int LZ4_NDIST = 73;
static const uint16_t LZ4_DIST[LZ4_NDIST] = {
     1,  2,  3,  4,  5,  6,  7,  8,  9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48,
    49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768};

// snappy's reference implementation sizes its table up to 2^14 —
// tuned separately from LZ4's (the measurements behind HASH_LOG=12
// were LZ4-only)
static const int SNAPPY_HASH_LOG = 14;

static inline uint32_t snappy_hash(uint32_t v) {
    return (v * 2654435761u) >> (32 - SNAPPY_HASH_LOG);
}

static inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

// worst-case compressed size (same bound as LZ4_compressBound)
int64_t lz4_max_compressed(int64_t n) {
    return n + n / 255 + 16;
}

// Deterministic POLICY encoder — returns compressed size, or -1 if dst
// too small.
//
// The device-side compressor (ops/device_compress.py) must emit blocks
// BYTE-IDENTICAL to this host encoder for any pool size × device on/off
// (check_compaction_ab.py's pinned contract), so the match search is a
// fixed policy rather than a hash-table heuristic: at every visited
// position take the longest forward run over the LZ4_DIST candidate
// set (ties → smallest distance), accept iff ≥ MINMATCH, else advance
// one byte. A hash-table matcher's output depends on probe/insertion
// order, which a data-parallel device scan cannot reproduce; an argmax
// over a fixed distance set is order-free and maps to one vectorized
// shifted-equality pass per distance.
static int64_t lz4_compress_policy(const uint8_t* src, int64_t srcLen,
                                   uint8_t* dst, int64_t dstCap) {
    if (srcLen == 0) {
        if (dstCap < 1) return -1;
        dst[0] = 0;  // token: 0 literals, no match
        return 1;
    }
    uint8_t* op = dst;
    uint8_t* oend = dst + dstCap;
    // matches may not start in the last 12 bytes (format rule); the
    // final 5 bytes must be literals
    const int64_t mflimit = srcLen - 12;
    int64_t pos = 0, anchor = 0;
    while (pos < mflimit) {
        const uint32_t cur = read32(src + pos);
        int64_t bestLen = 0, bestD = 0;
        for (int k = 0; k < LZ4_NDIST; k++) {
            const int64_t d = LZ4_DIST[k];
            if (d > pos) break;  // table ascends: rest are too far back
            // 4-byte prefilter: runs < MINMATCH are never accepted, so
            // skipping them leaves the policy's argmax unchanged
            if (read32(src + pos - d) != cur) continue;
            int64_t l = MINMATCH;
            while (pos + l < srcLen && src[pos - d + l] == src[pos + l])
                l++;
            if (l > bestLen) { bestLen = l; bestD = d; }
        }
        if (bestLen >= MINMATCH) {
            int64_t matchLen = bestLen;
            // clamp to the literal tail; pos < mflimit keeps the
            // clamped length ≥ 8 ≥ MINMATCH
            if (matchLen > srcLen - 5 - pos) matchLen = srcLen - 5 - pos;
            int64_t litLen = pos - anchor;
            int64_t need = 1 + litLen / 255 + 1 + litLen + 2 +
                           (matchLen - MINMATCH) / 255 + 1;
            if (op + need > oend) return -1;
            uint8_t* token = op++;
            if (litLen >= 15) {
                *token = 15 << 4;
                int64_t l = litLen - 15;
                while (l >= 255) { *op++ = 255; l -= 255; }
                *op++ = (uint8_t)l;
            } else {
                *token = (uint8_t)(litLen << 4);
            }
            memcpy(op, src + anchor, litLen);
            op += litLen;
            *op++ = (uint8_t)bestD;
            *op++ = (uint8_t)(bestD >> 8);
            int64_t ml = matchLen - MINMATCH;
            if (ml >= 15) {
                *token |= 15;
                ml -= 15;
                while (ml >= 255) { *op++ = 255; ml -= 255; }
                *op++ = (uint8_t)ml;
            } else {
                *token |= (uint8_t)ml;
            }
            pos += matchLen;
            anchor = pos;
        } else {
            pos++;
        }
    }
    // final literals
    int64_t litLen = srcLen - anchor;
    int64_t need = 1 + litLen / 255 + 1 + litLen;
    if (op + need > oend) return -1;
    uint8_t* token = op++;
    if (litLen >= 15) {
        *token = 15 << 4;
        int64_t l = litLen - 15;
        while (l >= 255) { *op++ = 255; l -= 255; }
        *op++ = (uint8_t)l;
    } else {
        *token = (uint8_t)(litLen << 4);
    }
    memcpy(op, src + anchor, litLen);
    op += litLen;
    return op - dst;
}

// first-party fallback — returns decompressed size, or -1 on
// malformed input / overflow
static int64_t lz4_decompress_fb(const uint8_t* src, int64_t srcLen,
                                 uint8_t* dst, int64_t dstCap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + srcLen;
    uint8_t* op = dst;
    uint8_t* oend = dst + dstCap;

    while (ip < iend) {
        uint8_t token = *ip++;
        // literals
        int64_t litLen = token >> 4;
        if (litLen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                litLen += b;
            } while (b == 255);
        }
        if (ip + litLen > iend || op + litLen > oend) return -1;
        memcpy(op, ip, litLen);
        ip += litLen;
        op += litLen;
        if (ip >= iend) break;  // last sequence has no match
        // match
        if (ip + 2 > iend) return -1;
        int64_t offset = ip[0] | (ip[1] << 8);
        ip += 2;
        if (offset == 0 || offset > op - dst) return -1;
        int64_t matchLen = (token & 15) + MINMATCH;
        if ((token & 15) == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                matchLen += b;
            } while (b == 255);
        }
        if (op + matchLen > oend) return -1;
        const uint8_t* match = op - offset;
        // overlapping copy must be byte-wise
        for (int64_t i = 0; i < matchLen; i++) op[i] = match[i];
        op += matchLen;
    }
    return op - dst;
}

// -------------------------------------------------------------- Snappy ----
// Raw snappy format: uvarint uncompressed length, then tagged elements:
//   tag&3 == 0: literal, len-1 in tag>>2 (60..63 => that many extra LE
//               length bytes)
//   tag&3 == 1: copy, len = 4 + ((tag>>2)&7), offset = ((tag>>5)<<8) | byte
//   tag&3 == 2: copy, len = 1 + (tag>>2), offset = LE16
//   tag&3 == 3: copy, len = 1 + (tag>>2), offset = LE32

int64_t snappy_max_compressed(int64_t n) {
    return 32 + n + n / 6;
}

static int64_t snappy_compress_fb(const uint8_t* src, int64_t srcLen,
                        uint8_t* dst, int64_t dstCap) {
    uint8_t* op = dst;
    uint8_t* oend = dst + dstCap;
    // uvarint length
    uint64_t v = (uint64_t)srcLen;
    do {
        if (op >= oend) return -1;
        uint8_t b = v & 0x7F;
        v >>= 7;
        *op++ = b | (v ? 0x80 : 0);
    } while (v);

    uint32_t table[1 << SNAPPY_HASH_LOG];
    memset(table, 0, sizeof(table));
    const uint8_t* ip = src;
    const uint8_t* anchor = src;
    const uint8_t* iend = src + srcLen;
    const uint8_t* limit = srcLen > 15 ? iend - 15 : src;

    auto emit_literal = [&](const uint8_t* from, int64_t len) -> bool {
        while (len > 0) {
            // largest emitted tag (62) carries 3 length bytes => n < 2^24
            int64_t chunk = len < (1 << 24) ? len : (1 << 24);
            int64_t n = chunk - 1;
            if (n < 60) {
                if (op + 1 + chunk > oend) return false;
                *op++ = (uint8_t)(n << 2);
            } else if (n < 256) {
                if (op + 2 + chunk > oend) return false;
                *op++ = 60 << 2;
                *op++ = (uint8_t)n;
            } else if (n < 65536) {
                if (op + 3 + chunk > oend) return false;
                *op++ = 61 << 2;
                *op++ = (uint8_t)n;
                *op++ = (uint8_t)(n >> 8);
            } else {
                if (op + 5 + chunk > oend) return false;
                *op++ = 62 << 2;
                *op++ = (uint8_t)n;
                *op++ = (uint8_t)(n >> 8);
                *op++ = (uint8_t)(n >> 16);
            }
            memcpy(op, from, chunk);
            op += chunk;
            from += chunk;
            len -= chunk;
        }
        return true;
    };
    auto emit_copy = [&](int64_t offset, int64_t len) -> bool {
        // len up to 64 per element; offset <= 65535 (we never match farther)
        while (len >= 68) {
            if (op + 3 > oend) return false;
            *op++ = (63 << 2) | 2;
            *op++ = (uint8_t)offset;
            *op++ = (uint8_t)(offset >> 8);
            len -= 64;
        }
        if (len > 64) {
            // emit 60, leave >= 4
            if (op + 3 > oend) return false;
            *op++ = (59 << 2) | 2;
            *op++ = (uint8_t)offset;
            *op++ = (uint8_t)(offset >> 8);
            len -= 60;
        }
        if (len >= 4 && len <= 11 && offset < 2048) {
            if (op + 2 > oend) return false;
            *op++ = (uint8_t)(((offset >> 8) << 5) | ((len - 4) << 2) | 1);
            *op++ = (uint8_t)offset;
        } else {
            if (op + 3 > oend) return false;
            *op++ = (uint8_t)(((len - 1) << 2) | 2);
            *op++ = (uint8_t)offset;
            *op++ = (uint8_t)(offset >> 8);
        }
        return true;
    };

    if (srcLen > 15) {
        ip++;
        while (ip < limit) {
            uint32_t h = snappy_hash(read32(ip));
            const uint8_t* match = src + table[h];
            table[h] = (uint32_t)(ip - src);
            if (match < ip && (ip - match) <= 65535 &&
                read32(match) == read32(ip)) {
                const uint8_t* mi = match + 4;
                const uint8_t* ii = ip + 4;
                while (ii < iend && *ii == *mi) { ii++; mi++; }
                int64_t matchLen = ii - ip;
                if (!emit_literal(anchor, ip - anchor)) return -1;
                if (!emit_copy(ip - match, matchLen)) return -1;
                ip += matchLen;
                anchor = ip;
                if (ip < limit)
                    table[snappy_hash(read32(ip - 1))] =
                        (uint32_t)(ip - 1 - src);
            } else {
                ip++;
            }
        }
    }
    if (iend > anchor && !emit_literal(anchor, iend - anchor)) return -1;
    return op - dst;
}

// returns decompressed length or -1
static int64_t snappy_decompress_fb(const uint8_t* src, int64_t srcLen,
                          uint8_t* dst, int64_t dstCap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + srcLen;
    // uvarint
    uint64_t expected = 0;
    int shift = 0;
    while (true) {
        if (ip >= iend || shift > 63) return -1;
        uint8_t b = *ip++;
        expected |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    if ((int64_t)expected > dstCap) return -1;
    uint8_t* op = dst;
    uint8_t* oend = dst + dstCap;

    while (ip < iend) {
        uint8_t tag = *ip++;
        if ((tag & 3) == 0) {
            int64_t len = (tag >> 2) + 1;
            if (len > 60) {
                int nb = (int)len - 60;
                if (ip + nb > iend) return -1;
                len = 0;
                for (int i = 0; i < nb; i++) len |= (int64_t)ip[i] << (8 * i);
                len += 1;
                ip += nb;
            }
            if (ip + len > iend || op + len > oend) return -1;
            memcpy(op, ip, len);
            ip += len;
            op += len;
        } else {
            int64_t len, offset;
            if ((tag & 3) == 1) {
                if (ip >= iend) return -1;
                len = 4 + ((tag >> 2) & 7);
                offset = ((int64_t)(tag >> 5) << 8) | *ip++;
            } else if ((tag & 3) == 2) {
                if (ip + 2 > iend) return -1;
                len = (tag >> 2) + 1;
                offset = ip[0] | ((int64_t)ip[1] << 8);
                ip += 2;
            } else {
                if (ip + 4 > iend) return -1;
                len = (tag >> 2) + 1;
                offset = ip[0] | ((int64_t)ip[1] << 8) |
                         ((int64_t)ip[2] << 16) | ((int64_t)ip[3] << 24);
                ip += 4;
            }
            if (offset == 0 || offset > op - dst || op + len > oend) return -1;
            const uint8_t* match = op - offset;
            for (int64_t i = 0; i < len; i++) op[i] = match[i];
            op += len;
        }
    }
    if ((uint64_t)(op - dst) != expected) return -1;
    return op - dst;
}

// --------------------------------------------------------------- batch ----
// Compress/decompress n chunks in one call. srcs/dsts are packed buffers;
// offsets are n+1 prefix arrays. Per-chunk results (compressed sizes) land
// in outSizes; returns 0 or -1 (first failure aborts).

typedef int64_t (*codec_fn)(const uint8_t*, int64_t, uint8_t*, int64_t);


// --------------------------------------------------- byte transpose ------
// R x C byte-matrix transpose (dst[c*R + r] = src[r*C + c]) used by the
// lane byte-plane shuffle (write path) and unshuffle (read path). SSE2
// 16x16 kernel: four unpack stages leave rows in 4-bit bit-reversed
// order (self-inverse), so each vector stores to row BITREV4 of its
// index. ~5x the scalar tiled loop on this host.
#if defined(__SSE2__)
#include <emmintrin.h>
static const int TR16_PERM[16] =
    {0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15};
static inline void tr16x16(__m128i x[16]) {
    __m128i t[16], u[16];
    for (int i = 0; i < 8; ++i) {
        t[i]   = _mm_unpacklo_epi8(x[2*i], x[2*i+1]);
        t[i+8] = _mm_unpackhi_epi8(x[2*i], x[2*i+1]);
    }
    for (int i = 0; i < 8; ++i) {
        u[i]   = _mm_unpacklo_epi16(t[2*i], t[2*i+1]);
        u[i+8] = _mm_unpackhi_epi16(t[2*i], t[2*i+1]);
    }
    for (int i = 0; i < 8; ++i) {
        t[i]   = _mm_unpacklo_epi32(u[2*i], u[2*i+1]);
        t[i+8] = _mm_unpackhi_epi32(u[2*i], u[2*i+1]);
    }
    for (int i = 0; i < 8; ++i) {
        x[i]   = _mm_unpacklo_epi64(t[2*i], t[2*i+1]);
        x[i+8] = _mm_unpackhi_epi64(t[2*i], t[2*i+1]);
    }
}
#endif

static void byte_transpose(const uint8_t* src, int64_t R, int64_t C,
                           uint8_t* dst) {
#if defined(__SSE2__)
    int64_t r0 = 0;
    for (; r0 + 16 <= R; r0 += 16) {
        int64_t c0 = 0;
        for (; c0 + 16 <= C; c0 += 16) {
            __m128i x[16];
            for (int i = 0; i < 16; i++)
                x[i] = _mm_loadu_si128(
                    (const __m128i*)(src + (r0 + i) * C + c0));
            tr16x16(x);
            for (int i = 0; i < 16; i++)
                _mm_storeu_si128(
                    (__m128i*)(dst + (c0 + TR16_PERM[i]) * R + r0), x[i]);
        }
        for (; c0 < C; c0++) {
            uint8_t* d = dst + c0 * R + r0;
            const uint8_t* s = src + r0 * C + c0;
            for (int i = 0; i < 16; i++) { d[i] = *s; s += C; }
        }
    }
    for (; r0 < R; r0++)
        for (int64_t c = 0; c < C; c++)
            dst[c * R + r0] = src[r0 * C + c];
#else
    const int64_t TR = 256;       // cache-tiled scalar fallback
    for (int64_t t0 = 0; t0 < R; t0 += TR) {
        int64_t t1 = t0 + TR < R ? t0 + TR : R;
        for (int64_t c = 0; c < C; c++) {
            uint8_t* d = dst + c * R + t0;
            const uint8_t* s = src + t0 * C + c;
            for (int64_t r = t0; r < t1; r++) { *d++ = *s; s += C; }
        }
    }
#endif
}

// ---- system-library fast paths ------------------------------------
// Block formats are fixed public formats, so the system libraries
// (lz4 1.9 SIMD-tuned, snappy-c) read/write bit-compatible blocks.
// COMPRESSION no longer defers to liblz4: the encoder is the
// deterministic policy above, because the device compressor must
// reproduce its exact bytes and liblz4's hash-table output is not a
// policy anyone else can replay. DECOMPRESSION keeps the syslib fast
// path — any valid block decodes to the same bytes regardless of who
// wrote it, so read speed is free. dlopen'd lazily like zstd; the
// first-party decoder stays as the fallback so the build has no hard
// dependency.
static void* p_lz4_d = nullptr;    // LZ4_decompress_safe
static pthread_once_t lz4_once = PTHREAD_ONCE_INIT;
static void lz4_resolve_once() {
    void* h = dlopen("liblz4.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("liblz4.so", RTLD_NOW | RTLD_GLOBAL);
    if (!h) return;
    p_lz4_d = dlsym(h, "LZ4_decompress_safe");
}
typedef int (*lz4_d_fn)(const char*, char*, int, int);

int64_t lz4_compress(const uint8_t* src, int64_t srcLen,
                     uint8_t* dst, int64_t dstCap) {
    return lz4_compress_policy(src, srcLen, dst, dstCap);
}

int64_t lz4_decompress(const uint8_t* src, int64_t srcLen,
                       uint8_t* dst, int64_t dstCap) {
    pthread_once(&lz4_once, lz4_resolve_once);
    if (p_lz4_d && srcLen > 0 && srcLen < (1 << 30)
        && dstCap < (1 << 30)) {
        int r = ((lz4_d_fn)p_lz4_d)((const char*)src, (char*)dst,
                                    (int)srcLen, (int)dstCap);
        return r >= 0 ? (int64_t)r : -1;
    }
    return lz4_decompress_fb(src, srcLen, dst, dstCap);
}

static void* p_snp_c = nullptr;    // snappy_compress (snappy-c API)
static void* p_snp_d = nullptr;    // snappy_uncompress
static pthread_once_t snp_once = PTHREAD_ONCE_INIT;
static void snp_resolve_once() {
    void* h = dlopen("libsnappy.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libsnappy.so", RTLD_NOW | RTLD_GLOBAL);
    if (!h) return;
    p_snp_c = dlsym(h, "snappy_compress");
    p_snp_d = dlsym(h, "snappy_uncompress");
    if (!p_snp_c || !p_snp_d) { p_snp_c = p_snp_d = nullptr; }
}
typedef int (*snp_fn)(const char*, size_t, char*, size_t*);

int64_t snappy_compress(const uint8_t* src, int64_t srcLen,
                        uint8_t* dst, int64_t dstCap) {
    pthread_once(&snp_once, snp_resolve_once);
    if (p_snp_c) {
        size_t outLen = (size_t)dstCap;
        int s = ((snp_fn)p_snp_c)((const char*)src, (size_t)srcLen,
                                  (char*)dst, &outLen);
        return s == 0 ? (int64_t)outLen : -1;
    }
    return snappy_compress_fb(src, srcLen, dst, dstCap);
}

int64_t snappy_decompress(const uint8_t* src, int64_t srcLen,
                          uint8_t* dst, int64_t dstCap) {
    pthread_once(&snp_once, snp_resolve_once);
    if (p_snp_d) {
        size_t outLen = (size_t)dstCap;
        int s = ((snp_fn)p_snp_d)((const char*)src, (size_t)srcLen,
                                  (char*)dst, &outLen);
        return s == 0 ? (int64_t)outLen : -1;
    }
    return snappy_decompress_fb(src, srcLen, dst, dstCap);
}


static int64_t run_batch(codec_fn fn, const uint8_t* src,
                         const int64_t* srcOffs, uint8_t* dst,
                         const int64_t* dstOffs, int64_t* outSizes,
                         int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        int64_t r = fn(src + srcOffs[i], srcOffs[i + 1] - srcOffs[i],
                       dst + dstOffs[i], dstOffs[i + 1] - dstOffs[i]);
        if (r < 0) return -1;
        outSizes[i] = r;
    }
    return 0;
}

int64_t lz4_compress_batch(const uint8_t* src, const int64_t* srcOffs,
                           uint8_t* dst, const int64_t* dstOffs,
                           int64_t* outSizes, int64_t n) {
    return run_batch(lz4_compress, src, srcOffs, dst, dstOffs, outSizes, n);
}

int64_t lz4_decompress_batch(const uint8_t* src, const int64_t* srcOffs,
                             uint8_t* dst, const int64_t* dstOffs,
                             int64_t* outSizes, int64_t n) {
    return run_batch(lz4_decompress, src, srcOffs, dst, dstOffs, outSizes, n);
}

int64_t snappy_compress_batch(const uint8_t* src, const int64_t* srcOffs,
                              uint8_t* dst, const int64_t* dstOffs,
                              int64_t* outSizes, int64_t n) {
    return run_batch(snappy_compress, src, srcOffs, dst, dstOffs, outSizes, n);
}

int64_t snappy_decompress_batch(const uint8_t* src, const int64_t* srcOffs,
                                uint8_t* dst, const int64_t* dstOffs,
                                int64_t* outSizes, int64_t n) {
    return run_batch(snappy_decompress, src, srcOffs, dst, dstOffs, outSizes, n);
}

// ----------------------------------------------------------------- iov ----
// Zero-copy variant: each chunk arrives as its own (pointer, length) pair
// instead of a packed buffer, so Python can hand numpy array views over
// directly — no b"".join / from_buffer_copy staging of ~100MB per
// compaction on the write path.

static int64_t run_iov(codec_fn fn, const uint8_t** srcs,
                       const int64_t* srcLens, uint8_t* dst,
                       const int64_t* dstOffs, int64_t* outSizes,
                       int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        int64_t r = fn(srcs[i], srcLens[i], dst + dstOffs[i],
                       dstOffs[i + 1] - dstOffs[i]);
        if (r < 0) return -1;
        outSizes[i] = r;
    }
    return 0;
}

int64_t lz4_compress_iov(const uint8_t** srcs, const int64_t* srcLens,
                         uint8_t* dst, const int64_t* dstOffs,
                         int64_t* outSizes, int64_t n) {
    return run_iov(lz4_compress, srcs, srcLens, dst, dstOffs, outSizes, n);
}

int64_t snappy_compress_iov(const uint8_t** srcs, const int64_t* srcLens,
                            uint8_t* dst, const int64_t* dstOffs,
                            int64_t* outSizes, int64_t n) {
    return run_iov(snappy_compress, srcs, srcLens, dst, dstOffs, outSizes,
                   n);
}

// decompress into caller-provided destinations (one per chunk): reads
// land directly in the numpy arrays the CellBatch will own. Chunks are
// addressed by explicit (offset, length) pairs so raw-stored blocks can
// be skipped without repacking the source.
int64_t lz4_decompress_iov(const uint8_t* src, const int64_t* srcOffs,
                           const int64_t* srcLens, uint8_t** dsts,
                           const int64_t* dstLens, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        int64_t r = lz4_decompress(src + srcOffs[i], srcLens[i],
                                   dsts[i], dstLens[i]);
        if (r != dstLens[i]) return -1;
    }
    return 0;
}

int64_t snappy_decompress_iov(const uint8_t* src, const int64_t* srcOffs,
                              const int64_t* srcLens, uint8_t** dsts,
                              const int64_t* dstLens, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        int64_t r = snappy_decompress(src + srcOffs[i], srcLens[i],
                                      dsts[i], dstLens[i]);
        if (r != dstLens[i]) return -1;
    }
    return 0;
}

// ---------------------------------------------------------------- zstd ----
// Zstd rides the system libzstd (dlopen'd lazily — the reference links
// zstd-jni the same way: a thin binding over the real library). The
// symbols used are the stable simple API only.

typedef size_t (*ZSTD_compress_t)(void*, size_t, const void*, size_t, int);
typedef size_t (*ZSTD_decompress_t)(void*, size_t, const void*, size_t);
typedef size_t (*ZSTD_compressBound_t)(size_t);
typedef unsigned (*ZSTD_isError_t)(size_t);

static ZSTD_compress_t p_zstd_compress = nullptr;
static ZSTD_decompress_t p_zstd_decompress = nullptr;
static ZSTD_compressBound_t p_zstd_bound = nullptr;
static ZSTD_isError_t p_zstd_iserr = nullptr;
static int zstd_state = 0;  // 0 unresolved, 1 ok, -1 unavailable

// first zstd call can come concurrently from a flush writer and a
// compaction reader — the one-time dlopen/dlsym must not race
static pthread_once_t zstd_once = PTHREAD_ONCE_INIT;

static void zstd_resolve_once() {
    void* h = dlopen("libzstd.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libzstd.so", RTLD_NOW | RTLD_GLOBAL);
    if (h) {
        p_zstd_compress = (ZSTD_compress_t)dlsym(h, "ZSTD_compress");
        p_zstd_decompress = (ZSTD_decompress_t)dlsym(h, "ZSTD_decompress");
        p_zstd_bound = (ZSTD_compressBound_t)dlsym(h, "ZSTD_compressBound");
        p_zstd_iserr = (ZSTD_isError_t)dlsym(h, "ZSTD_isError");
    }
    zstd_state = (p_zstd_compress && p_zstd_decompress && p_zstd_bound &&
                  p_zstd_iserr) ? 1 : -1;
}

static int zstd_resolve() {
    pthread_once(&zstd_once, zstd_resolve_once);
    return zstd_state;
}

int64_t zstd_available() { return zstd_resolve() == 1 ? 1 : 0; }

int64_t zstd_max_compressed(int64_t n) {
    if (zstd_resolve() != 1) return -1;
    return (int64_t)p_zstd_bound((size_t)n);
}

// THREAD-LOCAL: each caller sets its level immediately before its codec
// calls (same thread), so instances with different levels never clobber
// each other and there is no cross-thread race on the level
static thread_local int g_zstd_level = 3;
void zstd_set_level(int level) { g_zstd_level = level; }

int64_t zstd_compress(const uint8_t* src, int64_t srcLen,
                      uint8_t* dst, int64_t dstCap) {
    if (zstd_resolve() != 1) return -1;
    size_t r = p_zstd_compress(dst, (size_t)dstCap, src, (size_t)srcLen,
                               g_zstd_level);
    if (p_zstd_iserr(r)) return -1;
    return (int64_t)r;
}

int64_t zstd_decompress(const uint8_t* src, int64_t srcLen,
                        uint8_t* dst, int64_t dstCap) {
    if (zstd_resolve() != 1) return -1;
    size_t r = p_zstd_decompress(dst, (size_t)dstCap, src, (size_t)srcLen);
    if (p_zstd_iserr(r)) return -1;
    return (int64_t)r;
}

int64_t zstd_compress_batch(const uint8_t* src, const int64_t* srcOffs,
                            uint8_t* dst, const int64_t* dstOffs,
                            int64_t* outSizes, int64_t n) {
    return run_batch(zstd_compress, src, srcOffs, dst, dstOffs, outSizes, n);
}

int64_t zstd_decompress_batch(const uint8_t* src, const int64_t* srcOffs,
                              uint8_t* dst, const int64_t* dstOffs,
                              int64_t* outSizes, int64_t n) {
    return run_batch(zstd_decompress, src, srcOffs, dst, dstOffs, outSizes,
                     n);
}

int64_t zstd_compress_iov(const uint8_t** srcs, const int64_t* srcLens,
                          uint8_t* dst, const int64_t* dstOffs,
                          int64_t* outSizes, int64_t n) {
    return run_iov(zstd_compress, srcs, srcLens, dst, dstOffs, outSizes, n);
}

int64_t zstd_decompress_iov(const uint8_t* src, const int64_t* srcOffs,
                            const int64_t* srcLens, uint8_t** dsts,
                            const int64_t* dstLens, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        int64_t r = zstd_decompress(src + srcOffs[i], srcLens[i],
                                    dsts[i], dstLens[i]);
        if (r != dstLens[i]) return -1;
    }
    return 0;
}

// -------------------------------------------------------- segment pack ----
// The fused write-path entry point: one GIL-released FFI call per segment
// does (optional) lane delta-transform + order check, per-block
// compress-or-store-raw, CRC32, and a sequential copy into `out` — the
// role of the reference's CompressedSequentialWriter.flushData chain
// (io/compress/CompressedSequentialWriter.java:140-205) without
// re-entering Python per block.
//
//   codec: 0 noop, 1 lz4, 2 snappy, 3 zstd
//   blocks/lens: nblocks source buffers
//   attempt[i]: 0 => store raw without trying (caller's skip heuristic)
//   maxCompressedLen: min_compress_ratio fallback bound
//   shuffle_block: index of the block to byte-plane-shuffle as
//                  u32[lane_width] rows (-1 = none); scratch must hold
//                  that block. Measured on real lane data: the plane
//                  layout compresses better AND 1.2-3x faster than
//                  row-major for lz4 and zstd both (blosc's shuffle
//                  filter, applied to the identity-lane matrix). Rows
//                  are also lex order-checked (u32 numeric per column)
//                  while shuffling — the writer's out-of-order guard.
//   out/outCap: destination; blocks land back to back
//   outSizes/outRaw/outCrcs: per-block stored size, raw?, crc32
// Returns total bytes placed in out; -1 codec/capacity error; -3 order
// violation inside the shuffled block.

int64_t segment_pack(int64_t codec, const uint8_t** blocks,
                     const int64_t* lens, int64_t nblocks,
                     const uint8_t* attempt, int64_t maxCompressedLen,
                     int64_t shuffle_block, int64_t lane_width,
                     uint8_t* scratch, uint8_t* out, int64_t outCap,
                     int64_t* outSizes, uint8_t* outRaw,
                     uint32_t* outCrcs) {
    codec_fn fn = nullptr;
    if (codec == 1) fn = lz4_compress;
    else if (codec == 2) fn = snappy_compress;
    else if (codec == 3) { if (zstd_resolve() != 1) return -1;
                           fn = zstd_compress; }
    int64_t pos = 0;
    for (int64_t i = 0; i < nblocks; i++) {
        const uint8_t* srcp = blocks[i];
        int64_t srcLen = lens[i];
        if (i == shuffle_block && lane_width > 0) {
            int64_t W = 4 * lane_width;          // row bytes
            int64_t nrows = srcLen / W;
            byte_transpose(srcp, nrows, W, scratch);
            // lexicographic order check (u32 numeric per column)
            const uint32_t* rows = (const uint32_t*)srcp;
            for (int64_t r = 1; r < nrows; r++) {
                const uint32_t* prev = rows + (r - 1) * lane_width;
                const uint32_t* cur = rows + r * lane_width;
                for (int64_t c = 0; c < lane_width; c++) {
                    if (cur[c] != prev[c]) {
                        if (cur[c] < prev[c]) return -3;
                        break;
                    }
                }
            }
            srcp = scratch;
        }
        int64_t stored;
        int raw = 1;
        if (fn && attempt[i]) {
            // compress straight into out; cap at the raw length (worse
            // than raw => store raw) and the min_compress_ratio bound
            int64_t cap = srcLen < maxCompressedLen ? srcLen
                                                    : maxCompressedLen;
            if (cap > outCap - pos) cap = outCap - pos;
            int64_t r = fn(srcp, srcLen, out + pos, cap);
            if (r >= 0 && r < srcLen && r < maxCompressedLen) {
                stored = r;
                raw = 0;
            } else {
                stored = srcLen;
            }
        } else {
            stored = srcLen;
        }
        if (raw) {
            if (srcLen > outCap - pos) return -1;
            memcpy(out + pos, srcp, srcLen);
            stored = srcLen;
        }
        outSizes[i] = stored;
        outRaw[i] = (uint8_t)raw;
        outCrcs[i] = (uint32_t)crc32(0, out + pos, (uInt)stored);
        pos += stored;
    }
    return pos;
}

// Reader side of segment_pack's shuffle: byte planes -> row-major.
// planes holds W*nrows bytes (W = 4*lane_width); rows receives the
// [nrows, lane_width] u32 matrix. W sequential read streams, one
// sequential write stream.
void lanes_unshuffle(const uint8_t* planes, uint8_t* rows, int64_t nrows,
                     int64_t lane_width) {
    byte_transpose(planes, 4 * lane_width, nrows, rows);
}


// Partition boundaries: indices where the first 4 identity lanes (the
// partition key lanes) change. One cache-friendly pass replacing the
// writer's strided numpy slice-copy + row compare. Returns the count.
int64_t part_boundaries(const uint32_t* lanes, int64_t nrows,
                        int64_t lane_width, int64_t* out_idx) {
    if (nrows == 0) return 0;
    int64_t n = 0;
    out_idx[n++] = 0;
    const uint32_t* prev = lanes;
    const uint32_t* cur = lanes + lane_width;
    for (int64_t r = 1; r < nrows; r++) {
        if (cur[0] != prev[0] || cur[1] != prev[1] ||
            cur[2] != prev[2] || cur[3] != prev[3])
            out_idx[n++] = r;
        prev = cur;
        cur += lane_width;
    }
    return n;
}

// ------------------------------------------------------------ gather -----
// Permuted ragged-frame gather: out[new_off[i] .. new_off[i+1]) =
// payload[off[perm[i]] .. off[perm[i]+1]). The CellBatch payload shuffle is
// the host-side hot loop of compaction (numpy's fancy indexing builds a
// per-byte index array; this is a straight memcpy per frame).

int64_t gather_frames(const uint8_t* payload, const int64_t* off,
                      const int64_t* perm, int64_t n,
                      const int64_t* new_off, uint8_t* out) {
    for (int64_t i = 0; i < n; i++) {
        int64_t j = perm[i];
        int64_t len = off[j + 1] - off[j];
        if (len != new_off[i + 1] - new_off[i]) return -1;
        memcpy(out + new_off[i], payload + off[j], len);
    }
    return 0;
}

}  // extern "C"
