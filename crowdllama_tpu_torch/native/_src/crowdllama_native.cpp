// Native data-plane components for crowdllama_tpu_torch.
//
// The port's own copy of the JAX package's native library, keeping what
// the port's serving path runs.  Host code only (no device kernel),
// loaded through ctypes by crowdllama_tpu_torch/native/__init__.py with
// a counted pure-Python fallback.
//
// Exposed C ABI:
//   - cl_frame_scan:   batch-scan length-prefixed frames in a buffer
//   - cl_rt_*:         256-bucket XOR-metric Kademlia routing table
//   - cl_aead_*:       per-session ChaCha20-Poly1305 (RFC 8439) seal/open
//                      with an internal 96-bit big-endian nonce counter,
//                      byte-identical to net/secure.py's Python path
//   - cl_env_*:        llama.v1 envelope fast paths for the per-chunk arms
//                      (GenerateRequest / GenerateResponse): encode writes
//                      a complete [4-byte BE length][BaseMessage] wire
//                      frame into a caller buffer, byte-identical to
//                      core/llama_v1.py (proto3 skip-defaults, ascending
//                      field order); decode fills a flat struct of
//                      offsets/scalars, returning 0 for any shape it is
//                      not sure about so the caller falls back to the
//                      Python parser with identical semantics.
//
// The routing table mirrors net/dht.py's PyRoutingTable bit for bit:
// bucket index is bit_length(xor(self, id)) - 1, buckets hold at most k
// entries ordered least-recently-seen first, a refresh moves an entry to
// the back, and insertion into a full bucket evicts the front.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kIdBytes = 32;
constexpr int kIdBits = kIdBytes * 8;

using Id = std::array<uint8_t, kIdBytes>;

Id make_id(const uint8_t* p) {
    Id id;
    std::memcpy(id.data(), p, kIdBytes);
    return id;
}

Id xor_id(const Id& a, const Id& b) {
    Id out;
    for (int i = 0; i < kIdBytes; ++i) out[i] = a[i] ^ b[i];
    return out;
}

// bit_length(xor) - 1, i.e. index of the highest set bit (0-based from the
// least significant end), or 0 for a zero distance — matches
// net/dht.py RoutingTable._bucket_index.
int bucket_index(const Id& d) {
    for (int byte = 0; byte < kIdBytes; ++byte) {
        if (d[byte] != 0) {
            int msb = 31 - __builtin_clz(static_cast<uint32_t>(d[byte]));
            return (kIdBytes - 1 - byte) * 8 + msb;
        }
    }
    return 0;
}

// Big-endian lexicographic compare == numeric compare of 256-bit ints.
bool id_less(const Id& a, const Id& b) {
    return std::memcmp(a.data(), b.data(), kIdBytes) < 0;
}

struct RoutingTable {
    Id self_id;
    int k;
    std::vector<std::vector<Id>> buckets;

    RoutingTable(const Id& self, int kk) : self_id(self), k(kk), buckets(kIdBits) {}
};

// ===================================================================
// ChaCha20-Poly1305 (RFC 8439), self-contained: no OpenSSL is needed.
// Pinned by byte-identity tests against the RFC vectors, the
// `cryptography` package's goldens and utils/crypto.py.
// ===================================================================

// -------------------------------------------- ChaCha20 (RFC 8439 §2.3)

inline uint32_t le32(const uint8_t* p) {
    return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
           (static_cast<uint32_t>(p[2]) << 16) |
           (static_cast<uint32_t>(p[3]) << 24);
}

inline uint32_t rotl32(uint32_t x, int n) { return (x << n) | (x >> (32 - n)); }

void chacha20_block(const uint8_t key[32], uint32_t counter,
                    const uint8_t nonce[12], uint8_t out[64]) {
    uint32_t st[16];
    st[0] = 0x61707865; st[1] = 0x3320646e; st[2] = 0x79622d32; st[3] = 0x6b206574;
    for (int i = 0; i < 8; ++i) st[4 + i] = le32(key + 4 * i);
    st[12] = counter;
    for (int i = 0; i < 3; ++i) st[13 + i] = le32(nonce + 4 * i);
    uint32_t x[16];
    std::memcpy(x, st, sizeof(st));
    for (int i = 0; i < 10; ++i) {
#define CL_QR(a, b, c, d)                                   \
    x[a] += x[b]; x[d] ^= x[a]; x[d] = rotl32(x[d], 16);    \
    x[c] += x[d]; x[b] ^= x[c]; x[b] = rotl32(x[b], 12);    \
    x[a] += x[b]; x[d] ^= x[a]; x[d] = rotl32(x[d], 8);     \
    x[c] += x[d]; x[b] ^= x[c]; x[b] = rotl32(x[b], 7);
        CL_QR(0, 4, 8, 12) CL_QR(1, 5, 9, 13) CL_QR(2, 6, 10, 14) CL_QR(3, 7, 11, 15)
        CL_QR(0, 5, 10, 15) CL_QR(1, 6, 11, 12) CL_QR(2, 7, 8, 13) CL_QR(3, 4, 9, 14)
#undef CL_QR
    }
    for (int i = 0; i < 16; ++i) {
        uint32_t v = x[i] + st[i];
        out[4 * i] = static_cast<uint8_t>(v);
        out[4 * i + 1] = static_cast<uint8_t>(v >> 8);
        out[4 * i + 2] = static_cast<uint8_t>(v >> 16);
        out[4 * i + 3] = static_cast<uint8_t>(v >> 24);
    }
}

void chacha20_xor(const uint8_t key[32], uint32_t counter,
                  const uint8_t nonce[12], const uint8_t* in, uint8_t* out,
                  size_t len) {
    uint8_t block[64];
    while (len) {
        chacha20_block(key, counter++, nonce, block);
        size_t take = std::min<size_t>(64, len);
        for (size_t i = 0; i < take; ++i) out[i] = in[i] ^ block[i];
        in += take;
        out += take;
        len -= take;
    }
}

// ------------------------------------------- Poly1305 (RFC 8439 §2.5)

struct Poly1305 {
    uint32_t r[5];
    uint32_t h[5];
    uint32_t pad[4];
    size_t leftover;
    uint8_t buffer[16];
    int final_;
};

void poly1305_init(Poly1305* st, const uint8_t key[32]) {
    st->r[0] = le32(key + 0) & 0x3ffffff;
    st->r[1] = (le32(key + 3) >> 2) & 0x3ffff03;
    st->r[2] = (le32(key + 6) >> 4) & 0x3ffc0ff;
    st->r[3] = (le32(key + 9) >> 6) & 0x3f03fff;
    st->r[4] = (le32(key + 12) >> 8) & 0x00fffff;
    for (int i = 0; i < 5; ++i) st->h[i] = 0;
    for (int i = 0; i < 4; ++i) st->pad[i] = le32(key + 16 + 4 * i);
    st->leftover = 0;
    st->final_ = 0;
}

void poly1305_blocks(Poly1305* st, const uint8_t* m, size_t bytes) {
    const uint32_t hibit = st->final_ ? 0 : (1UL << 24);
    uint32_t r0 = st->r[0], r1 = st->r[1], r2 = st->r[2], r3 = st->r[3], r4 = st->r[4];
    uint32_t s1 = r1 * 5, s2 = r2 * 5, s3 = r3 * 5, s4 = r4 * 5;
    uint32_t h0 = st->h[0], h1 = st->h[1], h2 = st->h[2], h3 = st->h[3], h4 = st->h[4];
    while (bytes >= 16) {
        h0 += le32(m + 0) & 0x3ffffff;
        h1 += (le32(m + 3) >> 2) & 0x3ffffff;
        h2 += (le32(m + 6) >> 4) & 0x3ffffff;
        h3 += (le32(m + 9) >> 6) & 0x3ffffff;
        h4 += (le32(m + 12) >> 8) | hibit;
        uint64_t d0 = (uint64_t)h0 * r0 + (uint64_t)h1 * s4 + (uint64_t)h2 * s3 +
                      (uint64_t)h3 * s2 + (uint64_t)h4 * s1;
        uint64_t d1 = (uint64_t)h0 * r1 + (uint64_t)h1 * r0 + (uint64_t)h2 * s4 +
                      (uint64_t)h3 * s3 + (uint64_t)h4 * s2;
        uint64_t d2 = (uint64_t)h0 * r2 + (uint64_t)h1 * r1 + (uint64_t)h2 * r0 +
                      (uint64_t)h3 * s4 + (uint64_t)h4 * s3;
        uint64_t d3 = (uint64_t)h0 * r3 + (uint64_t)h1 * r2 + (uint64_t)h2 * r1 +
                      (uint64_t)h3 * r0 + (uint64_t)h4 * s4;
        uint64_t d4 = (uint64_t)h0 * r4 + (uint64_t)h1 * r3 + (uint64_t)h2 * r2 +
                      (uint64_t)h3 * r1 + (uint64_t)h4 * r0;
        uint32_t c = (uint32_t)(d0 >> 26); h0 = (uint32_t)d0 & 0x3ffffff;
        d1 += c; c = (uint32_t)(d1 >> 26); h1 = (uint32_t)d1 & 0x3ffffff;
        d2 += c; c = (uint32_t)(d2 >> 26); h2 = (uint32_t)d2 & 0x3ffffff;
        d3 += c; c = (uint32_t)(d3 >> 26); h3 = (uint32_t)d3 & 0x3ffffff;
        d4 += c; c = (uint32_t)(d4 >> 26); h4 = (uint32_t)d4 & 0x3ffffff;
        h0 += c * 5; c = h0 >> 26; h0 &= 0x3ffffff;
        h1 += c;
        m += 16;
        bytes -= 16;
    }
    st->h[0] = h0; st->h[1] = h1; st->h[2] = h2; st->h[3] = h3; st->h[4] = h4;
}

void poly1305_update(Poly1305* st, const uint8_t* m, size_t bytes) {
    if (st->leftover) {
        size_t want = std::min<size_t>(16 - st->leftover, bytes);
        std::memcpy(st->buffer + st->leftover, m, want);
        bytes -= want;
        m += want;
        st->leftover += want;
        if (st->leftover < 16) return;
        poly1305_blocks(st, st->buffer, 16);
        st->leftover = 0;
    }
    if (bytes >= 16) {
        size_t want = bytes & ~static_cast<size_t>(15);
        poly1305_blocks(st, m, want);
        m += want;
        bytes -= want;
    }
    if (bytes) {
        std::memcpy(st->buffer, m, bytes);
        st->leftover = bytes;
    }
}

void poly1305_finish(Poly1305* st, uint8_t mac[16]) {
    if (st->leftover) {
        st->buffer[st->leftover] = 1;
        for (size_t i = st->leftover + 1; i < 16; ++i) st->buffer[i] = 0;
        st->final_ = 1;
        poly1305_blocks(st, st->buffer, 16);
    }
    uint32_t h0 = st->h[0], h1 = st->h[1], h2 = st->h[2], h3 = st->h[3], h4 = st->h[4];
    uint32_t c = h1 >> 26; h1 &= 0x3ffffff;
    h2 += c; c = h2 >> 26; h2 &= 0x3ffffff;
    h3 += c; c = h3 >> 26; h3 &= 0x3ffffff;
    h4 += c; c = h4 >> 26; h4 &= 0x3ffffff;
    h0 += c * 5; c = h0 >> 26; h0 &= 0x3ffffff;
    h1 += c;
    uint32_t g0 = h0 + 5; c = g0 >> 26; g0 &= 0x3ffffff;
    uint32_t g1 = h1 + c; c = g1 >> 26; g1 &= 0x3ffffff;
    uint32_t g2 = h2 + c; c = g2 >> 26; g2 &= 0x3ffffff;
    uint32_t g3 = h3 + c; c = g3 >> 26; g3 &= 0x3ffffff;
    uint32_t g4 = h4 + c - (1UL << 26);
    uint32_t mask = (g4 >> 31) - 1;
    h0 = (h0 & ~mask) | (g0 & mask);
    h1 = (h1 & ~mask) | (g1 & mask);
    h2 = (h2 & ~mask) | (g2 & mask);
    h3 = (h3 & ~mask) | (g3 & mask);
    h4 = (h4 & ~mask) | (g4 & mask);
    uint32_t o0 = h0 | (h1 << 26);
    uint32_t o1 = (h1 >> 6) | (h2 << 20);
    uint32_t o2 = (h2 >> 12) | (h3 << 14);
    uint32_t o3 = (h3 >> 18) | (h4 << 8);
    uint64_t f = (uint64_t)o0 + st->pad[0]; o0 = (uint32_t)f;
    f = (uint64_t)o1 + st->pad[1] + (f >> 32); o1 = (uint32_t)f;
    f = (uint64_t)o2 + st->pad[2] + (f >> 32); o2 = (uint32_t)f;
    f = (uint64_t)o3 + st->pad[3] + (f >> 32); o3 = (uint32_t)f;
    uint32_t o[4] = {o0, o1, o2, o3};
    for (int i = 0; i < 4; ++i) {
        mac[4 * i] = static_cast<uint8_t>(o[i]);
        mac[4 * i + 1] = static_cast<uint8_t>(o[i] >> 8);
        mac[4 * i + 2] = static_cast<uint8_t>(o[i] >> 16);
        mac[4 * i + 3] = static_cast<uint8_t>(o[i] >> 24);
    }
}

// --------------------------------------------------- AEAD session ctx

constexpr size_t kTagLen = 16;

struct AeadCtx {
    uint8_t key[32];
    uint64_t ctr;  // per-direction frame counter -> 96-bit BE nonce
};

void aead_nonce(uint64_t ctr, uint8_t nonce[12]) {
    std::memset(nonce, 0, 4);  // counters stay far below 2^64 in practice
    for (int i = 0; i < 8; ++i)
        nonce[4 + i] = static_cast<uint8_t>(ctr >> (56 - 8 * i));
}

// Poly1305 over (aad, ct) with RFC 8439 §2.8 padding and lengths.
void aead_tag(const uint8_t poly_key[32], const uint8_t* aad, size_t aad_len,
              const uint8_t* ct, size_t n, uint8_t tag[16]) {
    Poly1305 p;
    poly1305_init(&p, poly_key);
    static const uint8_t zeros[16] = {0};
    if (aad_len) {
        poly1305_update(&p, aad, aad_len);
        if (aad_len % 16) poly1305_update(&p, zeros, 16 - (aad_len % 16));
    }
    poly1305_update(&p, ct, n);
    if (n % 16) poly1305_update(&p, zeros, 16 - (n % 16));
    uint8_t lens[16];
    for (int i = 0; i < 8; ++i) {
        lens[i] = static_cast<uint8_t>(static_cast<uint64_t>(aad_len) >> (8 * i));
        lens[8 + i] = static_cast<uint8_t>(static_cast<uint64_t>(n) >> (8 * i));
    }
    poly1305_update(&p, lens, 16);
    poly1305_finish(&p, tag);
}

// Seal `pt[0:n)` under `nonce` into out = ct || tag; returns n + 16.
size_t aead_seal_one(const uint8_t key[32], const uint8_t* nonce,
                     const uint8_t* aad, size_t aad_len, const uint8_t* pt,
                     size_t n, uint8_t* out) {
    uint8_t poly_key[64];
    chacha20_block(key, 0, nonce, poly_key);
    if (n) chacha20_xor(key, 1, nonce, pt, out, n);
    aead_tag(poly_key, aad, aad_len, out, n, out + n);
    return n + kTagLen;
}

// Open one ct||tag frame; returns the plaintext length, or -1 on a tag
// failure (constant-time compare; nothing is decrypted then).
long aead_open_one(const uint8_t key[32], const uint8_t* nonce,
                   const uint8_t* ct, size_t ct_len, uint8_t* out) {
    if (ct_len < kTagLen) return -1;
    size_t n = ct_len - kTagLen;
    uint8_t poly_key[64];
    chacha20_block(key, 0, nonce, poly_key);
    uint8_t tag[16];
    aead_tag(poly_key, nullptr, 0, ct, n, tag);
    uint8_t diff = 0;
    for (size_t i = 0; i < kTagLen; ++i) diff |= tag[i] ^ ct[n + i];
    if (diff) return -1;
    if (n) chacha20_xor(key, 1, nonce, ct, out, n);
    return static_cast<long>(n);
}

// ------------------------------------------- protobuf wire primitives

inline size_t varint_len(uint64_t v) {
    size_t n = 1;
    while (v >= 0x80) {
        v >>= 7;
        ++n;
    }
    return n;
}

inline uint8_t* put_varint(uint8_t* p, uint64_t v) {
    while (v >= 0x80) {
        *p++ = static_cast<uint8_t>(v) | 0x80;
        v >>= 7;
    }
    *p++ = static_cast<uint8_t>(v);
    return p;
}

// tag byte + length varint + raw bytes (field numbers < 16 only).
inline uint8_t* put_bytes_field(uint8_t* p, uint8_t tag, const uint8_t* s,
                                size_t n) {
    *p++ = tag;
    p = put_varint(p, n);
    if (n) std::memcpy(p, s, n);
    return p + n;
}

inline size_t bytes_field_len(size_t n) { return 1 + varint_len(n) + n; }

}  // namespace

extern "C" {

// Scan `buf[0:len)` for complete [4-byte BE length][payload] frames.
// Writes payload offsets/sizes for up to `max_frames` frames, sets
// `*consumed` to the total bytes of the frames returned, and returns the
// frame count.  Returns -1 if any frame declares a length > max_size
// (protocol violation; connection should be dropped).
long cl_frame_scan(const uint8_t* buf, size_t len, uint32_t max_size,
                   uint32_t* offsets, uint32_t* sizes, size_t max_frames,
                   size_t* consumed) {
    size_t pos = 0;
    long n = 0;
    while (static_cast<size_t>(n) < max_frames && pos + 4 <= len) {
        uint32_t frame_len = (static_cast<uint32_t>(buf[pos]) << 24) |
                             (static_cast<uint32_t>(buf[pos + 1]) << 16) |
                             (static_cast<uint32_t>(buf[pos + 2]) << 8) |
                             static_cast<uint32_t>(buf[pos + 3]);
        if (frame_len > max_size) return -1;
        if (pos + 4 + frame_len > len) break;  // incomplete frame
        offsets[n] = static_cast<uint32_t>(pos + 4);
        sizes[n] = frame_len;
        pos += 4 + frame_len;
        ++n;
    }
    *consumed = pos;
    return n;
}

void* cl_rt_new(const uint8_t* self_id, int k) {
    return new RoutingTable(make_id(self_id), k);
}

void cl_rt_free(void* h) { delete static_cast<RoutingTable*>(h); }

// Insert or refresh `id`.  Returns 0 if id == self (ignored), 1 otherwise.
// When a full bucket evicts its least-recently-seen entry, the evicted id is
// written to evicted_out and *evicted is set to 1 (else 0).
int cl_rt_upsert(void* h, const uint8_t* id_bytes, uint8_t* evicted_out,
                 int* evicted) {
    auto* rt = static_cast<RoutingTable*>(h);
    *evicted = 0;
    Id id = make_id(id_bytes);
    if (id == rt->self_id) return 0;
    auto& bucket = rt->buckets[bucket_index(xor_id(rt->self_id, id))];
    for (size_t i = 0; i < bucket.size(); ++i) {
        if (bucket[i] == id) {  // refresh: move to most-recently-seen
            bucket.erase(bucket.begin() + i);
            bucket.push_back(id);
            return 1;
        }
    }
    if (static_cast<int>(bucket.size()) >= rt->k) {
        std::memcpy(evicted_out, bucket.front().data(), kIdBytes);
        *evicted = 1;
        bucket.erase(bucket.begin());
    }
    bucket.push_back(id);
    return 1;
}

int cl_rt_remove(void* h, const uint8_t* id_bytes) {
    auto* rt = static_cast<RoutingTable*>(h);
    Id id = make_id(id_bytes);
    auto& bucket = rt->buckets[bucket_index(xor_id(rt->self_id, id))];
    for (size_t i = 0; i < bucket.size(); ++i) {
        if (bucket[i] == id) {
            bucket.erase(bucket.begin() + i);
            return 1;
        }
    }
    return 0;
}

long cl_rt_size(void* h) {
    auto* rt = static_cast<RoutingTable*>(h);
    long n = 0;
    for (const auto& b : rt->buckets) n += static_cast<long>(b.size());
    return n;
}

// Write the (up to) `k` ids closest to `target` (by XOR distance) into
// `out` (k * 32 bytes), sorted nearest first.  Returns the count written.
long cl_rt_closest(void* h, const uint8_t* target_bytes, int k, uint8_t* out) {
    auto* rt = static_cast<RoutingTable*>(h);
    Id target = make_id(target_bytes);

    std::vector<std::pair<Id, Id>> all;  // (distance, id)
    all.reserve(64);
    for (const auto& b : rt->buckets)
        for (const auto& id : b) all.emplace_back(xor_id(id, target), id);

    size_t kk = std::min<size_t>(k, all.size());
    std::partial_sort(all.begin(), all.begin() + kk, all.end(),
                      [](const auto& a, const auto& b) {
                          return id_less(a.first, b.first);
                      });
    for (size_t i = 0; i < kk; ++i)
        std::memcpy(out + i * kIdBytes, all[i].second.data(), kIdBytes);
    return static_cast<long>(kk);
}

// Dump every id (bucket order, LRS first within a bucket).  Returns count,
// or -1 if `cap` (in ids) is too small.
long cl_rt_dump(void* h, uint8_t* out, long cap) {
    auto* rt = static_cast<RoutingTable*>(h);
    long n = 0;
    for (const auto& b : rt->buckets) {
        for (const auto& id : b) {
            if (n >= cap) return -1;
            std::memcpy(out + n * kIdBytes, id.data(), kIdBytes);
            ++n;
        }
    }
    return n;
}

// ------------------------------------------------------- AEAD sessions

void* cl_aead_new(const uint8_t* key32) {
    auto* c = new AeadCtx();
    std::memcpy(c->key, key32, 32);
    c->ctr = 0;
    return c;
}

void cl_aead_free(void* h) { delete static_cast<AeadCtx*>(h); }

uint64_t cl_aead_ctr(void* h) { return static_cast<AeadCtx*>(h)->ctr; }

// Seal `data[0:len)` into wire frames: plaintext is chunked at `chunk`
// bytes, each chunk sealed under the next nonce and emitted as
// [4B BE ct_len][ct||tag].  If `with_eof` an extra empty-plaintext frame
// (the authenticated close) is appended.  Returns total bytes written to
// `out`, or -1 if `cap` is too small (counter untouched in that case).
long cl_aead_seal_frames(void* h, const uint8_t* data, size_t len,
                         size_t chunk, int with_eof, uint8_t* out,
                         size_t cap) {
    auto* c = static_cast<AeadCtx*>(h);
    if (chunk == 0) return -1;
    if (len == 0 && !with_eof) return 0;
    size_t nframes = len / chunk + ((len % chunk) ? 1 : 0) + (with_eof ? 1 : 0);
    size_t need = len + nframes * (4 + kTagLen);
    if (need > cap) return -1;
    size_t w = 0;
    size_t off = 0;
    uint8_t nonce[12];
    while (off < len) {
        size_t n = std::min(chunk, len - off);
        aead_nonce(c->ctr, nonce);
        c->ctr++;
        size_t ct_len = n + kTagLen;
        out[w] = static_cast<uint8_t>(ct_len >> 24);
        out[w + 1] = static_cast<uint8_t>(ct_len >> 16);
        out[w + 2] = static_cast<uint8_t>(ct_len >> 8);
        out[w + 3] = static_cast<uint8_t>(ct_len);
        aead_seal_one(c->key, nonce, nullptr, 0, data + off, n, out + w + 4);
        w += 4 + ct_len;
        off += n;
    }
    if (with_eof) {
        aead_nonce(c->ctr, nonce);
        c->ctr++;
        out[w] = 0;
        out[w + 1] = 0;
        out[w + 2] = 0;
        out[w + 3] = kTagLen;
        aead_seal_one(c->key, nonce, nullptr, 0, nullptr, 0, out + w + 4);
        w += 4 + kTagLen;
    }
    return static_cast<long>(w);
}

// Open one ciphertext frame body (ct||tag, no length prefix) under the
// next nonce.  Returns the plaintext length, -1 on an authentication
// failure, -2 if `outcap` is too small.  The counter advances on success
// AND on a tag failure (net/secure.py SecureReader._fill's rule), but not
// on the -2 capacity error (a caller bug, not a wire event).
long cl_aead_open(void* h, const uint8_t* ct, size_t ct_len, uint8_t* out,
                  size_t outcap) {
    auto* c = static_cast<AeadCtx*>(h);
    if (ct_len < kTagLen) return -1;
    if (ct_len - kTagLen > outcap) return -2;
    uint8_t nonce[12];
    aead_nonce(c->ctr, nonce);
    c->ctr++;
    return aead_open_one(c->key, nonce, ct, ct_len, out);
}

// One-shot seal with an explicit nonce and aad, so tests can pin the core
// to the RFC 8439 vectors (whose nonce the counter scheme never makes).
// Returns the ct||tag length, or -1 if `cap` is too small.
long cl_aead_seal_raw(const uint8_t* key32, const uint8_t* nonce12,
                      const uint8_t* aad, size_t aad_len, const uint8_t* pt,
                      size_t pt_len, uint8_t* out, size_t cap) {
    if (pt_len + kTagLen > cap) return -1;
    return static_cast<long>(
        aead_seal_one(key32, nonce12, aad, aad_len, pt, pt_len, out));
}


// ------------------------------------------------ llama.v1 envelopes

// Flat field structs mirrored by ctypes.Structure in native/__init__.py.
// Pointers reference caller-owned UTF-8 buffers valid for the call.

struct ClGenRespFields {
    const uint8_t* model; size_t model_len;
    const uint8_t* response; size_t response_len;
    const uint8_t* done_reason; size_t done_reason_len;
    const uint8_t* worker_id; size_t worker_id_len;
    const uint8_t* trace_id; size_t trace_id_len;
    const uint8_t* parent_span; size_t parent_span_len;
    int64_t created_seconds;
    int64_t total_duration;
    int32_t created_nanos;
    int32_t has_created;
    int32_t done;
    int32_t prompt_tokens;
    int32_t completion_tokens;
    int32_t _pad;
};

struct ClGenReqFields {
    const uint8_t* model; size_t model_len;
    const uint8_t* prompt; size_t prompt_len;
    const uint8_t* kv_donor; size_t kv_donor_len;
    const uint8_t* trace_id; size_t trace_id_len;
    const uint8_t* parent_span; size_t parent_span_len;
    const uint8_t* const* msg_roles; const size_t* msg_role_lens;
    const uint8_t* const* msg_contents; const size_t* msg_content_lens;
    const uint8_t* const* stops; const size_t* stop_lens;
    int32_t n_msgs;
    int32_t n_stop;
    int32_t stream;
    int32_t max_tokens;
    float temperature;
    float top_p;
    float repeat_penalty;
    int32_t top_k;
    uint64_t seed;
    int32_t migrate;
    int32_t _pad;
};

// Decode view: offsets into the caller's payload buffer (no copies).
struct ClGenRespView {
    uint32_t model_off; uint32_t model_len;
    uint32_t response_off; uint32_t response_len;
    uint32_t done_reason_off; uint32_t done_reason_len;
    uint32_t worker_id_off; uint32_t worker_id_len;
    uint32_t trace_id_off; uint32_t trace_id_len;
    uint32_t parent_span_off; uint32_t parent_span_len;
    int64_t created_seconds;
    int64_t total_duration;
    int32_t created_nanos;
    int32_t has_created;
    int32_t done;
    int32_t prompt_tokens;
    int32_t completion_tokens;
    int32_t _pad;
};

namespace {

// GenerateResponse submessage body length (proto3 skip-defaults, fields
// in ascending order — matches core/llama_v1.py and protobuf byte for byte).
size_t genresp_body_len(const ClGenRespFields* f) {
    size_t n = 0;
    if (f->model_len) n += bytes_field_len(f->model_len);
    if (f->has_created) {
        size_t ts = 0;
        if (f->created_seconds)
            ts += 1 + varint_len(static_cast<uint64_t>(f->created_seconds));
        if (f->created_nanos)
            ts += 1 + varint_len(static_cast<uint64_t>(
                          static_cast<int64_t>(f->created_nanos)));
        n += 1 + varint_len(ts) + ts;
    }
    if (f->response_len) n += bytes_field_len(f->response_len);
    if (f->done) n += 2;  // tag 0x20 + varint 1
    if (f->done_reason_len) n += bytes_field_len(f->done_reason_len);
    if (f->worker_id_len) n += bytes_field_len(f->worker_id_len);
    if (f->total_duration)
        n += 1 + varint_len(static_cast<uint64_t>(f->total_duration));
    if (f->prompt_tokens)
        n += 1 + varint_len(static_cast<uint64_t>(
                      static_cast<int64_t>(f->prompt_tokens)));
    if (f->completion_tokens)
        n += 1 + varint_len(static_cast<uint64_t>(
                      static_cast<int64_t>(f->completion_tokens)));
    return n;
}

uint8_t* genresp_body_put(uint8_t* p, const ClGenRespFields* f) {
    if (f->model_len) p = put_bytes_field(p, 0x0A, f->model, f->model_len);
    if (f->has_created) {
        size_t ts = 0;
        if (f->created_seconds)
            ts += 1 + varint_len(static_cast<uint64_t>(f->created_seconds));
        if (f->created_nanos)
            ts += 1 + varint_len(static_cast<uint64_t>(
                          static_cast<int64_t>(f->created_nanos)));
        *p++ = 0x12;
        p = put_varint(p, ts);
        if (f->created_seconds) {
            *p++ = 0x08;
            p = put_varint(p, static_cast<uint64_t>(f->created_seconds));
        }
        if (f->created_nanos) {
            *p++ = 0x10;
            p = put_varint(p, static_cast<uint64_t>(
                                  static_cast<int64_t>(f->created_nanos)));
        }
    }
    if (f->response_len) p = put_bytes_field(p, 0x1A, f->response, f->response_len);
    if (f->done) { *p++ = 0x20; *p++ = 0x01; }
    if (f->done_reason_len)
        p = put_bytes_field(p, 0x2A, f->done_reason, f->done_reason_len);
    if (f->worker_id_len)
        p = put_bytes_field(p, 0x32, f->worker_id, f->worker_id_len);
    if (f->total_duration) {
        *p++ = 0x38;
        p = put_varint(p, static_cast<uint64_t>(f->total_duration));
    }
    if (f->prompt_tokens) {
        *p++ = 0x40;
        p = put_varint(p, static_cast<uint64_t>(
                              static_cast<int64_t>(f->prompt_tokens)));
    }
    if (f->completion_tokens) {
        *p++ = 0x48;
        p = put_varint(p, static_cast<uint64_t>(
                              static_cast<int64_t>(f->completion_tokens)));
    }
    return p;
}

inline uint8_t* put_float_field(uint8_t* p, uint8_t tag, float v) {
    uint32_t bits;
    std::memcpy(&bits, &v, 4);
    if (!bits) return p;  // proto3 skips +0.0 (callers reject -0.0 upstream)
    *p++ = tag;
    std::memcpy(p, &bits, 4);
    return p + 4;
}

size_t genreq_body_len(const ClGenReqFields* f) {
    size_t n = 0;
    if (f->model_len) n += bytes_field_len(f->model_len);
    if (f->prompt_len) n += bytes_field_len(f->prompt_len);
    if (f->stream) n += 2;
    for (int32_t i = 0; i < f->n_msgs; ++i) {
        size_t body = 0;
        if (f->msg_role_lens[i]) body += bytes_field_len(f->msg_role_lens[i]);
        if (f->msg_content_lens[i])
            body += bytes_field_len(f->msg_content_lens[i]);
        n += 1 + varint_len(body) + body;
    }
    if (f->max_tokens)
        n += 1 + varint_len(static_cast<uint64_t>(
                      static_cast<int64_t>(f->max_tokens)));
    uint32_t fb;
    std::memcpy(&fb, &f->temperature, 4);
    if (fb) n += 5;
    std::memcpy(&fb, &f->top_p, 4);
    if (fb) n += 5;
    if (f->seed) n += 1 + varint_len(f->seed);
    for (int32_t i = 0; i < f->n_stop; ++i)
        n += bytes_field_len(f->stop_lens[i]);
    if (f->top_k)
        n += 1 + varint_len(static_cast<uint64_t>(
                      static_cast<int64_t>(f->top_k)));
    std::memcpy(&fb, &f->repeat_penalty, 4);
    if (fb) n += 5;
    if (f->kv_donor_len) n += bytes_field_len(f->kv_donor_len);
    if (f->migrate) n += 2;
    return n;
}

uint8_t* genreq_body_put(uint8_t* p, const ClGenReqFields* f) {
    if (f->model_len) p = put_bytes_field(p, 0x0A, f->model, f->model_len);
    if (f->prompt_len) p = put_bytes_field(p, 0x12, f->prompt, f->prompt_len);
    if (f->stream) { *p++ = 0x18; *p++ = 0x01; }
    for (int32_t i = 0; i < f->n_msgs; ++i) {
        size_t body = 0;
        if (f->msg_role_lens[i]) body += bytes_field_len(f->msg_role_lens[i]);
        if (f->msg_content_lens[i])
            body += bytes_field_len(f->msg_content_lens[i]);
        *p++ = 0x22;
        p = put_varint(p, body);
        if (f->msg_role_lens[i])
            p = put_bytes_field(p, 0x0A, f->msg_roles[i], f->msg_role_lens[i]);
        if (f->msg_content_lens[i])
            p = put_bytes_field(p, 0x12, f->msg_contents[i],
                                f->msg_content_lens[i]);
    }
    if (f->max_tokens) {
        *p++ = 0x28;
        p = put_varint(p, static_cast<uint64_t>(
                              static_cast<int64_t>(f->max_tokens)));
    }
    p = put_float_field(p, 0x35, f->temperature);
    p = put_float_field(p, 0x3D, f->top_p);
    if (f->seed) { *p++ = 0x40; p = put_varint(p, f->seed); }
    for (int32_t i = 0; i < f->n_stop; ++i)
        p = put_bytes_field(p, 0x4A, f->stops[i], f->stop_lens[i]);
    if (f->top_k) {
        *p++ = 0x50;
        p = put_varint(p, static_cast<uint64_t>(
                              static_cast<int64_t>(f->top_k)));
    }
    p = put_float_field(p, 0x5D, f->repeat_penalty);
    if (f->kv_donor_len)
        p = put_bytes_field(p, 0x62, f->kv_donor, f->kv_donor_len);
    if (f->migrate) { *p++ = 0x68; *p++ = 0x01; }
    return p;
}

// BaseMessage wrapper: oneof arm (serialized even when the submessage is
// empty: the oneof keeps its presence) + trace_id(5) + parent_span(6).
// The oneof arm comes FIRST in field order for arms 1/2; trace fields 5/6
// follow.  The encoders write ascending field numbers, so arm tags 0x0A
// (generate_request) and 0x12 (generate_response) always precede 0x2A/0x32.
size_t base_wrap_len(size_t arm_body, size_t tid_len, size_t span_len) {
    size_t n = 1 + varint_len(arm_body) + arm_body;
    if (tid_len) n += bytes_field_len(tid_len);
    if (span_len) n += bytes_field_len(span_len);
    return n;
}

// varint reader: returns bytes consumed, 0 on malformed/overlong input.
inline size_t read_varint(const uint8_t* p, size_t len, uint64_t* out) {
    uint64_t v = 0;
    size_t i = 0;
    int shift = 0;
    while (i < len && i < 10) {
        uint8_t b = p[i++];
        v |= static_cast<uint64_t>(b & 0x7f) << shift;
        if (!(b & 0x80)) {
            *out = v;
            return i;
        }
        shift += 7;
    }
    return 0;
}

}  // namespace

// Encode BaseMessage{generate_response=..., trace_id, parent_span} as a
// length-prefixed wire frame ([4B BE len][payload]) into `out`.  Returns
// total bytes written or -1 if cap is insufficient.
long cl_env_encode_genresp(const ClGenRespFields* f, uint8_t* out, size_t cap) {
    size_t body = genresp_body_len(f);
    size_t total = base_wrap_len(body, f->trace_id_len, f->parent_span_len);
    if (4 + total > cap) return -1;
    out[0] = static_cast<uint8_t>(total >> 24);
    out[1] = static_cast<uint8_t>(total >> 16);
    out[2] = static_cast<uint8_t>(total >> 8);
    out[3] = static_cast<uint8_t>(total);
    uint8_t* p = out + 4;
    *p++ = 0x12;  // BaseMessage.generate_response
    p = put_varint(p, body);
    p = genresp_body_put(p, f);
    if (f->trace_id_len)
        p = put_bytes_field(p, 0x2A, f->trace_id, f->trace_id_len);
    if (f->parent_span_len)
        p = put_bytes_field(p, 0x32, f->parent_span, f->parent_span_len);
    return static_cast<long>(p - out);
}

long cl_env_encode_genreq(const ClGenReqFields* f, uint8_t* out, size_t cap) {
    size_t body = genreq_body_len(f);
    size_t total = base_wrap_len(body, f->trace_id_len, f->parent_span_len);
    if (4 + total > cap) return -1;
    out[0] = static_cast<uint8_t>(total >> 24);
    out[1] = static_cast<uint8_t>(total >> 16);
    out[2] = static_cast<uint8_t>(total >> 8);
    out[3] = static_cast<uint8_t>(total);
    uint8_t* p = out + 4;
    *p++ = 0x0A;  // BaseMessage.generate_request
    p = put_varint(p, body);
    p = genreq_body_put(p, f);
    if (f->trace_id_len)
        p = put_bytes_field(p, 0x2A, f->trace_id, f->trace_id_len);
    if (f->parent_span_len)
        p = put_bytes_field(p, 0x32, f->parent_span, f->parent_span_len);
    return static_cast<long>(p - out);
}

// Strict decoder for BaseMessage frames whose oneof arm is
// generate_response.  Fills `view` with offsets into `payload` and
// returns 1.  Returns 0 — caller must fall back to the real parser —
// for ANY shape it is not sure about: unknown fields, non-genresp arms,
// out-of-order or duplicate fields, nested unknowns, negative varint
// surprises.  Never partially trusts: 0 means "view contents undefined".
long cl_env_decode_genresp(const uint8_t* payload, size_t len,
                           ClGenRespView* v) {
    std::memset(v, 0, sizeof(*v));
    size_t i = 0;
    int seen_arm = 0;
    while (i < len) {
        uint8_t tag = payload[i];
        if (tag == 0x12 && !seen_arm) {  // generate_response
            ++i;
            uint64_t blen;
            size_t c = read_varint(payload + i, len - i, &blen);
            if (!c || blen > len - i - c) return 0;
            i += c;
            size_t end = i + blen;
            seen_arm = 1;
            uint32_t prev_tag = 0;
            while (i < end) {
                uint8_t ft = payload[i++];
                if (ft <= prev_tag) return 0;  // require ascending, no dupes
                prev_tag = ft;
                uint64_t x;
                switch (ft) {
                    case 0x0A: case 0x1A: case 0x2A: case 0x32: {
                        size_t cc = read_varint(payload + i, end - i, &x);
                        if (!cc || x > end - i - cc) return 0;
                        i += cc;
                        uint32_t off = static_cast<uint32_t>(i);
                        uint32_t flen = static_cast<uint32_t>(x);
                        if (ft == 0x0A) { v->model_off = off; v->model_len = flen; }
                        else if (ft == 0x1A) { v->response_off = off; v->response_len = flen; }
                        else if (ft == 0x2A) { v->done_reason_off = off; v->done_reason_len = flen; }
                        else { v->worker_id_off = off; v->worker_id_len = flen; }
                        i += x;
                        break;
                    }
                    case 0x12: {  // created_at Timestamp
                        size_t cc = read_varint(payload + i, end - i, &x);
                        if (!cc || x > end - i - cc) return 0;
                        i += cc;
                        size_t tend = i + x;
                        v->has_created = 1;
                        uint32_t tprev = 0;
                        while (i < tend) {
                            uint8_t tt = payload[i++];
                            if (tt <= tprev) return 0;
                            tprev = tt;
                            uint64_t tv;
                            size_t tc = read_varint(payload + i, tend - i, &tv);
                            if (!tc) return 0;
                            i += tc;
                            if (tt == 0x08) {
                                if (tv > 0x7fffffffffffffffULL) return 0;
                                v->created_seconds = static_cast<int64_t>(tv);
                            } else if (tt == 0x10) {
                                if (tv > 0x7fffffff) return 0;
                                v->created_nanos = static_cast<int32_t>(tv);
                            } else {
                                return 0;
                            }
                        }
                        if (i != tend) return 0;
                        break;
                    }
                    case 0x20: {  // done
                        size_t cc = read_varint(payload + i, end - i, &x);
                        if (!cc || x != 1) return 0;  // proto3 never encodes 0
                        i += cc;
                        v->done = 1;
                        break;
                    }
                    case 0x38: {  // total_duration
                        size_t cc = read_varint(payload + i, end - i, &x);
                        if (!cc || x > 0x7fffffffffffffffULL) return 0;
                        i += cc;
                        v->total_duration = static_cast<int64_t>(x);
                        break;
                    }
                    case 0x40: case 0x48: {  // prompt/completion tokens
                        size_t cc = read_varint(payload + i, end - i, &x);
                        if (!cc || x > 0x7fffffff) return 0;  // negatives → fallback
                        i += cc;
                        if (ft == 0x40) v->prompt_tokens = static_cast<int32_t>(x);
                        else v->completion_tokens = static_cast<int32_t>(x);
                        break;
                    }
                    default:
                        return 0;
                }
            }
            if (i != end) return 0;
        } else if (tag == 0x2A) {  // trace_id
            if (v->trace_id_len || !seen_arm) return 0;
            ++i;
            uint64_t x;
            size_t c = read_varint(payload + i, len - i, &x);
            if (!c || !x || x > len - i - c) return 0;
            i += c;
            v->trace_id_off = static_cast<uint32_t>(i);
            v->trace_id_len = static_cast<uint32_t>(x);
            i += x;
        } else if (tag == 0x32) {  // parent_span
            if (v->parent_span_len || !seen_arm) return 0;
            ++i;
            uint64_t x;
            size_t c = read_varint(payload + i, len - i, &x);
            if (!c || !x || x > len - i - c) return 0;
            i += c;
            v->parent_span_off = static_cast<uint32_t>(i);
            v->parent_span_len = static_cast<uint32_t>(x);
            i += x;
        } else {
            return 0;
        }
    }
    return seen_arm ? 1 : 0;
}

}  // extern "C"
