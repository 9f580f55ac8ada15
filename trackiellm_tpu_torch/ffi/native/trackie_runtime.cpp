// Native runtime primitives for trackiellm_tpu_torch.
//
// Parity targets (reference, reimplemented not translated):
//   - the cortex's 128-slot mutex+condvar event queue with deep-copied
//     payloads (src/cortex/tk_cortex_main.c:231-366),
//   - the audio/video ring buffers (tk_cortex_main.c:542-543),
//   - the FFI layer's aligned alloc / secure_zero / constant-time
//     memcmp (src/ffi/c_api/tk_ffi_api.h:587-616),
//   - the security crate's XChaCha20-Poly1305 AEAD via libsodium
//     (src/security/tk_encryption.c:7-40) — here a self-contained
//     RFC 8439 ChaCha20-Poly1305 (no external deps).
//
// Exposed as a flat C ABI consumed by ctypes (trackiellm_tpu_torch/ffi/native.py).
// Build: g++ -O2 -shared -fPIC -std=c++17 -o libtrackie_runtime.so this.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC lock-free byte ring buffer
// ---------------------------------------------------------------------------

struct tk_ring {
    uint8_t* buf;
    size_t capacity;               // power of two
    std::atomic<size_t> head;      // write index (producer)
    std::atomic<size_t> tail;      // read index (consumer)
};

tk_ring* tk_ring_create(size_t capacity) {
    // Round up to a power of two.
    size_t cap = 1;
    while (cap < capacity) cap <<= 1;
    auto* r = new (std::nothrow) tk_ring;
    if (!r) return nullptr;
    r->buf = new (std::nothrow) uint8_t[cap];
    if (!r->buf) { delete r; return nullptr; }
    r->capacity = cap;
    r->head.store(0);
    r->tail.store(0);
    return r;
}

void tk_ring_destroy(tk_ring* r) {
    if (!r) return;
    delete[] r->buf;
    delete r;
}

size_t tk_ring_size(const tk_ring* r) {
    return r->head.load(std::memory_order_acquire)
         - r->tail.load(std::memory_order_acquire);
}

size_t tk_ring_capacity(const tk_ring* r) { return r->capacity; }

// Returns bytes written (may be < n when full).
size_t tk_ring_write(tk_ring* r, const uint8_t* data, size_t n) {
    size_t head = r->head.load(std::memory_order_relaxed);
    size_t tail = r->tail.load(std::memory_order_acquire);
    size_t free_space = r->capacity - (head - tail);
    if (n > free_space) n = free_space;
    size_t mask = r->capacity - 1;
    size_t pos = head & mask;
    size_t first = std::min(n, r->capacity - pos);
    std::memcpy(r->buf + pos, data, first);
    std::memcpy(r->buf, data + first, n - first);
    r->head.store(head + n, std::memory_order_release);
    return n;
}

// Returns bytes read (may be < n when empty).
size_t tk_ring_read(tk_ring* r, uint8_t* out, size_t n) {
    size_t tail = r->tail.load(std::memory_order_relaxed);
    size_t head = r->head.load(std::memory_order_acquire);
    size_t avail = head - tail;
    if (n > avail) n = avail;
    size_t mask = r->capacity - 1;
    size_t pos = tail & mask;
    size_t first = std::min(n, r->capacity - pos);
    std::memcpy(out, r->buf + pos, first);
    std::memcpy(out + first, r->buf, n - first);
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

// Overwrite-oldest write for real-time streams (audio ring semantics):
// always writes all n bytes, discarding the oldest data when full.
size_t tk_ring_write_overwrite(tk_ring* r, const uint8_t* data, size_t n) {
    if (n > r->capacity) {  // keep only the newest capacity bytes
        data += n - r->capacity;
        n = r->capacity;
    }
    size_t head = r->head.load(std::memory_order_relaxed);
    size_t tail = r->tail.load(std::memory_order_acquire);
    size_t free_space = r->capacity - (head - tail);
    if (n > free_space) {
        // Advance tail (drop oldest). This mutates the consumer index
        // from the producer side, so callers MUST serialize overwrite
        // writes against reads externally (NativeRingBuffer holds a
        // lock around every call); it is NOT safe as lock-free SPSC.
        r->tail.store(tail + (n - free_space), std::memory_order_release);
    }
    return tk_ring_write(r, data, n);
}

// ---------------------------------------------------------------------------
// Bounded MPMC event queue (deep-copied payloads)
// ---------------------------------------------------------------------------

struct tk_event {
    int32_t type;
    std::vector<uint8_t> payload;
};

struct tk_event_queue {
    std::vector<tk_event> slots;
    size_t head = 0, tail = 0, count = 0;
    size_t capacity;
    std::mutex mu;
    std::condition_variable cv_push, cv_pop;
    std::atomic<uint64_t> dropped{0};
};

tk_event_queue* tk_queue_create(size_t capacity) {
    auto* q = new (std::nothrow) tk_event_queue;
    if (!q) return nullptr;
    q->capacity = capacity ? capacity : 128;
    q->slots.resize(q->capacity);
    return q;
}

void tk_queue_destroy(tk_event_queue* q) { delete q; }

// Non-blocking enqueue; payload is deep-copied. Returns 1 on success,
// 0 when full (event dropped — counted).
int tk_queue_push(tk_event_queue* q, int32_t type, const uint8_t* payload,
                  size_t n) {
    {
        std::lock_guard<std::mutex> lk(q->mu);
        if (q->count == q->capacity) {
            q->dropped.fetch_add(1);
            return 0;
        }
        tk_event& e = q->slots[q->head];
        e.type = type;
        e.payload.assign(payload, payload + n);
        q->head = (q->head + 1) % q->capacity;
        q->count++;
    }
    q->cv_pop.notify_one();
    return 1;
}

// Blocking dequeue with timeout (ms). Returns payload size (copied into
// `out`, truncated to out_cap), or -1 on timeout. `type_out` receives
// the event type; the untruncated size is written to `size_out`.
int64_t tk_queue_pop(tk_event_queue* q, int32_t* type_out, uint8_t* out,
                     size_t out_cap, int64_t timeout_ms, size_t* size_out) {
    std::unique_lock<std::mutex> lk(q->mu);
    if (q->count == 0) {
        if (timeout_ms <= 0 ||
            !q->cv_pop.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                [q] { return q->count > 0; })) {
            return -1;
        }
    }
    tk_event& e = q->slots[q->tail];
    *type_out = e.type;
    size_t n = e.payload.size();
    if (size_out) *size_out = n;
    size_t copy = std::min(n, out_cap);
    std::memcpy(out, e.payload.data(), copy);
    e.payload.clear();
    e.payload.shrink_to_fit();
    q->tail = (q->tail + 1) % q->capacity;
    q->count--;
    lk.unlock();
    q->cv_push.notify_one();
    return (int64_t)copy;
}

size_t tk_queue_count(tk_event_queue* q) {
    std::lock_guard<std::mutex> lk(q->mu);
    return q->count;
}

uint64_t tk_queue_dropped(tk_event_queue* q) { return q->dropped.load(); }

// ---------------------------------------------------------------------------
// Arena (bump) allocator
// ---------------------------------------------------------------------------

struct tk_arena {
    uint8_t* base;
    size_t capacity;
    size_t offset;
    uint64_t allocations;
};

tk_arena* tk_arena_create(size_t capacity) {
    auto* a = new (std::nothrow) tk_arena;
    if (!a) return nullptr;
    a->base = new (std::nothrow) uint8_t[capacity];
    if (!a->base) { delete a; return nullptr; }
    a->capacity = capacity;
    a->offset = 0;
    a->allocations = 0;
    return a;
}

void tk_arena_destroy(tk_arena* a) {
    if (!a) return;
    delete[] a->base;
    delete a;
}

// 64-byte-aligned bump allocation; returns offset or -1 when exhausted.
int64_t tk_arena_alloc(tk_arena* a, size_t n) {
    size_t aligned = (a->offset + 63) & ~size_t(63);
    if (aligned + n > a->capacity) return -1;
    a->offset = aligned + n;
    a->allocations++;
    return (int64_t)aligned;
}

uint8_t* tk_arena_base(tk_arena* a) { return a->base; }
size_t tk_arena_used(tk_arena* a) { return a->offset; }
void tk_arena_reset(tk_arena* a) { a->offset = 0; }

// ---------------------------------------------------------------------------
// Security primitives
// ---------------------------------------------------------------------------

void tk_secure_zero(uint8_t* p, size_t n) {
    volatile uint8_t* vp = p;
    while (n--) *vp++ = 0;
}

// Constant-time comparison: 0 when equal.
int tk_ct_memcmp(const uint8_t* a, const uint8_t* b, size_t n) {
    uint8_t acc = 0;
    for (size_t i = 0; i < n; i++) acc |= (uint8_t)(a[i] ^ b[i]);
    return acc != 0;
}

// ----- ChaCha20 (RFC 8439) --------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int k) {
    return (x << k) | (x >> (32 - k));
}

#define QR(a, b, c, d)                                            \
    a += b; d ^= a; d = rotl32(d, 16);                            \
    c += d; b ^= c; b = rotl32(b, 12);                            \
    a += b; d ^= a; d = rotl32(d, 8);                             \
    c += d; b ^= c; b = rotl32(b, 7);

static void chacha20_block(const uint32_t key[8], uint32_t counter,
                           const uint32_t nonce[3], uint8_t out[64]) {
    uint32_t s[16] = {
        0x61707865, 0x3320646e, 0x79622d32, 0x6b206574,
        key[0], key[1], key[2], key[3], key[4], key[5], key[6], key[7],
        counter, nonce[0], nonce[1], nonce[2],
    };
    uint32_t w[16];
    std::memcpy(w, s, sizeof(w));
    for (int i = 0; i < 10; i++) {
        QR(w[0], w[4], w[8], w[12]);
        QR(w[1], w[5], w[9], w[13]);
        QR(w[2], w[6], w[10], w[14]);
        QR(w[3], w[7], w[11], w[15]);
        QR(w[0], w[5], w[10], w[15]);
        QR(w[1], w[6], w[11], w[12]);
        QR(w[2], w[7], w[8], w[13]);
        QR(w[3], w[4], w[9], w[14]);
    }
    for (int i = 0; i < 16; i++) {
        uint32_t v = w[i] + s[i];
        out[4 * i] = v & 0xff;
        out[4 * i + 1] = (v >> 8) & 0xff;
        out[4 * i + 2] = (v >> 16) & 0xff;
        out[4 * i + 3] = (v >> 24) & 0xff;
    }
}

static void chacha20_xor(const uint32_t key[8], uint32_t counter,
                         const uint32_t nonce[3], const uint8_t* in,
                         uint8_t* out, size_t n) {
    uint8_t block[64];
    while (n > 0) {
        chacha20_block(key, counter++, nonce, block);
        size_t take = n < 64 ? n : 64;
        for (size_t i = 0; i < take; i++) out[i] = in[i] ^ block[i];
        in += take; out += take; n -= take;
    }
}

// ----- Poly1305 ---------------------------------------------------------------

struct poly1305 {
    uint32_t r[5], h[5], pad[4];
};

static void poly1305_init(poly1305* st, const uint8_t key[32]) {
    auto le32 = [](const uint8_t* p) {
        return (uint32_t)p[0] | ((uint32_t)p[1] << 8)
             | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
    };
    st->r[0] = le32(key) & 0x3ffffff;
    st->r[1] = (le32(key + 3) >> 2) & 0x3ffff03;
    st->r[2] = (le32(key + 6) >> 4) & 0x3ffc0ff;
    st->r[3] = (le32(key + 9) >> 6) & 0x3f03fff;
    st->r[4] = (le32(key + 12) >> 8) & 0x00fffff;
    for (int i = 0; i < 5; i++) st->h[i] = 0;
    for (int i = 0; i < 4; i++) st->pad[i] = le32(key + 16 + 4 * i);
}

static void poly1305_blocks(poly1305* st, const uint8_t* m, size_t n,
                            uint32_t hibit) {
    uint32_t r0 = st->r[0], r1 = st->r[1], r2 = st->r[2], r3 = st->r[3],
             r4 = st->r[4];
    uint32_t s1 = r1 * 5, s2 = r2 * 5, s3 = r3 * 5, s4 = r4 * 5;
    uint32_t h0 = st->h[0], h1 = st->h[1], h2 = st->h[2], h3 = st->h[3],
             h4 = st->h[4];
    auto le32 = [](const uint8_t* p) {
        return (uint32_t)p[0] | ((uint32_t)p[1] << 8)
             | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
    };
    while (n >= 16) {
        h0 += le32(m) & 0x3ffffff;
        h1 += (le32(m + 3) >> 2) & 0x3ffffff;
        h2 += (le32(m + 6) >> 4) & 0x3ffffff;
        h3 += (le32(m + 9) >> 6) & 0x3ffffff;
        h4 += (le32(m + 12) >> 8) | hibit;
        uint64_t d0 = (uint64_t)h0 * r0 + (uint64_t)h1 * s4
                    + (uint64_t)h2 * s3 + (uint64_t)h3 * s2
                    + (uint64_t)h4 * s1;
        uint64_t d1 = (uint64_t)h0 * r1 + (uint64_t)h1 * r0
                    + (uint64_t)h2 * s4 + (uint64_t)h3 * s3
                    + (uint64_t)h4 * s2;
        uint64_t d2 = (uint64_t)h0 * r2 + (uint64_t)h1 * r1
                    + (uint64_t)h2 * r0 + (uint64_t)h3 * s4
                    + (uint64_t)h4 * s3;
        uint64_t d3 = (uint64_t)h0 * r3 + (uint64_t)h1 * r2
                    + (uint64_t)h2 * r1 + (uint64_t)h3 * r0
                    + (uint64_t)h4 * s4;
        uint64_t d4 = (uint64_t)h0 * r4 + (uint64_t)h1 * r3
                    + (uint64_t)h2 * r2 + (uint64_t)h3 * r1
                    + (uint64_t)h4 * r0;
        uint32_t c = (uint32_t)(d0 >> 26); h0 = (uint32_t)d0 & 0x3ffffff;
        d1 += c; c = (uint32_t)(d1 >> 26); h1 = (uint32_t)d1 & 0x3ffffff;
        d2 += c; c = (uint32_t)(d2 >> 26); h2 = (uint32_t)d2 & 0x3ffffff;
        d3 += c; c = (uint32_t)(d3 >> 26); h3 = (uint32_t)d3 & 0x3ffffff;
        d4 += c; c = (uint32_t)(d4 >> 26); h4 = (uint32_t)d4 & 0x3ffffff;
        h0 += c * 5; c = h0 >> 26; h0 &= 0x3ffffff; h1 += c;
        m += 16; n -= 16;
    }
    st->h[0] = h0; st->h[1] = h1; st->h[2] = h2; st->h[3] = h3; st->h[4] = h4;
}

static void poly1305_finish(poly1305* st, uint8_t mac[16]) {
    uint32_t h0 = st->h[0], h1 = st->h[1], h2 = st->h[2], h3 = st->h[3],
             h4 = st->h[4];
    uint32_t c = h1 >> 26; h1 &= 0x3ffffff;
    h2 += c; c = h2 >> 26; h2 &= 0x3ffffff;
    h3 += c; c = h3 >> 26; h3 &= 0x3ffffff;
    h4 += c; c = h4 >> 26; h4 &= 0x3ffffff;
    h0 += c * 5; c = h0 >> 26; h0 &= 0x3ffffff; h1 += c;

    uint32_t g0 = h0 + 5; c = g0 >> 26; g0 &= 0x3ffffff;
    uint32_t g1 = h1 + c; c = g1 >> 26; g1 &= 0x3ffffff;
    uint32_t g2 = h2 + c; c = g2 >> 26; g2 &= 0x3ffffff;
    uint32_t g3 = h3 + c; c = g3 >> 26; g3 &= 0x3ffffff;
    uint32_t g4 = h4 + c - (1u << 26);

    uint32_t mask = (g4 >> 31) - 1;
    h0 = (h0 & ~mask) | (g0 & mask);
    h1 = (h1 & ~mask) | (g1 & mask);
    h2 = (h2 & ~mask) | (g2 & mask);
    h3 = (h3 & ~mask) | (g3 & mask);
    h4 = (h4 & ~mask) | (g4 & mask);

    uint64_t f;
    uint32_t o0 = (h0 | (h1 << 26));
    uint32_t o1 = ((h1 >> 6) | (h2 << 20));
    uint32_t o2 = ((h2 >> 12) | (h3 << 14));
    uint32_t o3 = ((h3 >> 18) | (h4 << 8));
    f = (uint64_t)o0 + st->pad[0]; o0 = (uint32_t)f;
    f = (uint64_t)o1 + st->pad[1] + (f >> 32); o1 = (uint32_t)f;
    f = (uint64_t)o2 + st->pad[2] + (f >> 32); o2 = (uint32_t)f;
    f = (uint64_t)o3 + st->pad[3] + (f >> 32); o3 = (uint32_t)f;
    uint32_t outw[4] = {o0, o1, o2, o3};
    for (int i = 0; i < 4; i++) {
        mac[4 * i] = outw[i] & 0xff;
        mac[4 * i + 1] = (outw[i] >> 8) & 0xff;
        mac[4 * i + 2] = (outw[i] >> 16) & 0xff;
        mac[4 * i + 3] = (outw[i] >> 24) & 0xff;
    }
}

// AEAD construct (RFC 8439 section 2.8). key: 32 bytes, nonce: 12 bytes.
// out = ciphertext (n bytes) and mac written to tag[16].
static void aead_mac(const uint32_t key_words[8], const uint32_t nonce[3],
                     const uint8_t* aad, size_t aad_len,
                     const uint8_t* ct, size_t ct_len, uint8_t tag[16]) {
    uint8_t poly_key_block[64];
    chacha20_block(key_words, 0, nonce, poly_key_block);
    poly1305 st;
    poly1305_init(&st, poly_key_block);

    uint8_t buf[16] = {0};
    // AAD (padded to 16).
    size_t full = aad_len & ~size_t(15);
    if (full) poly1305_blocks(&st, aad, full, 1u << 24);
    if (aad_len % 16) {
        std::memset(buf, 0, 16);
        std::memcpy(buf, aad + full, aad_len % 16);
        poly1305_blocks(&st, buf, 16, 1u << 24);
    }
    // Ciphertext (padded to 16).
    full = ct_len & ~size_t(15);
    if (full) poly1305_blocks(&st, ct, full, 1u << 24);
    if (ct_len % 16) {
        std::memset(buf, 0, 16);
        std::memcpy(buf, ct + full, ct_len % 16);
        poly1305_blocks(&st, buf, 16, 1u << 24);
    }
    // Lengths block.
    std::memset(buf, 0, 16);
    uint64_t al = aad_len, cl = ct_len;
    std::memcpy(buf, &al, 8);
    std::memcpy(buf + 8, &cl, 8);
    poly1305_blocks(&st, buf, 16, 1u << 24);
    poly1305_finish(&st, tag);
}

static void load_key_nonce(const uint8_t key[32], const uint8_t nonce[12],
                           uint32_t kw[8], uint32_t nw[3]) {
    for (int i = 0; i < 8; i++)
        std::memcpy(&kw[i], key + 4 * i, 4);
    for (int i = 0; i < 3; i++)
        std::memcpy(&nw[i], nonce + 4 * i, 4);
}

// Encrypt: writes n ciphertext bytes to `out` and 16-byte tag to `tag`.
void tk_aead_encrypt(const uint8_t* key, const uint8_t* nonce,
                     const uint8_t* aad, size_t aad_len,
                     const uint8_t* plaintext, size_t n,
                     uint8_t* out, uint8_t* tag) {
    uint32_t kw[8], nw[3];
    load_key_nonce(key, nonce, kw, nw);
    chacha20_xor(kw, 1, nw, plaintext, out, n);
    aead_mac(kw, nw, aad, aad_len, out, n, tag);
}

// Decrypt: returns 0 on success (plaintext in `out`), -1 on tag mismatch.
int tk_aead_decrypt(const uint8_t* key, const uint8_t* nonce,
                    const uint8_t* aad, size_t aad_len,
                    const uint8_t* ciphertext, size_t n,
                    const uint8_t* tag, uint8_t* out) {
    uint32_t kw[8], nw[3];
    load_key_nonce(key, nonce, kw, nw);
    uint8_t expect[16];
    aead_mac(kw, nw, aad, aad_len, ciphertext, n, expect);
    if (tk_ct_memcmp(expect, tag, 16) != 0) return -1;
    chacha20_xor(kw, 1, nw, ciphertext, out, n);
    return 0;
}

}  // extern "C"
