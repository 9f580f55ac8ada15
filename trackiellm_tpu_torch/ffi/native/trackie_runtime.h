/* Stable C ABI for the trackiellm_tpu_torch native runtime.
 *
 * Parity surface: the reference's tk_* opaque-handle conventions
 * (src/ffi/c_api/tk_ffi_api.h) for the host-side primitives this
 * framework implements natively. Consumed by ctypes
 * (trackiellm_tpu_torch/ffi/native.py) and available to embedders.
 *
 * Build: g++ -O2 -shared -fPIC -std=c++17 \
 *            -o libtrackie_runtime.so trackie_runtime.cpp
 */

#ifndef TRACKIE_RUNTIME_H_
#define TRACKIE_RUNTIME_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- SPSC lock-free byte ring buffer (audio/video streams) ---------- */
typedef struct tk_ring tk_ring;
tk_ring* tk_ring_create(size_t capacity);           /* rounds to pow2 */
void     tk_ring_destroy(tk_ring*);
size_t   tk_ring_size(const tk_ring*);
size_t   tk_ring_capacity(const tk_ring*);
size_t   tk_ring_write(tk_ring*, const uint8_t* data, size_t n);
size_t   tk_ring_read(tk_ring*, uint8_t* out, size_t n);
/* Real-time variant: always writes n bytes, dropping oldest when full. */
size_t   tk_ring_write_overwrite(tk_ring*, const uint8_t* data, size_t n);

/* ---- Bounded MPMC event queue (deep-copied payloads) ----------------- */
typedef struct tk_event_queue tk_event_queue;
tk_event_queue* tk_queue_create(size_t capacity);   /* 0 -> 128 slots */
void     tk_queue_destroy(tk_event_queue*);
/* Non-blocking; returns 1 on success, 0 when full (event counted as
 * dropped). Payload is deep-copied. */
int      tk_queue_push(tk_event_queue*, int32_t type,
                       const uint8_t* payload, size_t n);
/* Blocking dequeue with timeout. Returns bytes copied into `out`
 * (truncated to out_cap) or -1 on timeout; full size via size_out. */
int64_t  tk_queue_pop(tk_event_queue*, int32_t* type_out, uint8_t* out,
                      size_t out_cap, int64_t timeout_ms, size_t* size_out);
size_t   tk_queue_count(tk_event_queue*);
uint64_t tk_queue_dropped(tk_event_queue*);

/* ---- Arena (bump) allocator, 64-byte aligned offsets ----------------- */
typedef struct tk_arena tk_arena;
tk_arena* tk_arena_create(size_t capacity);
void     tk_arena_destroy(tk_arena*);
int64_t  tk_arena_alloc(tk_arena*, size_t n);       /* offset or -1 */
uint8_t* tk_arena_base(tk_arena*);
size_t   tk_arena_used(tk_arena*);
void     tk_arena_reset(tk_arena*);

/* ---- Security primitives --------------------------------------------- */
void     tk_secure_zero(uint8_t* p, size_t n);
int      tk_ct_memcmp(const uint8_t* a, const uint8_t* b, size_t n);

/* RFC 8439 ChaCha20-Poly1305 AEAD. key: 32 bytes, nonce: 12 bytes. */
void     tk_aead_encrypt(const uint8_t* key, const uint8_t* nonce,
                         const uint8_t* aad, size_t aad_len,
                         const uint8_t* plaintext, size_t n,
                         uint8_t* ciphertext_out, uint8_t* tag16_out);
/* Returns 0 on success, -1 on authentication failure (constant time). */
int      tk_aead_decrypt(const uint8_t* key, const uint8_t* nonce,
                         const uint8_t* aad, size_t aad_len,
                         const uint8_t* ciphertext, size_t n,
                         const uint8_t* tag16, uint8_t* plaintext_out);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* TRACKIE_RUNTIME_H_ */
