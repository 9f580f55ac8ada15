// Header-only C++ RAII wrappers over the trackie_runtime C ABI.
//
// Parity target: the reference's C++ API layer — RAII wrappers over the
// C surface (reference: src/ffi/c_api/tk_ffi_cpp_api.hpp). For native
// embedders; the Python side uses ctypes directly.

#ifndef TRACKIE_RUNTIME_HPP_
#define TRACKIE_RUNTIME_HPP_

#include <cstdint>
#include <optional>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "trackie_runtime.h"

namespace trackie {

class RingBuffer {
 public:
  explicit RingBuffer(size_t capacity) : h_(tk_ring_create(capacity)) {
    if (!h_) throw std::bad_alloc();
  }
  ~RingBuffer() { tk_ring_destroy(h_); }
  RingBuffer(const RingBuffer&) = delete;
  RingBuffer& operator=(const RingBuffer&) = delete;
  RingBuffer(RingBuffer&& o) noexcept : h_(std::exchange(o.h_, nullptr)) {}

  size_t write(const uint8_t* data, size_t n, bool overwrite = false) {
    return overwrite ? tk_ring_write_overwrite(h_, data, n)
                     : tk_ring_write(h_, data, n);
  }
  std::vector<uint8_t> read(size_t n) {
    std::vector<uint8_t> out(n);
    out.resize(tk_ring_read(h_, out.data(), n));
    return out;
  }
  size_t size() const { return tk_ring_size(h_); }
  size_t capacity() const { return tk_ring_capacity(h_); }

 private:
  tk_ring* h_;
};

struct Event {
  int32_t type;
  std::vector<uint8_t> payload;
};

class EventQueue {
 public:
  explicit EventQueue(size_t capacity = 128)
      : h_(tk_queue_create(capacity)) {
    if (!h_) throw std::bad_alloc();
  }
  ~EventQueue() { tk_queue_destroy(h_); }
  EventQueue(const EventQueue&) = delete;
  EventQueue& operator=(const EventQueue&) = delete;

  bool push(int32_t type, const uint8_t* payload, size_t n) {
    return tk_queue_push(h_, type, payload, n) == 1;
  }
  std::optional<Event> pop(int64_t timeout_ms = 100,
                           size_t max_payload = 1 << 20) {
    Event e;
    e.payload.resize(max_payload);
    size_t full = 0;
    int64_t got = tk_queue_pop(h_, &e.type, e.payload.data(), max_payload,
                               timeout_ms, &full);
    if (got < 0) return std::nullopt;
    e.payload.resize(static_cast<size_t>(got));
    return e;
  }
  size_t count() const { return tk_queue_count(h_); }
  uint64_t dropped() const { return tk_queue_dropped(h_); }

 private:
  tk_event_queue* h_;
};

class Arena {
 public:
  explicit Arena(size_t capacity) : h_(tk_arena_create(capacity)) {
    if (!h_) throw std::bad_alloc();
  }
  ~Arena() { tk_arena_destroy(h_); }
  Arena(const Arena&) = delete;
  Arena& operator=(const Arena&) = delete;

  // Returns a pointer into the arena; throws on exhaustion.
  uint8_t* alloc(size_t n) {
    int64_t off = tk_arena_alloc(h_, n);
    if (off < 0) throw std::bad_alloc();
    return tk_arena_base(h_) + off;
  }
  size_t used() const { return tk_arena_used(h_); }
  void reset() { tk_arena_reset(h_); }

 private:
  tk_arena* h_;
};

// AEAD convenience: ciphertext||tag round trip.
inline std::vector<uint8_t> aead_encrypt(const uint8_t key[32],
                                         const uint8_t nonce[12],
                                         const std::vector<uint8_t>& pt,
                                         const std::vector<uint8_t>& aad = {}) {
  std::vector<uint8_t> out(pt.size() + 16);
  tk_aead_encrypt(key, nonce, aad.data(), aad.size(), pt.data(), pt.size(),
                  out.data(), out.data() + pt.size());
  return out;
}

inline std::vector<uint8_t> aead_decrypt(const uint8_t key[32],
                                         const uint8_t nonce[12],
                                         const std::vector<uint8_t>& ct_tag,
                                         const std::vector<uint8_t>& aad = {}) {
  if (ct_tag.size() < 16) throw std::invalid_argument("short ciphertext");
  size_t n = ct_tag.size() - 16;
  std::vector<uint8_t> out(n);
  if (tk_aead_decrypt(key, nonce, aad.data(), aad.size(), ct_tag.data(), n,
                      ct_tag.data() + n, out.data()) != 0) {
    throw std::runtime_error("AEAD authentication failed");
  }
  return out;
}

}  // namespace trackie

#endif  // TRACKIE_RUNTIME_HPP_
