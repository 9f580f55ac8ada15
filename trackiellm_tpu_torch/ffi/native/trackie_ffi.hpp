/* C++17 RAII layer over the stable C ABI (trackie_ffi.h).
 *
 * Parity surface: the reference ships a full RAII wrapper over its C
 * API for C++ embedders (reference: src/ffi/c_api/tk_ffi_cpp_api.hpp:
 * 1-685, .cpp:1-1413). This is the rebuild's equivalent — original
 * header-only C++17: exceptions carry the thread-local error string,
 * handles are move-only owners, module executors and async callbacks
 * are std::function (trampolined through the C fn-pointer contract),
 * and a ModuleGuard unregisters on scope exit.
 *
 * Usage: #include "trackie_ffi.hpp"; link against libtrackie_runtime.
 */

#ifndef TRACKIE_FFI_HPP_
#define TRACKIE_FFI_HPP_

#include <cstring>
#include <functional>
#include <memory>
#include <optional>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

#include "trackie_ffi.h"

namespace tk {

/* ---- errors ----------------------------------------------------------- */

class Error : public std::runtime_error {
 public:
    Error(TkStatus status, const std::string& what)
        : std::runtime_error(what), status_(status) {}
    TkStatus status() const noexcept { return status_; }

 private:
    TkStatus status_;
};

inline void check(TkStatus s, const char* op) {
    if (s != TK_OK) {
        const char* detail = tk_ffi_last_error();
        throw Error(s, std::string(op) + " failed (" +
                           std::to_string(static_cast<int>(s)) + "): " +
                           (detail ? detail : ""));
    }
}

inline std::string version() { return tk_version_string(); }

/* ---- Tensor ----------------------------------------------------------- */

class Tensor {
 public:
    Tensor() = default;
    /* Adopts ownership of a raw handle (e.g. a module-command result). */
    static Tensor adopt(TkTensor* raw) { return Tensor(raw); }

    static Tensor create(TkDataType dtype,
                         const std::vector<int64_t>& shape) {
        TkTensor* t = nullptr;
        check(tk_tensor_create(&t, dtype, shape.data(), shape.size()),
              "tk_tensor_create");
        return Tensor(t);
    }

    static Tensor zeros(const std::vector<int64_t>& shape,
                        TkDataType dtype = TK_F32) {
        Tensor t = create(dtype, shape);
        t.fill(0.0);
        return t;
    }

    static Tensor from_floats(const std::vector<int64_t>& shape,
                              const float* data, size_t n) {
        Tensor t = create(TK_F32, shape);
        auto [p, nbytes] = t.mutable_data();
        if (nbytes != n * sizeof(float))
            throw Error(TK_ERR_INVALID_ARGUMENT,
                        "from_floats: size mismatch");
        std::memcpy(p, data, nbytes);
        return t;
    }

    Tensor(Tensor&& o) noexcept : t_(o.t_) { o.t_ = nullptr; }
    Tensor& operator=(Tensor&& o) noexcept {
        if (this != &o) { reset(); t_ = o.t_; o.t_ = nullptr; }
        return *this;
    }
    Tensor(const Tensor&) = delete;
    Tensor& operator=(const Tensor&) = delete;
    ~Tensor() { reset(); }

    explicit operator bool() const noexcept { return t_ != nullptr; }
    TkTensor* get() const noexcept { return t_; }
    /* Releases ownership (for APIs that consume the handle). */
    TkTensor* release() noexcept { TkTensor* t = t_; t_ = nullptr; return t; }

    std::vector<int64_t> shape() const {
        int64_t dims[TK_TENSOR_MAX_DIMS];
        size_t n = TK_TENSOR_MAX_DIMS;
        check(tk_tensor_get_shape(t_, dims, &n), "tk_tensor_get_shape");
        return std::vector<int64_t>(dims, dims + n);
    }

    TkDataType dtype() const {
        TkDataType d;
        check(tk_tensor_dtype(t_, &d), "tk_tensor_dtype");
        return d;
    }

    std::pair<const void*, size_t> data() const {
        const void* p; size_t n;
        check(tk_tensor_get_data(t_, &p, &n), "tk_tensor_get_data");
        return {p, n};
    }

    std::pair<void*, size_t> mutable_data() {
        void* p; size_t n;
        check(tk_tensor_get_mutable_data(t_, &p, &n),
              "tk_tensor_get_mutable_data");
        return {p, n};
    }

    const float* floats() const {
        auto [p, n] = data();
        (void)n;
        return static_cast<const float*>(p);
    }

    size_t size() const {
        auto s = shape();
        size_t n = 1;
        for (int64_t d : s) n *= static_cast<size_t>(d);
        return n;
    }

    void reshape(const std::vector<int64_t>& shape) {
        check(tk_tensor_reshape(t_, shape.data(), shape.size()),
              "tk_tensor_reshape");
    }

    void fill(double v) { check(tk_tensor_fill(t_, v), "tk_tensor_fill"); }

    /* c = this + b */
    Tensor add(const Tensor& b) const {
        Tensor c = create(dtype(), shape());
        check(tk_tensor_add(t_, b.t_, c.t_), "tk_tensor_add");
        return c;
    }

    /* c = this @ b (2-D f32). block_size > 0 uses the blocked kernel. */
    Tensor matmul(const Tensor& b, size_t block_size = 0) const {
        auto sa = shape(), sb = b.shape();
        Tensor c = create(TK_F32, {sa[0], sb[1]});
        if (block_size)
            check(tk_tensor_matmul_blocked(t_, b.t_, c.t_, block_size),
                  "tk_tensor_matmul_blocked");
        else
            check(tk_tensor_matmul(t_, b.t_, c.t_), "tk_tensor_matmul");
        return c;
    }

 private:
    explicit Tensor(TkTensor* t) : t_(t) {}
    void reset() noexcept {
        if (t_) tk_tensor_destroy(&t_);
    }
    TkTensor* t_ = nullptr;
};

inline Tensor operator+(const Tensor& a, const Tensor& b) { return a.add(b); }

/* ---- media handles ----------------------------------------------------- */

class AudioStream {
 public:
    AudioStream(TkAudioFormat fmt, uint32_t sample_rate, uint32_t channels,
                size_t capacity_frames) {
        check(tk_audio_stream_create(&s_, fmt, sample_rate, channels,
                                     capacity_frames),
              "tk_audio_stream_create");
    }
    AudioStream(AudioStream&& o) noexcept : s_(o.s_) { o.s_ = nullptr; }
    AudioStream(const AudioStream&) = delete;
    AudioStream& operator=(const AudioStream&) = delete;
    ~AudioStream() { if (s_) tk_audio_stream_destroy(&s_); }

    size_t write(const void* frames, size_t n) {
        size_t written = 0;
        check(tk_audio_stream_write(s_, frames, n, &written),
              "tk_audio_stream_write");
        return written;
    }
    size_t read(void* out, size_t max_frames) {
        size_t got = 0;
        check(tk_audio_stream_read(s_, out, max_frames, &got),
              "tk_audio_stream_read");
        return got;
    }
    void reset() { check(tk_audio_stream_reset(s_), "tk_audio_stream_reset"); }
    TkAudioStream* get() const noexcept { return s_; }

 private:
    TkAudioStream* s_ = nullptr;
};

class VisionFrame {
 public:
    VisionFrame(TkPixelFormat fmt, uint32_t width, uint32_t height) {
        check(tk_vision_frame_create(&f_, fmt, width, height),
              "tk_vision_frame_create");
    }
    VisionFrame(VisionFrame&& o) noexcept : f_(o.f_) { o.f_ = nullptr; }
    VisionFrame(const VisionFrame&) = delete;
    VisionFrame& operator=(const VisionFrame&) = delete;
    ~VisionFrame() { if (f_) tk_vision_frame_destroy(&f_); }

    std::pair<void*, size_t> mutable_data() {
        void* p; size_t n;
        check(tk_vision_frame_get_mutable_data(f_, &p, &n),
              "tk_vision_frame_get_mutable_data");
        return {p, n};
    }
    struct Info { TkPixelFormat fmt; uint32_t width, height; };
    Info info() const {
        Info i{};
        check(tk_vision_frame_get_info(f_, &i.fmt, &i.width, &i.height),
              "tk_vision_frame_get_info");
        return i;
    }
    TkVisionFrame* get() const noexcept { return f_; }

 private:
    TkVisionFrame* f_ = nullptr;
};

/* ---- Context + module bus ---------------------------------------------- */

/* Executor signature for C++ modules: return an output tensor (or an
 * empty Tensor) for the given command + optional input. Throwing maps
 * to TK_ERR_OPERATION_FAILED on the C side. */
using Executor =
    std::function<Tensor(const std::string& command, const Tensor* input)>;

using AsyncCallback =
    std::function<void(TkStatus status, std::optional<Tensor> result)>;

class Context {
 public:
    Context() { check(tk_context_create(&ctx_), "tk_context_create"); }
    Context(Context&& o) noexcept : ctx_(o.ctx_) { o.ctx_ = nullptr; }
    Context(const Context&) = delete;
    Context& operator=(const Context&) = delete;
    ~Context() {
        /* In-flight async jobs may still reference executor state. */
        if (ctx_) {
            tk_context_drain(ctx_);
            for (auto& kv : executors_) {
                tk_context_unregister_module(ctx_, kv.first);
            }
            tk_context_destroy(&ctx_);
        }
    }

    TkContext* get() const noexcept { return ctx_; }

    void register_module(int32_t module, Executor fn) {
        auto holder = std::make_unique<Executor>(std::move(fn));
        check(tk_context_register_module(ctx_, module, &Context::trampoline,
                                         holder.get()),
              "tk_context_register_module");
        executors_[module] = std::move(holder);
    }

    void unregister_module(int32_t module) {
        check(tk_context_unregister_module(ctx_, module),
              "tk_context_unregister_module");
        /* A queued job may have copied the executor pointer before the
         * unregister landed — drain before dropping the state. */
        tk_context_drain(ctx_);
        executors_.erase(module);
    }

    /* Synchronous command; returns the output tensor if any. */
    std::optional<Tensor> execute(int32_t module, const std::string& command,
                                  const Tensor* input = nullptr) {
        TkTensor* out = nullptr;
        check(tk_module_execute_command(ctx_, module, command.c_str(),
                                        input ? input->get() : nullptr,
                                        &out, nullptr, nullptr),
              "tk_module_execute_command");
        if (!out) return std::nullopt;
        return Tensor::adopt(out);
    }

    /* Async command on the context worker pool; the callback owns the
     * result tensor. The std::function is freed after it fires. */
    void execute_async(int32_t module, const std::string& command,
                       const Tensor* input, AsyncCallback cb) {
        auto holder = new AsyncCallback(std::move(cb));
        TkStatus s = tk_module_execute_command(
            ctx_, module, command.c_str(),
            input ? input->get() : nullptr, nullptr,
            &Context::async_trampoline, holder);
        if (s != TK_OK) {
            delete holder;
            check(s, "tk_module_execute_command(async)");
        }
    }

    void drain() { check(tk_context_drain(ctx_), "tk_context_drain"); }

 private:
    static TkStatus trampoline(const char* command, const TkTensor* input,
                               TkTensor** output, void* state) {
        auto* fn = static_cast<Executor*>(state);
        /* The input is BORROWED (caller owns it): wrap it non-owning
         * and guarantee release on every path, including throws. */
        Tensor in_view = Tensor::adopt(const_cast<TkTensor*>(input));
        struct Borrow {
            Tensor* t;
            ~Borrow() { t->release(); }
        } borrow{&in_view};
        const Tensor* in_ptr = input ? &in_view : nullptr;
        try {
            Tensor out = (*fn)(command, in_ptr);
            if (output && out) *output = out.release();
            return TK_OK;
        } catch (...) {
            return TK_ERR_OPERATION_FAILED;
        }
    }

    static void async_trampoline(TkStatus status, TkTensor* result,
                                 void* user_data) {
        std::unique_ptr<AsyncCallback> cb(
            static_cast<AsyncCallback*>(user_data));
        std::optional<Tensor> t;
        if (result) t = Tensor::adopt(result);
        try {
            (*cb)(status, std::move(t));
        } catch (...) {
            /* callbacks must not propagate through the C layer */
        }
    }

    TkContext* ctx_ = nullptr;
    std::unordered_map<int32_t, std::unique_ptr<Executor>> executors_;
};

/* RAII module registration: unregisters (with drain) on scope exit. */
class ModuleGuard {
 public:
    ModuleGuard(Context& ctx, int32_t module, Executor fn)
        : ctx_(&ctx), module_(module) {
        ctx.register_module(module, std::move(fn));
    }
    ModuleGuard(const ModuleGuard&) = delete;
    ModuleGuard& operator=(const ModuleGuard&) = delete;
    ~ModuleGuard() {
        if (ctx_) {
            try { ctx_->unregister_module(module_); } catch (...) {}
        }
    }

 private:
    Context* ctx_;
    int32_t module_;
};

}  /* namespace tk */

#endif  /* TRACKIE_FFI_HPP_ */
