// Embeddable stable C ABI implementation (see trackie_ffi.h).
//
// Original C++17; behavioral parity with the reference's external FFI
// surface (src/ffi/c_api/tk_ffi_api.h) — opaque handles, thread-local
// error strings, a module registry, and an async command bus backed by
// a small worker pool.

#include "trackie_ffi.h"

#include <atomic>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// thread-local error
// ---------------------------------------------------------------------------

namespace {

thread_local std::string g_last_error;

TkStatus fail(TkStatus s, const char* msg) {
    g_last_error = msg ? msg : "";
    return s;
}

}  // namespace

extern "C" const char* tk_ffi_last_error(void) {
    return g_last_error.c_str();
}

// ---------------------------------------------------------------------------
// tensor
// ---------------------------------------------------------------------------

struct TkTensor {
    TkDataType dtype;
    std::vector<int64_t> shape;
    std::vector<uint8_t> data;  // row-major

    size_t elem_size() const {
        return dtype == TK_U8 ? 1 : 4;
    }
    int64_t count() const {
        int64_t n = 1;
        for (int64_t d : shape) n *= d;
        return n;
    }
};

extern "C" TkStatus tk_tensor_create(TkTensor** out, TkDataType dtype,
                                     const int64_t* shape, size_t ndims) {
    if (!out || (!shape && ndims > 0))
        return fail(TK_ERR_NULL_POINTER, "tensor_create: null arg");
    if (ndims > TK_TENSOR_MAX_DIMS)
        return fail(TK_ERR_INVALID_ARGUMENT, "tensor_create: too many dims");
    if (dtype != TK_F32 && dtype != TK_I32 && dtype != TK_U8)
        return fail(TK_ERR_INVALID_ARGUMENT, "tensor_create: bad dtype");
    int64_t n = 1;
    for (size_t i = 0; i < ndims; i++) {
        if (shape[i] < 0)
            return fail(TK_ERR_INVALID_ARGUMENT,
                        "tensor_create: negative dim");
        n *= shape[i];
    }
    auto* t = new (std::nothrow) TkTensor();
    if (!t) return fail(TK_ERR_ALLOCATION_FAILED, "tensor_create: oom");
    t->dtype = dtype;
    t->shape.assign(shape, shape + ndims);
    try {
        t->data.assign(static_cast<size_t>(n) * t->elem_size(), 0);
    } catch (...) {
        delete t;
        return fail(TK_ERR_ALLOCATION_FAILED, "tensor_create: oom");
    }
    *out = t;
    return TK_OK;
}

extern "C" TkStatus tk_tensor_destroy(TkTensor** t) {
    if (!t) return fail(TK_ERR_NULL_POINTER, "tensor_destroy: null");
    delete *t;
    *t = nullptr;
    return TK_OK;
}

extern "C" TkStatus tk_tensor_get_data(const TkTensor* t, const void** data,
                                       size_t* nbytes) {
    if (!t || !data) return fail(TK_ERR_NULL_POINTER, "get_data: null");
    *data = t->data.data();
    if (nbytes) *nbytes = t->data.size();
    return TK_OK;
}

extern "C" TkStatus tk_tensor_get_mutable_data(TkTensor* t, void** data,
                                               size_t* nbytes) {
    if (!t || !data) return fail(TK_ERR_NULL_POINTER, "get_mut: null");
    *data = t->data.data();
    if (nbytes) *nbytes = t->data.size();
    return TK_OK;
}

extern "C" TkStatus tk_tensor_get_shape(const TkTensor* t,
                                        int64_t* shape_out,
                                        size_t* ndims_inout) {
    if (!t || !ndims_inout)
        return fail(TK_ERR_NULL_POINTER, "get_shape: null");
    if (shape_out) {
        size_t n = t->shape.size() < *ndims_inout ? t->shape.size()
                                                  : *ndims_inout;
        for (size_t i = 0; i < n; i++) shape_out[i] = t->shape[i];
    }
    *ndims_inout = t->shape.size();
    return TK_OK;
}

extern "C" TkStatus tk_tensor_dtype(const TkTensor* t, TkDataType* out) {
    if (!t || !out) return fail(TK_ERR_NULL_POINTER, "dtype: null");
    *out = t->dtype;
    return TK_OK;
}

extern "C" TkStatus tk_tensor_reshape(TkTensor* t, const int64_t* shape,
                                      size_t ndims) {
    if (!t || !shape) return fail(TK_ERR_NULL_POINTER, "reshape: null");
    if (ndims > TK_TENSOR_MAX_DIMS)
        return fail(TK_ERR_INVALID_ARGUMENT, "reshape: too many dims");
    int64_t n = 1;
    for (size_t i = 0; i < ndims; i++) n *= shape[i];
    if (n != t->count())
        return fail(TK_ERR_INVALID_ARGUMENT, "reshape: element count");
    t->shape.assign(shape, shape + ndims);
    return TK_OK;
}

extern "C" TkStatus tk_tensor_fill(TkTensor* t, double value) {
    if (!t) return fail(TK_ERR_NULL_POINTER, "fill: null");
    int64_t n = t->count();
    switch (t->dtype) {
        case TK_F32: {
            float v = static_cast<float>(value);
            auto* p = reinterpret_cast<float*>(t->data.data());
            for (int64_t i = 0; i < n; i++) p[i] = v;
            break;
        }
        case TK_I32: {
            int32_t v = static_cast<int32_t>(value);
            auto* p = reinterpret_cast<int32_t*>(t->data.data());
            for (int64_t i = 0; i < n; i++) p[i] = v;
            break;
        }
        case TK_U8: {
            uint8_t v = static_cast<uint8_t>(value);
            std::memset(t->data.data(), v, t->data.size());
            break;
        }
    }
    return TK_OK;
}

extern "C" TkStatus tk_tensor_add(const TkTensor* a, const TkTensor* b,
                                  TkTensor* c) {
    if (!a || !b || !c) return fail(TK_ERR_NULL_POINTER, "add: null");
    if (a->dtype != b->dtype || a->dtype != c->dtype)
        return fail(TK_ERR_INVALID_ARGUMENT, "add: dtype mismatch");
    if (a->shape != b->shape || a->shape != c->shape)
        return fail(TK_ERR_INVALID_ARGUMENT, "add: shape mismatch");
    int64_t n = a->count();
    if (a->dtype == TK_F32) {
        auto* pa = reinterpret_cast<const float*>(a->data.data());
        auto* pb = reinterpret_cast<const float*>(b->data.data());
        auto* pc = reinterpret_cast<float*>(c->data.data());
        for (int64_t i = 0; i < n; i++) pc[i] = pa[i] + pb[i];
    } else if (a->dtype == TK_I32) {
        auto* pa = reinterpret_cast<const int32_t*>(a->data.data());
        auto* pb = reinterpret_cast<const int32_t*>(b->data.data());
        auto* pc = reinterpret_cast<int32_t*>(c->data.data());
        for (int64_t i = 0; i < n; i++) pc[i] = pa[i] + pb[i];
    } else {
        return fail(TK_ERR_UNSUPPORTED, "add: u8 unsupported");
    }
    return TK_OK;
}

namespace {

TkStatus matmul_checks(const TkTensor* a, const TkTensor* b,
                       const TkTensor* c, int64_t* m, int64_t* k,
                       int64_t* n) {
    if (!a || !b || !c) return fail(TK_ERR_NULL_POINTER, "matmul: null");
    if (a->dtype != TK_F32 || b->dtype != TK_F32 || c->dtype != TK_F32)
        return fail(TK_ERR_UNSUPPORTED, "matmul: f32 only");
    if (a->shape.size() != 2 || b->shape.size() != 2 ||
        c->shape.size() != 2)
        return fail(TK_ERR_INVALID_ARGUMENT, "matmul: 2-D only");
    if (a->shape[1] != b->shape[0] || c->shape[0] != a->shape[0] ||
        c->shape[1] != b->shape[1])
        return fail(TK_ERR_INVALID_ARGUMENT, "matmul: shape mismatch");
    *m = a->shape[0];
    *k = a->shape[1];
    *n = b->shape[1];
    return TK_OK;
}

}  // namespace

extern "C" TkStatus tk_tensor_matmul(const TkTensor* a, const TkTensor* b,
                                     TkTensor* c) {
    int64_t m, k, n;
    TkStatus s = matmul_checks(a, b, c, &m, &k, &n);
    if (s != TK_OK) return s;
    auto* pa = reinterpret_cast<const float*>(a->data.data());
    auto* pb = reinterpret_cast<const float*>(b->data.data());
    auto* pc = reinterpret_cast<float*>(c->data.data());
    std::memset(pc, 0, c->data.size());
    for (int64_t i = 0; i < m; i++)
        for (int64_t kk = 0; kk < k; kk++) {
            float av = pa[i * k + kk];
            const float* brow = pb + kk * n;
            float* crow = pc + i * n;
            for (int64_t j = 0; j < n; j++) crow[j] += av * brow[j];
        }
    return TK_OK;
}

extern "C" TkStatus tk_tensor_matmul_blocked(const TkTensor* a,
                                             const TkTensor* b, TkTensor* c,
                                             size_t block_size) {
    int64_t m, k, n;
    TkStatus s = matmul_checks(a, b, c, &m, &k, &n);
    if (s != TK_OK) return s;
    int64_t bs = block_size ? static_cast<int64_t>(block_size) : 64;
    auto* pa = reinterpret_cast<const float*>(a->data.data());
    auto* pb = reinterpret_cast<const float*>(b->data.data());
    auto* pc = reinterpret_cast<float*>(c->data.data());
    std::memset(pc, 0, c->data.size());
    for (int64_t i0 = 0; i0 < m; i0 += bs)
        for (int64_t k0 = 0; k0 < k; k0 += bs)
            for (int64_t j0 = 0; j0 < n; j0 += bs) {
                int64_t im = i0 + bs < m ? i0 + bs : m;
                int64_t km = k0 + bs < k ? k0 + bs : k;
                int64_t jm = j0 + bs < n ? j0 + bs : n;
                for (int64_t i = i0; i < im; i++)
                    for (int64_t kk = k0; kk < km; kk++) {
                        float av = pa[i * k + kk];
                        const float* brow = pb + kk * n;
                        float* crow = pc + i * n;
                        for (int64_t j = j0; j < jm; j++)
                            crow[j] += av * brow[j];
                    }
            }
    return TK_OK;
}

// ---------------------------------------------------------------------------
// audio stream (frame FIFO)
// ---------------------------------------------------------------------------

struct TkAudioStream {
    TkAudioFormat fmt;
    uint32_t rate;
    uint32_t channels;
    size_t frame_bytes;
    size_t capacity;  // frames
    std::deque<uint8_t> fifo;
    std::mutex mu;
};

extern "C" TkStatus tk_audio_stream_create(TkAudioStream** out,
                                           TkAudioFormat fmt,
                                           uint32_t sample_rate,
                                           uint32_t channels,
                                           size_t capacity_frames) {
    if (!out) return fail(TK_ERR_NULL_POINTER, "audio_create: null");
    if (channels == 0 || sample_rate == 0 || capacity_frames == 0)
        return fail(TK_ERR_INVALID_ARGUMENT, "audio_create: zero arg");
    size_t sample = fmt == TK_AUDIO_S16LE ? 2 : 4;
    auto* s = new (std::nothrow) TkAudioStream();
    if (!s) return fail(TK_ERR_ALLOCATION_FAILED, "audio_create: oom");
    s->fmt = fmt;
    s->rate = sample_rate;
    s->channels = channels;
    s->frame_bytes = sample * channels;
    s->capacity = capacity_frames;
    *out = s;
    return TK_OK;
}

extern "C" TkStatus tk_audio_stream_destroy(TkAudioStream** s) {
    if (!s) return fail(TK_ERR_NULL_POINTER, "audio_destroy: null");
    delete *s;
    *s = nullptr;
    return TK_OK;
}

extern "C" TkStatus tk_audio_stream_write(TkAudioStream* s,
                                          const void* frames,
                                          size_t n_frames,
                                          size_t* written_out) {
    if (!s || !frames) return fail(TK_ERR_NULL_POINTER, "audio_write: null");
    std::lock_guard<std::mutex> lk(s->mu);
    size_t have = s->fifo.size() / s->frame_bytes;
    size_t room = s->capacity > have ? s->capacity - have : 0;
    size_t w = n_frames < room ? n_frames : room;
    const uint8_t* p = static_cast<const uint8_t*>(frames);
    s->fifo.insert(s->fifo.end(), p, p + w * s->frame_bytes);
    if (written_out) *written_out = w;
    return TK_OK;
}

extern "C" TkStatus tk_audio_stream_read(TkAudioStream* s, void* out,
                                         size_t max_frames,
                                         size_t* read_out) {
    if (!s || !out) return fail(TK_ERR_NULL_POINTER, "audio_read: null");
    std::lock_guard<std::mutex> lk(s->mu);
    size_t have = s->fifo.size() / s->frame_bytes;
    size_t r = max_frames < have ? max_frames : have;
    uint8_t* p = static_cast<uint8_t*>(out);
    for (size_t i = 0; i < r * s->frame_bytes; i++) {
        p[i] = s->fifo.front();
        s->fifo.pop_front();
    }
    if (read_out) *read_out = r;
    return TK_OK;
}

extern "C" TkStatus tk_audio_stream_reset(TkAudioStream* s) {
    if (!s) return fail(TK_ERR_NULL_POINTER, "audio_reset: null");
    std::lock_guard<std::mutex> lk(s->mu);
    s->fifo.clear();
    return TK_OK;
}

// ---------------------------------------------------------------------------
// vision frame
// ---------------------------------------------------------------------------

struct TkVisionFrame {
    TkPixelFormat fmt;
    uint32_t width, height;
    std::vector<uint8_t> pixels;
};

extern "C" TkStatus tk_vision_frame_create(TkVisionFrame** out,
                                           TkPixelFormat fmt,
                                           uint32_t width, uint32_t height) {
    if (!out) return fail(TK_ERR_NULL_POINTER, "frame_create: null");
    if (width == 0 || height == 0)
        return fail(TK_ERR_INVALID_ARGUMENT, "frame_create: zero dim");
    size_t bpp = fmt == TK_PIXEL_GRAY8 ? 1 : 3;
    auto* f = new (std::nothrow) TkVisionFrame();
    if (!f) return fail(TK_ERR_ALLOCATION_FAILED, "frame_create: oom");
    f->fmt = fmt;
    f->width = width;
    f->height = height;
    try {
        f->pixels.assign(static_cast<size_t>(width) * height * bpp, 0);
    } catch (...) {
        delete f;
        return fail(TK_ERR_ALLOCATION_FAILED, "frame_create: oom");
    }
    *out = f;
    return TK_OK;
}

extern "C" TkStatus tk_vision_frame_destroy(TkVisionFrame** f) {
    if (!f) return fail(TK_ERR_NULL_POINTER, "frame_destroy: null");
    delete *f;
    *f = nullptr;
    return TK_OK;
}

extern "C" TkStatus tk_vision_frame_get_data(const TkVisionFrame* f,
                                             const void** data,
                                             size_t* nbytes) {
    if (!f || !data) return fail(TK_ERR_NULL_POINTER, "frame_data: null");
    *data = f->pixels.data();
    if (nbytes) *nbytes = f->pixels.size();
    return TK_OK;
}

extern "C" TkStatus tk_vision_frame_get_mutable_data(TkVisionFrame* f,
                                                     void** data,
                                                     size_t* nbytes) {
    if (!f || !data) return fail(TK_ERR_NULL_POINTER, "frame_mut: null");
    *data = f->pixels.data();
    if (nbytes) *nbytes = f->pixels.size();
    return TK_OK;
}

extern "C" TkStatus tk_vision_frame_get_info(const TkVisionFrame* f,
                                             TkPixelFormat* fmt,
                                             uint32_t* width,
                                             uint32_t* height) {
    if (!f) return fail(TK_ERR_NULL_POINTER, "frame_info: null");
    if (fmt) *fmt = f->fmt;
    if (width) *width = f->width;
    if (height) *height = f->height;
    return TK_OK;
}

// ---------------------------------------------------------------------------
// context: module registry + worker pool
// ---------------------------------------------------------------------------

struct TkContext {
    struct Module {
        TkModuleExecutor executor;
        void* state;
    };
    struct Job {
        int32_t module;
        std::string command;
        const TkTensor* input;
        TkCallback callback;
        void* user_data;
    };

    std::map<int32_t, Module> modules;
    std::mutex reg_mu;

    std::deque<Job> jobs;
    std::mutex job_mu;
    std::condition_variable job_cv;
    std::condition_variable drain_cv;
    size_t in_flight = 0;
    bool stopping = false;
    std::vector<std::thread> workers;

    void worker_loop() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lk(job_mu);
                job_cv.wait(lk, [&] { return stopping || !jobs.empty(); });
                if (stopping && jobs.empty()) return;
                job = std::move(jobs.front());
                jobs.pop_front();
                in_flight++;
            }
            TkTensor* result = nullptr;
            TkStatus s = run(job.module, job.command.c_str(), job.input,
                             &result);
            if (job.callback) {
                job.callback(s, result, job.user_data);
            } else if (result) {
                tk_tensor_destroy(&result);
            }
            {
                std::lock_guard<std::mutex> lk(job_mu);
                in_flight--;
            }
            drain_cv.notify_all();
        }
    }

    TkStatus run(int32_t module, const char* command, const TkTensor* input,
                 TkTensor** output) {
        Module mod;
        {
            std::lock_guard<std::mutex> lk(reg_mu);
            auto it = modules.find(module);
            if (it == modules.end())
                return fail(TK_ERR_MODULE_NOT_REGISTERED,
                            "module not registered");
            mod = it->second;
        }
        return mod.executor(command, input, output, mod.state);
    }
};

extern "C" TkStatus tk_context_create(TkContext** out) {
    if (!out) return fail(TK_ERR_NULL_POINTER, "context_create: null");
    auto* ctx = new (std::nothrow) TkContext();
    if (!ctx) return fail(TK_ERR_ALLOCATION_FAILED, "context_create: oom");
    for (int i = 0; i < 2; i++)
        ctx->workers.emplace_back([ctx] { ctx->worker_loop(); });
    *out = ctx;
    return TK_OK;
}

extern "C" TkStatus tk_context_destroy(TkContext** pctx) {
    if (!pctx) return fail(TK_ERR_NULL_POINTER, "context_destroy: null");
    TkContext* ctx = *pctx;
    if (ctx) {
        {
            std::lock_guard<std::mutex> lk(ctx->job_mu);
            ctx->stopping = true;
        }
        ctx->job_cv.notify_all();
        for (auto& t : ctx->workers) t.join();
        delete ctx;
    }
    *pctx = nullptr;
    return TK_OK;
}

extern "C" TkStatus tk_context_register_module(TkContext* ctx,
                                               int32_t module,
                                               TkModuleExecutor executor,
                                               void* state) {
    if (!ctx || !executor)
        return fail(TK_ERR_NULL_POINTER, "register_module: null");
    std::lock_guard<std::mutex> lk(ctx->reg_mu);
    if (ctx->modules.count(module))
        return fail(TK_ERR_INVALID_ARGUMENT,
                    "register_module: already registered");
    ctx->modules[module] = {executor, state};
    return TK_OK;
}

extern "C" TkStatus tk_context_unregister_module(TkContext* ctx,
                                                 int32_t module) {
    if (!ctx) return fail(TK_ERR_NULL_POINTER, "unregister_module: null");
    std::lock_guard<std::mutex> lk(ctx->reg_mu);
    ctx->modules.erase(module);
    return TK_OK;
}

extern "C" TkStatus tk_module_execute_command(TkContext* ctx, int32_t module,
                                              const char* command,
                                              const TkTensor* input,
                                              TkTensor** sync_result,
                                              TkCallback callback,
                                              void* user_data) {
    if (!ctx || !command)
        return fail(TK_ERR_NULL_POINTER, "execute_command: null");
    if (!callback) {
        TkTensor* result = nullptr;
        TkStatus s = ctx->run(module, command, input, &result);
        if (sync_result) {
            *sync_result = result;
        } else if (result) {
            tk_tensor_destroy(&result);
        }
        return s;
    }
    {
        std::lock_guard<std::mutex> lk(ctx->job_mu);
        if (ctx->stopping)
            return fail(TK_ERR_OPERATION_FAILED,
                        "execute_command: context shutting down");
        ctx->jobs.push_back({module, command, input, callback, user_data});
    }
    ctx->job_cv.notify_one();
    return TK_OK;
}

extern "C" TkStatus tk_context_drain(TkContext* ctx) {
    if (!ctx) return fail(TK_ERR_NULL_POINTER, "drain: null");
    std::unique_lock<std::mutex> lk(ctx->job_mu);
    ctx->drain_cv.wait(lk, [&] {
        return ctx->jobs.empty() && ctx->in_flight == 0;
    });
    return TK_OK;
}

// ---------------------------------------------------------------------------
// misc
// ---------------------------------------------------------------------------

extern "C" TkStatus tk_aligned_alloc64(void** out, size_t size) {
    if (!out) return fail(TK_ERR_NULL_POINTER, "aligned_alloc: null");
    void* p = nullptr;
    if (posix_memalign(&p, 64, size ? size : 64) != 0)
        return fail(TK_ERR_ALLOCATION_FAILED, "aligned_alloc: oom");
    *out = p;
    return TK_OK;
}

extern "C" void tk_aligned_free64(void* p) { std::free(p); }

extern "C" const char* tk_version_string(void) { return "2.0.0-cuda"; }

extern "C" void tk_version_numbers(uint32_t* major, uint32_t* minor,
                                   uint32_t* patch) {
    if (major) *major = 2;
    if (minor) *minor = 0;
    if (patch) *patch = 0;
}
