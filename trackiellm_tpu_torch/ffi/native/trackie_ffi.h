/* Embeddable stable C ABI: context, tensors, media handles, module bus.
 *
 * Parity surface: the reference's external FFI API consumed by bindings
 * and companion apps — TkContext/TkTensor/TkAudioStream/TkVisionFrame
 * opaque handles, tensor create/reshape/fill/add/matmul/matmul_blocked,
 * and the async tk_module_execute_command + TkCallback bus
 * (reference: src/ffi/c_api/tk_ffi_api.h:74-98, 251-382, 404-526,
 * 545-567). Implementation is original C++17 (trackie_ffi.cpp).
 *
 * Division of labor in the PyTorch port: device math lives in PyTorch
 * and the CUDA kernels (Python side); this surface is the HOST-side
 * embedder API — small tensors for module commands, media staging
 * buffers, and the module registry that lets a C/C++ host application
 * drive the framework's subsystems (the Python runtime registers
 * executors through tk_context_register_module via ctypes trampolines).
 *
 * Build: g++ -O2 -shared -fPIC -std=c++17 \
 *            -o libtrackie_runtime.so trackie_runtime.cpp trackie_ffi.cpp
 */

#ifndef TRACKIE_FFI_H_
#define TRACKIE_FFI_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- status / enums --------------------------------------------------- */

typedef enum {
    TK_OK                       = 0,
    TK_ERR_NULL_POINTER         = -1,
    TK_ERR_INVALID_ARGUMENT     = -2,
    TK_ERR_ALLOCATION_FAILED    = -3,
    TK_ERR_INVALID_HANDLE       = -4,
    TK_ERR_MODULE_NOT_REGISTERED = -5,
    TK_ERR_OPERATION_FAILED     = -6,
    TK_ERR_UNSUPPORTED          = -7,
    TK_ERR_TIMEOUT              = -9,
    TK_ERR_UNKNOWN              = -100
} TkStatus;

/* Sparse ids so new modules never break binary compatibility. */
typedef enum {
    TK_MODULE_CORTEX      = 0,
    TK_MODULE_VISION      = 10,
    TK_MODULE_AUDIO       = 20,
    TK_MODULE_SENSORS     = 30,
    TK_MODULE_NAVIGATION  = 40,
    TK_MODULE_CUSTOM_BASE = 1000
} TkModuleType;

typedef enum {
    TK_F32 = 0,
    TK_I32 = 1,
    TK_U8  = 2
} TkDataType;

typedef enum {
    TK_AUDIO_S16LE = 0,
    TK_AUDIO_F32   = 2
} TkAudioFormat;

typedef enum {
    TK_PIXEL_RGB24 = 1,
    TK_PIXEL_BGR24 = 2,
    TK_PIXEL_GRAY8 = 3
} TkPixelFormat;

/* ---- opaque handles ---------------------------------------------------- */

typedef struct TkContext TkContext;
typedef struct TkTensor TkTensor;
typedef struct TkAudioStream TkAudioStream;
typedef struct TkVisionFrame TkVisionFrame;

/* ---- thread-local error string ----------------------------------------- */

/* Valid until the next FFI call on the same thread; never free it. */
const char* tk_ffi_last_error(void);

/* ---- context ------------------------------------------------------------ */

TkStatus tk_context_create(TkContext** out);
TkStatus tk_context_destroy(TkContext** ctx);   /* nulls the handle */

/* ---- tensors (host-side, dense, row-major) ------------------------------ */

#define TK_TENSOR_MAX_DIMS 8

TkStatus tk_tensor_create(TkTensor** out, TkDataType dtype,
                          const int64_t* shape, size_t ndims);
TkStatus tk_tensor_destroy(TkTensor** t);
TkStatus tk_tensor_get_data(const TkTensor* t, const void** data,
                            size_t* nbytes);
TkStatus tk_tensor_get_mutable_data(TkTensor* t, void** data,
                                    size_t* nbytes);
TkStatus tk_tensor_get_shape(const TkTensor* t, int64_t* shape_out,
                             size_t* ndims_inout);
TkStatus tk_tensor_dtype(const TkTensor* t, TkDataType* out);
/* Same element count required; strides are recomputed (row-major). */
TkStatus tk_tensor_reshape(TkTensor* t, const int64_t* shape,
                           size_t ndims);
TkStatus tk_tensor_fill(TkTensor* t, double value);
/* c = a + b (elementwise; shapes must match; f32/i32 only). */
TkStatus tk_tensor_add(const TkTensor* a, const TkTensor* b, TkTensor* c);
/* c = a @ b for 2-D f32 tensors (naive ikj loop). */
TkStatus tk_tensor_matmul(const TkTensor* a, const TkTensor* b,
                          TkTensor* c);
/* Cache-blocked variant; block_size 0 picks a default (64). */
TkStatus tk_tensor_matmul_blocked(const TkTensor* a, const TkTensor* b,
                                  TkTensor* c, size_t block_size);

/* ---- audio stream (sample FIFO for staging capture/playback) ----------- */

TkStatus tk_audio_stream_create(TkAudioStream** out, TkAudioFormat fmt,
                                uint32_t sample_rate, uint32_t channels,
                                size_t capacity_frames);
TkStatus tk_audio_stream_destroy(TkAudioStream** s);
/* Returns frames actually written (may be < frames when full). */
TkStatus tk_audio_stream_write(TkAudioStream* s, const void* frames,
                               size_t n_frames, size_t* written_out);
TkStatus tk_audio_stream_read(TkAudioStream* s, void* out,
                              size_t max_frames, size_t* read_out);
TkStatus tk_audio_stream_reset(TkAudioStream* s);

/* ---- vision frame (pixel staging buffer) -------------------------------- */

TkStatus tk_vision_frame_create(TkVisionFrame** out, TkPixelFormat fmt,
                                uint32_t width, uint32_t height);
TkStatus tk_vision_frame_destroy(TkVisionFrame** f);
TkStatus tk_vision_frame_get_data(const TkVisionFrame* f,
                                  const void** data, size_t* nbytes);
TkStatus tk_vision_frame_get_mutable_data(TkVisionFrame* f, void** data,
                                          size_t* nbytes);
TkStatus tk_vision_frame_get_info(const TkVisionFrame* f,
                                  TkPixelFormat* fmt, uint32_t* width,
                                  uint32_t* height);

/* ---- module bus ---------------------------------------------------------- */

/* Executor contract: consume `command` + optional input tensor, produce
 * an optional output tensor (ownership passes to the caller / callback).
 * `state` is the pointer given at registration. */
typedef TkStatus (*TkModuleExecutor)(const char* command,
                                     const TkTensor* input,
                                     TkTensor** output,
                                     void* state);

typedef void (*TkCallback)(TkStatus status, TkTensor* result,
                           void* user_data);

TkStatus tk_context_register_module(TkContext* ctx, int32_t module,
                                    TkModuleExecutor executor,
                                    void* state);
TkStatus tk_context_unregister_module(TkContext* ctx, int32_t module);

/* callback == NULL: synchronous — the executor runs on the calling
 * thread and `*sync_result` (if non-NULL) receives the output tensor.
 * callback != NULL: the command is queued on the context's worker pool
 * and the callback fires with (status, result, user_data); the callback
 * owns `result`. */
TkStatus tk_module_execute_command(TkContext* ctx, int32_t module,
                                   const char* command,
                                   const TkTensor* input,
                                   TkTensor** sync_result,
                                   TkCallback callback, void* user_data);

/* Blocks until all queued async commands have completed. */
TkStatus tk_context_drain(TkContext* ctx);

/* ---- misc ----------------------------------------------------------------- */

TkStatus tk_aligned_alloc64(void** out, size_t size);
void     tk_aligned_free64(void* p);
const char* tk_version_string(void);
void     tk_version_numbers(uint32_t* major, uint32_t* minor,
                            uint32_t* patch);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* TRACKIE_FFI_H_ */
