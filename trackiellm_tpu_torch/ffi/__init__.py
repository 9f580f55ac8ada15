"""FFI layer: native C++ runtime primitives (ring buffer, event queue,
arena allocator, AEAD) bound via ctypes, plus the stable module-command
API. Port of ``trackiellm_tpu/ffi``; replacement for the reference's
src/ffi (C ABI + Rust bridge)."""

from trackiellm_tpu_torch.ffi.native import (  # noqa: F401
    NativeArena,
    NativeEventQueue,
    NativeRingBuffer,
    aead_decrypt,
    aead_encrypt,
    constant_time_compare,
    native_available,
)
from trackiellm_tpu_torch.ffi.api import (  # noqa: F401
    ModuleRegistry,
    ModuleType,
)
