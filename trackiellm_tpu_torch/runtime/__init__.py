"""Host runtime: event bus, task manager, device feeding, inference
scheduling, hardware workers. Replacement for the reference's Rust
orchestration shell (src/main.rs, src/event_bus, src/workers,
src/async_tasks)."""

from trackiellm_tpu_torch.runtime.event_bus import EventBus, TrackieEvent  # noqa: F401
from trackiellm_tpu_torch.runtime.tasks import TaskManager  # noqa: F401
from trackiellm_tpu_torch.runtime.buffers import DoubleBufferedFeeder  # noqa: F401
from trackiellm_tpu_torch.runtime.scheduler import (  # noqa: F401
    InferenceScheduler,
    JobKind,
)
