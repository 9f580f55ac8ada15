"""Cortex: the reasoning core — event loop, contextual reasoner,
decision engine, world model, long-term memory. TPU-native replacement
for the reference's src/cortex (C event loop + Rust reasoning crate)."""

from trackiellm_tpu_torch.cortex.reasoner import ContextualReasoner  # noqa: F401
from trackiellm_tpu_torch.cortex.decision import DecisionEngine  # noqa: F401
from trackiellm_tpu_torch.cortex.world_model import WorldModel  # noqa: F401
from trackiellm_tpu_torch.cortex.memory import MemoryManager  # noqa: F401
from trackiellm_tpu_torch.cortex.main import (  # noqa: F401
    Cortex,
    CortexConfig,
    CortexState,
)
