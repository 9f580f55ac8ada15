"""User interaction: feedback manager + voice command parsing.
Replacement for the reference's src/interaction (C feedback manager +
Rust command parser)."""

from trackiellm_tpu_torch.interaction.feedback import (  # noqa: F401
    FeedbackManager,
    FeedbackPriority,
)
from trackiellm_tpu_torch.interaction.commands import (  # noqa: F401
    CommandParser,
    ParsedCommand,
)
