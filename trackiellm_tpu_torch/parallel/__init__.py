"""Training on one device: the shared layer body, the LM loss and train
step, perplexity, and packed data.

Port of the single-device part of ``trackiellm_tpu/parallel/``. The JAX
package's device mesh, sharding rules, pipeline, ring attention, expert
parallelism and sharded inference (``mesh``, ``sharding``, ``pipeline``,
``ring``, ``moe``, ``infer``) are ROADMAP Queue 1 item 5 (ID 12); the
functions here that take a mesh raise NotImplementedError naming it.
"""

from trackiellm_tpu_torch.parallel.data import (  # noqa: F401
    PackedDataset,
    PrefetchIterator,
)
from trackiellm_tpu_torch.parallel.evaluate import (  # noqa: F401
    evaluate_perplexity,
)
from trackiellm_tpu_torch.parallel.train import (  # noqa: F401
    init_train_state,
    lm_forward_batched,
    lm_loss,
    make_optimizer,
    make_train_step,
    moe_load_balancing_loss,
    restore_train_state,
    save_train_state,
)
