"""Training on one device, and tensor-parallel inference over ranks.

Port of ``trackiellm_tpu/parallel/``: the shared layer body, the LM loss
and train step, perplexity and packed data on one device; the device mesh
on ``torch.distributed`` (``mesh``), the shard specs, the weight cutter and
the sharded prefill and decode (``infer``), and the rank launcher
(``launch``). The JAX package's sharding rules for training, pipeline,
ring attention and expert parallelism (``sharding``, ``pipeline``,
``ring``, ``moe``) are ROADMAP Queue 1 item 5 (ID 12); the training
functions here that take a mesh raise NotImplementedError naming it.
"""

from trackiellm_tpu_torch.parallel.data import (  # noqa: F401
    PackedDataset,
    PrefetchIterator,
)
from trackiellm_tpu_torch.parallel.evaluate import (  # noqa: F401
    evaluate_perplexity,
)
from trackiellm_tpu_torch.parallel.infer import (  # noqa: F401
    batched_kv_sharding,
    batched_mla_sharding,
    infer_param_shardings,
    kv_cache_sharding,
    local_config,
    make_sharded_decode,
    make_sharded_mla,
    make_sharded_prefill,
    mla_cache_sharding,
    mla_param_shardings,
    paged_pool_sharding,
    quant_pool_sharding,
    shard_params,
)
from trackiellm_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    build_mesh,
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
