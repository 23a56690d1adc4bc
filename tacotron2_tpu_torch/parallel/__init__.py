"""Parallelism: data parallelism over a torch.distributed process group.

Counterpart of tacotron2_tpu/parallel/: the JAX package's ('data',
'model') mesh becomes one process per card, each stepping on its rows of
the global batch (`dist.py`). The 'model' axis (WaveNet channel sharding,
JAX `parallel/partition.py`) is not ported.
"""

from .dist import (DataParallel, activate, all_gather_rows,  # noqa: F401
                   current, host_shard_indices, maybe_initialize_distributed,
                   rank_world, shard_batch, shutdown)
