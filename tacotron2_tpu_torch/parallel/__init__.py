"""Parallelism over a torch.distributed process group.

Counterpart of tacotron2_tpu/parallel/: the JAX package's ('data',
'model') mesh becomes one process per card laid out as (data × model)
(`dist.py`): each data shard steps on its rows of the global batch, and
the 'model' axis channel-shards the WaveNet's residual blocks
(`partition.py`).
"""

from .dist import (DataParallel, activate, all_gather_rows,  # noqa: F401
                   current, host_shard_indices, maybe_initialize_distributed,
                   rank_world, shard_batch, shutdown)
