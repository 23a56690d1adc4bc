"""tacotron2_tpu_torch: the PyTorch/CUDA port of tacotron2_tpu.

Mirrors the JAX package's layout and names. Plain tensor code is PyTorch;
each Pallas TPU kernel on a ported path has a hand-written CUDA kernel under
`csrc/`, built with nvcc and bound through ctypes (`native/build.py`), with
a plain PyTorch version beside it in `ops/`. Weights come from the JAX
package's flax msgpack checkpoints (`utils/flax_msgpack.py`, `convert.py`).

Every entry point takes `device=` and defaults to "cuda".
"""

__version__ = "0.1.0"

from .config import Config, default_config, get_config, paper_config  # noqa: F401
