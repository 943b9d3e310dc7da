"""csdr_tpu_torch — the PyTorch/CUDA port of csdr_tpu for NVIDIA Hopper.

Same blocks, same stream framing and same carried state as csdr_tpu, with
``torch.complex64`` streams and hand-written CUDA kernels where csdr_tpu has
Pallas kernels.  Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; without CUDA they raise rather than fall
back.  The package imports neither jax nor csdr_tpu.
"""

from csdr_tpu_torch import firdes
from csdr_tpu_torch.core.block import Block, Pipeline, VarOut, stateless
from csdr_tpu_torch.core.checkpoint import (load_state, save_state,
                                            state_from_numpy_leaves,
                                            state_to_numpy_leaves)
from csdr_tpu_torch.core.stream import StreamRunner, run_offline

__version__ = "0.1.0"

__all__ = [
    "firdes",
    "Block",
    "Pipeline",
    "VarOut",
    "stateless",
    "StreamRunner",
    "run_offline",
    "save_state",
    "load_state",
    "state_from_numpy_leaves",
    "state_to_numpy_leaves",
    "__version__",
]
