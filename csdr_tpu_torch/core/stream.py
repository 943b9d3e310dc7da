"""Host-side streaming runner (counterpart of csdr_tpu.core.stream).

Feeds a long host array to a pipeline in fixed blocks on one device,
carrying the state between blocks, and gathers the output on the host.  On
the card each block is one replay of the pipeline's captured step
(``pipeline.jit_apply()``, core/graph), as csdr_tpu's runner calls
``jax.jit(pipeline.apply, donate_argnums=(0,))``; on the CPU the pipeline
runs eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core.block import VarOut, resolve_device
from csdr_tpu_torch.core import cplx

DEFAULT_BLOCK = 1 << 18  # complex samples per device block


class StreamRunner:
    """Runs a Block/Pipeline over a long host array in fixed device blocks.

    device: where the pipeline runs, CUDA by default; without CUDA this
    raises unless the caller passes ``device="cpu"``."""

    def __init__(self, pipeline, block_size: int = DEFAULT_BLOCK,
                 device="cuda"):
        self.device = resolve_device(device)
        self.pipeline = pipeline.to(self.device)
        self.block_size = block_size
        self.step = (self.pipeline.jit_apply() if self.device.type == "cuda"
                     else self.pipeline)

    @torch.no_grad()
    def run(self, x: np.ndarray, drop_warmup: bool = False) -> np.ndarray:
        """Process ``x`` in blocks; returns the concatenated output.  The
        tail of ``x`` that does not fill a whole block is dropped, as the
        reference ends its stream at a short read (csdr.c:248)."""
        n = self.block_size
        state = self.pipeline.init(self.device)
        outs = []
        for start in range(0, len(x) - n + 1, n):
            state, y = self.step(state, cplx.from_numpy(
                x[start: start + n], self.device))
            outs.append(cplx.to_numpy(y.compact() if isinstance(y, VarOut)
                                      else y))
        if not outs:
            # no full block fit: run one zero block for the output dtype
            zeros = np.zeros((n,), np.asarray(x).dtype)
            _, y = self.pipeline(state, cplx.from_numpy(zeros, self.device))
            probe = cplx.to_numpy(y.data if isinstance(y, VarOut) else y)
            return np.zeros((0,) + probe.shape[1:], probe.dtype)
        out = np.concatenate(outs)
        if drop_warmup:
            out = out[self.pipeline.warmup_out:]
        return out


def run_offline(pipeline, x: np.ndarray, block_size: int = DEFAULT_BLOCK,
                drop_warmup: bool = False, device="cuda") -> np.ndarray:
    """One-shot convenience wrapper around :class:`StreamRunner`."""
    return StreamRunner(pipeline, block_size=block_size,
                        device=device).run(x, drop_warmup=drop_warmup)
