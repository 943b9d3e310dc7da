"""Block/state protocol of the PyTorch port (counterpart of csdr_tpu.core.block).

A *block* is a stream transform with an explicit carry:

    block(state, x) -> (state', y)

``state`` is a tuple of tensors (or a single tensor, or None), the
checkpointable stream history: FIR tails, NCO phases, resampler offsets.
A :class:`Pipeline` composes blocks into one transform of the same shape.

Blocks are ``nn.Module``s whose filter taps are registered buffers, so
``pipeline.to(device)`` moves every tap set with one call.  Sample streams
are ``torch.complex64`` or ``torch.float32`` tensors.

Where the state lives: sample history (tails, last samples) sits on the
stream's device.  Scalar bookkeeping that does not depend on the data
(NCO phase in cycles, the fractional decimator's occupancy and position)
is kept in 0-dim CPU tensors and advanced on the host with the same
float32 arithmetic as the JAX package, so a chunk costs no device sync to
learn its own output count.

Variable-rate blocks return a :class:`VarOut`: a fixed-capacity tensor and
the count of valid leading samples.  Where the count depends only on the
state and the chunk length it is a host ``int``; where it depends on the
samples (the timing recovery loop, the byte decoders) it is an int32
tensor on the stream's device, one count per row, so that no chunk waits
for the device to learn it.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import torch
from torch import nn


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller names the
    CPU; asking for CUDA on a machine without it raises instead of quietly
    running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "csdr_tpu_torch: CUDA is not available; pass device='cpu' to run "
            "on the CPU")
    return dev


class VarOut(NamedTuple):
    """Fixed-capacity output with a valid count: the first ``count``
    samples along the LAST axis are meaningful, the rest is padding of no
    defined value.  A multi-channel output ``(C, cap)`` of the fastddc
    blocks has one host ``int`` count shared by all channels (csdr_tpu's
    counts there are always ``jnp.full((C,), n)``); a data-dependent count
    is an int32 device tensor shaped like ``data`` without its last axis."""

    data: torch.Tensor
    count: int | torch.Tensor

    def compact(self) -> torch.Tensor:
        """The valid samples.  A device count is read to the host here."""
        if isinstance(self.count, torch.Tensor) and self.count.dim():
            raise ValueError("compact() of a per-row count: slice each row "
                             "by its own count")
        return self.data[..., : int(self.count)]


class Block(nn.Module):
    """A named, stateful stream transform.

    Subclasses implement ``init(device)`` (the zero-history state) and
    ``forward(state, x) -> (state', y)``; a block is called as
    ``block(state, x)``, where csdr_tpu writes ``block.apply(state, x)``.

    warmup_out: output samples to drop once at stream start so that the
    framing matches the reference's valid-mode output.
    rate_ratio: out_samples / in_samples (1/D for decimators); None when
    the ratio is data-dependent (VarOut producers)."""

    warmup_out: int = 0
    rate_ratio: float | None = 1.0

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def init(self, device="cuda") -> Any:
        resolve_device(device)
        return None


class _Stateless(Block):
    def __init__(self, name: str, fn: Callable[[torch.Tensor], torch.Tensor]):
        super().__init__(name)
        self.fn = fn

    def forward(self, state, x):
        if isinstance(x, VarOut):
            return state, VarOut(self.fn(x.data), x.count)
        return state, self.fn(x)


def stateless(name: str, fn: Callable[[torch.Tensor], torch.Tensor]) -> Block:
    """Wrap a pure elementwise function as a Block.  VarOut inputs pass
    through: fn maps the data and the valid count is kept."""
    return _Stateless(name, fn)


class Pipeline(Block):
    """Composition of Blocks into one ``(state, x) -> (state, y)`` call.
    The pipeline state is the tuple of per-block states."""

    def __init__(self, blocks: Sequence[Block], name: str = "pipeline"):
        super().__init__(name)
        self.blocks = nn.ModuleList(blocks)

    def init(self, device="cuda") -> tuple:
        dev = resolve_device(device)
        return tuple(b.init(dev) for b in self.blocks)

    def forward(self, state: tuple, x):
        if len(state) != len(self.blocks):
            # a silently-short zip would skip trailing blocks and return a
            # mid-pipeline intermediate as the final output
            raise ValueError(
                f"{self.name}: state has {len(state)} entries for "
                f"{len(self.blocks)} blocks")
        new_states = []
        for b, s in zip(self.blocks, state):
            s, x = b(s, x)
            new_states.append(s)
        return tuple(new_states), x

    @property
    def warmup_out(self) -> int:
        """EXACT start-of-stream samples to drop at the pipeline output:
        each block's warmup is carried through the downstream rate ratios.
        Raises if a data-dependent-rate block sits downstream of pending
        warmup, where exact framing is undefined."""
        w = 0.0
        for b in self.blocks:
            r = b.rate_ratio
            if r is None:
                if w > 0:
                    raise ValueError(
                        f"pipeline '{self.name}': block '{b.name}' has a "
                        "data-dependent rate downstream of pending warmup; "
                        "exact warmup_out is undefined — drop warmup per "
                        "block or pass drop_warmup=False")
                w = float(b.warmup_out)
            else:
                w = w * r + float(b.warmup_out)
        return int(round(w))

    @property
    def rate_ratio(self) -> float | None:
        r = 1.0
        for b in self.blocks:
            if b.rate_ratio is None:
                return None
            r *= b.rate_ratio
        return r
