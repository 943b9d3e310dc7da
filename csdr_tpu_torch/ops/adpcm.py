"""IMA ADPCM 4:1 codec (counterpart of csdr_tpu.ops.adpcm; reference
ima_adpcm.c:91-174, the public IMA/DVI ADPCM standard).  Byte domain: bit
for bit csdr_tpu's.

The codec is serial (each step's predictor is the last step's output), so
csdr_tpu runs it as one ``lax.scan`` with the integer state (prev, index),
the reference's ima_adpcm_state_t carry.  Here every entry point goes
through ``kernels/adpcm_cuda``: its CUDA kernel on the card, its plain
torch loop on the CPU.

Semantics kept: two nibbles a byte with the LOW nibble first, so a stream
has an even length (odd raises; csdr_tpu's CLI pumps pairs, as
:func:`paired_encode_block` does for a chunk of any length); the state is
int32 and carries across chunks; a waterfall row is padded with its first
value 10 times and encoded from a fresh state.

The port is held against csdr_tpu, not the reference binary: csdr_tpu's
own C goldens for this codec fail in some runs (ROADMAP §3 item 3).
"""

from __future__ import annotations

import torch

from csdr_tpu_torch.core.block import Block, VarOut, resolve_device
from csdr_tpu_torch.kernels import adpcm_cuda
from csdr_tpu_torch.kernels.adpcm_cuda import (  # noqa: F401 (csdr_tpu's)
    INDEX_ADJUST, STEP_SIZES)
from csdr_tpu_torch.ops.convert import f32_to_i16_saturating

COMPRESS_FFT_PAD_N = 10  # reference csdr.c:1739-1744


def _state_rows(state, device) -> torch.Tensor:
    """(prev, index) as ints or 0-dim tensors -> a (1, 2) int32 tensor."""
    parts = [torch.as_tensor(v, dtype=torch.int32, device=device).reshape(1)
             for v in state]
    return torch.stack(parts, dim=1)


def encode_ima_adpcm(samples: torch.Tensor, state=(0, 0)):
    """s16 samples (even count) -> packed u8, two nibbles a byte, LOW nibble
    first (reference ima_adpcm.c:146-155).  Returns (bytes, (prev, index))
    with the state as 0-dim int32 tensors."""
    x = samples.to(torch.int16).reshape(1, -1)
    packed, st = adpcm_cuda.encode(x, _state_rows(state, x.device))
    return packed.reshape(-1), (st[0, 0], st[0, 1])


def decode_ima_adpcm(packed: torch.Tensor, state=(0, 0)):
    """packed u8 -> s16 samples (two a byte).  Returns (samples, state')."""
    y = packed.to(torch.uint8).reshape(1, -1)
    out, st = adpcm_cuda.decode(y, _state_rows(state, y.device))
    return out.reshape(-1), (st[0, 0], st[0, 1])


class _CodecBlock(Block):
    def __init__(self, name: str, fn, rate_ratio: float):
        super().__init__(name)
        self.fn = fn
        self.rate_ratio = rate_ratio

    def init(self, device="cuda"):
        z = torch.zeros((), dtype=torch.int32, device=resolve_device(device))
        return (z, z.clone())

    def forward(self, state, x):
        y, state = self.fn(x, state)
        return state, y


def encode_block() -> Block:
    """Streaming encoder (s16 -> u8); state (prev, index), int32."""
    return _CodecBlock("encode_ima_adpcm_i16_u8", encode_ima_adpcm, 0.5)


def decode_block() -> Block:
    """Streaming decoder (u8 -> s16); state (prev, index), int32."""
    return _CodecBlock("decode_ima_adpcm_u8_i16", decode_ima_adpcm, 2.0)


class PairedEncodeBlock(Block):
    """The encoder fed whole sample pairs, as csdr_tpu's CLI pumps it
    (``pump(encode_block(), ..., quantum=2)``, cli.py:1303): a chunk of any
    length, a VarOut's valid samples included; an odd last sample waits in
    the state for the next chunk.  State (carry, (prev, index)): the carry
    an int16 tensor of 0 or 1 samples, (prev, index) encode_block's own,
    csdr_tpu's codec state."""

    def __init__(self):
        super().__init__("encode_ima_adpcm_i16_u8")
        self.enc = encode_block()
        self.rate_ratio = 0.5

    def init(self, device="cuda"):
        dev = resolve_device(device)
        return (torch.zeros(0, dtype=torch.int16, device=dev),
                self.enc.init(dev))

    def forward(self, state, x):
        carry, codec = state
        if isinstance(x, VarOut):
            x = x.compact()
        s16 = torch.cat([carry, x.to(torch.int16).reshape(-1)])
        keep = s16.shape[0] // 2 * 2
        codec, y = self.enc(codec, s16[:keep])
        return (s16[keep:], codec), y


def paired_encode_block() -> Block:
    """Streaming encoder (s16 -> u8) for chunks of any length, pairs kept
    whole across chunks (:class:`PairedEncodeBlock`)."""
    return PairedEncodeBlock()


def compress_fft_s16(rows: torch.Tensor) -> torch.Tensor:
    """dB rows (..., n) -> the s16 rows the waterfall codec encodes
    (reference csdr.c:1745-1768): each row's first value 10 times, then the
    row, times 100.  The cast is csdr_tpu's *direct* float32 -> int16,
    which saturates (-inf dB, a bin of zero power, gives -32768; NaN 0)."""
    pad = rows[..., :1].expand(*rows.shape[:-1], COMPRESS_FFT_PAD_N)
    return f32_to_i16_saturating(torch.cat([pad, rows], dim=-1) * 100)


def compress_fft_adpcm_f_u8(fft_row: torch.Tensor, fft_size: int):
    """Waterfall rows (..., n) -> their bytes (..., (n + 10)/2), each row
    from a fresh codec state (reference csdr.c:1745-1768), one codec launch
    for all rows.  csdr_tpu takes ``fft_size`` and does not use it, nor
    does this."""
    s16 = compress_fft_s16(fft_row.to(torch.float32))
    rows = s16.reshape(-1, s16.shape[-1])
    zeros = torch.zeros((rows.shape[0], 2), dtype=torch.int32,
                        device=rows.device)
    packed, _ = adpcm_cuda.encode(rows, zeros)
    return packed.reshape(*s16.shape[:-1], -1)
