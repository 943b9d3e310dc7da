"""IMA ADPCM codec over independent streams (the counterpart of csdr_tpu's
``lax.scan`` in csdr_tpu/ops/adpcm.py; no Pallas kernel there).

csdr_tpu compiles the codec's serial recurrence into one device loop.  In
eager torch the same loop is a Python loop of ~30 small ops a sample, so
the codec is hand-written CUDA, ``csrc/adpcm.cu``, two kernels:

- the encoder, one thread a stream, the state (prev, index) in registers.
  A step runs csdr_tpu's three compare-subtract stages as one add and one
  unsigned min each and picks prev' and the next step size by selects on
  their compares; the step sizes a step can lead to are read from shared
  memory a step ahead, so no table read sits on the chain
  (:func:`encode_select_plain` is that step on tensors);
- the decoder, one block a stream: both of its updates are clamped adds of
  amounts the nibbles fix, and clamped adds compose into clamped adds, so
  the index and then prev are two block-wide prefix scans of compositions
  (:func:`decode_scan_plain` is that scan on tensors).

:func:`chain_cycles` measures on the card the chains that bound them.

One signature serves every user: ``x`` (B, L) int16 and ``state`` (B, 2)
int32 (prev, index) in, packed uint8 (B, L/2) (low nibble first) and the
new state out; decode the reverse.  A fresh state per row encodes the
waterfall's rows, a carried state one audio stream.  The step-size table is
read as csdr_tpu's gather reads it: a negative index counts from the end,
then the index clamps to 0..88 (only a carried state can be out of range).

The wrappers launch the kernel for CUDA tensors, or raise; they take the
plain version (``encode_plain``, ``decode_plain``: csdr_tpu's steps as
torch ops, vectorised over B) only for CPU tensors.  ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from csdr_tpu_torch.kernels import _build

LAUNCHES = {"adpcm_encode": 0, "adpcm_decode": 0}

INDEX_ADJUST = np.array([-1, -1, -1, -1, 2, 4, 6, 8,
                         -1, -1, -1, -1, 2, 4, 6, 8], np.int32)
STEP_SIZES = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34,
    37, 41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143,
    157, 173, 190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494,
    544, 598, 658, 724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552,
    1707, 1878, 2066, 2272, 2499, 2749, 3024, 3327, 3660, 4026,
    4428, 4871, 5358, 5894, 6484, 7132, 7845, 8630, 9493, 10442,
    11487, 12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623,
    27086, 29794, 32767], np.int32)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(data: torch.Tensor, dtype, state: torch.Tensor, what: str):
    if data.dtype != dtype or data.dim() != 2:
        raise TypeError(f"{what}: want a 2-D {dtype} tensor, got "
                        f"{data.dim()}-D {data.dtype}")
    if state.dtype != torch.int32 or tuple(state.shape) != (data.shape[0], 2):
        raise TypeError(f"{what}: want an int32 state of shape "
                        f"({data.shape[0]}, 2), got {state.dtype} "
                        f"{tuple(state.shape)}")
    if state.device != data.device:
        raise ValueError(f"{what}: state on {state.device}, data on "
                         f"{data.device}")


def _launch(name: str, data: torch.Tensor, state: torch.Tensor,
            out: torch.Tensor, pairs: int):
    if data.numel() == 0:            # nothing to code: the state stands
        return out, state.clone()
    data = data.contiguous()
    if name == "adpcm_encode" and data.data_ptr() % 4:
        data = data.clone()          # the kernel reads 32-bit sample pairs
    state = state.contiguous()
    new_state = torch.empty_like(state)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    code = getattr(_build.lib(), "csdr_" + name)(
        data.data_ptr(), out.data_ptr(), state.data_ptr(),
        new_state.data_ptr(), data.shape[0], pairs, stream)
    _build.check(code, name)
    LAUNCHES[name] += 1
    return out, new_state


def encode(x: torch.Tensor, state: torch.Tensor):
    """(B, L) int16 samples, L even, and (B, 2) int32 states -> (B, L/2)
    packed uint8 and the new states.  CUDA tensors launch the kernel; CPU
    tensors take :func:`encode_plain`."""
    _check(x, torch.int16, state, "adpcm encode")
    if x.shape[1] % 2:
        raise ValueError(f"adpcm encode: {x.shape[1]} samples a row, want "
                         "an even count (two nibbles a byte)")
    if not x.is_cuda:
        return encode_plain(x, state)
    out = torch.empty((x.shape[0], x.shape[1] // 2), dtype=torch.uint8,
                      device=x.device)
    return _launch("adpcm_encode", x, state, out, x.shape[1] // 2)


def decode(y: torch.Tensor, state: torch.Tensor):
    """(B, P) packed uint8 and (B, 2) int32 states -> (B, 2P) int16 samples
    and the new states.  CUDA tensors launch the kernel; CPU tensors take
    :func:`decode_plain`."""
    _check(y, torch.uint8, state, "adpcm decode")
    if not y.is_cuda:
        return decode_plain(y, state)
    out = torch.empty((y.shape[0], 2 * y.shape[1]), dtype=torch.int16,
                      device=y.device)
    return _launch("adpcm_decode", y, state, out, y.shape[1])


def chain_cycles(kind: int, iters: int, device="cuda") -> float:
    """SM cycles a link of the probe chain that sets the codec's bound
    (``csrc/adpcm.cu``): kind 0 the encoder step's shortest chain, kind 1 a
    level of the decoder's scan; one thread, ``iters`` links.  It codes
    nothing and is not counted in ``LAUNCHES``."""
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    if not cycles.is_cuda:
        raise ValueError("adpcm chain probe: runs on a CUDA device only")
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(cycles.device).cuda_stream
    _build.check(_build.lib().csdr_adpcm_chain_probe(
        cycles.data_ptr(), sink.data_ptr(), kind, iters, stream),
        "adpcm chain probe")
    return int(cycles.item()) / iters


# ---------------------------------------------------------------------------
# plain versions: csdr_tpu's steps (ops/adpcm.py:33-61) as torch ops
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tables(device: str):
    return (torch.from_numpy(STEP_SIZES).to(device),
            torch.from_numpy(INDEX_ADJUST).to(device))


def _read_index(index):
    """The table row csdr_tpu's ``_STEPS[index]`` reads: jnp indexing counts
    a negative index from the end, then XLA's gather clamps it."""
    return torch.where(index < 0, index + 89, index).clamp(0, 88)


def _signed_dq(step, delta):
    """csdr_tpu's _decode_step difference, negative with the sign bit."""
    dq = (step >> 3) + torch.where((delta & 1) != 0, step >> 2, 0) \
        + torch.where((delta & 2) != 0, step >> 1, 0) \
        + torch.where((delta & 4) != 0, step, 0)
    return torch.where((delta & 8) != 0, -dq, dq)


def _decode_step(prev, index, delta, steps, adj):
    step = steps[_read_index(index)]
    prev = (prev + _signed_dq(step, delta)).clamp(-32768, 32767)
    index = (index + adj[delta]).clamp(0, 88)
    return prev, index


def _encode_step(prev, index, sample, steps, adj):
    step = steps[_read_index(index)]
    diff = sample - prev
    sign = diff < 0
    diff = diff.abs()
    b2 = diff >= step
    diff = torch.where(b2, diff - step, diff)
    step1 = step >> 1
    b1 = diff >= step1
    diff = torch.where(b1, diff - step1, diff)
    b0 = diff >= (step1 >> 1)
    delta = (sign.int() * 8 + b2.int() * 4 + b1.int() * 2 + b0.int())
    prev, index = _decode_step(prev, index, delta, steps, adj)
    return prev, index, delta


def encode_plain(x: torch.Tensor, state: torch.Tensor):
    """:func:`encode` as a loop over the samples of torch ops on B rows."""
    steps, adj = _tables(str(x.device))
    prev, index = state[:, 0].clone(), state[:, 1].clone()
    xi = x.to(torch.int32)
    deltas = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    for t in range(x.shape[1]):
        prev, index, deltas[:, t] = _encode_step(prev, index, xi[:, t],
                                                 steps, adj)
    packed = deltas[:, 0::2] | (deltas[:, 1::2] << 4)
    return packed.to(torch.uint8), torch.stack([prev, index], dim=1)


def decode_plain(y: torch.Tensor, state: torch.Tensor):
    """:func:`decode` as a loop over the nibbles of torch ops on B rows."""
    steps, adj = _tables(str(y.device))
    prev, index = state[:, 0].clone(), state[:, 1].clone()
    b = y.to(torch.int32)
    nibbles = torch.stack([b & 15, b >> 4], dim=2).reshape(y.shape[0], -1)
    out = torch.empty(nibbles.shape, dtype=torch.int32, device=y.device)
    for t in range(nibbles.shape[1]):
        prev, index = _decode_step(prev, index, nibbles[:, t], steps, adj)
        out[:, t] = prev
    return out.to(torch.int16), torch.stack([prev, index], dim=1)


# ---------------------------------------------------------------------------
# torch models of the kernels' algorithms (tests and chip_smoke.py; no entry
# point calls them)
# ---------------------------------------------------------------------------

def _select_step(prev, index, sample, steps):
    """The encoder kernel's step (``csrc/adpcm.cu``): csdr_tpu's three
    compare-subtract stages as one add and one unsigned min each (a
    difference that goes negative wraps above its minuend), the remainder
    q0 giving T_m = |d| - q0; the stage compares b2, b1, b0 pick m, the
    leaf the kernel selects; prev' = clamp(sample + (step>>3) - q0) for
    d >= 0, clamp(sample - (step>>3) + q0) for d < 0, which is csdr_tpu's
    clamp(prev +- ((step>>3) + T_m)); index' = clamp(index + adjust(m))."""
    step = steps[_read_index(index)].long()
    s1, s2, s3 = step >> 1, step >> 2, step >> 3
    sample = sample.long()
    d = sample - prev.long()
    ad = d.abs()
    q2 = torch.minimum((ad - step) % (1 << 32), ad)
    q1 = torch.minimum((q2 - s1) % (1 << 32), q2)
    q0 = torch.minimum((q1 - s2) % (1 << 32), q1)
    m = 4 * (ad >= step).int() + 2 * (q2 >= s1).int() + (q1 >= s2).int()
    prev = torch.where(d < 0, sample - s3 + q0, sample + s3 - q0
                       ).clamp(-32768, 32767).int()
    index = (index + torch.where(m >= 4, 2 * (m - 3), -1)).clamp(0, 88)
    return prev, index, m | torch.where(d < 0, 8, 0)


def encode_select_plain(x: torch.Tensor, state: torch.Tensor):
    """:func:`encode` by the encoder kernel's step (:func:`_select_step`),
    a loop over the samples on B rows."""
    steps, _ = _tables(str(x.device))
    prev, index = state[:, 0].clone(), state[:, 1].clone()
    xi = x.to(torch.int32)
    deltas = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    for t in range(x.shape[1]):
        prev, index, deltas[:, t] = _select_step(prev, index, xi[:, t],
                                                 steps)
    packed = deltas[:, 0::2] | (deltas[:, 1::2] << 4)
    return packed.to(torch.uint8), torch.stack([prev, index], dim=1)


# x -> clamp(x + a, lo, hi) as (a, lo, hi).  Its offset is clamped to +-k:
# on a domain of width k (index 0..88, k = 88; prev -32768..32767,
# k = 65535) an offset past k already sends every x to lo or hi, so the
# function is unchanged, and the offset cannot overflow over long rows.
INDEX_K, PREV_K = 88, 65535


def _then(f, g, k):
    """g after f."""
    (a1, lo1, hi1), (a2, lo2, hi2) = f, g
    return ((a1 + a2).clamp(-k, k),
            torch.minimum(torch.maximum(lo1 + a2, lo2), hi2),
            torch.minimum(torch.maximum(hi1 + a2, lo2), hi2))


def _scan(f, k):
    """Inclusive Hillis-Steele scan of the functions (a, lo, hi), each
    (B, n), along the last axis: entry j becomes f_j after ... after f_0."""
    a, lo, hi = f
    o = 1
    while o < a.shape[-1]:
        na, nlo, nhi = _then((a[:, :-o], lo[:, :-o], hi[:, :-o]),
                             (a[:, o:], lo[:, o:], hi[:, o:]), k)
        a = torch.cat([a[:, :o], na], 1)
        lo = torch.cat([lo[:, :o], nlo], 1)
        hi = torch.cat([hi[:, :o], nhi], 1)
        o *= 2
    return a, lo, hi


def _apply(f, x):
    a, lo, hi = f
    return torch.minimum(torch.maximum(x.unsqueeze(-1) + a, lo), hi)


def decode_scan_plain(y: torch.Tensor, state: torch.Tensor):
    """:func:`decode` by the decoder kernel's algorithm on B rows: the
    first nibble from the carried state, then the index after every later
    nibble as a prefix scan of clamp(x + adjust, 0, 88), the step sizes it
    reads, and prev as a prefix scan of clamp(x + dq, -32768, 32767), both
    with the offset rule above."""
    if y.shape[1] == 0:
        return torch.empty((y.shape[0], 0), dtype=torch.int16,
                           device=y.device), state.clone()
    steps, adj = _tables(str(y.device))
    b = y.to(torch.int32)
    nib = torch.stack([b & 15, b >> 4], dim=2).reshape(y.shape[0], -1)
    prev0, index0 = state[:, 0], state[:, 1]
    prev1 = (prev0 + _signed_dq(steps[_read_index(index0)], nib[:, 0])
             ).clamp(-32768, 32767)
    index1 = (index0 + adj[nib[:, 0]]).clamp(0, 88)
    rest = nib[:, 1:]
    full = torch.full_like(rest, 1)
    index_after = _apply(_scan((adj[rest], 0 * full, 88 * full), INDEX_K),
                         index1)
    index_at = torch.cat([index1[:, None], index_after[:, :-1]], 1)
    prev_after = _apply(_scan((_signed_dq(steps[index_at], rest),
                               -32768 * full, 32767 * full), PREV_K), prev1)
    out = torch.cat([prev1[:, None], prev_after], 1)
    index_end = torch.cat([index1[:, None], index_after], 1)[:, -1]
    return out.to(torch.int16), torch.stack([out[:, -1], index_end], dim=1)
