"""The algorithms of the redesigned IMA ADPCM kernels (csrc/adpcm.cu), as
their torch models in kernels/adpcm_cuda.py, against csdr_tpu and the
serial plain loops, bit for bit:

- the encoder's step: the compare form (the magnitude is the count of the
  thresholds T_q <= |d|) and the kernel's form (three add-and-unsigned-min
  stages), over every step size and every |d| of either sign, against the
  serial step;
- ``encode_select_plain`` against csdr_tpu's ``encode_ima_adpcm`` on random
  and +-32767 streams, chunked with the state carried, from carried states
  out of range;
- ``decode_scan_plain`` (clamped adds composed, a Hillis-Steele scan)
  against csdr_tpu's ``decode_ima_adpcm`` and ``decode_plain``: random
  rows, saturating runs, chunks with the state carried, a carried index of
  -5 and 100;
- the composition's offset clamp over long saturating runs.

On the CPU the kernels are not run; tests/test_torch_kernels.py and
chip_smoke.py hold them to these models on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu.ops import adpcm as jadpcm

from csdr_tpu_torch.kernels import adpcm_cuda

torch.set_num_threads(2)


def _tables():
    return (torch.from_numpy(adpcm_cuda.STEP_SIZES),
            torch.from_numpy(adpcm_cuda.INDEX_ADJUST))


def _jax_state(st):
    return (jnp.int32(st[0]), jnp.int32(st[1]))


def _ints(st):
    return [int(v) for v in st]


@pytest.mark.parametrize("sign", [1, -1])
def test_encoder_step_forms_cover_every_step_size_and_difference(sign):
    """For all 89 step sizes and every |d| in 0..65535 (d of the given
    sign), the count of T_q <= |d| is csdr_tpu's nibble magnitude, and the
    kernel's step gives the serial step's prev', index' and nibble."""
    steps, adj = _tables()
    v = torch.arange(65536, dtype=torch.int32)
    for lo in range(0, 89, 8):
        index = torch.arange(lo, min(lo + 8, 89), dtype=torch.int32)
        index = index[:, None].expand(-1, 65536).reshape(-1)
        mag = v.repeat(len(index) // 65536)
        if sign > 0:
            prev = torch.full_like(mag, -32768)
            sample = -32768 + mag
        else:
            prev = torch.full_like(mag, 32767)
            sample = 32767 - mag
        want = adpcm_cuda._encode_step(prev, index, sample, steps, adj)
        got = adpcm_cuda._select_step(prev, index, sample, steps)
        for w, g in zip(want, got):
            assert torch.equal(w.int(), g.int())
        step = steps[index]
        s1, s2 = step >> 1, step >> 2
        thresholds = torch.stack([s2, s1, s1 + s2, step, step + s2,
                                  step + s1, step + s1 + s2], dim=-1)
        count = (mag[:, None] >= thresholds).sum(-1)
        assert torch.equal(count.int(), want[2].int() & 7)


def _stream(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 9000, n) * np.sin(np.arange(n) / 60.0)
    x[200:260:2], x[201:260:2] = 32767, -32767
    x[400:700:2], x[401:700:2] = 32767, -32768
    x[900:940] = -32768
    return np.clip(x, -32768, 32767).astype(np.int16)


ENCODE_CASES = [(0, (0, 0), 256), (1, (1000, -5), 512),
                (2, (-3000, 100), 384), (3, (40000, 45), 1024),
                (4, (-40000, -100), 256)]


@pytest.mark.parametrize("seed,state,chunk", ENCODE_CASES)
def test_encode_select_plain_matches_csdr_tpu(seed, state, chunk):
    """Chunks of a stream encoded with the state carried: bytes and state
    equal csdr_tpu's jitted encoder's, from in- and out-of-range states."""
    x = _stream(seed, 2048)
    enc = jax.jit(jadpcm.encode_ima_adpcm)
    sj = _jax_state(state)
    st = torch.tensor([state], dtype=torch.int32)
    for c in range(len(x) // chunk):
        part = x[c * chunk:(c + 1) * chunk]
        bj, sj = enc(jnp.asarray(part), sj)
        bt, st = adpcm_cuda.encode_select_plain(torch.from_numpy(part)[None],
                                                st)
        assert np.array_equal(np.asarray(bj), bt[0].numpy())
        assert _ints(sj) == st[0].tolist()


def test_encode_select_plain_matches_plain_over_rows():
    """Several rows at once, each from its own state, against the serial
    loop."""
    x = np.stack([_stream(s, 1000) for s in range(5)])
    st = torch.tensor([[0, 0], [32767, 88], [-32768, 0], [100, -5],
                       [-100, 100]], dtype=torch.int32)
    want = adpcm_cuda.encode_plain(torch.from_numpy(x), st)
    got = adpcm_cuda.encode_select_plain(torch.from_numpy(x), st)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


def _bytes(seed: int, n: int, saturate: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, n, dtype=np.uint8)
    if saturate:
        y[: n // 3] = 0x77
        y[n // 3: 2 * n // 3] = 0xFF
    return y


DECODE_CASES = [(10, (0, 0), 256, False), (11, (500, -5), 512, False),
                (12, (-500, 100), 128, False), (13, (0, 0), 512, True),
                (14, (32767, 88), 1024, True), (15, (40000, -5), 300, True)]


@pytest.mark.parametrize("seed,state,chunk,saturate", DECODE_CASES)
def test_decode_scan_plain_matches_csdr_tpu_and_plain(seed, state, chunk,
                                                      saturate):
    """Chunks of bytes decoded with the state carried: samples and state
    equal csdr_tpu's jitted decoder's and the serial loop's."""
    y = _bytes(seed, 1200, saturate)
    dec = jax.jit(jadpcm.decode_ima_adpcm)
    sj = _jax_state(state)
    st = sp = torch.tensor([state], dtype=torch.int32)
    for c in range(-(-len(y) // chunk)):
        part = y[c * chunk:(c + 1) * chunk]
        xj, sj = dec(jnp.asarray(part), sj)
        xt, st = adpcm_cuda.decode_scan_plain(torch.from_numpy(part)[None],
                                              st)
        xp, sp = adpcm_cuda.decode_plain(torch.from_numpy(part)[None], sp)
        assert np.array_equal(np.asarray(xj), xt[0].numpy())
        assert torch.equal(xt, xp)
        assert _ints(sj) == st[0].tolist() == sp[0].tolist()


def test_decode_scan_plain_over_rows_of_other_lengths():
    """Rows of one byte and of odd byte counts, each from its own state."""
    for n in (1, 2, 3, 31, 33, 257):
        y = torch.from_numpy(np.stack([_bytes(n + k, n) for k in range(4)]))
        st = torch.tensor([[0, 0], [-32768, 88], [1234, -5], [-1, 100]],
                          dtype=torch.int32)
        want = adpcm_cuda.decode_plain(y, st)
        got = adpcm_cuda.decode_scan_plain(y, st)
        assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


def _serial_decode(nibbles, prev, index):
    """The IMA decoder in Python ints (csdr_tpu's _decode_step)."""
    steps = [int(v) for v in adpcm_cuda.STEP_SIZES]
    out = []
    for n in nibbles:
        step = steps[index]
        dq = (step >> 3) + (step >> 2 if n & 1 else 0) \
            + (step >> 1 if n & 2 else 0) + (step if n & 4 else 0)
        prev = min(max(prev - dq if n & 8 else prev + dq, -32768), 32767)
        index = min(max(index + int(adpcm_cuda.INDEX_ADJUST[n]), 0), 88)
        out.append(prev)
    return out, prev, index


def test_scan_offset_clamp_over_long_saturating_runs():
    """100 000 nibbles of 0x7, then of 0xF: the offsets of the composed
    functions would pass int32 (61 436 a nibble) but stay clamped to
    +-65535, and the scan's samples equal the serial decoder's."""
    n = 100_000
    y = np.concatenate([np.full(n // 2, 0x77, np.uint8),
                        np.full(n // 2, 0xFF, np.uint8)])
    want, prev, index = _serial_decode(
        [int(b) >> s & 15 for b in y for s in (0, 4)], 0, 0)
    got, st = adpcm_cuda.decode_scan_plain(torch.from_numpy(y)[None],
                                           torch.zeros((1, 2),
                                                       dtype=torch.int32))
    assert got[0].tolist() == want
    assert st[0].tolist() == [prev, index] == [-32768, 88]
    dq = torch.full((1, n), 61_436, dtype=torch.int32)
    a, lo, hi = adpcm_cuda._scan((dq, torch.full_like(dq, -32768),
                                  torch.full_like(dq, 32767)),
                                 adpcm_cuda.PREV_K)
    assert int(a.abs().max()) == adpcm_cuda.PREV_K
    assert 61_436 * n > 2 ** 31
    pinned = adpcm_cuda._apply((a, lo, hi), torch.tensor([-32768]))[0]
    assert pinned[0] == -32768 + 61_436
    assert torch.equal(pinned[1:], torch.full((n - 1,), 32767,
                                              dtype=torch.int32))
