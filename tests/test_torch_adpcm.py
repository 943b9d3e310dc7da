"""The IMA ADPCM codec of csdr_tpu_torch against csdr_tpu, bit for bit:
streams with s16 extremes encoded and decoded at three chunk sizes with the
state carried, streams resumed from csdr_tpu's state, and the waterfall's
row compression on dB rows holding -inf, +inf, NaN and values past int16.

Held against csdr_tpu, not the reference C binary: csdr_tpu's own C
goldens for this codec (tests/test_adpcm_spectrum.py) fail in some runs
(ROADMAP §3 item 3).  On the CPU every call takes the codec's plain torch
loop; the CUDA kernel is held to that loop bit for bit on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu.ops import adpcm as jadpcm
from csdr_tpu.ops import spectrum as jspec

import csdr_tpu_torch
from csdr_tpu_torch.core.block import Pipeline, VarOut
from csdr_tpu_torch.kernels import adpcm_cuda
from csdr_tpu_torch.ops import adpcm as tadpcm
from csdr_tpu_torch.ops import spectrum as tspec

torch.set_num_threads(2)

N = 4096


def _samples(seed: int, n: int = N) -> np.ndarray:
    """A 1 kHz-ish tone near full scale (the index walks up and down the
    table), noise, and the s16 extremes back to back."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 30000 * np.sin(2 * np.pi * t / 48.0) * (t % 1024 < 700)
    x = x + rng.normal(0, 300, n)
    x[100:110] = [32767, -32768] * 5
    x[500:520] = -32768
    x[900:920] = 32767
    return np.clip(x, -32768, 32767).astype(np.int16)


def _ints(st):
    return tuple(int(v) for v in st)


@pytest.mark.parametrize("chunk", [512, 1024, 2048])
def test_encode_decode_stream_bit_exact(chunk):
    """Encode, then decode the bytes, chunk by chunk; every chunk's output
    and state equal csdr_tpu's."""
    x = _samples(chunk)
    enc = jax.jit(jadpcm.encode_ima_adpcm)
    dec = jax.jit(jadpcm.decode_ima_adpcm)
    sje = sjd = (jnp.int32(0), jnp.int32(0))
    ste, std = (0, 0), (0, 0)
    for c in range(N // chunk):
        part = x[c * chunk:(c + 1) * chunk]
        bj, sje = enc(jnp.asarray(part), sje)
        bt, ste = tadpcm.encode_ima_adpcm(torch.from_numpy(part), ste)
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        assert bt.dtype == torch.uint8 and _ints(ste) == _ints(sje)
        yj, sjd = dec(bj, sjd)
        yt, std = tadpcm.decode_ima_adpcm(bt, std)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        assert yt.dtype == torch.int16 and _ints(std) == _ints(sjd)


@pytest.mark.parametrize("which", ["encode", "decode"])
def test_block_resumes_from_jax_state(which):
    """csdr_tpu's block runs chunk 1; its (prev, index) leaves go into the
    port's block through state_from_jax_leaves, which runs chunks 2-3 as
    csdr_tpu does."""
    x = _samples(7)
    if which == "encode":
        jb, tb, data = jadpcm.encode_block(), tadpcm.encode_block(), x
    else:
        data = np.array(jadpcm.encode_ima_adpcm(jnp.asarray(x))[0])
        jb, tb = jadpcm.decode_block(), tadpcm.decode_block()
    n = len(data) // 4
    apply = jax.jit(jb.apply)
    sj, _ = apply(jb.init(), jnp.asarray(data[:n]))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(sj)]
    assert [a.dtype for a in leaves] == [np.int32, np.int32]
    st = csdr_tpu_torch.state_from_jax_leaves(tb, leaves, device="cpu")
    assert _ints(st) == _ints(sj)
    for c in (1, 2):
        part = data[c * n:(c + 1) * n]
        sj, yj = apply(sj, jnp.asarray(part))
        st, yt = tb(st, torch.from_numpy(part))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        assert _ints(st) == _ints(sj)


def test_blocks_in_a_pipeline():
    """encode | decode as one Pipeline: the decoded stream is csdr_tpu's
    round trip, and odd chunks raise as csdr_tpu's pairing does."""
    x = _samples(8)
    pipe = Pipeline([tadpcm.encode_block(), tadpcm.decode_block()])
    st = pipe.init("cpu")
    outs = []
    for c in range(4):
        st, y = pipe(st, torch.from_numpy(x[c * 1024:(c + 1) * 1024]))
        outs.append(y.numpy())
    b, _ = jadpcm.encode_ima_adpcm(jnp.asarray(x))
    want, _ = jadpcm.decode_ima_adpcm(b)
    np.testing.assert_array_equal(np.concatenate(outs), np.asarray(want))
    with pytest.raises(ValueError, match="even"):
        tadpcm.encode_ima_adpcm(torch.from_numpy(x[:7]))


@pytest.mark.parametrize("chunk", [333, 1001, 2047])
def test_paired_block_keeps_pairs_across_odd_chunks(chunk):
    """paired_encode_block over chunks of odd length, every other one a
    VarOut with padding past its count: its bytes and codec state are
    csdr_tpu's encoder's on the stream's even prefix, and the odd last
    sample waits in the state, as csdr_tpu's CLI pumps pairs."""
    x = _samples(chunk)[: N - 1]
    blk = tadpcm.paired_encode_block()
    st, outs = blk.init("cpu"), []
    for c, start in enumerate(range(0, len(x), chunk)):
        part = torch.from_numpy(x[start:start + chunk])
        if c % 2:
            pad = torch.full((5,), 12345, dtype=torch.int16)
            part = VarOut(torch.cat([part, pad]), len(part))
        st, y = blk(st, part)
        outs.append(y.numpy())
    bj, sj = jadpcm.encode_ima_adpcm(jnp.asarray(x[: N - 2]))
    np.testing.assert_array_equal(np.concatenate(outs), np.asarray(bj))
    carry, codec = st
    assert carry.tolist() == [int(x[N - 2])]
    assert _ints(codec) == _ints(sj)


def _db_rows(seed: int, rows: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    r = (rng.uniform(-120, 0, (rows, n))
         + 30 * np.sin(np.arange(n) / 17.0)).astype(np.float32)
    r[0, :6] = [-np.inf, np.inf, np.nan, 400.0, -400.0, 0.0]
    r[1, 0] = -np.inf            # a row of zero power starts at -inf dB
    r[2, 0] = np.nan
    r[3, 10:20] = 1e9
    r[3, 0] = 327.68
    return r


def test_compress_rows_bit_exact_with_edges():
    """compress_fft_adpcm_rows and compress_fft_adpcm_f_u8 on rows with
    -inf, +inf, NaN, +-400 dB and 1e9: the saturating float32 -> int16
    cast and the 10-sample pad of the row's first value, bit for bit."""
    rows = _db_rows(9, 4, 502)
    j = np.asarray(jspec.compress_fft_adpcm_rows(jnp.asarray(rows), 502))
    t = tspec.compress_fft_adpcm_rows(torch.from_numpy(rows), 502).numpy()
    assert t.shape == (4, 256) and t.dtype == np.uint8
    np.testing.assert_array_equal(t, j)
    for k in range(4):
        one = tadpcm.compress_fft_adpcm_f_u8(torch.from_numpy(rows[k]), 502)
        np.testing.assert_array_equal(
            one.numpy(), np.asarray(jadpcm.compress_fft_adpcm_f_u8(
                jnp.asarray(rows[k]), 502)))


def test_compress_s16_saturates():
    rows = np.array([[-np.inf, np.inf, np.nan, 400.0, -400.0, 327.67,
                      -327.685, 1.234]], np.float32)
    s16 = tadpcm.compress_fft_s16(torch.from_numpy(rows)).numpy()
    want = np.asarray((jnp.asarray(rows) * 100).astype(jnp.int16))
    np.testing.assert_array_equal(s16[0, 10:], want[0])
    assert (s16[0, :10] == -32768).all()


def test_plain_rows_are_independent():
    """The plain loop over B rows gives each row what it gives alone, with
    each row's own carried state."""
    x = np.stack([_samples(s, 600) for s in (10, 11, 12)])
    st = torch.tensor([[0, 0], [-500, 40], [32767, 88]], dtype=torch.int32)
    packed, ns = adpcm_cuda.encode_plain(torch.from_numpy(x), st)
    for k in range(3):
        pk, nk = adpcm_cuda.encode_plain(torch.from_numpy(x[k:k + 1]),
                                         st[k:k + 1])
        assert torch.equal(pk[0], packed[k]) and torch.equal(nk[0], ns[k])
        bj, sj = jadpcm.encode_ima_adpcm(jnp.asarray(x[k]),
                                         tuple(int(v) for v in st[k]))
        np.testing.assert_array_equal(packed[k].numpy(), np.asarray(bj))
        assert _ints(ns[k]) == _ints(sj)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 8), dtype=torch.int16)
    with pytest.raises(TypeError):
        adpcm_cuda.encode(x.float(), torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(TypeError):
        adpcm_cuda.encode(x, torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="even"):
        adpcm_cuda.encode(x[:, :7], torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(TypeError):
        adpcm_cuda.decode(x, torch.zeros((2, 2), dtype=torch.int32))
