"""The single-card config-5 bank of csdr_tpu_torch (fastddc channelizer +
Gardner/DBPSK modem per channel) against csdr_tpu's bank on a 1x1 mesh,
on BPSK31 transmissions mixed into one wideband stream.

csdr_tpu's D=16 bank runs the fused single-matmul inverse and the port
K4's factored form (its plain version here), so the channel streams agree
to ~116 dB, not bit for bit: the bits are held after alignment, within 2
errors a channel (edge slips, tests/test_bpsk31.py), and each channel's
BER against its TX bits to tests/test_multichannel.py's bars."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from csdr_tpu.core.cplx import CF
from csdr_tpu.models import multichannel as jmc

from csdr_tpu_torch.core.checkpoint import state_from_jax_leaves
from csdr_tpu_torch.models import bpsk31 as tbpsk
from csdr_tpu_torch.models import multichannel as tmc
from csdr_tpu_torch.ops import fastddc as tfd

torch.set_num_threads(2)

SPS = 64
CENTERS = np.array([-0.3, -0.1, 0.15, 0.35])


@functools.cache
def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("chan", "time"))


def _align(a, b):
    return tbpsk.align_errors(a, b, range(-6, 6))


def _wideband(decim, texts, centers, steps, delta=0.0, noise=0.01, seed=9):
    """Each text's BPSK31 baseband at sps*decim samples a symbol, mixed to
    its centre (+delta), summed, plus noise: ``steps`` chunks of whole
    q-frame groups.  Returns (TX bits per channel, chunks)."""
    tx_bits, bbs = [], []
    for t in texts:
        bits, bb = tbpsk.tx_chain(t, interpolation=SPS * decim, device="cpu")
        tx_bits.append(bits)
        bbs.append(bb.numpy())
    ddc = tfd.fastddc_init(0.05, decim)
    q = tfd._class_plan(ddc)[0] if ddc.post_input_size % ddc.post_decimation \
        else 1
    unit = ddc.input_size * q
    n = min(map(len, bbs)) // (unit * steps) * unit
    k = np.arange(n * steps)
    acc = np.zeros(n * steps, np.complex64)
    for bb, f in zip(bbs, centers):
        acc += (bb[: n * steps] * np.exp(2j * np.pi * (f + delta) * k)
                ).astype(np.complex64)
    rng = np.random.default_rng(seed)
    acc += (noise * (rng.standard_normal(n * steps)
                     + 1j * rng.standard_normal(n * steps))
            ).astype(np.complex64)
    return tx_bits, [acc[s * n:(s + 1) * n] for s in range(steps)]


def _run_port(chunks, decim, state=None, bank_kw=None, rates=None):
    rates = [-f for f in CENTERS] if rates is None else rates
    init, step, meta = tmc.build_ddc_bpsk31_bank(rates, decim, SPS,
                                                 device="cpu",
                                                 **(bank_kw or {}))
    st = init(len(chunks[0])) if state is None else state(meta["bank"])
    outs = []
    for x in chunks:
        st, (bits, counts) = step(st, torch.from_numpy(x))
        outs.append([bits[c, :counts[c]].numpy() for c in range(len(rates))])
    return outs, st


def _run_jax(chunks, decim, bank_kw=None, rates=None):
    rates = [-f for f in CENTERS] if rates is None else rates
    init, step, _ = jmc.build_ddc_bpsk31_bank(_mesh(), rates, decim, SPS,
                                              **(bank_kw or {}))
    st = init(len(chunks[0]))
    outs, states = [], []
    for x in chunks:
        st, (bits, counts) = step(st, CF(jnp.asarray(x.real.copy()),
                                         jnp.asarray(x.imag.copy())))
        bits, counts = np.asarray(bits), np.asarray(counts)
        outs.append([bits[c, :counts[c]] for c in range(len(rates))])
        states.append([np.asarray(a) for a in st])
    return outs, states


def _joined(outs, c):
    return np.concatenate([o[c] for o in outs])


TEXTS = [bytes(f"CHANNEL {i} DE CSDR_TPU PSE K ".encode()) * 4
         for i in range(4)]


@pytest.fixture(scope="module", params=[16, 50])
def bank_case(request):
    decim = request.param
    tx_bits, chunks = _wideband(decim, TEXTS, CENTERS, 2)
    return decim, tx_bits, chunks, _run_jax(chunks, decim)


def test_bank_decodes_and_matches_csdr_tpu(bank_case):
    decim, tx_bits, chunks, (jouts, jstates) = bank_case
    outs, st = _run_port(chunks, decim)
    for c in range(4):
        got, ref = _joined(outs, c), _joined(jouts, c)
        errs, total = _align(tx_bits[c][8:], got[8:])
        assert total > 200 and errs / total < 0.02, (c, errs, total)
        errs, total = _align(ref, got)
        assert errs <= 2 and total > 200, (c, errs, total)
    # the carried state: the TED's occ and corr as csdr_tpu's
    np.testing.assert_array_equal(st[1].numpy(), jstates[-1][2])
    np.testing.assert_array_equal(st[2].numpy(), jstates[-1][3])
    assert st[0].shape == (4, 4 * SPS)


def test_bank_resumes_from_csdr_tpu_state(bank_case):
    """The port takes csdr_tpu's bank state after the first chunk (its 6
    arrays) and decodes the second chunk as csdr_tpu does."""
    decim, _, chunks, (jouts, jstates) = bank_case
    outs, _ = _run_port(chunks[1:], decim, state=lambda bank:
                        state_from_jax_leaves(bank, jstates[0], "cpu"))
    for c in range(4):
        errs, total = _align(jouts[1][c], outs[0][c])
        assert errs <= 2 and total > 100, (c, errs, total)


def test_bank_classed_sizing():
    """D=50 (a classed plan, q = 25): init checks the chunk holds whole
    q-frame groups; the TED carry is the fixed 4*sps tail."""
    rates = [-0.2, 0.1, 0.25, -0.05]
    init, step, meta = tmc.build_ddc_bpsk31_bank(rates, 50, SPS,
                                                 device="cpu")
    q, ga, ins = meta["q"], meta["group_out"], meta["input_size"]
    assert (q, ga) == (25, 448)
    with pytest.raises(ValueError, match="q-frame groups|frame groups"):
        init(ins * (q + 1))
    n = 2 * q * ins
    state = init(n)
    assert len(state) == 4 and tuple(state[0].shape) == (4, 4 * SPS)
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal(n)
                          + 1j * rng.standard_normal(n)).astype(np.complex64))
    assert tuple(meta["bank"].channelize(x).shape) == (4, 2 * ga)
    state, (bits, counts) = step(state, x)
    state, (bits, counts) = step(state, x)
    assert bits.shape[0] == 4 and bits.dtype == torch.uint8
    assert counts.dtype == torch.int32 and bool((counts > 0).all())


def test_bank_subchunked_modem_identical():
    """tr_subchunks=2 feeds the TED two sequential sub-chunks a step: the
    same bits and counts as one call; a count that does not divide the
    chunk warns and runs one call."""
    decim = 16
    rates = [-0.2, 0.1, 0.25, -0.05]
    rng = np.random.default_rng(21)
    n = 4 * tfd.fastddc_init(0.05, decim).input_size
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    ref, _ = _run_port([x] * 3, decim, rates=rates)
    sub, _ = _run_port([x] * 3, decim, rates=rates,
                       bank_kw=dict(tr_subchunks=2))
    for r_chans, s_chans in zip(ref, sub):
        for r, s in zip(r_chans, s_chans):
            np.testing.assert_array_equal(r, s)
    with pytest.warns(UserWarning, match="tr_subchunks=5"):
        odd, _ = _run_port([x], decim, rates=rates,
                           bank_kw=dict(tr_subchunks=5))
    for r, s in zip(ref[0], odd[0]):
        np.testing.assert_array_equal(r, s)


def test_bank_segmented_ted_matches_csdr_tpu():
    """tr_segments=4 with every segment given its warmup: the port's bits
    as csdr_tpu's segmented bank's, and decoded."""
    decim = 16
    tx_bits, chunks = _wideband(decim, TEXTS, CENTERS, 1, seed=13)
    m = len(chunks[0]) // 16
    assert m // (4 * SPS) >= 32
    kw = dict(tr_segments=4)
    outs, _ = _run_port(chunks, decim, bank_kw=kw)
    jouts, _ = _run_jax(chunks, decim, bank_kw=kw)
    for c in range(4):
        errs, total = _align(jouts[0][c], outs[0][c])
        assert errs <= 2 and total > 200, (c, errs, total)
        errs, total = _align(tx_bits[c][8:], outs[0][c][8:])
        assert errs / total < 0.02, (c, errs, total)


@pytest.mark.parametrize("use_costas", [True, False])
def test_bank_costas_recovers_carrier_offset(use_costas):
    """A residual carrier offset too large for DBPSK alone: with the
    Costas loop the text comes back (BER < 0.03) and the state is
    csdr_tpu's 9 arrays; without it the BER is visibly bad."""
    decim = 16
    centers = np.array([-0.25, 0.2])
    texts = [b"COSTAS CHANNEL %d TEST " % i * 2 for i in range(2)]
    tx_bits, chunks = _wideband(decim, texts, centers, 1, delta=0.00025,
                                noise=0.0)
    kw = dict(use_costas=use_costas)
    rates = [-f for f in centers]
    outs, st = _run_port(chunks, decim, bank_kw=kw, rates=rates)
    bers = []
    for c in range(2):
        errs, total = _align(tx_bits[c][16:], outs[0][c][16:])
        assert total > 150, (c, total)
        bers.append(errs / total)
    if not use_costas:
        assert max(bers) > 0.1, bers
        return
    assert max(bers) < 0.03, bers
    jouts, jstates = _run_jax(chunks, decim, bank_kw=kw, rates=rates)
    assert len(jstates[0]) == 9 == sum(2 if t.is_complex() else 1
                                       for t in st)
    for c in range(2):
        errs, total = _align(jouts[0][c][16:], outs[0][c][16:])
        assert errs / total < 0.03, (c, errs, total)
    resumed = state_from_jax_leaves(tmc.DdcBpsk31Bank(
        rates, decim, SPS, True, 2 * np.pi / 100, 1, 1, "cpu"),
        jstates[0], "cpu")
    np.testing.assert_array_equal(resumed[4].numpy(), jstates[0][6])


def test_bank_modem_subchunked_on_csdr_tpu_streams_bit_exact():
    """The bank's shape, 4 channels and tr_subchunks=2: the port's modem
    (two TED calls a chunk, each one launch of the TED kernel on the card)
    on csdr_tpu's own channel streams gives csdr_tpu's bank's bits and
    counts bit for bit, over two chunks with the state carried."""
    from csdr_tpu.ops import fastddc as jfd
    from csdr_tpu.parallel import sharded_ddc as jsd

    decim, kw = 16, dict(tr_subchunks=2)
    rates = [-f for f in CENTERS]
    _, chunks = _wideband(decim, TEXTS, CENTERS, 2, seed=17)
    jouts, _ = _run_jax(chunks, decim, bank_kw=kw)
    ddc_step, _ = jsd.build_ddc_bank_step(_mesh(),
                                          jfd.fastddc_init(0.05, decim),
                                          rates)
    ddc_step = jax.jit(ddc_step)
    init, _, meta = tmc.build_ddc_bpsk31_bank(rates, decim, SPS,
                                              device="cpu", **kw)
    bank, st = meta["bank"], init(len(chunks[0]))
    assert bank.tr_subchunks == 2
    for x, jo in zip(chunks, jouts):
        y = ddc_step(CF(jnp.asarray(x.real.copy()), jnp.asarray(
            x.imag.copy())))
        y = torch.from_numpy(np.asarray(y.re) + 1j * np.asarray(y.im))
        assert y.shape[-1] % 2 == 0
        with torch.no_grad():
            st, (bits, counts) = bank.modem(st, y.to(torch.complex64))
        for c in range(len(rates)):
            assert int(counts[c]) == len(jo[c]) > 50, c
            np.testing.assert_array_equal(bits[c, :counts[c]].numpy(),
                                          jo[c])
