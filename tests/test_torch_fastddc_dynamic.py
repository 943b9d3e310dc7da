"""The dynamic (retunable) fastddc blocks of csdr_tpu_torch against
csdr_tpu: their per-channel rows bit for bit, each block streamed over
three chunks with a retune between the first and the second, and
csdr_tpu's dynamic states loaded into the port.

csdr_tpu's steps run jitted, as its DDC server runs them, with its Pallas
inverse in interpret mode where a plan and chunk reach it (D=16 at 128
frames); the port's K4 wrapper takes its plain version on the CPU.  The
outputs meet at a max error relative to the peak of 5e-5, the bar of
tests/test_torch_fastddc.py; the carried phases and tails bit for bit
(both packages compute the float32 NCO ramps with the same operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu.core.cplx import CF
from csdr_tpu.ops import fastddc as jfd

import csdr_tpu_torch
from csdr_tpu_torch.ops import fastddc as tfd

torch.set_num_threads(2)

REL_BAR = 5e-5
RATES = [0.11, -0.23, 0.31, -0.02]
RETUNE = (1, 0.27)            # channel 1 moves to 0.27 before chunk 2


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CSDR_PALLAS_INTERPRET", "1")


def _cf(x):
    x = np.asarray(x)
    return CF(jnp.asarray(np.ascontiguousarray(x.real, np.float32)),
              jnp.asarray(np.ascontiguousarray(x.imag, np.float32)))


def _np(a):
    return np.asarray(a.re) + 1j * np.asarray(a.im)


def _noise(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(ref, got):
    return np.abs(ref - got).max() / np.abs(ref).max()


def _rows(fn, ddc, rates, **kw):
    """Stacked per-channel rows (tq, d, cyc) from a rows function."""
    parts = [fn(ddc, r, **kw) for r in rates]
    return tuple(np.stack([p[i] for p in parts]) for i in range(3))


def _cols(fn, ddc, rates, **kw):
    """(G with the channel blocks side by side on its last axis, cyc)."""
    parts = [fn(ddc, r, **kw) for r in rates]
    return (np.concatenate([g for g, _ in parts], axis=-1),
            np.asarray([c for _, c in parts], np.float32))


def _retuned(rates):
    out = list(rates)
    out[RETUNE[0]] = RETUNE[1]
    return out


# --------------------------------------------------------------------------
# rows: csdr_tpu's bit for bit, and the static blocks' at the same rate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d", [4, 16])
def test_dynamic_rows_equal_jax_and_static(d):
    td, jd = tfd.fastddc_init(0.05, d), jfd.fastddc_init(0.05, d)
    m = td.post_input_size // td.post_decimation
    chan = tfd.fastddc_channelizer_block(td, RATES)
    fac = tfd.fastddc_inv_block(td, RATES)
    fused = tfd._fastddc_inv_fused_block(td, RATES)
    for i, r in enumerate(RATES):
        for tfn, jfn in ((tfd.dynamic_channelizer_rows,
                          jfd.dynamic_channelizer_rows),
                         (tfd.dynamic_channel_rows,
                          jfd.dynamic_channel_rows)):
            got, want = tfn(td, r), jfn(jd, r)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
        tq2, d2, cyc2 = tfd.dynamic_channelizer_rows(td, r)
        assert d2.shape == (tfd.mpad_for(td),) and not np.any(d2[m:])
        np.testing.assert_array_equal(tq2, chan.tq2[i].numpy())
        np.testing.assert_array_equal(d2[:m], chan.d[i].numpy())
        assert cyc2 == np.float32(chan.frame_cyc[i])
        tq, dd, cyc = tfd.dynamic_channel_rows(td, r)
        np.testing.assert_array_equal(tq, fac.tq[i].numpy())
        np.testing.assert_array_equal(dd[:m], fac.d[i].numpy())
        assert cyc == cyc2
        g, gc = tfd.dynamic_channel_cols(td, r)
        gj, gcj = jfd.dynamic_channel_cols(jd, r)
        np.testing.assert_array_equal(g, gj)
        assert gc == gcj == cyc
        np.testing.assert_array_equal(
            g, fused.g[:, i * m:(i + 1) * m].numpy())


@pytest.mark.parametrize("order", ["natural", "kernel"])
def test_dynamic_class_cols_equal_jax_and_static(order):
    td, jd = tfd.fastddc_init(0.05, 50), jfd.fastddc_init(0.05, 50)
    static = tfd.fastddc_inv_block(td, RATES, spectra_order=order)
    w = static.m_max
    for i, r in enumerate(RATES):
        g, cyc = tfd.dynamic_channel_cols(td, r, spectra_order=order)
        gj, cycj = jfd.dynamic_channel_cols(jd, r, spectra_order=order)
        assert g.dtype == gj.dtype and cyc.dtype == cycj.dtype
        np.testing.assert_array_equal(g, gj)
        assert cyc == cycj == np.float32(np.mod(static.dsa[i], 1.0))
        np.testing.assert_array_equal(g, static.g[..., i * w:(i + 1) * w]
                                      .numpy())


# --------------------------------------------------------------------------
# the blocks, streamed with a retune
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d,frames", [(16, (128, 64, 128)), (4, (12, 5, 9))],
                         ids=["d16", "d4"])
def test_dynamic_channelizer_matches_jax(interpret, d, frames):
    td, jd = tfd.fastddc_init(0.05, d), jfd.fastddc_init(0.05, d)
    c = len(RATES)
    jinit, jstep = jfd.fastddc_dynamic_channelizer_block(jd, c)
    jstep = jax.jit(jstep)
    tblk = tfd.fastddc_dynamic_channelizer_block(td, c)
    rng = np.random.default_rng(31 + d)
    sj, st = jinit(), tblk.init("cpu")
    for k, b in enumerate(frames):
        rates = RATES if k == 0 else _retuned(RATES)
        tq, dd, cyc = _rows(tfd.dynamic_channelizer_rows, td, rates)
        tqj, ddj, cycj = _rows(jfd.dynamic_channelizer_rows, jd, rates)
        x = _noise(rng, b * td.input_size)
        sj, oj = jstep(sj, _cf(x), _cf(tqj), _cf(ddj), jnp.asarray(cycj))
        with torch.no_grad():
            st, ot = tblk(st, torch.from_numpy(x), torch.from_numpy(tq),
                          torch.from_numpy(dd), torch.from_numpy(cyc))
        assert int(np.asarray(oj.count)[0]) == ot.count == b * tblk.m
        assert _rel(_np(oj.data), ot.data.numpy()) < REL_BAR
        np.testing.assert_array_equal(st[1].numpy(), np.asarray(sj[1]))
        np.testing.assert_array_equal(st[0].numpy(), _np(sj[0]))


@pytest.mark.parametrize("d,frames", [(16, (128, 64, 128)), (4, (12, 5, 9))],
                         ids=["d16", "d4"])
def test_dynamic_factored_inverse_matches_jax(interpret, d, frames):
    td, jd = tfd.fastddc_init(0.05, d), jfd.fastddc_init(0.05, d)
    c = len(RATES)
    jinit, jstep = jfd.fastddc_inv_dynamic_factored_block(jd, c)
    jstep = jax.jit(jstep)
    tblk = tfd.fastddc_inv_dynamic_factored_block(td, c)
    rng = np.random.default_rng(41 + d)
    sj, st = jinit(), tblk.init("cpu")
    for k, b in enumerate(frames):
        rates = RATES if k == 0 else _retuned(RATES)
        tq, dd, cyc = _rows(tfd.dynamic_channel_rows, td, rates)
        sp = _noise(rng, b, td.fft_size)
        sj, oj = jstep(sj, _cf(sp), _cf(tq), _cf(dd), jnp.asarray(cyc))
        with torch.no_grad():
            st, ot = tblk(st, torch.from_numpy(sp), torch.from_numpy(tq),
                          torch.from_numpy(dd), torch.from_numpy(cyc))
        assert int(np.asarray(oj.count)[0]) == ot.count
        assert _rel(_np(oj.data), ot.data.numpy()) < REL_BAR
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj[0]))


@pytest.mark.parametrize("d,order,frames", [
    (16, "natural", (7, 4, 9)), (50, "natural", None),
    (50, "kernel", None)], ids=["d16_dense", "d50_classed", "d50_kernel"])
def test_dynamic_inverse_matches_jax(d, order, frames):
    """The dense (divisible) and classed forms; classed chunks of q, 2q
    and q frames."""
    td, jd = tfd.fastddc_init(0.05, d), jfd.fastddc_init(0.05, d)
    c = len(RATES)
    jinit, jstep, g_shape = jfd.fastddc_inv_dynamic_block(jd, c)
    jstep = jax.jit(jstep)
    tblk = tfd.fastddc_inv_dynamic_block(td, c)
    assert tblk.g_shape == g_shape
    if frames is None:
        frames = (tblk.q, 2 * tblk.q, tblk.q)
    rng = np.random.default_rng(51 + d)
    sj, st = jinit(), tblk.init("cpu")
    for k, b in enumerate(frames):
        rates = RATES if k == 0 else _retuned(RATES)
        g, cyc = _cols(tfd.dynamic_channel_cols, td, rates,
                       spectra_order=order)
        sp = _noise(rng, b, td.fft_size)
        sj, oj = jstep(sj, _cf(sp), _cf(g), jnp.asarray(cyc))
        with torch.no_grad():
            st, ot = tblk(st, torch.from_numpy(sp), torch.from_numpy(g),
                          torch.from_numpy(cyc))
        assert int(np.asarray(oj.count)[0]) == ot.count
        assert _rel(_np(oj.data), ot.data.numpy()) < REL_BAR
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_dynamic_channelizer_equals_static_channelizer():
    """With each channel's rows at a fixed rate, the dynamic channelizer
    (float32 device ramps) and the static one (float64 host ramps) agree
    at REL_BAR over two chunks of up to 40 frames.  (The classed form's
    float32 ramp reaches hundreds of cycles within a chunk, csdr_tpu's
    design, and is held against csdr_tpu alone.)"""
    td = tfd.fastddc_init(0.05, 16)
    rng = np.random.default_rng(61)
    dyn = tfd.fastddc_dynamic_channelizer_block(td, len(RATES))
    sta = tfd.fastddc_channelizer_block(td, RATES)
    rows = [torch.from_numpy(a) for a in
            _rows(tfd.dynamic_channelizer_rows, td, RATES)]
    sd, ss = dyn.init("cpu"), sta.init("cpu")
    for b in (40, 24):
        x = torch.from_numpy(_noise(rng, b * td.input_size))
        with torch.no_grad():
            sd, od = dyn(sd, x, *rows)
            ss, os_ = sta(ss, x)
        assert _rel(os_.data.numpy(), od.data.numpy()) < REL_BAR


def test_dynamic_blocks_refuse_bad_calls():
    td = tfd.fastddc_init(0.05, 16)
    blk = tfd.fastddc_inv_dynamic_block(td, 2)
    sp = torch.zeros(4, td.fft_size, dtype=torch.complex64)
    with pytest.raises(ValueError, match="want"):
        blk(blk.init("cpu"), sp, torch.zeros(3, 3, dtype=torch.complex64),
            torch.zeros(2))
    c50 = tfd.fastddc_inv_dynamic_block(tfd.fastddc_init(0.05, 50), 1)
    with pytest.raises(ValueError, match="% q"):
        c50(c50.init("cpu"), torch.zeros(c50.q + 1, 1024,
                                         dtype=torch.complex64),
            torch.zeros(c50.g_shape, dtype=torch.complex64), torch.zeros(1))
    with pytest.raises(ValueError, match="divisible"):
        tfd.fastddc_dynamic_channelizer_block(tfd.fastddc_init(0.05, 50), 2)
    fac = tfd.fastddc_inv_dynamic_factored_block(td, 2)
    tq, dd, cyc = (torch.from_numpy(a) for a in
                   _rows(tfd.dynamic_channel_rows, td, [0.1, 0.2, 0.3]))
    with pytest.raises(ValueError, match="rows for 2 channels"):
        fac(fac.init("cpu"), sp, tq, dd, cyc)


# --------------------------------------------------------------------------
# csdr_tpu's dynamic states into the port
# --------------------------------------------------------------------------

def _leaves(state):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(state)]


@pytest.mark.parametrize("precision", ["HIGH", "HIGHEST"])
def test_dynamic_states_from_jax_leaves(precision):
    """csdr_tpu runs a chunk; its state leaves (history and matrices, the
    bf16 W stack at "HIGH") load into the port, which runs the next chunk
    as csdr_tpu does; a wrong matrix or shape is refused."""
    td, jd = tfd.fastddc_init(0.05, 16), jfd.fastddc_init(0.05, 16)
    c = 2
    rng = np.random.default_rng(71)
    x1, x2 = (_noise(rng, 24 * td.input_size) for _ in range(2))
    tq, dd, cyc = _rows(tfd.dynamic_channelizer_rows, td, RATES[:c])
    jrows = (_cf(tq), _cf(dd), jnp.asarray(cyc))
    trows = [torch.from_numpy(a) for a in (tq, dd, cyc)]
    jinit, jstep = jfd.fastddc_dynamic_channelizer_block(jd, c, precision)
    sj, _ = jstep(jinit(), _cf(x1), *jrows)
    tblk = tfd.fastddc_dynamic_channelizer_block(td, c)
    st = csdr_tpu_torch.state_from_jax_leaves(tblk, _leaves(sj),
                                              device="cpu")
    sj2, oj = jstep(sj, _cf(x2), *jrows)
    with torch.no_grad():
        st2, ot = tblk(st, torch.from_numpy(x2), *trows)
    assert _rel(_np(oj.data), ot.data.numpy()) < REL_BAR
    np.testing.assert_array_equal(st2[1].numpy(), np.asarray(sj2[1]))
    bad = _leaves(sj)
    bad[3] = bad[3] * np.float32(1.5)                        # Wdft re
    with pytest.raises(ValueError, match="differs"):
        csdr_tpu_torch.state_from_jax_leaves(tblk, bad, device="cpu")
    with pytest.raises(ValueError, match="shape"):            # 3 channels
        csdr_tpu_torch.state_from_jax_leaves(
            tfd.fastddc_dynamic_channelizer_block(td, 3), _leaves(sj),
            device="cpu")

    # the factored inverse: phases and packed W; another plan's W refused
    finit, _ = jfd.fastddc_inv_dynamic_factored_block(jd, c, precision)
    lf = _leaves(finit())
    fblk = tfd.fastddc_inv_dynamic_factored_block(td, c)
    assert csdr_tpu_torch.state_from_jax_leaves(
        fblk, lf, device="cpu").shape == (c,)
    j8 = jfd.fastddc_init(0.05, 8)
    l8 = _leaves(jfd.fastddc_inv_dynamic_factored_block(j8, c,
                                                        precision)[0]())
    with pytest.raises(ValueError, match="W"):
        csdr_tpu_torch.state_from_jax_leaves(fblk, l8, device="cpu")

    # the classed (and dense) inverse: phases alone
    for d in (50, 16):
        dinit = jfd.fastddc_inv_dynamic_block(jfd.fastddc_init(0.05, d), c)[0]
        dblk = tfd.fastddc_inv_dynamic_block(tfd.fastddc_init(0.05, d), c)
        assert csdr_tpu_torch.state_from_jax_leaves(
            dblk, _leaves(dinit()), device="cpu").shape == (c,)
        with pytest.raises(ValueError, match="shape"):
            csdr_tpu_torch.state_from_jax_leaves(
                tfd.fastddc_inv_dynamic_block(tfd.fastddc_init(0.05, d), 3),
                _leaves(dinit()), device="cpu")
