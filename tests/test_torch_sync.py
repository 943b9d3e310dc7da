"""Timing recovery, Costas loop and PLL of csdr_tpu_torch against
csdr_tpu on the same numpy inputs.

The timing recovery loop (TED) has no transcendental: its symbols, errors,
indexes, counts and carried (tail, occ, corr) must be csdr_tpu's bit for
bit, serial and segmented, GARDNER and EARLYLATE, streamed at two chunk
sizes and resumed from a csdr_tpu state.  The Costas loop and the PLL
evaluate sin/cos/atan2 inside their feedback, where torch and XLA differ
in the last bits, so they are held to the bars of csdr_tpu's own tests
(tests/test_digital.py: 32 dB over the first 256 Costas samples and 28 dB
over the stream against the reference C, 39 and 30 dB against a float64
model) and, for the PLL, 40 dB against csdr_tpu and 30 dB against a
float64 model of the same recurrence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu.core.cplx import CF
from csdr_tpu.ops import sync as jsync

from csdr_tpu_torch.core.checkpoint import state_from_jax_leaves
from csdr_tpu_torch.ops import sync as tsync

torch.set_num_threads(2)

DECIM = 16


def _cf(x):
    x = np.asarray(x, np.complex64)
    return CF(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))


def _np(a):
    if isinstance(a, CF):
        return np.asarray(a.re) + 1j * np.asarray(a.im)
    return np.asarray(a)


def _snr(ref, test):
    err = np.sum(np.abs(ref - test) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(np.abs(ref) ** 2)
                                                 / err)


def _bpsk(seed, n_bits, decim=DECIM, q=0.2, noise=0.05):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n_bits) * 2.0 - 1.0
    sm = np.convolve(np.repeat(bits, decim), np.hanning(decim), mode="same")
    x = sm + 1j * q * sm + noise * rng.standard_normal(len(sm))
    return x.astype(np.complex64)


def _same_state(st, sj):
    tail, occ, corr = st
    np.testing.assert_array_equal(tail.numpy(), _np(sj[0]))
    assert int(occ) == int(sj[1]) and int(corr) == int(sj[2])


def _stream_both(jblk, tblk, x, chunk, sj=None, st=None):
    """Both blocks over ``x`` in chunks: every chunk's whole output buffer,
    count and carried state must be equal."""
    sj = jblk.init(1) if sj is None else sj
    st = tblk.init("cpu") if st is None else st
    apply = jax.jit(jblk.apply)
    total = 0
    for c in range(len(x) // chunk):
        xc = x[c * chunk:(c + 1) * chunk]
        sj, oj = apply(sj, _cf(xc))
        with torch.no_grad():
            st, ot = tblk(st, torch.from_numpy(xc))
        assert int(ot.count) == int(oj.count), c
        got = ot.data.numpy()
        assert got.shape == _np(oj.data).shape
        np.testing.assert_array_equal(got, _np(oj.data), err_msg=f"chunk {c}")
        _same_state(st, sj)
        total += int(ot.count)
    return sj, st, total


def _blocks(alg, segments, output="symbols", decim=DECIM, warm=8):
    kw = dict(use_q=True, output=output, segments=segments,
              warmup_symbols=warm)
    return (jsync.timing_recovery_block(alg, decim, **kw),
            tsync.timing_recovery_block(alg, decim, **kw))


X_TED = _bpsk(5, 400)              # 6400 samples


@pytest.mark.parametrize("chunk", [1600, 3200])
@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("alg", ["GARDNER", "EARLYLATE"])
def test_ted_symbols_bit_exact_streamed(alg, segments, chunk):
    jblk, tblk = _blocks(alg, segments)
    _, _, total = _stream_both(jblk, tblk, X_TED, chunk)
    assert total > 350


@pytest.mark.parametrize("output", ["error", "indexes"])
@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("alg", ["GARDNER", "EARLYLATE"])
def test_ted_error_and_indexes_bit_exact(alg, segments, output):
    jblk, tblk = _blocks(alg, segments, output)
    _stream_both(jblk, tblk, X_TED, 1600)


@pytest.mark.parametrize("segments", [1, 4])
def test_ted_resumes_from_csdr_tpu_state(segments):
    """csdr_tpu streams two chunks, the port takes its state leaves and
    both stream on: equal bit for bit."""
    jblk, tblk = _blocks("GARDNER", segments)
    sj, _, _ = _stream_both(jblk, tblk, X_TED[:3200], 1600)
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(sj)]
    st = state_from_jax_leaves(tblk, leaves, device="cpu")
    _same_state(st, sj)
    _stream_both(jblk, tblk, X_TED[3200:], 1600, sj, st)


def test_ted_batch_rows_as_alone():
    """A (C, n) batch gives each row what the row gives alone."""
    _, tblk = _blocks("GARDNER", 1)
    rows = np.stack([X_TED[:3200], X_TED[3200:], X_TED[1000:4200]])
    with torch.no_grad():
        sb, ob = tblk(tblk.init("cpu", channels=3), torch.from_numpy(rows))
        for r in range(3):
            s1, o1 = tblk(tblk.init("cpu"), torch.from_numpy(rows[r]))
            assert int(ob.count[r]) == int(o1.count)
            np.testing.assert_array_equal(ob.data[r].numpy(),
                                          o1.data.numpy())
            for a, b in zip(sb, s1):
                np.testing.assert_array_equal(a[r].numpy(), b.numpy())


@pytest.mark.parametrize("segments", [1, 2])
def test_ted_saturation_drop_oldest(segments):
    """A ramp that rails the Gardner error (the loop falls behind), then a
    clean stream: the carry stays coherent and equal to csdr_tpu's
    (tests/test_digital.py, tests/test_segmented_ted.py)."""
    jblk, tblk = _blocks("GARDNER", segments, decim=8, warm=4)
    ramp = np.linspace(0, 1, 64, dtype=np.float32).astype(np.complex64)
    sj, st = None, None
    for _ in range(8):
        sj, st, _ = _stream_both(jblk, tblk, ramp, 64, sj, st)
        assert 0 <= int(st[1]) <= st[0].shape[0]
    sig = np.repeat(np.resize([1.0, -1.0], 64), 8).astype(np.complex64)
    _, _, got = _stream_both(jblk, tblk, sig, 64, sj, st)
    assert got > 0


def test_ted_degenerate_span_falls_back_to_serial():
    """Chunks too small to give every segment its warmup run serially:
    the same indexes as segments=1, and as csdr_tpu."""
    rng = np.random.default_rng(3)
    sig = np.repeat(rng.integers(0, 2, 64) * 2.0 - 1.0, 8).astype(
        np.complex64)
    outs = []
    for segs in (1, 8):
        jblk, tblk = (jsync.timing_recovery_block("GARDNER", 8, segments=segs,
                                                  output="indexes"),
                      tsync.timing_recovery_block("GARDNER", 8, segments=segs,
                                                  output="indexes"))
        st, idx = tblk.init("cpu"), []
        for c in range(8):
            st, o = tblk(st, torch.from_numpy(sig[c * 64:(c + 1) * 64]))
            idx.append(o.compact().numpy())
        outs.append(np.concatenate(idx))
    np.testing.assert_array_equal(outs[1], outs[0])
    _stream_both(jblk, tblk, sig, 64)      # segments=8 against csdr_tpu


# --------------------------------------------------------------------------
# Costas loop and PLL
# --------------------------------------------------------------------------

def _costas_input():
    rng = np.random.default_rng(4)
    bb = np.repeat(rng.integers(0, 2, 64) * 2.0 - 1.0, 32)
    n = len(bb)
    return (bb * np.exp(1j * (2 * np.pi * 0.001 * np.arange(n) + 0.3))
            ).astype(np.complex64)


def test_costas_params_equal():
    for bw in (0.01, 2 * np.pi / 100):
        assert tsync.costas_loop_params(bw) == jsync.costas_loop_params(bw)
    for bw in (0.01, 0.003):
        assert tsync.pll_loop_params(bw) == jsync.pll_loop_params(bw)


def test_costas_matches_csdr_tpu_and_f64_model():
    x = _costas_input()
    alpha, beta, dmax = tsync.costas_loop_params(0.01)
    jy, je, jd, jst = jsync.bpsk_costas_loop_cc(_cf(x), alpha, beta, dmax)
    ty, te, td, tst = tsync.bpsk_costas_loop_cc(torch.from_numpy(x), alpha,
                                                beta, dmax)
    jy, ty = _np(jy), ty.numpy()
    assert _snr(jy[:256], ty[:256]) >= 32
    assert _snr(jy, ty) >= 28
    # float64 model of the recurrence (reference libcsdr.c:2108-2142)
    ph = fr = 0.0
    model = np.zeros(len(x), np.complex128)
    for i, xi in enumerate(x.astype(np.complex128)):
        y = xi * (np.cos(ph) + 1j * np.sin(ph))
        model[i] = y
        e = np.pi * y.real * y.imag
        fr += e * beta
        dp = np.clip(e * alpha + fr, -dmax, dmax)
        ph = (ph + dp) % (2 * np.pi)
        if ph <= 0:
            ph += 2 * np.pi
    assert _snr(model[:128], ty[:128]) >= 39
    assert _snr(model, ty) >= 30
    # streamed in two chunks with the carried state: the same samples
    ty1, _, _, s1 = tsync.bpsk_costas_loop_cc(torch.from_numpy(x[:700]),
                                              alpha, beta, dmax)
    ty2, _, _, _ = tsync.bpsk_costas_loop_cc(torch.from_numpy(x[700:]),
                                             alpha, beta, dmax, state=s1)
    np.testing.assert_array_equal(np.concatenate([ty1, ty2]), ty)


@pytest.mark.parametrize("dd", [False, True])
def test_costas_block_and_batch(dd):
    """costas_block (decision-directed too) against csdr_tpu's, and a batch
    of rows equal to each row alone."""
    x = _costas_input()[:1024]
    jblk = jsync.costas_block(0.01, decision_directed=dd)
    tblk = tsync.costas_block(0.01, decision_directed=dd)
    _, jy = jblk.apply(jblk.init(), _cf(x))
    st, ty = tblk(tblk.init("cpu"), torch.from_numpy(x))
    assert _snr(_np(jy)[:256], ty.numpy()[:256]) >= 32
    assert _snr(_np(jy), ty.numpy()) >= 28
    rows = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    _, tb = tblk(tblk.init("cpu", shape=(2,)), rows)
    np.testing.assert_array_equal(tb[0].numpy(), ty.numpy())


def _pll_input(n=3000):
    k = np.arange(n)
    return np.exp(1j * (2 * np.pi * 0.002 * k + 1.0)).astype(np.complex64)


@pytest.mark.parametrize("pi_controller", [True, False])
def test_pll_matches_csdr_tpu(pi_controller):
    x = _pll_input()
    jblk = jsync.pll_block(0.01, pi_controller, output="nco")
    tblk = tsync.pll_block(0.01, pi_controller, output="nco")
    _, jn = jblk.apply(jblk.init(), _cf(x))
    ts, tn = tblk(tblk.init("cpu"), torch.from_numpy(x))
    assert _snr(_np(jn), tn.numpy()) >= 40
    jd = jsync.pll_cc(_cf(x), tblk.alpha, tblk.beta)[0]
    td = tsync.pll_cc(torch.from_numpy(x), tblk.alpha, tblk.beta)[0]
    assert _snr(np.asarray(jd), td.numpy()) >= 40
    if pi_controller:
        # locked: the NCO (sin + j cos) tracks the input's phase ramp
        phase_in = np.arctan2(x[-500:].real, x[-500:].imag)
        phase_nco = np.arctan2(tn.numpy()[-500:].real, tn.numpy()[-500:].imag)
        err = np.angle(np.exp(1j * (phase_in - phase_nco)))
        assert np.max(np.abs(err)) < 0.05
    # float64 model of the recurrence (reference libcsdr.c:1870-1915)
    wrap = lambda p: (p + np.pi) % (2 * np.pi) - np.pi   # noqa: E731
    op = dp = iir = 0.0
    model = np.zeros(len(x), np.complex128)
    for i, xi in enumerate(x.astype(np.complex128)):
        op = wrap(op + dp)
        model[i] = np.sin(op) + 1j * np.cos(op)
        nd = wrap(np.arctan2(xi.real, xi.imag) - op)
        if tblk.beta is None:
            dp = nd * tblk.alpha
        else:
            dp = wrap(nd * tblk.alpha + iir)
            iir += nd * tblk.beta
    assert _snr(model, tn.numpy()) >= 30
    # streamed with the carried state
    s1, t1 = tblk(tblk.init("cpu"), torch.from_numpy(x[:1000]))
    _, t2 = tblk(s1, torch.from_numpy(x[1000:]))
    np.testing.assert_array_equal(torch.cat([t1, t2]).numpy(), tn.numpy())
