"""The carrier loops' kernel wrappers (``kernels/carrier_cuda``: the Costas
loop and the PLL) on the CPU, where they run their plain versions, against
csdr_tpu; the kernels' phase wrap against torch's; and the config-5 bank
with its Costas loop through the routed op against csdr_tpu's bank.

The loops evaluate sin/cos/atan2 inside their feedback, where torch's CPU
and XLA's transcendentals differ in the last bits, so the outputs are held
at the bars of tests/test_torch_sync.py (csdr_tpu's own: 32 dB over the
first 256 Costas samples and 28 dB over all; the PLL at 40 dB).  The
kernels (csrc/carrier.cu) replace torch.remainder(a, 2pi) by compares,
selects and one exact subtract where a lies in (-2pi, 4pi), and run a
tile again with fmod where a phase leaves that range: a float32 numpy
model of those forms must give torch's bits over that range and past its
edges.  On
the card the kernels are held against the plain versions bit for bit
(tests/test_torch_kernels.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu.core.cplx import CF
from csdr_tpu.ops import sync as jsync

from csdr_tpu_torch.kernels import carrier_cuda
from csdr_tpu_torch.ops import sync as tsync

import test_torch_multichannel as tmc_tests

torch.set_num_threads(2)

COSTAS_BARS = (32.0, 28.0)      # dB: the first 256 samples, all
PLL_BAR = 40.0                  # dB
F32 = np.float32
TWO_PI32 = F32(2.0 * np.pi)
PI32 = F32(np.pi)


def _cf(x):
    return CF(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))


def _np(a):
    if isinstance(a, CF):
        return np.asarray(a.re) + 1j * np.asarray(a.im)
    return np.asarray(a)


def _snr(ref, test):
    err = np.sum(np.abs(ref - test) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(np.abs(ref) ** 2)
                                                 / err)


def _bpsk(n_sym=64, sps=32, offset=0.001, seed=4):
    """BPSK at ``sps`` samples a symbol on a carrier ``offset`` cycles a
    sample away (csdr_tpu's test_digital.py input)."""
    rng = np.random.default_rng(seed)
    bb = np.repeat(rng.integers(0, 2, n_sym) * 2.0 - 1.0, sps)
    k = np.arange(len(bb))
    return (bb * np.exp(1j * (2 * np.pi * offset * k + 0.3))
            ).astype(np.complex64)


@pytest.mark.parametrize("dd,reset", [(False, False), (True, False),
                                      (False, True), (True, True)])
def test_costas_wrapper_matches_csdr_tpu(dd, reset):
    """carrier_cuda.costas on CPU tensors, both error modes, the dphase
    clamp and its reset-to-zero form, against csdr_tpu's scan; streamed in
    two calls with the state carried, the same samples bit for bit."""
    x = _bpsk(offset=0.004 if reset else 0.001)
    alpha, beta, dmax = tsync.costas_loop_params(0.01)
    jy, _, _, _ = jsync.bpsk_costas_loop_cc(_cf(x), alpha, beta, dmax, dd,
                                            reset)
    ty, te, td, ts = carrier_cuda.costas(torch.from_numpy(x), alpha, beta,
                                         dmax, dd, reset)
    jy, ty = _np(jy), ty.numpy()
    assert _snr(jy[:256], ty[:256]) >= COSTAS_BARS[0]
    assert _snr(jy, ty) >= COSTAS_BARS[1]
    np.testing.assert_array_equal(np.abs(td.numpy()) <= F32(dmax), True)
    if reset and not dd:        # the offset drives dphase past dmax
        assert (td.numpy() == 0).any()
    y1, e1, d1, s1 = carrier_cuda.costas(torch.from_numpy(x[:700]), alpha,
                                         beta, dmax, dd, reset)
    y2, e2, d2, s2 = carrier_cuda.costas(torch.from_numpy(x[700:]), alpha,
                                         beta, dmax, dd, reset, state=s1)
    np.testing.assert_array_equal(torch.cat([y1, y2]).numpy(), ty)
    np.testing.assert_array_equal(torch.cat([e1, e2]).numpy(), te.numpy())
    np.testing.assert_array_equal(torch.cat([d1, d2]).numpy(), td.numpy())
    for a, b in zip(s2, ts):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pi_controller", [True, False])
def test_pll_wrapper_matches_csdr_tpu(pi_controller):
    """carrier_cuda.pll on CPU tensors, P and PI, both outputs, against
    csdr_tpu's pll_cc at 40 dB; two rows each as alone."""
    k = np.arange(3000)
    x = np.exp(1j * (2 * np.pi * 0.002 * k + 1.0)).astype(np.complex64)
    alpha, beta = tsync.pll_loop_params(0.01)
    if not pi_controller:
        alpha, beta = 0.01, None
    jd, jn, _ = jsync.pll_cc(_cf(x), alpha, beta)
    td, tn, ts = carrier_cuda.pll(torch.from_numpy(x), alpha, beta)
    assert _snr(np.asarray(jd), td.numpy()) >= PLL_BAR
    assert _snr(_np(jn), tn.numpy()) >= PLL_BAR
    rows = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    rd, rn, rs = carrier_cuda.pll(rows, alpha, beta)
    np.testing.assert_array_equal(rd[0].numpy(), td.numpy())
    np.testing.assert_array_equal(rn[0].numpy(), tn.numpy())
    assert [tuple(t.shape) for t in rs] == [(2,)] * 3


def _near_model(a: np.ndarray):
    """csrc/carrier.cu's Near forms, the kernels' branch-free wraps, in
    float32 numpy: (rem, phase, far).  rem: a + 2pi below 0, a - 2pi from
    2pi up (exact: Sterbenz), else a; phase (the Costas phase's remainder
    with its <= 0 fix): a + 2pi up to 0, a - 2pi past 2pi, else a; far:
    a outside (-2pi, 4pi) or NaN, where the kernel runs the tile again
    with the exact forms."""
    a = np.asarray(a, F32)
    with np.errstate(invalid="ignore"):
        far = ~((a > -TWO_PI32) & (a < F32(2) * TWO_PI32))
        up, dn = a + TWO_PI32, a - TWO_PI32
        rem = np.where(a < 0, up, np.where(a >= TWO_PI32, dn, a))
        phase = np.where(a <= 0, up, np.where(a > TWO_PI32, dn, a))
    return rem.astype(F32), phase.astype(F32), far


def _remainder_model(a: np.ndarray) -> np.ndarray:
    """csrc/carrier.cu's remainder as its kernels take it, float32 numpy:
    the Near form in (-2pi, 4pi); past it the exact form's fmod and
    torch's sign fix."""
    a = np.asarray(a, F32)
    rem, _, far = _near_model(a)
    with np.errstate(invalid="ignore"):
        m = np.fmod(a, TWO_PI32)
        exact = np.where(m < 0, m + TWO_PI32, m)
    return np.where(far, exact, rem).astype(F32)


def _phase_model(a: np.ndarray) -> np.ndarray:
    """The Costas phase update as the kernel makes it from a = phase +
    dphase: the Near form in (-2pi, 4pi), else the exact remainder and
    the <= 0 fix."""
    _, phase, far = _near_model(a)
    r = _remainder_model(a)
    with np.errstate(invalid="ignore"):
        exact = np.where(r <= 0, r + TWO_PI32, r)
    return np.where(far, exact, phase).astype(F32)


def _phases() -> np.ndarray:
    """The reachable phase range and past it, float32: a dense sweep of
    (-2pi - 1, 4pi + 1), the 8 neighbours of every edge (-2pi, -pi, 0, pi,
    2pi, 3pi, 4pi), +-0, subnormals, large and non-finite values."""
    sweep = np.linspace(-2 * np.pi - 1, 4 * np.pi + 1, 400_001).astype(F32)
    edges = []
    for e in (-TWO_PI32, -PI32, F32(0), PI32, TWO_PI32, F32(3) * PI32,
              F32(2) * TWO_PI32):
        v = e
        for _ in range(4):
            v = np.nextafter(v, F32(-np.inf))
            edges.append(v)
        v = e
        for _ in range(4):
            v = np.nextafter(v, F32(np.inf))
            edges.append(v)
        edges.append(e)
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38, 25.0, -9.0,
                        1e6, -1e6, 3e38, -3e38, np.inf, -np.inf, np.nan],
                       F32)
    return np.concatenate([sweep, np.array(edges, F32), special])


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    nan = np.isnan(a)
    return bool((nan == np.isnan(b)).all() and (
        a[~nan].view(np.uint32) == b[~nan].view(np.uint32)).all())


def _torch_phase(a: np.ndarray) -> np.ndarray:
    """costas_plain's phase update from a = phase + dphase."""
    t = torch.remainder(torch.from_numpy(a), carrier_cuda.TWO_PI)
    return torch.where(t <= 0, t + carrier_cuda.TWO_PI, t).numpy()


def test_kernel_phase_wrap_model_is_torch_bit_for_bit():
    """The kernels' remainder, wrap_pi and the Costas phase update, as
    float32 numpy, against torch.remainder, carrier_cuda.wrap_pi and
    costas_plain's update, bit for bit (NaNs by place), over the phase
    range and past it; from every reachable Costas phase the update stays
    in the Near range (no tile runs again)."""
    a = _phases()
    want = torch.remainder(torch.from_numpy(a), carrier_cuda.TWO_PI).numpy()
    assert _same_bits(_remainder_model(a), want)
    with np.errstate(invalid="ignore"):
        got = _remainder_model(a + PI32) - PI32
    assert _same_bits(got, carrier_cuda.wrap_pi(torch.from_numpy(a)).numpy())
    assert _same_bits(_phase_model(a), _torch_phase(a))
    # the Costas update from every reachable phase (0, 2pi] by a dphase in
    # +-dmax (G_c's: 0.395) and its edges
    rng = np.random.default_rng(1)
    ph = np.concatenate([rng.uniform(0, 2 * np.pi, 200_000).astype(F32),
                         [TWO_PI32, np.nextafter(TWO_PI32, F32(0)),
                          F32(1e-45), F32(1e-7)]]).astype(F32)
    d = np.concatenate([rng.uniform(-0.4, 0.4, 200_000).astype(F32),
                        [F32(0), F32(-1e-7), F32(-1e-45), F32(1e-7)]]
                       ).astype(F32)
    s = (ph + d).astype(F32)
    assert not _near_model(s)[2].any()
    assert _same_bits(_phase_model(s), _torch_phase(s))


def test_bank_with_costas_runs_the_routed_op_and_matches_csdr_tpu(
        monkeypatch):
    """build_ddc_bpsk31_bank(use_costas=True) on CPU tensors over two
    chunks of two BPSK31 channels with a residual carrier offset: the
    modem's Costas loop goes through ops/sync into carrier_cuda (its plain
    version once a chunk), the text comes back (BER < 0.03) and the bits
    are csdr_tpu's bank's within its bar."""
    calls = []
    plain = carrier_cuda.costas_plain

    def counted(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    monkeypatch.setattr(carrier_cuda, "costas_plain", counted)
    decim = 16
    centers = np.array([-0.25, 0.2])
    texts = [b"COSTAS CHANNEL %d TEST " % i * 2 for i in range(2)]
    tx_bits, chunks = tmc_tests._wideband(decim, texts, centers, 2,
                                          delta=0.00025, noise=0.0)
    rates = [-f for f in centers]
    kw = dict(use_costas=True)
    outs, st = tmc_tests._run_port(chunks, decim, bank_kw=kw, rates=rates)
    assert len(calls) == 2 and calls[0][0] == 2
    jouts, _ = tmc_tests._run_jax(chunks, decim, bank_kw=kw, rates=rates)
    for c in range(2):
        got = tmc_tests._joined(outs, c)
        errs, total = tmc_tests._align(tx_bits[c][16:], got[16:])
        assert total > 300 and errs / total < 0.03, (c, errs, total)
        errs, total = tmc_tests._align(tmc_tests._joined(jouts, c)[16:],
                                       got[16:])
        assert errs / total < 0.03, (c, errs, total)
    assert len(st) == 7
