"""csdr_tpu_torch's NCO shift and decimating FIR against csdr_tpu.

csdr_tpu's Pallas kernels run as its own tests run them on the CPU, through
the Pallas interpreter (CSDR_PALLAS_INTERPRET=1).  Here the port's wrappers
take their plain versions, since the tensors lie on the CPU;
tests/test_torch_kernels.py holds the CUDA kernels against those plain
versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu import firdes
from csdr_tpu.core.cplx import CF
from csdr_tpu.kernels import fir_pallas as jfp
from csdr_tpu.ops import fir as jfir
from csdr_tpu.ops import shift as jshift

from csdr_tpu_torch.kernels import fir_cuda
from csdr_tpu_torch.ops import fir as tfir
from csdr_tpu_torch.ops import shift as tshift

from tests.util import assert_snr, cplx_noise

torch.set_num_threads(2)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CSDR_PALLAS_INTERPRET", "1")


def _cf(x: np.ndarray) -> CF:
    return CF(jnp.asarray(x.real.astype(np.float32)),
              jnp.asarray(x.imag.astype(np.float32)))


def _np(y: CF) -> np.ndarray:
    return np.asarray(y.re) + 1j * np.asarray(y.im)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.complex64))


def _taps(t, d):
    return np.asarray(firdes.firdes_lowpass_f(t, 0.5 / d), np.float32)


# --------------------------------------------------------------------------
# shift (bars of tests/test_shift.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.2, -0.05, 0.4999, 1e-4])
def test_shift_cc_matches_float64_ideal_and_jax(rate):
    x = cplx_noise(4096)
    s = np.arange(4096, dtype=np.float64)
    ideal = (x * np.exp(1j * 2 * np.pi * np.mod(s * rate, 1.0))
             ).astype(np.complex64)
    y, nxt = tshift.shift_cc(_t(x), rate)
    assert_snr(ideal, y.numpy(), 110, f"ideal NCO rate={rate}")
    yj, nxtj = jshift.shift_cc(_cf(x), rate)
    assert_snr(_np(yj), y.numpy(), 110, f"vs csdr_tpu rate={rate}")
    assert nxt.dtype == torch.float32 and float(nxt) == float(nxtj)


def test_shift_block_phase_carry_matches_jax():
    x = cplx_noise(8192, seed=3)
    one, _ = tshift.shift_cc(_t(x), 0.123)
    bt, bj = tshift.shift_block(0.123), jshift.shift_block(0.123)
    st, sj = bt.init("cpu"), bj.init()
    outs = []
    for c in range(4):
        xc = x[c * 2048:(c + 1) * 2048]
        st, y = bt(st, _t(xc))
        sj, yj = bj.apply(sj, _cf(xc))
        assert float(st) == float(sj)            # carried phase, f32 exact
        assert_snr(_np(yj), y.numpy(), 110, f"chunk {c}")
        outs.append(y.numpy())
    assert_snr(one.numpy(), np.concatenate(outs), 100, "phase carry")


# --------------------------------------------------------------------------
# K1 / K2 plain versions against the interpret-mode Pallas kernels
# --------------------------------------------------------------------------

K1_CASES = ((10, 1023, -0.2, 0.0), (10, 81, 0.137, 0.3), (4, 243, -0.05, 0.9))


def _mk_input(kout, d, t, seed):
    n = kout * d
    tail = ((t - 1 + d - 1) // d) * d
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n + tail)
            + 1j * rng.standard_normal(n + tail)).astype(np.complex64)


@pytest.mark.parametrize("d,t,rate,phase", K1_CASES)
def test_shift_fir_decimate_plain_matches_pallas_k1(interpret, d, t, rate,
                                                     phase):
    kout = 16 * 128
    x = _mk_input(kout, d, t, seed=3)
    taps = _taps(t, d)
    y = fir_cuda.shift_fir_decimate(_t(x[:0]), _t(x), torch.from_numpy(taps),
                                    d, kout, rate, phase).numpy()
    for prec, bar in ((jax.lax.Precision.HIGHEST, 110),
                      (jax.lax.Precision.HIGH, 95)):   # HIGH is bf16x3
        yj = jfp.fir_decimate_vmem_shift(_cf(x), jnp.asarray(taps), d, kout,
                                         rate, jnp.float32(phase), prec,
                                         jb=8)
        assert_snr(_np(yj), y, bar, f"K1 {prec} D={d} T={t}")
    sh, _ = jshift.shift_cc(_cf(x), rate, phase=2 * np.pi * phase)
    ref = jfir.fir_decimate_cc(sh, jnp.asarray(taps), d)[:kout]
    assert_snr(_np(ref), y, 110, "K1 vs shift_cc + fir_decimate_cc")


def test_fir_decimate_plain_matches_pallas_k2(interpret):
    d, t, kout = 10, 1023, 8 * 128
    x = _mk_input(kout, d, t, seed=0)
    taps = _taps(t, d)
    yj = jfp.fir_decimate_vmem(_cf(x), taps, d, kout,
                               jax.lax.Precision.HIGHEST)
    y = fir_cuda.fir_decimate(_t(x[:0]), _t(x), torch.from_numpy(taps), d,
                              kout).numpy()
    assert_snr(_np(yj), y, 120, "K2 vs fir_decimate_vmem")
    # the stateless op is the same function
    assert np.array_equal(
        tfir.fir_decimate_cc(_t(x), taps, d)[:kout].numpy(), y)


def test_wrapper_checks_shapes_and_types():
    taps = torch.from_numpy(_taps(79, 10))
    x = torch.zeros(1000, dtype=torch.complex64)
    with pytest.raises(ValueError, match="need"):
        fir_cuda.fir_decimate(x[:0], x, taps, 10, 100)
    with pytest.raises(TypeError, match="complex64"):
        fir_cuda.fir_decimate(x[:0], x.real.contiguous(), taps, 10, 10)
    with pytest.raises(ValueError, match="precision"):
        fir_cuda.fir_decimate(x[:0], x, taps, 10, 10, precision="DEFAULT")
    before = dict(fir_cuda.LAUNCHES)
    fir_cuda.fir_decimate(x[:0], x, taps, 10, 10)
    assert fir_cuda.LAUNCHES == before          # CPU: plain, no launch
    # the kernel takes the D=50 receivers' T=801 and refuses a shape
    # whose smallest block does not fit in shared memory
    assert fir_cuda.plan_tile(801, 50, 48_060)["smem"] <= fir_cuda.MAX_SMEM
    assert fir_cuda.smem_bytes(801, 2000, 32, 1) > fir_cuda.MAX_SMEM


# --------------------------------------------------------------------------
# streaming blocks against csdr_tpu's zero-concat split path
# --------------------------------------------------------------------------

def _count_calls(monkeypatch, name):
    seen = []
    orig = getattr(jfp, name)

    def wrapped(xcat, taps, decimation, kout, *a, **k):
        seen.append(kout)
        return orig(xcat, taps, decimation, kout, *a, **k)

    monkeypatch.setattr(jfp, name, wrapped)
    return seen


def _theta_close(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(a - b) <= np.spacing(max(abs(a), abs(b), np.float32(1e-30)))


def test_shifted_block_streams_like_jax_split_path(interpret, monkeypatch):
    d, t, rate = 10, 79, -0.2
    chunk = 24 * 128 * d
    seen = _count_calls(monkeypatch, "fir_decimate_vmem_shift")
    taps = _taps(t, d)
    bj = jfir.shifted_fir_decimate_block(rate, taps, d,
                                         precision=jax.lax.Precision.HIGHEST)
    bt = tfir.shifted_fir_decimate_block(rate, taps, d)
    sj, st = bj.init(), bt.init("cpu")
    rng = np.random.default_rng(21)
    for i in range(3):
        x = (rng.standard_normal(chunk)
             + 1j * rng.standard_normal(chunk)).astype(np.complex64)
        sj, yj = bj.apply(sj, _cf(x))
        st, yt = bt(st, _t(x))
        assert yt.shape[0] == chunk // d
        assert_snr(_np(yj), yt.numpy(), 110, f"chunk {i}")
        assert _theta_close(st[0], sj[0]), (float(st[0]), float(sj[0]))
        assert np.array_equal(st[1].numpy(), _np(sj[1]).astype(np.complex64))
    # the JAX block took its head/body/tail split: the kernel body got
    # fewer outputs than the chunk has
    assert len(seen) == 3 and all(0 < k < chunk // d for k in seen), seen


@pytest.mark.parametrize("t,body", [(79, "fir_decimate_best"),
                                    (1023, "fir_decimate_vmem")])
def test_fir_block_streams_like_jax_split_path(interpret, monkeypatch, t,
                                               body):
    d = 10
    chunk = 24 * 128 * d
    seen = _count_calls(monkeypatch, body)
    taps = _taps(t, d)
    bj = jfir.fir_decimate_block(taps, d)
    bt = tfir.fir_decimate_block(taps, d)
    sj, st = bj.init(), bt.init("cpu")
    rng = np.random.default_rng(31)
    for i in range(3):
        x = (rng.standard_normal(chunk)
             + 1j * rng.standard_normal(chunk)).astype(np.complex64)
        sj, yj = bj.apply(sj, _cf(x))
        st, yt = bt(st, _t(x))
        assert yt.shape[0] == chunk // d
        assert_snr(_np(yj), yt.numpy(), 110, f"chunk {i}")
        assert np.array_equal(st.numpy(), _np(sj).astype(np.complex64))
    assert seen and all(0 < k < chunk // d for k in seen), seen


def test_fused_block_equals_shift_then_fir_block():
    d, t, rate = 10, 79, 0.11
    chunk = 8 * 128 * d
    taps = _taps(t, d)
    from csdr_tpu_torch.core.block import Pipeline
    serial = Pipeline([tshift.shift_block(rate),
                       tfir.fir_decimate_block(taps, d)])
    fused = tfir.shifted_fir_decimate_block(rate, taps, d)
    ss, sf = serial.init("cpu"), fused.init("cpu")
    rng = np.random.default_rng(12)
    for i in range(3):
        x = _t((rng.standard_normal(chunk)
                + 1j * rng.standard_normal(chunk)).astype(np.complex64))
        ss, ys = serial(ss, x)
        sf, yf = fused(sf, x)
        assert_snr(ys.numpy(), yf.numpy(), 110, f"chunk {i}")


# --------------------------------------------------------------------------
# K5: the direct polyphase form and its dispatcher
# --------------------------------------------------------------------------

def _poly_inputs(d, t, kout, seed):
    """A tail-extended stream of (kout + M - 1)*D samples, as csdr_tpu's
    dispatcher pads it, and lowpass taps."""
    m = -(-t // d)
    rng = np.random.default_rng(seed)
    n = (kout + m - 1) * d
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    return x, _taps(t, d)


@pytest.mark.parametrize("d,t,kout", [(10, 79, 4096), (50, 81, 2048),
                                      (10, 1023, 2048)])
def test_fir_poly_plain_matches_pallas_k5(d, t, kout):
    """csdr_tpu's _fir_decimate_pallas through Pallas' TPU interpreter
    (force_tpu_interpret_mode, which needs no change to csdr_tpu): both
    sum per phase first, both in f32; >= 110 dB, the kernels' bar."""
    from jax.experimental.pallas import tpu as pltpu
    x, taps = _poly_inputs(d, t, kout, seed=d + t)
    m = -(-t // d)
    tmat = np.zeros(m * d, np.float32)
    tmat[:t] = taps
    with pltpu.force_tpu_interpret_mode():
        yr, yi = jfp._fir_decimate_pallas(
            jnp.asarray(x.real), jnp.asarray(x.imag),
            jnp.asarray(tmat.reshape(m, d)), d, kout)
    yj = np.asarray(yr) + 1j * np.asarray(yi)
    yt = fir_cuda.fir_decimate_poly(_t(x), torch.from_numpy(taps), d, kout)
    assert yt.dtype == torch.complex64 and yt.shape == (kout,)
    assert_snr(yj, yt.numpy(), 110, f"K5 D={d} T={t}")


@pytest.mark.parametrize("d,t,kout", [(10, 1023, 2048), (50, 801, 500),
                                      (50, 81, 777), (10, 7, 300),
                                      (50, 49, 40)],
                         ids=["headline", "ssb_front", "nfm_ragged",
                              "m1", "m1_d50"])
def test_fir_poly_dispatcher_matches_jax_dispatcher(d, t, kout):
    """The port's fir_decimate_poly_or_plain against csdr_tpu's
    fir_decimate_pallas_or_fallback, which takes its XLA conv on the CPU
    (as it does for every T <= D and every len % D != 0): ragged kout and
    m = 1 included; the stream here is T - D samples longer than kout
    needs, as a carried tail leaves it."""
    x, taps = _poly_inputs(d, t, kout, seed=t)
    x = x[: (kout - 1) * d + t]
    yj = jfp.fir_decimate_pallas_or_fallback(
        _cf(x), jnp.asarray(taps), d, kout, jax.lax.Precision.HIGHEST)
    yt = fir_cuda.fir_decimate_poly_or_plain(_t(x), taps, d, kout)
    assert_snr(_np(yj), yt.numpy(), 110, f"K5 dispatcher D={d} T={t}")


def test_fir_poly_refuses_bad_calls():
    x = torch.zeros(1000, dtype=torch.complex64)
    taps = torch.ones(81)
    with pytest.raises(ValueError, match="samples"):
        fir_cuda.fir_decimate_poly(x, taps, 50, 20)       # needs 1031
    assert fir_cuda.fir_decimate_poly(x, taps, 50, 19).shape == (19,)
    assert fir_cuda.fir_decimate_poly(x, taps, 50, 0).shape == (0,)
    with pytest.raises(TypeError, match="complex64"):
        fir_cuda.fir_decimate_poly(x.real, taps, 50, 1)
    # the dispatcher takes a float32 tensor as it is, or a float sequence;
    # a tensor of another type or device is refused, not copied
    assert torch.equal(fir_cuda.fir_decimate_poly_or_plain(x, taps, 50, 19),
                       fir_cuda.fir_decimate_poly_or_plain(
                           x, taps.tolist(), 50, 19))
    with pytest.raises(TypeError, match="float32"):
        fir_cuda.fir_decimate_poly_or_plain(x, taps.double(), 50, 1)
    # the planner's launches at the path shapes; a block of the smallest
    # tile must fit in the opt-in shared memory
    assert [(p["tile"], p["per_thread"]) for p in (
        fir_cuda.poly_plan(1023, 10, 240_000),
        fir_cuda.poly_plan(801, 50, 48_061),
        fir_cuda.poly_plan(81, 50, 48_000))] == [(1024, 8), (192, 1), (192, 1)]
    with pytest.raises(ValueError, match="shared memory"):
        fir_cuda.poly_plan(80_000, 2000, 100)
