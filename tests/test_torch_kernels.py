"""The port's FIR kernels against float64 numpy, and on the card against
their plain versions.

This file imports neither jax nor csdr_tpu, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The tests marked ``cuda`` skip without a card.
"""

import numpy as np
import pytest
import torch

from csdr_tpu_torch import firdes
from csdr_tpu_torch.kernels import fir_cuda

torch.set_num_threads(2)

# (D, T, rate, theta): the WFM front end, the BASELINE headline FIR, a
# short-D case and the D=50 receivers' front ends
CASES = ((10, 79, -0.2, 0.6), (10, 1023, -0.2, 0.0), (4, 243, -0.05, 0.9),
         (50, 81, 0.137, 0.3), (50, 801, 0.01, 0.25))


def _snr_db(ref, test):
    err = np.sum(np.abs(ref - test) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(np.abs(ref) ** 2)
                                                 / err)


def _inputs(d, t, kout, seed):
    tail_len = ((t - 1 + d - 1) // d) * d
    n = kout * d
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(tail_len + n)
         + 1j * rng.standard_normal(tail_len + n)).astype(np.complex64)
    taps = firdes.firdes_lowpass_f(t, 0.5 / d)
    return v[:tail_len], v[tail_len:], taps


def _ref64(v, taps, d, kout, rate=None, theta=0.0):
    """float64 numpy: mix by exp(j*2*pi*(theta + rate*s)), then the
    stride-D correlation."""
    v = v.astype(np.complex128)
    if rate is not None:
        s = np.arange(len(v), dtype=np.float64)
        v = v * np.exp(2j * np.pi * (theta + np.mod(rate * s, 1.0)))
    idx = np.arange(kout)[:, None] * d + np.arange(len(taps))[None, :]
    return v[idx] @ taps.astype(np.float64)


@pytest.mark.parametrize("d,t,rate,theta", CASES[:3])
def test_plain_versions_match_float64(d, t, rate, theta):
    kout = 300
    tail, x, taps = _inputs(d, t, kout, seed=1)
    v = np.concatenate([tail, x])
    args = (torch.from_numpy(tail), torch.from_numpy(x),
            torch.from_numpy(taps), d, kout)
    y1 = fir_cuda.shift_fir_decimate(*args, rate, theta).numpy()
    assert _snr_db(_ref64(v, taps, d, kout, rate, theta), y1) > 110
    y2 = fir_cuda.fir_decimate(*args).numpy()
    assert _snr_db(_ref64(v, taps, d, kout), y2) > 120


def test_nco_phasor_is_exact_far_into_a_chunk():
    """The phase is frac(rate*s) in float64: no drift at s ~ 2.4e6."""
    s0 = 2_400_000
    p = fir_cuda.nco_phasor(s0 + 64, -0.2137, 0.25, "cpu")[s0:].numpy()
    s = np.arange(s0, s0 + 64, dtype=np.float64)
    ideal = np.exp(2j * np.pi * (0.25 + np.mod(-0.2137 * s, 1.0)))
    assert np.max(np.abs(p - ideal)) < 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CPU tests use the plain "
                    "versions, and chip_smoke.py checks the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,t,rate,theta", CASES)
def test_cuda_kernels_match_plain(cuda, d, t, rate, theta):
    kout = 3 * fir_cuda.TILE + 17                # a ragged last tile
    tail, x, taps = _inputs(d, t, kout, seed=7)
    args = (torch.from_numpy(tail).to(cuda), torch.from_numpy(x).to(cuda),
            torch.from_numpy(taps).to(cuda), d, kout)
    n0 = dict(fir_cuda.LAUNCHES)
    yk = fir_cuda.shift_fir_decimate(*args, rate, theta)
    yp = fir_cuda.shift_fir_decimate_plain(*args, rate, theta)
    torch.cuda.synchronize()
    assert _snr_db(yp.cpu().numpy(), yk.cpu().numpy()) > 110
    yk = fir_cuda.fir_decimate(*args)
    yp = fir_cuda.fir_decimate_plain(*args)
    assert _snr_db(yp.cpu().numpy(), yk.cpu().numpy()) > 110
    assert fir_cuda.LAUNCHES["shift_fir_decimate"] == \
        n0["shift_fir_decimate"] + 1
    assert fir_cuda.LAUNCHES["fir_decimate"] == n0["fir_decimate"] + 1


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_shapes_the_kernel_refuses(cuda):
    x = torch.zeros(200_000, dtype=torch.complex64, device=cuda)
    taps = torch.ones(801, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fir_cuda.fir_decimate(x[:0], x, taps, 200, 10)
