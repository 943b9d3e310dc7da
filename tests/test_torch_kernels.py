"""The port's kernels (the FIR pair, the direct polyphase FIR, the
kernel-order FFT pair and its natural-order forward, the fastddc inverse,
the IMA ADPCM codec, the timing recovery's symbol loop, the chunked AGC's
relaxation, agc_ff's exact scan, the Costas loop, the PLL, the RTTY Baudot
decoder and the FP32 ceiling's fma-chain probe) against float64 numpy (the
codec against the standard's integer steps in Python), and on the card
against their plain versions (the natural-order forward also against
csdr_tpu's spectra kept in a file, tests/torch_fft_golden.py).

This file imports neither jax nor csdr_tpu, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The tests marked ``cuda`` skip without a card.
"""

import numpy as np
import pytest
import torch

from csdr_tpu_torch import firdes
from csdr_tpu_torch.kernels import (_build, adpcm_cuda, agc_cuda,
                                    baudot_cuda, carrier_cuda, fastddc_cuda,
                                    fft_cuda, fir_cuda, probe_cuda, ted_cuda)
import torch_fft_golden as golden  # tests/, on the path under pytest

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
    kout = 3 * 256 + 17                          # ragged last tiles
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
        fir_cuda.fir_decimate(x[:0], x, taps, 2000, 10)


# (name, D, T, kout): the WFM front end fused and unfused, the D=50
# front ends of paths D (T=81) and C, E, F (T=801), at their chunk sizes,
# and the CLI's fir_decimate_cc 10 0.05 at its 65 536-sample chunk
PATH_SHAPES = (("shift_fir_decimate", 10, 79, 240_000),
               ("fir_decimate", 10, 79, 240_000),
               ("fir_decimate", 50, 81, 48_000),
               ("fir_decimate", 50, 801, 48_060),
               ("fir_decimate", 10, 79, 6553))


@pytest.mark.cuda
@pytest.mark.parametrize("name,d,t,kout", PATH_SHAPES)
def test_cuda_path_shapes_match_plain_and_every_tile_bit_for_bit(
        cuda, name, d, t, kout):
    """At each path shape the planner's launch equals the plain version,
    and launches with other tiles and outputs a thread give the same bits:
    every output is one chain over t = 0 .. T-1 whatever the tile."""
    tail, x, taps = _inputs(d, t, kout, seed=11)
    args = (torch.from_numpy(tail).to(cuda), torch.from_numpy(x).to(cuda),
            torch.from_numpy(taps).to(cuda), d, kout)
    phase = (0.137, 0.3) if name == "shift_fir_decimate" else ()
    kern = getattr(fir_cuda, name)
    y = kern(*args, *phase)
    yp = getattr(fir_cuda, name + "_plain")(*args, *phase)
    assert _snr_db(yp.cpu().numpy(), y.cpu().numpy()) > 110
    chosen = fir_cuda.plan_tile(t, d, kout, bool(phase))
    others = [p for p in fir_cuda.plans(t, d, kout, bool(phase))
              if p["threads"] in (32, 96, 512) and p != chosen]
    assert others
    for plan in others:
        assert torch.equal(kern(*args, *phase, plan=plan), y), plan


# --------------------------------------------------------------------------
# K1/K2's launch planner and a CPU model of the kernel's schedule
# --------------------------------------------------------------------------

def _parent_smem(t, d):
    """Shared memory of the one-output-a-thread kernel of 256-output tiles
    that this design replaced; the shapes it took must still be taken."""
    return 4 * ((t + 1) & ~1) + 8 * (255 * d + t)


# (T, D, kout): the path shapes (the CLI's fir_decimate_cc among them),
# kout = 1, kout = one planned tile + 1, T < D, T = 1, and the BASELINE
# headline
PLAN_CASES = ((79, 10, 240_000), (801, 50, 48_060), (81, 50, 48_000),
              (1023, 10, 262_144), (79, 10, 1), (801, 50, 129), (7, 50, 500),
              (1, 10, 1000), (1, 1, 77), (1023, 10, 1025), (79, 10, 6553))


@pytest.mark.parametrize("t,d,kout", PLAN_CASES)
def test_fir_plan_tile_covers_fits_and_fills(t, d, kout):
    plan = fir_cuda.plan_tile(t, d, kout)
    tile, r, g = plan["tile"], plan["per_thread"], plan["groups"]
    assert r in fir_cuda.PER_THREAD and plan["threads"] in fir_cuda.THREADS
    assert g in fir_cuda.GROUPS and tile == plan["threads"] * r * g
    assert plan["blocks"] * tile >= kout > (plan["blocks"] - 1) * tile
    assert plan["smem"] == fir_cuda.smem_bytes(t, d, tile, r) \
        <= fir_cuda.MAX_SMEM
    assert plan["blocks_per_sm"] >= 1
    if kout >= 48_000:
        # the path shapes: at least one block an SM, all in one wave
        assert fir_cuda.SMS <= plan["blocks"] \
            <= fir_cuda.SMS * plan["blocks_per_sm"]
        assert fir_cuda.waves(plan) == 1


def test_fir_plan_tile_takes_every_shape_the_parent_took():
    """No (D, T) that the 256-output-tile kernel took is refused; the
    largest D at T=801 grows from 110 to where the smallest block, 32
    outputs, no longer fits."""
    for d in (1, 2, 3, 5, 10, 16, 50, 64, 100, 110, 111):
        for t in (1, 7, 79, 81, 801, 1023, 4095, 9001, 19_000):
            if _parent_smem(t, d) <= fir_cuda.MAX_SMEM:
                fir_cuda.plan_tile(t, d, 1000)
    largest = max(d for d in range(1, 1000)
                  if fir_cuda.smem_bytes(801, d, 32, 1) <= fir_cuda.MAX_SMEM)
    assert largest > 110
    assert fir_cuda.plan_tile(801, largest, 100)["tile"] == 32
    for d in (largest + 1, largest + 50, 2000):
        with pytest.raises(ValueError, match="shared memory"):
            fir_cuda.plan_tile(801, d, 100)


def _fma32(a, b, c):
    """f32 a*b + c rounded once from float64 (a*b is exact there): the
    same emulated FMA for both orders below."""
    return (a.astype(np.float64) * np.float64(b)
            + c.astype(np.float64)).astype(np.float32)


def _k2_schedule(v, taps, d, kout, tile, r, g):
    """K1/K2's schedule in numpy, block by block: the phase-major window
    (row p, sub-row c % R, position c / R, odd row stride), the tap table
    H[u][p][r], the steps u outer and p inner, each thread's G runs of R
    outputs at tap rows u - r, and the guards.  Returns complex64
    outputs."""
    t_len = len(taps)
    m = -(-t_len // d)
    steps = m + r - 1
    nt = tile // (r * g)
    sub = -(-(tile + m - 1) // r)
    rs = (r * sub) | 1
    total = len(v)
    y = np.zeros(kout, np.complex64)
    lanes = np.arange(nt)
    for b in range(-(-kout // tile)):
        s0 = b * tile * d
        w = np.zeros(d * rs, np.complex64)
        for i in range((tile + m - 1) * d):
            c, p = divmod(i, d)
            if s0 + i < total:
                w[p * rs + (c % r) * sub + c // r] = v[s0 + i]
        hu = np.zeros(steps * d * r, np.float32)
        for i in range(steps * d * r):
            u, p = divmod(i // r, d)
            tap = (u - i % r) * d + p
            if u >= i % r and tap < t_len:
                hu[i] = taps[tap]
        # lane l, run j: outputs (j*nt + l)*R + q; its column at step u
        # is (j*nt + l)*R + u, at position j*nt + l + u // R
        runs = (np.arange(g)[:, None] * nt + lanes).reshape(-1)
        ar = np.zeros((r, g * nt), np.float32)
        ai = np.zeros((r, g * nt), np.float32)
        for u in range(steps):
            for p in range(d):
                x = w[p * rs + (u % r) * sub + u // r + runs]
                for q in range(r):
                    if 0 <= u * d + p - q * d < t_len:
                        h = hu[(u * d + p) * r + q]
                        ar[q] = _fma32(x.real, h, ar[q])
                        ai[q] = _fma32(x.imag, h, ai[q])
        for q in range(r):
            k = b * tile + runs * r + q
            ok = k < kout
            y[k[ok]] = (ar[q] + 1j * ai[q]).astype(np.complex64)[ok]
    return y


def _one_chain(v, taps, d, kout):
    """One output a thread: the chain over t = 0 .. T-1 of the kernel this
    design replaced, with the same emulated FMA."""
    idx = np.arange(kout) * d
    ar = np.zeros(kout, np.float32)
    ai = np.zeros(kout, np.float32)
    for t, h in enumerate(taps):
        ar = _fma32(v[idx + t].real, h, ar)
        ai = _fma32(v[idx + t].imag, h, ai)
    return (ar + 1j * ai).astype(np.complex64)


# (D, T, kout, tile, R, S): the WFM and D=50 shapes at small kout, T < D,
# T a multiple of D, each R and S, ragged last tiles
SCHEDULE_CASES = ((10, 79, 700, 128, 4, 1), (50, 81, 300, 64, 2, 1),
                  (50, 801, 200, 256, 4, 1), (50, 7, 100, 32, 1, 1),
                  (4, 243, 333, 128, 2, 2), (9, 99, 130, 256, 4, 2),
                  (10, 1023, 150, 64, 1, 2), (10, 79, 1000, 512, 4, 2))


@pytest.mark.parametrize("d,t,kout,tile,r,g", SCHEDULE_CASES)
def test_fir_decimate_schedule_equals_one_chain_bit_for_bit(d, t, kout,
                                                            tile, r, g):
    """The kernel's schedule gives every output the bits of the one-chain
    order, and matches float64."""
    tail, x, taps = _inputs(d, t, kout, seed=5)
    v = np.concatenate([tail, x])
    y = _k2_schedule(v, taps, d, kout, tile, r, g)
    assert np.array_equal(y.view(np.uint32),
                          _one_chain(v, taps, d, kout).view(np.uint32))
    assert _snr_db(_ref64(v, taps, d, kout), y) > 120
    assert fir_cuda.smem_bytes(t, d, tile, r) <= fir_cuda.MAX_SMEM


# --------------------------------------------------------------------------
# K5: the direct polyphase FIR
# --------------------------------------------------------------------------

# (D, T, kout): the BASELINE headline, NFM's and SSB/AM's front ends, m = 1
# (T <= D) and a ragged kout; each stream is exactly (kout-1)*D + T long
POLY_CASES = ((10, 1023, 1000), (50, 81, 960), (50, 801, 500), (10, 7, 333),
              (50, 49, 1001))


def _poly_inputs(d, t, kout, seed):
    rng = np.random.default_rng(seed)
    n = (kout - 1) * d + t
    v = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    return v, firdes.firdes_lowpass_f(t, 0.5 / d)


@pytest.mark.parametrize("d,t,kout", POLY_CASES)
def test_fir_poly_plain_matches_float64(d, t, kout):
    v, taps = _poly_inputs(d, t, kout, seed=t)
    ref = _ref64(v, taps, d, kout)
    y = fir_cuda.fir_decimate_poly(torch.from_numpy(v),
                                   torch.from_numpy(taps), d, kout).numpy()
    assert y.shape == (kout,) and _snr_db(ref, y) > 120


def _poly_chains(v, taps, d, kout):
    """The contract's order with the same emulated FMA: per phase p one
    chain from +0 over the M tap rows m = 0 .. M-1, then the D chains
    added in the order p = 0 .. D-1."""
    m_rows = -(-len(taps) // d)
    h = np.zeros(m_rows * d, np.float32)
    h[: len(taps)] = taps
    # the zero taps of the last row reach up to (kout + M - 1)*D samples
    v = np.concatenate([v, np.zeros(max(0, (kout + m_rows - 1) * d - len(v)),
                                    np.complex64)])
    y = np.zeros(kout, np.complex64)
    for p in range(d):
        ar = np.zeros(kout, np.float32)
        ai = np.zeros(kout, np.float32)
        for m in range(m_rows):
            x = v[(np.arange(kout) + m) * d + p]
            ar = _fma32(x.real, h[m * d + p], ar)
            ai = _fma32(x.imag, h[m * d + p], ai)
        y = y + (ar + 1j * ai).astype(np.complex64) if p else \
            (ar + 1j * ai).astype(np.complex64)
    return y


def _poly_layout(t, d, tile, r, g):
    """K5's block layout, read off the wrapper's shared-memory sum: the tap
    table's row stride, the window's sub-row and row stride, and the byte
    offset of the window (the sum less the window's D rows)."""
    m_rows = -(-t // d)
    sub = -(-(tile + m_rows - 1) // r)
    rs = (r * sub) | 1
    smem = fir_cuda.poly_smem_bytes(t, d, tile, r, g)
    return {"dp": (d + 3) & ~3 if g == 4 else d, "sub": sub, "rs": rs,
            "smem": smem, "window_at": smem - 8 * d * rs}


def _k5_schedule(v, taps, d, kout, tile, r, g):
    """K5's schedule in numpy, block by block, over one float32 buffer laid
    out as the block's shared memory and filled with NaN first (a word the
    kernel leaves unwritten may hold anything): the taps in exactly M rows
    of DP at the front, the phase-major window behind them (row p, sub-row
    c % R, position c / R, odd row stride, zero past the stream).  Each
    thread's R outputs walk the columns c = 0 .. M + R - 2 of G phases side
    by side, loading as the kernel does, unguarded: a window word and the
    tap of row c a column (4 aligned taps at G = 4), the phase past D of a
    last group included.  Output q takes tap row c - q where it lies in
    [0, M), and the chains of phases below D go into running sums from -0.
    A load past the buffer raises, a window load past its sub-row fails,
    and a product with an unwritten word turns its output NaN.  Returns
    complex64 outputs."""
    t_len = len(taps)
    m_rows = -(-t_len // d)
    nt = tile // r
    lay = _poly_layout(t_len, d, tile, r, g)
    dp, sub, rs, at = lay["dp"], lay["sub"], lay["rs"], lay["window_at"]
    assert at % 16 == 0 and 4 * m_rows * dp <= at < 4 * m_rows * dp + 16
    y = np.zeros(kout, np.complex64)
    lanes = np.arange(nt)
    for b in range(-(-kout // tile)):
        sm = np.full(lay["smem"] // 4, np.nan, np.float32)
        w = sm[at // 4:].view(np.complex64)
        assert len(w) == d * rs
        s0 = b * tile * d
        i = np.arange((tile + m_rows - 1) * d)
        c, p = np.divmod(i, d)
        w[p * rs + (c % r) * sub + c // r] = np.where(
            s0 + i < len(v), v[np.minimum(s0 + i, len(v) - 1)], 0)
        i = np.arange(m_rows * dp)
        m, p = np.divmod(i, dp)
        ok = (p < d) & (m * d + p < t_len)
        sm[i] = np.where(ok, taps[np.minimum(m * d + p, t_len - 1)], 0)
        sr = np.full((r, nt), -0.0, np.float32)
        si = np.full((r, nt), -0.0, np.float32)
        for p0 in range(0, d, g):
            for gi in range(g):
                p = min(p0 + gi, d - 1)
                ar = np.zeros((r, nt), np.float32)
                ai = np.zeros((r, nt), np.float32)
                h = {}
                for c0 in range(0, m_rows + r - 1, r):
                    pos = c0 // r + lanes
                    assert pos[-1] < sub
                    if g == 4:
                        assert (c0 * dp + p0) % 4 == 0
                    xs = [w[p * rs + cc * sub + pos] for cc in range(r)]
                    for cc in range(r):
                        h[c0 + cc] = sm[(c0 + cc) * dp + p0 + gi]
                    for cc in range(r):
                        for q in range(r):
                            if 0 <= c0 + cc - q < m_rows:
                                tap = h[c0 + cc - q]
                                ar[q] = _fma32(xs[cc].real, tap, ar[q])
                                ai[q] = _fma32(xs[cc].imag, tap, ai[q])
                if p0 + gi < d:
                    sr, si = sr + ar, si + ai
        for q in range(r):
            k = b * tile + lanes * r + q
            ok = k < kout
            y[k[ok]] = (sr[q] + 1j * si[q]).astype(np.complex64)[ok]
    return y


# (D, T, kout, tile, R, G): POLY_CASES under a planned launch, then other
# tiles, R and G at T a multiple of D, m = 1, ragged last tiles, and odd D
# with odd M (a tap table of an odd number of floats)
POLY_SCHEDULE_CASES = tuple(
    (d, t, kout) + (lambda p: (p["tile"], p["per_thread"], p["groups"]))(
        fir_cuda.poly_plan(t, d, kout, sms=4))
    for d, t, kout in POLY_CASES) + (
    (10, 1023, 300, 128, 4, 2), (25, 775, 100, 64, 8, 2),
    (10, 7, 90, 32, 4, 2), (4, 243, 333, 256, 8, 2), (9, 99, 130, 64, 1, 1),
    (50, 81, 200, 128, 8, 2), (3, 79, 200, 32, 4, 2), (1, 33, 150, 64, 8, 2),
    (5, 121, 90, 32, 1, 4))


@pytest.mark.parametrize("d,t,kout,tile,r,g", POLY_SCHEDULE_CASES)
def test_fir_poly_schedule_equals_contract_bit_for_bit(d, t, kout, tile, r,
                                                       g):
    """K5's schedule forms each output's products with the M tap rows only,
    in the contract's order: bit for bit the per-phase chains and the
    in-order phase sum, and > 120 dB against float64."""
    v, taps = _poly_inputs(d, t, kout, seed=t + 1)
    y = _k5_schedule(v, taps, d, kout, tile, r, g)
    assert np.array_equal(y.view(np.uint32),
                          _poly_chains(v, taps, d, kout).view(np.uint32))
    assert _snr_db(_ref64(v, taps, d, kout), y) > 120
    assert fir_cuda.poly_smem_bytes(t, d, tile, r, g) <= fir_cuda.MAX_SMEM


def test_fir_poly_schedule_reads_no_row_past_m():
    """A NaN in a column that only rows m >= M would reach (column kout+1
    of a stream padded for 8-row tiles) leaves every output finite."""
    d, t, kout = 50, 81, 40
    v, taps = _poly_inputs(d, t, kout, seed=3)
    v = np.concatenate([v, np.zeros((kout + 8) * d - len(v), np.complex64)])
    v[(kout + 1) * d] = np.nan
    for tile, r, g in ((32, 1, 4), (64, 4, 2), (40, 1, 1)):
        y = _k5_schedule(v, taps, d, kout, tile, r, g)
        assert np.all(np.isfinite(y))
        assert np.array_equal(y, _poly_chains(v, taps, d, kout))


def test_fir_poly_window_is_aligned_under_every_launch():
    """Under every launch K5 takes, at odd and even D and M, the window
    starts 16-byte aligned just past the tap table (its 8-byte copies,
    stores and loads fault on the card otherwise), and the block's bytes
    are the planner's."""
    for t in (1, 7, 33, 79, 81, 99, 121, 775, 801, 1023):
        for d in (1, 2, 3, 5, 9, 10, 25, 50, 101):
            m_rows = -(-t // d)
            for plan in fir_cuda.poly_plans(t, d, 1000):
                lay = _poly_layout(t, d, plan["tile"], plan["per_thread"],
                                   plan["groups"])
                table = 4 * m_rows * lay["dp"]
                assert lay["window_at"] % 16 == 0, (t, d, plan)
                assert table <= lay["window_at"] < table + 16, (t, d, plan)
                assert lay["smem"] == plan["smem"]


def _parent_poly_smem(t, d):
    """Shared memory of the smallest block (8 outputs) of the kernel with
    tap rows padded to a multiple of 8 that this design replaced."""
    mp = -(-(-(-t // d)) // 8) * 8
    return 4 * mp * d + 8 * (8 + mp) * d + 8 * d * 9


# (T, D, kout): the path shapes, kout = 1, kout = one planned tile + 1,
# m = 1, T a multiple of D
POLY_PLAN_CASES = ((1023, 10, 240_000), (1023, 10, 262_144),
                   (81, 50, 48_000), (7, 10, 240_000), (801, 50, 48_061),
                   (1023, 10, 1), (81, 50, 1), (7, 10, 1), (800, 50, 5000),
                   (50, 50, 77), (1, 1, 10))


@pytest.mark.parametrize("t,d,kout", POLY_PLAN_CASES)
def test_fir_poly_plan_covers_fits_and_fills(t, d, kout):
    plan = fir_cuda.poly_plan(t, d, kout)
    tile, r, nt = plan["tile"], plan["per_thread"], plan["threads"]
    assert (r, plan["groups"]) == fir_cuda.poly_rg(t, d) and tile == nt * r
    assert nt in fir_cuda.POLY_THREADS
    assert plan["blocks"] * tile >= kout > (plan["blocks"] - 1) * tile
    assert plan["smem"] == fir_cuda.poly_smem_bytes(
        t, d, tile, r, plan["groups"]) <= fir_cuda.MAX_SMEM
    assert plan["blocks_per_sm"] >= 1
    # a plan one tile larger is covered by one more block
    more = fir_cuda.poly_plan(t, d, tile + 1)
    assert more["blocks"] * more["tile"] >= tile + 1
    if kout >= 48_000:
        # the path shapes: every SM has a block, the last wave > 3/4 full
        assert plan["blocks"] >= fir_cuda.SMS
        fill = plan["blocks"] / (fir_cuda.waves(plan) * fir_cuda.SMS
                                 * plan["blocks_per_sm"])
        assert fill > 0.75


def test_fir_poly_plan_takes_every_shape_the_parent_took():
    """No (D, T) that the 8-row-padded kernel took is refused; at T=801 the
    largest D is where the smallest block, 8 outputs, no longer fits."""
    for d in (1, 2, 3, 10, 50, 100, 300, 900, 1001):
        for t in (1, 7, 81, 801, 1023, 4095, 19_000):
            if _parent_poly_smem(t, d) <= fir_cuda.MAX_SMEM:
                fir_cuda.poly_plan(t, d, 1000)
    largest = max(d for d in range(1, 5000)
                  if fir_cuda.poly_smem_bytes(801, d, 8, 1)
                  <= fir_cuda.MAX_SMEM)
    assert largest >= max(d for d in range(1, 5000)
                          if _parent_poly_smem(801, d) <= fir_cuda.MAX_SMEM)
    assert fir_cuda.poly_plan(801, largest, 100)["tile"] == 8
    for d in (largest + 1, 5000):
        with pytest.raises(ValueError, match="shared memory"):
            fir_cuda.poly_plan(801, d, 100)


def _poly_launch(xcat, taps, d, kout, plan):
    """K5 launched with ``plan`` (one of fir_cuda.poly_plans' dicts) in
    place of the planner's, straight through the built library."""
    y = torch.empty(kout, dtype=torch.complex64, device=xcat.device)
    code = _build.lib().csdr_fir_poly(
        xcat.data_ptr(), xcat.shape[0], taps.data_ptr(), taps.shape[0], d,
        kout, plan["tile"], plan["per_thread"], plan["groups"], y.data_ptr(),
        torch.cuda.current_stream(xcat.device).cuda_stream)
    _build.check(code, "fir_poly")
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("d,t,kout", POLY_CASES + (
    (10, 1023, 262_144), (10, 1023, 240_000), (50, 81, 48_000),
    (3, 79, 5000), (1, 33, 4000)))
def test_cuda_fir_poly_matches_plain(cuda, d, t, kout):
    """K5 against its plain version (>= 110 dB) and against float64; a
    stream with a carried tail in front through the dispatcher; and bit
    for bit under other launches (odd D with odd M among the shapes: a tap
    table of an odd number of floats in front of the window)."""
    v, taps = _poly_inputs(d, t, kout, seed=t)
    vx, tx = torch.from_numpy(v).to(cuda), torch.from_numpy(taps).to(cuda)
    n0 = fir_cuda.LAUNCHES["fir_poly"]
    yk = fir_cuda.fir_decimate_poly(vx, tx, d, kout)
    yp = fir_cuda.fir_decimate_poly_plain(vx, tx, d, kout)
    yd = fir_cuda.fir_decimate_poly_or_plain(vx, tx, d, kout)
    yd_seq = fir_cuda.fir_decimate_poly_or_plain(vx, taps, d, kout)
    torch.cuda.synchronize()
    assert _snr_db(yp.cpu().numpy(), yk.cpu().numpy()) > 110
    assert _snr_db(_ref64(v, taps, d, kout), yk.cpu().numpy()) > 110
    assert torch.equal(yk, yd) and torch.equal(yk, yd_seq)
    assert fir_cuda.LAUNCHES["fir_poly"] == n0 + 3
    chosen = fir_cuda.poly_plan(t, d, kout)
    others = [p for p in fir_cuda.poly_plans(t, d, kout)
              if p["threads"] in (8, 64, 512) and p != chosen]
    assert others
    for plan in others:
        assert torch.equal(_poly_launch(vx, tx, d, kout, plan), yk), plan


@pytest.mark.cuda
def test_cuda_fir_poly_reads_only_its_rows(cuda):
    """A NaN in a sample that only tap rows m >= M would reach (column
    kout+1 of a stream of (kout + 8)*D samples at D=50/T=81, M=2): every
    output stays finite and equals the plain version."""
    d, t, kout = 50, 81, 48_000
    v, taps = _poly_inputs(d, t, kout, seed=9)
    v = np.concatenate([v, np.zeros((kout + 8) * d - len(v), np.complex64)])
    v[(kout + 1) * d] = np.nan
    vx, tx = torch.from_numpy(v).to(cuda), torch.from_numpy(taps).to(cuda)
    yk = fir_cuda.fir_decimate_poly(vx, tx, d, kout)
    yp = fir_cuda.fir_decimate_poly_plain(vx, tx, d, kout)
    assert bool(torch.isfinite(yk).all()) and bool(torch.isfinite(yp).all())
    assert _snr_db(yp.cpu().numpy(), yk.cpu().numpy()) > 110


@pytest.mark.cuda
def test_cuda_fir_poly_raises_on_shapes_it_refuses(cuda):
    x = torch.zeros(400_000, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fir_cuda.fir_decimate_poly(x, torch.ones(8001, device=cuda), 2000, 3)
    with pytest.raises(ValueError, match="samples"):
        fir_cuda.fir_decimate_poly(x, torch.ones(81, device=cuda), 50, 8000)


# --------------------------------------------------------------------------
# K3: the kernel-order FFT pair
# --------------------------------------------------------------------------

def _frames(b, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n))
            + 1j * rng.standard_normal((b, n))).astype(np.complex64)


def _ko64(x):
    """float64 DFT of the frames, stored in kernel bin order:
    natural[k] == ko[kernel_perm[k]]."""
    nat = np.fft.fft(x.astype(np.complex128))
    ko = np.empty_like(nat)
    ko[:, fft_cuda.kernel_perm(x.shape[-1])] = nat
    return ko


@pytest.mark.parametrize("n", [128, 256, 1024, 4096])
def test_fft_ko_plain_matches_float64(n):
    x = _frames(5, n, seed=n)
    ko = _ko64(x)
    y = fft_cuda.fft_ko(torch.from_numpy(x)).numpy()
    assert _snr_db(ko, y) > 120
    back = fft_cuda.ifft_ko(torch.from_numpy(ko.astype(np.complex64)))
    assert _snr_db(x.astype(np.complex128) * n, back.numpy()) > 120
    # the kernel-order map on a single bin: bin k lands at perm[k]
    k = 3 if n > 128 else 5
    e = np.exp(2j * np.pi * k * np.arange(n) / n).astype(np.complex64)
    spec = fft_cuda.fft_ko(torch.from_numpy(e)[None]).numpy()[0]
    assert np.argmax(np.abs(spec)) == fft_cuda.kernel_perm(n)[k]


def test_fft_ko_shapes_refused():
    assert fft_cuda.supported(128, 1) and fft_cuda.supported(16384, 7)
    assert not fft_cuda.supported(64, 1)
    assert not fft_cuda.supported(32768, 1)
    assert not fft_cuda.supported(384, 1)
    with pytest.raises(ValueError, match="power of two"):
        fft_cuda.fft_ko(torch.zeros(2, 96, dtype=torch.complex64))
    with pytest.raises(TypeError, match="complex64"):
        fft_cuda.fft_ko(torch.zeros(2, 256))


_ROOTS16 = np.exp(-2j * np.pi * np.arange(16) / 16).astype(np.complex64)


def _dft_regs(v, inverse):
    """The kernel's R-point DFT over axis -2 of (..., R, S) complex64, as
    each thread runs it in registers: radix-2 decimation-in-frequency
    stages with 16th roots of unity, then the bit reversal undone."""
    r = v.shape[-2]
    v = v.copy()
    h = r // 2
    while h >= 1:
        for a in range(0, r, 2 * h):
            for i in range(h):
                p, q = v[..., a + i, :].copy(), v[..., a + i + h, :].copy()
                e = i * (8 // h)
                v[..., a + i, :] = p + q
                v[..., a + i + h, :] = (p - q) * _ROOTS16[-e % 16 if inverse
                                                          else e]
        h //= 2
    bits = r.bit_length() - 1
    return v[..., [fft_cuda._bitrev(k, bits) for k in range(r)], :]


def _k3_schedule(x, inverse=False):
    """csrc/fft_ko.cu's arithmetic in complex64 numpy, on the wrapper's own
    plan (fft_cuda.radix_plan) and twiddle table (fft_cuda.twiddles): pass
    i takes the DFT over digit i (stride S_i), its output k_i twiddled by
    W_N^(k_i * low * W_i) after the DFT (forward) or conjugated before it
    (inverse, passes in reverse order), read from the table at pass i's
    offset + (k_i - 1) * S_i + low, k_i left in place of digit i; the
    forward's last pass stores bin k at 128*bitrev_T(k mod T) + k/T and
    the inverse's first pass loads from there."""
    b, n = x.shape
    plan = fft_cuda.radix_plan(n)
    tw = fft_cuda.twiddles(n)
    if inverse:
        tw = np.conj(tw)
    logn, logt = n.bit_length() - 1, n.bit_length() - 8
    rb = [r.bit_length() - 1 for r in plan]
    before = [sum(rb[:i]) for i in range(len(plan))]
    sb = [logn - before[i] - rb[i] for i in range(len(plan))]
    p = np.arange(n)
    k = sum(((p >> sb[i]) & (plan[i] - 1)) << before[i]
            for i in range(len(plan)))
    pos = np.array([(fft_cuda._bitrev(int(kk) % (1 << logt), logt) << 7)
                    | (int(kk) >> logt) for kk in k])
    s = x[:, pos] if inverse else x
    order = range(len(plan))
    off = 0
    offsets = []
    for i in order:
        offsets.append(off)
        off += (plan[i] - 1) << sb[i]
    for i in (reversed(order) if inverse else order):
        r, stride = plan[i], 1 << sb[i]
        v = s.reshape(b, n // (r * stride), r, stride)
        twd = None
        if i < len(plan) - 1:
            rows = tw[offsets[i]: offsets[i] + (r - 1) * stride]
            twd = np.concatenate([np.ones((1, stride), np.complex64),
                                  rows.reshape(r - 1, stride)])
        if inverse and twd is not None:
            v = v * twd
        v = _dft_regs(v, inverse)
        if not inverse and twd is not None:
            v = v * twd
        s = v.reshape(b, n).astype(np.complex64)
    if inverse:
        return s
    out = np.empty_like(s)
    out[:, pos] = s
    return out


@pytest.mark.parametrize("n", [128, 256, 1024, 16384])
def test_fft_ko_schedule_matches_float64(n):
    """The CUDA kernel's plan, emulated in complex64, against float64 in
    kernel order, forward and inverse."""
    x = _frames(3, n, seed=n + 1)
    ko = _ko64(x)
    assert _snr_db(ko, _k3_schedule(x)) > 120
    back = _k3_schedule(ko.astype(np.complex64), inverse=True)
    assert back.dtype == np.complex64
    assert _snr_db(x.astype(np.complex128) * n, back) > 120


@pytest.mark.parametrize("n", [128, 256, 1024, 16384])
def test_fft_ko_twiddles_and_plan(n):
    """The twiddle table holds exp(-2*pi*i*k/N) to 1e-7, with k = j * low *
    W for each pass but the last, j = 1..R-1 and low < S; the plan has
    radices of at most 16, the last 16, in ceil(log2(N)/4) passes."""
    plan = fft_cuda.radix_plan(n)
    assert np.prod(plan) == n and plan[-1] == 16
    assert all(2 <= r <= 16 for r in plan)
    assert len(plan) == -(-(n.bit_length() - 1) // 4)
    k = []
    for i, r in enumerate(plan[:-1]):
        w = int(np.prod(plan[:i]))
        s = n // (w * r)
        k += [j * low * w for j in range(1, r) for low in range(s)]
    tw = fft_cuda.twiddles(n)
    assert tw.dtype == np.complex64 and tw.shape == (len(k),)
    assert np.max(np.abs(tw - np.exp(-2j * np.pi * np.array(k) / n))) < 1e-7


# --------------------------------------------------------------------------
# K4: the fastddc factored-v2 inverse
# --------------------------------------------------------------------------

def _inv_inputs(b, c, pre, inv, m, seed):
    rng = np.random.default_rng(seed)

    def cn(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)
    rot = np.exp(2j * np.pi * rng.random((c, b))).astype(np.complex64)
    return cn(b, pre * inv), cn(c, pre, inv), cn(inv, m), cn(c, m), rot


def _inv64(s, tq, w, d, rot):
    b, (c, pre, inv) = s.shape[0], tq.shape
    z = np.einsum("bjm,cjm->cbm", s.reshape(b, pre, inv).astype(complex),
                  tq.astype(complex))
    return (z @ w.astype(complex)) * d[:, None, :] * rot[:, :, None]


# (B, C, pre, inv, M): the 64-channel D=16 plan cut to size, D=4 (pre=2,
# M=224), D=256 (inv=16), and ragged frame/channel counts
INV_CASES = ((24, 8, 8, 128, 56), (9, 3, 2, 512, 224), (13, 5, 128, 16, 7))


@pytest.mark.parametrize("b,c,pre,inv,m", INV_CASES)
def test_fastddc_inv_plain_matches_float64(b, c, pre, inv, m):
    args = _inv_inputs(b, c, pre, inv, m, seed=b)
    ref = _inv64(*args)
    y = fastddc_cuda.fastddc_inv(*map(torch.from_numpy, args), m).numpy()
    assert y.shape == (c, b, m) and _snr_db(ref, y) > 120
    # fewer output columns than W has: the leading columns
    y2 = fastddc_cuda.fastddc_inv(*map(torch.from_numpy, args), m - 1)
    assert _snr_db(ref[..., : m - 1], y2.numpy()) > 120


def _tf32(x):
    """cvt.rna.tf32.f32: the f32 bit pattern rounded to 10 mantissa bits,
    to nearest with ties away from zero (sign and magnitude)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _f32_rz(x):
    """float64 to float32 rounded toward zero, as the tensor cores round
    the sums they accumulate."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _inv_3xtf32(s, tq, w, d, rot):
    """K4's arithmetic: the fold in f32, then the iDFT as csrc/fastddc_inv.cu
    runs it on the tensor cores: each f32 operand split as hi = tf32(x),
    lo = tf32(x - hi); for each 8-bin MMA step, fresh accumulators take the
    real products (Zr Wr, Zi (-Wi) into Yr; Zr Wi, Zi Wr into Yi), each as
    lo*hi, hi*lo, hi*hi, every MMA's sum rounded toward zero; then the step
    is added to the running f32 sums (rounded to nearest)."""
    b, (c, pre, inv) = s.shape[0], tq.shape
    m = w.shape[1]
    z = np.einsum("bjm,cjm->cbm", s.reshape(b, pre, inv), tq)
    z = z.astype(np.complex64).reshape(c * b, inv)

    def parts(x):
        hi = _tf32(x)
        return hi.astype(np.float64), _tf32(x - hi).astype(np.float64)

    zr, zi = parts(z.real), parts(z.imag)
    wr, wi = parts(w.real), parts(w.imag)
    wn = (-wi[0], -wi[1])
    yr = np.zeros((c * b, m), np.float32)
    yi = np.zeros((c * b, m), np.float32)
    for k in range(0, inv, 8):
        ks = slice(k, k + 8)
        pr, pi = np.zeros_like(yr), np.zeros_like(yi)
        for acc, (a, bb) in ((pr, (zr, wr)), (pr, (zi, wn)), (pi, (zr, wi)),
                             (pi, (zi, wr))):
            for x, y in ((a[1], bb[0]), (a[0], bb[1]), (a[0], bb[0])):
                acc[:] = _f32_rz(acc + x[:, ks] @ y[ks])
        yr, yi = yr + pr, yi + pi
    y = (yr + 1j * yi).astype(np.complex64).reshape(c, b, m)
    return (y * d[:, None, :]) * rot[:, :, None]


def test_tf32_rounding_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                 # TF32's at 1.0
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                  one + 3 * ulp / 2], np.float32)
    np.testing.assert_array_equal(
        _tf32(x), np.array([one + ulp, -(one + ulp), one, one + 2 * ulp],
                           np.float32))
    v = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi = _tf32(v)
    assert np.all(np.abs(v - hi) <= np.abs(v) * 2.0 ** -11)
    assert np.all(np.abs(v - hi - _tf32(v - hi)) <= np.abs(v) * 2.0 ** -22)


@pytest.mark.parametrize("b,c,pre,inv,m", INV_CASES)
def test_fastddc_inv_3xtf32_design_matches_float64(b, c, pre, inv, m):
    """The kernel's 3xTF32 product, emulated here, holds the plan's output
    to float64 at >= 120 dB (the card holds the kernel to the plain
    version at 110 dB)."""
    args = _inv_inputs(b, c, pre, inv, m, seed=b)
    assert _snr_db(_inv64(*args), _inv_3xtf32(*args)) >= 120


def _plan(d):
    from csdr_tpu_torch.ops.fastddc import fastddc_init
    ddc = fastddc_init(0.05, d)
    assert ddc.post_input_size % ddc.post_decimation == 0
    return (ddc.pre_decimation, ddc.fft_inv_size,
            ddc.post_input_size // ddc.post_decimation)


# D=4, 16 and 256, and the other divisible-post decimations csdr_tpu's
# fastddc tests run (1, 8, 64)
@pytest.mark.parametrize("d", [1, 4, 8, 16, 64, 256])
def test_fastddc_inv_plan_tiles_cover_and_fit(d):
    pre, inv, m = _plan(d)
    tiles = fastddc_cuda.plan_tiles(pre, inv, m)
    assert tiles["mt"] % 8 == 0 and tiles["mt"] // 8 in fastddc_cuda.NI_MENU
    assert tiles["mt"] * tiles["col_blocks"] >= m
    assert tiles["mt"] * (tiles["col_blocks"] - 1) < m
    assert tiles["kc"] <= inv and inv % tiles["kc"] == 0
    assert tiles["kc"] == min(inv, 32)
    assert pre % tiles["jc"] == 0
    assert tiles["smem"] == fastddc_cuda.smem_bytes(
        tiles["kc"], tiles["mt"], tiles["jc"]) <= fastddc_cuda.MAX_SMEM
    if m <= 56:                                  # all of M in one block
        assert tiles["col_blocks"] == 1 and tiles["mt"] - m < 8


def test_fastddc_inv_plan_tiles_choices_and_refusals():
    d256 = fastddc_cuda.plan_tiles(128, 16, 7)      # two blocks an SM
    assert d256["jc"] == 8 and d256["smem"] <= fastddc_cuda.HALF_SMEM
    assert fastddc_cuda.plan_tiles(2, 512, 224)["col_blocks"] == 4  # D=4
    with pytest.raises(ValueError, match="bin chunk"):
        fastddc_cuda.plan_tiles(256, 8, 7)
    with pytest.raises(ValueError, match="bin chunk"):
        fastddc_cuda.plan_tiles(4, 48, 20)


def test_fastddc_inv_checks_shapes():
    s, tq, w, d, rot = map(torch.from_numpy, _inv_inputs(4, 2, 8, 128, 56, 0))
    with pytest.raises(ValueError, match="shapes"):
        fastddc_cuda.fastddc_inv(s[:, :-1], tq, w, d, rot, 56)
    with pytest.raises(ValueError, match="m_out"):
        fastddc_cuda.fastddc_inv(s, tq, w, d, rot, 57)
    with pytest.raises(TypeError, match="complex64"):
        fastddc_cuda.fastddc_inv(s, tq, w.real.contiguous(), d, rot, 56)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(128, 9), (256, 270), (1024, 333),
                                 (2048, 5), (4096, 837), (16384, 3)])
def test_cuda_fft_ko_matches_plain(cuda, n, b):
    x = torch.from_numpy(_frames(b, n, seed=n)).to(cuda)
    n0 = dict(fft_cuda.LAUNCHES)
    yk = fft_cuda.fft_ko(x)
    yp = fft_cuda.fft_ko_plain(x)
    zk = fft_cuda.ifft_ko(yp)
    zp = fft_cuda.ifft_ko_plain(yp)
    torch.cuda.synchronize()
    assert _snr_db(yp.cpu().numpy(), yk.cpu().numpy()) > 110
    assert _snr_db(zp.cpu().numpy(), zk.cpu().numpy()) > 110
    assert _snr_db(_ko64(x.cpu().numpy()), yk.cpu().numpy()) > 110
    assert fft_cuda.LAUNCHES == {"fft_ko": n0["fft_ko"] + 1,
                                 "ifft_ko": n0["ifft_ko"] + 1,
                                 "fft_natural": n0["fft_natural"]}


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,pre,inv,m", INV_CASES + (
    (1024, 64, 8, 128, 56), (512, 256, 8, 128, 56)))
def test_cuda_fastddc_inv_matches_plain(cuda, b, c, pre, inv, m):
    args = [torch.from_numpy(a).to(cuda)
            for a in _inv_inputs(b, c, pre, inv, m, seed=b)]
    n0 = fastddc_cuda.LAUNCHES["fastddc_inv"]
    yk = fastddc_cuda.fastddc_inv(*args, m)
    yp = fastddc_cuda.fastddc_inv_plain(*args, m)
    torch.cuda.synchronize()
    assert _snr_db(yp.cpu().numpy(), yk.cpu().numpy()) > 110
    assert fastddc_cuda.LAUNCHES["fastddc_inv"] == n0 + 1


# --------------------------------------------------------------------------
# matrix products outside the kernels: full float32 whatever the caller set
# --------------------------------------------------------------------------

@pytest.fixture
def tf32_on():
    cuda = torch.backends.cuda.matmul
    prev = cuda.allow_tf32
    cuda.allow_tf32 = True
    yield
    cuda.allow_tf32 = prev


def test_full_f32_matmul_turns_tf32_off_and_restores(tf32_on):
    from csdr_tpu_torch.core.precision import full_f32_matmul
    cuda = torch.backends.cuda.matmul
    assert cuda.allow_tf32
    with full_f32_matmul():
        assert not cuda.allow_tf32
        with full_f32_matmul():                  # nested: stays off
            assert not cuda.allow_tf32
        assert not cuda.allow_tf32
    assert cuda.allow_tf32
    with pytest.raises(ZeroDivisionError):
        with full_f32_matmul():
            1 / 0
    assert cuda.allow_tf32


@pytest.mark.cuda
def test_cuda_fastddc_plain_ignores_global_tf32(cuda, tf32_on):
    """K4's plain version (einsum fold and cgemm) gives the same bits with
    TF32 switched on globally as with it off."""
    args = [torch.from_numpy(a).to(cuda)
            for a in _inv_inputs(256, 16, 8, 128, 56, seed=3)]
    y_on = fastddc_cuda.fastddc_inv_plain(*args, 56)
    torch.backends.cuda.matmul.allow_tf32 = False
    y_off = fastddc_cuda.fastddc_inv_plain(*args, 56)
    assert torch.equal(y_on, y_off)


@pytest.mark.cuda
def test_cuda_fastddc_inv_refuses_misaligned_spectra(cuda):
    s, tq, w, d, rot = [torch.from_numpy(a).to(cuda)
                        for a in _inv_inputs(4, 2, 8, 128, 56, 0)]
    flat = torch.cat([s.new_zeros(1), s.reshape(-1)])[1:].reshape(s.shape)
    with pytest.raises(ValueError, match="aligned"):
        fastddc_cuda.fastddc_inv(flat, tq, w, d, rot, 56)


@pytest.mark.cuda
def test_cuda_fastddc_kernel_ignores_global_tf32(cuda, tf32_on):
    """K4's 3xTF32 is the kernel's own arithmetic: the same bits with TF32
    switched on globally as with it off."""
    args = [torch.from_numpy(a).to(cuda)
            for a in _inv_inputs(256, 16, 8, 128, 56, seed=3)]
    y_on = fastddc_cuda.fastddc_inv(*args, 56)
    torch.backends.cuda.matmul.allow_tf32 = False
    y_off = fastddc_cuda.fastddc_inv(*args, 56)
    assert torch.equal(y_on, y_off)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 37])
@pytest.mark.parametrize("n", [1 << k for k in range(7, 15)])
def test_cuda_fft_natural_is_the_kernel_in_natural_order(cuda, n, b):
    """fft_natural: one launch of K3's natural-order forward and no
    kernel-order launch, bit for bit the kernel-order output gathered by
    kernel_perm, equal to cuFFT's natural order at the K3 bar; frames that
    are not contiguous are refused."""
    x = torch.from_numpy(_frames(b, n, seed=5)).to(cuda)
    n0 = dict(fft_cuda.LAUNCHES)
    y = fft_cuda.fft_natural(x)
    torch.cuda.synchronize()
    assert fft_cuda.LAUNCHES == dict(n0, fft_natural=n0["fft_natural"] + 1)
    assert torch.equal(y, fft_cuda.ko_to_natural(fft_cuda.fft_ko(x)))
    assert _snr_db(torch.fft.fft(x).cpu().numpy(), y.cpu().numpy()) > 110
    with pytest.raises(ValueError, match="contiguous"):
        fft_cuda.fft_natural(torch.cat([x, x], -1)[:, ::2])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 37])
def test_cuda_fft_natural_matches_csdr_tpu_golden(cuda, b):
    """The natural-order kernel at N=4096 against csdr_tpu's fft_natural
    (interpret mode, HIGHEST), read from tests/data/fft_natural_4096.npz
    (tests/torch_fft_golden.py: its frame, and frames made from it by maps
    whose effect on the spectrum is exact), every frame at the K3 bar."""
    x, y = golden.load()
    xb = torch.from_numpy(golden.frames(x, b)).to(cuda)
    n0 = dict(fft_cuda.LAUNCHES)
    got = fft_cuda.fft_natural(xb).cpu().numpy()
    assert fft_cuda.LAUNCHES == dict(n0, fft_natural=n0["fft_natural"] + 1)
    ref = golden.spectra(y, b)
    assert min(_snr_db(r, g) for r, g in zip(ref, got)) > 110


# --------------------------------------------------------------------------
# the IMA ADPCM codec (csrc/adpcm.cu): integer steps, bit for bit
# --------------------------------------------------------------------------

def _ima_encode_ref(samples, prev, index):
    """The IMA/DVI encoder (reference ima_adpcm.c:91-174) in Python ints;
    returns (nibbles, prev, index)."""
    out = []
    for s in samples:
        step = int(adpcm_cuda.STEP_SIZES[index])
        diff = int(s) - prev
        delta = 8 if diff < 0 else 0
        diff = abs(diff)
        if diff >= step:
            delta |= 4
            diff -= step
        if diff >= step >> 1:
            delta |= 2
            diff -= step >> 1
        if diff >= step >> 2:
            delta |= 1
        prev, index = _ima_decode_ref1(delta, prev, index)
        out.append(delta)
    return out, prev, index


def _ima_decode_ref1(delta, prev, index):
    step = int(adpcm_cuda.STEP_SIZES[index])
    diff = step >> 3
    if delta & 1:
        diff += step >> 2
    if delta & 2:
        diff += step >> 1
    if delta & 4:
        diff += step
    if delta & 8:
        diff = -diff
    prev = min(max(prev + diff, -32768), 32767)
    index = min(max(index + int(adpcm_cuda.INDEX_ADJUST[delta]), 0), 88)
    return prev, index


def _codec_rows(rows, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 8000, (rows, n)) * np.sin(np.arange(n) / 40.0)
    x[:, 10:20] = 32767
    x[:, 20:26] = -32768
    x[:, 30:40:2], x[:, 31:40:2] = 32767, -32768
    return np.clip(x, -32768, 32767).astype(np.int16)


CODEC_STATES = [[0, 0], [32767, 88], [-32768, 0], [1000, 45]]


def test_adpcm_plain_matches_the_integer_steps():
    x = _codec_rows(4, 300, 1)
    st = torch.tensor(CODEC_STATES, dtype=torch.int32)
    packed, ns = adpcm_cuda.encode(torch.from_numpy(x), st)
    dec, ds = adpcm_cuda.decode(packed, st)
    for k in range(4):
        nib, prev, index = _ima_encode_ref(x[k], *CODEC_STATES[k])
        want = [a | (b << 4) for a, b in zip(nib[0::2], nib[1::2])]
        assert packed[k].tolist() == want
        assert ns[k].tolist() == [prev, index] == ds[k].tolist()
        p, i, samples = CODEC_STATES[k][0], CODEC_STATES[k][1], []
        for d in nib:
            p, i = _ima_decode_ref1(d, p, i)
            samples.append(p)
        assert dec[k].tolist() == samples


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(4, 1000), (9, 4106), (1, 2048)])
def test_cuda_adpcm_matches_plain(cuda, rows, n):
    """Encode and decode, kernel against plain on the card, from edge
    states and with the state carried into a second chunk."""
    x = torch.from_numpy(_codec_rows(rows, 2 * n, rows)).to(cuda)
    st = torch.tensor([CODEC_STATES[k % 4] for k in range(rows)],
                      dtype=torch.int32, device=cuda)
    n0 = dict(adpcm_cuda.LAUNCHES)
    pk, sk = adpcm_cuda.encode(x[:, :n].contiguous(), st)
    pk2, sk2 = adpcm_cuda.encode(x[:, n:].contiguous(), sk)
    pp, sp = adpcm_cuda.encode_plain(x[:, :n], st)
    pp2, sp2 = adpcm_cuda.encode_plain(x[:, n:], sp)
    dk, tk = adpcm_cuda.decode(torch.cat([pk, pk2], 1), st)
    dp, tp = adpcm_cuda.decode_plain(torch.cat([pp, pp2], 1), st)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(pk2, pp2)
    assert torch.equal(sk, sp) and torch.equal(sk2, sp2)
    assert torch.equal(dk, dp) and torch.equal(tk, tp)
    assert adpcm_cuda.LAUNCHES == {"adpcm_encode": n0["adpcm_encode"] + 2,
                                   "adpcm_decode": n0["adpcm_decode"] + 1}


def test_adpcm_chain_probe_runs_on_the_card_only():
    """The probe that times the codec's bound chains takes no CPU device."""
    with pytest.raises(ValueError, match="CUDA"):
        adpcm_cuda.chain_cycles(0, 16, device="cpu")


@pytest.mark.cuda
def test_cuda_adpcm_chain_probe_times_its_chains(cuda):
    """Both probe chains take whole cycles a link, the same at two lengths
    within 5 %, and a five-level encoder step more than a two-op scan
    level; the probe launches no codec."""
    n0 = dict(adpcm_cuda.LAUNCHES)
    enc = [adpcm_cuda.chain_cycles(0, n) for n in (1 << 12, 1 << 16)]
    lvl = [adpcm_cuda.chain_cycles(1, n) for n in (1 << 12, 1 << 16)]
    for a, b in (enc, lvl):
        assert a > 1.0 and abs(a - b) < 0.05 * b
    assert enc[1] > lvl[1]
    assert adpcm_cuda.LAUNCHES == n0


@pytest.mark.cuda
def test_cuda_adpcm_takes_an_unaligned_view(cuda):
    """Samples at an odd int16 offset are copied to an aligned buffer."""
    x = torch.from_numpy(_codec_rows(1, 513, 3)).to(cuda)[:, 1:]
    st = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    assert x.data_ptr() % 4
    pk, _ = adpcm_cuda.encode(x, st)
    pp, _ = adpcm_cuda.encode_plain(x, st)
    assert torch.equal(pk, pp)


@pytest.mark.cuda
def test_cuda_adpcm_writes_only_its_output(cuda):
    """The C entry points write each row's bytes (or samples) and state
    into the middle of guarded buffers; the guards survive and the middle
    equals the wrapper's output."""
    lib, guard = _build.lib(), 4096
    rows, n = 9, 4106
    x = torch.from_numpy(_codec_rows(rows, n, 7)).to(cuda)
    st = torch.tensor([CODEC_STATES[k % 4] for k in range(rows)],
                      dtype=torch.int32, device=cuda)
    want, want_st = adpcm_cuda.encode(x, st)
    back, back_st = adpcm_cuda.decode(want, st)
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def guarded(dtype, count, sentinel):
        return torch.full((2 * guard + count,), sentinel, dtype=dtype,
                          device=cuda)

    for fn, src, out, out_st, dtype, sentinel in (
            (lib.csdr_adpcm_encode, x, want, want_st, torch.uint8, 0xA5),
            (lib.csdr_adpcm_decode, want, back, back_st, torch.int16, -12345)):
        buf = guarded(dtype, out.numel(), sentinel)
        sbuf = guarded(torch.int32, st.numel(), -7)
        code = fn(src.data_ptr(), buf[guard:].data_ptr(), st.data_ptr(),
                  sbuf[guard:].data_ptr(), rows, want.shape[1], stream)
        _build.check(code, "adpcm guarded")
        torch.cuda.synchronize()
        for b, body, s in ((buf, out, sentinel), (sbuf, out_st, -7)):
            k = body.numel()
            assert (b[:guard] == s).all() and (b[guard + k:] == s).all()
            assert torch.equal(b[guard:guard + k], body.reshape(-1))


@pytest.mark.cuda
def test_cuda_fma_chain_probe_matches_plain_bit_for_bit(cuda):
    """The FP32 probe: every output one fmaf chain, as its plain version's
    fma_f32 links; a ragged tail of elements past the last full group of
    chains; one launch counted."""
    x = torch.randn(65_536 * 8 + 13, device=cuda)
    n0 = probe_cuda.LAUNCHES["fma_chain"]
    for chain in (0, 1, 17, 300):
        yk = probe_cuda.fma_chain(x, chain)
        yp = probe_cuda.fma_chain_plain(x, chain)
        torch.cuda.synchronize()
        assert torch.equal(yk, yp), chain
    assert probe_cuda.LAUNCHES["fma_chain"] == n0 + 4


@pytest.mark.cuda
def test_cuda_time_kernel_of_k2_agrees_with_time_cuda(cuda):
    """time_kernel (a CUDA graph of k calls, each with its output summed)
    of K2 at path C's shape (D=50, T=801, a 2 403 000-sample chunk) within
    0.5-2x the CUDA events' time of the same calls."""
    from csdr_tpu_torch.utils.timing import time_cuda, time_kernel
    d, t, kout = 50, 801, 48_060
    tail, x, taps = _inputs(d, t, kout, seed=9)
    args = [torch.from_numpy(v).to(cuda) for v in (tail, x, taps)]

    def k2(v, h):
        return fir_cuda.fir_decimate(v[0], v[1], h, d, kout)

    ms = time_cuda(lambda: k2(args[:2], args[2]), iters=40,
                   queue_ahead_ms=20.0)
    for perturb in ("dus", "rotate"):
        tk = time_kernel(k2, tuple(args[:2]), aux=args[2],
                         k_pair=(64, 512), perturb=perturb) * 1e3
        assert 0.5 * ms <= tk <= 2.0 * ms, (perturb, tk, ms)


@pytest.mark.cuda
def test_cuda_wfm_step_has_no_cross_device_op(cuda):
    """The lint over one step of wfm_advanced on the card: every op on the
    card (host flags aside), no host sync, K1 launched once."""
    from csdr_tpu_torch.models import wfm
    from csdr_tpu_torch.utils import dispatch_lint
    pipe = wfm.wfm_advanced().to(cuda)
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal(240_000) + 1j * rng.
                          standard_normal(240_000)).astype(np.complex64))
    with torch.no_grad():
        trace, _ = dispatch_lint.trace_fn(pipe, pipe.init(cuda), x.to(cuda))
    found = dispatch_lint.findings_of(trace)
    assert not [f for f in found if f.kind in ("cross-device", "host-sync")]
    assert dict(trace.kernel_launches) == {"shift_fir_decimate": 1}


# the redesigned codec kernels: their schedules emulated in Python ints on
# the CPU (the encoder's packed entries, leaf table and stage ladder; the
# decoder's segments, 32-byte groups, compositions and tables), then the
# kernels on the card against both plain versions

_IMA_STEPS = [int(v) for v in adpcm_cuda.STEP_SIZES]


def _clampi(v, lo, hi):
    return min(max(v, lo), hi)


def _ima_adjust(n):
    return 2 * ((n & 3) + 1) if n & 4 else -1


def _wrap32(v):
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def _read_index(i):
    return _clampi(i + 89 if i < 0 else i, 0, 88)


def _signed_dq(step, n):
    dq = (step >> 3) + (step >> 2 if n & 1 else 0) \
        + (step >> 1 if n & 2 else 0) + (step if n & 4 else 0)
    return -dq if n & 8 else dq


def _enc_entry(j, m):
    return (_IMA_STEPS[j] << 16) | (m << 12) | (j << 5)


def _adpcm_encode_schedule(x, prev, index):
    """csrc/adpcm.cu's encoder on one row: e packs (step, m, index's row
    offset), NEXT[i][m] the leaves, three add-and-unsigned-min stages, the
    first step's clamp two-sided."""
    table = [_enc_entry(_clampi(k // 8 + _ima_adjust(k % 8), 0, 88), k % 8)
             for k in range(89 * 8)]
    e = _IMA_STEPS[_read_index(index)] << 16
    leaves = [_enc_entry(_clampi(_wrap32(index + _ima_adjust(m)), 0, 88), m)
              for m in range(8)]
    nibbles = []
    for k, sample in enumerate(int(v) for v in x):
        step, s1, s2, s3 = e >> 16, e >> 17, e >> 18, e >> 19
        d = sample - prev
        ad = abs(d)
        q2 = min((ad - step) % 2 ** 32, ad)
        q1 = min((q2 - s1) % 2 ** 32, q2)
        q0 = min((q1 - s2) % 2 ** 32, q1)
        up, down = sample + s3 - q0, sample - s3 + q0
        pos = _clampi(up, -32768, 32767) if k == 0 else min(up, 32767)
        neg = _clampi(down, -32768, 32767) if k == 0 else max(down, -32768)
        e = leaves[4 * (ad >= step) + 2 * (q2 >= s1) + (q1 >= s2)]
        prev = neg if d < 0 else pos
        row = (e & 0xfe0) // 4
        leaves = table[row:row + 8]
        nibbles.append(((e >> 12) & 7) | ((d >> 28) & 8))
    return nibbles, prev, (e & 0xfe0) >> 5


def _adpcm_decode_schedule(y, prev0, index0, out_offset):
    """csrc/adpcm.cu's decoder on one row whose output starts out_offset
    int16 past a 32-byte boundary: the launch's threads and segment, the
    first nibble from the carried state, each thread's segment composed
    (offsets clamped), the exclusive scans, the replays through DEC."""
    n_len = 2 * len(y)
    threads = _clampi((n_len // 16 + 31) // 32 * 32, 32, 1024)
    seg = ((n_len + 14 + threads - 1) // threads + 15) // 16 * 16
    a = out_offset & 15
    table = [_signed_dq(_IMA_STEPS[k >> 4], k & 15) * 8192
             | _clampi(k // 16 + _ima_adjust(k & 15), 0, 88) * 64
             for k in range(89 * 16)]

    def nib(k):
        return (int(y[k >> 1]) >> ((k & 1) * 4)) & 15

    n0 = nib(0)
    prev1 = _clampi(_wrap32(prev0 + _signed_dq(
        _IMA_STEPS[_read_index(index0)], n0)), -32768, 32767)
    index1 = _clampi(_wrap32(index0 + _ima_adjust(n0)), 0, 88)
    segs = [(1 if t == 0 else min(n_len, t * seg - a),
             min(n_len, (t + 1) * seg - a)) for t in range(threads)]
    assert [k for b, e in segs for k in range(b, e)] == list(range(1, n_len))
    assert all((b + a) % 16 == 0 for b, e in segs[1:] if b < e)

    def then(f, g, lim):
        return (_clampi(f[0] + g[0], -lim, lim),
                _clampi(f[1] + g[0], g[1], g[2]),
                _clampi(f[2] + g[0], g[1], g[2]))

    def apply(f, v):
        return _clampi(v + f[0], f[1], f[2])

    def starts(funcs, ident, lim, x0):
        pre, out = ident, []
        for f in funcs:
            out.append(apply(pre, x0))
            pre = then(pre, f, lim)
        return out

    funcs = []
    for b, e in segs:
        f = (0, 0, 88)
        for k in range(b, e):
            f = then(f, (_ima_adjust(nib(k)), 0, 88), 88)
        funcs.append(f)
    i_starts = [64 * i for i in starts(funcs, (0, 0, 88), 88, index1)]
    funcs = []
    for (b, e), i in zip(segs, i_starts):
        f = (0, -32768, 32767)
        for k in range(b, e):
            d = table[(i + 4 * nib(k)) // 4]
            i = d & 0x1fc0
            f = then(f, (d >> 13, -32768, 32767), 65535)
        funcs.append(f)
    p_starts = starts(funcs, (0, -32768, 32767), 65535, prev1)
    out, state = [prev1] + [None] * (n_len - 1), None
    for (b, e), i, p in zip(segs, i_starts, p_starts):
        for k in range(b, e):
            d = table[(i + 4 * nib(k)) // 4]
            p = _clampi(p + (d >> 13), -32768, 32767)
            i = d & 0x1fc0
            out[k] = p
        if b < e == n_len:
            state = [p, i // 64]
    return out, state


CODEC_SCHEDULE_STATES = [(0, 0), (32767, 88), (-32768, 0), (1000, -5),
                         (-3000, 100), (40000, 45), (-40000, -100)]


@pytest.mark.parametrize("n", [2, 30, 514, 4106])
def test_adpcm_encode_schedule_matches_plain(n):
    x = _codec_rows(len(CODEC_SCHEDULE_STATES), n, n)
    st = torch.tensor(CODEC_SCHEDULE_STATES, dtype=torch.int32)
    packed, ns = adpcm_cuda.encode_plain(torch.from_numpy(x), st)
    for k, (prev, index) in enumerate(CODEC_SCHEDULE_STATES):
        nib, p, i = _adpcm_encode_schedule(x[k], prev, index)
        assert packed[k].tolist() == [a | (b << 4) for a, b in
                                      zip(nib[0::2], nib[1::2])]
        assert ns[k].tolist() == [p, i]


@pytest.mark.parametrize("pairs,offset", [(1, 0), (7, 2), (257, 14),
                                          (2053, 6), (4106, 8)])
def test_adpcm_decode_schedule_matches_plain(pairs, offset):
    rng = np.random.default_rng(pairs)
    y = rng.integers(0, 256, (2, pairs), dtype=np.uint8)
    y[1, : pairs // 2] = 0x77
    states = [(1000, -5), (-40000, 100)]
    out, st = adpcm_cuda.decode_plain(
        torch.from_numpy(y), torch.tensor(states, dtype=torch.int32))
    for k, (prev, index) in enumerate(states):
        got, state = _adpcm_decode_schedule(y[k], prev, index, offset)
        assert out[k].tolist() == got and st[k].tolist() == state


@pytest.mark.cuda
@pytest.mark.parametrize("rows,pairs", [(1, 24_000), (9, 2053), (33, 1024)])
def test_cuda_adpcm_redesign_matches_both_plain_versions(cuda, rows, pairs):
    """The encoder (rows over two blocks at 33) and the decoder (one block
    a row) against the serial loops on their first 2048 samples and the
    kernels' torch models whole, from carried states in and out of
    range."""
    x = torch.from_numpy(_codec_rows(rows, 2 * pairs, rows)).to(cuda)
    st = torch.tensor([CODEC_SCHEDULE_STATES[k % 7] for k in range(rows)],
                      dtype=torch.int32, device=cuda)
    pk, sk = adpcm_cuda.encode(x, st)
    ps, ss = adpcm_cuda.encode_select_plain(x, st)
    head = x[:, :2048].contiguous()
    hk = adpcm_cuda.encode(head, st)
    hp = adpcm_cuda.encode_plain(head, st)
    dk, tk = adpcm_cuda.decode(pk, st)
    ds, ts = adpcm_cuda.decode_scan_plain(pk, st)
    gk = adpcm_cuda.decode(pk[:, :1024].contiguous(), st)
    gp = adpcm_cuda.decode_plain(pk[:, :1024], st)
    torch.cuda.synchronize()
    assert torch.equal(pk, ps) and torch.equal(sk, ss)
    assert torch.equal(hk[0], hp[0]) and torch.equal(hk[1], hp[1])
    assert torch.equal(dk, ds) and torch.equal(tk, ts)
    assert torch.equal(gk[0], gp[0]) and torch.equal(gk[1], gp[1])


@pytest.mark.cuda
def test_cuda_adpcm_decoder_scans_a_long_saturating_row(cuda):
    """2 400 000 nibbles in one block, runs of 0x7 and 0xF pinning prev at
    either rail and index at 88: against decode_scan_plain whole and the
    serial loop on the first 4096 nibbles."""
    y = torch.full((1, 1_200_000), 0x77, dtype=torch.uint8, device=cuda)
    y[0, 400_000:800_000] = 0xFF
    st = torch.tensor([[0, -5]], dtype=torch.int32, device=cuda)
    n0 = adpcm_cuda.LAUNCHES["adpcm_decode"]
    dk, tk = adpcm_cuda.decode(y, st)
    assert adpcm_cuda.LAUNCHES["adpcm_decode"] == n0 + 1
    ds, ts = adpcm_cuda.decode_scan_plain(y, st)
    hk = adpcm_cuda.decode(y[:, :2048].contiguous(), st)
    hp = adpcm_cuda.decode_plain(y[:, :2048], st)
    torch.cuda.synchronize()
    assert torch.equal(dk, ds) and torch.equal(tk, ts)
    assert tk[0].tolist() == [32767, 88]
    assert torch.equal(hk[0], hp[0]) and torch.equal(hk[1], hp[1])


# ---------------------------------------------------------------------------
# the timing recovery's symbol loop (csrc/ted.cu)
# ---------------------------------------------------------------------------

INT32_MAX = int(np.iinfo(np.int32).max)


def _ted_params(nsb, gardner=True, use_q=True):
    wing = nsb // 4
    offs = (3 * nsb // 2, nsb // 2, nsb) if gardner else (3 * wing, wing,
                                                         nsb // 2)
    return ted_cuda.TedParams(nsb, offs, gardner, use_q, 2.0, 0.5)


def _ted_case(rows, n, nsb, segs=1, warm=8, seed=0, nan_row=None):
    """A chunk of ``n`` samples a row behind a 4*nsb tail as the block
    buffers it: BPSK at nsb samples a symbol (random bits, a Hann pulse,
    a Q part, noise, the rows at different gains), each row's valid
    region from a random s0, a random carried corr; with ``segs`` > 1 the
    segmented mode's lanes as TimingRecoveryBlock._segmented lays them
    out.  Returns (planes, size, bitstart, corr, cap, span_hi, emit_lo) as
    CPU tensors."""
    rng = np.random.default_rng(seed)
    margin = 4 * nsb
    size = margin + n
    bits = rng.integers(0, 2, (rows, size // nsb + 2)) * 2.0 - 1.0
    pulse = np.hanning(nsb)
    base = np.stack([np.convolve(np.repeat(b, nsb), pulse, "same")[:size]
                     for b in bits])
    gain = rng.uniform(0.2, 3.0, (rows, 1))
    x = gain * (base + 0.2j * base) + 0.05 * (
        rng.standard_normal((rows, size))
        + 1j * rng.standard_normal((rows, size)))
    x = x.astype(np.complex64)
    if nan_row is not None:
        x[nan_row, size // 3] = np.nan
    planes = torch.view_as_real(torch.from_numpy(x)).reshape(rows, 2 * size)
    s0 = rng.integers(0, margin + 1, rows).astype(np.int32)
    corr0 = rng.integers(-nsb // 8, nsb // 8 + 1, rows).astype(np.int32)
    if segs == 1:
        return (planes, size, torch.from_numpy(s0), torch.from_numpy(corr0),
                (n + margin) // nsb + 2, None, None)
    span = (size - s0) // segs
    s_idx = np.arange(segs)
    emit_lo = (s0[:, None] + s_idx * span[:, None]).astype(np.int32)
    span_hi = np.where(s_idx == segs - 1, INT32_MAX,
                       emit_lo + span[:, None] + nsb).astype(np.int32)
    bs0 = np.maximum(emit_lo - warm * nsb, s0[:, None]).astype(np.int32)
    corr = np.where(s_idx == 0, corr0[:, None], 0).astype(np.int32)
    return (planes, size, torch.from_numpy(bs0), torch.from_numpy(corr),
            (n + margin) // (segs * nsb) + warm + 4,
            torch.from_numpy(span_hi), torch.from_numpy(emit_lo))


def _f32_fma(a, b, c):
    """fmaf: a*b + c rounded once to float32 (exact rationals, nearest,
    ties to even)."""
    from fractions import Fraction
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    cands = [near, np.nextafter(near, np.float32(np.inf)),
             np.nextafter(near, np.float32(-np.inf))]
    dist = [abs(Fraction(float(v)) - exact) for v in cands]
    best = min(dist)
    ties = [v for v, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda v: int(np.float32(v).view(np.uint32)) & 1)


def _ted_lane(row, size, bs, corr, cap, hi, lo, p):
    """One lane as csrc/ted.cu's thread runs it, in numpy float32 scalars:
    the reset compared in float32, the picks, the error (an exact fmaf),
    the clamp, the gain left to right, the truncation."""
    f32 = np.float32
    reset = f32(0.9 * p.nsqb)
    gain, lg, me = f32(p.nshb * p.err_sign), f32(p.loop_gain), \
        f32(p.max_error)
    alive, out = True, []
    for _ in range(cap):
        alive = alive and bs + 3 * p.nshb < size and bs < hi
        if f32(corr) <= -reset or f32(corr) >= reset:
            corr = 0
        g = [bs + p.offs[0], bs + p.offs[1] - (0 if p.gardner else corr),
             bs + p.offs[2]]
        v = [row[min(max(i, 0), size - 1)] for i in g]
        dre = f32(v[0].real) - f32(v[1].real)
        if p.use_q:
            dim = f32(v[0].imag) - f32(v[1].imag)
            err = _f32_fma(dre, f32(v[2].real), dim * f32(v[2].imag)) \
                * f32(0.5)
        else:
            err = dre * f32(v[2].real)
        e = min(max(err, -me), me)
        new = int(np.trunc(gain * e * lg))
        out.append((v, err, bs, alive and bs >= lo))
        if alive:
            bs, corr = bs + p.nsb + new, new
    return bs, corr, out


@pytest.mark.parametrize("gardner,use_q,segs", [
    (True, True, 1), (False, False, 1), (True, True, 3), (False, True, 3)])
def test_ted_lane_schedule_equals_plain_bit_for_bit(gardner, use_q, segs):
    """The kernel's per-lane arithmetic (``_ted_lane``) against the plain
    loop ``ted_cuda.scan`` runs on the CPU: every pick, raw error, start,
    emit and the final state, serial and segmented, both algorithms."""
    planes, size, bs, corr, cap, hi, lo = _ted_case(2, 640, 16, segs,
                                                    warm=4, seed=3)
    p = _ted_params(16, gardner, use_q)
    n0 = dict(ted_cuda.LAUNCHES)
    got = ted_cuda.scan(planes, size, bs, corr, cap, hi, lo, params=p)
    assert ted_cuda.LAUNCHES == n0        # the CPU runs the plain loop
    x = torch.view_as_complex(planes.reshape(2, size, 2)).numpy()
    flat = [t.reshape(-1) if t is not None else None
            for t in (bs, corr, hi, lo)]
    lanes = flat[0].numel()
    v = got[2].reshape(lanes, cap, 3, 2)
    err, start, emit = (t.reshape(lanes, cap) for t in got[3:])
    for k in range(lanes):
        b_k, c_k, out = _ted_lane(
            x[k // segs], size, int(flat[0][k]), int(flat[1][k]), cap,
            INT32_MAX if hi is None else int(flat[2][k]),
            -INT32_MAX - 1 if lo is None else int(flat[3][k]), p)
        assert (b_k, c_k) == (int(got[0].reshape(-1)[k]),
                              int(got[1].reshape(-1)[k])), k
        for j, (vv, e, s, m) in enumerate(out):
            want = np.array([[a.real, a.imag] for a in vv], np.float32)
            assert np.array_equal(v[k, j].numpy(), want), (k, j)
            assert np.float32(err[k, j]).view(np.uint32) == np.float32(
                e).view(np.uint32), (k, j)
            assert int(start[k, j]) == s and bool(emit[k, j]) == m, (k, j)


def _ted_picks(size, bs0, corr0, starts, final_bs, hi, cap, p):
    """A lane's picks at every slot, clamped, rebuilt from scan_plain's
    recorded starts: alive as the kernel tracks it, the correction a slot
    gave from the step that followed it (nsb + new_corr), reset before
    the picks.  Returns (picks (cap, 3), the final corr)."""
    reset = np.float32(0.9 * p.nsqb)
    nxt = list(starts[1:]) + [final_bs]
    alive, corr, picks = True, int(corr0), []
    for k in range(cap):
        b = int(starts[k])
        alive = alive and b + 3 * p.nshb < size and b < hi
        if np.float32(corr) <= -reset or np.float32(corr) >= reset:
            corr = 0
        g = [b + p.offs[0], b + p.offs[1] - (0 if p.gardner else corr),
             b + p.offs[2]]
        picks.append([min(max(i, 0), size - 1) for i in g])
        if alive:
            corr = int(nxt[k]) - b - p.nsb
    return np.array(picks, np.int64), corr


def _ring_model(row, size, picks, starts, plan, bs0, eager,
                publish="envelope"):
    """csrc/ted.cu's ring for one lane in numpy: the copies load tiles in
    order into ring slot t mod tiles, each only once the chain's published
    lowest tile leaves room; ``eager`` copies as far ahead as the room
    allows before each slot (the most a copy can overwrite), else only up
    to the tile the chain waits for (the least it can have).  At each slot
    whose window first reaches a tile the chain publishes the lowest tile
    it may still read, the tile of its envelope clamp(bitstart + lo_off)
    (``publish="picks"``: of its window's lowest pick), and waits for the
    window's highest; every slot reads its picks at ring[i & mask].
    Returns the values read, and the slots that broke the plan: a pick
    below a tile published before, a bitstart below the last
    publication's (the kernel's test), or a window reaching past the
    ring's tiles above the published one."""
    tile, tiles = plan.tile, plan.tiles
    mask = tiles * tile - 1
    ring = np.full(tiles * tile, np.nan + 1j * np.nan, np.complex64)
    held = np.full(tiles, -1)
    last = size - 1
    t_first = min(max(bs0 + plan.lo_off, 0), last) // tile
    t_last = last // tile
    loaded, need, got, broke = t_first - 1, t_first, [], []
    have, b_pub = t_first - 1, bs0

    def load_through(t):
        nonlocal loaded
        while loaded < min(t, t_last) and loaded + 1 < need + tiles:
            loaded += 1
            s0 = loaded * tile
            ring[(loaded % tiles) * tile:][:min(tile, size - s0)] = \
                row[s0:s0 + tile]
            held[loaded % tiles] = loaded
    for k in range(len(picks)):
        t_lo, t_hi = picks[k].min() // tile, picks[k].max() // tile
        if t_lo < need or int(starts[k]) < b_pub:
            broke.append(k)
        if t_hi > have:
            env = (t_lo if publish == "picks" else
                   min(max(int(starts[k]) + plan.lo_off, 0), last) // tile)
            if t_hi - env >= tiles:
                broke.append(k)
            need, have, b_pub = max(need, env), t_hi, int(starts[k])
        load_through(t_last if eager else t_hi)
        assert held[t_hi % tiles] == t_hi or k in broke, (k, t_hi, held)
        got.append(ring[picks[k] & mask])
    return np.array(got), broke


def _ring_lanes(planes, size, bs, corr, cap, hi, p):
    """Each lane's (row, start, picks, final corr) from one scan_plain run,
    with scan_plain's outputs."""
    out = ted_cuda.scan_plain(planes, size, bs, corr, cap, hi, None if hi
                              is None else hi * 0 - INT32_MAX - 1, params=p)
    x = torch.view_as_complex(planes.reshape(-1, size, 2)).numpy()
    flat = [t.reshape(-1) for t in (bs, corr)]
    segs = bs.numel() // planes.shape[0]
    lanes = []
    for k in range(bs.numel()):
        starts = out[4].reshape(-1, cap)[k].numpy()
        h = INT32_MAX if hi is None else int(hi.reshape(-1)[k])
        picks, c = _ted_picks(size, int(flat[0][k]), int(flat[1][k]), starts,
                              int(out[0].reshape(-1)[k]), h, cap, p)
        assert c == int(out[1].reshape(-1)[k])
        lanes.append((x[k // segs], int(flat[0][k]), picks,
                      out[2].reshape(-1, cap, 3, 2)[k].numpy(), starts))
    return lanes


# (name, rows, n, nsb, segs, gardner, use_q, start override[, loop
# gain]): G's parameters at G's row length, the segmented mode,
# early-late, early-late at loop gain 1 with max error 2 (timing_recovery_
# cc EARLYLATE 64's correction up to a symbol: the left pick may land below
# the slot before's), a lane starting before the row (its picks clamped
# to 0) and lanes starting at the row's end (dead at once, picks clamped
# to size - 1)
RING_CASES = (
    ("G", 3, 57_344, 256, 1, True, True, None),
    ("G segmented", 2, 57_344, 256, 4, True, True, None),
    ("early-late", 3, 8_192, 64, 1, False, False, None),
    ("early-late segmented", 2, 8_192, 64, 3, False, True, None),
    ("early-late loop gain 1", 3, 8_192, 64, 3, False, False, None, 1.0),
    ("row start", 2, 4_096, 64, 1, True, True, (-300, -1)),
    ("row end", 2, 4_096, 64, 1, False, True, (4_096 + 200, 4_096 + 255)),
)


@pytest.mark.parametrize("case", RING_CASES, ids=[c[0] for c in RING_CASES])
def test_ted_ring_holds_every_pick_when_it_is_read(case):
    """ring_plan's layout at each case's parameters, run in the numpy ring
    model over scan_plain's recorded starts and corrections, with the
    copies as far ahead as they may go and as far behind: every pick is
    in the ring when the chain reads it (the values scan_plain recorded),
    no window spans more tiles than the ring or reaches below the copies'
    first tile, and the route is the ring.  Every pick lies in its slot's
    envelope [bitstart + lo_off, bitstart + hi_off] (clamped), whose low
    end never decreases: the tile the kernel publishes."""
    _, rows, n, nsb, segs, gardner, use_q, start, *gain = case
    p = _ted_params(nsb, gardner, use_q)
    if gain:
        p = p._replace(loop_gain=gain[0])
    planes, size, bs, corr, cap, hi, lo = _ted_case(rows, n, nsb, segs,
                                                    seed=11)
    if start is not None:
        bs = torch.tensor(start, dtype=torch.int32)
    plan = ted_cuda.ring_plan(size, p)
    assert plan.route == "ring" and plan.trail == 0
    assert plan.lead >= 2 * plan.tile and plan.tile >= nsb + nsb // 2
    assert plan.tiles * plan.tile * 8 <= ted_cuda.RING_MAX_BYTES
    for row, b0, picks, v, st in _ring_lanes(planes, size, bs, corr, cap,
                                             hi, p):
        env = np.clip(st.astype(np.int64)[:, None]
                      + [plan.lo_off, plan.hi_off], 0, size - 1)
        assert np.all(picks >= env[:, :1]) and np.all(picks <= env[:, 1:])
        assert np.all(np.diff(env[:, 0]) >= 0)
        for eager in (True, False):
            got, broke = _ring_model(row, size, picks, st, plan, b0, eager)
            assert broke == []
            assert np.array_equal(got, row[picks])
            assert np.array_equal(got.view(np.float32).reshape(v.shape), v)


def test_ted_ring_publishes_the_envelope_not_the_picks():
    """timing_recovery_cc EARLYLATE 64 at loop gain 1, max error 2: |corr|
    up to 64 = nsb, the ring's route.  A correction of -12 carried into a
    slot (its left pick 12 above bitstart + wing) and one of -63 out of it
    (the next slot one sample on, its corr reset to 0) put the next left
    pick 11 samples below the slot's.  Placed across a tile's edge, a ring
    whose copies may overwrite the tiles below the picks' own lowest loses
    that pick; publishing the envelope's lowest tile, as the kernel does,
    keeps it."""
    p = _ted_params(64, False, False)._replace(loop_gain=1.0)
    size, k = 16_384, 31
    plan = ted_cuda.ring_plan(size, p)
    assert plan.route == "ring" and ted_cuda.max_correction(p) == 64
    steps = [64] * (k - 1) + [64 - 12, 64 - 63] + [64] * 150
    starts = np.cumsum([2025 - 52 - 64 * (k - 1)] + steps)
    assert starts[k] == 2025
    cap = len(starts) - 1
    picks, _ = _ted_picks(size, int(starts[0]), 0, starts[:-1], starts[-1],
                          INT32_MAX, cap, p)
    assert picks[k].min() == 2053 and picks[k + 1].min() == 2042
    rng = np.random.default_rng(5)
    row = (rng.standard_normal(size)
           + 1j * rng.standard_normal(size)).astype(np.complex64)
    got, broke = _ring_model(row, size, picks, starts, plan, int(starts[0]),
                             True, publish="picks")
    assert k + 1 in broke and not np.array_equal(got[k + 1],
                                                 row[picks[k + 1]])
    for eager in (True, False):
        got, broke = _ring_model(row, size, picks, starts, plan,
                                 int(starts[0]), eager)
        assert broke == [] and np.array_equal(got, row[picks])


def test_ted_backward_stepping_parameters_take_the_l2_route():
    """A CLI parameter set whose correction exceeds a symbol (timing_
    recovery_cc GARDNER 16 4 2: |corr| up to 64 > 16) steps bitstart back
    on real data, so ring_plan routes it to the L2 design from the
    parameters alone; a ring laid out for it anyway loses picks in the
    model.  Its non-finite and oversized relatives take the same route."""
    p = ted_cuda.TedParams(16, (24, 8, 16), True, True, 2.0, 4.0)
    planes, size, bs, corr, cap, hi, _ = _ted_case(4, 4_096, 16, seed=12)
    plan = ted_cuda.ring_plan(size, p)
    assert plan.route == "l2" and "step back" in plan.why
    assert ted_cuda.max_correction(p) == 64
    lanes = _ring_lanes(planes, size, bs, corr, cap, hi, p)
    assert any(np.any(np.diff(st.astype(np.int64)) < 0)
               for *_, st in lanes)
    forced = plan._replace(route="ring", tile=64, tiles=4,
                           lead=128)
    assert any(_ring_model(row, size, picks, st, forced, b0, True)[1]
               for row, b0, picks, _, st in lanes)
    inf = p._replace(max_error=float("inf"))
    assert ted_cuda.ring_plan(size, inf).route == "l2"
    assert ted_cuda.max_correction(p._replace(loop_gain=1e30)) is None
    wide = ted_cuda.TedParams(8192, (12288, 4096, 8192), True, True, 2.0,
                              0.5)
    assert ted_cuda.ring_plan(1 << 20, wide).route == "l2"


def test_ted_scan_checks_its_arguments():
    planes, size, bs, corr, cap, hi, lo = _ted_case(2, 256, 16, 2)
    p = _ted_params(16)
    with pytest.raises(TypeError, match="int32"):
        ted_cuda.scan(planes, size, bs.long(), corr, cap, hi, lo, params=p)
    with pytest.raises(TypeError, match="planes"):
        ted_cuda.scan(planes.double(), size, bs, corr, cap, hi, lo, params=p)
    with pytest.raises(TypeError, match="go together"):
        ted_cuda.scan(planes, size, bs, corr, cap, hi, None, params=p)
    with pytest.raises(TypeError, match="rows"):
        ted_cuda.scan(planes[:1], size, bs, corr, cap, hi, lo, params=p)


def test_ted_chain_probe_runs_on_the_card_only():
    with pytest.raises(ValueError, match="CUDA"):
        ted_cuda.chain_cycles(16, device="cpu")


# G's shape (64 rows of 58 368 samples, sps 256: 230 slots), a segmented
# shape (64 x 4 lanes), a small segmented shape, early-late with the error
# from I alone, a NaN, early-late at loop gain 1 (corrections up to a
# symbol, the ring), and a backward-stepping loop gain (the L2 route)
TED_CUDA_CASES = (
    dict(rows=64, n=57_344, nsb=256, segs=1, gardner=True, use_q=True),
    dict(rows=64, n=57_344, nsb=256, segs=4, gardner=True, use_q=True),
    dict(rows=4, n=4_096, nsb=64, segs=3, gardner=True, use_q=True),
    dict(rows=16, n=8_192, nsb=64, segs=1, gardner=False, use_q=False),
    dict(rows=16, n=8_192, nsb=64, segs=3, gardner=False, use_q=True,
         nan_row=5),
    dict(rows=16, n=8_192, nsb=64, segs=3, gardner=False, use_q=False,
         loop_gain=1.0),
    dict(rows=16, n=8_192, nsb=64, segs=1, gardner=True, use_q=True,
         loop_gain=4.0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", TED_CUDA_CASES)
def test_cuda_ted_scan_matches_plain(cuda, case):
    """ted_cuda.scan (one launch, of the ring or of the L2 route as
    ring_plan picks) against scan_plain on the card, bit for bit: the
    final state and every slot's picks, raw error, start and emit."""
    case = dict(case)
    p = _ted_params(case.pop("nsb"), case.pop("gardner"), case.pop("use_q"))
    p = p._replace(loop_gain=case.get("loop_gain", p.loop_gain))
    planes, size, bs, corr, cap, hi, lo = (
        t.to(cuda) if isinstance(t, torch.Tensor) else t
        for t in _ted_case(case["rows"], case["n"], p.nsb, case["segs"],
                           nan_row=case.get("nan_row")))
    key = ("ted_scan" if ted_cuda.ring_plan(size, p).route == "ring"
           else "ted_scan_l2")
    assert (key == "ted_scan_l2") == (p.loop_gain > 1.0)
    n0 = dict(ted_cuda.LAUNCHES)
    got = ted_cuda.scan(planes, size, bs, corr, cap, hi, lo, params=p)
    assert ted_cuda.LAUNCHES == dict(n0, **{key: n0[key] + 1})
    want = ted_cuda.scan_plain(planes, size, bs, corr, cap, hi, lo,
                               params=p)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    assert bool(got[5].any())


@pytest.mark.cuda
def test_cuda_ted_block_step_is_one_launch(cuda):
    """The bank's TED block on the card: one launch a call, the CPU's
    symbols and state bit for bit."""
    from csdr_tpu_torch.ops import sync
    tr = sync.timing_recovery_block("GARDNER", 64, use_q=True)
    planes, size, *_ = _ted_case(8, 4096, 64, seed=9)
    x = torch.view_as_complex(planes.reshape(8, size, 2))[:, 256:]
    x = x.contiguous()
    n0 = ted_cuda.LAUNCHES["ted_scan"]
    sk, yk = tr(tr.init(cuda, channels=8), x.to(cuda))
    assert ted_cuda.LAUNCHES["ted_scan"] == n0 + 1
    sc, yc = tr(tr.init("cpu", channels=8), x)
    assert torch.equal(yk.count.cpu(), yc.count)
    assert torch.equal(yk.data.cpu(), yc.data)
    for a, b in zip(sk, sc):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_ted_chain_probe_times_its_chain(cuda):
    """The probe's slot chain takes the same cycles a slot at two lengths
    within 5 %, more than a shared-memory load alone (~30 cycles); no TED
    launch counted."""
    n0 = dict(ted_cuda.LAUNCHES)
    a, b = (ted_cuda.chain_cycles(n) for n in (1 << 12, 1 << 14))
    assert a > 30.0 and abs(a - b) < 0.05 * b
    assert ted_cuda.LAUNCHES == n0


# ---------------------------------------------------------------------------
# the chunked AGC's relaxation (csrc/agc.cu)
# ---------------------------------------------------------------------------

def _agc_cases():
    """tests/test_torch_agc_kernel.py's cases and its numpy model of the
    kernel's control flow (that file imports no jax)."""
    import test_torch_agc_kernel as m
    return m.CASES, m.agc_model, m.speech_like


def _same_bits(a, b):
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["agc_signal_start", "speech_continuing",
                                  "zero_run_max_gain_100", "n0", "n1",
                                  "n8192", "n8193", "chunk256"])
def test_cuda_agc_relax_matches_plain_and_the_model(cuda, name):
    """agc_cuda.relax (one launch) against relax_plain on the card, bit for
    bit (y, gain, hang, converged), and its rounds against the numpy model
    of its control flow, row by row and round by round."""
    cases, model, _ = _agc_cases()
    make, kw = cases[name]
    x = torch.from_numpy(make()).to(cuda)
    n0 = agc_cuda.LAUNCHES["agc_relax"]
    *got, table = agc_cuda.relax(x, rounds=True, **kw)
    assert agc_cuda.LAUNCHES["agc_relax"] == n0 + (len(x) > 0)
    want = agc_cuda.relax_plain(x, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _same_bits(a, b.to(a.device)), name
    assert got[1].device == x.device == got[2].device
    assert np.array_equal(table.cpu().numpy(), model(make(), **kw)[4])


def _rows_for_each_size(chunk, most_rows):
    """For each (cluster size, spread) agc_cuda.plan gives at ``chunk`` up
    to ``most_rows`` rows, the fewest rows that get it."""
    seen = {}
    for rows in range(1, most_rows + 1):
        p = agc_cuda.plan(rows * chunk, chunk)
        seen.setdefault((p["size"], p["spread"]), rows)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("most", [8, 16])
def test_cuda_agc_relax_at_every_cluster_size_the_rule_picks(cuda, most,
                                                             monkeypatch):
    """Speech over the fewest rows that get each cluster size and layout
    the rule picks up to 2 rows past the resident clusters (K = 8 or 16
    down to 4 at chunk 8192, rows in turns at the end): bit for bit
    relax_plain, one launch, the rounds the model's."""
    monkeypatch.setattr(agc_cuda, "CLUSTER_MAX", most)
    _, model, speech_like = _agc_cases()
    resident = agc_cuda.resident_rows(8192)
    sizes = _rows_for_each_size(8192, resident + 2)
    assert {k for k, _ in sizes} == set(agc_cuda.cluster_sizes(8192))
    kw = {"started": True, "last_gain": 2.0, "last_hang": 20}
    for (k, spread), rows in sorted(sizes.items()):
        x = speech_like(rows * 8192 - 100, 5)
        a = torch.from_numpy(x).to(cuda)
        n0 = agc_cuda.LAUNCHES["agc_relax"]
        *got, table = agc_cuda.relax(a, rounds=True, **kw)
        assert agc_cuda.LAUNCHES["agc_relax"] == n0 + 1
        want = agc_cuda.relax_plain(a, **kw)
        for g, w in zip(got, want):
            assert _same_bits(g, w), (k, spread, rows)
        if rows <= 8:
            assert np.array_equal(table.cpu().numpy(), model(x, **kw)[4])


@pytest.mark.cuda
def test_cuda_agc_relax_past_the_resident_rows(cuda):
    """More rows than clusters fit on the card: each cluster runs its rows
    in turns, bit for bit relax_plain; at chunk 2048 the rule takes one
    CTA a row (K = 1), at 8192 four."""
    _, _, speech_like = _agc_cases()
    kw = {"started": True, "last_gain": 2.0, "last_hang": 20}
    for chunk, k in ((2048, 1), (8192, 4)):
        rows = agc_cuda.resident_rows(chunk) + 2
        p = agc_cuda.plan(rows * chunk, chunk)
        assert (p["size"], p["spread"]) == (k, False)
        assert p["ctas"] < rows * k
        x = torch.from_numpy(speech_like(rows * chunk - 100, 5)).to(cuda)
        got = agc_cuda.relax(x, chunk=chunk, **kw)
        want = agc_cuda.relax_plain(x, chunk=chunk, **kw)
        for a, b in zip(got, want):
            assert _same_bits(a, b), chunk


@pytest.mark.cuda
def test_cuda_agc_relax_spreads_a_few_rows_over_the_sms(cuda):
    """E's shape, 6 rows of 8192: clusters of 16 CTAs, one CTA an SM."""
    _, _, speech_like = _agc_cases()
    x = torch.from_numpy(speech_like(48_060, 7)).to(cuda)
    p = agc_cuda.plan(len(x))
    assert (p["size"], p["spread"], p["ctas"]) == (16, True, 96)
    assert agc_cuda.sms_used(x, started=True) == 96


@pytest.mark.cuda
def test_cuda_agc_block_is_one_launch_with_its_state_on_the_card(cuda):
    """agc_block on the card: one launch a chunk, the gain and hang read
    from the card, the CPU's output and state bit for bit."""
    from csdr_tpu_torch.ops import agc
    _, _, speech_like = _agc_cases()
    x = torch.from_numpy(speech_like(30_000, 6))
    blk = agc.agc_block()
    sk, sc = blk.init(cuda), blk.init("cpu")
    n0 = agc_cuda.LAUNCHES["agc_relax"]
    for part in (x[:12_000], x[12_000:]):
        sk, yk = blk(sk, part.to(cuda))
        sc, yc = blk(sc, part)
        assert _same_bits(yk, yc)
    assert agc_cuda.LAUNCHES["agc_relax"] == n0 + 2
    for a, b in zip(sk, sc):
        assert _same_bits(a, b)


@pytest.mark.cuda
def test_cuda_agc_relax_refuses_a_chunk_past_its_shared_memory(cuda):
    with pytest.raises(ValueError, match="8192"):
        agc_cuda.relax(torch.ones(100, device=cuda), chunk=8320)


@pytest.mark.cuda
def test_cuda_agc_scan_probe_times_a_scan(cuda):
    """The probe's chain of a scan (13 dependent steps on one warp) takes
    the same cycles a scan at two lengths within 5 %, more than 13 times a
    dependent product and sum (8 cycles); no AGC launch counted."""
    n0 = dict(agc_cuda.LAUNCHES)
    a, b = (agc_cuda.scan_cycles(n) for n in (20, 100))
    assert a > 13 * 8.0 and abs(a - b) < 0.05 * b
    assert agc_cuda.LAUNCHES == n0


def test_agc_scan_probe_runs_on_the_card_only():
    with pytest.raises(ValueError, match="CUDA"):
        agc_cuda.scan_cycles(16, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        agc_cuda.plan(8192, device="cpu")


def test_ptxas_report_gives_each_kernel_its_registers_and_spills():
    """_build.parse_ptxas reads nvcc -Xptxas -v's report (the form ptxas
    prints for sm_90a), one entry a kernel, as chip_smoke.py's AGC phase
    reads it for every agc_relax_kernel instance."""
    from csdr_tpu_torch.kernels import _build
    text = (
        "ptxas info    : Compiling entry function '_Z1aILi1EEvv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aILi1EEvv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 55 registers, used 1 barriers, 560 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1aILi2EEvv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aILi2EEvv\n"
        "    40 bytes stack frame, 52 bytes spill stores, 92 bytes spill "
        "loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers\n")
    assert _build.parse_ptxas(text) == {
        "_Z1aILi1EEvv": {"registers": 55, "stack_bytes": 0,
                         "spill_store_bytes": 0, "spill_load_bytes": 0},
        "_Z1aILi2EEvv": {"registers": 64, "stack_bytes": 40,
                         "spill_store_bytes": 52, "spill_load_bytes": 92}}


# ---------------------------------------------------------------------------
# agc_ff's exact recurrence (csrc/agc_exact.cu)
# ---------------------------------------------------------------------------

def _same_bits_or_nan(a, b):
    """Equal bits, but where both hold a NaN: a NaN's payload is the
    hardware's (x86 keeps the input's, the card writes its canonical one),
    so only its place is compared."""
    a, b = a.cpu(), b.cpu()
    if not a.is_floating_point():
        return _same_bits(a, b)
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and _same_bits(torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)))


def _scan_case(name):
    """tests/test_torch_agc_kernel.py's exact-scan case ``name``: its input
    and agc_ff's keyword arguments."""
    import test_torch_agc_kernel as m
    make, kw = m.SCAN_CASES[name]
    return make(), dict(kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wait0", "wait5", "wait200", "continuing",
                                  "n1", "nan_inf", "edges",
                                  "max_gain_negative"])
def test_cuda_agc_ff_scan_matches_plain(cuda, name):
    """agc_ff on the card (one launch of the exact scan's kernel) against
    the host loop, bit for bit: y and the next gain, hang, peak and
    attack-wait count, which stay on the card."""
    from csdr_tpu_torch.ops import agc
    x, kw = _scan_case(name)
    n0 = agc_cuda.LAUNCHES["agc_ff_scan"]
    got = agc.agc_ff(torch.from_numpy(x).to(cuda), full_state=True, **kw)
    assert agc_cuda.LAUNCHES["agc_ff_scan"] == n0 + 1
    want = agc.agc_ff(torch.from_numpy(x), full_state=True, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.device == got[0].device and _same_bits_or_nan(a, b), name


@pytest.mark.cuda
def test_cuda_agc_scan_block_is_one_launch_with_its_state_on_the_card(cuda):
    """agc_block(method="scan") on the card: one launch a chunk, its state
    read and written on the card, the CPU's output and state bit for bit."""
    from csdr_tpu_torch.ops import agc
    _, _, speech_like = _agc_cases()
    x = torch.from_numpy(speech_like(30_000, 8))
    blk = agc.agc_block(method="scan", attack_wait_time=5)
    sk, sc = blk.init(cuda), blk.init("cpu")
    n0 = agc_cuda.LAUNCHES["agc_ff_scan"]
    for part in (x[:12_000], x[12_000:12_001], x[12_001:]):
        sk, yk = blk(sk, part.to(cuda))
        sc, yc = blk(sc, part)
        assert _same_bits(yk, yc)
    assert agc_cuda.LAUNCHES["agc_ff_scan"] == n0 + 3
    assert all(t.is_cuda for t in sk[:4])
    for a, b in zip(sk, sc):
        assert _same_bits(a, b)


@pytest.mark.cuda
def test_cuda_agc_ff_chain_probe_times_its_chain(cuda):
    """The exact scan's probe takes the same cycles a sample at two lengths
    within 5 %, more than a float add's latency; no launch counted."""
    _, _, speech_like = _agc_cases()
    x = torch.from_numpy(speech_like(agc_cuda.PROBE_MAX, 9)).to(cuda)
    n0 = dict(agc_cuda.LAUNCHES)
    a, b = (agc_cuda.exact_cycles(x[:n], attack_wait_time=5)
            for n in (agc_cuda.PROBE_MAX // 2, agc_cuda.PROBE_MAX))
    assert a > 8.0 and abs(a - b) < 0.05 * b
    assert agc_cuda.LAUNCHES == n0


# ---------------------------------------------------------------------------
# the carrier loops (csrc/carrier.cu) and the Baudot decoder (csrc/baudot.cu)
# ---------------------------------------------------------------------------

def _carrier_rows(rows=3, n=1500, seed=10):
    """BPSK rows at 32 samples a symbol on carriers 0.001-0.003 cycles a
    sample off, in noise."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    out = []
    for r in range(rows):
        bb = np.repeat(rng.integers(0, 2, n // 32 + 1) * 2.0 - 1.0, 32)[:n]
        out.append(bb * np.exp(1j * (2 * np.pi * 0.001 * (r + 1) * k + r))
                   + 0.05 * (rng.standard_normal(n)
                             + 1j * rng.standard_normal(n)))
    return np.stack(out).astype(np.complex64)


def test_costas_plain_matches_float64():
    """costas_plain against a float64 model of the recurrence (reference
    libcsdr.c:2108-2142): 39 dB over the first 128 samples, 30 over all
    (csdr_tpu's bars against its float64 model)."""
    x = _carrier_rows(1, 2048)[0]
    alpha, beta, dmax = (0.0628 * 0.707 * 4 / 1.093, 0.0158 / 1.093, 0.0628)
    y = carrier_cuda.costas_plain(torch.from_numpy(x), alpha, beta,
                                  dmax)[0].numpy()
    ph = fr = 0.0
    model = np.zeros(len(x), np.complex128)
    for i, xi in enumerate(x.astype(np.complex128)):
        v = xi * (np.cos(ph) + 1j * np.sin(ph))
        model[i] = v
        e = np.pi * v.real * v.imag
        fr += e * beta
        ph = (ph + np.clip(e * alpha + fr, -dmax, dmax)) % (2 * np.pi)
        ph += 2 * np.pi if ph <= 0 else 0.0
    assert _snr_db(model[:128], y[:128]) >= 39
    assert _snr_db(model, y) >= 30


def test_pll_plain_matches_float64():
    """pll_plain (PI) against a float64 model of the recurrence (reference
    libcsdr.c:1870-1915), NCO sin + j*cos: 30 dB."""
    k = np.arange(3000)
    x = np.exp(1j * (2 * np.pi * 0.002 * k + 1.0)).astype(np.complex64)
    alpha, beta = 0.0888, 0.0039
    _, nco, _ = carrier_cuda.pll_plain(torch.from_numpy(x), alpha, beta)
    wrap = lambda p: (p + np.pi) % (2 * np.pi) - np.pi   # noqa: E731
    op = dp = iir = 0.0
    model = np.zeros(len(x), np.complex128)
    for i, xi in enumerate(x.astype(np.complex128)):
        op = wrap(op + dp)
        model[i] = np.sin(op) + 1j * np.cos(op)
        nd = wrap(np.arctan2(xi.real, xi.imag) - op)
        dp = wrap(nd * alpha + iir)
        iir += nd * beta
    assert _snr_db(model, nco.numpy()) >= 30


@pytest.mark.cuda
@pytest.mark.parametrize("dd,reset", [(False, False), (True, False),
                                      (False, True), (True, True)])
def test_cuda_costas_matches_plain(cuda, dd, reset):
    """carrier_cuda.costas (one launch) against costas_plain on the card,
    bit for bit: y, error, dphase and the state, which stays on the card;
    streamed in two calls the same bits."""
    x = torch.from_numpy(_carrier_rows()).to(cuda)
    params = (0.0628 * 0.707 * 4 / 1.093, 0.0158 / 1.093,
              0.02 if reset else 0.0628, dd, reset)
    n0 = carrier_cuda.LAUNCHES["costas_scan"]
    got = carrier_cuda.costas(x, *params)
    assert carrier_cuda.LAUNCHES["costas_scan"] == n0 + 1
    want = carrier_cuda.costas_plain(x, *params)
    torch.cuda.synchronize()
    for a, b in zip(got[:3] + got[3], want[:3] + want[3]):
        assert a.is_cuda and _same_bits_or_nan(torch.view_as_real(a)
                                               if a.is_complex() else a,
                                               torch.view_as_real(b)
                                               if b.is_complex() else b)
    first = carrier_cuda.costas(x[:, :700], *params)
    rest = carrier_cuda.costas(x[:, 700:], *params, state=first[3])
    assert _same_bits(torch.view_as_real(torch.cat([first[0], rest[0]], 1)),
                      torch.view_as_real(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("pi_controller", [True, False])
def test_cuda_pll_matches_plain(cuda, pi_controller):
    """carrier_cuda.pll (one launch) against pll_plain on the card, bit for
    bit: -dphase, the NCO and the state."""
    x = torch.from_numpy(_carrier_rows(seed=11)).to(cuda)
    alpha, beta = (0.0888, 0.0039) if pi_controller else (0.01, None)
    n0 = carrier_cuda.LAUNCHES["pll_scan"]
    got = carrier_cuda.pll(x, alpha, beta)
    assert carrier_cuda.LAUNCHES["pll_scan"] == n0 + 1
    want = carrier_cuda.pll_plain(x, alpha, beta)
    torch.cuda.synchronize()
    assert _same_bits(got[0], want[0])
    assert _same_bits(torch.view_as_real(got[1]), torch.view_as_real(want[1]))
    for a, b in zip(got[2], want[2]):
        assert a.is_cuda and _same_bits(a, b)


@pytest.mark.cuda
def test_cuda_scan_chain_probes(cuda):
    """Each loop's probe (the Costas loop, the PLL, the Baudot machine):
    its last state the kernel's (the wrappers raise otherwise), more
    cycles a step than an add's latency, the same within 5 % at two
    lengths; no launch counted."""
    from csdr_tpu_torch.ops import digital
    x = torch.from_numpy(_carrier_rows(1, carrier_cuda.PROBE_MAX)[0]).to(
        cuda)
    n0 = dict(carrier_cuda.LAUNCHES), dict(baudot_cuda.LAUNCHES)
    a, b = (carrier_cuda.costas_cycles(x[:n], 0.1, 0.01, 0.0628)
            for n in (carrier_cuda.PROBE_MAX // 2, carrier_cuda.PROBE_MAX))
    assert a > 20.0 and abs(a - b) < 0.05 * b
    a, b = (carrier_cuda.pll_cycles(x[:n], 0.0888, 0.0039)
            for n in (carrier_cuda.PROBE_MAX // 2, carrier_cuda.PROBE_MAX))
    assert a > 8.0 and abs(a - b) < 0.05 * b
    sym = torch.from_numpy(np.random.default_rng(13).integers(
        0, 2, baudot_cuda.PROBE_MAX).astype(np.uint8)).to(cuda)
    a, b = (baudot_cuda.chain_cycles(sym[:n], *digital._baudot_tables(cuda))
            for n in (baudot_cuda.PROBE_MAX // 2, baudot_cuda.PROBE_MAX))
    assert a > 2.0 and abs(a - b) < 0.05 * b
    assert (carrier_cuda.LAUNCHES, baudot_cuda.LAUNCHES) == n0


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [3, None])
def test_cuda_baudot_matches_plain(cuda, cap):
    """baudot_cuda.decode (one launch) against decode_plain on the card,
    bit for bit: characters, count and state, from carried states the
    stream never makes too, a cap small enough to drop characters; on
    rows of framed characters, noise, all ones, all zeros and a periodic
    word whose framing never converges, from a bit counter of -60 and of 5
    (tiles on the serial route); decode_serial (every tile on the serial
    route) the same bits."""
    from csdr_tpu_torch.ops import digital
    rng = np.random.default_rng(12)
    rows, n = 6, 9000
    sym = rng.integers(0, 2, (rows, n)).astype(np.uint8)
    sym[::2] = 1
    for r in range(0, rows, 2):             # framed characters
        for i in range(0, n - 9, 10):
            sym[r, i + 1:i + 7] = np.r_[0, rng.integers(0, 2, 5)]
    sym = np.concatenate([sym, np.stack([
        np.ones(n, np.uint8), np.zeros(n, np.uint8),
        np.resize(np.asarray([0, 1, 1, 1, 1, 0, 0, 1, 1, 1, 1], np.uint8), n),
        sym[0], sym[2]])])
    state = tuple(torch.tensor(v, dtype=torch.int32, device=cuda) for v in (
        [0, 1, 2, 3, -1, 0, 0, 1, 2, 2, 2],
        [0, 1, 0, 1, 5, 0, 1, 0, 5, 0, 1],
        [0, -7, 31, 27, 1 << 20, 3, 27, 0, -4, 5, 3],
        [0, 4, 3, (1 << 31) - 1, -1, 0, 0, 5, 2, -60, 5],
        [0, 1, 0, 1, -3, 1, 1, 0, -3, 1, 0]))
    cap = cap or n // 7 + 4
    tables = digital._baudot_tables(cuda)
    x = torch.from_numpy(sym).to(cuda)
    n0 = baudot_cuda.LAUNCHES["baudot_scan"]
    got = baudot_cuda.decode(x, cap, state, *tables)
    assert baudot_cuda.LAUNCHES["baudot_scan"] == n0 + 1
    want = baudot_cuda.decode_plain(x, cap, state, *tables)
    ser = baudot_cuda.decode_serial(x, cap, state, *tables)
    torch.cuda.synchronize()
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
    assert _same_bits(ser[0], want[0]) and _same_bits(ser[1], want[1])
    for a, b, c in zip(got[2], want[2], ser[2]):
        assert a.is_cuda and _same_bits(a, b) and _same_bits(c, b)
    assert int(got[1].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(65536, 0), (70001, 3), (1001, 1)])
def test_cuda_baudot_routes_agree(cuda, n, offset):
    """The segmented route against the serial route (decode_serial) on the
    card, bit for bit, on 3 rows of framed characters over several tiles,
    the rows starting off 16-byte alignment where n or the offset puts
    them there (loaded by the threads instead of the bulk copy)."""
    from csdr_tpu_torch.ops import digital
    rng = np.random.default_rng(n)
    flat = np.ones(3 * n + offset, np.uint8)
    i = 0
    while i + 8 < len(flat):
        i += int(rng.integers(1, 4))
        flat[i:i + 6] = np.r_[0, rng.integers(0, 2, 5)]
        i += 8
    x = torch.from_numpy(flat).to(cuda)[offset:].reshape(3, n)
    tables = digital._baudot_tables(cuda)
    st = baudot_cuda.zero_state((3,), cuda)
    got = baudot_cuda.decode(x, n // 7 + 4, st, *tables)
    ser = baudot_cuda.decode_serial(x, n // 7 + 4, st, *tables)
    torch.cuda.synchronize()
    for a, b in zip(got[:2] + got[2], ser[:2] + ser[2]):
        assert _same_bits(a, b)
    assert int(got[1].min()) > n // 20


# ---------------------------------------------------------------------------
# the captured step (core/graph.CapturedStep) and K1's theta from the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d,t,rate,theta", [c for c in CASES if c[0] <= 10])
def test_cuda_k1_theta_on_the_card_is_the_by_value_form(cuda, d, t, rate,
                                                        theta):
    """K1 reading theta from a float32 on the card gives the by-value
    form's bits (theta widened alike), and both match the plain version."""
    kout = 3 * 256 + 17
    tail, x, taps = _inputs(d, t, kout, seed=11)
    args = (torch.from_numpy(tail).to(cuda), torch.from_numpy(x).to(cuda),
            torch.from_numpy(taps).to(cuda), d, kout)
    th = np.float32(theta)
    n0 = fir_cuda.LAUNCHES["shift_fir_decimate"]
    by_value = fir_cuda.shift_fir_decimate(*args, rate, float(th))
    on_card = fir_cuda.shift_fir_decimate(
        *args, rate, torch.tensor(th, device=cuda))
    plain = fir_cuda.shift_fir_decimate_plain(*args, rate, float(th))
    torch.cuda.synchronize()
    assert torch.equal(torch.view_as_real(by_value),
                       torch.view_as_real(on_card))
    assert _snr_db(plain.cpu().numpy(), on_card.cpu().numpy()) > 110
    assert fir_cuda.LAUNCHES["shift_fir_decimate"] == n0 + 2
    with pytest.raises(ValueError, match="theta"):
        fir_cuda.shift_fir_decimate(*args, rate, torch.tensor(
            [th, th], device=cuda))


def _same_tree(a, b):
    from torch.utils import _pytree as pytree
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb
    for u, v in zip(la, lb):
        if isinstance(u, torch.Tensor):
            u, v = u.cpu(), v.cpu()
            if u.is_complex():
                u, v = torch.view_as_real(u), torch.view_as_real(v)
            if u.is_floating_point():
                assert torch.equal(torch.isnan(u), torch.isnan(v))
                u, v = torch.nan_to_num(u), torch.nan_to_num(v)
            assert torch.equal(u, v)
        else:
            assert u == v


def _launch_counts():
    from csdr_tpu_torch.core.graph import launch_counts
    return {(m, k): n for m, c in launch_counts().items()
            for k, n in c.items()}


def _eager_against_captured(eager, captured, init, xs):
    """Both steps over ``xs`` from one state: outputs and states bit for
    bit, each step's launches equal."""
    se, sg = init(), init()
    with torch.no_grad():
        for x in xs:
            c0 = _launch_counts()
            se, ye = eager(se, x)
            c1 = _launch_counts()
            sg, yg = captured(sg, x)
            c2 = _launch_counts()
            torch.cuda.synchronize()
            _same_tree((se, ye), (sg, yg))
            assert {k: c1[k] - c0[k] for k in c0} == \
                {k: c2[k] - c1[k] for k in c1}
    assert captured.replays >= len(xs) - 2


def _tone(n, rate):
    s = np.arange(n, dtype=np.float64)
    rng = np.random.default_rng(12)
    return (np.exp(2j * np.pi * np.mod(rate * s, 1.0))
            + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [-0.2, -0.123456789])
def test_cuda_captured_wfm_step_is_the_eager_step(cuda, rate):
    from csdr_tpu_torch.models import wfm
    pipe = wfm.wfm_advanced(shift_rate=rate).to(cuda)
    n = 240_000
    x = _tone(5 * n, -rate)
    xs = [torch.from_numpy(x[c * n:(c + 1) * n]).to(cuda) for c in range(5)]
    step = pipe.jit_apply()
    _eager_against_captured(pipe, step, lambda: pipe.init(cuda), xs)
    assert step.captures <= 2


@pytest.mark.cuda
def test_cuda_captured_ssb_with_agc_step_is_the_eager_step(cuda):
    from csdr_tpu_torch.models import receivers
    pipe = receivers.ssb_receiver().to(cuda)
    n = 50 * pipe.blocks[1].input_size * 6
    x = _tone(5 * n, 0.0005)
    xs = [torch.from_numpy(x[c * n:(c + 1) * n]).to(cuda) for c in range(5)]
    step = pipe.jit_apply()
    _eager_against_captured(pipe, step, lambda: pipe.init(cuda), xs)
    assert step.captures == 2                # the AGC's started, then not


@pytest.mark.cuda
def test_cuda_captured_bank_step_is_the_eager_step(cuda):
    from csdr_tpu_torch.core.graph import CapturedStep
    from csdr_tpu_torch.models import multichannel
    init, step, meta = multichannel.build_ddc_bpsk31_bank(
        [0.3, 0.1, -0.15, -0.35], 50, 64, device=cuda)
    assert isinstance(step, CapturedStep)
    n = 500 * meta["input_size"]
    x = torch.from_numpy(0.3 * _tone(4 * n, 0.1)).to(cuda)
    xs = [x[c * n:(c + 1) * n] for c in range(4)]
    _eager_against_captured(meta["bank"].step, step, lambda: init(n), xs)
    assert step.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("d,method,frames", [
    (16, "fastddc", 64), (50, "fastddc", 100), (16, "td", 4)],
    ids=["d16_factored", "d50_classed", "d16_td"])
def test_cuda_captured_server_is_the_eager_server(cuda, d, method, frames):
    """The ddcd server's captured step (``DdcdServer._step``) against its
    eager twin (``_step = step``) on the card over 5 chunks: claims, a
    retune between the first replay and the second, a release, the retune
    back, a new claim.  Every chunk's outputs, counts and state bit for
    bit, launches equal, one capture, the row buffers never moved."""
    from csdr_tpu_torch.server.ddcd import DdcdServer

    eager, graph = (DdcdServer(d, 0.05, 8, method, frames, port=0,
                               device=cuda) for _ in range(2))
    eager._step = eager.step
    ptrs = [r.data_ptr() for r in graph.rows]

    def release(s):
        with s.lock:
            s._zero_slot_locked(0)

    events = {0: lambda s: [s.set_shift(i, r) for i, r in
                            ((0, -0.11), (1, 0.23), (3, 0.3))],
              1: lambda s: s.set_shift(1, -0.31), 2: release,
              3: lambda s: s.set_shift(1, 0.23),
              4: lambda s: s.set_shift(2, -0.2)}
    rng = np.random.default_rng(d)
    for k in range(5):
        x = (rng.standard_normal(eager.chunk_in)
             + 1j * rng.standard_normal(eager.chunk_in)).astype(np.complex64)
        for s in (eager, graph):
            events[k](s)
        c0 = _launch_counts()
        de, ce = eager._run_chunk(x)
        c1 = _launch_counts()
        dg, cg = graph._run_chunk(x)
        c2 = _launch_counts()
        _same_tree((torch.from_numpy(de), torch.from_numpy(ce), eager.state),
                   (torch.from_numpy(dg), torch.from_numpy(cg), graph.state))
        assert {n: c1[n] - c0[n] for n in c0} == \
            {n: c2[n] - c1[n] for n in c1}
        assert [r.data_ptr() for r in graph.rows] == ptrs
    assert graph._step.captures == 1 and graph._step.replays == 4


@pytest.mark.cuda
def test_cuda_capture_survives_a_graph_freed_in_another_thread(cuda):
    """Another thread frees an old step's graph while a step is captured
    (Python's cyclic collector can do that at any time, and the DDC server
    captures on its device-loop thread): the capture holds, with the
    cyclic collector paused while it runs."""
    import gc
    import threading

    from csdr_tpu_torch.core.graph import CapturedStep

    x = torch.arange(8, dtype=torch.float32, device=cuda)
    old = CapturedStep(lambda s, v: (s + 1, v * 2))
    s = torch.zeros(1, device=cuda)
    for _ in range(2):
        s, _ = old(s, x)
    assert old.captures == 1
    held, seen = [old], []
    del old

    def body(state, v):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
            t = threading.Thread(target=held.clear)
            t.start()
            t.join()
        return state + 1, v * 3

    step = CapturedStep(body)
    s = torch.zeros(1, device=cuda)
    for k in range(3):
        s, y = step(s, x)
        torch.cuda.synchronize()
        assert torch.equal(y, x * 3) and s.item() == k + 1
    assert step.captures == 1 and step.replays == 2
    assert seen == [False] and not held


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [["fir_decimate_cc", "10", "0.05",
                                   "HAMMING"],
                                  ["shift_addition_cc", "-0.123456789"]])
def test_cuda_cli_command_captured_against_uncaptured(cuda, argv,
                                                     monkeypatch):
    """A CLI command in process on the card, its pump's step captured (one
    CUDA graph a key, replayed; cli.STEP's default) and uncaptured (the
    block itself): the same bytes bit for bit over 6 chunks and a tail;
    one capture for the chunk's key and one for the tail's, replays on
    the rest.  The shift's phase moves every chunk, a value leaf."""
    import io
    import sys

    from csdr_tpu_torch import cli

    rng = np.random.default_rng(40)
    x = (rng.standard_normal(6 * 8192 + 99)
         + 1j * rng.standard_normal(6 * 8192 + 99)).astype(np.complex64)
    monkeypatch.setenv("CSDR_FIXED_BUFSIZE", "8192")

    def run(step):
        monkeypatch.setattr(cli, "STEP", step)
        out = io.BytesIO()
        saved = sys.stdin, sys.stdout
        sys.stdin = io.TextIOWrapper(io.BytesIO(x.tobytes()))
        sys.stdout = io.TextIOWrapper(out, write_through=True)
        try:
            rc = cli.main(["csdr_tpu_torch", *argv, "--device", "cuda"])
            sys.stdout.flush()
            data = out.getvalue()
        finally:
            sys.stdin, sys.stdout = saved
        assert rc in (0, None)
        return data, cli.STEPS[-1]

    graph, row = run(cli.CapturedStep)
    eager, row_e = run(lambda block, graphs: block)
    assert len(graph) > 0 and graph == eager
    assert row["captured"] and not row_e["captured"]
    assert (row["captures"], row["replays"], row["recaptures"]) == (2, 5, 0)
