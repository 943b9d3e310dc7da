"""csdr_tpu_torch core against csdr_tpu: package purity, the device rule,
Block/Pipeline framing, checkpoints (including a csdr_tpu checkpoint
loaded into the port), and the firdes copy."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csdr_tpu
from csdr_tpu import firdes as jfirdes
from csdr_tpu.core import cplx as jcplx
from csdr_tpu.models import wfm as jwfm
from csdr_tpu.ops import fir as jfir

import csdr_tpu_torch
from csdr_tpu_torch import firdes as tfirdes
from csdr_tpu_torch.core import block as tblock
from csdr_tpu_torch.core import checkpoint as tckpt
from csdr_tpu_torch.core.stream import StreamRunner, run_offline
from csdr_tpu_torch.models import wfm as twfm
from csdr_tpu_torch.ops import fir as tfir

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "csdr_tpu_torch"


# --------------------------------------------------------------------------
# purity and the device rule
# --------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_csdr_tpu():
    """In a fresh interpreter (this one has jax loaded by conftest)."""
    code = ("import sys, csdr_tpu_torch, csdr_tpu_torch.models.wfm\n"
            "import csdr_tpu_torch.ops.fastddc, csdr_tpu_torch.ops.fftfilt\n"
            "import csdr_tpu_torch.models.receivers, csdr_tpu_torch.ops.agc\n"
            "import csdr_tpu_torch.kernels.fft_cuda\n"
            "import csdr_tpu_torch.kernels.fastddc_cuda\n"
            "import csdr_tpu_torch.ops.sync, csdr_tpu_torch.ops.digital\n"
            "import csdr_tpu_torch.ops.noise, csdr_tpu_torch.models.bpsk31\n"
            "import csdr_tpu_torch.models.multichannel\n"
            "import csdr_tpu_torch.ops.shift, csdr_tpu_torch.server.ddcd\n"
            "import csdr_tpu_torch.server.nmux\n"
            "import csdr_tpu_torch.ops.convert, csdr_tpu_torch.ops.spectrum\n"
            "import csdr_tpu_torch.ops.adpcm, csdr_tpu_torch.kernels.adpcm_cuda\n"
            "import csdr_tpu_torch.kernels.probe_cuda\n"
            "import csdr_tpu_torch.kernels.agc_cuda\n"
            "import csdr_tpu_torch.utils.roofline\n"
            "import csdr_tpu_torch.utils.dispatch_lint\n"
            "import chip_smoke, check_kernels\n"
            "assert callable(chip_smoke.phase_bank_paths)\n"
            "assert callable(chip_smoke.phase_server_paths)\n"
            "assert callable(chip_smoke.phase_byte_edge_paths)\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'csdr_tpu' "
            "or m.startswith('csdr_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_source_has_no_jax_imports():
    sources = sorted(PKG.rglob("*.py"))
    assert len(sources) >= 12
    assert PKG / "server" / "ddcd.py" in sources
    assert PKG / "server" / "nmux.py" in sources
    for name in ("convert", "spectrum", "adpcm"):
        assert PKG / "ops" / f"{name}.py" in sources
    assert PKG / "kernels" / "adpcm_cuda.py" in sources
    sources += [ROOT / "chip_smoke.py", ROOT / "check_kernels.py"]
    for p in sources:
        for i, line in enumerate(p.read_text().splitlines(), 1):
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or s.startswith("from csdr_tpu.")
                        or s.startswith("import csdr_tpu.")
                        or s.startswith("from csdr_tpu import")
                        or s == "import csdr_tpu"), f"{p}:{i}: {s}"


def test_expj_is_accurate_on_its_first_call_in_fresh_processes():
    """expj on a CPU tensor large enough to be split over threads, as the
    first transcendental of a fresh process after a complex matmul, in 80
    forked children of a fresh interpreter: every value within 1e-6 of
    e^{j theta} in float64.  torch.cos/torch.sin on float32 failed this in
    up to a third of the children (errors near 2^-13 over one thread's
    share)."""
    code = (
        "import os, numpy as np, torch\n"
        "from csdr_tpu_torch.core.cplx import expj\n"
        "rng = np.random.default_rng(0)\n"
        "def c64(*shape):\n"
        "    return torch.from_numpy((rng.standard_normal(shape) + 1j * "
        "rng.standard_normal(shape)).astype(np.complex64))\n"
        "a, w = c64(8192, 128), c64(128, 128)\n"
        "theta = torch.from_numpy(rng.uniform(0, 2 * np.pi, (64, 1024))"
        ".astype(np.float32))\n"
        "ref = np.exp(1j * theta.numpy().astype(np.float64))\n"
        "errs = []\n"
        "for _ in range(80):\n"
        "    rd, wr = os.pipe()\n"
        "    pid = os.fork()\n"
        "    if pid == 0:\n"
        "        torch.matmul(a, w)\n"
        "        err = np.abs(expj(theta).numpy() - ref).max()\n"
        "        os.write(wr, repr(float(err)).encode())\n"
        "        os._exit(0)\n"
        "    os.close(wr)\n"
        "    errs.append(float(os.read(rd, 64)))\n"
        "    os.close(rd)\n"
        "    os.waitpid(pid, 0)\n"
        "print(max(errs), sum(e > 1e-6 for e in errs))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    worst, bad = proc.stdout.split()
    assert int(bad) == 0 and float(worst) < 1e-6, proc.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    pipe = twfm.wfm_advanced()
    x = np.zeros(12_800, np.complex64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_offline(pipe, x, block_size=6400)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamRunner(pipe, block_size=6400)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipe.init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tckpt.state_from_numpy_leaves(pipe, [])
    # the CPU is reached only by asking for it
    y = run_offline(pipe, x, block_size=6400, device="cpu")
    assert y.dtype == np.float32 and np.all(np.isfinite(y))
    # no whole block fits: an empty result of the pipeline's output dtype,
    # as csdr_tpu's run_offline gives
    e = run_offline(pipe, x[:100], block_size=6400, device="cpu")
    ej = csdr_tpu.run_offline(jwfm.wfm_advanced(), x[:100], block_size=6400)
    assert e.shape == ej.shape == (0,) and e.dtype == ej.dtype


# --------------------------------------------------------------------------
# Block / Pipeline framing
# --------------------------------------------------------------------------

_TAPS79 = jfirdes.firdes_lowpass_f(79, 0.05)


@pytest.mark.parametrize("make_j,make_t", [
    (lambda: jwfm.wfm_basic(), lambda: twfm.wfm_basic()),
    (lambda: csdr_tpu.Pipeline([jfir.fir_decimate_block(_TAPS79, 10)]),
     lambda: tblock.Pipeline([tfir.fir_decimate_block(_TAPS79, 10)])),
    (lambda: csdr_tpu.Pipeline(
        [jfir.shifted_fir_decimate_block(-0.2, _TAPS79, 10),
         jfir.fir_decimate_block(jfirdes.firdes_lowpass_f(41, 0.1), 5)]),
     lambda: tblock.Pipeline(
        [tfir.shifted_fir_decimate_block(-0.2, _TAPS79, 10),
         tfir.fir_decimate_block(tfirdes.firdes_lowpass_f(41, 0.1), 5)])),
], ids=["wfm_basic", "fir_decimate", "shifted_then_fir"])
def test_pipeline_warmup_and_rate_match_jax(make_j, make_t):
    pj, pt = make_j(), make_t()
    assert pt.warmup_out == pj.warmup_out
    assert [b.warmup_out for b in pt.blocks] == \
        [b.warmup_out for b in pj.blocks]
    assert [b.rate_ratio for b in pt.blocks] == \
        [b.rate_ratio for b in pj.blocks]


def test_wfm_advanced_warmup_raises_in_both():
    """A VarOut block sits downstream of the FIR's pending warmup."""
    with pytest.raises(ValueError, match="data-dependent rate"):
        jwfm.wfm_advanced().warmup_out
    with pytest.raises(ValueError, match="data-dependent rate"):
        twfm.wfm_advanced().warmup_out


def test_pipeline_state_length_checked_and_stateless_passes_varout():
    pipe = tblock.Pipeline([tblock.stateless("neg", lambda v: -v),
                            tfir.fir_decimate_block(_TAPS79, 10)])
    st = pipe.init("cpu")
    with pytest.raises(ValueError, match="state has 1 entries for 2"):
        pipe(st[:1], torch.zeros(100, dtype=torch.complex64))
    blk = tblock.stateless("twice", lambda v: 2 * v)
    _, y = blk(None, tblock.VarOut(torch.arange(4.0), 3))
    assert y.count == 3 and y.data.tolist() == [0.0, 2.0, 4.0, 6.0]


def test_varout_compact_cuts_samples_not_channels():
    """A (C, cap) VarOut shares one count across channels: compact cuts
    the sample axis; the 1-D case is unchanged."""
    data = torch.arange(12.0).reshape(3, 4)
    assert tblock.VarOut(data, 2).compact().tolist() == \
        [[0.0, 1.0], [4.0, 5.0], [8.0, 9.0]]
    assert tblock.VarOut(torch.arange(5.0), 3).compact().tolist() == \
        [0.0, 1.0, 2.0]


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _fm_tone(n, fs=2_400_000, carrier=0.2, seed=0):
    t = np.arange(n) / fs
    audio = 0.5 * np.sin(2 * np.pi * 1000 * t)
    ph = 2 * np.pi * (np.cumsum(audio) * 75_000 / fs + carrier * np.arange(n))
    rng = np.random.default_rng(seed)
    noise = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (np.exp(1j * ph) + noise).astype(np.complex64)


def test_checkpoint_round_trip(tmp_path):
    pipe = twfm.wfm_advanced()
    st = pipe.init("cpu")
    with torch.no_grad():
        st, _ = pipe(st, torch.from_numpy(_fm_tone(6400)))
    path = tmp_path / "st.npz"
    tckpt.save_state(str(path), st)
    back = tckpt.load_state(str(path), pipe.init("cpu"))
    a, b = tckpt.state_to_numpy_leaves(st), tckpt.state_to_numpy_leaves(back)
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and np.array_equal(u, v)
    with pytest.raises(ValueError, match="tree structure"):
        tckpt.load_state(str(path), twfm.wfm_basic().init("cpu"))


def test_csdr_tpu_checkpoint_resumes_in_port(tmp_path):
    """csdr_tpu streams 2 chunks and saves; the port loads the leaves and
    streams chunk 3; the audio equals csdr_tpu's chunk 3."""
    n = 6400
    x = _fm_tone(3 * n, seed=1)
    pj = jwfm.wfm_advanced()
    sj = pj.init()
    for c in range(2):
        sj, _ = pj.apply(sj, jcplx.from_numpy(x[c * n:(c + 1) * n]))
    path = tmp_path / "jax_state.npz"
    csdr_tpu.save_state(str(path), sj)
    sj, yj = pj.apply(sj, jcplx.from_numpy(x[2 * n:]))
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in
                  range(sum(k.startswith("leaf_") for k in z.files))]
    pt = twfm.wfm_advanced()
    st = tckpt.state_from_numpy_leaves(pt, leaves, device="cpu")
    # the port writes the same leaves back
    for u, v in zip(tckpt.state_to_numpy_leaves(st), leaves):
        assert u.dtype == v.dtype and np.array_equal(u, v)
    with torch.no_grad():
        st, yt = pt(st, torch.from_numpy(x[2 * n:]))
    assert yt.count == int(yj.count) > 0
    ref = np.asarray(yj.data)[: yt.count]
    from tests.util import assert_snr
    assert_snr(ref, yt.compact().numpy(), 60, "resumed chunk 3")


def test_state_leaves_match_jax_flatten_order():
    import jax
    pj, pt = jwfm.wfm_advanced(), twfm.wfm_advanced()
    x = _fm_tone(6400)
    sj, _ = pj.apply(pj.init(), jcplx.from_numpy(x))
    with torch.no_grad():
        st, _ = pt(pt.init("cpu"), torch.from_numpy(x))
    lj = [np.asarray(v) for v in jax.tree_util.tree_leaves(sj)]
    lt = tckpt.state_to_numpy_leaves(st)
    assert [(a.shape, a.dtype) for a in lt] == [(a.shape, a.dtype)
                                               for a in lj]


# --------------------------------------------------------------------------
# firdes: a bit-identical copy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("length,cutoff", [(81, 0.05), (199, 0.01),
                                           (21, 0.25), (79, 0.05)])
@pytest.mark.parametrize("window", ["HAMMING", "BLACKMAN", "BOXCAR"])
def test_firdes_lowpass_bit_identical(length, cutoff, window):
    assert np.array_equal(tfirdes.firdes_lowpass_f(length, cutoff, window),
                          jfirdes.firdes_lowpass_f(length, cutoff, window))


def test_firdes_other_designs_bit_identical():
    for length, lo, hi in [(101, -0.2, 0.1), (257, 0.0, 0.25)]:
        assert np.array_equal(tfirdes.firdes_bandpass_c(length, lo, hi),
                              jfirdes.firdes_bandpass_c(length, lo, hi))
    for bw in (0.05, 0.1, 0.0123, 0.15):
        assert tfirdes.firdes_filter_len(bw) == jfirdes.firdes_filter_len(bw)
    assert tfirdes.firdes_filter_len(0.05) == 79
    assert np.array_equal(tfirdes.firdes_add_peak_c(101, [0.1, -0.2]),
                          jfirdes.firdes_add_peak_c(101, [0.1, -0.2]))
    assert np.array_equal(tfirdes.firdes_rrc_f(65, 8, 0.35),
                          jfirdes.firdes_rrc_f(65, 8, 0.35))
    assert np.array_equal(tfirdes.firdes_cosine_f(17, 8),
                          jfirdes.firdes_cosine_f(17, 8))
    assert np.array_equal(
        tfirdes.rational_resampler_get_lowpass_f(101, 3, 5),
        jfirdes.rational_resampler_get_lowpass_f(101, 3, 5))
    assert np.array_equal(tfirdes.precalculate_window(256),
                          jfirdes.precalculate_window(256))
    # the WFM front-end taps, as both wfm_advanced build them
    assert np.array_equal(
        tfirdes.firdes_lowpass_f(tfirdes.firdes_filter_len(0.05), 0.05),
        jfirdes.firdes_lowpass_f(jfirdes.firdes_filter_len(0.05), 0.05))
