"""The csdr-compatible CLI of csdr_tpu_torch against csdr_tpu's, both
``main``s run in this process on the same stdin bytes, the port with
``--device cpu``: the registry and usage text, CSDR_FIXED_BUFSIZE with an
odd EOF tail, the dynamic-bufsize preamble and its mismatch fallback, live
``--fd`` retunes, the noise sources by their statistics, and, in fresh
processes, the CUDA requirement and an import with jax and csdr_tpu
blocked.  The registry sweep over tests/test_cli_smoke.py's CASES is in
test_torch_cli_sweep.py.

Bars: bytes and integer outputs bit for bit; float outputs at 100 dB
against csdr_tpu (csdr_tpu's jitted pump rounds some float32 ops otherwise
than eager torch: XLA rewrites a division by a constant, contracts
multiply-adds), except the Costas loop and the noise sources.  Costas is
held at csdr_tpu's own bars, 32 dB over its first 256 samples and 28 dB
over all (tests/test_digital.py), on the BPSK signal those bars were set
for; on an input it does not lock to, its first 256 samples at 32 dB and
every sample's magnitude.  The noise sources are held by their
statistics (another PRNG)."""

import io
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import csdr_tpu.ops.adpcm  # noqa: F401  (imported before any traced apply)
import csdr_tpu.ops.digital  # noqa: F401
import csdr_tpu.ops.noise  # noqa: F401
import csdr_tpu.ops.spectrum  # noqa: F401
from csdr_tpu import cli as jcli

from csdr_tpu_torch import cli

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FLOAT_BAR = 100.0
COSTAS_BARS = (32.0, 28.0)

# wire format of each command's output, for the comparison
F32_OUT = set("""convert_u8_f convert_s8_f convert_s16_f convert_s24_f
realpart_cf gain_ff limit_ff clipdetect_ff detect_nan_ff dcblock_ff
fastdcblock_ff rational_resampler_ff suboptimal_rational_resampler_ff
fractional_decimator_ff old_fractional_decimator_ff fmdemod_atan_cf
fmdemod_quadri_cf amdemod_cf amdemod_estimator_cf deemphasis_wfm_ff
deemphasis_nfm_ff agc_ff fastagc_ff logpower_cf logaveragepower_cf
fft_exchange_sides_ff fft_one_side_ff bfsk_demod_cf pll_cc
normalized_timing_variance_u32_f add_n_zero_samples_at_beginning_f through
yes_f""".split())
C64_OUT = set("""add_const_cc shift_math_cc shift_addition_cc shift_table_cc
shift_addfast_cc shift_unroll_cc shift_addition_fc
decimating_shift_addition_cc fir_decimate_cc fir_interpolate_cc
plain_interpolate_cc bandpass_fir_fft_cc peaks_fir_cc
pulse_shaping_filter_cc fmmod_fc dsb_fc add_dcoffset_cc fixed_amplitude_cc
simple_agc_cc squelch_and_smeter_cc fft_cc fft_fc psk_modulator_u8_c
psk31_interpolate_sine_cc timing_recovery_cc bpsk_costas_loop_cc awgn_cc
fastddc_fwd_cc fastddc_inv_cc""".split())


class _Stdin:
    """stdin over bytes; ``hook(pos)`` runs before each read that starts
    at byte ``pos`` (a retune written to a control pipe)."""

    def __init__(self, data: bytes, hook=None):
        self.buffer = self
        self.data, self.pos, self.hook = data, 0, hook

    def read(self, n=-1):
        if self.hook is not None:
            self.hook(self.pos)
        end = len(self.data) if n is None or n < 0 else self.pos + n
        out = self.data[self.pos:end]
        self.pos += len(out)
        return out


def run_main(main, argv, inp=b"", env=None, hook=None):
    """``main(argv)`` with stdin, stdout and stderr swapped for buffers
    (temporary files where the command needs file descriptors: fifo);
    returns (rc, stdout bytes, stderr text)."""
    saved = (sys.stdin, sys.stdout, sys.stderr, sys.argv, dict(os.environ))
    with tempfile.TemporaryFile() as fi, tempfile.TemporaryFile() as fo:
        if hook is None:
            fi.write(inp)
            fi.flush()
            fi.seek(0)
            sys.stdin = io.TextIOWrapper(open(os.dup(fi.fileno()), "rb"))
        else:
            sys.stdin = _Stdin(inp, hook)
        sys.stdout = io.TextIOWrapper(open(os.dup(fo.fileno()), "wb"),
                                      write_through=True)
        sys.stderr = io.StringIO()
        err = sys.stderr
        sys.argv = list(argv)
        os.environ.update(env or {})
        try:
            try:
                rc = main(list(argv))
            except SystemExit as e:
                rc = e.code
            sys.stdout.flush()
        finally:
            if hook is None:
                sys.stdin.close()
            sys.stdout.close()
            sys.stdin, sys.stdout, sys.stderr, sys.argv = saved[:4]
            os.environ.clear()
            os.environ.update(saved[4])
        fo.seek(0)
        return rc or 0, fo.read(), err.getvalue()


def run_both(name, args, inp=b"", env=None):
    """csdr_tpu's main and the port's (``--device cpu``) on the same
    stdin; returns ((rc, out, err) of csdr_tpu, of the port)."""
    j = run_main(jcli.main, ["csdr_tpu", name] + list(args), inp, env)
    t = run_main(cli.main, ["csdr_tpu_torch", name] + list(args)
                 + ["--device", "cpu"], inp, env)
    return j, t


def snr_db(ref, test) -> float:
    ref = np.asarray(ref).astype(np.complex128)
    test = np.asarray(test).astype(np.complex128)
    err = np.sum(np.abs(ref - test) ** 2)
    return np.inf if err == 0 else float(
        10 * np.log10(np.sum(np.abs(ref) ** 2) / err))


def assert_outputs_match(name, out_j: bytes, out_t: bytes):
    """Bit for bit for bytes and integers; at FLOAT_BAR for float outputs
    (Costas at its two bars)."""
    if name not in F32_OUT and name not in C64_OUT:
        assert out_t == out_j, (name, len(out_j), len(out_t))
        return
    assert len(out_t) == len(out_j), (name, len(out_j), len(out_t))
    dt = np.float32 if name in F32_OUT else np.complex64
    a, b = np.frombuffer(out_j, dt), np.frombuffer(out_t, dt)
    if name == "bpsk_costas_loop_cc":
        # csdr_tpu's first bar; on an input the loop does not lock to
        # (the sweep's noise) the stream is chaotic and both packages
        # leave the float64 recurrence alike, so past 256 samples the
        # outputs are held to a rotation of the input: |y| = |x|
        assert snr_db(a[:256], b[:256]) >= COSTAS_BARS[0], name
        np.testing.assert_allclose(np.abs(b), np.abs(a), rtol=1e-5,
                                   atol=1e-7)
        return
    assert snr_db(a, b) >= FLOAT_BAR, (name, snr_db(a, b))


RNG = np.random.default_rng(1302)
CF = (0.3 * (RNG.standard_normal(10_001) + 1j * RNG.standard_normal(10_001))
      ).astype(np.complex64)
FL = (0.3 * RNG.standard_normal(10_001)).astype(np.float32)


def test_registry_and_usage():
    assert sorted(cli.REGISTRY) == sorted(jcli.REGISTRY)
    assert len([n for n in cli.REGISTRY if not n.startswith("-")]) == 116
    assert len(cli.REGISTRY) == 117
    assert set(cli.USAGE) == set(jcli.USAGE)
    for name in cli.REGISTRY:
        if name.startswith("-"):
            continue
        u = cli.usage_for(name)
        assert u.startswith(f"usage: csdr_tpu_torch {name}"), u
        assert "--device cuda|cpu" in u
    assert "default" in cli.USAGE["fir_decimate_cc"]
    assert "float32 FMA" in cli.USAGE["fir_decimate_cc"]
    rc, _, err = run_main(cli.main, ["csdr_tpu_torch", "--help"])
    assert rc == 0 and "csdr_tpu_torch" in err and "--device" in err
    for name in cli.REGISTRY:
        if not name.startswith("-"):
            assert cli.USAGE[name] in err


def test_main_forms_and_bad_syntax():
    rc, out, _ = run_main(cli.main, ["x", "=2*3"])
    assert (rc, out) == (0, b"6\n")
    for form in ("?shift", "??fir_dec"):
        j = run_main(jcli.main, ["x", form])
        t = run_main(cli.main, ["x", form])
        assert t[1] == j[1] and t[0] == 0
    rc, _, err = run_main(cli.main, ["x", "fir_decimate_cc", "--device",
                                     "cpu"])
    assert rc == 1 and "usage: csdr_tpu_torch fir_decimate_cc " \
        "<decimation_factor>" in err
    rc, _, err = run_main(cli.main, ["x", "deemphasis_wfm_ff", "48000",
                                     "--device", "cpu"])
    assert rc == 1 and "usage: csdr_tpu_torch deemphasis_wfm_ff" in err
    rc, _, err = run_main(cli.main, ["x", "no_such_cmd"])
    assert rc == 1 and "unknown command" in err
    rc, _, err = run_main(cli.main, ["x", "gain_ff", "2", "--device", "tpu"])
    assert rc == 1 and "usage: csdr_tpu_torch gain_ff" in err
    x = (np.arange(50_000) % 7).astype(np.complex64)
    rc, _, err = run_main(cli.main, ["x", "fir_decimate_cc", "10",
                                     "--precision", "bf16", "--device",
                                     "cpu"], x.tobytes())
    assert rc == 1 and "--precision bf16" in err
    outs = [run_main(cli.main, ["x", "fir_decimate_cc", "10", "0.05",
                                "HAMMING", "--precision", p, "--device",
                                "cpu"], x.tobytes())[1]
            for p in ("highest", "high", "default")]
    assert outs[0] == outs[1] == outs[2] and len(outs[0]) > 0


def test_strip_ctl_args():
    assert cli.strip_ctl_args(["--fifo", "p", "0.1", "--fd", "3", "--device",
                               "cpu", "x"]) == ["0.1", "x"]


@pytest.mark.parametrize("bufsize", ["1024", "4096"])
@pytest.mark.parametrize("name,args,kind", [
    ("fir_decimate_cc", ["4", "0.05", "HAMMING"], "c"),
    ("bandpass_fir_fft_cc", ["0.0", "0.2", "0.05"], "c"),
    ("fractional_decimator_ff", ["2.5"], "f"),
    ("rational_resampler_ff", ["5", "2"], "f"),
    ("fmdemod_quadri_cf", [], "c"),
    ("fastddc_fwd_cc", ["4"], "c"),
    ("convert_f_s16", [], "f"),
])
def test_fixed_bufsize_with_odd_tail(bufsize, name, args, kind):
    """CSDR_FIXED_BUFSIZE sets the chunk; the 10 001-sample input leaves
    an odd EOF tail, run as one last chunk truncated to the quantum, in
    both packages."""
    env = {"CSDR_FIXED_BUFSIZE": bufsize}
    inp = (CF if kind == "c" else FL).tobytes()
    (rj, oj, ej), (rt, ot, et) = run_both(name, args, inp, env)
    assert rj == rt == 0, et
    assert len(ot) > 0
    assert_outputs_match(name, oj, ot)
    assert et == ej


def test_dynamic_bufsize_preamble_and_fallback():
    """CSDR_DYNAMIC_BUFSIZE_ON: a pump command reads the upstream preamble
    and sends its own, the same bytes as csdr_tpu's; relays pass theirs
    on; without a preamble both warn alike and fall back to 1024 (the 8
    bytes read stay consumed)."""
    env = {"CSDR_DYNAMIC_BUFSIZE_ON": "1"}
    x = (np.arange(5000, dtype=np.float32) / 5000)
    pre = b"csdr" + (3000).to_bytes(4, "little")
    for name, args, inp in (("gain_ff", ["3.0"], pre + x.tobytes()),
                            ("fir_decimate_cc", ["4"], pre + CF.tobytes()),
                            ("fastagc_ff", ["512"], pre + x.tobytes()),
                            ("clone", [], pre + x.tobytes()),
                            ("setbuf", ["8192"], pre + x.tobytes()),
                            ("gain_ff", ["2.0"], x.tobytes())):
        (rj, oj, ej), (rt, ot, et) = run_both(name, args, inp, env)
        assert rj == rt == 0, et
        assert ot[:8] == oj[:8], (name, ot[:8], oj[:8])
        assert ot[:4] == b"csdr"
        assert et == ej, (et, ej)
        if name == "gain_ff" and args == ["2.0"]:
            assert int.from_bytes(ot[4:8], "little") == 1024
            assert "Falling back to default buffer size: 1024" in et
            np.testing.assert_array_equal(np.frombuffer(ot[8:], np.float32),
                                          x[2:] * 2)
        elif name in ("gain_ff", "clone", "setbuf", "fastagc_ff"):
            assert_outputs_match("gain_ff", oj[8:], ot[8:])
        else:
            assert_outputs_match(name, oj[8:], ot[8:])


def _retune(name, args, inp, lines_at, first=None):
    """Both CLIs with ``--fd``: a control pipe per run, ``first`` written
    before the start (the reference blocks for it), each ``(byte, line)``
    of lines_at written just before the read of the chunk that starts at
    that byte.  Returns the two outputs."""
    outs = []
    for main, argv0, extra in ((jcli.main, "csdr_tpu", []),
                               (cli.main, "csdr_tpu_torch",
                                ["--device", "cpu"])):
        r, w = os.pipe()
        if first:
            os.write(w, first)
        todo = dict(lines_at)

        def hook(pos, todo=todo, w=w):
            if pos in todo:
                os.write(w, todo.pop(pos))

        try:
            rc, out, err = run_main(main, [argv0, name, "--fd", str(r)]
                                    + args + extra, inp, hook=hook)
        finally:
            os.close(r)
            os.close(w)
        assert rc == 0, err
        assert not todo, f"{name}: no read started at {list(todo)}"
        outs.append(out)
    return outs


def test_fd_retune_shift_addition_cc():
    """A retune between chunks (csdr_tpu's tests/test_cli_extra.py
    retunes through a FIFO): the port follows csdr_tpu; after the retune
    the output is a fresh run at the new rate on the rest of the input,
    up to the constant phase the NCO has reached."""
    n = 16384
    x = np.exp(2j * np.pi * 0.05 * np.arange(4 * n)).astype(np.complex64)
    env = {"CSDR_FIXED_BUFSIZE": str(n)}
    os.environ.update(env)
    try:
        oj, ot = _retune("shift_addition_cc", ["0.1"], x.tobytes(),
                         [(2 * n * 8, b"-0.2\n")])
    finally:
        del os.environ["CSDR_FIXED_BUFSIZE"]
    a, b = np.frombuffer(oj, np.complex64), np.frombuffer(ot, np.complex64)
    assert len(b) == 4 * n and snr_db(a, b) >= FLOAT_BAR
    _, fresh, _ = run_main(cli.main, ["x", "shift_addition_cc", "-0.2",
                                      "--device", "cpu"],
                           x[2 * n:].tobytes())
    fresh = np.frombuffer(fresh, np.complex64)
    after = b[2 * n:]
    rot = np.mean(after * np.conj(fresh))
    rot /= abs(rot)
    assert snr_db(fresh * rot, after) >= FLOAT_BAR
    assert abs(np.angle(np.mean(b[n: 2 * n] * np.conj(x[n: 2 * n]) *
                                np.exp(-2j * np.pi * 0.1 *
                                       np.arange(n, 2 * n))))) < 1e-3


def _after_retune_matches_fresh(out, fresh, skip=0):
    """The output after a retune against a fresh run at the new rate on
    the rest of the input, up to one constant phase (the NCO's)."""
    after, fresh = out[skip:], fresh[skip:]
    rot = np.mean(after * np.conj(fresh))
    rot /= abs(rot)
    return snr_db(fresh * rot, after)


def test_fd_retune_bandpass_fir_fft_cc():
    """--fd: the first band from the pipe, then a retune at a chunk
    boundary; the port replaces its taps spectra in place (no new block).
    After the retune, past the old band's overlap carry, the output is a
    fresh run at the new band."""
    from csdr_tpu_torch.ops import fftfilt
    ins = fftfilt.bandpass_fir_fft_block(0.0, 0.2, 0.05).input_size
    n = 8192 // ins * ins
    k = np.arange(6 * n)
    x = (np.exp(2j * np.pi * 0.1 * k) + np.exp(-2j * np.pi * 0.3 * k)
         ).astype(np.complex64)
    os.environ["CSDR_FIXED_BUFSIZE"] = "8192"
    try:
        oj, ot = _retune("bandpass_fir_fft_cc", ["0.05"], x.tobytes(),
                         [(3 * n * 8, b"-0.4 -0.2\n")], first=b"0.0 0.2\n")
    finally:
        del os.environ["CSDR_FIXED_BUFSIZE"]
    assert len(ot) == len(x) * 8
    assert_outputs_match("bandpass_fir_fft_cc", oj, ot)
    b = np.frombuffer(ot, np.complex64)
    # the +0.1 tone passes before the retune, the -0.3 tone after
    before, after = b[n: 3 * n], b[3 * n + 256:]
    for seg, f in ((before, 0.1), (after, -0.3)):
        spec = np.abs(np.fft.fft(seg))
        assert abs(np.fft.fftfreq(len(seg))[np.argmax(spec)] - f) < 1e-3
    _, fresh, _ = run_main(cli.main, ["x", "bandpass_fir_fft_cc", "-0.4",
                                      "-0.2", "0.05", "--device", "cpu"],
                           x[3 * n:].tobytes())
    fresh = np.frombuffer(fresh, np.complex64)
    assert snr_db(fresh[ins:], b[3 * n + ins:]) >= FLOAT_BAR


def test_fd_retune_fastddc_inv_cc():
    """fastddc_inv_cc --fd (csdr_tpu's tests/test_cli_extra.py:200-268):
    the rate from the pipe, a retune from +0.11 to -0.27 at a chunk
    boundary.  The port runs K4's factored inverse at D=16 (its plain
    version on the CPU) with the rows uploaded on a retune; csdr_tpu its
    dense dynamic inverse.  After the retune the output is a fresh run at
    the new rate, up to the NCO's phase."""
    from csdr_tpu_torch.ops import fastddc
    nf = 896 * 16
    k = np.arange(nf * 12)
    x = (np.exp(2j * np.pi * 0.11 * k) + np.exp(-2j * np.pi * 0.27 * k)
         ).astype(np.complex64)
    _, spec, _ = run_main(cli.main, ["x", "fastddc_fwd_cc", "16", "--device",
                                     "cpu"], x.tobytes())
    ddc = fastddc.fastddc_init(0.05, 16)
    frame = ddc.fft_size * 8
    chunk = 8192 // ddc.fft_size * frame
    assert len(spec) >= 4 * chunk
    os.environ["CSDR_FIXED_BUFSIZE"] = "8192"
    try:
        oj, ot = _retune("fastddc_inv_cc", ["16"], spec,
                         [(2 * chunk, b"0.27\n")], first=b"-0.11\n")
    finally:
        del os.environ["CSDR_FIXED_BUFSIZE"]
    assert len(ot) == len(oj) > 0
    assert_outputs_match("fastddc_inv_cc", oj, ot)
    b = np.frombuffer(ot, np.complex64)
    m = len(b) * (2 * chunk) // len(spec)
    for seg in (b[256: m], b[m + 256:]):
        s = np.abs(np.fft.fft(seg * np.hanning(len(seg))))
        assert abs(np.fft.fftfreq(len(seg))[np.argmax(s)]) < 0.02
    _, fresh, _ = run_main(cli.main, ["x", "fastddc_inv_cc", "0.27", "16",
                                      "--device", "cpu"], spec[2 * chunk:])
    fresh = np.frombuffer(fresh, np.complex64)
    assert len(fresh) == len(b) - m
    assert _after_retune_matches_fresh(b[m:], fresh) >= FLOAT_BAR


def test_costas_cli_on_bpsk_at_csdr_tpus_bars():
    """bpsk_costas_loop_cc on a BPSK signal with a carrier offset (the
    input of csdr_tpu's test_digital.py), through both CLIs: 32 dB over
    the first 256 samples, 28 dB over all."""
    rng = np.random.default_rng(4)
    bb = np.repeat(rng.integers(0, 2, 128) * 2.0 - 1.0, 32)
    x = (bb * np.exp(1j * (2 * np.pi * 0.001 * np.arange(len(bb)) + 0.3))
         ).astype(np.complex64)
    (rj, oj, ej), (rt, ot, et) = run_both("bpsk_costas_loop_cc", ["0.01"],
                                          x.tobytes())
    assert rj == rt == 0 and et == ej
    a, b = np.frombuffer(oj, np.complex64), np.frombuffer(ot, np.complex64)
    assert snr_db(a[:256], b[:256]) >= COSTAS_BARS[0]
    assert snr_db(a, b) >= COSTAS_BARS[1]


def test_awgn_cc_statistics():
    """The noise is another PRNG's (a torch.Generator a chunk): the same
    signal and noise powers as csdr_tpu's, the same stderr line."""
    x = np.exp(2j * np.pi * 0.05 * np.arange(60_000)).astype(np.complex64)
    (rj, oj, ej), (rt, ot, et) = run_both("awgn_cc", ["10"], x.tobytes())
    assert rj == rt == 0 and et == ej
    a, b = np.frombuffer(oj, np.complex64), np.frombuffer(ot, np.complex64)
    assert len(a) == len(b)
    r = 10 ** 0.5
    for y in (a, b):
        nz = y - x * r / (r + 1)
        np.testing.assert_allclose(np.mean(np.abs(nz) ** 2),
                                   2 * (0.707 / (r + 1)) ** 2, rtol=0.03)
        assert abs(np.mean(nz)) < 0.01
    np.testing.assert_allclose(np.mean(np.abs(b) ** 2),
                               np.mean(np.abs(a) ** 2), rtol=0.02)
    assert snr_db(a, b) < 40          # another draw, not csdr_tpu's noise


class _Full(Exception):
    pass


class _Sink:
    """stdout that stops an endless source after ``limit`` bytes."""

    def __init__(self, limit):
        self.buffer, self.parts, self.limit = self, [], limit

    def write(self, b):
        self.parts.append(bytes(b))
        if sum(map(len, self.parts)) >= self.limit:
            raise _Full

    def flush(self):
        pass


@pytest.mark.parametrize("name,dtype", [("uniform_noise_f", np.float32),
                                        ("gaussian_noise_c", np.complex64)])
def test_noise_sources_statistics(name, dtype):
    """The endless sources, stopped after 4 writes: uniform on [-1, 1),
    unit-variance complex gaussian per part, each write its own draw."""
    saved = sys.stdout
    sink = sys.stdout = _Sink(4 * 65536 * np.dtype(dtype).itemsize)
    try:
        with pytest.raises(_Full):
            cli.main(["x", name, "--device", "cpu"])
    finally:
        sys.stdout = saved
    y = np.frombuffer(b"".join(sink.parts), dtype)
    if dtype == np.float32:
        assert y.min() >= -1 and y.max() < 1
        assert abs(y.mean()) < 0.01 and abs(y.var() - 1 / 3) < 0.01
    else:
        for part in (y.real, y.imag):
            assert abs(part.mean()) < 0.01 and abs(part.var() - 1) < 0.02
    w = y.reshape(4, -1)
    assert not np.array_equal(w[0], w[1])


def test_without_cuda_a_command_exits_nonzero():
    """No CUDA (CUDA_VISIBLE_DEVICES empty hides any card) and no
    --device cpu: the command exits non-zero with resolve_device's
    message and writes nothing; with --device cpu it runs."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    x = np.ones(1000, np.float32).tobytes()
    p = subprocess.run([sys.executable, "-m", "csdr_tpu_torch.cli",
                        "gain_ff", "2.0"], input=x, capture_output=True,
                       cwd=ROOT, env=env, timeout=120)
    assert p.returncode != 0 and p.stdout == b""
    assert b"CUDA is not available" in p.stderr, p.stderr
    p = subprocess.run([sys.executable, "-m", "csdr_tpu_torch.cli",
                        "gain_ff", "2.0", "--device", "cpu"], input=x,
                       capture_output=True, cwd=ROOT, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    np.testing.assert_array_equal(np.frombuffer(p.stdout, np.float32), 2.0)


def test_cli_imports_no_jax():
    """csdr_tpu_torch.cli and python -m csdr_tpu_torch with jax and
    csdr_tpu made unimportable: the CLI imports and runs every command's
    module."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'csdr_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import io, numpy as np\n"
        "from csdr_tpu_torch import cli\n"
        "import csdr_tpu_torch.ops.mod, csdr_tpu_torch.ops.resamp\n"
        "x = np.arange(64, dtype=np.float32).tobytes()\n"
        "sys.stdin = io.TextIOWrapper(io.BytesIO(x))\n"
        "out = io.BytesIO()\n"
        "sys.stdout = io.TextIOWrapper(out, write_through=True)\n"
        "rc = cli.main(['x', 'fmmod_fc', '--device', 'cpu'])\n"
        "got = len(out.getvalue())\n"
        "sys.stdout = sys.__stdout__\n"
        "assert rc == 0 and got == 512, (rc, got)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'csdr_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    p = subprocess.run([sys.executable, "-m", "csdr_tpu_torch", "?fmmod"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.split() == ["fmmod_fc"]
