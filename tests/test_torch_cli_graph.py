"""The CLI's captured steps on the CPU: ``csdr_tpu_torch.cli.pump`` runs a
command's block as ``cli.STEP(block, graphs)`` (on the card a CUDA graph a
key, csdr_tpu's ``jax.jit(block.apply)``), and a command with a step of its
own (the fastddc inverse, the timing octave's block, fft_cc --octave,
fft_benchmark) makes it through the same seam.  Here the seam makes a
rehearsal (tests/torch_rehearsal.py): a CapturedStep on CPU tensors whose
stand-in graph re-runs the step on its static buffers with the host leaves
frozen at their capture values, as a CUDA graph replays its capture.

Over at least 6 chunks of a small CSDR_FIXED_BUFSIZE, each command's
rehearsed bytes equal the uncaptured port's (the seam giving the block
itself) bit for bit, and csdr_tpu's ``main`` at test_torch_cli.py's bars;
its steps capture each key once (a capture only of a key not seen, none
of the chunk's shape after the first lap of the key cycle): csdr-fm's
seven stages (path X), fastddc_inv_cc factored (D=16) and classed (D=50),
bandpass_fir_fft_cc, squelch_and_smeter_cc, agc_ff with and without an
attack wait, timing_recovery_cc, the ADPCM pair, fractional_decimator_ff at
5, at 2.4 and at a generic rate (which runs uncaptured).
fractional_decimator_ff 5 at the CLI's 65 536-sample chunk goes round 5
keys, each kept (the step's bound is its key cycle; MAX_GRAPHS is 4).
The shift family's NCO phase is a value leaf, so it keys on its rate only
and a retune makes one capture.  A --fd retune of fastddc_inv_cc rewrites
the rows and ``cyc`` in their storage (its ``data_ptr``s unchanged: the
rehearsal re-runs the body, which would also read a rebound closure, so
the storage itself is what shows that a CUDA graph sees the retune) and
makes no capture; a retune of bandpass_fir_fft_cc (taps copied into the
block's buffers) and of the squelch's level (a state leaf on the card,
copied into the graph's buffer) make none; each gives csdr_tpu's output.
The commands that csdr_tpu pumps unjitted make no step of the pump's, and
a pump's step is freed when the pump returns, without Python's cyclic
collector.  The card's own capture is held to the uncaptured command in
tests/test_torch_kernels.py (``cuda``) and chip_smoke.py's path X''.
"""

import gc
import os
import weakref

import numpy as np
import pytest
import torch

from csdr_tpu import cli as jcli

from csdr_tpu_torch import cli
from csdr_tpu_torch.core.graph import MAX_GRAPHS
from csdr_tpu_torch.ops import fastddc, fftfilt, resamp

from tests.test_torch_cli import _retune, assert_outputs_match, run_main
from tests.torch_rehearsal import Rehearsal
from tests.util import assert_snr

torch.set_num_threads(2)

FS = 2_400_000
CHUNKS = 6                 # chunks of each command's stdin, at least


class _Counted(Rehearsal):
    """A rehearsal that notes each call's input shape and whether the
    call captured."""

    def __init__(self, fn, like, max_graphs):
        super().__init__(fn, like, max_graphs)
        self.calls = []

    def __call__(self, state, x):
        before = self.captures
        out = super().__call__(state, x)
        self.calls.append((tuple(x.shape), self.captures > before))
        return out


class _Maker:
    """``cli.STEP`` that makes a rehearsal of each block at the pump's
    bound and keeps it; ``ptrs`` the storage of each block's ``rows``
    (the fastddc inverse's buffers) when its step was made."""

    def __init__(self):
        self.steps, self.ptrs = [], []

    def __call__(self, block, graphs=MAX_GRAPHS):
        self.steps.append(_Counted(block, block.init("meta"), graphs))
        self.ptrs.append([r.data_ptr() for r in getattr(block, "rows", ())])
        return self.steps[-1]


@pytest.fixture
def made(monkeypatch):
    maker = _Maker()
    monkeypatch.setattr(cli, "STEP", maker)
    return maker


def _port(argv, inp, env=None, hook=None) -> bytes:
    rc, out, err = run_main(cli.main, ["csdr_tpu_torch", *argv, "--device",
                                       "cpu"], inp, env, hook)
    assert rc == 0, err[-600:]
    return out


def _uncaptured(argv, inp, env=None) -> bytes:
    saved, cli.STEP = cli.STEP, lambda block, graphs: block
    try:
        return _port(argv, inp, env)
    finally:
        cli.STEP = saved


def _jax(argv, inp, env=None) -> bytes:
    rc, out, err = run_main(jcli.main, ["csdr_tpu", *argv], inp, env)
    assert rc == 0, err[-600:]
    return out


def _settled(step, what):
    """Each key captured once, and no capture of the stream's chunk shape
    after the first call that replayed (the first lap of its keys): a
    later capture is of another shape only, the EOF tail."""
    assert step.recaptures == 0, what
    assert step.captures == len(step.captured_keys) <= len(step.calls), what
    first = next((i for i, (_, cap) in enumerate(step.calls) if not cap),
                 len(step.calls))
    shape = step.calls[0][0]
    assert not any(cap and s == shape for s, cap in step.calls[first:]), \
        f"{what}: captured after the first lap"
    assert first < len(step.calls), f"{what}: never replayed"


def _check(name, args, inp, bufsize, made, bar=None):
    """``name`` rehearsed, uncaptured and by csdr_tpu on ``inp`` at
    ``bufsize``: the bytes bit for bit, csdr_tpu's at test_torch_cli's
    bars (at ``bar`` dB where given), and every step settled.  Returns the
    bytes."""
    env = {"CSDR_FIXED_BUFSIZE": str(bufsize)}
    argv = [name, *args]
    got = _port(argv, inp, env)
    assert len(got) > 0
    assert got == _uncaptured(argv, inp, env), name
    ref = _jax(argv, inp, env)
    if bar is None:
        assert_outputs_match(name, ref, got)
    else:
        assert_snr(np.frombuffer(ref, np.float32),
                   np.frombuffer(got, np.float32), bar, name)
    for step in made.steps:
        _settled(step, name)
    return got


# --------------------------------------------------------------------------
# path X: csdr-fm's seven stages
# --------------------------------------------------------------------------

X_STAGES = (["convert_u8_f"], ["shift_addition_cc", "-0.2"],
            ["fir_decimate_cc", "10", "0.05", "HAMMING"],
            ["fmdemod_quadri_cf"], ["fractional_decimator_ff", "5"],
            ["deemphasis_wfm_ff", "48000", "50e-6"], ["convert_f_s16"])
X_SAMPLES = CHUNKS * 10 * 1001 + 4321     # complex samples into stage 1
IN_BYTES = {"convert_u8_f": 1, "shift_addition_cc": 8, "fir_decimate_cc": 8,
            "fmdemod_quadri_cf": 8}       # the rest take float32


def _x_input() -> bytes:
    """An FM 1 kHz tone on a carrier at +0.2*fs as u8 I/Q."""
    n = np.arange(X_SAMPLES)
    phase = 2 * np.pi * (np.cumsum(0.5 * np.sin(2 * np.pi * 1000 * n / FS))
                         * 75_000 / FS + np.mod(0.2 * n, 1.0))
    iq = np.stack([np.cos(phase), np.sin(phase)], -1)
    return np.clip(np.round(127.5 + 127 * iq), 0, 255).astype(
        np.uint8).tobytes()


_X_INPUTS = []


def _x_inputs() -> list:
    """Each stage's stdin: the uncaptured port's stages chained."""
    if not _X_INPUTS:
        data = _x_input()
        for st in X_STAGES:
            _X_INPUTS.append(data)
            data = _uncaptured(st, data, {"CSDR_FIXED_BUFSIZE": str(
                len(data) // IN_BYTES.get(st[0], 4) // (CHUNKS + 1))})
    return _X_INPUTS


@pytest.mark.parametrize("stage", range(len(X_STAGES)))
def test_x_stage_rehearsed(made, stage):
    st = X_STAGES[stage]
    inp = _x_inputs()[stage]
    bufsize = len(inp) // IN_BYTES.get(st[0], 4) // (CHUNKS + 1)
    _check(st[0], st[1:], inp, bufsize, made)
    assert len(made.steps) == 1
    step = made.steps[0]
    assert len(step.calls) >= CHUNKS
    if st[0] == "shift_addition_cc":
        # the phase a value leaf, the rate a key leaf: one key a shape
        assert step._value_pos == frozenset({0})
        assert step.captures == len({s for s, _ in step.calls})
    if st[0] == "fractional_decimator_ff":
        blk = resamp.fractional_decimator_block(5.0)
        assert step.max_graphs == max(MAX_GRAPHS, blk.key_cycle(bufsize))


# --------------------------------------------------------------------------
# the kernel commands and the resamplers
# --------------------------------------------------------------------------

def _noise(n, seed, real=False):
    rng = np.random.default_rng(seed)
    if real:
        return (0.3 * rng.standard_normal(n)).astype(np.float32)
    return (0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _s16(n):
    t = np.arange(n) / 48_000
    return np.round(16000 * np.sin(2 * np.pi * 1000 * t)
                    + 300 * np.sin(2 * np.pi * 7000 * t)).astype(np.int16)


def _agc_in(n):
    """Bursts 40 dB apart, so the gain attacks, hangs and decays."""
    x = _noise(n, 21, real=True)
    x[: n // 3] *= 0.01
    x[2 * n // 3:] *= 0.01
    return x


# command -> (args, stdin, bar against csdr_tpu: None for test_torch_cli's)
COMMANDS = {
    "bandpass_fir_fft_cc": (["0.0", "0.2", "0.05"],
                            lambda: _noise(12_000, 20), None),
    "squelch_and_smeter_cc": (["1", "1"], lambda: _noise(7_000, 22), None),
    # the chunked relaxation at csdr_tpu's own AGC bar (tests/test_torch_
    # agc.py): over bursts 40 dB apart it rounds otherwise than the scan
    "agc_ff": ([], lambda: _agc_in(7_000), 80.0),
    "agc_ff attack wait": (["200", "0.2", "0.01", "0.0001", "65536", "5"],
                           lambda: _agc_in(7_000), None),
    "timing_recovery_cc": (["GARDNER", "8"], lambda: _noise(7_000, 23),
                           None),
    "encode_ima_adpcm_i16_u8": ([], lambda: _s16(7_000), None),
    "decode_ima_adpcm_u8_i16": (
        [], lambda: np.random.default_rng(24).integers(
            0, 256, 3_500).astype(np.uint8), None),
    "fractional_decimator_ff": (["5"], lambda: _noise(7_000, 25, True),
                                None),
    "fractional_decimator_ff 2.4": (["2.4"], lambda: _noise(7_000, 26, True),
                                    None),
}


@pytest.mark.parametrize("case", list(COMMANDS))
def test_command_rehearsed(made, case):
    name = case.split()[0]
    args, make, bar = COMMANDS[case]
    x = make()
    _check(name, args, x.tobytes(), len(x) // (CHUNKS + 1), made, bar)
    assert len(made.steps) == 1 and len(made.steps[0].calls) >= CHUNKS


def test_fractional_decimator_at_a_generic_rate_runs_uncaptured(made):
    """A rate neither integer nor rational: ``where`` need not come back,
    and the command declares its block uncaptured."""
    x = _noise(7_000, 27, True)
    _check("fractional_decimator_ff", ["2.7182818"], x.tobytes(), 1000,
           made)
    assert made.steps == []
    assert cli.STEPS[-1] == {"block": "fractional_decimator_ff",
                             "captured": False}


def test_fractional_decimator_settles_at_the_cli_chunk(made):
    """Rate 5 at the CLI's 65 536-sample chunk: occ goes round 14..18
    with ``where`` at 6, five keys after the first chunk's.  The pump
    keeps a graph for each (MAX_GRAPHS alone would drop one a chunk), so
    no key is captured twice: the start's, the five and the EOF tail's."""
    n = 1 << 16
    x = _noise(8 * n + 777, 28, True)
    got = _port(["fractional_decimator_ff", "5"], x.tobytes())
    step = made.steps[0]
    assert resamp.fractional_decimator_block(5.0).key_cycle(n) == 5
    assert step.max_graphs == 5 > MAX_GRAPHS
    _settled(step, "fractional_decimator_ff 5")
    assert step.captures == 7 and len(step.calls) == 9
    assert got == _uncaptured(["fractional_decimator_ff", "5"], x.tobytes())


@pytest.mark.parametrize("d", [16, 50])
def test_fastddc_inv_rehearsed(made, d):
    """The inverse's own step (csdr_tpu's jitted ``step_inv``), over the
    factored rows at D=16 and the classed G at D=50; the outer apply is
    the pump's, uncaptured."""
    ddc = fastddc.fastddc_init(0.05, d)
    frames = 8 * (CHUNKS + 1)
    x = _noise(ddc.input_size * frames, 29)
    spectra = _uncaptured(["fastddc_fwd_cc", str(d)], x.tobytes())
    made.steps.clear()
    q = ddc.post_decimation // np.gcd(ddc.post_input_size,
                                      ddc.post_decimation)
    n = len(spectra) // 8 // ddc.fft_size // (CHUNKS + 1) // q * q
    _check("fastddc_inv_cc", ["0.1", str(d)], spectra,
           max(q, n) * ddc.fft_size, made)
    assert [s.fn.name for s in made.steps] == ["ddcinv step"]
    assert cli.STEPS[-2]["block"] == "ddcinv" \
        and not cli.STEPS[-2]["captured"]


# --------------------------------------------------------------------------
# retunes
# --------------------------------------------------------------------------

def _retuned(name, args, inp, at, line, bufsize, first=None):
    """Both CLIs through test_torch_cli's _retune at ``bufsize``, the
    port's step rehearsed: their outputs at the bars; the port's bytes."""
    os.environ["CSDR_FIXED_BUFSIZE"] = str(bufsize)
    try:
        oj, ot = _retune(name, args, inp, [(at, line)], first)
    finally:
        del os.environ["CSDR_FIXED_BUFSIZE"]
    assert_outputs_match(name, oj, ot)
    return ot


def test_fastddc_inv_retune_rewrites_the_rows_in_place(made):
    """--fd: the rate from the pipe, a retune at the third chunk: csdr_
    tpu's output after it, no capture at the retune, and the rows and
    ``cyc`` the graph reads in the storage they had."""
    ddc = fastddc.fastddc_init(0.05, 16)
    k = np.arange(ddc.input_size * 8 * (CHUNKS + 1))
    x = (np.exp(2j * np.pi * 0.11 * k) + np.exp(-2j * np.pi * 0.27 * k)
         ).astype(np.complex64)
    spectra = _uncaptured(["fastddc_fwd_cc", "16"], x.tobytes())
    made.steps.clear()
    chunk = 8 * ddc.fft_size
    _retuned("fastddc_inv_cc", ["16"], spectra, 3 * chunk * 8, b"0.27\n",
             chunk, first=b"-0.11\n")
    step, = made.steps
    _settled(step, "fastddc_inv_cc retune")
    assert step.captures == 1
    assert [r.data_ptr() for r in step.fn.rows] == made.ptrs[0]
    assert len(made.ptrs[0]) == 3


def test_bandpass_retune_copies_the_taps_in(made):
    """--fd: the first band from the pipe, a retune at the fourth chunk:
    csdr_tpu's output, no capture at the retune."""
    ins = fftfilt.bandpass_fir_fft_block(0.0, 0.2, 0.05).input_size
    n = 4 * ins
    k = np.arange((CHUNKS + 2) * n)
    x = (np.exp(2j * np.pi * 0.1 * k) + np.exp(-2j * np.pi * 0.3 * k)
         ).astype(np.complex64)
    _retuned("bandpass_fir_fft_cc", ["0.05"], x.tobytes(), 4 * n * 8,
             b"-0.4 -0.2\n", n, first=b"0.0 0.2\n")
    step, = made.steps
    _settled(step, "bandpass retune")
    assert step.captures == 1


def test_squelch_retune_copies_the_level_in(made):
    """--fd: the level replaced between chunks (a new tensor in the state
    the last chunk returned, copied into the graph's buffer): csdr_tpu's
    output, the quiet chunks closed after the retune, no capture."""
    n = 1000
    x = _noise((CHUNKS + 2) * n, 30)
    x.reshape(-1, n)[1::2] *= 0.1
    out = _retuned("squelch_and_smeter_cc", ["1", "1"], x.tobytes(),
                   4 * n * 8, b"0.002\n", n)
    y = np.frombuffer(out, np.complex64).reshape(-1, n)
    assert np.all(y[5::2] == 0) and np.all(y[4::2] != 0)
    assert np.all(y[:4] != 0)
    step, = made.steps
    _settled(step, "squelch retune")
    assert step.captures == 1


def test_shift_retune_makes_one_capture(made):
    """The rate is the shift's key leaf: a retune is one capture, the
    phase (a value leaf) none."""
    n = 1024
    x = _noise((CHUNKS + 2) * n, 31)
    _retuned("shift_addition_cc", ["0.1"], x.tobytes(), 4 * n * 8,
             b"-0.2\n", n)
    step, = made.steps
    assert step.recaptures == 0 and len(step.captured_keys) == 2
    assert [i for i, (_, cap) in enumerate(step.calls) if cap] == [0, 4]
    assert step._value_pos == frozenset({0})


# --------------------------------------------------------------------------
# what runs uncaptured, and what is freed
# --------------------------------------------------------------------------

UNCAPTURED = {          # command -> (args, stdin, steps of its own)
    "clipdetect_ff": ([], _noise(4000, 32, True).tobytes() * 3, []),
    "detect_nan_ff": ([], _noise(4000, 33, True).tobytes(), []),
    "awgn_cc": (["10"], _noise(4000, 34).tobytes(), []),
    "fastddc_inv_cc": (["0.1", "16"], None, ["ddcinv step"]),
    "timing_recovery_cc": (["GARDNER", "8", "--octave", "1"],
                           _noise(4000, 35).tobytes(),
                           ["timing_recovery_cc"]),
}


@pytest.mark.parametrize("name", list(UNCAPTURED))
def test_uncaptured_commands_make_no_pump_step(made, name):
    """The five commands csdr_tpu pumps unjitted: the pump makes no step
    (its row uncaptured); the fastddc inverse and the timing octave make
    their inner step through the seam, as csdr_tpu jits theirs."""
    args, inp, own = UNCAPTURED[name]
    if inp is None:
        inp = _uncaptured(["fastddc_fwd_cc", "16"],
                          _noise(fastddc.fastddc_init(0.05, 16).input_size
                                 * 24, 36).tobytes())
        made.steps.clear()
    cli.STEPS.clear()
    _port([name, *args], inp, {"CSDR_FIXED_BUFSIZE": "1000"})
    assert [s.fn.name for s in made.steps] == own
    pumped = [r for r in cli.STEPS if r["block"] not in own]
    assert len(pumped) == 1 and not pumped[0]["captured"]


class _Forgets:
    """What a CUDA graph keeps of a capture: its outputs, not the body
    (the rehearsal's stand-in keeps the body to run it again)."""

    def capture(self, body):
        self.out = body()
        return self.out

    def replay(self):
        return self.out


@pytest.mark.parametrize("argv", [["fir_decimate_cc", "4"],
                                  ["shift_addition_cc", "0.1"],
                                  ["fastddc_inv_cc", "0.1", "16"]])
def test_a_pump_step_is_freed_when_the_pump_returns(monkeypatch, argv):
    """Every step made through the seam, its graphs and its block, gone
    when the command returns, with the cyclic collector off: a graph left
    to that collector can be destroyed in the middle of another capture
    (about 100 commands run captured in one process in chip_smoke.py)."""
    if argv[0] == "fastddc_inv_cc":
        inp = _uncaptured(["fastddc_fwd_cc", "16"],
                          _noise(fastddc.fastddc_init(0.05, 16).input_size
                                 * 24, 37).tobytes())
    else:
        inp = _noise(6000, 38).tobytes()
    refs = []

    def make(block, graphs=MAX_GRAPHS):
        step = Rehearsal(block, block.init("meta"), graphs)
        step._new_graph = _Forgets
        refs.extend(weakref.ref(o) for o in (step, block))
        return step

    monkeypatch.setattr(cli, "STEP", make)
    collecting = gc.isenabled()
    gc.disable()
    try:
        _port(argv, inp, {"CSDR_FIXED_BUFSIZE": "1000"})
        assert cli.STEPS[-1]["captures"] >= 1
        assert refs and [r() for r in refs] == [None] * len(refs)
    finally:
        if collecting:
            gc.enable()
