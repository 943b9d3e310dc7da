"""csdr-compatible CLI on the card (counterpart of csdr_tpu.cli): the same
command names, parameters, wire formats and stderr lines, raw samples on
stdin and stdout, so that shell pipes of these processes form the
flowgraph as they do with csdr (reference dispatcher csdr.c:419-3631).

Every command maps to a Block.  The stream pump reads stdin into the
block's chunk quantum, uploads the raw wire bytes to the device as their
own dtype (float32, u8, s8, s16), runs the block there (the converters of
``ops/convert`` included) with its state carried, and copies back only the
output in its wire dtype.  ``CSDR_FIXED_BUFSIZE`` sets the chunk (65 536
samples by default); ``CSDR_DYNAMIC_BUFSIZE_ON`` reads and sends csdr's
8-byte ``csdr``+int32 preamble; ``--fifo <path>`` or ``--fd <fd>`` retunes
shift, bandpass, squelch and the fastddc inverse between chunks
(csdr.c:252-323).

Device: ``--device cuda|cpu``, stripped from the arguments like ``--fifo``;
CUDA by default (``core/block.resolve_device``).  Without CUDA a command
exits non-zero with that message unless it is given ``--device cpu``; it
never carries on on the CPU.  The pump checks that every chunk's output
lies on the command's device before it copies it back, so a block that
quietly computes on the host fails on the card.

Host-only commands, which carry no device tensors, as csdr_tpu runs them
on the host: ``tee``, ``fifo``, ``flowcontrol``, ``through``, ``clone``,
``REM``, ``setbuf``, the dumps (``dump_f``, ``floatdump_f``,
``dump_u8``), ``yes_f``, ``repeat_u8``, ``none``,
``add_n_zero_samples_at_beginning_f``, ``convert_f_samplerf``, the
``firdes_*`` tap dumps, ``octave_complex_c``, ``_fft2octave``,
``psk31_varicode_encoder_u8_u8``, ``serial_line_decoder_f_u8``,
``pattern_search_u8_u8``, ``syncword_search`` and
``old_fractional_decimator_ff``.

Usage:  python -m csdr_tpu_torch.cli <command> [params...] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np
import torch

from csdr_tpu_torch.core.block import (Block, VarOut, resolve_device,
                                       stateless)
from csdr_tpu_torch.core.graph import MAX_GRAPHS, CapturedStep, carried_value

USAGE_NOTE = """csdr_tpu_torch — csdr-compatible DSP tool on CUDA (the PyTorch port of csdr_tpu).
usage: python -m csdr_tpu_torch.cli <command> [params] [--device cuda|cpu]  (see `?<text>` to search)
  --device: where the command runs, cuda (the default) or cpu
"""

# commands that carry no device tensors (the module docstring's list)
HOST_ONLY = frozenset("""tee fifo flowcontrol through clone REM setbuf dump_f
floatdump_f dump_u8 yes_f repeat_u8 none add_n_zero_samples_at_beginning_f
convert_f_samplerf firdes_lowpass_f firdes_bandpass_c
firdes_pulse_shaping_filter_f firdes_peak_c octave_complex_c _fft2octave
psk31_varicode_encoder_u8_u8 serial_line_decoder_f_u8 pattern_search_u8_u8
syncword_search old_fractional_decimator_ff""".split())

# the running command: its name (csdr_tpu reads sys.argv[1]) and device
_RUN = {"cmd": "csdr_tpu_torch", "device": torch.device("cpu")}
# chunks whose output the pump found on the command's device
PUMP_CHECKS = {"chunks": 0}


# how the pump, and a command with a step of its own, make that step from
# a block: ``STEP(block, graphs)``, by default one CUDA graph a key,
# captured on the key's first chunk and replayed after, at most ``graphs``
# kept (csdr_tpu's ``jax.jit(block.apply)``; on CPU tensors the block
# itself).  Code in this process may put another maker here (the block
# itself, to run it uncaptured on the card; a CPU rehearsal of the
# capture).
STEP = CapturedStep
# what each step made through STEP did, noted when its command is done
# with it: the block's name, whether it was captured and, if so, its
# captures, replays, keys captured and recaptures (core/graph)
STEPS: list = []


def _note(step, block) -> None:
    row = {"block": block.name, "captured": isinstance(step, CapturedStep)}
    if row["captured"]:
        row.update(captures=step.captures, replays=step.replays,
                   keys=len(step.captured_keys), recaptures=step.recaptures,
                   max_graphs=step.max_graphs)
    STEPS.append(row)


def _cmd() -> str:
    return _RUN["cmd"]


def _dev() -> torch.device:
    return _RUN["device"]


def _env_bufsize(default: int = 1 << 16) -> int:
    v = os.environ.get("CSDR_FIXED_BUFSIZE")
    return int(v) if v else default


def _dynamic_bufsize_on() -> bool:
    return os.environ.get("CSDR_DYNAMIC_BUFSIZE_ON", "") not in ("", "0")


def getbufsize() -> int:
    """Read the 8-byte dynamic-bufsize preamble "csdr"+int32 from stdin
    (reference csdr.c:330-356, README.md:1407-1446).

    On a mismatch: warn, fall back to the default 1024, and the 8 bytes
    read stay consumed (the reference fread()s them and never pushes
    back)."""
    pre = sys.stdin.buffer.read(8)
    if len(pre) < 8 or pre[:4] != b"csdr":
        sys.stderr.write(
            f"{_cmd()}: warning! "
            "Did not match preamble on the beginning of the stream. You "
            "should put \"csdr setbuf <buffer size>\" at the beginning of "
            "the chain! Falling back to default buffer size: 1024\n")
        return 1024
    n = int.from_bytes(pre[4:], "little", signed=True)
    if n <= 0:
        sys.stderr.write(f"{_cmd()}: warning! Invalid buffer size.\n")
        return 0
    if os.environ.get("CSDR_PRINT_BUFSIZES"):
        sys.stderr.write(f"{_cmd()}: getbufsize = {n}\n")
    return n


def sendbufsize(n: int):
    """Write the preamble announcing our output chunk size downstream
    (reference sendbufsize, csdr.c:358-376)."""
    sys.stdout.buffer.write(b"csdr" + int(n).to_bytes(4, "little",
                                                      signed=True))
    sys.stdout.buffer.flush()
    if os.environ.get("CSDR_PRINT_BUFSIZES"):
        sys.stderr.write(f"{_cmd()}: sendbufsize = {n}\n")


# ---------------------------------------------------------------------------
# wire formats
# ---------------------------------------------------------------------------

class Fmt:
    """A sample wire format (reference naming: README.md:126-153).

    to_dev(raw numpy array of the wire dtype, device) -> tensor there;
    to_wire(tensor) -> tensor of the wire dtype on the same device, flat;
    the pump copies only that to the host."""

    def __init__(self, name, dtype, per_sample, to_dev, to_wire):
        self.name = name
        self.dtype = dtype
        self.per_sample = per_sample  # wire items per logical sample
        self.to_dev = to_dev
        self.to_wire = to_wire


def _upload(raw: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(raw)).to(dev)


def _mk_fmts():
    from csdr_tpu_torch.ops import convert

    def cf_in(raw, dev):      # interleaved float pairs -> complex64
        return convert.interleaved_to_cf(_upload(raw, dev))

    def cf_out(y):
        return convert.cf_to_interleaved(y)

    def as_type(dtype):
        return lambda y: y.reshape(-1).to(dtype)

    return {
        "c": Fmt("c", np.float32, 2, cf_in, cf_out),
        "f": Fmt("f", np.float32, 1, _upload, as_type(torch.float32)),
        "u8": Fmt("u8", np.uint8, 1, _upload, as_type(torch.uint8)),
        "s8": Fmt("s8", np.int8, 1, _upload, as_type(torch.int8)),
        "s16": Fmt("s16", np.int16, 1, _upload, as_type(torch.int16)),
        # int32 on the device, the same bytes read as uint32 on the host
        "u32": Fmt("u32", np.uint32, 1, _upload, as_type(torch.int32)),
    }


# ---------------------------------------------------------------------------
# FIFO control plane (reference init_fifo/read_fifo_ctl, csdr.c:252-323)
# ---------------------------------------------------------------------------

class FifoCtl:
    def __init__(self, argv):
        self.fd = None
        self.buf = b""
        if "--fifo" in argv:
            path = argv[argv.index("--fifo") + 1]
            self.fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
        elif "--fd" in argv:
            self.fd = int(argv[argv.index("--fd") + 1])
            os.set_blocking(self.fd, False)

    def poll(self):
        """The latest complete text line, or None."""
        if self.fd is None:
            return None
        try:
            r, _, _ = select.select([self.fd], [], [], 0)
            if r:
                self.buf += os.read(self.fd, 1024)
        except OSError:
            return None
        if b"\n" in self.buf:
            *lines, rest = self.buf.split(b"\n")
            self.buf = rest
            return lines[-1].decode()
        return None

    def wait_first(self):
        """Block until the first command line arrives (the reference
        blocks at startup when --fifo is given, csdr.c:1819-1821)."""
        while True:
            line = self.poll()
            if line:
                return line
            time.sleep(0.01)


CTL_FLAGS = ("--fifo", "--fd", "--device")


def strip_ctl_args(argv):
    """argv without the control flags and their values: --fifo, --fd and
    --device."""
    out = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in CTL_FLAGS:
            skip = True
            continue
        out.append(a)
    return out


def _take_device(args):
    """(device name, args without --device and its value)."""
    if "--device" not in args:
        return "cuda", args
    i = args.index("--device")
    if i + 1 >= len(args):
        raise SystemExit("--device needs a value: cuda or cpu")
    name = args[i + 1]
    if name not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: want cuda or cpu")
    return name, args[:i] + args[i + 2:]


# ---------------------------------------------------------------------------
# stream pump
# ---------------------------------------------------------------------------

class FnBlock(Block):
    """A block from two functions: ``init(device)`` and ``apply(state, x)``
    (csdr_tpu's ``Block(name, init, apply)``)."""

    def __init__(self, name: str, init, apply):
        super().__init__(name)
        self.init_fn, self.apply_fn = init, apply

    def init(self, device="cuda"):
        return self.init_fn(resolve_device(device))

    def forward(self, state, x):
        return self.apply_fn(state, x)


def _concrete(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _on(y: torch.Tensor, dev: torch.device, block) -> torch.Tensor:
    if not isinstance(y, torch.Tensor) or y.device != dev:
        where = y.device if isinstance(y, torch.Tensor) else type(y).__name__
        raise RuntimeError(f"{_cmd()}: block '{block.name}' gave its output "
                           f"on {where}, not on {dev}")
    PUMP_CHECKS["chunks"] += 1
    return y


def pump(block, in_fmt: str, out_fmt: str, quantum: int = 1,
         chunk: int | None = None, on_chunk=None, drop_warmup_out: int = 0,
         device=None, jit: bool = True):
    """The fread -> block -> fwrite loop.  quantum: a chunk is a multiple
    of it (decimations, frame sizes); chunk pins the chunk size (the
    preamble is still read); on_chunk(state) -> state applies FIFO
    retunes before the chunk just read; drop_warmup_out drops that many
    leading output samples, so a FIR block's zero-history warmup does not
    reach the wire and the stream aligns with the reference's valid-mode
    output (csdr_tpu's pump, cli.py:172-245).  device: the command's
    device unless a host-only command names the CPU.

    jit: the block runs as ``STEP(block, graphs)``, on the card one CUDA
    graph replay a chunk, as csdr_tpu's pump runs ``jax.jit(block.apply)``,
    ``graphs`` MAX_GRAPHS or the block's ``key_cycle(n)`` where it has one
    and that is more; a command whose apply has a host
    effect a chunk (a host read, a fresh generator) passes False, as
    csdr_tpu's does.  The state the step returns is passed to its next
    call, which owns it (donated); an on_chunk retune that replaces a
    leaf has it copied into the graph's buffers.  The step, and its
    graphs with it, are dropped when the pump returns.

    At EOF the tail is run as one shorter chunk, truncated to the quantum,
    as the reference processes its last short fread.  A VarOut's count is
    read once a chunk (the one host sync the pump adds), then only the
    valid samples, in the wire dtype, come back to the host."""
    fmts = _mk_fmts()
    fi, fo = fmts[in_fmt], fmts[out_fmt]
    dev = _concrete(torch.device(_dev() if device is None else device))
    n = chunk or _env_bufsize()
    if _dynamic_bufsize_on():
        # adopt the upstream chunk size, announce ours downstream; a
        # pinned chunk (fastdcblock, fastagc own their block size,
        # csdr.c:952-968) still consumes the upstream preamble
        up = getbufsize()
        if not chunk:
            n = max(up, quantum)
    n = max(quantum, (n // quantum) * quantum)
    if _dynamic_bufsize_on():
        sendbufsize(n)
    block = block.to(dev)
    graphs = MAX_GRAPHS
    if jit and hasattr(block, "key_cycle"):
        # a block whose key leaves go round a cycle at a chunk length
        # (the fractional decimator) keeps a graph for each key of it
        graphs = max(graphs, block.key_cycle(n) or 0)
    step = STEP(block, graphs) if jit else block
    state = block.init(dev)
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    bytes_per = np.dtype(fi.dtype).itemsize * fi.per_sample
    pending = b""
    eof = False
    try:
        with torch.no_grad():
            while not eof:
                data = stdin.read(n * bytes_per - len(pending))
                pending += data or b""
                if len(pending) < n * bytes_per:
                    eof = True
                    nlast = (len(pending) // bytes_per // quantum) * quantum
                    if nlast == 0:
                        break
                    raw = np.frombuffer(pending[: nlast * bytes_per], fi.dtype)
                else:
                    raw = np.frombuffer(pending[: n * bytes_per], fi.dtype)
                pending = b""
                x = fi.to_dev(raw, dev)
                if on_chunk is not None:
                    state = on_chunk(state)
                state, y = step(state, x)
                if isinstance(y, VarOut):
                    data_d = _on(y.data, dev, block)
                    y = data_d[..., : int(y.count)]
                out = fo.to_wire(_on(y, dev, block)).cpu().numpy()
                if out_fmt == "u32":
                    out = out.view(np.uint32)
                if drop_warmup_out:
                    k = min(drop_warmup_out * fo.per_sample, len(out))
                    out = out[k:]
                    drop_warmup_out -= k // fo.per_sample
                stdout.write(out.tobytes())
                stdout.flush()
    finally:
        _note(step, block)


def _stateless_pump(fn, in_fmt, out_fmt, quantum=1, chunk=None):
    pump(stateless("cmd", fn), in_fmt, out_fmt, quantum, chunk)


# ---------------------------------------------------------------------------
# command implementations
# ---------------------------------------------------------------------------

def main(argv=None):
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 2:
        sys.stderr.write(USAGE_NOTE)
        return 1
    cmd = argv[1]
    args = argv[2:]

    if cmd.startswith("="):
        # python calculator (reference csdr.c:3622-3628)
        from math import pi, sin, cos, log10, sqrt  # noqa: F401
        print(eval(cmd[1:] + "".join(argv[2:])))
        return 0
    if cmd.startswith("??"):
        # docs lookup (reference csdr.c:3604-3612 opens the README anchor)
        pat = cmd[2:]
        hits = [n for n in sorted(REGISTRY) if pat in n]
        if hits:
            print("https://github.com/ha7ilm/csdr/blob/master/README.md#"
                  + hits[0])
        return 0
    if cmd.startswith("?"):
        pat = cmd[1:]
        for name in sorted(REGISTRY):
            if pat in name:
                print(name)
        return 0

    handler = REGISTRY.get(cmd)
    if handler is None:
        sys.stderr.write(f"csdr_tpu_torch: unknown command {cmd}\n"
                         f"{USAGE_NOTE}")
        return 1
    _RUN["cmd"] = cmd
    try:
        name, args = _take_device(args)
        if cmd != "--help":
            try:
                _RUN["device"] = resolve_device(name)
            except RuntimeError as e:
                sys.stderr.write(f"csdr_tpu_torch {cmd}: {e} (on the "
                                 "command line: --device cpu)\n")
                return 1
        return handler(args) or 0
    except SystemExit as e:
        # bad invocation: print the error AND this command's syntax
        # (reference csdr.c prints the usage[] entry on badsyntax)
        if e.code not in (0, None):
            msg = e.code if isinstance(e.code, str) else ""
            if msg:
                sys.stderr.write(f"csdr_tpu_torch {cmd}: {msg}\n")
            sys.stderr.write(usage_for(cmd))
            return 1
        return 0
    except (IndexError, ValueError) as e:
        sys.stderr.write(f"csdr_tpu_torch {cmd}: bad parameters ({e})\n")
        sys.stderr.write(usage_for(cmd))
        return 1


def _f(args, i, default=None):
    if len(args) <= i:
        if default is None:
            raise SystemExit("missing required parameter")
        return default
    return float(args[i])


def _i(args, i, default=None):
    if len(args) <= i:
        if default is None:
            raise SystemExit("missing required parameter")
        return default
    return int(args[i])


def _window(args, i):
    from csdr_tpu_torch import firdes
    return args[i].upper() if len(args) > i and not args[i].startswith("--") \
        else firdes.WINDOW_DEFAULT


def _precision(args):
    """--precision default|high|highest, on the port's precision contract
    (ops/fir.py): highest (the default) and high are float32 FMA on the
    card, where csdr_tpu's high is bf16x3; default, csdr_tpu's raw bf16,
    is float32 FMA here too."""
    if "--precision" in args:
        i = args.index("--precision")
        name = args[i + 1].upper()
        del args[i: i + 2]          # strip so positional parsing is clean
        if name not in ("DEFAULT", "HIGH", "HIGHEST"):
            raise ValueError(f"--precision {name.lower()}: want default, "
                             "high or highest")
        return "HIGH" if name == "DEFAULT" else name
    return "HIGHEST"


REGISTRY = {}

# Per-command usage syntax (reference csdr.c:56-181 `usage[]`); <> =
# required, [] = optional.  Every command also takes --device cuda|cpu.
_PREC = ("[--precision default|high|highest]  (highest and high: float32 "
         "FMA on the card; default: float32 FMA too)")
USAGE = {
    "convert_u8_f": "convert_u8_f",
    "convert_f_u8": "convert_f_u8",
    "convert_s8_f": "convert_s8_f",
    "convert_f_s8": "convert_f_s8",
    "convert_s16_f": "convert_s16_f",
    "convert_f_s16": "convert_f_s16",
    "convert_s24_f": "convert_s24_f [--bigendian]",
    "convert_f_s24": "convert_f_s24 [--bigendian]",
    "realpart_cf": "realpart_cf",
    "mono2stereo_s16": "mono2stereo_s16",
    "stereo2mono_s16": "stereo2mono_s16",
    "none": "none",
    "flowcontrol": "flowcontrol <data_rate> <reads_per_second>",
    "clone": "clone",
    "REM": "REM [comment...]",
    "through": "through",
    "dump_f": "dump_f",
    "dump_u8": "dump_u8",
    "setbuf": "setbuf <bufsize>",
    "yes_f": "yes_f <to_repeat> [buf_times]",
    "repeat_u8": "repeat_u8 <data_bytes...>",
    "gain_ff": "gain_ff <gain>",
    "limit_ff": "limit_ff [max_amplitude]",
    "clipdetect_ff": "clipdetect_ff",
    "detect_nan_ff": "detect_nan_ff",
    "dcblock_ff": "dcblock_ff",
    "fastdcblock_ff": "fastdcblock_ff [block_size]",
    "add_n_zero_samples_at_beginning_f":
        "add_n_zero_samples_at_beginning_f <n_zero_samples>",
    "add_const_cc": "add_const_cc <i> <q>",
    "shift_math_cc": "shift_math_cc [--fifo <fifo_path>|--fd <fd>] <rate>",
    "shift_addition_cc":
        "shift_addition_cc [--fifo <fifo_path>|--fd <fd>] <rate>",
    "shift_table_cc": "shift_table_cc <rate> [table_size]",
    "shift_addfast_cc": "shift_addfast_cc <rate>",
    "shift_unroll_cc": "shift_unroll_cc <rate>",
    "decimating_shift_addition_cc":
        "decimating_shift_addition_cc <rate> [decimation]",
    "fir_decimate_cc":
        "fir_decimate_cc <decimation_factor> [transition_bw [window]] "
        + _PREC,
    "fir_interpolate_cc":
        "fir_interpolate_cc <interpolation_factor> [transition_bw [window]] "
        + _PREC,
    "rational_resampler_ff":
        "rational_resampler_ff <interpolation> <decimation> "
        "[transition_bw [window]] " + _PREC,
    "fractional_decimator_ff":
        "fractional_decimator_ff <decimation_rate> [num_poly_points "
        "[transition_bw [window]]]",
    "bandpass_fir_fft_cc":
        "bandpass_fir_fft_cc [--fifo <fifo_path>|--fd <fd>] <low_cut> "
        "<high_cut> <transition_bw> [window]",
    "peaks_fir_cc": "peaks_fir_cc <taps_length> <peak_rate...>",
    "pulse_shaping_filter_cc":
        "pulse_shaping_filter_cc (RRC <samples_per_symbol> <num_taps> <beta> "
        "| COSINE <samples_per_symbol>)",
    "firdes_lowpass_f":
        "firdes_lowpass_f <cutoff_rate> <length> [window [--octave]]",
    "firdes_bandpass_c":
        "firdes_bandpass_c <low_cut> <high_cut> <length> [window [--octave]]",
    "firdes_pulse_shaping_filter_f":
        "firdes_pulse_shaping_filter_f (RRC <samples_per_symbol> <num_taps> "
        "<beta> | COSINE <samples_per_symbol>) [--octave]",
    "fmdemod_quadri_cf": "fmdemod_quadri_cf",
    "fmdemod_quadri_novect_cf": "fmdemod_quadri_novect_cf",
    "fmdemod_atan_cf": "fmdemod_atan_cf",
    "amdemod_cf": "amdemod_cf",
    "amdemod_estimator_cf": "amdemod_estimator_cf",
    "deemphasis_wfm_ff": "deemphasis_wfm_ff <sample_rate> <tau>",
    "deemphasis_nfm_ff": "deemphasis_nfm_ff <one_of_the_predefined_rates>",
    "fmmod_fc": "fmmod_fc",
    "dsb_fc": "dsb_fc [q_value]",
    "add_dcoffset_cc": "add_dcoffset_cc",
    "fixed_amplitude_cc": "fixed_amplitude_cc <new_amplitude>",
    "convert_f_samplerf": "convert_f_samplerf <wait_for_this_sample>",
    "agc_ff":
        "agc_ff [hang_time [reference [attack_rate [decay_rate [max_gain "
        "[attack_wait [filter_alpha]]]]]]]  (--reference/--attack/--decay/"
        "--max/--hangtime/--attackwait/--filteralpha also accepted; an "
        "attack_wait > 0 runs the exact per-sample scan)",
    "fastagc_ff": "fastagc_ff [block_size [reference]]",
    "simple_agc_cc": "simple_agc_cc <rate> [reference]",
    "squelch_and_smeter_cc":
        "squelch_and_smeter_cc --fifo <squelch_fifo> --outfifo <smeter_fifo> "
        "<use_every_nth> <report_every_nth>",
    "fft_cc":
        "fft_cc <fft_size> <out_of_every_n_samples> [window [--octave] "
        "[--benchmark]]",
    "fft_fc":
        "fft_fc <fft_size> <out_of_every_n_samples> [window [--benchmark]]",
    "logpower_cf": "logpower_cf [add_db]",
    "logaveragepower_cf": "logaveragepower_cf <add_db> <fft_size> <avgnumber>",
    "fft_exchange_sides_ff": "fft_exchange_sides_ff <fft_size>",
    "fft_one_side_ff": "fft_one_side_ff <fft_size>",
    "compress_fft_adpcm_f_u8": "compress_fft_adpcm_f_u8 <fft_size>",
    "encode_ima_adpcm_i16_u8": "encode_ima_adpcm_i16_u8",
    "decode_ima_adpcm_u8_i16": "decode_ima_adpcm_u8_i16",
    "fft_benchmark": "fft_benchmark <fft_size> <fft_cycles>",
    "fastddc_fwd_cc": "fastddc_fwd_cc <decimation> [transition_bw [window]]",
    "fastddc_inv_cc":
        "fastddc_inv_cc [--fifo <fifo_path>|--fd <fd>] <shift_rate> "
        "<decimation> [transition_bw [window]]",
    "psk31_varicode_encoder_u8_u8": "psk31_varicode_encoder_u8_u8",
    "psk31_varicode_decoder_u8_u8": "psk31_varicode_decoder_u8_u8",
    "differential_encoder_u8_u8": "differential_encoder_u8_u8",
    "differential_decoder_u8_u8": "differential_decoder_u8_u8",
    "psk_modulator_u8_c": "psk_modulator_u8_c <n_psk>",
    "psk31_interpolate_sine_cc": "psk31_interpolate_sine_cc <interpolation>",
    "duplicate_samples_ntimes_u8_u8":
        "duplicate_samples_ntimes_u8_u8 <sample_size_bytes> <ntimes>",
    "pack_bits_1to8_u8_u8": "pack_bits_1to8_u8_u8",
    "pack_bits_8to1_u8_u8": "pack_bits_8to1_u8_u8",
    "invert_u8_u8": "invert_u8_u8",
    "binary_slicer_f_u8": "binary_slicer_f_u8",
    "generic_slicer_f_u8": "generic_slicer_f_u8 <n_symbols>",
    "dbpsk_decoder_c_u8": "dbpsk_decoder_c_u8",
    "bfsk_demod_cf": "bfsk_demod_cf <spacing> <filter_length>",
    "timing_recovery_cc":
        "timing_recovery_cc (GARDNER|EARLYLATE) <decimation> [loop_gain "
        "[max_error]] [--add_q] [--output_error|--output_indexes] "
        "[--octave <show_every_nth>] [--octave_save <path_prefix>] "
        "[--segments <n>]",
    "bpsk_costas_loop_cc":
        "bpsk_costas_loop_cc [loop_bandwidth [damping_factor]] [--dd]",
    "pll_cc": "pll_cc (1 [alpha] | 2 [bandwidth]) [--nco]",
    "normalized_timing_variance_u32_f":
        "normalized_timing_variance_u32_f <samples_per_symbol> "
        "<initial_sample_offset>",
    "serial_line_decoder_f_u8":
        "serial_line_decoder_f_u8 <samples_per_bit> [databits [stopbits]]",
    "pattern_search_u8_u8":
        "pattern_search_u8_u8 <values_after> <pattern_value...>",
    "awgn_cc": "awgn_cc <snr_db> [--awgnfile <file>] [--snrshow]",
    "uniform_noise_f": "uniform_noise_f",
    "gaussian_noise_c": "gaussian_noise_c",
    "fifo": "fifo <buffer_size> <number_of_buffers>",
    "tee": "tee <path> [num_buffers]",
    "shift_addition_fc": "shift_addition_fc <rate>",
    "shift_addition_cc_test": "shift_addition_cc_test [rate]",
    "old_fractional_decimator_ff":
        "old_fractional_decimator_ff <decimation_rate> [transition_bw "
        "[window]]",
    "plain_interpolate_cc": "plain_interpolate_cc <interpolation>",
    "suboptimal_rational_resampler_ff":
        "suboptimal_rational_resampler_ff <interpolation> <decimation> "
        "[transition_bw [window]]",
    "firdes_peak_c": "firdes_peak_c <rate> <length> [window [--octave]]",
    "rtty_line_decoder_u8_u8": "rtty_line_decoder_u8_u8",
    "rtty_baudot2ascii_u8_u8": "rtty_baudot2ascii_u8_u8",
    "octave_complex_c":
        "octave_complex_c <samples_to_plot> <out_of_n_samples> [--2d]",
    "_fft2octave": "_fft2octave <fft_size>",
    "syncword_search": "syncword_search <syncword_hex> <bits_after>",
}
# aliases share the canonical entry
for _alias, _canon in [
    ("convert_i16_f", "convert_s16_f"), ("convert_f_i16", "convert_f_s16"),
    ("mono2stereo_i16", "mono2stereo_s16"),
    ("stereo2mono_i16", "stereo2mono_s16"),
    ("floatdump_f", "dump_f"),
    ("encode_ima_adpcm_s16_u8", "encode_ima_adpcm_i16_u8"),
    ("decode_ima_adpcm_u8_s16", "decode_ima_adpcm_u8_i16"),
]:
    USAGE[_alias] = USAGE[_canon].replace(_canon, _alias, 1)


def usage_for(cmd: str) -> str:
    u = USAGE.get(cmd)
    return f"usage: csdr_tpu_torch {u} [--device cuda|cpu]\n" if u else ""


def command(*names):
    def deco(fn):
        for n in names:
            REGISTRY[n] = fn
        return fn
    return deco


def _scalar0(value, dtype, dev) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=dev)


# --- converters ------------------------------------------------------------

@command("convert_u8_f")
def _c_u8f(args):
    from csdr_tpu_torch.ops import convert
    _stateless_pump(convert.convert_u8_f, "u8", "f")


@command("convert_f_u8")
def _c_fu8(args):
    from csdr_tpu_torch.ops import convert
    _stateless_pump(convert.convert_f_u8, "f", "u8")


@command("convert_s8_f")
def _c_s8f(args):
    from csdr_tpu_torch.ops import convert
    _stateless_pump(convert.convert_s8_f, "s8", "f")


@command("convert_f_s8")
def _c_fs8(args):
    from csdr_tpu_torch.ops import convert
    _stateless_pump(convert.convert_f_s8, "f", "s8")


@command("convert_s16_f", "convert_i16_f")
def _c_s16f(args):
    from csdr_tpu_torch.ops import convert
    _stateless_pump(convert.convert_s16_f, "s16", "f")


@command("convert_f_s16", "convert_f_i16")
def _c_fs16(args):
    from csdr_tpu_torch.ops import convert
    _stateless_pump(convert.convert_f_s16, "f", "s16")


@command("convert_s24_f")
def _c_s24f(args):
    from csdr_tpu_torch.ops import convert
    be = "--bigendian" in args
    _stateless_pump(lambda b: convert.convert_s24_f(b, be), "u8", "f",
                    quantum=3)


@command("convert_f_s24")
def _c_fs24(args):
    from csdr_tpu_torch.ops import convert
    be = "--bigendian" in args
    _stateless_pump(lambda x: convert.convert_f_s24(x, be), "f", "u8")


@command("realpart_cf")
def _c_real(args):
    from csdr_tpu_torch.ops import demod
    _stateless_pump(demod.realpart_cf, "c", "f")


@command("mono2stereo_s16", "mono2stereo_i16")
def _c_m2s(args):
    from csdr_tpu_torch.ops import convert
    _stateless_pump(convert.mono2stereo_s16, "s16", "s16")


@command("stereo2mono_s16", "stereo2mono_i16")
def _c_s2m(args):
    from csdr_tpu_torch.ops import convert
    _stateless_pump(convert.stereo2mono_s16, "s16", "s16", quantum=2)


# --- simple utility commands ------------------------------------------------

@command("none")
def _c_none(args):
    """Does nothing, exits immediately (reference csdr.c:3599-3602)."""
    return 0


@command("flowcontrol")
def _c_flowcontrol(args):
    """Rate limiter: forwards <data_rate> bytes/s in <reads_per_second>
    equal reads with a sleep between them (reference csdr.c:1922-1943).
    Host-only."""
    data_rate = _i(args, 0)
    rps = _f(args, 1)
    if _dynamic_bufsize_on():
        # reference flowcontrol reads the preamble and announces its own
        # read size (csdr.c:1963-1986)
        getbufsize()
    bufsize = max(1, int(np.ceil(data_rate / rps)))
    sleep_s = 1.0 / rps
    if _dynamic_bufsize_on():
        sendbufsize(bufsize)
    sys.stderr.write(f"flowcontrol: bufsize={bufsize} sleep={sleep_s:.6f}s\n")
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    while True:
        data = stdin.read(bufsize)
        if not data:
            break
        stdout.write(data)
        stdout.flush()
        time.sleep(sleep_s)


@command("clone", "REM", "through", "dump_f", "floatdump_f", "dump_u8",
         "setbuf")
def _c_passthrough(args):
    """clone/REM/setbuf: byte passthrough; through: passthrough + rate meter
    on stderr; dump_f/dump_u8: print values as text/hex (reference
    csdr.c:431-531, 1056-1067, 2046-2082, 2802-2814).  Host-only."""
    cmd = _cmd()
    if cmd in ("floatdump_f",):
        cmd = "dump_f"
    rdsize = 65536
    if _dynamic_bufsize_on() and cmd in ("clone", "REM", "through"):
        # reference clone/REM relay the negotiated size downstream
        # (csdr.c:440-444 sendbufsize(initialize_buffers()))
        sendbufsize(getbufsize())
    elif _dynamic_bufsize_on() and cmd in ("dump_f", "dump_u8"):
        getbufsize()        # text output: consume the preamble, send none
    if cmd == "setbuf":
        # reference csdr.c:1056-1067: the read quantum AND (under dynamic
        # bufsize) the size announced downstream, after consuming the
        # upstream preamble
        rdsize = _i(args, 0)
        if rdsize <= 0:
            raise SystemExit("bufsize must be >= 1")
        if _dynamic_bufsize_on():
            getbufsize()
            sendbufsize(rdsize)
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    total, t0 = 0, time.time()
    while True:
        data = stdin.read(rdsize)
        if not data:
            break
        total += len(data)
        if cmd == "dump_f":
            vals = np.frombuffer(data[: len(data) // 4 * 4], np.float32)
            sys.stdout.write(" ".join(f"{v:g}" for v in vals) + " ")
            continue
        if cmd == "dump_u8":
            sys.stdout.write(data.hex(" ") + " ")
            continue
        stdout.write(data)
        stdout.flush()
        if cmd == "through" and time.time() - t0 > 1.0:
            sys.stderr.write(f"through: {total / (time.time() - t0):.0f} "
                             "bytes/s\n")
            total, t0 = 0, time.time()


@command("yes_f")
def _c_yes(args):
    """Host-only constant source."""
    value = _f(args, 0)
    count = _i(args, 1, 0)  # 0 = infinite
    if _dynamic_bufsize_on():
        sendbufsize(65536)  # stream source: announce only
    buf = np.full(65536, value, np.float32).tobytes()
    written = 0
    while count == 0 or written < count:
        n = 65536 if count == 0 else min(65536, count - written)
        sys.stdout.buffer.write(buf[: n * 4])
        written += n
        if count == 0:
            sys.stdout.buffer.flush()


@command("repeat_u8")
def _c_repeat(args):
    """Host-only byte pattern source."""
    pat = np.asarray([int(a) for a in args], np.uint8).tobytes()
    while True:
        sys.stdout.buffer.write(pat)


@command("gain_ff")
def _c_gain(args):
    from csdr_tpu_torch.ops import util_ops
    g = _f(args, 0, 1.0)
    _stateless_pump(lambda x: util_ops.gain_ff(x, g), "f", "f")


@command("limit_ff")
def _c_limit(args):
    from csdr_tpu_torch.ops import util_ops
    m = _f(args, 0, 1.0)
    _stateless_pump(lambda x: util_ops.limit_ff(x, m), "f", "f")


@command("clipdetect_ff")
def _c_clip(args):
    # in-stream sanitizer (reference csdr.c:1034-1044): the count is read
    # on the host to print the warning
    from csdr_tpu_torch.ops import util_ops

    def apply(state, x):
        n = int(util_ops.clipdetect_ff(x))
        if n:
            sys.stderr.write(f"clipdetect_ff: {n} samples clipped\n")
        return state, x

    # the count is read on the host a chunk: uncaptured, as csdr_tpu pumps
    # it unjitted (cli.py:735)
    pump(FnBlock("clipdetect", lambda dev: None, apply), "f", "f", jit=False)


@command("detect_nan_ff")
def _c_nan(args):
    from csdr_tpu_torch.ops import util_ops

    def apply(state, x):
        if int(util_ops.detect_nan_ff(x)):
            sys.stderr.write("detect_nan_ff: NaN detected!\n")
        return state, x

    # the flag is read on the host a chunk: uncaptured, as csdr_tpu pumps
    # it unjitted (cli.py:749)
    pump(FnBlock("detect_nan", lambda dev: None, apply), "f", "f", jit=False)


@command("dcblock_ff")
def _c_dcblock(args):
    from csdr_tpu_torch.ops import util_ops
    pump(util_ops.dcblock_block(), "f", "f")


@command("fastdcblock_ff")
def _c_fastdc(args):
    from csdr_tpu_torch.ops import util_ops
    # the reference runs its OWN block size (default 1024, optional arg),
    # independent of the stream bufsize: the DC window is that block
    # (csdr.c:952-968), so the chunk is pinned
    block = _i(args, 0, 1024)
    pump(util_ops.fastdcblock_block(), "f", "f", chunk=block)


@command("add_n_zero_samples_at_beginning_f")
def _c_addzero(args):
    """Host-only: zeros, then the stream as it is."""
    n = _i(args, 0)
    if _dynamic_bufsize_on():
        sendbufsize(getbufsize())   # reference relays (csdr.c:3153)
    sys.stdout.buffer.write(b"\x00" * (4 * n))
    while True:
        d = sys.stdin.buffer.read(65536)
        if not d:
            break
        sys.stdout.buffer.write(d)
        sys.stdout.buffer.flush()


@command("add_const_cc")
def _c_addconst(args):
    i, q = _f(args, 0, 0.0), _f(args, 1, 0.0)
    # the reference's add_const_cc uses i for both parts
    # (libcsdr.c:2524-2531); csdr_tpu implements the obvious intent
    _stateless_pump(lambda x: torch.complex(x.real + i, x.imag + q),
                    "c", "c")


# --- shift family ------------------------------------------------------------

@command("shift_math_cc", "shift_addition_cc", "shift_table_cc",
         "shift_addfast_cc", "shift_unroll_cc")
def _c_shift(args):
    from csdr_tpu_torch.ops import shift
    ctl = FifoCtl(args)
    a = strip_ctl_args(args)
    rate = float(a[0]) if a else float(ctl.wait_first())
    if _cmd() == "shift_table_cc" and len(a) > 1:
        # the reference's table variant takes a table size / quality knob
        # (csdr.c:872-896); the direct NCO is exact, so the argument is
        # accepted for compatibility and has no effect
        sys.stderr.write(f"shift_table_cc: table_size={int(float(a[1]))} "
                         "accepted (direct NCO is exact; no table)\n")

    # the rate lives in the state, a float32 0-dim CPU tensor: the NCO
    # takes csdr_tpu's traced-rate path on the card, and a FIFO retune
    # replaces the rate between chunks (the reference re-enters its shift
    # loop, csdr.c:749-848).  The rate is a key leaf of the captured step
    # (a retune makes one capture); the phase a value leaf, advanced on
    # the host as shift_cc advances it (core/graph.carried_value)
    def init(dev):
        return (torch.tensor(0.0), torch.tensor(rate, dtype=torch.float32))

    def apply(state, x):
        phase, r = state
        n = x.shape[0]
        ph, nphase = carried_value(
            phase, lambda p: shift.traced_next_phase(p, n, r))
        return (nphase, r), shift.traced_mix(x, r, ph)

    def on_chunk(state):
        line = ctl.poll()
        if line:
            try:
                new_rate = float(line)
                sys.stderr.write(f"shift: retuned to {new_rate}\n")
                return (state[0], torch.tensor(new_rate,
                                               dtype=torch.float32))
            except ValueError:
                pass
        return state

    pump(FnBlock("shift", init, apply), "c", "c", on_chunk=on_chunk)


@command("decimating_shift_addition_cc")
def _c_decshift(args):
    from csdr_tpu_torch.ops import shift
    rate = _f(args, 0)
    d = _i(args, 1, 1)

    ramps = {}          # the NCO's ramp by chunk length, on the card

    def init(dev):
        return (_scalar0(0.0, torch.float32, dev),
                _scalar0(0, torch.int32, dev))

    def apply(state, x):
        phase, off = state
        cap = -(-x.shape[0] // d)
        if cap not in ramps:
            ramps[cap] = shift.static_cycles(cap, rate * d, x.device)
        y, count, nphase, noff = shift.decimating_shift_cc(
            x, rate * d, d, phase, off, cycles=ramps[cap])
        return (nphase, noff), VarOut(y, count)

    pump(FnBlock("decshift", init, apply), "c", "c", quantum=d)


# --- FIR / resampling --------------------------------------------------------

@command("fir_decimate_cc")
def _c_firdec(args):
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.ops import fir
    args = list(args)
    prec = _precision(args)
    d = _i(args, 0)
    bw = _f(args, 1, 0.05)
    win = _window(args, 2)
    taps = firdes.firdes_lowpass_f(firdes.firdes_filter_len(bw), 0.5 / d, win)
    blk = fir.fir_decimate_block(taps, d, precision=prec)
    pump(blk, "c", "c", quantum=d, drop_warmup_out=blk.warmup_out)


@command("fir_interpolate_cc")
def _c_firint(args):
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.ops import fir
    args = list(args)
    prec = _precision(args)
    i_ = _i(args, 0)
    bw = _f(args, 1, 0.05)
    win = _window(args, 2)
    taps = firdes.firdes_lowpass_f(firdes.firdes_filter_len(bw), 0.5 / i_,
                                   win)
    blk = fir.fir_interpolate_block(taps, i_, precision=prec)
    pump(blk, "c", "c", drop_warmup_out=blk.warmup_out)


@command("rational_resampler_ff")
def _c_ratres(args):
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.ops import fir
    args = list(args)
    prec = _precision(args)
    i_ = _i(args, 0)
    d = _i(args, 1)
    bw = _f(args, 2, 0.05)
    win = _window(args, 3)
    taps = firdes.rational_resampler_get_lowpass_f(
        firdes.firdes_filter_len(bw), i_, d, win)
    blk = fir.rational_resampler_block(taps, i_, d, precision=prec)
    pump(blk, "f", "f", quantum=d, drop_warmup_out=blk.warmup_out)


@command("fractional_decimator_ff")
def _c_fracdec(args):
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.ops import resamp
    rate = _f(args, 0)
    npoly = _i(args, 1, 12)
    taps = None
    if len(args) > 2 and not args[2].startswith("--"):
        bw = float(args[2])
        win = _window(args, 3)
        taps = firdes.firdes_lowpass_f(firdes.firdes_filter_len(bw),
                                       0.5 / rate, win)
    blk = resamp.fractional_decimator_block(rate, npoly, taps)
    # occ and where are key leaves of the captured step: at an integer or
    # a rational rate they go round a cycle (the pump keeps a graph for
    # each key of it, the block's key_cycle); at any other rate, the
    # generic path, they need not come back, and the block runs uncaptured
    pump(blk, "f", "f", jit=rate.is_integer() or isinstance(
        blk, resamp.RationalFractionalDecimatorBlock))


@command("bandpass_fir_fft_cc")
def _c_bandpass(args):
    from csdr_tpu_torch.ops import fftfilt
    ctl = FifoCtl(args)
    a = strip_ctl_args(args)
    if ctl.fd is not None:
        low, high = map(float, ctl.wait_first().split())
        bw = float(a[0])
        win = _window(a, 1)
    else:
        low, high, bw = float(a[0]), float(a[1]), float(a[2])
        win = _window(a, 3)
    blk = fftfilt.bandpass_fir_fft_block(low, high, bw, win)

    def on_chunk(state):
        # the taps spectra are the block's buffers: a retune computes the
        # new band's spectra on the host and copies them into the buffers
        # (the block is not rebuilt; the overlap carry is kept)
        line = ctl.poll()
        if line:
            try:
                lo, hi = map(float, line.split())
            except ValueError:
                return state
            tfft, tko = fftfilt.bandpass_taps_spectra(bw, lo, hi, win)
            blk.taps_fft.copy_(tfft)
            if tko is not None:
                blk.taps_fft_ko.copy_(tko)
            sys.stderr.write(f"bandpass: retuned to [{lo}, {hi}]\n")
        return state

    pump(blk, "c", "c", quantum=blk.input_size, on_chunk=on_chunk)


@command("peaks_fir_cc")
def _c_peaks(args):
    # <taps_length> <peak_rate x N> (reference csdr.c:2975)
    from csdr_tpu_torch.ops import fir
    length = int(args[0])
    rates = [float(a) for a in args[1:]]
    pump(fir.peaks_fir_cc_block(rates, length), "c", "c")


@command("pulse_shaping_filter_cc")
def _c_pulse(args):
    from csdr_tpu_torch.ops import fir
    kind = args[0].upper()
    sps = _i(args, 1)
    ntaps = _i(args, 2, 0) if kind == "RRC" else None
    beta = _f(args, 3, 0.25) if kind == "RRC" else 0.0
    pump(fir.pulse_shaping_filter_cc_block(kind, sps, ntaps, beta), "c",
         "c")


def _dump_taps_real(taps, octave: bool):
    """Real tap dump, optionally as an octave plot script
    (reference csdr.c:1278-1285)."""
    if octave:
        print("taps=[" + " ".join(f"{t:g}" for t in taps) +
              "];plot(taps);figure(2);freqz(taps);")
    else:
        print(",".join(f"{t:g}" for t in taps))


def _dump_taps_complex(taps, octave: bool):
    """Complex tap dump; --octave plots the shifted power spectrum
    (reference csdr.c:1317-1330)."""
    if octave:
        print("taps=[" + " ".join(f"({t.real:g})+({t.imag:g})*i"
                                  for t in taps)
              + "];fser=fft(taps);ampl=abs(fser).^2;"
              "semilogy(fftshift(ampl));")
    else:
        print(",".join(f"({t.real:g}{t.imag:+g}j)" for t in taps))


@command("firdes_lowpass_f")
def _c_firdes_lp(args):
    from csdr_tpu_torch import firdes
    cutoff = _f(args, 0)
    length = _i(args, 1)
    win = _window(args, 2)
    _dump_taps_real(firdes.firdes_lowpass_f(length, cutoff, win),
                    "--octave" in args)


@command("firdes_bandpass_c")
def _c_firdes_bp(args):
    from csdr_tpu_torch import firdes
    low, high = _f(args, 0), _f(args, 1)
    length = _i(args, 2)
    win = _window(args, 3)
    _dump_taps_complex(firdes.firdes_bandpass_c(length, low, high, win),
                       "--octave" in args)


@command("firdes_pulse_shaping_filter_f")
def _c_firdes_ps(args):
    from csdr_tpu_torch import firdes
    kind = args[0].upper()
    if kind == "RRC":
        taps = firdes.firdes_rrc_f(_i(args, 2), _i(args, 1), _f(args, 3, 0.25))
    else:
        sps = _i(args, 1)
        taps = firdes.firdes_cosine_f(2 * sps + 1, sps)
    _dump_taps_real(taps, "--octave" in args)


# --- demod / mod -------------------------------------------------------------

@command("fmdemod_quadri_cf", "fmdemod_quadri_novect_cf")
def _c_fmq(args):
    from csdr_tpu_torch.ops import demod
    pump(demod.fmdemod_quadri_block(), "c", "f")


@command("fmdemod_atan_cf")
def _c_fma(args):
    from csdr_tpu_torch.ops import demod
    pump(demod.fmdemod_atan_block(), "c", "f")


@command("amdemod_cf")
def _c_am(args):
    from csdr_tpu_torch.ops import demod
    _stateless_pump(demod.amdemod_cf, "c", "f")


@command("amdemod_estimator_cf")
def _c_ame(args):
    from csdr_tpu_torch.ops import demod
    _stateless_pump(demod.amdemod_estimator_cf, "c", "f")


@command("deemphasis_wfm_ff")
def _c_dewfm(args):
    from csdr_tpu_torch.ops import demod
    rate = _i(args, 0)
    tau = _f(args, 1)
    pump(demod.deemphasis_wfm_block(tau, rate), "f", "f")


@command("deemphasis_nfm_ff")
def _c_denfm(args):
    from csdr_tpu_torch.ops import demod
    rate = _i(args, 0)
    pump(demod.deemphasis_nfm_block(rate), "f", "f")


@command("fmmod_fc")
def _c_fmmod(args):
    from csdr_tpu_torch.ops import mod
    pump(mod.fmmod_block(), "f", "c")


@command("dsb_fc")
def _c_dsb(args):
    from csdr_tpu_torch.ops import mod
    q = _f(args, 0, 0.0)
    _stateless_pump(lambda x: mod.dsb_fc(x, q), "f", "c")


@command("add_dcoffset_cc")
def _c_adddc(args):
    from csdr_tpu_torch.ops import util_ops
    _stateless_pump(util_ops.add_dcoffset_cc, "c", "c")


@command("fixed_amplitude_cc")
def _c_fixamp(args):
    from csdr_tpu_torch.ops import util_ops
    amp = _f(args, 0)
    _stateless_pump(lambda x: util_ops.fixed_amplitude_cc(x, amp), "c", "c")


@command("convert_f_samplerf")
def _c_samplerf(args):
    """Host-only: the rpitx record is packed on the host."""
    from csdr_tpu_torch.ops import mod
    wait = _i(args, 0)
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    while True:
        d = stdin.read(4 * 65536)
        if not d:
            break
        x = np.frombuffer(d[: len(d) // 4 * 4], np.float32)
        stdout.write(mod.convert_f_samplerf(x, wait).tobytes())
        stdout.flush()


# --- gain control / squelch --------------------------------------------------

@command("agc_ff")
def _c_agc(args):
    from csdr_tpu_torch.ops import agc
    kw = {}
    # reference-compatible positional form first (csdr.c:2018-2044:
    # agc_ff [hang_time [reference [attack_rate [decay_rate [max_gain
    # [attack_wait [filter_alpha]]]]]]]); --flag form kept as an extension
    flags = {"--reference": "reference", "--attack": "attack_rate",
             "--decay": "decay_rate", "--max": "max_gain",
             "--hangtime": "hang_time", "--attackwait": "attack_wait_time",
             "--filteralpha": "gain_filter_alpha"}
    positional = ["hang_time", "reference", "attack_rate", "decay_rate",
                  "max_gain", "attack_wait_time", "gain_filter_alpha"]
    i = npos = 0
    while i < len(args):
        if args[i] in flags:
            v = float(args[i + 1])
            kw[flags[args[i]]] = int(v) if "time" in flags[args[i]] else v
            i += 2
        else:
            name = positional[npos]
            v = float(args[i])
            kw[name] = int(v) if "time" in name else v
            npos += 1
            i += 1
    # the chunked (waveform-relaxation) agc supports attack_wait_time=0
    # only; otherwise the bit-faithful scan, one kernel launch a chunk on
    # the card (kernels/agc_cuda.scan), the host loop under --device cpu
    method = "scan" if kw.get("attack_wait_time", 0) else "chunked"
    pump(agc.agc_block(method=method, **kw), "f", "f")


@command("fastagc_ff")
def _c_fastagc(args):
    # the reference defaults input_size=1024 and reads exactly that per
    # iteration whatever the negotiated bufsize, then
    # sendbufsize(input_size) (csdr.c:1377-1386): the chunk is pinned
    from csdr_tpu_torch.ops import agc
    block = _i(args, 0, 1024)
    ref = _f(args, 1, 1.0)
    pump(agc.fastagc_block(reference=ref, block_size=block), "f", "f",
         quantum=block, chunk=block)


@command("simple_agc_cc")
def _c_sagc(args):
    from csdr_tpu_torch.ops import agc
    rate = _f(args, 0)
    ref = _f(args, 1, 1.0)
    pump(agc.simple_agc_block(rate, ref), "c", "c")


@command("squelch_and_smeter_cc")
def _c_squelch(args):
    from csdr_tpu_torch.ops import util_ops
    ctl = FifoCtl(args)
    outfifo = None
    if "--outfifo" in args:
        outfifo = os.open(args[args.index("--outfifo") + 1],
                          os.O_WRONLY | os.O_NONBLOCK)
    a = [x for x in strip_ctl_args(args) if not x.startswith("--")]
    use_every_nth = int(a[0]) if len(a) > 0 else 1
    report_every_nth = int(a[1]) if len(a) > 1 else 1
    box = {"n": 0}

    def init(dev):
        # (squelch level, last chunk's power): the level is state, so a
        # FIFO retune replaces it; the power is read on the host for the
        # S-meter, only where an S-meter FIFO is open
        return (_scalar0(0.0, torch.float32, dev),
                _scalar0(0.0, torch.float32, dev))

    def apply(state, x):
        level, _ = state
        y, power = util_ops.squelch_and_smeter_cc(x, level, use_every_nth)
        return (level, power), y

    def on_chunk(state):
        level, power = state
        box["n"] += 1
        if outfifo is not None and box["n"] % report_every_nth == 0:
            try:
                os.write(outfifo, f"{float(power):g}\n".encode())
            except OSError:
                pass
        line = ctl.poll()
        if line:
            try:
                return (_scalar0(float(line), torch.float32, level.device),
                        power)
            except ValueError:
                pass
        return state

    pump(FnBlock("squelch", init, apply), "c", "c", on_chunk=on_chunk)


# --- spectrum ----------------------------------------------------------------

@command("fft_cc")
def _c_fft(args):
    from csdr_tpu_torch.ops import spectrum
    n = _i(args, 0)
    every = _i(args, 1)
    win = _window(args, 2)
    if "--benchmark" in args:
        # the reference flag selects FFTW_MEASURE planning (csdr.c:1586,
        # 1602); here the first launch builds the plan: acknowledged
        sys.stderr.write("fft_cc: benchmarking... (first launch = plan)\n")
    blk = spectrum.fft_cc_block(n, every, win)
    if "--octave" in args:
        # live octave plot script instead of raw spectra
        # (reference csdr.c:1578-1644 + _fft2octave)
        dev = _dev()
        print(f'setenv("GNUTERM","X11 noraise");y=zeros(1,{n});'
              'semilogy(y,"ydatasource","y");')
        blk = blk.to(dev)
        step = STEP(blk, MAX_GRAPHS)      # csdr_tpu's jax.jit(blk.apply)
        state = blk.init(dev)
        stdin = sys.stdin.buffer
        half = n // 2
        with torch.no_grad():
            while True:
                data = stdin.read(8 * every)
                if len(data) < 8 * every:
                    break
                x = _mk_fmts()["c"].to_dev(np.frombuffer(data, np.float32),
                                           dev)
                state, y = step(state, x)
                fr = torch.view_as_real(y).reshape(-1, 2).cpu().numpy()
                swapped = np.concatenate([fr[half:n], fr[:half]])
                print("fftdata=[" +
                      " ".join(f"({i:g})+({q:g})*i" for i, q in swapped) +
                      "];\ny=abs(fftdata);\nrefreshdata;")
                sys.stdout.flush()
        _note(step, blk)
        return 0
    pump(blk, "c", "c", quantum=every)


@command("fft_fc")
def _c_fftfc(args):
    from csdr_tpu_torch.ops import spectrum
    n = _i(args, 0)
    every = _i(args, 1)
    win = _window(args, 2)
    if "--benchmark" in args:
        sys.stderr.write("fft_fc: benchmarking... (first launch = plan)\n")
    pump(spectrum.fft_fc_block(n, every, win), "f", "c", quantum=every)


@command("logpower_cf")
def _c_logpow(args):
    from csdr_tpu_torch.ops import spectrum
    add_db = _f(args, 0, 0.0)
    _stateless_pump(lambda x: spectrum.logpower_cf(x, add_db), "c", "f")


@command("logaveragepower_cf")
def _c_logavg(args):
    from csdr_tpu_torch.ops import spectrum
    add_db = _f(args, 0)
    n = _i(args, 1)
    avg = _i(args, 2)
    pump(spectrum.logaveragepower_block(add_db, n, avg), "c", "f",
         quantum=n * avg)


@command("fft_exchange_sides_ff")
def _c_fftswap(args):
    from csdr_tpu_torch.ops import spectrum
    n = _i(args, 0)
    _stateless_pump(lambda x: spectrum.fft_exchange_sides_ff(
        x.reshape(-1, n)).reshape(-1), "f", "f", quantum=n)


@command("fft_one_side_ff")
def _c_fftone(args):
    from csdr_tpu_torch.ops import spectrum
    n = _i(args, 0)
    _stateless_pump(lambda x: spectrum.fft_one_side_ff(
        x.reshape(-1, n)).reshape(-1), "f", "f", quantum=n)


@command("compress_fft_adpcm_f_u8")
def _c_compressfft(args):
    from csdr_tpu_torch.ops import spectrum
    n = _i(args, 0)

    def apply(state, x):
        return state, spectrum.compress_fft_adpcm_rows(
            x.reshape(-1, n), n).reshape(-1)

    pump(FnBlock("compressfft", lambda dev: None, apply), "f", "u8",
         quantum=n)


@command("encode_ima_adpcm_i16_u8", "encode_ima_adpcm_s16_u8")
def _c_adpcm_enc(args):
    from csdr_tpu_torch.ops import adpcm
    pump(adpcm.encode_block(), "s16", "u8", quantum=2)


@command("decode_ima_adpcm_u8_i16", "decode_ima_adpcm_u8_s16")
def _c_adpcm_dec(args):
    from csdr_tpu_torch.ops import adpcm
    pump(adpcm.decode_block(), "u8", "s16")


def _time_ms(fn, iters: int) -> float:
    """Milliseconds a call of ``fn``: CUDA events on the card, the host
    clock on the CPU."""
    if _dev().type == "cuda":
        from csdr_tpu_torch.utils.timing import time_cuda
        return time_cuda(fn, iters=iters, warmup=0, repeats=1)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


@command("fft_benchmark")
def _c_fftbench(args):
    """Times <fft_cycles> complex FFTs of <fft_size> (the port's core FFT)
    with CUDA events on the card: replays of the FFT captured as a CUDA
    graph, the first call its warm-up and capture (csdr_tpu times its
    jitted FFT's compile there)."""
    from csdr_tpu_torch.core import cplx, fft as cfft
    n = _i(args, 0)
    cycles = _i(args, 1)
    rng = np.random.default_rng(0)
    x = cplx.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                        .astype(np.complex64), _dev())
    blk = FnBlock("fft", lambda dev: None, lambda s, v: (s, cfft.fft(v)))
    fft = STEP(blk, MAX_GRAPHS)
    first = _time_ms(lambda: fft(None, x), 1)
    sys.stderr.write(f"fft_benchmark: first (plan) in {first / 1e3:g} s\n")
    dt = _time_ms(lambda: fft(None, x), max(cycles, 1)) / 1e3
    _note(fft, blk)
    sys.stderr.write(f"fft_benchmark: {cycles} transforms of {n}, "
                     f"{dt:g} seconds each.\n")


# --- fastddc -----------------------------------------------------------------

@command("fastddc_fwd_cc")
def _c_ddcfwd(args):
    from csdr_tpu_torch.ops import fastddc
    d = _i(args, 0)
    bw = _f(args, 1, 0.05)
    win = _window(args, 2)
    ddc = fastddc.fastddc_init(bw, d, 0.0, win)
    sys.stderr.write(f"fastddc_fwd_cc: fft_size={ddc.fft_size} "
                     f"input_size={ddc.input_size}\n")
    blk = fastddc.fastddc_fwd_block(ddc)

    def apply(state, x):
        state, spectra = blk(state, x)
        return state, spectra.reshape(-1)

    pump(FnBlock("ddcfwd", blk.init, apply), "c", "c",
         quantum=ddc.input_size)


@command("fastddc_inv_cc")
def _c_ddcinv(args):
    """The inverse of one channel from natural-order spectra.  A divisible
    post decimation (e.g. D=16) runs the factored inverse, K4, with the
    channel's rows as arguments, as the DDC server's path S; another (e.g.
    D=50) the dynamic classed product.  The rows and ``cyc`` are card
    buffers allocated once, which the inverse's captured step reads
    (csdr_tpu's ``step_inv`` takes them as arguments, cli.py:1376-1391); a
    retune computes the new rows on the host and copies them into the
    buffers (reference csdr.c:2308-2339 re-enters fastddc_init): no
    storage moves, so no new capture; the block is not rebuilt."""
    import math

    from csdr_tpu_torch.ops import fastddc
    ctl = FifoCtl(args)
    a = strip_ctl_args(args)
    if ctl.fd is not None:
        rate = float(ctl.wait_first())
        d = int(a[0])
        bw = float(a[1]) if len(a) > 1 else 0.05
        win = _window(a, 2)
    else:
        rate = float(a[0])
        d = int(a[1])
        bw = float(a[2]) if len(a) > 2 else 0.05
        win = _window(a, 3)
    ddc = fastddc.fastddc_init(bw, d, rate, win)
    factored = ddc.post_input_size % ddc.post_decimation == 0
    dev = _concrete(_dev())
    inv = (fastddc.fastddc_inv_dynamic_factored_block(ddc, 1) if factored
           else fastddc.fastddc_inv_dynamic_block(ddc, 1)).to(dev)

    def host_rows(r):
        """The channel's rows at rate r, host arrays: (tq, drow) factored,
        (g,) classed, and cyc."""
        if factored:
            tq, drow, cyc = fastddc.dynamic_channel_rows(ddc, r)
            rows = (tq[None], drow[None])
        else:
            g, cyc = fastddc.dynamic_channel_cols(ddc, r)
            rows = (g,)
        return tuple(torch.from_numpy(np.ascontiguousarray(v, np.complex64))
                     for v in rows), torch.tensor([cyc], dtype=torch.float32)

    rows, cyc = host_rows(rate)
    rows = tuple(v.to(dev) for v in rows) + (cyc.to(dev),)

    def set_rate(r):
        new, c = host_rows(r)
        for buf, v in zip(rows, new + (c,)):
            buf.copy_(v)

    def step_inv(state, spectra):
        return inv(state, spectra, *rows)

    # csdr_tpu jits step_inv with the rows as arguments; here it is
    # captured over the buffers
    inner = FnBlock("ddcinv step", inv.init, step_inv)
    inner.rows = rows
    step = STEP(inner, MAX_GRAPHS)

    def apply(state, x):
        state, out = step(state, x.reshape(-1, ddc.fft_size))
        return state, VarOut(out.data[0], out.count)

    def on_chunk(state):
        line = ctl.poll()
        if line:
            try:
                new_rate = float(line)
                sys.stderr.write(f"fastddc_inv: retuned to {new_rate}\n")
                set_rate(new_rate)
            except ValueError:
                pass
        return state

    # classed decimations (post_input % post != 0) need q-aligned frame
    # counts per chunk for streaming NCO/class continuity
    q_al = (ddc.post_decimation //
            math.gcd(ddc.post_input_size, ddc.post_decimation))
    # the outer apply is not captured, as csdr_tpu pumps it unjitted
    # (cli.py:1413): its step is
    pump(FnBlock("ddcinv", inv.init, apply), "c", "c",
         quantum=ddc.fft_size * q_al, on_chunk=on_chunk, jit=False)
    _note(step, inner)


# --- digital / modem ---------------------------------------------------------

@command("psk31_varicode_encoder_u8_u8")
def _c_vc_enc(args):
    """Host-only: the encoder is host numpy, as csdr_tpu's."""
    from csdr_tpu_torch.ops import digital
    while True:
        d = sys.stdin.buffer.read(4096)
        if not d:
            break
        bits = digital.psk31_varicode_encoder_u8_u8(np.frombuffer(d, np.uint8))
        sys.stdout.buffer.write(bits.tobytes())
        sys.stdout.buffer.flush()


@command("psk31_varicode_decoder_u8_u8")
def _c_vc_dec(args):
    from csdr_tpu_torch.ops import digital

    def init(dev):
        # ones = the op's own start-of-stream padding (cannot satisfy the
        # 00 framing), so chunked output equals a one-shot decode
        return torch.ones(13, dtype=torch.int32, device=dev)

    def apply(tail, x):
        xcat = torch.cat([tail, x.to(torch.int32)])
        # skip=13: matches ending inside the carried tail were emitted by
        # the previous chunk
        out = digital.psk31_varicode_decoder_u8_u8(xcat, skip=13)
        return xcat[-13:].clone(), out

    pump(FnBlock("vcdec", init, apply), "u8", "u8")


def _u8_codec_block(name, fn):
    def init(dev):
        return _scalar0(0, torch.int32, dev)

    def apply(st, x):
        y, st = fn(x, st)
        return st, y

    return FnBlock(name, init, apply)


@command("differential_encoder_u8_u8")
def _c_diffenc(args):
    from csdr_tpu_torch.ops import digital
    pump(_u8_codec_block("diffenc", digital.differential_codec_encode),
         "u8", "u8")


@command("differential_decoder_u8_u8")
def _c_diffdec(args):
    from csdr_tpu_torch.ops import digital
    pump(_u8_codec_block("diffdec", digital.differential_codec_decode),
         "u8", "u8")


@command("psk_modulator_u8_c")
def _c_pskmod(args):
    from csdr_tpu_torch.ops import digital
    n = _i(args, 0, 2)
    _stateless_pump(lambda x: digital.psk_modulator_u8_c(x, n), "u8", "c")


def _last_sample_block(name, fn):
    def init(dev):
        return _scalar0(0.0, torch.complex64, dev)

    def apply(last, x):
        y, last = fn(x, last)
        return last, y

    return FnBlock(name, init, apply)


@command("psk31_interpolate_sine_cc")
def _c_psk31int(args):
    from csdr_tpu_torch.ops import digital
    interp = _i(args, 0)
    pump(_last_sample_block("psk31int", lambda x, last: digital.
                            psk31_interpolate_sine_cc(x, interp, last)),
         "c", "c")


@command("duplicate_samples_ntimes_u8_u8")
def _c_dup(args):
    from csdr_tpu_torch.ops import digital
    sz = _i(args, 0)
    nt = _i(args, 1)
    _stateless_pump(lambda x: digital.duplicate_samples_ntimes_u8_u8(
        x, sz, nt), "u8", "u8", quantum=sz)


@command("pack_bits_1to8_u8_u8")
def _c_pack18(args):
    from csdr_tpu_torch.ops import digital
    _stateless_pump(digital.pack_bits_1to8_u8_u8, "u8", "u8")


@command("pack_bits_8to1_u8_u8")
def _c_pack81(args):
    from csdr_tpu_torch.ops import digital
    _stateless_pump(digital.pack_bits_8to1_u8_u8, "u8", "u8", quantum=8)


@command("invert_u8_u8")
def _c_invert(args):
    from csdr_tpu_torch.ops import digital
    _stateless_pump(digital.invert_u8_u8, "u8", "u8")


@command("binary_slicer_f_u8")
def _c_binslice(args):
    from csdr_tpu_torch.ops import digital
    _stateless_pump(digital.binary_slicer_f_u8, "f", "u8")


@command("generic_slicer_f_u8")
def _c_genslice(args):
    from csdr_tpu_torch.ops import digital
    n = _i(args, 0)
    _stateless_pump(lambda x: digital.generic_slicer_f_u8(x, n), "f", "u8")


@command("dbpsk_decoder_c_u8")
def _c_dbpsk(args):
    from csdr_tpu_torch.ops import digital
    pump(_last_sample_block("dbpsk", digital.dbpsk_decoder_c_u8), "c", "u8")


@command("bfsk_demod_cf")
def _c_bfsk(args):
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.ops import digital
    spacing = _f(args, 0)
    flen = _i(args, 1)
    mark = firdes.firdes_add_peak_c(flen, [spacing / 2])
    space = firdes.firdes_add_peak_c(flen, [-spacing / 2])
    box = {}

    def init(dev):
        box["mark"] = torch.from_numpy(np.asarray(mark, np.complex64)).to(dev)
        box["space"] = torch.from_numpy(np.asarray(space, np.complex64)
                                        ).to(dev)
        return torch.zeros(flen - 1, dtype=torch.complex64, device=dev)

    def apply(tail, x):
        xcat = torch.cat([tail, x])
        y = digital.bfsk_demod_cf(xcat, box["mark"], box["space"])
        return xcat[x.shape[0]:].clone(), y[: x.shape[0]]

    pump(FnBlock("bfsk", init, apply), "c", "f")


@command("timing_recovery_cc")
def _c_timing(args):
    from csdr_tpu_torch.ops import sync
    alg = args[0].upper()
    decim = int(args[1])
    pos, skip = [], False
    for a in args[2:]:
        if skip:
            skip = False
            continue
        if a.startswith("--"):
            skip = a in ("--octave_save", "--segments")  # flags with a value
            continue
        pos.append(a)
    gain = float(pos[0]) if len(pos) > 0 else 0.5
    max_err = float(pos[1]) if len(pos) > 1 else 2.0
    use_q = "--add_q" in args
    output = "symbols"
    if "--output_error" in args:
        output = "error"
    if "--output_indexes" in args:
        output = "indexes"
    # --segments N (csdr_tpu's extension): the overlap-discard parallel
    # mode, serial reference semantics at the default 1
    if "--segments" in args:
        i = args.index("--segments")
        if i + 1 >= len(args) or args[i + 1].startswith("--"):
            raise SystemExit("--segments requires a value")
        try:
            segs = int(args[i + 1])
        except ValueError:
            raise SystemExit("--segments must be an integer >= 1") from None
        if segs < 1:
            raise SystemExit("--segments must be an integer >= 1")
    else:
        segs = 1
    if "--octave" in args:
        # debug plots of the sampling points on the signal (reference
        # octave_plot_point_on_cplxsig, libcsdr.c:1917-1958 + :2046-2052)
        inner = sync.timing_recovery_block(alg, decim, gain, max_err, use_q,
                                           "indexes", segments=segs)
        print("cf=figure();")
        save_prefix = None
        if "--octave_save" in args:
            # each plot saved as PNG (libcsdr.c:1917-1958 writes
            # <prefix>_<n>.png via print -dpng)
            save_prefix = args[args.index("--octave_save") + 1]
        plot_n = [0]
        step = STEP(inner, MAX_GRAPHS)    # csdr_tpu's jax.jit(blk.apply)

        def apply(state, x):
            state, out = step(state, x)
            m = int(out.count)
            idx = out.data[:m].cpu().numpy()
            sig = x.real.cpu().numpy()
            print("isig=[" + " ".join(f"{v:g}" for v in sig) + "];")
            print("pts=[" + " ".join(str(int(v) + 1) for v in idx) + "];")
            print("plot(isig);hold on;scatter(pts,isig(pts),'r');hold off;")
            if save_prefix is not None:
                print(f'print(cf,"{save_prefix}_{plot_n[0]}.png","-dpng");')
                plot_n[0] += 1
            sys.stdout.flush()
            return state, VarOut(out.data[:0], 0)

        # the plot is printed from the host a chunk: the outer apply is not
        # captured, as csdr_tpu pumps it unjitted (cli.py:1658); its step is
        pump(FnBlock("timing_octave", lambda dev: inner.to(dev).init(dev),
                     apply), "c", "u32", quantum=decim, jit=False)
        _note(step, inner)
        return
    blk = sync.timing_recovery_block(alg, decim, gain, max_err, use_q, output,
                                     segments=segs)
    ofmt = "c" if output == "symbols" else ("f" if output == "error"
                                            else "u32")
    pump(blk, "c", ofmt, quantum=decim)


@command("bpsk_costas_loop_cc")
def _c_costas(args):
    from csdr_tpu_torch.ops import sync
    # reference intent: omega = 2*pi*0.01 (libcsdr.c:2098)
    bw = _f(args, 0, 0.01)
    damping = _f(args, 1, 0.707)
    dd = "--dd" in args
    pump(sync.costas_block(bw, damping, dd), "c", "c")


@command("pll_cc")
def _c_pll(args):
    """pll_cc <1|2> [alpha|bandwidth] [--nco]: PLL carrier tracker; emits
    dphase (f) by default, or the NCO itself (c) with --nco (the reference
    pll_cc supports both outputs, libcsdr.c:1856-1915)."""
    from csdr_tpu_torch.ops import sync
    output = "nco" if "--nco" in args else "dphase"
    ofmt = "c" if output == "nco" else "f"
    pos = [a for a in args if not a.startswith("--")]
    which = int(pos[0]) if pos else 2
    gain = float(pos[1]) if len(pos) > 1 else 0.01
    pump(sync.pll_block(gain, pi_controller=(which != 1), output=output),
         "c", ofmt)


@command("normalized_timing_variance_u32_f")
def _c_ntv(args):
    from csdr_tpu_torch.ops import digital
    sps = _i(args, 0)
    offset = _i(args, 1)
    data = sys.stdin.buffer.read()
    idxs = np.frombuffer(data[: len(data) // 4 * 4], np.uint32)
    v = digital.normalized_timing_variance_u32_f(
        _upload(idxs.astype(np.int64), _dev()), sps, offset)
    sys.stdout.buffer.write(np.float32(float(v)).tobytes())


@command("serial_line_decoder_f_u8")
def _c_serial(args):
    """Host-only software UART (host numpy, as csdr_tpu's)."""
    from csdr_tpu_torch.ops import digital
    sps = _f(args, 0)
    databits = _i(args, 1, 8)
    stopbits = _f(args, 2, 1.0)
    buf = np.zeros(0, np.float32)
    while True:
        d = sys.stdin.buffer.read(65536 * 4)
        if not d:
            break
        buf = np.concatenate([buf, np.frombuffer(d[: len(d) // 4 * 4],
                                                 np.float32)])
        out, used = digital.serial_line_decoder_f_u8(buf, sps, databits,
                                                     stopbits)
        sys.stdout.buffer.write(out.astype(np.uint8).tobytes())
        sys.stdout.buffer.flush()
        buf = buf[used:]


@command("pattern_search_u8_u8")
def _c_patsearch(args):
    """Host-only pattern match (host numpy, as csdr_tpu's)."""
    from csdr_tpu_torch.ops import digital
    values_after = _i(args, 0)
    pattern = np.asarray([int(a) for a in args[1:]], np.uint8)
    data = sys.stdin.buffer.read()
    hits = digital.pattern_search_u8_u8(np.frombuffer(data, np.uint8),
                                        pattern, values_after)
    sys.stdout.buffer.write(hits.tobytes())


# --- noise -------------------------------------------------------------------

@command("awgn_cc")
def _c_awgn(args):
    """<snr_db> [--awgnfile <f>] [--snrshow]: add AWGN at the reference's
    amplitude split; --awgnfile replays recorded noise for reproducible
    tests, --snrshow prints the measured SNR (csdr.c:3035-3091).  The
    noise of chunk k is drawn on the device from a generator seeded k, as
    csdr_tpu seeds its PRNG per chunk (other samples, the same
    statistics)."""
    from csdr_tpu_torch.ops import noise
    snr = _f(args, 0)
    snrshow = "--snrshow" in args
    awgn_data = None
    if "--awgnfile" in args:
        path = args[args.index("--awgnfile") + 1]
        awgn_data = np.fromfile(path, np.float32).reshape(-1, 2)
    r = 10.0 ** (snr / 20.0)
    a_signal = r / (r + 1.0)
    a_noise = 0.707 / (r + 1.0)
    sys.stderr.write(f"awgn_cc: a_signal = {a_signal:f}, "
                     f"a_noise = {a_noise / 0.707:f}\n")
    seed_box = {"n": 0, "pos": 0}

    def _file_noise(n, dev):
        out = np.empty((n, 2), np.float32)
        pos = seed_box["pos"]
        total = len(awgn_data)
        got = 0
        while got < n:
            take = min(n - got, total - pos)
            out[got:got + take] = awgn_data[pos:pos + take]
            pos = (pos + take) % total
            got += take
        seed_box["pos"] = pos
        return torch.view_as_complex(_upload(out, dev))

    def apply(state, x):
        if awgn_data is None:
            nz = noise.gaussian_noise_c(x.shape[0], seed_box["n"], x.device)
            seed_box["n"] += 1
        else:
            nz = _file_noise(x.shape[0], x.device)
        sig = torch.complex(x.real * a_signal, x.imag * a_signal)
        nza = torch.complex(nz.real * a_noise, nz.imag * a_noise)
        if snrshow:
            ps = 10.0 * np.log10(float(torch.mean(
                sig.real ** 2 + sig.imag ** 2)) + 1e-30)
            pn = 10.0 * np.log10(float(torch.mean(
                nza.real ** 2 + nza.imag ** 2)) + 1e-30)
            sys.stderr.write(f"awgn_cc: SNR = {ps - pn:f} dB\n")
        return state, torch.complex(sig.real + nza.real, sig.imag + nza.imag)

    # a fresh generator (or the next file block) a chunk: uncaptured, as
    # csdr_tpu pumps it unjitted (cli.py:1787)
    pump(FnBlock("awgn", lambda dev: None, apply), "c", "c", jit=False)


@command("uniform_noise_f")
def _c_unoise(args):
    """Uniform noise in [-1, 1), drawn on the device, 65 536 samples a
    write from a generator seeded with the write's number."""
    from csdr_tpu_torch.ops import noise
    n = 0
    while True:
        x = noise.uniform_noise_f(65536, seed=n, device=_dev())
        sys.stdout.buffer.write(x.cpu().numpy().tobytes())
        n += 1


@command("gaussian_noise_c")
def _c_gnoise(args):
    from csdr_tpu_torch.ops import noise
    n = 0
    while True:
        x = noise.gaussian_noise_c(65536, seed=n, device=_dev())
        sys.stdout.buffer.write(torch.view_as_real(x).cpu().numpy().tobytes())
        n += 1


# --- remaining parity commands -----------------------------------------------

@command("fifo")
def _c_fifo(args):
    """Decoupling circular buffer between two pipeline stages: select() on
    nonblocking stdin/stdout, drop-oldest on overrun (reference
    csdr.c:447-531).  Host-only."""
    from collections import deque
    buffer_size = _i(args, 0)
    num_buffers = _i(args, 1)
    if _dynamic_bufsize_on():
        sendbufsize(getbufsize())
    q = deque()
    partial = b""
    os.set_blocking(sys.stdin.fileno(), False)
    os.set_blocking(sys.stdout.fileno(), False)
    overrun_shown = False
    in_open = True
    while in_open or q:
        rfds = [sys.stdin.fileno()] if in_open else []
        wfds = [sys.stdout.fileno()] if q else []
        r, w, _ = select.select(rfds, wfds, [], 1.0)
        if r:
            while True:
                try:
                    data = os.read(sys.stdin.fileno(), buffer_size)
                except BlockingIOError:
                    break
                if not data:
                    in_open = False
                    if partial:
                        q.append(partial)
                        partial = b""
                    break
                partial += data
                while len(partial) >= buffer_size:
                    q.append(partial[:buffer_size])
                    partial = partial[buffer_size:]
                    if len(q) > num_buffers:
                        q.popleft()
                        if not overrun_shown:
                            overrun_shown = True
                            sys.stderr.write(
                                "fifo: circular buffer full, dropping "
                                "samples\n")
                    else:
                        overrun_shown = False
        if w and q:
            buf = q.popleft()
            try:
                written = os.write(sys.stdout.fileno(), buf)
                if written < len(buf):
                    q.appendleft(buf[written:])
            except BlockingIOError:
                q.appendleft(buf)
            except BrokenPipeError:
                return 1
    return 0


@command("tee")
def _c_tee(args):
    """Passthrough + asynchronous file branch: the file writer runs on its
    own thread over a bounded queue and drops buffers rather than stalling
    the main stream (reference csdr.c:3323-3363).  Host-only."""
    import threading
    from collections import deque
    if not args:
        raise SystemExit("required parameter <path> is missing.")
    path = args[0]
    num_buffers = _i(args, 1, 100)
    if _dynamic_bufsize_on():
        # reference tee relays the negotiated size (csdr.c:3334)
        sendbufsize(getbufsize())
    f = open(path, "wb")
    sys.stderr.write(f"tee: file opened: {path}\n")
    q = deque(maxlen=num_buffers)
    stop = False
    cond = threading.Condition()

    def writer():
        while True:
            with cond:
                while not q and not stop:
                    cond.wait()
                if not q and stop:
                    return
                buf = q.popleft()
            f.write(buf)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    while True:
        data = stdin.read(65536)
        if not data:
            break
        stdout.write(data)
        stdout.flush()
        with cond:
            if len(q) == num_buffers:
                sys.stderr.write("tee: circular buffer overflow\n")
            q.append(data)
            cond.notify()
    with cond:
        stop = True
        cond.notify()
    t.join()
    f.close()
    return 0


@command("shift_addition_fc")
def _c_shift_fc(args):
    """Real -> complex modulator shift (reference libcsdr_gpl.c:54-79)."""
    from csdr_tpu_torch.ops import shift
    # ShiftBlock: shift_fc's NCO with its ramp on the card and its phase a
    # value leaf of the captured step
    blk = shift.shift_block(_f(args, 0), "shift_fc")

    def apply(phase, x):
        x = x.float()
        return blk(phase, torch.complex(x, torch.zeros_like(x)))

    pump(FnBlock("shift_fc", blk.init, apply), "f", "c")


@command("shift_addition_cc_test")
def _c_shift_test(args):
    """NCO accuracy self-test: error vector (dB) of the float32 direct NCO
    against a float64 oscillator over 500k samples (the reference tests its
    trig recurrence the same way, libcsdr_gpl.c:94-124); stderr gets each
    form's time (CUDA events on the card)."""
    from csdr_tpu_torch.ops import shift
    rate = _f(args, 0, 0.24567)
    n = 500_000
    dev = _dev()
    ones = torch.ones(n, dtype=torch.complex64, device=dev)
    # float64 oracle at the float32-quantized rate for the traced form
    # (the NCO's job there is frac(k*rate_f32))
    rate32 = float(np.float32(rate))
    k = np.arange(n, dtype=np.float64)
    for label, r in (("static (host f64 ramp)", rate),
                     ("traced (digit-split NCO, retune path)",
                      torch.tensor(rate, dtype=torch.float32))):
        y, _ = shift.shift_cc(ones, r, 0.0)
        ref = np.exp(2j * np.pi * ((k * (rate if label.startswith("static")
                                         else rate32)) % 1.0))
        err = np.abs(y.cpu().numpy().astype(np.complex128) - ref) ** 2
        ev = 10 * np.log10(np.mean(err) + 1e-300)
        print(f"error vector = {ev:.2f} dB over {n} samples at rate {rate} "
              f"[{label}]")
        ms = _time_ms(lambda: shift.shift_cc(ones, r, 0.0), 5)
        sys.stderr.write(f"shift_addition_cc_test: {ms:.3f} ms a call "
                         f"[{label}, {dev.type}]\n")
    return 0


@command("old_fractional_decimator_ff")
def _c_oldfracdec(args):
    """Deprecated linear-interp fractional decimator (libcsdr.c:682-713),
    host-only: host numpy, as csdr_tpu's."""
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.ops import resamp
    rate = _f(args, 0)
    taps = None
    if len(args) > 1:
        bw = float(args[1])
        win = _window(args, 2)
        taps = firdes.firdes_lowpass_f(firdes.firdes_filter_len(bw),
                                       0.5 / rate, win)
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    remain, pend = 0.0, np.zeros(0, np.float32)
    while True:
        data = stdin.read(1 << 18)
        if not data:
            break
        x = np.concatenate([pend, np.frombuffer(data, np.float32)])
        y, used, remain = resamp.old_fractional_decimator_ff(x, rate, taps,
                                                             remain)
        pend = x[used:]
        stdout.write(np.asarray(y, np.float32).tobytes())
        stdout.flush()
    return 0


@command("plain_interpolate_cc")
def _c_plainint(args):
    """Zero-stuffing interpolator (reference libcsdr.c:2499-2506)."""
    from csdr_tpu_torch.ops import fir
    interp = _i(args, 0)
    _stateless_pump(lambda x: fir.plain_interpolate_cc(x, interp), "c", "c")


@command("suboptimal_rational_resampler_ff")
def _c_subopt_rr(args):
    """The reference maps this name onto the normal rational resampler with
    a stderr note (csdr.c:1408-1431; the suboptimal path itself is
    commented out at csdr.c:1456), and so does this."""
    sys.stderr.write("note: suboptimal rational resampler chosen.\n")
    return REGISTRY["rational_resampler_ff"](args)


@command("firdes_peak_c")
def _c_firdes_peak(args):
    """Peak-filter tap dump: <rate> <length> [window] (csdr.c:2932-2973)."""
    from csdr_tpu_torch import firdes
    rate = _f(args, 0)
    length = _i(args, 1)
    if length % 2 == 0:
        raise SystemExit("number of symmetric FIR filter taps should be odd")
    win = _window(args, 2)
    _dump_taps_complex(firdes.firdes_add_peak_c(length, [rate], win),
                       "--octave" in args)


@command("rtty_line_decoder_u8_u8")
def _c_rtty_line(args):
    """Framed bit symbols -> ASCII via the baudot start/stop state machine
    (reference csdr.c:2446-2459 over rtty_baudot_decoder_push): one launch
    of the Baudot kernel a chunk on the command's device."""
    from csdr_tpu_torch.kernels import baudot_cuda
    from csdr_tpu_torch.ops import digital

    def apply(state, x):
        out, state = digital.rtty_baudot_decoder(x, state=state)
        return state, out

    pump(FnBlock("rtty", lambda dev: baudot_cuda.zero_state((), dev), apply),
         "u8", "u8")


@command("rtty_baudot2ascii_u8_u8")
def _c_rtty_b2a(args):
    """Direct 5-bit baudot codes -> ASCII (reference csdr.c:2461-2474)."""
    from csdr_tpu_torch.ops import digital

    def apply(mode, x):
        out, mode = digital.rtty_baudot2ascii_u8_u8(x, mode)
        return mode, out

    pump(FnBlock("b2a", lambda dev: _scalar0(0, torch.int32, dev), apply),
         "u8", "u8")


@command("octave_complex_c")
def _c_octave_c(args):
    """Octave plot scripts of the first <samples_to_plot> of every
    <out_of_n_samples> complex samples (reference csdr.c:2647-2682).
    Host-only."""
    nplot = _i(args, 0)
    out_of = _i(args, 1)
    mode2d = "--2d" in args
    if out_of < nplot:
        raise SystemExit("out_of_n_samples should be >= samples_to_plot")
    stdin = sys.stdin.buffer
    while True:
        data = stdin.read(8 * nplot)
        if len(data) < 8 * nplot:
            break
        iq = np.frombuffer(data, np.float32).reshape(-1, 2)
        print(f"N = {nplot};\nisig = [" +
              " ".join(f"{v:f}" for v in iq[:, 0]) + "];\nqsig = [" +
              " ".join(f"{v:f}" for v in iq[:, 1]) + "];\nzsig = [0:N-1];")
        if mode2d:
            print("subplot(2,1,1);\nplot(zsig,isig);\n"
                  "subplot(2,1,2);\nplot(zsig,qsig);")
        else:
            print("plot3(isig,zsig,qsig);")
        sys.stdout.flush()
        skip = (out_of - nplot) * 8
        while skip > 0:
            d = stdin.read(min(skip, 1 << 16))
            if not d:
                return 0
            skip -= len(d)
    return 0


@command("_fft2octave")
def _c_fft2octave(args):
    """Live octave spectrum plot driver (reference csdr.c:2380-2405).
    Host-only."""
    fft_size = _i(args, 0)
    print(f'setenv("GNUTERM","X11 noraise");y=zeros(1,{fft_size});'
          'semilogy(y,"ydatasource","y");')
    stdin = sys.stdin.buffer
    while True:
        data = stdin.read(8 * fft_size)
        if len(data) < 8 * fft_size:
            break
        iq = np.frombuffer(data, np.float32).reshape(-1, 2)
        half = fft_size // 2
        swapped = np.concatenate([iq[half:], iq[:half]])
        print("fftdata=[" +
              " ".join(f"({i:g})+({q:g})*i" for i, q in swapped) +
              "];\ny=abs(fftdata);\nrefreshdata;")
        sys.stdout.flush()
    return 0


@command("syncword_search")
def _c_syncword(args):
    """Find a hex syncword in a bit stream (u8 0/1 a bit) and print the bits
    after each hit (csdr_tpu's working equivalent of the reference's
    unfinished draft, csdr.c:3500-3531).  Host-only."""
    if len(args) < 2:
        raise SystemExit("need <syncword_hex> <bits_after>")
    word = args[0]
    bits_after = int(args[1])
    pattern = np.array(
        [(int(c, 16) >> j) & 1 for c in word for j in (3, 2, 1, 0)], np.uint8)
    sys.stderr.write(f"syncword = 0x{word}, n_bits = {len(pattern)}\n")
    from csdr_tpu_torch.ops import digital
    data = sys.stdin.buffer.read()
    out = digital.pattern_search_u8_u8(np.frombuffer(data, np.uint8),
                                       pattern, bits_after)
    sys.stdout.buffer.write(np.asarray(out, np.uint8).tobytes())
    return 0


@command("--help")
def _c_help(args):
    """--help: list all commands with syntax; --help <cmd>: one command's
    usage (reference csdr.c:3570-3597 prints usage[])."""
    if args:
        u = usage_for(args[0])
        if u:
            sys.stderr.write(u)
            doc = REGISTRY.get(args[0], lambda a: None).__doc__
            if doc:
                sys.stderr.write("  " + doc.strip().split("\n")[0] + "\n")
            return 0
        sys.stderr.write(f"csdr_tpu_torch: unknown command {args[0]}\n")
        return 1
    sys.stderr.write(USAGE_NOTE)
    for name in sorted(REGISTRY):
        if not name.startswith("-"):
            sys.stderr.write(f"    {USAGE.get(name, name)}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
