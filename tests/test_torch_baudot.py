"""The RTTY Baudot decoder's kernel wrapper (``kernels/baudot_cuda``) on
the CPU, where it runs its plain version, against csdr_tpu bit for bit,
streamed; a Python model of the kernel's machine (csrc/baudot.cu) against
the plain version from any carried state, and of the transition its
bound's probe times; and the CLI's
rtty_line_decoder_u8_u8, which now runs on the command's device, against
csdr_tpu's bytes (with ``--device cpu``) and refusing without a card.  On
the card the kernel is held against the plain version bit for bit
(tests/test_torch_kernels.py, chip_smoke.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from csdr_tpu.ops import digital as jdig

from csdr_tpu_torch.kernels import baudot_cuda
from csdr_tpu_torch.ops import digital as tdig

from test_torch_cli import ROOT, run_both

torch.set_num_threads(2)


def _rtty_symbols(rng, n_chars):
    """Start bit 0, five data bits, stop bits 1, with random idle gaps."""
    out = []
    for _ in range(n_chars):
        out += [1] * int(rng.integers(1, 4))
        out += [0] + list(rng.integers(0, 2, 5)) + [1, 1]
    return np.asarray(out, np.uint8)


def _tables():
    return tdig._baudot_tables(torch.device("cpu"))


def test_decode_wrapper_matches_csdr_tpu_streamed():
    """Two rows of framed symbols (mode selects among them) in three calls
    with the state carried: each row's characters, count and state are
    csdr_tpu's bit for bit; a small cap drops the characters past it."""
    rng = np.random.default_rng(5)
    rows = [_rtty_symbols(rng, 80)[:600] for _ in range(2)]
    rows = np.stack(rows)
    cuts = (0, 170, 431, 600)
    st = baudot_cuda.zero_state((2,), "cpu")
    js = [None, None]
    for a, b in zip(cuts[:-1], cuts[1:]):
        part = rows[:, a:b]
        cap = (b - a) // 7 + 4
        data, count, st = baudot_cuda.decode(torch.from_numpy(part), cap, st,
                                             *_tables())
        for r in range(2):
            jo, js[r] = jdig.rtty_baudot_decoder(part[r], state=js[r])
            assert int(count[r]) == int(jo.count)
            np.testing.assert_array_equal(data[r].numpy(), np.asarray(jo.data))
            assert [int(t[r]) for t in st] == [int(v) for v in js[r]]
    data, count, _ = baudot_cuda.decode(torch.from_numpy(rows), 3,
                                        baudot_cuda.zero_state((2,), "cpu"),
                                        *_tables())
    for r in range(2):
        jo, _ = jdig.rtty_baudot_decoder(rows[r], max_out=3)
        assert int(count[r]) == int(jo.count) == 3
        np.testing.assert_array_equal(data[r].numpy(), np.asarray(jo.data))


def _kernel_model(sym, cap, state, letters, figures):
    """csrc/baudot.cu's machine in Python integers (int32 arithmetic
    wrapping as the kernel's unsigned forms do), one row."""
    def i32(v):
        return (v + (1 << 31)) % (1 << 32) - (1 << 31)

    st, fig, shr, cnt, rcvd = (int(v) for v in state)
    out = []
    for s in sym:
        one = int(s) != 0
        code = shr & 31
        is_fig, is_let = code == 27, code == 31
        ch = int(figures[code] if fig != 0 else letters[code])
        n = [st, fig, shr, cnt, rcvd]
        if st == 0:
            if one and rcvd != 0:
                if is_fig:
                    n[1] = 1
                elif is_let:
                    n[1] = 0
                elif ch != 0:
                    out.append(ch)
            n[0] = 1 if one else 0
            n[4] = rcvd if one else 0
        elif st == 1:
            if not one:
                n[0], n[2], n[3] = 2, 0, 0
            n[4] = 0
        else:
            done = cnt == 4
            if st == 2:
                n[2] = ((shr << 1) | int(one)) & 0xFFFF
                n[3] = i32(cnt + 1)
            n[0] = 0 if done else 2
            n[4] = 1 if done else rcvd
        st, fig, shr, cnt, rcvd = n
    data = np.zeros(cap, np.uint8)
    data[:min(len(out), cap)] = out[:cap]
    return data, min(len(out), cap), (st, fig, shr, cnt, rcvd)


def _transition_model(sym, state):
    """csrc/baudot.cu's baudot_next, the chain its probe times (the
    transition alone, branch-free, as selects), one row; returns the last
    state."""
    def i32(v):
        return (v + (1 << 31)) % (1 << 32) - (1 << 31)

    st, fig, shr, cnt, rcvd = (int(v) for v in state)
    for s in sym:
        one = int(s) != 0
        code = shr & 31
        s0, s1, s2 = st == 0, st == 1, st == 2
        done = cnt == 4
        sel = s0 and one and rcvd != 0
        start = s1 and not one
        fig = 1 if sel and code == 27 else 0 if sel and code == 31 else fig
        st, rcvd, shr, cnt = (
            (1 if one else 0) if s0 else (1 if one else 2) if s1 else
            (0 if done else 2),
            (rcvd if one else 0) if s0 else 0 if s1 else
            (1 if done else rcvd),
            0 if start else ((shr << 1) | int(one)) & 0xFFFF if s2 else shr,
            0 if start else i32(cnt + 1) if s2 else cnt)
    return st, fig, shr, cnt, rcvd


def _any_states(rng, rows):
    """Carried states the stream never makes (a machine state of -1, 3 or
    7, a counter at -1, 4 or int32's top, any shift register) and the usual
    ones, (5, rows) int32."""
    return np.stack([
        rng.choice([-1, 0, 1, 2, 3, 7], rows),
        rng.choice([0, 1, 5], rows),
        rng.integers(-(1 << 31), 1 << 31, rows, dtype=np.int64),
        rng.choice([-1, 0, 3, 4, 5, (1 << 31) - 1], rows),
        rng.choice([0, 1, -3], rows)]).astype(np.int32)


def test_kernel_model_matches_plain_from_any_state():
    """The kernel's machine (modelled here) against decode_plain from
    carried states the stream never makes (a machine state of -1, 3 or 7,
    a counter at -1, 4 or int32's top, any shift register) and from the
    usual ones, over random symbols (any nonzero byte a 1), caps small
    enough to drop characters: bit for bit."""
    rng = np.random.default_rng(6)
    letters, figures = (t.numpy() for t in _tables())
    rows, n = 48, 300
    states = _any_states(rng, rows)
    framed = np.stack([_rtty_symbols(rng, 50)[:n] for _ in range(rows)])
    noise = rng.integers(0, 3, (rows, n)).astype(np.uint8) * 7
    sym = np.where(np.arange(rows)[:, None] % 2 == 0, framed, noise)
    for cap in (2, n // 7 + 4):
        data, count, st = baudot_cuda.decode_plain(
            torch.from_numpy(sym), cap,
            tuple(torch.from_numpy(s) for s in states),
            *(torch.from_numpy(t) for t in (letters, figures)))
        for r in range(rows):
            d, c, s = _kernel_model(sym[r], cap, states[:, r], letters,
                                    figures)
            assert int(count[r]) == c, r
            np.testing.assert_array_equal(data[r].numpy(), d)
            assert [int(t[r]) for t in st] == list(s), r


def test_probe_transition_model_matches_plain_from_any_state():
    """The chain the decoder's bound is probed on (the machine's transition
    alone, branch-free; modelled here) ends in decode_plain's state from
    any carried state, over framed symbols and noise (any nonzero byte a
    1): what lets it stand for the machine."""
    rng = np.random.default_rng(16)
    rows, n = 48, 300
    states = _any_states(rng, rows)
    framed = np.stack([_rtty_symbols(rng, 50)[:n] for _ in range(rows)])
    noise = rng.integers(0, 3, (rows, n)).astype(np.uint8) * 7
    sym = np.where(np.arange(rows)[:, None] % 2 == 0, framed, noise)
    _, _, st = baudot_cuda.decode_plain(
        torch.from_numpy(sym), 4, tuple(torch.from_numpy(s) for s in states),
        *_tables())
    for r in range(rows):
        assert [int(t[r]) for t in st] == list(
            _transition_model(sym[r], states[:, r])), r


def test_cli_rtty_line_decoder_cpu_is_csdr_tpus():
    """rtty_line_decoder_u8_u8 with --device cpu, pumped at 200 symbols a
    chunk (the machine's state carried across chunks): csdr_tpu's bytes."""
    rng = np.random.default_rng(7)
    sym = _rtty_symbols(rng, 300)
    (rj, oj, ej), (rt, ot, et) = run_both(
        "rtty_line_decoder_u8_u8", [], sym.tobytes(),
        env={"CSDR_FIXED_BUFSIZE": "200"})
    assert rj == rt == 0 and et == ej
    assert len(ot) > 100 and ot == oj


@pytest.mark.parametrize("device", [None, "cpu"])
def test_cli_rtty_line_decoder_refuses_without_cuda(device):
    """No CUDA (CUDA_VISIBLE_DEVICES empty) and no --device cpu: the
    command exits non-zero and writes nothing, like every device command;
    with --device cpu it decodes."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    sym = _rtty_symbols(np.random.default_rng(8), 40)
    argv = [sys.executable, "-m", "csdr_tpu_torch.cli",
            "rtty_line_decoder_u8_u8"] + (["--device", device] if device
                                          else [])
    p = subprocess.run(argv, input=sym.tobytes(), capture_output=True,
                       cwd=ROOT, env=env, timeout=120)
    if device is None:
        assert p.returncode != 0 and p.stdout == b""
        assert b"CUDA is not available" in p.stderr, p.stderr
    else:
        assert p.returncode == 0 and len(p.stdout) > 10, p.stderr
