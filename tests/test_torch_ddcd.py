"""The port's ddcd DDC server (csdr_tpu_torch.server.ddcd) on the CPU:
its device step against csdr_tpu's DdcdServer in-process with the same
set_shift calls, csdr_tpu's server state loaded into the port, and the
server over real loopback sockets (the Python front, the native C++ front
from native/, and the module entry points).

The outputs meet csdr_tpu's at a max error relative to the peak of 5e-5
(tests/test_torch_fastddc.py's bar); host rows, counts, carried phases
and tails bit for bit.  Every socket read and thread join has a deadline
of at most 30 s, and every server's listen socket is closed by the end of
its test.
"""

import io
import os
import queue
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from csdr_tpu.server.ddcd import DdcdServer as JServer

import csdr_tpu_torch
from csdr_tpu_torch.core.checkpoint import state_to_numpy_leaves
from csdr_tpu_torch.ops import fastddc as tfd
from csdr_tpu_torch.server import ddcd as tddcd

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
NATIVE = ROOT / "native"
REL_BAR = 5e-5
DEADLINE = 30.0


def _rel(ref, got):
    return np.abs(ref - got).max() / np.abs(ref).max()


def _noise(rng, n):
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _recv_n(sock, n, timeout=DEADLINE):
    sock.settimeout(timeout)
    data = b""
    while len(data) < n:
        chunk = sock.recv(n - len(data))
        if not chunk:
            break
        data += chunk
    assert len(data) == n, f"received {len(data)} of {n} bytes"
    return data


def _connect(port, alive=lambda: True):
    end = time.time() + DEADLINE
    while True:
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=5)
        except OSError:
            assert alive(), "the server ended"
            assert time.time() < end, f"nothing listens on {port}"
            time.sleep(0.05)


def _wait(cond, what):
    end = time.time() + DEADLINE
    while not cond():
        assert time.time() < end, f"timed out waiting for {what}"
        time.sleep(0.01)


def _peak(payload: bytes) -> float:
    """Strongest frequency (cycles/sample) of interleaved f32 I/Q."""
    y = np.frombuffer(payload, np.complex64)
    spec = np.abs(np.fft.fft(y * np.hanning(len(y))))
    f = np.argmax(spec) / len(y)
    return f - 1.0 if f >= 0.5 else f


def _tones(n, freqs, seed=0):
    s = np.arange(n, dtype=np.float64)
    rng = np.random.default_rng(seed)
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for f in freqs:
        x = x + np.exp(2j * np.pi * np.mod(f * s, 1.0))
    return x.astype(np.complex64)


# --------------------------------------------------------------------------
# the device step against csdr_tpu, in-process
# --------------------------------------------------------------------------

def _j_state(srv):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(srv.state)]


def _history(srv, leaves):
    """The history leaves of a csdr_tpu server state (its channelizer also
    carries the DFT and iDFT matrices, which the port keeps as buffers)."""
    return leaves[:3] if srv.method == "fastddc" and srv.factored \
        else leaves


@pytest.mark.parametrize("d,method,frames", [
    (16, "fastddc", 8), (50, "fastddc", 25), (4, "fastddc", 6),
    (16, "td", 2)], ids=["d16_factored", "d50_classed", "d4_factored",
                         "d16_td"])
def test_run_chunk_matches_jax(d, method, frames):
    """Claims, a retune, a release and a retune back over four chunks: the
    host rows, outputs, counts and carried state chunk by chunk; then
    csdr_tpu's state loads into a fresh port server, which runs a fifth
    chunk as csdr_tpu does."""
    c = 4
    js = JServer(d, 0.05, c, method, frames, port=0)
    ts = tddcd.DdcdServer(d, 0.05, c, method, frames, port=0, device="cpu")
    assert ts.chunk_in == js.chunk_in and ts.factored == js.factored
    start = {0: -0.11, 1: 0.23, 3: 0.3}

    def both(fn):
        for s in (js, ts):
            fn(s)

    def release(s):
        with s.lock:
            s._zero_slot_locked(0)

    events = {1: lambda s: s.set_shift(1, -0.31), 2: release,
              3: lambda s: s.set_shift(1, start[1])}
    for slot, r in start.items():
        both(lambda s: s.set_shift(slot, r))
    rows0 = [a.copy() for a in ts._host_rows()]
    rng = np.random.default_rng(d)
    for k in range(4):
        if k in events:
            both(events[k])
        jrows = ((js.rate_np,) if method == "td"
                 else (js.tq_np, js.d_np, js.rate_np) if js.factored
                 else (js.fold_np, js.rate_np))
        for a, b in zip(ts._host_rows(), jrows, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        x = _noise(rng, js.chunk_in)
        dr, di, cj = js._run_chunk(x)
        data, ct = ts._run_chunk(x)
        np.testing.assert_array_equal(ct, cj)
        assert data.dtype == np.complex64 and data.shape == dr.shape
        assert _rel(dr + 1j * di, data) < REL_BAR
        if k >= 2 and method == "fastddc":
            assert not np.any(data[0])                  # released slot
        elif k >= 2:
            # td, as csdr_tpu: a released slot is retuned to shift 0, so
            # it carries the unclaimed slot 2's channel, turned by its phase
            turn = np.vdot(data[2], data[0]) / np.vdot(data[2], data[2])
            assert abs(abs(turn) - 1) < 1e-5
            assert np.abs(data[0] - turn * data[2]).max() \
                < 1e-5 * np.abs(data[2]).max()
        for a, b in zip(state_to_numpy_leaves(ts.state),
                        _history(js, _j_state(js))):
            np.testing.assert_array_equal(a, b)
    # retuning back rewrote the slot's rows bit for bit
    back = ts._host_rows()
    if method == "fastddc" and not ts.factored:
        w = ts._block_cols
        np.testing.assert_array_equal(back[0][..., w:2 * w],
                                      rows0[0][..., w:2 * w])
    else:
        for a, b in zip(back, rows0):
            np.testing.assert_array_equal(a[1], b[1])

    fresh = tddcd.DdcdServer(d, 0.05, c, method, frames, port=0,
                             device="cpu")
    for slot, r in start.items():
        fresh.set_shift(slot, r)
    with fresh.lock:
        fresh._zero_slot_locked(0)
    fresh.state = csdr_tpu_torch.state_from_jax_leaves(
        fresh, _j_state(js), device="cpu")
    x = _noise(rng, js.chunk_in)
    dr, di, _ = js._run_chunk(x)
    data, _ = fresh._run_chunk(x)
    assert _rel(dr + 1j * di, data) < REL_BAR


def test_server_state_from_jax_refuses_other_plans():
    js = JServer(16, 0.05, 2, "fastddc", 8, port=0)
    with pytest.raises(ValueError):
        csdr_tpu_torch.state_from_jax_leaves(
            tddcd.DdcdServer(16, 0.05, 3, "fastddc", 8, port=0,
                             device="cpu"), _j_state(js), device="cpu")
    jt = JServer(16, 0.05, 2, "td", 2, port=0)
    with pytest.raises(ValueError):
        csdr_tpu_torch.state_from_jax_leaves(
            tddcd.DdcdServer(50, 0.05, 2, "td", 2, port=0, device="cpu"),
            _j_state(jt), device="cpu")


# --------------------------------------------------------------------------
# sockets: the Python front in-process
# --------------------------------------------------------------------------

class _Fed:
    """A server's ``serve``/``serve_native`` in a thread, its input a pipe
    fed one chunk at a time by a feeder thread."""

    def __init__(self, srv, target, *args):
        r, w = os.pipe()
        self.pipe = os.fdopen(w, "wb")
        self.todo: queue.Queue = queue.Queue()
        self.feeder = threading.Thread(target=self._feed, daemon=True)
        self.thread = threading.Thread(
            target=target, args=args + (os.fdopen(r, "rb"),), daemon=True)
        self.feeder.start()
        self.thread.start()

    def _feed(self):
        try:
            while (data := self.todo.get()) is not None:
                self.pipe.write(data)
                self.pipe.flush()
        except OSError:
            pass
        finally:
            self.pipe.close()

    def feed(self, x: np.ndarray):
        self.todo.put(x.tobytes())

    def close(self):
        self.todo.put(None)
        self.feeder.join(DEADLINE)
        self.thread.join(DEADLINE)
        assert not self.thread.is_alive(), "the server did not end at EOF"


def _rows_of(srv, slot):
    return srv.tq_np[slot].copy()


def test_serve_two_clients_retune_bypass_release():
    port = _free_port()
    srv = tddcd.DdcdServer(16, 0.05, max_channels=4, method="fastddc",
                           frames=64, port=port, device="cpu")
    n = srv.chunk_in
    per_chunk = 64 * (srv.ddc.post_input_size // srv.ddc.post_decimation)
    x = _tones(4 * n, (0.11 + 0.005, -0.27 - 0.008), seed=1)
    chunks = [x[i * n:(i + 1) * n] for i in range(4)]
    want = {r: tfd.dynamic_channelizer_rows(srv.ddc, r)[0]
            for r in (-0.11, 0.27)}
    fed = _Fed(srv, srv.serve)
    c1 = c2 = None
    try:
        c1 = _connect(port, fed.thread.is_alive)
        _wait(lambda: len(srv.clients) == 1, "the first client's slot")
        c2 = _connect(port)
        _wait(lambda: len(srv.clients) == 2, "the second client's slot")
        c1.sendall(b"shift=-0.11\n")
        c2.sendall(b"shift=0.27\n")
        _wait(lambda: np.array_equal(_rows_of(srv, 0), want[-0.11])
              and np.array_equal(_rows_of(srv, 1), want[0.27]),
              "both shifts")
        fed.feed(chunks[0])
        p1, p2 = (_peak(_recv_n(c, per_chunk * 8)) for c in (c1, c2))
        assert abs(p1 - 0.005 * 16) < 1e-3 and abs(p2 + 0.008 * 16) < 1e-3
        # c1 retunes mid-stream to c2's channel
        c1.sendall(b"shift=0.27\n")
        _wait(lambda: np.array_equal(_rows_of(srv, 0), want[0.27]),
              "the retune")
        fed.feed(chunks[1])
        p1, p2 = (_peak(_recv_n(c, per_chunk * 8)) for c in (c1, c2))
        assert abs(p1 + 0.008 * 16) < 1e-3 and abs(p2 + 0.008 * 16) < 1e-3
        # c2 switches to the raw wideband stream
        c2.sendall(b"bypass=1\n")
        _wait(lambda: any(cl.bypass for cl in srv.clients.values()),
              "bypass")
        fed.feed(chunks[2])
        assert _recv_n(c2, n * 8) == chunks[2].tobytes()
        _recv_n(c1, per_chunk * 8)
        # a client that leaves frees its slot: its rows go to zero
        c1.close()
        _wait(lambda: len(srv.clients) == 1 and not srv.tq_np[0].any(),
              "the release")
        fed.feed(chunks[3])
        assert _recv_n(c2, n * 8) == chunks[3].tobytes()
    finally:
        fed.close()
        for c in (c1, c2):
            if c is not None:
                c.close()
    assert not srv.running
    with pytest.raises(OSError):            # the listen socket is closed
        socket.create_connection(("127.0.0.1", port), timeout=2).close()


# --------------------------------------------------------------------------
# the native C++ front (native/build/ddcd_front)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def native_build():
    subprocess.run(["make", "-C", str(NATIVE)], check=True,
                   capture_output=True, timeout=300)
    return NATIVE / "build"


def test_serve_native_front(native_build):
    front = tddcd.default_front_bin()
    assert front == str(native_build / "ddcd_front")
    port = _free_port()
    srv = tddcd.DdcdServer(16, 0.05, max_channels=4, method="td", frames=2,
                           port=port, device="cpu")
    n = srv.chunk_in
    x = _tones(3 * n, (0.11 + 0.005,), seed=2)
    fed = _Fed(srv, srv.serve_native, front)
    c1 = c2 = None
    try:
        c1 = _connect(port, fed.thread.is_alive)
        c2 = _connect(port)
        # c2's lines arrive in order: once its shift shows, bypass is set
        c2.sendall(b"bypass=1\nshift=0.05\n")
        c1.sendall(b"shift=-0.11\n")
        _wait(lambda: srv.rate_np[0] == np.float32(-0.11)
              and srv.rate_np[1] == np.float32(0.05), "both commands")
        for i in range(2):
            fed.feed(x[i * n:(i + 1) * n])
        y = _recv_n(c1, 2 * (n // 16) * 8)
        assert abs(_peak(y[(n // 16) * 8:]) - 0.005 * 16) < 1e-3
        assert _recv_n(c2, 2 * n * 8) == x[:2 * n].tobytes()
        c1.close()
        _wait(lambda: srv.rate_np[0] == 0 and srv.dirty, "the release")
    finally:
        fed.close()
        for c in (c1, c2):
            if c is not None:
                c.close()


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def test_main_raises_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = _free_port()
    argv = ["--port", str(port), "--decimation", "16", "--frames", "2"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tddcd.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tddcd.DdcdServer(16, method="td")
    # with the CPU asked for, it serves an empty input and returns
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(b"")))
    assert tddcd.main(argv + ["--device", "cpu", "--method", "td"]) == 0


def test_module_entry_points(native_build):
    """``python -m csdr_tpu_torch.server.ddcd --device cpu`` serves a
    client its tone; ``python -m csdr_tpu_torch.server.nmux`` fans stdin
    out to a client."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "csdr_tpu_torch.server.ddcd", "--port",
         str(port), "--decimation", "16", "--method", "td", "--frames", "2",
         "--max_channels", "2", "--device", "cpu"],
        stdin=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT)
    c = None
    try:
        c = _connect(port, lambda: proc.poll() is None)
        c.sendall(b"shift=-0.11\n")
        time.sleep(0.5)
        x = _tones(8192 * 8, (0.11 + 0.005,), seed=3)
        proc.stdin.write(x.tobytes())
        proc.stdin.close()
        y = _recv_n(c, (len(x) // 16) * 8)
        assert abs(_peak(y[len(y) // 2:]) - 0.005 * 16) < 1e-3
    finally:
        if c is not None:
            c.close()
        proc.terminate()
        proc.wait(timeout=DEADLINE)

    port = _free_port()
    payload = bytes(range(256)) * 64
    proc = subprocess.Popen(
        [sys.executable, "-m", "csdr_tpu_torch.server.nmux", "--port",
         str(port), "--address", "127.0.0.1", "--bufsize", "4096",
         "--bufcnt", "64"], stdin=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env, cwd=ROOT)
    c = None
    try:
        c = _connect(port, lambda: proc.poll() is None)
        time.sleep(0.2)                   # the reader thread registers
        proc.stdin.write(payload)
        proc.stdin.close()
        assert _recv_n(c, len(payload)) == payload
    finally:
        if c is not None:
            c.close()
        proc.terminate()
        proc.wait(timeout=DEADLINE)
