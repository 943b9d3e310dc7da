"""ddcd: a DDC (digital down-converter) server with a channel per TCP
client, on the card (counterpart of csdr_tpu.server.ddcd, the redesign of
the reference's ddcd, ddcd_old.cpp:97-560).

Where the reference forks a ``csdr`` pipeline per client, this server keeps
every client's channel as a row of ONE batched device step:

- **fastddc method**: a divisible plan (post_input_size % post_decimation
  == 0, e.g. D=16) runs the dynamic fused channelizer
  (ops/fastddc.fastddc_dynamic_channelizer_block: the split-DFT product,
  then K4 with this chunk's TQ2/d rows and NCO); another plan (e.g. D=50)
  runs the forward FFT in kernel bin order (K3) and the dynamic classed
  inverse.  A channel's rows are host arrays that a claim, release or
  retune ("shift=<rate>\\n" on the client socket, the protocol of
  ddcd_old.cpp:497-526) rewrites; the device loop copies them, under the
  lock, into the server's row buffers on the card before the next chunk
  when they changed.
- **td method**: the traced-rate NCO shift (ops/shift) of the (C, n)
  chunk, then the shared-taps decimating FIR, K2 once a slot (the
  reference's shift_addfast_cc | fir_decimate_cc per client,
  ddcd_old.h:51-57).

The step (``DdcdServer.step``, csdr_tpu's jitted ``step``) is a pure
``step(state, x) -> (state', (data, count))`` that reads the rows from
buffers allocated once: on the card ``_run_chunk`` calls it as one
``core/graph.CapturedStep``, captured on the first chunk and replayed on
every later one, and since the rows are rewritten in place (in stream
order, before the replay that reads them) a retune needs no new capture.

Commands: ``shift=<rate>`` retunes; ``bypass=1``/``bypass=0`` switch the
client between the raw wideband stream and its channel
(ddcd_old.cpp:504-520).  A slow client loses its oldest buffers instead of
stalling the device loop (tsmpool semantics, native/tsmpool.hpp).  Only the
device-loop thread touches the card.

Usage (the card by default; ``--device cpu`` runs on the CPU):
    ... wideband f32-interleaved I/Q on stdin ...
    python -m csdr_tpu_torch.server.ddcd --port 4953 --decimation 16 \\
        [--method fastddc|td] [--bw 0.05] [--max_channels 8] [--frames 16]
"""

from __future__ import annotations

import argparse
import os
import socket
import struct
import subprocess
import sys
import threading
from collections import deque

import numpy as np
import torch

from csdr_tpu_torch import firdes
from csdr_tpu_torch.core.block import resolve_device
from csdr_tpu_torch.core.graph import CapturedStep
from csdr_tpu_torch.ops import fastddc, fir
from csdr_tpu_torch.ops import shift as shift_ops


class _Client:
    def __init__(self, sock: socket.socket, slot: int):
        self.sock = sock
        self.slot = slot
        self.bypass = False
        self.queue: deque[bytes] = deque(maxlen=64)   # drop-oldest
        self.cond = threading.Condition()
        self.alive = True

    def push(self, data: bytes):
        with self.cond:
            self.queue.append(data)
            self.cond.notify()

    def stop(self):
        with self.cond:
            self.alive = False
            self.cond.notify()


class _DeviceStep:
    """The server's device step, csdr_tpu's jitted ``step``: ``step(state,
    x) -> (state', (data (C, cap) complex64, valid count))`` for x
    (chunk_in,) complex64, the rows read from ``rows`` (card buffers the
    server allocates once and rewrites in place).  It holds nothing of the
    server, so a dropped server frees its graph at once: a graph left to
    Python's cyclic collector can be destroyed in the middle of another
    capture, which that invalidates."""

    def __init__(self, name: str, rows: tuple, chan=None, fwd=None, inv=None,
                 taps=None, decimation: int = 0):
        self.name, self.rows = name, rows
        self.chan, self.fwd, self.inv = chan, fwd, inv
        self.taps, self.decimation = taps, decimation

    @torch.no_grad()
    def __call__(self, state, x: torch.Tensor):
        if self.taps is not None:
            return self._td(state, x, *self.rows)
        if self.chan is not None:
            state, out = self.chan(state, x, *self.rows)
        else:
            fwd_st, inv_st = state
            fwd_st, spectra = self.fwd(fwd_st, x)
            inv_st, out = self.inv(inv_st, spectra, *self.rows)
            state = (fwd_st, inv_st)
        return state, (out.data, out.count)

    def _td(self, state, x: torch.Tensor, rates: torch.Tensor):
        phases, tails = state
        c, n, d = rates.shape[0], x.shape[0], self.decimation
        xcat = torch.cat([tails, x.expand(c, n)], 1)
        y, _ = shift_ops.shift_cc(xcat, rates[:, None], phases[:, None])
        # csdr_tpu's slice: valid mode gives n/D + 1 outputs when
        # (T-1) % D != 0, and the extra one is the next chunk's first
        k = n // d
        need = (k - 1) * d + self.taps.shape[0]
        data = torch.stack([fir.fir_decimate_cc(y[i, :need], self.taps, d)
                            for i in range(c)])
        # the carry advances by the n new samples, in csdr_tpu's
        # digit-split float32 (a naive n*rate would lose ~n*eps cycles)
        nphase = shift_ops._advance_phase(
            phases, shift_ops._frac_mul(n, rates, n + 1))
        return (nphase, xcat[:, n:].clone()), (data, k)


class DdcdServer:
    """The server's state and device loop.  ``device`` is where the step
    runs: the card unless the caller names the CPU (without CUDA, the card
    raises).  ``rows`` are the step's channel rows on ``device``, allocated
    once and rewritten in place; ``step`` is the device step over them
    (:class:`_DeviceStep`), ``_step`` the same captured
    (``core/graph.CapturedStep``: a CUDA graph on the card, the step itself
    on the CPU), and ``state`` the state it returned last, which on the
    card lives in the graph's buffers: clone it to keep it past the next
    chunk."""

    def __init__(self, decimation: int, transition_bw: float = 0.05,
                 max_channels: int = 8, method: str = "fastddc",
                 frames: int = 16, port: int = 4953,
                 address: str = "127.0.0.1", device="cuda"):
        self.device = dev = resolve_device(device)
        self.method = method
        self.decimation = decimation
        self.max_channels = c = max_channels
        self.port, self.address = port, address
        self.clients: dict[int, _Client] = {}
        self.lock = threading.Lock()          # slots + host channel arrays
        self.dirty = True
        self.running = True
        self.rate_np = np.zeros((c,), np.float32)

        self.factored = False
        if method == "fastddc":
            self.ddc = ddc = fastddc.fastddc_init(transition_bw, decimation)
            pis, post = ddc.post_input_size, ddc.post_decimation
            self.factored = pis % post == 0
            if not self.factored:
                # the classed inverse takes whole groups of q frames
                q = post // int(np.gcd(pis, post))
                frames = max(q, (frames // q) * q)
            self.chunk_in = ddc.input_size * frames
            if self.factored:
                self.chan = fastddc.fastddc_dynamic_channelizer_block(
                    ddc, c).to(dev)
                parts = dict(chan=self.chan)
                self.tq_np = np.zeros((c, ddc.pre_decimation,
                                       ddc.fft_inv_size), np.complex64)
                self.d_np = np.zeros((c, fastddc.mpad_for(ddc)),
                                     np.complex64)
            else:
                self.fwd = fastddc.fastddc_fwd_block(ddc,
                                                     spectra_order="kernel")
                self.inv = fastddc.fastddc_inv_dynamic_block(ddc, c).to(dev)
                # per-channel column blocks of the classed G, side by side
                self.fold_np = np.zeros(self.inv.g_shape, np.complex64)
                self._block_cols = self.inv.g_shape[-1] // c
                parts = dict(fwd=self.fwd, inv=self.inv)
        elif method == "td":
            taps = firdes.firdes_lowpass_f(
                firdes.firdes_filter_len(transition_bw), 0.5 / decimation)
            t = len(taps)
            self.tail_len = ((t - 1 + decimation - 1) // decimation) \
                * decimation
            self.chunk_in = frames * 4096 - (frames * 4096) % decimation
            parts = dict(taps=torch.from_numpy(np.asarray(
                taps, np.float32)).to(dev), decimation=decimation)
        else:
            raise ValueError(f"unknown method {method!r}")
        self.rows = tuple(torch.from_numpy(a).to(dev, copy=True)
                          for a in self._host_rows())
        self.state = self.init()
        self.step = _DeviceStep(f"ddcd {method} D={decimation}", self.rows,
                                **parts)
        self._step = CapturedStep(self.step)

    def init(self):
        """The step's state at the stream's start, on ``self.device``."""
        dev = self.device
        if self.method == "td":
            # the carried phase is the NCO phase (radians) at the TAIL's
            # first sample: the overlap is re-shifted at its own phases and
            # the carry advances by the n new samples only
            c = self.max_channels
            return (torch.zeros(c, dtype=torch.float32, device=dev),
                    torch.zeros((c, self.tail_len), dtype=torch.complex64,
                                device=dev))
        if self.factored:
            return self.chan.init(dev)
        return (self.fwd.init(dev), self.inv.init(dev))

    # ---- slot management -------------------------------------------------

    def _claim_slot(self, sock) -> _Client | None:
        with self.lock:
            used = {cl.slot for cl in self.clients.values()}
            free = [i for i in range(self.max_channels) if i not in used]
            if not free:
                return None
            slot = free[0]
            cl = _Client(sock, slot)
            self.clients[id(cl)] = cl
            self._set_shift_locked(slot, 0.0)
            return cl

    def _release(self, cl: _Client):
        with self.lock:
            # idempotent: the rx and the tx thread both call this on a
            # disconnect; only the first (which still finds cl registered)
            # zeroes the slot, which may by the second call belong to a
            # new client that must keep its tune
            if self.clients.pop(id(cl), None) is not None:
                self._zero_slot_locked(cl.slot)
        cl.stop()

    def _set_shift_locked(self, slot: int, rate: float):
        if self.method == "fastddc":
            if self.factored:
                tq2_row, d_row, cyc = fastddc.dynamic_channelizer_rows(
                    self.ddc, rate)
                self.tq_np[slot] = tq2_row
                self.d_np[slot] = d_row
                self.rate_np[slot] = cyc
            else:
                w = self._block_cols
                g, cyc = fastddc.dynamic_channel_cols(self.ddc, rate,
                                                      spectra_order="kernel")
                self.fold_np[..., slot * w:(slot + 1) * w] = g
                self.rate_np[slot] = cyc
        else:
            # the td method feeds `shift=` straight into the NCO (mix by
            # +rate), so a channel centred at -rate comes to baseband, the
            # fastddc method's sign
            self.rate_np[slot] = rate
        self.dirty = True

    def set_shift(self, slot: int, rate: float):
        with self.lock:
            self._set_shift_locked(slot, rate)

    def _zero_slot_locked(self, slot: int):
        """Release a slot's rows: it gives zeros until claimed again."""
        if self.method == "fastddc":
            if self.factored:
                self.tq_np[slot] = 0.0
                self.d_np[slot] = 0.0
            else:
                w = self._block_cols
                self.fold_np[..., slot * w:(slot + 1) * w] = 0.0
        self.rate_np[slot] = 0.0
        self.dirty = True

    def _host_rows(self) -> tuple:
        """The host arrays the step takes, in its argument order."""
        if self.method == "td":
            return (self.rate_np,)
        if self.factored:
            return self.tq_np, self.d_np, self.rate_np
        return self.fold_np, self.rate_np

    # ---- client threads ----------------------------------------------------

    def _client_rx(self, cl: _Client):
        """Parse newline text commands from the client socket."""
        buf = b""
        try:
            while cl.alive:
                data = cl.sock.recv(1024)
                if not data:
                    break
                buf += data
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    self._handle_cmd(cl, line.decode(errors="replace").strip())
        except OSError:
            pass
        self._release(cl)

    def _handle_cmd(self, cl: _Client, line: str):
        if line.startswith("shift="):
            try:
                rate = float(line[6:])
            except ValueError:
                return
            sys.stderr.write(f"ddcd: slot {cl.slot} shift={rate}\n")
            self.set_shift(cl.slot, rate)
        elif line.startswith("bypass="):
            cl.bypass = line[7:].strip() == "1"
            sys.stderr.write(f"ddcd: slot {cl.slot} bypass={cl.bypass}\n")

    def _client_tx(self, cl: _Client):
        try:
            while True:
                with cl.cond:
                    while not cl.queue and cl.alive:
                        cl.cond.wait()
                    if not cl.alive and not cl.queue:
                        break
                    data = cl.queue.popleft()
                cl.sock.sendall(data)
        except OSError:
            pass
        self._release(cl)
        try:
            cl.sock.close()
        except OSError:
            pass

    def _accept_loop(self, lsock):
        while self.running:
            try:
                sock, _ = lsock.accept()
            except OSError:
                break
            cl = self._claim_slot(sock)
            if cl is None:
                sys.stderr.write("ddcd: no free channel slots\n")
                sock.close()
                continue
            sys.stderr.write(f"ddcd: client -> slot {cl.slot}\n")
            threading.Thread(target=self._client_rx, args=(cl,),
                             daemon=True).start()
            threading.Thread(target=self._client_tx, args=(cl,),
                             daemon=True).start()

    # ---- device loop -------------------------------------------------------

    def _run_chunk(self, x_np: np.ndarray):
        """x_np: complex64 (chunk_in,).  Returns (data (C, cap) complex64,
        counts (C,) int32) on the host."""
        x = torch.tensor(x_np, dtype=torch.complex64, device=self.device)
        with self.lock:
            if self.dirty:
                # into the buffers the graph reads, in stream order after
                # the last replay and before the next; a synchronous copy
                # under the lock, so no retune rewrites a host row while it
                # is read (a pinned buffer written ahead would be read when
                # the card gets to it, after the host has moved on)
                for buf, a in zip(self.rows, self._host_rows()):
                    buf.copy_(torch.from_numpy(a))
                self.dirty = False
        self.state, (data, count) = self._step(self.state, x)
        return (data.cpu().numpy(),
                np.full((self.max_channels,), count, np.int32))

    def state_from_jax(self, leaves):
        """The port's state from csdr_tpu's ``srv.state`` leaves
        (``state_from_jax_leaves(srv, leaves)``): the channelizer's
        (tail, phases, Wdft, W), the classed method's (forward tail,
        inverse phases), or the td method's (phases, tails)."""
        if self.method == "td":
            return (leaves.real((self.max_channels,), "ddcd td phases"),
                    leaves.complex((self.max_channels, self.tail_len),
                                   "ddcd td tails"))
        if self.factored:
            return self.chan.state_from_jax(leaves)
        return (self.fwd.state_from_jax(leaves),
                self.inv.state_from_jax(leaves))

    # ---- the plumbing both fronts share -----------------------------------

    def _chunks(self, stdin):
        """Yield (x complex64 ndarray, raw bytes) whole input chunks; stops
        at EOF or a short read."""
        bytes_per = 8
        pending = b""
        while True:
            data = stdin.read(self.chunk_in * bytes_per - len(pending))
            if not data:
                return
            pending += data
            if len(pending) < self.chunk_in * bytes_per:
                continue
            x = np.frombuffer(pending, np.complex64)
            raw = pending
            pending = b""
            yield x, raw

    @staticmethod
    def _slot_payload(data, counts, slot: int) -> bytes:
        """One slot's decimated output as interleaved f32 I/Q bytes."""
        return np.ascontiguousarray(data[slot, :int(counts[slot])]).tobytes()

    @staticmethod
    def _input(stdin, input_url: str | None):
        """stdin, or a connection to ``tcp://host:port`` (e.g. an nmux
        server), the composition the reference runs as ``nc host port |
        ddcd``."""
        if input_url:
            if not input_url.startswith("tcp://"):
                raise ValueError(f"input {input_url!r}: want tcp://host:port")
            host, port = input_url[6:].rsplit(":", 1)
            insock = socket.create_connection((host, int(port)), timeout=30)
            # 30 s is the connect timeout only: a lingering recv timeout
            # would end serving at any input stall longer than that
            insock.settimeout(None)
            return insock.makefile("rb")
        return stdin or sys.stdin.buffer

    def serve(self, stdin=None, input_url: str | None = None):
        """Serve clients from in-process threads until the input ends."""
        stdin = self._input(stdin, input_url)
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((self.address, self.port))
        lsock.listen(16)
        sys.stderr.write(
            f"ddcd: listening on {self.address}:{self.port} "
            f"method={self.method} D={self.decimation} "
            f"chunk={self.chunk_in} device={self.device}\n")
        threading.Thread(target=self._accept_loop, args=(lsock,),
                         daemon=True).start()
        try:
            for x, raw in self._chunks(stdin):
                data, counts = self._run_chunk(x)
                with self.lock:
                    clients = list(self.clients.values())
                for cl in clients:
                    cl.push(raw if cl.bypass
                            else self._slot_payload(data, counts, cl.slot))
        finally:
            self.running = False
            # shutdown wakes the accept loop blocked on the socket: a bare
            # close leaves the kernel socket listening under it
            try:
                lsock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            lsock.close()
            with self.lock:
                clients = list(self.clients.values())
            for cl in clients:
                cl.stop()

    # ---- native front-end mode ------------------------------------------

    def serve_native(self, front_bin: str, stdin=None,
                     input_url: str | None = None):
        """Serve through the native ddcd_front child process
        (native/ddcd_front.cpp): the C++ front owns the listen socket,
        the client sockets, command parsing and the per-client drop-oldest
        queues; this process runs the device loop and writes framed
        per-slot payloads, so client churn and slow readers never touch
        the step's cadence."""
        stdin = self._input(stdin, input_url)
        front = subprocess.Popen(
            [front_bin, "--port", str(self.port), "--address", self.address,
             "--slots", str(self.max_channels)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        active: dict[int, bool] = {}          # slot -> bypass flag

        def events():
            for raw in front.stdout:
                parts = raw.decode(errors="replace").strip().split(" ", 2)
                if len(parts) < 2:
                    continue
                try:
                    ev, slot = parts[0], int(parts[1])
                except ValueError:
                    # one malformed line must not end this thread, which
                    # would freeze connects, retunes and closes while the
                    # device loop streams on
                    sys.stderr.write(f"ddcd: bad front event {raw!r}\n")
                    continue
                if ev == "connect":
                    with self.lock:
                        self._set_shift_locked(slot, 0.0)
                        active[slot] = False
                    sys.stderr.write(f"ddcd: client -> slot {slot}\n")
                elif ev == "close":
                    with self.lock:
                        active.pop(slot, None)
                        self._zero_slot_locked(slot)
                    sys.stderr.write(f"ddcd: slot {slot} released\n")
                elif ev == "line" and len(parts) == 3:
                    line = parts[2]
                    if line.startswith("shift="):
                        try:
                            self.set_shift(slot, float(line[6:]))
                            sys.stderr.write(f"ddcd: slot {slot} {line}\n")
                        except ValueError:
                            pass
                    elif line.startswith("bypass="):
                        with self.lock:
                            if slot in active:
                                active[slot] = line[7:].strip() == "1"

        threading.Thread(target=events, daemon=True).start()
        try:
            for x, raw in self._chunks(stdin):
                data, counts = self._run_chunk(x)
                with self.lock:
                    snapshot = dict(active)
                for slot, bypass in snapshot.items():
                    payload = (raw if bypass
                               else self._slot_payload(data, counts, slot))
                    try:
                        front.stdin.write(
                            struct.pack("<II", slot, len(payload)) + payload)
                        front.stdin.flush()
                    except (BrokenPipeError, OSError):
                        return
        finally:
            self.running = False
            try:
                front.stdin.close()
            except OSError:
                pass
            front.wait(timeout=10)


def default_front_bin() -> str | None:
    cand = os.path.abspath(os.path.join(
        os.path.dirname(__file__), "..", "..", "native", "build",
        "ddcd_front"))
    return cand if os.path.exists(cand) else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=int, default=4953)
    ap.add_argument("--address", default="127.0.0.1")
    ap.add_argument("--decimation", type=int, required=True)
    ap.add_argument("--bw", type=float, default=0.05,
                    help="transition bandwidth")
    ap.add_argument("--method", choices=["fastddc", "td"], default="fastddc")
    ap.add_argument("--max_channels", type=int, default=8)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--input", default=None,
                    help="tcp://host:port wideband input (e.g. from nmux); "
                         "default stdin")
    ap.add_argument("--front", choices=["py", "native"], default="py",
                    help="client-facing socket layer: 'py' serves in-process "
                         "threads; 'native' spawns native/build/ddcd_front "
                         "(C++), keeping client churn off the device loop")
    ap.add_argument("--device", default="cuda",
                    help="where the step runs: cuda (default; raises "
                         "without CUDA) or cpu")
    args = ap.parse_args(argv)
    srv = DdcdServer(args.decimation, args.bw, args.max_channels,
                     args.method, args.frames, args.port, args.address,
                     device=args.device)
    if args.front == "native":
        front = default_front_bin()
        if front is None:
            sys.stderr.write("ddcd: native front not built "
                             "(run `make -C native`)\n")
            return 1
        srv.serve_native(front, input_url=args.input)
    else:
        srv.serve(input_url=args.input)
    return 0


if __name__ == "__main__":
    sys.exit(main())
