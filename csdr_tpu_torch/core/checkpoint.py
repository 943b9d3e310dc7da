"""Checkpoint/resume for streaming state (counterpart of
csdr_tpu.core.checkpoint).

A block's state is its whole stream history (NCO phases, FIR tails,
resampler offsets), so a checkpoint is that carry serialized.  The leaves
are written in the JAX package's flatten order, with every complex tensor
split into its (re, im) float32 planes exactly where csdr_tpu's planar
``CF`` flattens to two leaves.  ``leaf_0 … leaf_k`` of a ``csdr_tpu``
checkpoint therefore load into the port with numpy alone
(:func:`state_from_numpy_leaves`), and back (:func:`state_to_numpy_leaves`).

Format: .npz with the leaves plus a json tree description; no pickle.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from csdr_tpu_torch.core.block import Pipeline, resolve_device


def _flatten(state, out: list) -> str:
    """Depth-first leaves of a nested tuple state; returns its structure
    as a string ('*' a real leaf, 'c' a complex leaf)."""
    if state is None:
        return "None"
    if isinstance(state, (tuple, list)):
        return "(" + ",".join(_flatten(s, out) for s in state) + ")"
    if not isinstance(state, torch.Tensor):
        raise TypeError(f"state leaf of type {type(state).__name__}; "
                        "states are nested tuples of tensors")
    out.append(state)
    return "c" if state.is_complex() else "*"


def state_to_numpy_leaves(state) -> list[np.ndarray]:
    """Flat numpy leaves in csdr_tpu's flatten order (complex -> re, im)."""
    leaves: list[torch.Tensor] = []
    _flatten(state, leaves)
    out = []
    for t in leaves:
        a = t.detach().cpu().numpy()
        if np.iscomplexobj(a):
            out += [a.real.copy(), a.imag.copy()]
        else:
            out.append(a)
    return out


def _unflatten_like(like, leaves, pos: list):
    if like is None:
        return None
    if isinstance(like, (tuple, list)):
        return tuple(_unflatten_like(s, leaves, pos) for s in like)
    parts = 2 if like.is_complex() else 1
    i = pos[0]
    if i + parts > len(leaves):
        raise ValueError(f"too few leaves: need more than {len(leaves)}")
    got = [np.asarray(a) for a in leaves[i: i + parts]]
    pos[0] = i + parts
    want_dtype = np.float32 if like.is_complex() else \
        torch.empty((), dtype=like.dtype).numpy().dtype
    want_shape = tuple(like.shape)
    for k, a in enumerate(got):
        if a.shape != want_shape:
            raise ValueError(f"leaf {i + k}: shape {a.shape} != state "
                             f"shape {want_shape}")
        if a.dtype != want_dtype:
            raise ValueError(f"leaf {i + k}: dtype {a.dtype} != state "
                             f"dtype {want_dtype}")
    if like.is_complex():
        arr = np.asarray(got[0] + 1j * got[1], dtype=np.complex64)
    else:
        arr = np.array(got[0])
    return torch.from_numpy(arr).to(like.device)


def state_from_leaves_like(like, leaves) -> object:
    """Build a state structured (and placed) like ``like`` from flat numpy
    leaves; shapes and dtypes are checked leaf by leaf."""
    pos = [0]
    state = _unflatten_like(like, list(leaves), pos)
    if pos[0] != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a state of {pos[0]}")
    return state


def state_from_numpy_leaves(pipeline, leaves, device="cuda") -> object:
    """The port's state for ``pipeline`` from csdr_tpu's flat leaves (e.g.
    ``leaf_0 … leaf_k`` of a ``csdr_tpu.save_state`` file).  Sample history
    lands on ``device``; host bookkeeping scalars stay on the CPU."""
    return state_from_leaves_like(pipeline.init(resolve_device(device)),
                                  leaves)


class JaxLeaves:
    """csdr_tpu's flat state leaves (numpy), read in order.

    Some csdr_tpu blocks carry their constant matrices inside the state
    pytree (the fastddc inverse's TQ/d/W, the fftfilt taps spectra); the
    port keeps those as registered buffers and its state is only the stream
    history.  Blocks of that kind read their history with :meth:`complex`
    and :meth:`real`, and check each matrix leaf against their buffer with
    :meth:`matches` and its variants, which raise on any mismatch."""

    def __init__(self, leaves, device):
        self.leaves = [np.asarray(a) for a in leaves]
        self.device = device
        self.pos = 0

    def next_shape(self) -> tuple:
        """The shape of the next leaf, not consumed."""
        if self.pos >= len(self.leaves):
            raise ValueError(f"too few leaves ({len(self.leaves)})")
        return self.leaves[self.pos].shape

    def _next(self, what: str, shape=None) -> np.ndarray:
        if self.pos >= len(self.leaves):
            raise ValueError(f"{what}: too few leaves ({len(self.leaves)})")
        a = self.leaves[self.pos]
        self.pos += 1
        if shape is not None and a.shape != tuple(shape):
            raise ValueError(f"{what}: leaf {self.pos - 1} has shape "
                             f"{a.shape}, the port's is {tuple(shape)}")
        return a

    def _f32(self, what: str, shape) -> np.ndarray:
        a = self._next(what, shape)
        if a.dtype != np.float32:
            raise ValueError(f"{what}: leaf {self.pos - 1} is {a.dtype}, "
                             "not float32")
        return a

    def real(self, shape, what: str) -> torch.Tensor:
        """One float32 leaf as a tensor on the device (history)."""
        return torch.from_numpy(np.array(self._f32(what, shape))
                                ).to(self.device)

    def complex(self, shape, what: str) -> torch.Tensor:
        """A planar (re, im) pair as a complex64 tensor on the device."""
        re, im = self._f32(what, shape), self._f32(what, shape)
        return torch.from_numpy((re + 1j * im).astype(np.complex64)
                                ).to(self.device)

    def matches(self, buf: torch.Tensor, what: str) -> None:
        """A planar pair equal, value for value, to the complex buffer."""
        want = buf.detach().cpu().numpy()
        for part, got in ((want.real, self._f32(what, want.shape)),
                          (want.imag, self._f32(what, want.shape))):
            if not np.array_equal(part, got):
                raise ValueError(f"{what}: leaf {self.pos - 1} differs from "
                                 "the port's matrix")

    def matches_padded(self, buf: torch.Tensor, what: str) -> None:
        """A planar pair whose leading columns equal the buffer and whose
        padding columns are zero (csdr_tpu pads to 128-lane multiples)."""
        want = buf.detach().cpu().numpy()
        cols = want.shape[-1]
        for part in (want.real, want.imag):
            got = self._next(what)
            if got.dtype != np.float32 or got.shape[:-1] != want.shape[:-1] \
                    or got.shape[-1] < cols:
                raise ValueError(f"{what}: leaf {self.pos - 1} is "
                                 f"{got.dtype} {got.shape}, the port's is "
                                 f"{want.shape}")
            if not (np.array_equal(got[..., :cols], part)
                    and not np.any(got[..., cols:])):
                raise ValueError(f"{what}: leaf {self.pos - 1} differs from "
                                 "the port's matrix")

    def matches_packed_w(self, w: torch.Tensor, what: str) -> None:
        """csdr_tpu's ``pack_w`` leaf of the complex (inv, M) matrix: float32
        [wr | wi] lanes, each padded to mpad (precision "HIGHEST"), or the
        bf16 [hi; lo] row stack of that (precision "HIGH"), whose sum must
        reproduce W to bf16x2 accuracy."""
        want = w.detach().cpu().numpy()
        inv, m = want.shape
        got = self._next(what)
        if got.dtype == np.float32:
            packed = got
        elif got.ndim == 2 and got.shape[0] == 2 * inv:
            packed = (got[:inv].astype(np.float32)
                      + got[inv:].astype(np.float32))
        else:
            raise ValueError(f"{what}: leaf {self.pos - 1} is {got.dtype} "
                             f"{got.shape}")
        mpad = packed.shape[-1] // 2
        if packed.shape != (inv, 2 * mpad) or mpad < m:
            raise ValueError(f"{what}: leaf {self.pos - 1} has shape "
                             f"{got.shape} for W {want.shape}")
        full = np.zeros((inv, 2 * mpad), np.float32)
        full[:, :m], full[:, mpad:mpad + m] = want.real, want.imag
        exact = got.dtype == np.float32
        if not (np.array_equal(packed, full) if exact else np.allclose(
                packed, full, rtol=0, atol=1e-5 * np.abs(full).max())):
            raise ValueError(f"{what}: leaf {self.pos - 1} differs from the "
                             "port's W")

    def like(self, state):
        """The next leaves as a state shaped, typed and placed like the port
        state ``state`` (complex tensors from planar pairs), checked leaf by
        leaf: the history of a block that keeps no matrices."""
        pos = [self.pos]
        out = _unflatten_like(state, self.leaves, pos)
        self.pos = pos[0]
        return out

    def done(self) -> None:
        if self.pos != len(self.leaves):
            raise ValueError(f"{len(self.leaves)} leaves for a state of "
                             f"{self.pos}")


def _state_from_jax(block, reader: JaxLeaves):
    if hasattr(block, "state_from_jax"):
        return block.state_from_jax(reader)
    if isinstance(block, Pipeline):
        return tuple(_state_from_jax(b, reader) for b in block.blocks)
    return reader.like(block.init(reader.device))


def state_from_jax_leaves(block, leaves, device="cuda") -> object:
    """The port's state for ``block`` (a block, a whole Pipeline, the
    config-5 bank ``models.multichannel.DdcBpsk31Bank`` or the DDC server
    ``server.ddcd.DdcdServer``) from csdr_tpu's flat state leaves
    (``jax.tree_util.tree_leaves`` of its state).
    Blocks whose csdr_tpu state also carries constant matrices (the
    fastddc blocks, ``bandpass_fir_fft_block``) keep the history and check
    the matrix leaves against the port's buffers.  The timing recovery
    block takes its (tail re, tail im, occ, corr) for one stream or, with a
    leading channel axis, for a vmapped bank; the bank takes csdr_tpu's 6
    arrays (9 with the Costas loop), and its mesh form
    (``models.multichannel.MeshDdcBpsk31Bank``) the same global (C, ...)
    arrays of csdr_tpu's mesh bank, keeping its rank's chan rows (pass
    the mesh's device).  The dynamic fastddc blocks take their
    history (the channelizer's tail and phases, the inverses' phases) and
    check their matrix leaves (Wdft, the packed W); the server takes
    ``srv.state`` of csdr_tpu's server of the same method and plan (the
    td method's phases and tails).  Every other block reads its leaves
    as :func:`state_from_numpy_leaves` does (the AGC's float32 gain, int32
    hang and bool ``started``, fastagc's buffers and peaks, the FIR and
    de-emphasis tails, ``fft_cc_block``'s overlap tail from its planar
    pair, the ADPCM blocks' int32 (prev, index)).  Any shape, dtype or
    value mismatch raises."""
    reader = JaxLeaves(leaves, resolve_device(device))
    state = _state_from_jax(block, reader)
    reader.done()
    return state


def save_state(path: str, state) -> None:
    """Serialize a block/pipeline state to ``path`` (.npz)."""
    tree = _flatten(state, [])
    arrays = {f"leaf_{i}": a
              for i, a in enumerate(state_to_numpy_leaves(state))}
    arrays["__tree__"] = np.frombuffer(json.dumps(tree).encode(), np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, like) -> object:
    """Load a checkpoint structured like the state ``like`` (use
    ``block.init(device)``).  Tree structure, leaf count, shapes and dtypes
    are all checked so a mismatched pipeline fails loudly."""
    with np.load(path) as z:
        want = _flatten(like, [])
        if "__tree__" in z.files:
            stored = json.loads(bytes(z["__tree__"]).decode())
            if stored != want:
                raise ValueError(
                    "checkpoint tree structure does not match pipeline "
                    f"state:\n  checkpoint: {stored}\n  state:      {want}")
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    return state_from_leaves_like(like, leaves)
