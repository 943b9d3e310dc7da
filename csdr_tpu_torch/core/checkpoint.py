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

from csdr_tpu_torch.core.block import resolve_device


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
