"""Card-pathology lint over one call of a step, at the dispatcher: the
counterpart of csdr_tpu's ``utils/hlo_lint.py`` (same API names:
``Finding(kind, primitive, detail)`` and ``lint_fn(fn, *args)``).

csdr_tpu traces a step to one compiled program and walks its jaxpr for
the TPU's cliffs.  The port runs eagerly: what reaches the card is the
sequence of ops the dispatcher sees, plus the kernels launched through
ctypes, which bypass it.  The card's cliffs are in that sequence (PERF.md
§5):

- ``host-sync``: the host waits for the card inside a step.  Any of
  ``HOST_SYNC_OPS`` or an index by a boolean mask on a tensor of the
  step's device, or a copy from the step's device to the host.
- ``python-loop``: a ``lax.scan`` that became a Python loop of small
  launches.  :func:`lint_lengths` lints one step at two chunk lengths and
  flags it when the launching ops grow with the length by more than
  ``LOOP_GROWTH_OPS`` (the Costas loop's plain version,
  ``kernels/carrier_cuda.costas_plain``: ~20 launches a sample).
- ``launch-bound``: more than ``LAUNCH_BOUND_OPS`` launching ops in one
  call, each one ~11.5-22 us of host issue time on the card (PERF.md
  §5), so the step waits on the host (one launch a tap:
  ``kernels/fir_cuda.strided_corr``, 201 launches in NFM's de-emphasis).
- ``cross-device``: an op whose tensors lie on a device other than the
  step's inputs' (0-dim CPU scalars, which torch reads by value, aside),
  other than a copy to the step's device (an upload, counted in
  ``Trace.uploads``) or to the host (a host sync).  Meaningful only on
  the card: on the CPU every tensor is on the one device.

A launching op is any op but a view (``func.is_view``) or one of
``NO_LAUNCH_OPS`` (allocation and metadata).  On the CPU the lint sees a
kernel wrapper's plain version (many ops); on the card it sees the
wrapper's one ctypes launch, counted from the kernels' ``LAUNCHES``.
"""

from __future__ import annotations

import contextlib
import importlib
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.weak import WeakIdKeyDictionary

# launching ops in one call of a step above which it is launch-bound: at
# ~11.5 us a launch (PERF.md §5) 64 launches take ~0.74 ms to
# issue, 3.5x WFM's 0.21 ms device step (whose busy share is 0.12-0.14)
LAUNCH_BOUND_OPS = 64
# launching ops a step may gain between two chunk lengths (the second
# twice the first) before it counts as a loop over the samples
LOOP_GROWTH_OPS = 32

HOST_SYNC_OPS = frozenset((
    "aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
    "aten::unique", "aten::_unique", "aten::_unique2", "aten::unique_dim",
    "aten::unique_consecutive", "aten::unique_dim_consecutive",
    "aten::equal", "aten::is_nonzero"))
NO_LAUNCH_OPS = frozenset((
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::new_empty", "aten::new_empty_strided", "aten::resize_",
    "aten::set_", "aten::detach", "aten::lift_fresh", "aten::alias",
    "aten::sym_size", "aten::sym_stride", "aten::sym_numel",
    "aten::sym_storage_offset", "aten::is_same_size",
    "aten::_local_scalar_dense"))
# indexing by a boolean mask computes the mask's nonzero on the card
MASK_INDEX_OPS = frozenset(("aten::index", "aten::index_put_",
                            "aten::index_put", "aten::_index_put_impl_"))
COPY_OPS = frozenset(("aten::_to_copy", "aten::copy_"))


# the cliffs of the port's own pipelines that the lint finds and a
# ROADMAP item queues for repair: name -> (kinds of finding, reason,
# item).  A pipeline's allow-list names the cliffs it runs.
KNOWN_CLIFFS = {
    "per-tap-fir": (("launch-bound",),
                    "a real-input FIR as one launch a tap "
                    "(kernels/fir_cuda.strided_corr): the de-emphasis "
                    "filters and the fractional decimator's prefilter",
                    "ROADMAP §1 item 2c"),
}


def allowed_kinds(cliffs) -> set:
    """The kinds of finding the named KNOWN_CLIFFS allow."""
    return {k for c in cliffs for k in KNOWN_CLIFFS[c][0]}


@dataclass
class Finding:
    kind: str          # 'host-sync' | 'python-loop' | 'launch-bound'
                       # | 'cross-device'
    primitive: str
    detail: str

    def __str__(self):
        return f"[{self.kind}] {self.primitive}: {self.detail}"


@dataclass
class Trace:
    """What one call dispatched: launching ops by name, the kernels'
    ctypes launches, host syncs, cross-device ops and uploads (op, bytes)."""
    device: torch.device
    ops: Counter = field(default_factory=Counter)
    kernel_launches: Counter = field(default_factory=Counter)
    syncs: list = field(default_factory=list)
    cross: list = field(default_factory=list)
    uploads: list = field(default_factory=list)

    @property
    def launching(self) -> int:
        return sum(self.ops.values()) + sum(self.kernel_launches.values())


def _tensors(tree, out=None) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


def _is_host_scalar(t: torch.Tensor) -> bool:
    return t.device.type == "cpu" and t.dim() == 0


class _Recorder(TorchDispatchMode):
    """Counts the ops of one call and follows which tensors derive from
    the step's data (its input tensors other than 0-dim CPU scalars),
    so that on the CPU a host flag's read is told from a read of data."""

    def __init__(self, trace: Trace, sources):
        super().__init__()
        self.trace = trace
        self.data = WeakIdKeyDictionary({t: True for t in sources})
        self.depth = 0               # plain versions being run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(t in self.data for t in ins):
            for t in outs:
                self.data[t] = True
        name = func._schema.name
        tr, dev = self.trace, self.trace.device
        masked = name in MASK_INDEX_OPS and any(
            t.dtype in (torch.bool, torch.uint8) for t in _tensors(args[1]))
        if (name in HOST_SYNC_OPS or masked) and ins:
            t = ins[0]
            # on the card a read of any card tensor; on the CPU, where
            # host flags share the device, a read of the step's data
            if t.device.type != "cpu" or (dev.type == "cpu"
                                          and t in self.data):
                tr.syncs.append(name)
        if func.is_view or name in NO_LAUNCH_OPS:
            return out
        tr.ops[name] += 1
        if name in COPY_OPS:
            src = ins[-1] if name == "aten::copy_" else ins[0]
            dst = ins[0] if name == "aten::copy_" else outs[0]
            if src.device == dev and dst.device.type == "cpu" \
                    and dev.type != "cpu":
                tr.syncs.append(f"{name} {dev}->cpu")
                return out
            if dst.device == dev and src.device != dev:
                tr.uploads.append((name, src.numel() * src.element_size()))
                return out
        devices = {t.device for t in ins + outs if not _is_host_scalar(t)}
        if devices - {dev}:
            tr.cross.append(f"{name} on {sorted(map(str, devices))}")
        return out


# each kernel wrapper's plain version -> the kernel's LAUNCHES key
PLAIN_VERSIONS = {
    "fir_cuda": {"fir_decimate_plain": "fir_decimate",
                 "shift_fir_decimate_plain": "shift_fir_decimate",
                 "fir_decimate_poly_plain": "fir_poly"},
    "fft_cuda": {"fft_ko_plain": "fft_ko", "ifft_ko_plain": "ifft_ko"},
    "fastddc_cuda": {"fastddc_inv_plain": "fastddc_inv"},
    "adpcm_cuda": {"encode_plain": "adpcm_encode",
                   "decode_plain": "adpcm_decode"},
    "probe_cuda": {"fma_chain_plain": "fma_chain"},
    "ted_cuda": {"scan_plain": "ted_scan"},
    "agc_cuda": {"relax_plain": "agc_relax", "scan_plain": "agc_ff_scan"},
    "carrier_cuda": {"costas_plain": "costas_scan", "pll_plain": "pll_scan"},
    "baudot_cuda": {"decode_plain": "baudot_scan"},
}


def _kernel_modules() -> dict:
    return {name: importlib.import_module(f"csdr_tpu_torch.kernels.{name}")
            for name in PLAIN_VERSIONS}


@contextlib.contextmanager
def _plain_as_launches(rec: _Recorder):
    """On the CPU a wrapper runs its kernel's plain version; inside this
    context each such call counts as the one launch the card makes and
    runs with the recorder off (as hlo_lint.pretend_tpu makes a CPU trace
    take the TPU's path); its outputs derive from the step's data when
    its inputs do."""
    saved = []
    for modname, fns in PLAIN_VERSIONS.items():
        mod = _kernel_modules()[modname]
        for fn_name, key in fns.items():
            orig = getattr(mod, fn_name)

            def stand_in(*a, _orig=orig, _key=key, **k):
                rec.depth += 1
                try:
                    with _disable_current_modes():
                        out = _orig(*a, **k)
                finally:
                    rec.depth -= 1
                if not rec.depth:
                    rec.trace.kernel_launches[_key] += 1
                if any(t in rec.data for t in _tensors((a, k))):
                    for t in _tensors(out):
                        rec.data[t] = True
                return out
            setattr(mod, fn_name, stand_in)
            saved.append((mod, fn_name, orig))
    try:
        yield
    finally:
        for mod, fn_name, orig in saved:
            setattr(mod, fn_name, orig)


def _launch_counts() -> dict:
    counts = {}
    for mod in _kernel_modules().values():
        counts.update(mod.LAUNCHES)
    return counts


def trace_fn(fn, *args) -> tuple[Trace, object]:
    """Run ``fn(*args)`` once under the recorder; the step's device is
    that of the first tensor in ``args`` that is not a 0-dim CPU scalar
    (a host flag of the state).  Returns the trace and fn's result."""
    data = [t for t in _tensors(args) if not _is_host_scalar(t)]
    dev = data[0].device if data else torch.device("cpu")
    trace = Trace(dev)
    rec = _Recorder(trace, data)
    view = (_plain_as_launches(rec) if dev.type == "cpu"
            else contextlib.nullcontext())
    before = _launch_counts()
    with view, rec:
        out = fn(*args)
    after = _launch_counts()
    trace.kernel_launches.update(
        {k: after[k] - before[k] for k in after if after[k] != before[k]})
    return trace, out


def findings_of(trace: Trace,
                launch_bound: int = LAUNCH_BOUND_OPS) -> list[Finding]:
    """The host-sync, cross-device and launch-bound findings of a trace,
    one a kind and primitive."""
    found = []
    for name, n in sorted(Counter(trace.syncs).items()):
        found.append(Finding("host-sync", name, f"{n} in one call on "
                                                f"{trace.device}"))
    for what, n in sorted(Counter(trace.cross).items()):
        found.append(Finding("cross-device", what.split(" ")[0],
                             f"{what}, {n}x; the step's device is "
                             f"{trace.device}"))
    if trace.launching > launch_bound:
        top = ", ".join(f"{k} {v}" for k, v in trace.ops.most_common(4))
        found.append(Finding(
            "launch-bound", "step",
            f"{trace.launching} launching ops in one call (> "
            f"{launch_bound}); most: {top}"))
    return found


def lint_fn(fn, *args, launch_bound: int = LAUNCH_BOUND_OPS
            ) -> list[Finding]:
    """Run fn(*args) once under the dispatcher and list its findings
    (module docstring); an empty list means the call is free of the known
    cliffs but the python loop, which :func:`lint_lengths` checks."""
    trace, _ = trace_fn(fn, *args)
    return findings_of(trace, launch_bound)


def lint_lengths(fn, make_args, lengths: tuple[int, int],
                 launch_bound: int = LAUNCH_BOUND_OPS
                 ) -> tuple[list[Finding], dict]:
    """Lint ``fn(*make_args(n))`` at the two chunk lengths of ``lengths``
    (the second twice the first; two equal lengths lint one call): every
    finding of each call, plus a ``python-loop`` finding when the
    launching ops grow with the length by more than ``LOOP_GROWTH_OPS``.
    Also returns the launching ops and host syncs at each length."""
    n1, n2 = lengths
    found, counts = [], {}
    for n in sorted({n1, n2}):
        trace, _ = trace_fn(fn, *make_args(n))
        counts[n] = {"launching": trace.launching, "syncs": len(trace.syncs),
                     "kernel_launches": dict(trace.kernel_launches),
                     "uploads": len(trace.uploads)}
        for f in findings_of(trace, launch_bound):
            if all((f.kind, f.primitive) != (g.kind, g.primitive)
                   for g in found):
                found.append(f)
    grow = counts[n2]["launching"] - counts[n1]["launching"]
    if grow > LOOP_GROWTH_OPS:
        found.append(Finding(
            "python-loop", "step",
            f"{counts[n1]['launching']} launching ops at {n1} samples, "
            f"{counts[n2]['launching']} at {n2} (+{grow} > "
            f"{LOOP_GROWTH_OPS}): a loop over the samples"))
    return found, counts
