"""The card-pathology lint (``utils/dispatch_lint``, the counterpart of
csdr_tpu's ``utils/hlo_lint``) over every pipeline of the port, on the CPU
at small shapes, as tests/test_hlo_lint.py runs csdr_tpu's lint over its
pipelines.

Each pipeline is linted at two chunk lengths (the second twice the
first) and must be free of findings but the kinds its allow-list names.
Every allow-list entry is a cliff of ``dispatch_lint.KNOWN_CLIFFS``, with
its reason and the ROADMAP item that queues its repair:

- ``per-tap-fir``: a real-input FIR launches once a tap (de-emphasis,
  the fractional decimator's prefilter; ROADMAP §1 item 2c).

An entry is also required to show, so a repaired cliff leaves its list.
The lint has teeth: a per-sample loop planted in a test is flagged
``python-loop`` and a planted ``.item()`` ``host-sync``.  Every scan of
csdr_tpu is one kernel launch a call: the modem's timing recovery (once a
Python loop of ~43 ops a symbol), the chunked AGC (once ~2 900 ops and two
host syncs a chunk of the SSB and AM receivers' audio), agc_ff's exact
scan, the Costas loop and the PLL (once ~20 ops a sample) and the RTTY
Baudot decoder (once ~60 ops a symbol).  On the CPU a kernel wrapper's
plain version counts as the one launch the card makes
(``_plain_as_launches``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from csdr_tpu_torch import Pipeline, firdes
from csdr_tpu_torch.kernels import (agc_cuda, baudot_cuda, carrier_cuda,
                                    fir_cuda, ted_cuda)
from csdr_tpu_torch.models import multichannel, receivers, wfm
from csdr_tpu_torch.ops import (adpcm, agc, digital, fastddc as fd, fftfilt,
                                spectrum, sync)
from csdr_tpu_torch.utils import dispatch_lint as dl

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)
RATES = np.random.default_rng(0).uniform(-0.4, 0.4, 8)


def _noise(n, seed=0):
    r = np.random.default_rng(seed)
    return torch.from_numpy((r.standard_normal(n) + 1j * r.standard_normal(n)
                             ).astype(np.complex64))


def _ints(n, lo, hi, dtype, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        lo, hi, n).astype(dtype))


def _ssb_chunk():
    _, ins, _ = fftfilt.fftfilt_plan(firdes.firdes_filter_len(0.05))
    return 50 * ins


def _block(make, data):
    """(step, make_args(n)) for a block or pipeline from a fresh state."""
    blk = make()
    return blk, lambda n: (blk.init("cpu"), data(n))


def _bank(use_costas=False):
    init, step, meta = multichannel.build_ddc_bpsk31_bank(
        RATES[:4], 16, sps=16, use_costas=use_costas, device="cpu")
    return step, lambda n: (init(n * meta["input_size"]),
                            _noise(n * meta["input_size"]))


def _server():
    from csdr_tpu_torch.server.ddcd import DdcdServer
    srv = DdcdServer(16, 0.05, max_channels=8, frames=8, device="cpu")
    for s, r in zip((1, 3, 5), (-0.3, 0.1, 0.2)):
        srv.set_shift(s, r)
    srv._run_chunk(_noise(srv.chunk_in).numpy())      # copies the rows in

    def make_args(n):
        return (srv.init(), _noise(n * srv.chunk_in // 8))
    return srv.step, make_args


W_ROW = chip_smoke.W_EVERY * chip_smoke.W_AVG         # samples a dB row

# name -> (step, make_args(n)), the two lengths n (one, where a block
# takes a single chunk length: the fastagc's block, the server's chunk),
# the allowed cliffs, and the chip_smoke path that runs the same
# pipeline on the card, if any
PIPELINES = {
    "wfm_basic": (lambda: _block(wfm.wfm_basic, _noise), (2400, 4800),
                  ("per-tap-fir",), None),
    "wfm_advanced": (lambda: _block(wfm.wfm_advanced, _noise),
                     (24_000, 48_000), ("per-tap-fir",), "WFM"),
    "nfm_receiver": (lambda: _block(receivers.nfm_receiver, _noise),
                     (4800, 9600), ("per-tap-fir",), None),
    "nfm_receiver_48k": (lambda: _block(lambda: receivers.nfm_receiver(
        50, audio_rate=48_000, fastagc_block_size=480), _noise),
        (24_000, 24_000), ("per-tap-fir",), "D"),
    "am_receiver": (lambda: _block(receivers.am_receiver, _noise),
                    (24_000, 48_000), (), "F"),
    "ssb_receiver": (lambda: _block(receivers.ssb_receiver, _noise),
                     (2 * _ssb_chunk(), 4 * _ssb_chunk()), (), "E"),
    "ssb_receiver_no_agc": (lambda: _block(lambda: receivers.ssb_receiver(
        agc_on=False), _noise), (2 * _ssb_chunk(), 4 * _ssb_chunk()), (),
        "C"),
    "fastddc_channelizer": (lambda: _block(
        lambda: fd.fastddc_channelizer_block(fd.fastddc_init(0.05, 16),
                                             RATES), _noise),
        (16 * 896, 32 * 896), (), "A"),
    "fastddc50_classed": (lambda: _block(lambda: Pipeline([
        fd.fastddc_fwd_block(fd.fastddc_init(0.05, 50),
                             spectra_order="kernel"),
        fd.fastddc_inv_block(fd.fastddc_init(0.05, 50), RATES,
                             spectra_order="kernel")]),
        lambda n: _noise(n * fd.fastddc_init(0.05, 50).input_size)),
        (20, 40), (), "B"),
    "fft_cc_logaveragepower": (lambda: _block(lambda: Pipeline([
        spectrum.fft_cc_block(1024, 1024),
        spectrum.logaveragepower_block(-70.0, 1024, 4)]), _noise),
        (16 * 1024, 32 * 1024), (), None),
    "waterfall": (lambda: _block(chip_smoke.waterfall_chain,
                                 lambda n: _ints(2 * n, 0, 256, np.uint8)),
                  (W_ROW, 2 * W_ROW), (), "W"),
    "config1": (lambda: _block(chip_smoke.config1_chain,
                               lambda n: _ints(2 * n, 0, 256, np.uint8)),
                (2400, 4800), ("per-tap-fir",), "W1"),
    "adpcm_encode": (lambda: _block(adpcm.encode_block, lambda n: _ints(
        n, -3000, 3000, np.int16)), (128, 256), (), None),
    "adpcm_decode": (lambda: _block(adpcm.decode_block, lambda n: _ints(
        n, 0, 256, np.uint8)), (64, 128), (), None),
    "adpcm_paired_encode": (lambda: _block(adpcm.paired_encode_block,
                                           lambda n: _ints(n, -3000, 3000,
                                                           np.int16)),
                            (127, 254), (), None),
    "ddc_bpsk31_bank": (_bank, (24, 48), (), "G"),
    "ddc_bpsk31_bank_costas": (lambda: _bank(use_costas=True), (24, 48), (),
                               "G_c"),
    "ddcd_server": (_server, (8, 8), (), "S"),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipeline_lints_clean_but_its_allow_list(name):
    make, lengths, allow, _ = PIPELINES[name]
    step, make_args = make()
    with torch.no_grad():
        found, counts = dl.lint_lengths(step, make_args, lengths)
    kinds = dl.allowed_kinds(allow)
    bad = [str(f) for f in found if f.kind not in kinds]
    assert not bad, f"{name}: {bad} ({counts})"
    for cliff in allow:
        assert any(f.kind in dl.KNOWN_CLIFFS[cliff][0] for f in found), (
            f"{name}: allow-listed cliff {cliff!r} no longer shows "
            f"({counts}); take it off the list")


def test_chip_smoke_allows_what_these_tests_allow():
    """chip_smoke.py's lint gate on the card allows each path what the
    CPU test of the same pipeline allows, and lints every path."""
    by_path = {path: allow for _, _, allow, path in PIPELINES.values()
               if path}
    by_path["G'"] = by_path["G"]
    assert chip_smoke.LINT_ALLOW == by_path


def test_known_cliffs_name_their_roadmap_items():
    for kinds, reason, item in dl.KNOWN_CLIFFS.values():
        assert kinds and set(kinds) <= {"host-sync", "python-loop",
                                        "launch-bound", "cross-device"}
        assert reason and item.startswith("ROADMAP §1 item 2")


def test_timing_recovery_is_flagged_python_loop():
    """Teeth, named for the loop it first caught (the timing recovery, now
    one kernel launch: test_ted_step_is_one_kernel_launch): a Python loop
    over the samples planted here, a first-order recursive filter a sample
    a step, grows with the chunk (every loop of the port's own is a kernel
    now: the tests below)."""
    def planted(x):
        acc, ys = torch.zeros(()), []
        for i in range(x.shape[-1]):
            acc = 0.9 * acc + x[i]
            ys.append(acc)
        return torch.stack(ys)

    found, counts = dl.lint_lengths(planted, lambda n: (torch.ones(n),),
                                    (64, 128))
    assert any(f.kind == "python-loop" for f in found), counts
    assert counts[128]["launching"] > counts[64]["launching"] + 32


def _one_launch(fn, make_args, lengths, kernel):
    """``fn`` at two chunk lengths: no finding, one launch of ``kernel``
    (its plain version standing in for it on the CPU), no host sync, no
    upload, and as many launching ops at either length."""
    found, counts = dl.lint_lengths(fn, make_args, lengths)
    assert found == [], counts
    for c in counts.values():
        assert c["kernel_launches"] == {kernel: 1}, counts
        assert c["syncs"] == 0 and c["uploads"] == 0, counts
        assert c["launching"] < 8, counts
    assert counts[lengths[0]]["launching"] == counts[lengths[1]]["launching"]


@pytest.mark.parametrize("dd", [False, True])
def test_costas_step_is_one_kernel_launch(dd):
    """A Costas block step over 3 rows, decision-directed or not, is one
    launch of the Costas kernel (ROADMAP §1 item 2f): no loop over the
    samples."""
    blk = sync.costas_block(0.01, decision_directed=dd)
    _one_launch(blk, lambda n: (blk.init("cpu", shape=(3,)), torch.stack(
        [_noise(n, s) for s in range(3)])), (64, 128), "costas_scan")
    assert carrier_cuda.costas_plain.__module__ == carrier_cuda.__name__


@pytest.mark.parametrize("pi_controller", [True, False])
def test_pll_step_is_one_kernel_launch(pi_controller):
    """A PLL block step (P or PI) is one launch of the PLL kernel."""
    blk = sync.pll_block(0.01, pi_controller, output="nco")
    _one_launch(blk, lambda n: (blk.init("cpu"), _noise(n)), (64, 128),
                "pll_scan")
    assert carrier_cuda.pll_plain.__module__ == carrier_cuda.__name__


def test_baudot_decoder_is_one_kernel_launch():
    """The RTTY Baudot decoder over 2 rows of u8 symbols, from its state,
    is one launch of the Baudot kernel; its count stays a tensor."""
    def step(state, x):
        out, state = digital.rtty_baudot_decoder(x, state=state)
        return state, out.data, out.count

    _one_launch(step, lambda n: (baudot_cuda.zero_state((2,), "cpu"),
                                 _ints((2, n), 0, 2, np.uint8)),
                (140, 280), "baudot_scan")
    assert baudot_cuda.decode_plain.__module__ == baudot_cuda.__name__


@pytest.mark.parametrize("segments", [1, 4])
def test_ted_step_is_one_kernel_launch(segments):
    """A timing recovery step, serial or segmented, is one launch of the
    TED kernel (its plain version standing in for it on the CPU) and ops
    around it as many at twice the chunk: no loop over the slots.  The
    serial step (the bank's) is a few ops; the segmented mode's seam dedup
    and pack (a scatter a segment) make it launch-bound."""
    tr = sync.timing_recovery_block("GARDNER", 16, segments=segments,
                                    warmup_symbols=4)
    found, counts = dl.lint_lengths(
        tr, lambda n: (tr.init("cpu", channels=3), torch.stack(
            [_noise(n, s) for s in range(3)])), (1024, 2048))
    assert [f.kind for f in found] == ([] if segments == 1
                                       else ["launch-bound"]), counts
    assert counts[1024]["launching"] == counts[2048]["launching"], counts
    for c in counts.values():
        assert c["kernel_launches"] == {"ted_scan": 1}, counts
        if segments == 1:
            assert c["launching"] < dl.LAUNCH_BOUND_OPS // 2, counts
    trace, _ = dl.trace_fn(tr, tr.init("cpu"), _noise(512))
    assert dict(trace.kernel_launches) == {"ted_scan": 1}
    assert ted_cuda.scan_plain.__module__ == ted_cuda.__name__


def test_agc_step_is_one_kernel_launch():
    """A chunked AGC step, from the stream's start and continuing, is one
    launch of the AGC kernel (its plain version standing in for it on the
    CPU), no host sync, and as many ops at twice the chunk: both
    relaxation loops are inside the kernel."""
    blk = agc.agc_block()

    def make_args(n):
        return blk.init("cpu"), torch.from_numpy(
            np.random.default_rng(n).standard_normal(n).astype(np.float32))
    found, counts = dl.lint_lengths(blk, make_args, (3000, 6000))
    assert found == [], counts
    for c in counts.values():
        assert c["kernel_launches"] == {"agc_relax": 1}, counts
        assert c["syncs"] == 0 and c["uploads"] == 0, counts
        assert c["launching"] < 8, counts
    state, _ = blk(blk.init("cpu"), make_args(500)[1])
    trace, _ = dl.trace_fn(blk, state, make_args(3000)[1])
    assert dict(trace.kernel_launches) == {"agc_relax": 1}
    assert not trace.syncs
    assert agc_cuda.relax_plain.__module__ == agc_cuda.__name__


def test_agc_scan_step_is_one_kernel_launch():
    """An exact-scan AGC step (an attack wait), from the stream's start and
    continuing, is one launch of the exact scan's kernel (its plain
    version standing in for it on the CPU), no host sync and no upload:
    the recurrence is inside the kernel, its state on the stream's
    device."""
    blk = agc.agc_block(method="scan", attack_wait_time=5)

    def make_args(n):
        return blk.init("cpu"), torch.from_numpy(
            np.random.default_rng(n).standard_normal(n).astype(np.float32))
    found, counts = dl.lint_lengths(blk, make_args, (3000, 6000))
    assert found == [], counts
    for c in counts.values():
        assert c["kernel_launches"] == {"agc_ff_scan": 1}, counts
        assert c["syncs"] == 0 and c["uploads"] == 0, counts
        assert c["launching"] < 8, counts
    state, _ = blk(blk.init("cpu"), make_args(500)[1])
    trace, _ = dl.trace_fn(blk, state, make_args(3000)[1])
    assert dict(trace.kernel_launches) == {"agc_ff_scan": 1}
    assert not trace.syncs and not trace.uploads
    assert agc_cuda.scan_plain.__module__ == agc_cuda.__name__


def test_item_in_a_step_is_flagged_host_sync():
    """Teeth: a planted .item() on the step's data."""
    def step(x):
        return x * float((x * 2).abs().sum().item())

    found = dl.lint_fn(step, torch.ones(64))
    assert [f.kind for f in found] == ["host-sync"]
    assert found[0].primitive == "aten::_local_scalar_dense"
    # nonzero and masked_select wait for the card too
    found = dl.lint_fn(lambda x: x[x > 0], torch.randn(64))
    assert {f.kind for f in found} == {"host-sync"}


def test_host_flag_read_is_not_a_sync():
    """A 0-dim CPU tensor of the state (a host flag, as the blocks keep
    their phases and counts) is read on the host without the card."""
    def step(flag, x):
        return x * int(flag) + float(flag.double() + 1)

    assert dl.lint_fn(step, torch.tensor(3), torch.ones(64)) == []


def test_per_tap_loop_is_flagged_launch_bound():
    taps = firdes.firdes_lowpass_f(dl.LAUNCH_BOUND_OPS + 9, 0.05).tolist()
    found = dl.lint_fn(lambda x: fir_cuda.strided_corr(x, taps, 10, 100),
                       torch.randn(2000))
    assert [f.kind for f in found] == ["launch-bound"]


def test_a_kernels_plain_version_counts_one_launch():
    """On the CPU a wrapper's plain version stands in for its one launch;
    the ops inside it are not the card's."""
    x = _noise(10_000)
    taps = torch.from_numpy(firdes.firdes_lowpass_f(801, 0.01))
    trace, y = dl.trace_fn(lambda v: fir_cuda.fir_decimate(
        v[:800], v[800:], taps, 50, 184), x)
    assert dict(trace.kernel_launches) == {"fir_decimate": 1}
    assert trace.launching < 8
    assert torch.equal(y, fir_cuda.fir_decimate_plain(x[:800], x[800:],
                                                      taps, 50, 184))
    assert fir_cuda.fir_decimate_plain.__module__ == fir_cuda.__name__


def test_cross_device_op_is_flagged():
    """Work on another device than the step's inputs' (here the meta
    device beside a CPU step)."""
    found = dl.lint_fn(lambda x: (torch.ones(8, device="meta") * 2, x * 2),
                       torch.ones(8))
    assert {f.kind for f in found} == {"cross-device"}
    assert all("meta" in f.detail for f in found)
    assert "aten::mul" in {f.primitive for f in found}


def test_constant_op_count_is_not_a_loop():
    found, counts = dl.lint_lengths(lambda x: (x * 2).cumsum(0),
                                    lambda n: (torch.ones(n),), (100, 200))
    assert found == [] and counts[100] == counts[200]
