"""Receiver models (counterpart of csdr_tpu.models.receivers); so far the
SSB receiver, BASELINE config 4, composed like the reference command
pipeline (README.md:110)."""

from __future__ import annotations

from csdr_tpu_torch import firdes
from csdr_tpu_torch.core.block import Pipeline, stateless
from csdr_tpu_torch.ops import demod, fftfilt, fir, util_ops


def ssb_receiver(low_cut: float = 0.0, high_cut: float = 0.1,
                 transition_bw: float = 0.05, decimation: int = 50,
                 front_bw: float = 0.005, agc_on: bool = True) -> Pipeline:
    """fir_decimate_cc 50 | bandpass_fir_fft_cc 0 0.1 | realpart_cf
    | agc_ff | limit_ff.  The decimating FIR runs on K2, the bandpass on
    K3's forward and inverse.  Chunk sizes must be multiples of
    decimation * the bandpass input_size.

    agc_on=True raises NotImplementedError: the AGC is not ported yet
    (ROADMAP item 7); agc_on=False is the chain without it."""
    if agc_on:
        raise NotImplementedError(
            "ssb_receiver(agc_on=True): agc_ff is not ported yet (ROADMAP "
            "item 7); pass agc_on=False")
    front = firdes.firdes_lowpass_f(firdes.firdes_filter_len(front_bw),
                                    0.5 / decimation)
    return Pipeline([
        fir.fir_decimate_block(front, decimation, precision="HIGH"),
        fftfilt.bandpass_fir_fft_block(low_cut, high_cut, transition_bw),
        stateless("realpart_cf", demod.realpart_cf),
        stateless("limit_ff", lambda x: util_ops.limit_ff(x, 1.0)),
    ], name="ssb")
