"""Receiver models (counterpart of csdr_tpu.models.receivers): NFM
(BASELINE config 3), SSB (BASELINE config 4) and AM, composed like the
reference command pipelines (README.md:85-124).  Their front end is the
decimating FIR on K2; SSB's bandpass runs on K3's forward and inverse."""

from __future__ import annotations

from csdr_tpu_torch import firdes
from csdr_tpu_torch.core.block import Pipeline, stateless
from csdr_tpu_torch.ops import agc, demod, fftfilt, fir, util_ops


def _limit(x):
    return util_ops.limit_ff(x, 1.0)


def nfm_receiver(decimation: int = 50, transition_bw: float = 0.05,
                 audio_rate: int = 8000,
                 fastagc_block_size: int | None = None) -> Pipeline:
    """BASELINE config 3, the reference README's NFM chain:
    fir_decimate_cc D | fmdemod_quadri_cf | limit_ff | deemphasis_nfm_ff
    | fastagc_ff.  Chunk sizes must be multiples of D; the fastagc block
    size is the decimated chunk length."""
    taps = firdes.firdes_lowpass_f(firdes.firdes_filter_len(transition_bw),
                                   0.5 / decimation)
    blocks = [
        fir.fir_decimate_block(taps, decimation),
        demod.fmdemod_quadri_block(),
        stateless("limit_ff", _limit),
        demod.deemphasis_nfm_block(audio_rate),
    ]
    if fastagc_block_size:
        blocks.append(agc.fastagc_block(reference=1.0,
                                        block_size=fastagc_block_size))
    return Pipeline(blocks, name="nfm")


def ssb_receiver(low_cut: float = 0.0, high_cut: float = 0.1,
                 transition_bw: float = 0.05, decimation: int = 50,
                 front_bw: float = 0.005, agc_on: bool = True) -> Pipeline:
    """BASELINE config 4, the reference's full SSB chain (README.md:110):
    fir_decimate_cc 50 | bandpass_fir_fft_cc 0 0.1 | realpart_cf | agc_ff
    | limit_ff.  The AGC (agc_ff_chunked) runs at the decimated audio rate,
    as in the reference; agc_on=False leaves it out.  Chunk sizes must be
    multiples of decimation * the bandpass input_size."""
    front = firdes.firdes_lowpass_f(firdes.firdes_filter_len(front_bw),
                                    0.5 / decimation)
    blocks = [
        fir.fir_decimate_block(front, decimation, precision="HIGH"),
        fftfilt.bandpass_fir_fft_block(low_cut, high_cut, transition_bw),
        stateless("realpart_cf", demod.realpart_cf),
    ]
    if agc_on:
        blocks.append(agc.agc_block())
    blocks.append(stateless("limit_ff", _limit))
    return Pipeline(blocks, name="ssb")


def am_receiver(decimation: int = 50, transition_bw: float = 0.05,
                front_bw: float = 0.005) -> Pipeline:
    """The reference's AM chain (README.md:95):
    fir_decimate_cc 50 | amdemod_cf | fastdcblock_ff | agc_ff | limit_ff.
    ``transition_bw`` is csdr_tpu's signature, unused there too."""
    taps = firdes.firdes_lowpass_f(firdes.firdes_filter_len(front_bw),
                                   0.5 / decimation)
    return Pipeline([
        fir.fir_decimate_block(taps, decimation, precision="HIGH"),
        stateless("amdemod_cf", demod.amdemod_cf),
        util_ops.fastdcblock_block(),
        agc.agc_block(),
        stateless("limit_ff", _limit),
    ], name="am")
