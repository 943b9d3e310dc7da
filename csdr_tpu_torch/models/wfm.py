"""WFM broadcast receivers (counterpart of csdr_tpu.models.wfm).

wfm_basic (csdr-fm basic, reference README.md:66-83):
    fmdemod_quadri_cf -> fractional_decimator_ff 5 -> deemphasis_wfm_ff

wfm_advanced (2.4 Msps front end):
    shift_cc <rate> -> fir_decimate_cc 10 0.05 HAMMING -> fmdemod_quadri_cf
    -> fractional_decimator_ff 5 -> deemphasis_wfm_ff
"""

from __future__ import annotations

import os

from csdr_tpu_torch import firdes
from csdr_tpu_torch.core.block import Pipeline
from csdr_tpu_torch.ops import demod, fir, resamp, shift


def wfm_basic(samp_rate: int = 240_000, audio_rate: int = 48_000,
              tau: float = 50e-6) -> Pipeline:
    """240 ksps complex64 in -> 48 ksps float audio out (VarOut)."""
    return Pipeline([
        demod.fmdemod_quadri_block(),
        resamp.fractional_decimator_block(samp_rate / audio_rate),
        demod.deemphasis_wfm_block(tau, audio_rate),
    ], name="wfm_basic")


def wfm_advanced(shift_rate: float = -0.2, decimation: int = 10,
                 transition_bw: float = 0.05, window: str = firdes.HAMMING,
                 frac_rate: float = 5.0, audio_rate: int = 48_000,
                 tau: float = 50e-6,
                 fuse_shift: bool | None = None) -> Pipeline:
    """2.4 Msps complex64 front end -> 48 ksps audio (reference csdr-fm:41
    chain).  Chunk sizes must be multiples of ``decimation``.

    fuse_shift: run the NCO shift inside the FIR kernel (one pass over the
    chunk, ops/fir.shifted_fir_decimate_block), or as its own block before
    the plain FIR.  None = env CSDR_WFM_FUSED (default on; "0" = off)."""
    if fuse_shift is None:
        fuse_shift = os.environ.get("CSDR_WFM_FUSED", "1") != "0"
    taps = firdes.firdes_lowpass_f(
        firdes.firdes_filter_len(transition_bw), 0.5 / decimation, window)
    if fuse_shift:
        front = [fir.shifted_fir_decimate_block(shift_rate, taps, decimation,
                                                precision="HIGH")]
    else:
        front = [shift.shift_block(shift_rate),
                 fir.fir_decimate_block(taps, decimation)]
    return Pipeline(front + [
        demod.fmdemod_quadri_block(),
        resamp.fractional_decimator_block(frac_rate),
        demod.deemphasis_wfm_block(tau, audio_rate),
    ], name="wfm_advanced")
