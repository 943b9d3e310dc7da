#!/usr/bin/env python3
"""Smoke run of csdr_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csdr_tpu_torch/csrc (nvcc, at first use), then
prints one JSON line per phase and exits non-zero at the first failure:

1. env: the card, its power limit, the CUDA and nvcc versions, build time.
   measure: the card's ceilings measured by utils/roofline (device memory
   by a 256 MB sum, matrix products at HIGHEST, DEFAULT and BF16, FP32 by
   the probe kernel of csrc/roofline_probe.cu), each beside its published
   peak (utils/roofline.PUBLISHED) with the SM clock and power nvidia-smi
   samples during it, each finite, > 0 and at most 1.05x the published;
   the probe against its plain version bit for bit.  Every kernel row
   below also runs through utils/timing.time_kernel(perturb="rotate") and
   utils/roofline.account against the published and the measured peaks
   (at most 105 % of its published bound), and one step of each path
   WFM, A, B, C, D, E, F, G, G', S, W and W1 through utils/dispatch_lint
   on the card (no cross-device finding, no finding outside LINT_ALLOW);
   the phase's seconds are summed over its parts.
2. kernels: each kernel against its plain PyTorch version on the same
   inputs on the card (SNR bar stated per entry), with its time, the plain
   version's, a one-call library yardstick (TF32 off) and the least time
   the card could take (bytes or FP32 operations over the peak rates):
   the FIR pair (K1, K2), K2 also at path C's D=50/T=801, the
   kernel-order FFT pair (K3) at the shapes of paths B and C (the inverse
   also at B's, which runs only the forward), the fastddc
   inverse (K4) at path A's shape, at the D=4 and D=256 plans and at 256
   channels x 512 frames (D=16), also with TF32 on globally (bit for bit
   the same) and with its 3xTF32 tensor-core bound beside the FP32 one; then
   the polyphase FIR (K5) at path P's shape and four others, each also
   against K2 on the same input, with its launch, its share of the bound
   and conv1d's time over its own, and on a stream with a NaN that only
   tap rows m >= M would reach (every output finite, equal to the plain
   version); and K2 at path D's D=50/T=81.  Before path G, the timing
   recovery's symbol loop (csrc/ted.cu) at the bank's shape (64 rows of
   58 368 samples, sps 256: 230 slots) and segmented (64 x 4 lanes)
   through its shared-memory ring, at loop gain 4 (bitstart steps back)
   through its L2 route, whose time at that shape is reported beside the
   ring's, and early-late at loop gain 1 (corrections up to a symbol, the
   left pick stepping back) through the ring, each bit for bit against
   scan_plain; the probe chain that bounds it (a slot's picks from shared
   memory and its arithmetic) in SM cycles.  Then csdr_tpu's last scans
   (csrc/carrier.cu, one warp a row, one thread on the recurrence; and
   csrc/baudot.cu, a row split into segments composed in block scans):
   the PLL, P and PI, on 3 rows of 4096 samples of a tone and the RTTY
   Baudot decoder on 12 rows of 4096 symbols (baudot_cases: framed
   characters, carried states a stream never makes, all ones, all zeros,
   a periodic word that never frames, noise, tiles on the serial route;
   a cap that drops characters) and at n of 1, 33 and 1001, against
   their plain versions on the card, bit for bit (the PLL: or the first
   differing sample and the SNR at SWEEP_BAR; the decoder's serial route
   too); each chain's probe (the step on one thread from shared memory,
   its last state the kernel's) in SM cycles; and each at the CLI's
   65 536-sample chunk against the plain version on the CPU host (the PLL
   at SWEEP_BAR, the decoder bit for bit, its two routes bit for bit
   there and at 134 x 65 536), its time beside its bound.
3. path: wfm_advanced over 10 s of an FM-modulated 1 kHz tone at 2.4 Msps
   in 2.4 M-sample chunks, through run_offline on the card: the tone comes
   back, each chunk launched the fused kernel once, and the first 2 chunks
   match the same pipeline on the CPU.  Then the unfused chain
   (fuse_shift=False), which runs the plain FIR kernel.
4. throughput: wfm_advanced's Msps on the card, per chunk and per block.
5. path A/A'/B/C, each driven with every launch count zeroed just before
   and read just after:
   A  the 64-channel fastddc channelizer at D=16, 10 chunks of 1024
      frames: K4 once per chunk, test tones come out at delta*D, the first
      chunk equals the CPU per channel, also with TF32 switched on
      globally (the blocks' own products stay in full float32);
   A' fastddc_fwd_block | fastddc_inv_block at D=16, 3 chunks: K4 once
      per chunk, equal to A;
   B  fwd (kernel order) | classed inverse at D=50, 64 channels, 3 chunks
      of 3200 frames: K3 forward once per chunk, tones at delta*D, card
      equals CPU on one chunk;
   C  ssb_receiver(agc_on=False) over 10 s of a USB tone at 2.4 Msps: K2,
      K3 forward and K3 inverse once per chunk, the tone at its frequency,
      an out-of-band tone rejected, card equals CPU on 2 chunks.
   Matrix products outside the kernels must run with TF32 off.
6. throughput of A, B and C as for WFM.
7. path P/D/E/F, each driven as path A is:
   P  K5's dispatcher fir_decimate_poly_or_plain over 10 chunks of 2.4 M
      samples at D=10/T=1023, the tail carried by the caller: K5 once per
      chunk, equal to fir_decimate_block (K2) on the stream and, on 2
      chunks, to the port on the CPU;
   D  nfm_receiver(50, 48 ksps audio, fastagc on 48 000-sample blocks) over
      10 s of an NFM 1 kHz tone: K2 once per chunk, the tone, card equals
      CPU on 4 chunks (the fastagc lookahead fills the first 2);
   E  ssb_receiver(0.0, 0.1, 0.05, decimation=50), the full chain with its
      AGC, on path C's input: launches as C and the AGC kernel once per
      chunk, the tone, the AGC's output level for an input 40 dB quieter
      within 3 dB, card equals CPU on 2 chunks from the AGC's start-up on
      (SSB_SETTLE);
   F  am_receiver() over 10 s of a 1 kHz tone at depth 0.5: K2 and the AGC
      kernel once per chunk, the tone, card equals CPU on 2 chunks;
   then one AGC step's launches, host syncs and scalar uploads
   (torch.profiler and utils/dispatch_lint: one kernel launch, no sync,
   no upload).
8. throughput of D, E and F as for C.  Then the chunked AGC's kernel
   (csrc/agc.cu, both relaxation loops in one cooperative launch, a row
   over a cluster of CTAs; its registers and spills from nvcc -Xptxas -v,
   no spill allowed) against relax_plain on the card, bit for bit (y,
   gain, hang, converged): E's and F's second audio chunk continuing from
   their first's state, _agc_signal from the stream's start (a padded
   chunk that never settles), the zero run at max_gain 100, n = 1, 5 x
   8192 and 5 x 8192 + 1, E's audio over the fewest rows that get each
   cluster size the rule picks, over 2 rows more than clusters fit (rows
   in turns) and, at chunk 2048, the same with one CTA a row; each with
   its cluster (size, CTAs, SMs read from %smid), the rounds it ran, its
   time, the plain version's and its bound (the scans on the chain x the
   probe's chain of a scan in SM cycles, csdr_agc_chain_probe), E's also
   by time_kernel.  Then agc_ff's
   exact scan (csrc/agc_exact.cu, one warp a call) against the host loop,
   bit for bit (y, gain, hang, peak, attack-wait count): _agc_signal at
   attack wait 0, 5 and 200, its second half continuing from a carried
   state, one sample, a NaN and +-inf, the clamp's and the error's edges,
   a negative max_gain, a gain of -0.0, the CLI's 65 536-sample chunk;
   each timed beside its bound (samples x the probe's SM cycles a sample
   of agc_ff's shortest chain from shared memory, csdr_agc_ff_chain_
   probe), and one
   agc_block(method="scan") step's launches, syncs and uploads (1, 0, 0).
9. path G/G', BASELINE config 5 whole through
   models/multichannel.build_ddc_bpsk31_bank (64 channels, sps 256): 8
   channels tuned to 8 BPSK31 transmissions 0.1 apart, 56 at rates drawn
   as bench.py's flagship draws them, noise 0.01 per part:
   G  D=50, 3 chunks of 3200 frames: K3 forward and the TED once per
      chunk;
   G' D=16, 3 chunks of 1024 frames: K4 and the TED once per chunk;
   each BPSK31 channel decodes at BER < 0.02 over > 200 bits; the channel
   streams equal the CPU's (each BPSK31 channel >= 100 dB, every channel
   >= 100 dB against the bank's mean channel power); the card's modem on
   the CPU's channel streams gives the CPU's bits, counts and TED symbols
   bit for bit; the card's bits equal the CPU's within 2 errors a
   channel after alignment.  Then the Costas kernel against costas_plain
   on the card on 4096 samples of G's 8 BPSK31 streams, in both error
   modes and with the clamp's reset form, bit for bit or the first
   differing sample and the SNR at csdr_tpu's bars (COSTAS_BARS: 32 dB
   over the first 256 samples, 28 dB over all), with its chain probe;
   G_c BASELINE config 5 as BASELINE.md names it, "Costas/Gardner":
      build_ddc_bpsk31_bank(64 rates, 50, 256, use_costas=True) on G's
      input, 3 chunks of 3200 frames (64 rows x 57 344 channel samples),
      captured and eager bit for bit, K3 forward, the TED and the Costas
      kernel once a chunk, BER < 0.02 on each BPSK31 channel, its bits
      within 2 errors of the CPU bank's over the first 2 chunks on each
      BPSK31 channel, the Costas kernel on the first chunk's CPU streams
      against costas_plain on the CPU at COSTAS_BARS on the BPSK31
      channels and |y| = |x| on every channel (the loop does not lock to
      noise: off the transmissions card and CPU part, reported), its lint,
      and its step's cost eager and captured (ms as issued and device-only,
      busy share, Msps).
   Each bank's first chunk of channel streams, card and CPU, is also held
   against a float64 numpy channelizer on the same matrices and NCO
   phases, per channel ("quiet_channels": the channels without a carrier).
10. the cost of G and G' a chunk: Msps, step ms as issued, device-only
   ms and busy share, the channelizer's and the modem's ms, and launches
   and host syncs a chunk from torch.profiler.
11. the sharded banks over torch.distributed (parallel/), one spawn of
   ranks for the 1x1 meshes (NCCL) and one for the 2x2 (gloo, four ranks
   on the one card: NCCL refuses two ranks on one device, and gloo's
   send/recv takes host tensors, so the halo, fixup and corner turn copy
   their tensors through the host; python3
   tools/comm_probe.py checks both), the kernel library
   built in this process first:
   M   build_ddc_bpsk31_bank(64 rates, D, sps=256, mesh=1x1) at D=50 and
       D=16 over the first 2 chunks of G's and G''s input: bits, counts
       and channel streams bit for bit those of G and G', BER < 0.02 over
       > 200 bits a BPSK31 channel, streams card vs CPU >= 100 dB on them;
       the DDC bank (sharded_ddc) on chunk 1 equal to G's channelizer;
       K3 forward (D=50) and K4 (D=16) and the TED once a chunk;
   M'  the same on a 2x2 mesh: the DDC bank at D=50 and D=16 within atol
       2e-4 of M's and >= 100 dB on each BPSK31 channel, the flagship at
       D=50 within 2 bit errors a channel of M's; every launch counted
       over the ranks (the TED once a chunk a rank), collective bytes
       equal to the halo's and corner turn's shapes;
   M'' sharded_wfm at 64 channels (firdes_lowpass_f(81, 0.05), D1=10,
       D2=5) over one 2.4 M-sample chunk of FM 1 kHz tones on 8 channels,
       1x1 and 2x2: at both shapes the bank against the same step with
       K1's plain version in K1's place >= 100 dB and atol 5e-5 on each
       of the 64 channels, the tones within 5 Hz, 2x2 vs 1x1 >= 90 dB
       and atol 5e-3, K1 once a channel a time shard, bytes as predicted;
   every bank as its builder gives it on the card (captured,
   parallel/segments: one CUDA graph a step where time is 1, else a graph
   between each two collectives, the halo, fixup and corner turn run
   between the replays) and eagerly, in the same rank on the same chunks:
   outputs, counts and state leaves bit for bit on every rank, launches
   and collective bytes equal, the segments, one capture a segment and
   none after the first chunk (the K1-plain comparison runs the eager
   step and must launch no K1); and per path each rank's step ms (CUDA
   events and host clock), eager and captured issued and device-only ms,
   busy share and host CUDA calls a step, each rank's peak memory, the
   mesh's wideband Msps, its collective bytes a step, the staged
   collectives' host ms, and each rank's start-up apart from the steps.
11'. graph (phase_graph): the captured step (core/graph.CapturedStep:
   ``pipeline.jit_apply()``, and the bank's step from
   build_ddc_bpsk31_bank) against the eager step, over 6 chunks from one
   state each, on WFM at shift -0.2 and at -0.123456789 (the tone's
   carrier there: the NCO phase moves every chunk), C, D, E and F at
   CHUNK_C, W and W1 from raw u8 I/Q at their chunks, G and G': every
   output, VarOut count and carried state leaf
   bit for bit (NaNs by place); at most 2 captures a path, at most 1
   after the first chunk where the phase moves; each step's launches
   equal; an output held from one call unchanged after the next; a state
   saved through core/checkpoint after 3 chunks resumed bit for bit; then
   each step eager beside graph: issued ms, device-only ms and busy
   share, the host's CUDA calls a step (torch.profiler: kernel launches,
   graph launches, copies), dispatch_lint's ops (no sync, no upload), the
   captures, and the card's name and power limit.  run_offline on the
   card replays the captured step on every path above that goes through
   it (WFM, C, D, E, F, W).  Then the server paths S, S', S'' (below):
   DdcdServer's captured step (``_step``) against an eager twin (``_step
   = step``), both through ``_run_chunk`` over 12's schedule (claims, a
   retune, a release, the retune back): every chunk's outputs, counts and
   state bit for bit, launches equal, 1 capture, the row buffers' storage
   unchanged, no sync or upload in the captured step; each step's cost as
   above, and ``_run_chunk``'s host ms eager and captured.

12. the ddcd DDC server, driven through server.ddcd.DdcdServer: K2 at the
   shape of S'' (D=16, T=79, kout=16 384) against its plain version, then
   S   DdcdServer(16, 0.05, max_channels=64, frames=1024), the dynamic
       channelizer: K4 once a chunk;
   S'  DdcdServer(50, 0.05, max_channels=64, frames=3200), K3 forward in
       kernel order and the dynamic classed inverse: K3 once a chunk;
   S'' DdcdServer(16, 0.05, max_channels=8, method="td", frames=64), the
       traced-rate NCO and K2 once a slot a chunk;
   each 6 chunks of tones in 6 claimed slots' channels plus noise: every
   tone at its frequency within 1e-3 cycles, a retune after chunk 3 (the
   slot's tone moves; every slot it and the release leave alone equal bit
   for bit to a run without them), a release after chunk 4 (zeros; in
   the td method shift 0, as csdr_tpu's), a retune back whose host rows
   equal the first bit for bit, every claimed slot card vs CPU >= 100 dB;
   each path's cost (Msps, the captured step's ms as issued and
   device-only, busy share, _run_chunk and set_shift-to-output ms by the
   host clock; _run_chunk replays the captured step in all of 12); then
   serve() over loopback with two clients (shift=, a retune mid-stream,
   bypass=1), and path S's server with six tone slots and six noise-only
   slots, card and CPU against float64 per channel.

13. the byte edge: K3 forward at the waterfall's N=4096, B=837 against its
   plain version and cuFFT (on no path now), and what W's fft_cc runs
   (fft_natural: K3's forward storing natural order, one launch) bit for
   bit K3 and the order gather at W's and X''s shapes and at every N from
   128 to 16384, against cuFFT, timed beside cuFFT and the two-launch
   route on rotated inputs; the IMA ADPCM codec
   kernel, encode and decode, against its plain version on the card bit
   for bit (the 9 rows of a real waterfall chunk, dB rows holding -inf,
   +inf, NaN and +-400 dB through compress_fft_adpcm_rows, a stream in
   two chunks of 2048 with the state carried, W1's 48 000-sample audio
   chunk), with its time beside its bound: the encoder's shortest step
   chain and the decoder's scan depth, each timed in SM cycles by the
   codec source's probe; the decoder (a block-wide prefix scan) on a
   300 000-nibble row of saturating runs (0x7, 0xF: prev pinned at
   +-32767, index 88) against decode_scan_plain whole and decode_plain on
   its first 2048 nibbles, and on a 2 400 000-nibble row against
   decode_scan_plain; both directions from carried states whose index is
   -5 and 100; the encoder on 33 rows (two blocks), one alternating
   +-32767, against encode_plain and encode_select_plain; then
   W   OpenWebRX's waterfall at its defaults (fft_size 4096, fft_fps 9,
       fft_voverlap_factor 0.3 at 2.4 Msps: 93 frames averaged, a frame
       every 2867 samples) from raw u8 I/Q, 10 chunks of 2 399 679 samples
       (1 s, 9 rows, 837 frames): convert_u8_c | fft_cc_block(4096, 2867)
       | logaveragepower_block(-70, 4096, 93) | fft_exchange_sides_ff |
       compress_fft_adpcm_rows: fft_natural once and the codec once a
       chunk, four tones each in its column within 1 bin, the card's
       bytes equal to the plain codec's on the card's dB rows, linear
       averaged power card vs CPU >= 100 dB (the share of rows whose
       bytes equal the CPU's reported, not gated), and run_offline from
       the host array bit for bit the same;
   W1  BASELINE config 1 with OpenWebRX's compressed audio from raw u8
       I/Q: 10 s of the FM 1 kHz tone at 240 ksps, convert_u8_c |
       wfm_basic() | convert_f_s16 | paired_encode_block() (whole sample
       pairs, as csdr_tpu's CLI pumps them), the bytes decoded by
       decode_block() as a client would: the codec once a chunk each way,
       the tone at 1 kHz within 5 Hz, card vs CPU audio >= 60 dB, the
       card's bytes equal to the plain codec's over 2 x 2048 samples, the
       decoded tone at 1 kHz within 5 Hz;
   and each one's cost a chunk (Msps, device-only ms, busy share).

14. the csdr-compatible CLI (python -m csdr_tpu_torch.cli):
   Every pumped command runs its block as one CUDA graph replay a chunk
   (cli.STEP, core/graph.CapturedStep), but the declared UNCAPTURED.
   X   the csdr-fm pipeline as a shell pipeline of seven processes over
       10 s of the WFM FM tone as u8 I/Q (48 MB), the CLI's default
       65 536-sample chunk: convert_u8_f | shift_addition_cc -0.2 |
       fir_decimate_cc 10 0.05 HAMMING | fmdemod_quadri_cf |
       fractional_decimator_ff 5 | deemphasis_wfm_ff 48000 50e-6 |
       convert_f_s16; each stage alone first on the same bytes (its
       wall-clock Msps), every process exits 0, the pipeline's audio equal
       to the stages' bit for bit, the 1 kHz tone, the seconds to the first
       output byte; the same pipeline with every step uncaptured
       (EAGER_CLI), the same audio bit for bit, its rate and first byte
       beside; the start-up of the first STARTUP_STAGES stages' processes
       split by piece (STARTUP_PROBE); fractional_decimator_ff 5 in
       process on its stage's input, no key captured twice; and the same
       pipeline with --device cpu on the first 2 s: every int16 sample
       within 1, at most 0.1 % different;
   X'  each kernel command in process (csdr_tpu_torch.cli.main, stdin and
       stdout swapped for buffers), captured, launch counts zeroed just
       before and read just after (a replay counts its capture's
       launches), then with --device cpu: fir_decimate_cc (K2, and
       K2 at its shape D=10/T=79/kout=6553 against its plain version),
       bandpass_fir_fft_cc (K3 both ways), fft_cc 4096 2867 (fft_natural,
       K3's natural-order form), fastddc_fwd_cc 16 then fastddc_inv_cc
       0.1 16 (K4), the ADPCM codec both ways, agc_ff 200 0.2 0.01
       0.0001 65536 5 (an attack wait: the exact scan's kernel once a
       chunk, the bytes bit for bit --device cpu's), bpsk_costas_loop_cc
       0.01, pll_cc 2 0.01 and rtty_line_decoder_u8_u8 over a chunk
       and a tail (each its kernel once a chunk; the RTTY bytes bit for
       bit, the PLL at SWEEP_BAR, the Costas loop at its first-256 bar
       with |y| = |x|); each command's step on its first chunk eager and
       captured (chunk_cost: issued and device-only ms, busy
       share, host CUDA calls, the host clock a chunk); live --fd
       retunes, captured: shift_addition_cc (at most one capture) and
       fastddc_inv_cc (none: its rows rewritten in place), the output
       after each equal to a fresh run at the new rate up to the NCO's
       phase, and bandpass_fir_fft_cc and squelch_and_smeter_cc (none),
       the output after each equal to a fresh run;
   X'' every command of tests/test_cli_smoke.py's CASES in process on the
       card and with --device cpu, each pumped one at a chunk that gives
       it at least 3 chunks: exit 0, the same stderr, bytes bit for bit,
       floats at 100 dB (Costas at 32 dB over its first 256 samples,
       awgn_cc by its noise power), the pump's device check on every
       chunk; each pumped command captured against itself uncaptured on
       the card, bit for bit, its captures and replays, no key captured
       twice, every uncaptured pump one of UNCAPTURED; the endless noise
       sources by their statistics, and fft_benchmark over a captured
       FFT.

A card-vs-CPU check that fails first re-runs both sides once, then writes
what it saw (the input, both outputs and the re-runs in the worst channel,
per-channel SNRs, the worst frame) to chiprun_out/mismatch_<path>.npz
beside this script, and exits non-zero.

The second-last lines are the kernel table as one JSON object and the
card's name and power limit as nvidia-smi gives them; the last line is the
result object.  Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FS = 2_400_000             # one RTL-SDR stream, 2.4 Msps
CHUNK = 2_400_000          # one second per chunk, as bench.py runs it
SECONDS = 10
SHIFT = -0.2               # the carrier sits at +0.2*FS
SNR_BAR = 110.0            # kernel vs plain, dB
AUDIO_BAR = 60.0           # card vs CPU audio, dB (tests/test_torch_wfm.py)
KERNEL_SOURCE = "csdr_tpu_torch/csrc/fir_decimate.cu"
FFT_SOURCE = "csdr_tpu_torch/csrc/fft_ko.cu"
INV_SOURCE = "csdr_tpu_torch/csrc/fastddc_inv.cu"
POLY_SOURCE = "csdr_tpu_torch/csrc/fir_poly.cu"
CHANNELS = 64              # BASELINE config 5's channelizer
FRAMES_A = 1024            # bench.py fastddc16: frames per chunk
FRAMES_B = 3200            # bench.py fastddc50
CHUNKS_A, CHUNKS_AP, CHUNKS_B, CHUNKS_C = 10, 3, 3, 10
CHUNK_C = 270 * 8900       # ~1 s at 2.4 Msps, 270 bandpass frames
CHANNEL_BAR = 100.0        # card vs CPU, dB, per channel (fastddc)
SSB_BAR = 110.0            # card vs CPU audio, dB (K2 and K3 in f32 FMA)
CHUNKS_P = 10              # path P: 2.4 M-sample chunks through K5
SSB_SETTLE = 4800          # audio samples of the SSB AGC's start-up (0.1 s)
RECEIVER_BAR = 120.0       # card vs CPU audio, dB, paths D-F (K2 in f32 FMA)
POLY_K2_BAR = 100.0        # K5 vs K2 on one input, dB: two summation orders
AUDIO_RATE = 48_000        # the D=50 receivers' audio rate
MISMATCH_DIR = Path(__file__).resolve().parent / "chiprun_out"
INV_PLANS = (1, 4, 8, 16, 64, 256)   # K4 decimations whose tiles are checked
SPS = 256                  # config 5's modem: samples a symbol per channel
FRAMES_G, CHUNKS_G = 3200, 3     # bench.py bench_tpu_flagship, D=50
FRAMES_GP, CHUNKS_GP = 1024, 3   # the same bank at D=16
BPSK_CHANNELS = 8          # channels carrying a BPSK31 transmission
BANK_NOISE = 0.01          # complex noise per part in the wideband stream
BER_BAR = 0.02             # per BPSK31 channel (tests/test_multichannel.py)
BANK_SLIP_BAR = 2          # card vs CPU bits after alignment, a channel
COSTAS_SAMPLES = 4096
COSTAS_BARS = (32.0, 28.0)  # dB, first 256 samples and whole (csdr_tpu's)
CEILING_BAR = 1.05         # a measured ceiling over its published peak, most
SHARE_BAR = 105.0          # % of its published bound a kernel row may read
LOOP_MS = 40.0             # time_kernel's k_big: ~this many ms of loop
PROBE_SOURCE = "csdr_tpu_torch/csrc/roofline_probe.cu"
# the cliffs each path's step may show on the card (dispatch_lint.
# KNOWN_CLIFFS; tests/test_torch_dispatch_lint.py holds the same lists for
# the same pipelines on the CPU)
LINT_ALLOW = {"WFM": ("per-tap-fir",), "A": (), "B": (), "C": (),
              "D": ("per-tap-fir",), "E": (), "F": (),
              "G": (), "G'": (), "G_c": (), "S": (), "W": (),
              "W1": ("per-tap-fir",)}
# the measure phase's state: its seconds (summed over its parts, which
# run where their inputs are), the published and measured peaks, and the
# lint's findings by path
MEASURE = {"seconds": 0.0, "published": None, "peaks": None, "lint": {}}


class SmokeFailure(RuntimeError):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def require_no_tf32(torch) -> None:
    """The timed library yardsticks and the paths run with cuBLAS's TF32
    flag off, PyTorch's default (the float32 matmul precision "highest"
    sets the same flag)."""
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    err = float(np.sum(np.abs(ref - test) ** 2))
    if err == 0.0:
        return float("inf")
    return float(10 * np.log10(np.sum(np.abs(ref) ** 2) / err))


def channel_snrs(ref, test) -> np.ndarray:
    """SNR per row of 2-D outputs (channels), or one SNR for 1-D audio."""
    ref, test = np.atleast_2d(ref), np.atleast_2d(test)
    return np.asarray([snr_db(ref[k], test[k]) for k in range(len(ref))])


def float32_bits(v) -> list[str]:
    """The float32 bit patterns (hex) of a complex sample's two parts."""
    v = np.complex64(v)
    return [f"{np.float32(p).view(np.uint32):08x}" for p in (v.real, v.imag)]


def card_identity() -> str:
    """The card's UUID and PCI bus, so that two failures can be told to
    come from one card or from two."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,pci.bus_id",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def require_match(what: str, card, cpu, bar: float, x=None, rerun_card=None,
                  rerun_cpu=None, frame: int = 1) -> float:
    """The least SNR of ``card`` against ``cpu`` (per channel for 2-D
    outputs), which must reach ``bar``.  Otherwise both sides run once
    more, and what the check saw goes to chiprun_out/ before it fails:
    the input ``x``, the worst channel of each output and re-run, the SNRs
    per channel and the error per ``frame`` samples of the worst one."""
    card, cpu = np.atleast_2d(card), np.atleast_2d(cpu)
    snrs = channel_snrs(cpu, card)
    if snrs.min() >= bar:
        return float(snrs.min())
    worst = int(np.argmin(snrs))
    card2 = None if rerun_card is None else np.atleast_2d(rerun_card())
    cpu2 = None if rerun_cpu is None else np.atleast_2d(rerun_cpu())
    err = np.abs(card[worst] - cpu[worst]) ** 2
    per_frame = err[: len(err) // frame * frame].reshape(-1, frame).sum(1)
    k = int(np.argmax(err))
    power = float(np.mean(np.abs(cpu[worst]) ** 2))
    summary = {"what": what, "bar_db": bar, "worst_channel": worst,
               "worst_frame": int(np.argmax(per_frame)), "frame": frame,
               "worst_sample": k,
               # samples of the worst channel off by more than -80 dB of
               # its mean power: one for a lone corrupted value, many for
               # a path that computes differently
               "worst_channel_samples_off": int(np.sum(err > 1e-8 * power)),
               "min_snr_db": float(snrs.min()),
               "channels_under_bar": int(np.sum(snrs < bar)),
               "worst_sample_bits": {"card": float32_bits(card[worst][k]),
                                     "cpu": float32_bits(cpu[worst][k])},
               "card_id": card_identity()}
    arrays = {"snr_card_vs_cpu": snrs, "err_per_frame": per_frame,
              "card_worst": card[worst], "cpu_worst": cpu[worst]}
    if card2 is not None:
        arrays["card_rerun_worst"] = card2[worst]
        summary["card_rerun_vs_card_db"] = float(channel_snrs(card, card2).min())
        summary["card_rerun_vs_cpu_db"] = float(channel_snrs(cpu, card2).min())
        summary["worst_sample_bits"]["card_rerun"] = float32_bits(
            card2[worst][k])
    if cpu2 is not None:
        arrays["cpu_rerun_worst"] = cpu2[worst]
        summary["cpu_rerun_vs_cpu_db"] = float(channel_snrs(cpu, cpu2).min())
        summary["worst_sample_bits"]["cpu_rerun"] = float32_bits(
            cpu2[worst][k])
    if x is not None:
        arrays["x"] = np.asarray(x)
    MISMATCH_DIR.mkdir(exist_ok=True)
    path = MISMATCH_DIR / f"mismatch_{what.split(':')[0].replace(' ', '_')}.npz"
    np.savez_compressed(path, summary=json.dumps(summary), **arrays)
    emit("mismatch", saved=str(path.relative_to(MISMATCH_DIR.parent)),
         **summary)
    # the summary goes with the error too, so a log that keeps only the
    # standard error still tells a transient from a steady disagreement
    raise SmokeFailure(f"{what}: {snrs.min():.1f} dB < {bar} dB "
                       f"{json.dumps(summary)}")


def fm_tone(n: int, fs: float = FS, carrier: float = -SHIFT,
            dev: float = 75_000.0) -> np.ndarray:
    """The verify skill's FM-modulated 1 kHz tone (``dev`` Hz for a full
    scale tone, so a peak deviation of dev/2) on a carrier at
    ``carrier``*fs."""
    t = np.arange(n) / fs
    audio = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    phase = 2 * np.pi * (np.cumsum(audio) * dev / fs
                         + np.mod(carrier * np.arange(n), 1.0))
    return np.exp(1j * phase).astype(np.complex64)


def tone_hz(audio: np.ndarray, rate: int = 48_000) -> float:
    seg = audio[2000:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    return float(np.argmax(spec) * rate / len(seg))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def measured():
    """Adds the enclosed seconds to the measure phase's."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        MEASURE["seconds"] += time.perf_counter() - t0


def published(torch) -> dict:
    """The card's data-sheet peaks (utils/roofline.PUBLISHED); an unknown
    card raises."""
    from csdr_tpu_torch.utils import roofline
    if MEASURE["published"] is None:
        MEASURE["published"] = roofline.published_peaks(
            torch.cuda.get_device_name(0))
    return MEASURE["published"]


def least_ms(torch, nbytes: float, fp32_flops: float) -> tuple:
    """The least time of a kernel at the published peaks, ms, and what
    sets it ("bytes": each input read and each output written once over
    the memory rate, or "operations": its FP32 flops over the FP32 rate),
    through utils/roofline.least_seconds."""
    from csdr_tpu_torch.utils import roofline
    sec, by = roofline.least_seconds(nbytes, published(torch),
                                     fp32_flops=fp32_flops)
    return sec * 1e3, "bytes" if by == "hbm" else "operations"


def roofline_row(torch, name, kernel, x, aux, nbytes, fp32_flops, ms,
                 ops_s: float = 0.0) -> dict:
    """Part (c) of the measure phase for one kernel-table row: the row's
    kernel by utils/timing.time_kernel(perturb="rotate"), beside its
    time_cuda ``ms``, and utils/roofline.account against the published
    and the measured peaks (FP32 flops ``fp32_flops``; ``ops_s`` a bound
    in seconds of the row's own, the codec's chains).  Fails when a
    reading exceeds SHARE_BAR % of the published bound: the row's bytes
    or flops are then wrong.  Outside run() (the tools/ scripts call the
    case functions) there are no measured peaks and it returns {}."""
    if MEASURE["peaks"] is None:
        return {}
    from csdr_tpu_torch.utils import roofline
    from csdr_tpu_torch.utils.timing import time_kernel
    k_big = int(min(2000, max(64, LOOP_MS / max(ms, 1e-4))))
    k_pair = (k_big // 8, k_big)
    with measured():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tk = time_kernel(kernel, x, aux=aux, k_pair=k_pair, perturb="rotate")
        out = {"tk_ms": tk * 1e3, "tk_k_pair": list(k_pair),
               "tk_peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    for key, peaks in (("published", MEASURE["published"]),
                       ("measured", MEASURE["peaks"])):
        acc = roofline.account(name, tk, nbytes, 0.0, peaks,
                               fp32_flops=fp32_flops)
        light = max(roofline.least_seconds(nbytes, peaks,
                                           fp32_flops=fp32_flops)[0], ops_s)
        out[f"share_{key}"] = light / tk
        out[f"share_{key}_time_cuda"] = light / (ms / 1e3)
        out[f"account_{key}"] = acc
    worst = 100 * max(out["share_published"],
                      out["share_published_time_cuda"])
    require(worst <= SHARE_BAR,
            f"{name}: {worst:.1f} % of its published bound > {SHARE_BAR} "
            "%: its byte or FLOP count is wrong")
    return out


def sample_smi(fn):
    """``fn()`` with nvidia-smi sampling clocks.sm, power.draw and
    power.limit every 50 ms beside it; returns (fn's value, the samples'
    SM clock range in MHz, highest power in W and the power limit)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        value = fn()
    finally:
        proc.terminate()
        lines = proc.communicate(timeout=30)[0].strip().splitlines()
    rows = [[float(v) for v in ln.split(",")] for ln in lines
            if ln.count(",") == 2 and "[" not in ln]
    smi = {"samples": len(rows),
           "sm_mhz_max": max((r[0] for r in rows), default=None),
           "sm_mhz_min": min((r[0] for r in rows), default=None),
           "power_w_max": max((r[1] for r in rows), default=None),
           "power_limit_w": rows[-1][2] if rows else None}
    return value, smi


def phase_measure(torch):
    """The measure phase: (a) the card's ceilings measured by
    utils/roofline, each beside its published peak with nvidia-smi's SM
    clock and power sampled during it (each must be finite, > 0 and at
    most CEILING_BAR x the published); (b) the FP32 probe kernel
    (csrc/roofline_probe.cu) against its plain version, bit for bit, as a
    kernel-table row.  Parts (c), the kernel rows, and (d), the lint of
    every path's step, run where their inputs are (roofline_row,
    lint_step) and add their seconds to the phase's."""
    from csdr_tpu_torch.kernels import probe_cuda
    from csdr_tpu_torch.utils import roofline
    from csdr_tpu_torch.utils.timing import time_cuda

    t0, s0 = time.perf_counter(), MEASURE["seconds"]
    pub = published(torch)
    probe_cuda.reset_launches()
    ceilings, measured_peaks = {}, {"device": pub["device"]}
    for key, fn, scale in (
            ("hbm_bw_GBps", roofline.measure_hbm_bw, 1e9),
            ("matmul_highest_Tflops",
             lambda: roofline.measure_matmul_flops("HIGHEST"), 1e12),
            ("matmul_default_Tflops",
             lambda: roofline.measure_matmul_flops("DEFAULT"), 1e12),
            ("matmul_bf16_Tflops",
             lambda: roofline.measure_matmul_flops("BF16"), 1e12),
            ("fp32_Tflops", roofline.measure_fp32_flops, 1e12)):
        value, smi = sample_smi(fn)
        value /= scale
        ratio = value / pub[key]
        require(np.isfinite(value) and value > 0
                and ratio <= CEILING_BAR,
                f"ceiling {key}: measured {value} against published "
                f"{pub[key]} (ratio {ratio:.3f} > {CEILING_BAR} or not "
                "finite and > 0)")
        measured_peaks[key] = value
        ceilings[key] = {"measured": value, "published": pub[key],
                         "ratio": ratio, **smi}
    require_no_tf32(torch)
    probe_launches = dict(probe_cuda.LAUNCHES)
    measured_peaks["matmul_high_Tflops"] = \
        measured_peaks["matmul_default_Tflops"] / 3
    measured_peaks["matmul_high_derived"] = True
    MEASURE["peaks"] = measured_peaks
    # the FP32 rate as an SM clock: 132 SMs x 128 FP32 lanes x 2 flops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ceilings["fp32_Tflops"]["sm_mhz_implied"] = \
        measured_peaks["fp32_Tflops"] * 1e12 / (sms * 128 * 2) / 1e6
    emit("measure", part="ceilings", card=pub["device"],
         published_power_w=pub["power_W"], ceilings=ceilings,
         ceiling_bar=CEILING_BAR, seconds=time.perf_counter() - t0)

    # (b) the probe at its ceiling's shape against its plain version
    n, chain = 1 << 22, 2048
    gen = torch.Generator(device="cuda").manual_seed(50)
    x = torch.randn(n, device="cuda", generator=gen)
    yk = probe_cuda.fma_chain(x, chain)
    box = {}
    plain_ms = time_cuda(lambda: box.setdefault(
        "p", probe_cuda.fma_chain_plain(x, chain)), iters=1, warmup=0,
        repeats=1)
    torch.cuda.synchronize()
    require(torch.equal(yk, box["p"]),
            "fma_chain: kernel differs from its plain version")
    ms = time_cuda(lambda: probe_cuda.fma_chain(x, chain), iters=20,
                   queue_ahead_ms=20.0)
    nbytes, flops = 8 * n, 2 * chain * n
    bound, by = least_ms(torch, nbytes, flops)
    row = {"name": "fma_chain", "route": "cuda", "source": PROBE_SOURCE,
           "replaces": "no Pallas kernel: the fused chain of csdr_tpu/"
                       "utils/roofline.py:89-93 (measure_vpu_flops)",
           "shape": {"n": n, "chain": chain}, "bit_exact": True,
           "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "bytes": nbytes, "flops": flops, "path": "measure",
           **roofline_row(torch, "fma_chain",
                          lambda v: probe_cuda.fma_chain(v, chain), x, None,
                          nbytes, flops, ms)}
    emit("kernels", **row)
    MEASURE["seconds"] = s0 + time.perf_counter() - t0
    return row, probe_launches


def lint_step(torch, key: str, fn, *args):
    """Part (d) of the measure phase: utils/dispatch_lint over one call of
    path ``key``'s step on the card; every finding must be of a kind
    LINT_ALLOW[key]'s cliffs allow, and none cross-device.  Returns the
    step's result."""
    from csdr_tpu_torch.utils import dispatch_lint
    with measured():
        trace, out = dispatch_lint.trace_fn(fn, *args)
        torch.cuda.synchronize()
    found = dispatch_lint.findings_of(trace)
    allowed = dispatch_lint.allowed_kinds(LINT_ALLOW[key])
    bad = [str(f) for f in found
           if f.kind == "cross-device" or f.kind not in allowed]
    MEASURE["lint"][key] = {
        "launching": trace.launching, "kernel_launches":
            dict(trace.kernel_launches), "syncs": len(trace.syncs),
        "uploads": len(trace.uploads),
        "findings": [str(f) for f in found],
        "allowed": list(LINT_ALLOW[key])}
    emit("measure", part="lint", path=key, **MEASURE["lint"][key])
    require(not bad, f"lint of path {key}: findings outside its allow-list "
                     f"{LINT_ALLOW[key]}: {bad}")
    return out


def lint_pipeline(torch, key: str, pipe, chunk: np.ndarray):
    """lint_step over one call of ``pipe`` on the card from a fresh state,
    on ``chunk`` uploaded as a user's stream runner uploads it."""
    dev = torch.device("cuda")
    pipe = pipe.to(dev)
    with torch.no_grad():
        return lint_step(torch, key, pipe, pipe.init(dev),
                         torch.from_numpy(chunk).to(dev))


def lint_vs_profiler(torch, key: str, pipe, chunk: np.ndarray) -> None:
    """The lint's launching ops on path ``key``'s step beside what
    torch.profiler counts on the same call from the same fresh state: the
    kernels the card ran and the launch calls the host made (an op may
    launch none, as a copy of a scalar, or several)."""
    dev = torch.device("cuda")
    pipe = pipe.to(dev)
    x = torch.from_numpy(chunk).to(dev)
    with torch.no_grad(), measured():
        prof = profile_call(torch, lambda: pipe(pipe.init(dev), x))
    lint = MEASURE["lint"][key]
    emit("measure", part="lint_vs_profiler", path=key,
         lint_launching=lint["launching"],
         profiler_device_kernels=prof["device_kernels"],
         profiler_launch_calls=prof["cuda_launch_calls"],
         device_kernels_minus_lint=prof["device_kernels"]
         - lint["launching"])


def phase_measure_report() -> None:
    """The measure phase's total seconds and every path's lint."""
    missing = sorted(set(LINT_ALLOW) - set(MEASURE["lint"]))
    require(not missing, f"lint: paths not linted: {missing}")
    emit("measure", part="summary", seconds=MEASURE["seconds"],
         lint={k: v["findings"] for k, v in MEASURE["lint"].items()})


def phase_env(torch, build):
    smi = nvidia_smi_line()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    t0 = time.perf_counter()
    lib = build.lib()
    load_s = time.perf_counter() - t0
    from csdr_tpu_torch.kernels import fastddc_cuda, fir_cuda
    fir_shapes = ((79, 10, CHUNK // 10), (801, 50, CHUNK_C // 50),
                  (81, 50, CHUNK // 50), (1023, 10, 262_144),
                  (79, 16, 16_384))
    require(all(lib.csdr_fir_decimate_smem_bytes(t, d, p["tile"],
                                                 p["per_thread"]) == p["smem"]
                for t, d, k in fir_shapes for p in fir_cuda.plans(t, d, k)),
            "fir_decimate shared memory differs from fir_cuda.smem_bytes")
    require(all(lib.csdr_fastddc_inv_smem_bytes(t["kc"], t["mt"], t["jc"])
                == t["smem"] for t in map(inv_tiles, INV_PLANS)),
            "fastddc_inv tiles differ from fastddc_cuda.plan_tiles")
    poly_shapes = ((1023, 10, CHUNK // 10), (81, 50, 48_000),
                   (801, 50, 48_061), (7, 10, 240_000), (79, 3, 5000),
                   (33, 1, 4000))
    require(all(lib.csdr_fir_poly_smem_bytes(
                t, d, p["tile"], p["per_thread"], p["groups"]) == p["smem"]
                for t, d, k in poly_shapes
                for p in fir_cuda.poly_plans(t, d, k)),
            "fir_poly shared memory differs from fir_cuda.poly_smem_bytes")
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc.stdout.strip().splitlines()[-1],
         build_s=build.build_seconds, build_and_load_s=load_s,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32)
    return smi


def inv_tiles(d: int) -> dict:
    """K4's tiles (fastddc_cuda.plan_tiles) for fastddc_init(0.05, d)."""
    from csdr_tpu_torch.kernels import fastddc_cuda
    from csdr_tpu_torch.ops import fastddc as fd
    ddc = fd.fastddc_init(0.05, d)
    return fastddc_cuda.plan_tiles(ddc.pre_decimation, ddc.fft_inv_size,
                                   ddc.post_input_size // ddc.post_decimation)


def kernel_case(torch, name, d, t, kout, rate, theta, seed):
    """One kernel at one shape against its plain version; timings."""
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.kernels import fir_cuda
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    tail_len = ((t - 1 + d - 1) // d) * d
    n = kout * d
    gen = torch.Generator(device=dev).manual_seed(seed)
    # four input sets (~80 MB at the WFM shape) cycled by the timed loops,
    # so a launch does not find its input in the 50 MB L2
    sets = [(torch.randn(tail_len, dtype=torch.complex64, device=dev,
                         generator=gen),
             torch.randn(n, dtype=torch.complex64, device=dev,
                         generator=gen)) for _ in range(4)]
    taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
    mix = name == "shift_fir_decimate"
    phase = (rate, theta) if mix else ()
    kern = getattr(fir_cuda, name)
    plain = getattr(fir_cuda, name + "_plain")

    tail, x = sets[0]
    y_kernel = kern(tail, x, taps, d, kout, *phase)
    y_plain = plain(tail, x, taps, d, kout, *phase)
    torch.cuda.synchronize()
    yk, yp = y_kernel.cpu().numpy(), y_plain.cpu().numpy()
    snr = snr_db(yp, yk)
    max_abs_err = float(np.max(np.abs(yk - yp)))
    require(np.all(np.isfinite(yk)), f"{name}: non-finite output")
    require(snr > SNR_BAR, f"{name} D={d} T={t}: SNR {snr:.1f} dB vs plain "
                           f"<= {SNR_BAR}")

    it = iter(range(1 << 30))

    def pick():
        return sets[next(it) % len(sets)]

    kernel_ms = time_cuda(lambda: kern(*pick(), taps, d, kout, *phase),
                          iters=40, queue_ahead_ms=20.0)
    plain_ms = time_cuda(lambda: plain(*pick(), taps, d, kout, *phase),
                         iters=3, warmup=1, repeats=3)
    theta_form = {}
    if mix:
        # K1 reading theta from a float32 on the card (the captured step's
        # form) against the by-value form at that float32, bit for bit
        th32 = np.float32(theta)
        th = torch.tensor(th32, device=dev)
        y_dev = kern(tail, x, taps, d, kout, rate, th)
        y_val = kern(tail, x, taps, d, kout, rate, float(th32))
        torch.cuda.synchronize()
        require(same_bits(torch, torch.view_as_real(y_dev),
                          torch.view_as_real(y_val)),
                f"{name}: theta from the card differs from theta by value")
        theta_form = {"theta_on_card_bit_for_bit": True,
                      "ms_theta_on_card": time_cuda(
                          lambda: kern(*pick(), taps, d, kout, rate, th),
                          iters=40, queue_ahead_ms=20.0)}
    # library yardstick: one conv1d (cuDNN, TF32 off) over [tail|x] as
    # (re, im) planes, pre-mixed for the shifted kernel; never used by
    # the port
    planes = []
    for tl, xx in sets:
        v = torch.cat([tl, xx])
        if mix:
            v = v * fir_cuda.nco_phasor(v.shape[0], rate, theta, dev)
        planes.append(torch.view_as_real(v).T.contiguous()[:, None, :])
    w = taps.view(1, 1, -1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y_lib = torch.nn.functional.conv1d(planes[0], w, stride=d)
        lib_snr = snr_db(yp, torch.complex(y_lib[0, 0, :kout],
                                           y_lib[1, 0, :kout]).cpu().numpy())
        lib_ms = time_cuda(
            lambda: torch.nn.functional.conv1d(planes[next(it) % 4], w,
                                               stride=d),
            iters=40, queue_ahead_ms=20.0)
    # least time: each input read once, each output written once; FP32
    # operations: 2 FMA (4 flops) per tap per output, 6 per mixed sample
    nbytes = 8 * (tail_len + n) + 4 * t + 8 * kout
    flops = 4 * t * kout + (6 * (tail_len + n) if mix else 0)
    bound, bound_by = least_ms(torch, nbytes, flops)
    plan = fir_cuda.plan_tile(t, d, kout, mix, torch.cuda.
                              get_device_properties(0).multi_processor_count)
    return {
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": ("csdr_tpu/kernels/fir_pallas.py:226" if mix
                     else "csdr_tpu/kernels/fir_pallas.py:211"),
        "shape": {"D": d, "T": t, "kout": kout, "n": n,
                  "plan": {k: plan[k] for k in ("tile", "per_thread",
                                                "groups", "threads",
                                                "blocks")}},
        "snr_db": snr, "snr_bar_db": SNR_BAR, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "share_of_bound": bound / kernel_ms,
        "times_faster_than_library": lib_ms / kernel_ms,
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": lib_ms,
        "library_call": "torch.nn.functional.conv1d(stride=D), cuDNN, "
                        "TF32 off" + (", on the pre-mixed stream" if mix
                                      else ""),
        "library_snr_db": lib_snr,
        "bytes": nbytes, "flops": flops, **theta_form,
        **roofline_row(torch, name,
                       lambda v, h: kern(*v, h, d, kout, *phase), sets[0],
                       taps, nbytes, flops, kernel_ms),
    }


def phase_kernels(torch):
    kout = CHUNK // 10
    cases = [dict(kernel_case(torch, "shift_fir_decimate", 10, 79, kout,
                              SHIFT, 0.3, 1), path="wfm"),
             dict(kernel_case(torch, "fir_decimate", 10, 79, kout, 0.0, 0.0,
                              2), path="wfm_unfused")]
    # the BASELINE headline op fir_decimate_cc: D=10, T=1023
    headline = kernel_case(torch, "fir_decimate", 10, 1023, 262_144, 0.0,
                           0.0, 3)
    for c in cases + [headline]:
        emit("kernels", **c)
    emit("kernels", ported=[
        {"kernel": "K1 _fir_vmem_shift_kernel", "status": "ported",
         "wrapper": "csdr_tpu_torch.kernels.fir_cuda.shift_fir_decimate"},
        {"kernel": "K2 _fir_vmem_kernel", "status": "ported",
         "wrapper": "csdr_tpu_torch.kernels.fir_cuda.fir_decimate"},
        {"kernel": "K3 _fft_fwd_kernel/_fft_inv_kernel", "status": "ported",
         "wrapper": "csdr_tpu_torch.kernels.fft_cuda.fft_ko / ifft_ko / "
                    "fft_natural"},
        {"kernel": "K4 fastddc _inv_kernel", "status": "ported",
         "wrapper": "csdr_tpu_torch.kernels.fastddc_cuda.fastddc_inv"},
        {"kernel": "K5 _fir_poly_kernel", "status": "ported",
         "wrapper": "csdr_tpu_torch.kernels.fir_cuda.fir_decimate_poly"},
        {"kernel": "IMA ADPCM codec", "status": "ported",
         "counterpart_of": "lax.scan in csdr_tpu/ops/adpcm.py:69, 82 (no "
                           "Pallas kernel)",
         "wrapper": "csdr_tpu_torch.kernels.adpcm_cuda.encode / decode"},
        {"kernel": "timing recovery symbol loop (TED)", "status": "ported",
         "counterpart_of": "lax.scan in csdr_tpu/ops/sync.py:374, 397 (no "
                           "Pallas kernel)",
         "wrapper": "csdr_tpu_torch.kernels.ted_cuda.scan"},
        {"kernel": "chunked AGC relaxation", "status": "ported",
         "counterpart_of": "while_loop in csdr_tpu/ops/agc.py:385, 437 (no "
                           "Pallas kernel)",
         "wrapper": "csdr_tpu_torch.kernels.agc_cuda.relax"},
        {"kernel": "agc_ff's exact scan", "status": "ported",
         "counterpart_of": "lax.scan in csdr_tpu/ops/agc.py:171 (no Pallas "
                           "kernel)",
         "wrapper": "csdr_tpu_torch.kernels.agc_cuda.scan"}])
    return cases, headline


def _timed_sets(make, nsets=4):
    """``nsets`` input sets and a picker that cycles them, so a timed loop
    does not find its input in the 50 MB L2 where the sets exceed it."""
    sets = [make(i) for i in range(nsets)]
    it = iter(range(1 << 30))
    return sets, lambda: sets[next(it) % nsets]


def fft_case(torch, name, n, b, seed):
    """K3 (fft_ko, ifft_ko, or fft_natural: its forward storing natural
    order, one launch) at (N, B) against its plain version.  fft_natural's
    plain version is torch.fft.fft, its CPU route; it is also held bit for
    bit against the two-launch route it replaces, ko_to_natural(fft_ko(x)),
    which is timed beside it."""
    from csdr_tpu_torch.kernels import _build, fft_cuda
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    sets, pick = _timed_sets(lambda i: torch.randn(
        b, n, dtype=torch.complex64, device=dev, generator=gen))
    kern = getattr(fft_cuda, name)
    natural = name == "fft_natural"
    inverse = name == "ifft_ko"
    plain = (torch.fft.fft if natural
             else getattr(fft_cuda, name + "_plain"))

    def two_launch(x):
        return fft_cuda.ko_to_natural(fft_cuda.fft_ko(x))

    yk, yp = kern(sets[0]), plain(sets[0])
    same = natural and torch.equal(yk, two_launch(sets[0]))
    torch.cuda.synchronize()
    require(same or not natural, f"fft_natural N={n} B={b}: differs from "
                                 "ko_to_natural(fft_ko(x))")
    yk, yp = yk.cpu().numpy(), yp.cpu().numpy()
    snr = snr_db(yp, yk)
    require(np.all(np.isfinite(yk)), f"{name}: non-finite output")
    require(snr > SNR_BAR, f"{name} N={n} B={b}: SNR {snr:.1f} dB vs plain "
                           f"<= {SNR_BAR}")
    ms = time_cuda(lambda: kern(pick()), iters=40, queue_ahead_ms=20.0)
    plain_ms = time_cuda(lambda: plain(pick()), iters=20, queue_ahead_ms=20.0)
    if inverse:
        def lib():
            return torch.fft.ifft(pick(), norm="forward")
    else:
        def lib():
            return torch.fft.fft(pick())
    lib_ms = time_cuda(lib, iters=40, queue_ahead_ms=20.0)
    # least time: each point read once and written once (16 B); operations:
    # 5 N log2 N per radix-2 transform
    nbytes = 16 * b * n
    flops = 5 * b * n * int(np.log2(n))
    bound, bound_by = least_ms(torch, nbytes, flops)
    if natural:
        replaces = {"replaces": "csdr_tpu/kernels/fft_pallas.py:458",
                    "replaces_note": "fft_natural: the pallas_call of :364 "
                                     "(K3 forward, :220), then ko_to_natural "
                                     "(:434)",
                    "bit_for_bit_two_launch": same,
                    "two_launch_ms": time_cuda(
                        lambda: two_launch(pick()), iters=40,
                        queue_ahead_ms=20.0)}
    else:
        replaces = {"replaces": ("csdr_tpu/kernels/fft_pallas.py:265"
                                 if inverse else
                                 "csdr_tpu/kernels/fft_pallas.py:220")}
    return {
        "name": name, "route": "cuda", "source": FFT_SOURCE, **replaces,
        "shape": {"N": n, "B": b, "radix_plan": fft_cuda.radix_plan(n),
                  "frames_per_block":
                      _build.lib().csdr_fft_ko_frames_per_block(n, b)},
        "snr_db": snr, "snr_bar_db": SNR_BAR,
        "max_abs_err": float(np.max(np.abs(yk - yp))),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by,
        "share_of_bound": bound / ms,
        "library_ms": lib_ms,
        "library_call": ("torch.fft.ifft(norm='forward')" if inverse
                         else "torch.fft.fft") + " on (B, N) complex64 in "
                        "natural order (cuFFT)" + (
                            "; the plain version is the same call" if natural
                            else "; the kernel-order gather is not in it"),
        "bytes": nbytes, "flops": flops,
        **roofline_row(torch, name, kern, sets[0], None, nbytes, flops, ms),
    }


def fft_natural_sweep(torch, seed):
    """fft_natural bit for bit ko_to_natural(fft_ko(x)) at every N the
    kernel takes, B = 1 and 37, and against cuFFT at SNR_BAR."""
    from csdr_tpu_torch.kernels import fft_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = float("inf")
    for k in range(7, 15):
        for b in (1, 37):
            x = torch.randn(b, 1 << k, dtype=torch.complex64, device=dev,
                            generator=gen)
            y = fft_cuda.fft_natural(x)
            require(torch.equal(y, fft_cuda.ko_to_natural(fft_cuda.fft_ko(
                x))), f"fft_natural N={1 << k} B={b}: differs from "
                      "ko_to_natural(fft_ko(x))")
            worst = min(worst, snr_db(torch.fft.fft(x).cpu().numpy(),
                                      y.cpu().numpy()))
    require(worst > SNR_BAR, f"fft_natural: SNR {worst:.1f} dB vs "
                             f"torch.fft.fft <= {SNR_BAR}")
    return {"n": [1 << k for k in range(7, 15)], "b": [1, 37],
            "bit_for_bit_two_launch": True, "worst_snr_db": worst}


def inv_case(torch, d, b, rates, seed):
    """K4 at one plan, C = len(rates) channels, B frames, against its plain
    version; the yardstick is the same linear map as one complex64 matmul
    of the spectra by the fused (fft, C*M) matrix (TF32 off)."""
    from csdr_tpu_torch.kernels import fastddc_cuda
    from csdr_tpu_torch.ops import fastddc as fd
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    ddc = fd.fastddc_init(0.05, d)
    tq, w, dd, cyc = fd.channel_factored2_arrays(ddc, rates)
    c, pre, inv = tq.shape
    m = w.shape[1]
    rot = np.exp(2j * np.pi * np.mod(np.arange(b)[None, :] * cyc[:, None],
                                     1.0)).astype(np.complex64)
    mats = [torch.from_numpy(a).to(dev) for a in (tq, w, dd, rot)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    sets, pick = _timed_sets(lambda i: torch.randn(
        b, ddc.fft_size, dtype=torch.complex64, device=dev, generator=gen))
    yk = fastddc_cuda.fastddc_inv(sets[0], *mats, m)
    yp = fastddc_cuda.fastddc_inv_plain(sets[0], *mats, m)
    torch.cuda.synchronize()
    yk, yp = yk.cpu().numpy(), yp.cpu().numpy()
    snr = snr_db(yp, yk)
    require(np.all(np.isfinite(yk)), "fastddc_inv: non-finite output")
    require(snr > SNR_BAR, f"fastddc_inv D={d}: SNR {snr:.1f} dB vs plain "
                           f"<= {SNR_BAR}")
    # the kernel's 3xTF32 is its own arithmetic: the global flag changes
    # no bit
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y_tf32 = fastddc_cuda.fastddc_inv(sets[0], *mats, m)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    require(np.array_equal(y_tf32.cpu().numpy(), yk),
            f"fastddc_inv D={d}: output changes with allow_tf32")
    ms = time_cuda(lambda: fastddc_cuda.fastddc_inv(pick(), *mats, m),
                   iters=40, queue_ahead_ms=20.0)
    plain_ms = time_cuda(
        lambda: fastddc_cuda.fastddc_inv_plain(pick(), *mats, m),
        iters=20, queue_ahead_ms=20.0)
    g = torch.from_numpy(np.concatenate(
        [fd.channel_fused_matrix(ddc, r)[0] for r in rates], 1)).to(dev)
    require_no_tf32(torch)
    z = torch.matmul(sets[0], g).reshape(b, c, m).permute(1, 0, 2)
    lib_snr = snr_db(yp, (z * mats[3][:, :, None]).cpu().numpy())
    lib_ms = time_cuda(lambda: torch.matmul(pick(), g), iters=40,
                       queue_ahead_ms=20.0)
    # least time: S, TQ, W, d, rot read once, out written once; FP32
    # operations: 8 per complex MAC of the fold and of the iDFT
    nbytes = 8 * (b * pre * inv + c * pre * inv + inv * m + c * m + c * b
                  + c * b * m)
    fold, idft = 8 * b * c * pre * inv, 8 * b * c * inv * m
    flops = fold + idft
    bound, bound_by = least_ms(torch, nbytes, flops)
    # the same with the iDFT on the tensor cores in 3xTF32, as the kernel
    # runs it: the fold over the FP32 rate plus three TF32 products of
    # the iDFT's operations over the dense TF32 rate
    pub = published(torch)
    t_tc = (fold / (pub["fp32_Tflops"] * 1e12)
            + 3 * idft / (pub["matmul_default_Tflops"] * 1e12)) * 1e3
    return {
        "name": "fastddc_inv", "route": "cuda", "source": INV_SOURCE,
        "replaces": "csdr_tpu/kernels/fastddc_pallas.py:54",
        "shape": {"D": d, "B": b, "C": c, "pre": pre, "inv": inv, "M": m,
                  "tiles": fastddc_cuda.plan_tiles(pre, inv, m)},
        "snr_db": snr, "snr_bar_db": SNR_BAR,
        "max_abs_err": float(np.max(np.abs(yk - yp))),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by,
        "bound_tc_ms": max(least_ms(torch, nbytes, 0)[0], t_tc),
        "library_ms": lib_ms,
        "library_call": "torch.matmul(spectra (B, fft), fused G (fft, C*M)) "
                        "complex64, TF32 off: the same map before the "
                        "per-frame NCO",
        "library_snr_db": lib_snr,
        "bytes": nbytes, "flops": flops,
        **roofline_row(torch, "fastddc_inv",
                       lambda v, mm: fastddc_cuda.fastddc_inv(v, *mm, m),
                       sets[0], mats, nbytes, flops, ms),
    }


def bench_rates():
    """64 channel shifts in [-0.4, 0.4), drawn as bench.py draws them."""
    return np.random.default_rng(0).uniform(-0.4, 0.4, CHANNELS)


def phase_fastddc_kernels(torch):
    """K2, K3 and K4 at the shapes paths A, B and C give them, each tagged
    with its path; K3's inverse also at path B's shape, and K4 at the D=4
    and D=256 plans and at csdr_tpu's 256-channel D=16 bench shape
    (bench.py fastddc256: 512 frames), on no path."""
    rates = bench_rates()
    frames_c = CHUNK_C // 8900             # bandpass frames of N=256
    cases = [
        dict(fft_case(torch, "fft_ko", 1024, FRAMES_B, 11), path="B"),
        dict(kernel_case(torch, "fir_decimate", 50, 801, CHUNK_C // 50, 0.0,
                         0.0, 16), path="C"),
        dict(fft_case(torch, "fft_ko", 256, frames_c, 17), path="C"),
        dict(fft_case(torch, "ifft_ko", 256, frames_c, 12), path="C"),
        dict(inv_case(torch, 16, FRAMES_A, rates, 13), path="A")]
    others = [fft_case(torch, "ifft_ko", 1024, FRAMES_B, 19)]
    others += [inv_case(torch, d, FRAMES_A, rates, 14 + d) for d in (4, 256)]
    rates256 = np.random.default_rng(0).uniform(-0.4, 0.4, 256)
    others.append(inv_case(torch, 16, 512, rates256, 30))
    for c in cases + others:
        emit("kernels", **c)
    return cases


def drive_path(torch, pipe, x, name):
    """run_offline on the card with the launch counts zeroed just before
    and read just after."""
    from csdr_tpu_torch import run_offline
    from csdr_tpu_torch.kernels import fir_cuda

    fir_cuda.reset_launches()
    t0 = time.perf_counter()
    audio = run_offline(pipe, x, block_size=CHUNK)
    wall = time.perf_counter() - t0
    launches = dict(fir_cuda.LAUNCHES)
    hz = tone_hz(audio)
    require(np.all(np.isfinite(audio)) and audio.dtype == np.float32,
            f"{name}: audio not finite float32")
    require(abs(hz - 1000.0) < 5.0, f"{name}: tone at {hz} Hz, not 1 kHz")
    return audio, launches, hz, wall


def phase_path(torch):
    from csdr_tpu_torch import run_offline
    from csdr_tpu_torch.models import wfm

    x = fm_tone(SECONDS * FS)
    chunks = len(x) // CHUNK
    audio, launches, hz, wall = drive_path(
        torch, wfm.wfm_advanced(shift_rate=SHIFT), x, "wfm_advanced")
    require_launches(launches, {"shift_fir_decimate": chunks},
                     f"wfm_advanced, {chunks} chunks")
    def wfm_on(device):
        return run_offline(wfm.wfm_advanced(shift_rate=SHIFT), x[:2 * CHUNK],
                           block_size=CHUNK, device=device)

    cpu = wfm_on("cpu")
    cpu_snr = require_match("wfm_advanced: card vs CPU audio",
                            audio[: len(cpu)], cpu, AUDIO_BAR,
                            x[:2 * CHUNK], lambda: wfm_on("cuda"),
                            lambda: wfm_on("cpu"), frame=4800)
    require(np.allclose(audio[: len(cpu)], cpu, rtol=2e-3, atol=5e-4),
            f"card vs CPU audio: not allclose at {cpu_snr:.1f} dB")
    emit("path", pipeline="wfm_advanced(shift_rate=-0.2)", chunks=chunks,
         chunk=CHUNK, audio_samples=len(audio), tone_hz=hz,
         launches=launches, card_vs_cpu_snr_db=cpu_snr,
         run_offline_s=wall)

    # the unfused chain: shift block, then the plain FIR kernel
    n_unfused = 3
    audio_u, launches_u, hz_u, wall_u = drive_path(
        torch, wfm.wfm_advanced(shift_rate=SHIFT, fuse_shift=False),
        x[: n_unfused * CHUNK], "wfm_advanced(fuse_shift=False)")
    require_launches(launches_u, {"fir_decimate": n_unfused},
                     f"unfused, {n_unfused} chunks")
    unf_snr = snr_db(audio[: len(audio_u)], audio_u)
    require(unf_snr >= AUDIO_BAR, f"fused vs unfused: {unf_snr:.1f} dB")
    emit("path", pipeline="wfm_advanced(shift_rate=-0.2, fuse_shift=False)",
         chunks=n_unfused, tone_hz=hz_u, launches=launches_u,
         fused_vs_unfused_snr_db=unf_snr, run_offline_s=wall_u)
    lint_pipeline(torch, "WFM", wfm.wfm_advanced(shift_rate=SHIFT), x[:CHUNK])
    lint_vs_profiler(torch, "WFM", wfm.wfm_advanced(shift_rate=SHIFT),
                     x[:CHUNK])
    return x, launches, launches_u, wall, chunks


def throughput(torch, pipe, xs):
    """Step time of ``pipe`` on device-resident chunks ``xs`` (CUDA events),
    the same steps queued ahead of the device, and each block alone on the
    input it gets in the chain."""
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    box = {"state": pipe.init(dev), "i": 0}

    def step():
        box["state"], y = pipe(box["state"], xs[box["i"] % len(xs)])
        box["i"] += 1
        return y

    with torch.no_grad():
        step_ms = time_cuda(step, iters=10, warmup=3, repeats=5)
        # the same steps queued behind a spin kernel: the device's own time
        # per step, as if the host issued launches instantly
        device_ms = time_cuda(step, iters=10, warmup=1, repeats=5,
                              queue_ahead_ms=100.0)
        per_block, state, v = {}, pipe.init(dev), xs[0]
        for _ in range(2):
            state, _ = pipe(state, xs[0])
        for blk, st in zip(pipe.blocks, state):
            ms = time_cuda(lambda b=blk, s=st, u=v: b(s, u), iters=10,
                           warmup=2, repeats=5)
            per_block[blk.name] = ms
            _, v = blk(st, v)
    n = xs[0].shape[0]
    return {"chunk": n, "step_ms": step_ms, "msps": n / step_ms / 1e3,
            "device_ms": device_ms, "device_busy_share": device_ms / step_ms,
            "per_block_ms": per_block}


TP_NOTE = ("step_ms: CUDA events around back-to-back pipeline steps on "
           "device-resident chunks; device_ms: the same steps queued ahead "
           "of the device; run_offline_msps: host clock, host-to-device "
           "copies and output back to the host included")


def phase_throughput(torch, x, wall, chunks):
    from csdr_tpu_torch.models import wfm

    dev = torch.device("cuda")
    pipe = wfm.wfm_advanced(shift_rate=SHIFT).to(dev)
    xs = [torch.from_numpy(x[c * CHUNK:(c + 1) * CHUNK]).to(dev)
          for c in range(4)]
    tp = throughput(torch, pipe, xs)
    emit("throughput", pipeline="wfm_advanced(shift_rate=-0.2)", **tp,
         run_offline_msps=chunks * CHUNK / wall / 1e6, note=TP_NOTE)


# ---------------------------------------------------------------------------
# the fastddc channelizer (paths A, A', B) and the SSB receiver (path C)
# ---------------------------------------------------------------------------

def _counted_modules() -> tuple:
    from csdr_tpu_torch.kernels import (adpcm_cuda, agc_cuda, baudot_cuda,
                                        carrier_cuda, fastddc_cuda, fft_cuda,
                                        fir_cuda, ted_cuda)
    return (fir_cuda, fft_cuda, fastddc_cuda, adpcm_cuda, ted_cuda, agc_cuda,
            carrier_cuda, baudot_cuda)


def reset_all() -> None:
    for mod in _counted_modules():
        mod.reset_launches()


def launches_all() -> dict:
    return {k: v for mod in _counted_modules() for k, v in mod.LAUNCHES.items()}


def require_launches(got: dict, want: dict, what: str) -> None:
    full = {k: want.get(k, 0) for k in got}
    require(got == full, f"{what}: launches {got}, want {full}")


def tones(n: int, freqs, seed: int, noise: float = 0.5) -> np.ndarray:
    """Unit complex tones at ``freqs`` (cycles/sample, float64 phase) plus
    complex white noise of std ``noise`` per part, so that every channel
    carries signal."""
    rng = np.random.default_rng(seed)
    s = np.arange(n, dtype=np.float64)
    x = noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for f in freqs:
        x += np.exp(2j * np.pi * np.mod(f * s, 1.0))
    return x.astype(np.complex64)


def checked_channels(rates, gap: float = 0.1, most: int = 6) -> list[int]:
    """Channels at least ``gap`` apart, so each checked channel's passband
    holds its own test tone and no other."""
    picked: list[int] = []
    for k in np.argsort(rates):
        if all(abs(rates[k] - rates[j]) > gap for j in picked):
            picked.append(int(k))
    return picked[:most]


def peak_cycles(y: np.ndarray) -> float:
    """Frequency of the strongest bin, cycles/sample in [-0.5, 0.5)."""
    spec = np.abs(np.fft.fft(y * np.hanning(len(y))))
    f = np.argmax(spec) / len(y)
    return f - 1.0 if f >= 0.5 else f


def stream(torch, pipe, x: np.ndarray, chunk: int, dev) -> list:
    """A block or pipeline over ``x`` in chunks on ``dev``, as a user calls
    it; the valid outputs per chunk, synchronised."""
    from csdr_tpu_torch import VarOut
    state, outs = pipe.init(dev), []
    with torch.no_grad():
        for c in range(len(x) // chunk):
            state, y = pipe(state, torch.from_numpy(
                x[c * chunk:(c + 1) * chunk]).to(dev))
            outs.append(y.compact() if isinstance(y, VarOut) else y)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return outs


def check_tones(outs, checked, want: float, what: str) -> dict:
    """Each checked channel's test tone, over all chunks, at ``want``."""
    got = {}
    for k in checked:
        got[k] = peak_cycles(np.concatenate([o[k].cpu().numpy()
                                             for o in outs]))
        require(abs(got[k] - want) < 1e-3,
                f"{what}: channel {k} tone at {got[k]:.5f}, want {want}")
    return got


def phase_fastddc_paths(torch):
    import copy

    from csdr_tpu_torch import Pipeline
    from csdr_tpu_torch.ops import fastddc as fd

    require_no_tf32(torch)
    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    rates = bench_rates()
    checked = checked_channels(rates)
    result = {}

    # A: the channelizer at D=16
    ddc = fd.fastddc_init(0.05, 16)
    chunk = FRAMES_A * ddc.input_size
    delta = 0.01                           # in each checked passband
    x = tones(CHUNKS_A * chunk, [-rates[k] + delta for k in checked], 5)
    chan_cpu = fd.fastddc_channelizer_block(ddc, rates)
    chan = copy.deepcopy(chan_cpu).to(dev)
    reset_all()
    t0 = time.perf_counter()
    outs = stream(torch, chan, x, chunk, dev)
    wall = time.perf_counter() - t0
    launches = launches_all()
    require_launches(launches, {"fastddc_inv": CHUNKS_A}, "path A")
    m = ddc.post_input_size // ddc.post_decimation
    require(all(tuple(o.shape) == (CHANNELS, FRAMES_A * m) for o in outs),
            "path A: output shape")
    require(all(bool(torch.isfinite(torch.view_as_real(o)).all())
                for o in outs), "path A: non-finite output")
    got = check_tones(outs, checked, delta * 16, "path A")

    def first_chunk(blk, device):
        return stream(torch, blk, x[:chunk], chunk, device)[0].cpu().numpy()

    cpu0 = first_chunk(chan_cpu, cpu)
    card0 = outs[0].cpu().numpy()
    snr_cpu = require_match(
        "path_A: card vs CPU", card0, cpu0, CHANNEL_BAR, x[:chunk],
        lambda: first_chunk(chan, dev), lambda: first_chunk(chan_cpu, cpu),
        frame=m)
    # the same chunk with TF32 switched on globally: the channelizer's
    # split-DFT product runs in full float32 all the same
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card_tf32 = first_chunk(chan, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    snr_tf32 = require_match("path_A_tf32_on: card vs CPU", card_tf32, cpu0,
                             CHANNEL_BAR, frame=m)
    emit("path", path="A", pipeline="fastddc_channelizer_block("
         "fastddc_init(0.05, 16), 64 rates)", chunks=CHUNKS_A, chunk=chunk,
         launches=launches, tones_at=got, tone_want=delta * 16,
         card_vs_cpu_min_channel_snr_db=snr_cpu,
         tf32_on_card_vs_cpu_min_channel_snr_db=snr_tf32,
         tf32_on_bitwise_equal=bool(np.array_equal(card_tf32, card0)),
         stream_s=wall)
    result["A"] = (launches, chan, x, chunk, wall)
    lint_pipeline(torch, "A", chan, x[:chunk])

    # A': the forward block and the inverse block at D=16
    pipe = Pipeline([fd.fastddc_fwd_block(ddc),
                     fd.fastddc_inv_block(ddc, rates)],
                    name="fastddc16 fwd|inv").to(dev)
    reset_all()
    outs_ap = stream(torch, pipe, x[:CHUNKS_AP * chunk], chunk, dev)
    launches_ap = launches_all()
    require_launches(launches_ap, {"fastddc_inv": CHUNKS_AP}, "path A'")
    snr_ap = min(require_match("path_A'_vs_A: chunk", b.cpu().numpy(),
                               a.cpu().numpy(), CHANNEL_BAR, frame=m)
                 for a, b in zip(outs, outs_ap))
    emit("path", path="A'", pipeline="fastddc_fwd_block(ddc16) | "
         "fastddc_inv_block(ddc16, 64 rates)", chunks=CHUNKS_AP,
         launches=launches_ap, vs_path_a_min_channel_snr_db=float(snr_ap))
    del outs, outs_ap

    # B: kernel-order forward and the classed inverse at D=50
    ddc = fd.fastddc_init(0.05, 50)
    chunk = FRAMES_B * ddc.input_size
    delta = 0.004
    x = tones(CHUNKS_B * chunk, [-rates[k] + delta for k in checked], 6)
    pipe_cpu = Pipeline([
        fd.fastddc_fwd_block(ddc, spectra_order="kernel"),
        fd.fastddc_inv_block(ddc, rates, spectra_order="kernel")],
        name="fastddc50")
    pipe = copy.deepcopy(pipe_cpu).to(dev)
    reset_all()
    t0 = time.perf_counter()
    outs = stream(torch, pipe, x, chunk, dev)
    wall = time.perf_counter() - t0
    launches = launches_all()
    require_launches(launches, {"fft_ko": CHUNKS_B}, "path B")
    require(all(bool(torch.isfinite(torch.view_as_real(o)).all())
                for o in outs), "path B: non-finite output")
    got = check_tones(outs, checked, delta * 50, "path B")

    def first_chunk_b(blk, device):
        return stream(torch, blk, x[:chunk], chunk, device)[0].cpu().numpy()

    snr_cpu = require_match(
        "path_B: card vs CPU", outs[0].cpu().numpy(),
        first_chunk_b(pipe_cpu, cpu), CHANNEL_BAR, x[:chunk],
        lambda: first_chunk_b(pipe, dev),
        lambda: first_chunk_b(pipe_cpu, cpu), frame=ddc.post_input_size)
    emit("path", path="B", pipeline="fastddc_fwd_block(ddc50, kernel "
         "order) | fastddc_inv_block(ddc50, 64 rates, kernel order)",
         chunks=CHUNKS_B, chunk=chunk, launches=launches, tones_at=got,
         tone_want=delta * 50,
         card_vs_cpu_min_channel_snr_db=snr_cpu, stream_s=wall)
    result["B"] = (launches, pipe, x, chunk, wall)
    lint_pipeline(torch, "B", pipe, x[:chunk])
    return result


def phase_ssb_path(torch):
    from csdr_tpu_torch import run_offline
    from csdr_tpu_torch.models import receivers

    require_no_tf32(torch)
    n = CHUNKS_C * CHUNK_C
    s = np.arange(n, dtype=np.float64)
    x = np.exp(2j * np.pi * np.mod(0.0005 * s, 1.0)).astype(np.complex64)
    pipe = receivers.ssb_receiver(0.0, 0.1, 0.05, decimation=50,
                                  agc_on=False)
    reset_all()
    t0 = time.perf_counter()
    audio = run_offline(pipe, x, block_size=CHUNK_C)
    wall = time.perf_counter() - t0
    launches = launches_all()
    require_launches(launches, {"fir_decimate": CHUNKS_C, "fft_ko": CHUNKS_C,
                                "ifft_ko": CHUNKS_C}, "path C")
    require(audio.dtype == np.float32 and np.all(np.isfinite(audio))
            and len(audio) == n // 50, "path C: audio not finite float32")
    peak = abs(peak_cycles(audio[2000:]))       # real audio: +-f mirror
    require(abs(peak - 0.0005 * 50) < 0.002, f"path C: tone at {peak}")
    # a tone at -0.004 lands at -0.2 after decimation: outside the USB band
    x2 = np.exp(-2j * np.pi * np.mod(0.004 * s[:2 * CHUNK_C], 1.0)
                ).astype(np.complex64)
    audio2 = run_offline(pipe, x2, block_size=CHUNK_C)
    reject = float(np.abs(audio2[2000:]).mean()
                   / np.abs(audio[2000: len(audio2)]).mean())
    require(reject < 0.02, f"path C: out-of-band tone passes at {reject}")
    def ssb_on(device):
        return run_offline(receivers.ssb_receiver(
            0.0, 0.1, 0.05, decimation=50, agc_on=False), x[:2 * CHUNK_C],
            block_size=CHUNK_C, device=device)

    cpu = ssb_on("cpu")
    cpu_snr = require_match("path_C: card vs CPU audio", audio[: len(cpu)],
                            cpu, SSB_BAR, x[:2 * CHUNK_C],
                            lambda: ssb_on("cuda"), lambda: ssb_on("cpu"),
                            frame=CHUNK_C // 50)
    emit("path", path="C", pipeline="ssb_receiver(0.0, 0.1, 0.05, "
         "decimation=50, agc_on=False)", chunks=CHUNKS_C, chunk=CHUNK_C,
         launches=launches, tone_cycles=peak, tone_want=0.025,
         out_of_band_ratio=reject, card_vs_cpu_snr_db=cpu_snr,
         run_offline_s=wall)
    lint_pipeline(torch, "C", receivers.ssb_receiver(
        0.0, 0.1, 0.05, decimation=50, agc_on=False), x[:CHUNK_C])
    return launches, pipe, x, wall


def phase_new_throughput(torch, paths, ssb):
    from csdr_tpu_torch import Pipeline

    dev = torch.device("cuda")
    labels = {"A": "fastddc_channelizer_block(ddc16, 64 rates)",
              "B": "fastddc_fwd_block | fastddc_inv_block, D=50, kernel "
                   "order, 64 rates"}
    for key, label in labels.items():
        _, pipe, x, chunk, wall = paths[key]
        if not isinstance(pipe, Pipeline):
            pipe = Pipeline([pipe], name=label)
        xs = [torch.from_numpy(x[c * chunk:(c + 1) * chunk]).to(dev)
              for c in range(min(3, len(x) // chunk))]
        tp = throughput(torch, pipe, xs)
        emit("throughput", path=key, pipeline=label, **tp,
             stream_msps=(len(x) // chunk) * chunk / wall / 1e6,
             note=TP_NOTE.replace("run_offline_msps", "stream_msps"))
    _, pipe, x, wall = ssb
    xs = [torch.from_numpy(x[c * CHUNK_C:(c + 1) * CHUNK_C]).to(dev)
          for c in range(3)]
    tp = throughput(torch, pipe.to(dev), xs)
    emit("throughput", path="C", pipeline="ssb_receiver(agc_on=False)", **tp,
         run_offline_msps=CHUNKS_C * CHUNK_C / wall / 1e6, note=TP_NOTE)


# ---------------------------------------------------------------------------
# K5 and its path (P); the NFM (D), full SSB (E) and AM (F) receivers
# ---------------------------------------------------------------------------

def poly_case(torch, d, t, kout, seed, xlen=None):
    """K5 at one shape against its plain version (>= SNR_BAR) and against
    K2 on the same input; its time, the plain version's, conv1d's and the
    least time.  The stream is (kout-1)*D + T samples, or ``xlen``."""
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.kernels import fir_cuda
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    n = xlen or (kout - 1) * d + t
    gen = torch.Generator(device=dev).manual_seed(seed)
    sets, pick = _timed_sets(lambda i: torch.randn(
        n, dtype=torch.complex64, device=dev, generator=gen))
    taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
    plan = fir_cuda.poly_plan(t, d, kout)
    yk = fir_cuda.fir_decimate_poly(sets[0], taps, d, kout)
    yp = fir_cuda.fir_decimate_poly_plain(sets[0], taps, d, kout)
    y2 = fir_cuda.fir_decimate(sets[0][:0], sets[0], taps, d, kout)
    torch.cuda.synchronize()
    yk, yp, y2 = (v.cpu().numpy() for v in (yk, yp, y2))
    snr, snr_k2 = snr_db(yp, yk), snr_db(y2, yk)
    require(np.all(np.isfinite(yk)), "fir_poly: non-finite output")
    require(snr > SNR_BAR, f"fir_poly D={d} T={t} kout={kout}: SNR "
                           f"{snr:.1f} dB vs plain <= {SNR_BAR}")
    require(snr_k2 >= POLY_K2_BAR, f"fir_poly D={d} T={t} kout={kout}: "
                                   f"{snr_k2:.1f} dB vs K2 < {POLY_K2_BAR}")
    ms = time_cuda(lambda: fir_cuda.fir_decimate_poly(pick(), taps, d, kout),
                   iters=40, queue_ahead_ms=20.0)
    plain_ms = time_cuda(
        lambda: fir_cuda.fir_decimate_poly_plain(pick(), taps, d, kout),
        iters=5, warmup=1, repeats=3)
    planes = [torch.view_as_real(v).T.contiguous()[:, None, :] for v in sets]
    turn = iter(range(1 << 30))
    w = taps.view(1, 1, -1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_ms = time_cuda(lambda: torch.nn.functional.conv1d(
            planes[next(turn) % len(planes)], w, stride=d), iters=40,
            queue_ahead_ms=20.0)
    # least time: the stream and taps read once, the output written once;
    # FP32 operations: 2 FMA (4 flops) per tap per output
    nbytes = 8 * n + 4 * t + 8 * kout
    flops = 4 * t * kout
    bound, bound_by = least_ms(torch, nbytes, flops)
    return {
        "name": "fir_poly", "route": "cuda", "source": POLY_SOURCE,
        "replaces": "csdr_tpu/kernels/fir_pallas.py:37",
        "shape": {"D": d, "T": t, "kout": kout, "len": n},
        "plan": {k: plan[k] for k in ("tile", "per_thread", "groups",
                                      "threads", "smem", "blocks",
                                      "blocks_per_sm")},
        "snr_db": snr, "snr_bar_db": SNR_BAR, "snr_vs_k2_db": snr_k2,
        "snr_vs_k2_bar_db": POLY_K2_BAR,
        "max_abs_err": float(np.max(np.abs(yk - yp))),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by,
        "bound_share": bound / ms,
        "library_ms": lib_ms, "library_over_kernel": lib_ms / ms,
        "library_call": "torch.nn.functional.conv1d(stride=D), cuDNN, "
                        "TF32 off, on (re, im) planes",
        "bytes": nbytes, "flops": flops,
        **roofline_row(torch, "fir_poly",
                       lambda v, h: fir_cuda.fir_decimate_poly(v, h, d, kout),
                       sets[0], taps, nbytes, flops, ms),
    }


def phase_poly_kernels(torch):
    """K5 at path P's shape (the tail-extended 2.4 M-sample chunk) and at
    the four shapes K5 must serve: the BASELINE headline, NFM's front end,
    m = 1 and a ragged kout.  Then K2 at path D's shape (NFM's front end),
    which no earlier path gives it."""
    tail = 1030                     # round_up(T-1, D) at D=10, T=1023
    case_p = dict(poly_case(torch, 10, 1023, CHUNK // 10, 21,
                            xlen=tail + CHUNK), path="P")
    others = [poly_case(torch, 10, 1023, 262_144, 22),
              poly_case(torch, 50, 81, 48_000, 23),
              poly_case(torch, 10, 7, 240_000, 24),
              poly_case(torch, 50, 801, 48_061, 25)]
    case_d = dict(kernel_case(torch, "fir_decimate", 50, 81, CHUNK // 50,
                              0.0, 0.0, 26), path="D")
    for c in [case_p] + others + [case_d]:
        emit("kernels", **c)
    poly_nan_case(torch)
    return [case_p, case_d]


def poly_nan_case(torch):
    """K5 reads exactly its M tap rows: a NaN in a sample that only rows
    m >= M would reach (column kout+1 of a stream of (kout + 8)*D samples
    at D=50/T=81, M=2) leaves every output finite and equal to the plain
    version."""
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.kernels import fir_cuda

    d, t, kout = 50, 81, 48_000
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn((kout + 8) * d, dtype=torch.complex64, device=dev,
                    generator=gen)
    x[(kout + 1) * d] = complex(float("nan"), float("nan"))
    taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
    yk = fir_cuda.fir_decimate_poly(x, taps, d, kout).cpu().numpy()
    yp = fir_cuda.fir_decimate_poly_plain(x, taps, d, kout).cpu().numpy()
    finite = bool(np.all(np.isfinite(yk)))
    snr = snr_db(yp, yk) if finite else float("nan")
    emit("kernels", name="fir_poly", check="no row past M",
         shape={"D": d, "T": t, "kout": kout, "len": len(x),
                "nan_at": (kout + 1) * d},
         finite=finite, snr_db=snr, snr_bar_db=SNR_BAR)
    require(finite, "fir_poly: a NaN only rows m >= M read reached an output")
    require(snr > SNR_BAR, f"fir_poly NaN case: {snr:.1f} dB vs plain")


def phase_poly_path(torch):
    """Path P: the dispatcher over a stream, the tail carried here."""
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.kernels import fir_cuda
    from csdr_tpu_torch.ops import fir

    d, t = 10, 1023
    tail_len = 1030
    taps = firdes.firdes_lowpass_f(t, 0.5 / d)
    x = tones(CHUNKS_P * CHUNK, [0.003, -0.02], 7)

    def run_p(device, chunks):
        dev = torch.device(device)
        tail = torch.zeros(tail_len, dtype=torch.complex64, device=dev)
        taps_dev = torch.from_numpy(taps).to(dev)
        outs = []
        for c in range(chunks):
            xcat = torch.cat([tail, torch.from_numpy(
                x[c * CHUNK:(c + 1) * CHUNK]).to(dev)])
            outs.append(fir_cuda.fir_decimate_poly_or_plain(
                xcat, taps_dev, d, CHUNK // d))
            tail = xcat[-tail_len:]
        return torch.cat(outs).cpu().numpy()

    reset_all()
    t0 = time.perf_counter()
    y = run_p("cuda", CHUNKS_P)
    wall = time.perf_counter() - t0
    launches = launches_all()
    require_launches(launches, {"fir_poly": CHUNKS_P}, "path P")
    require(np.all(np.isfinite(y)) and len(y) == CHUNKS_P * CHUNK // d,
            "path P: output")
    dev = torch.device("cuda")
    k2 = torch.cat(stream(torch, fir.fir_decimate_block(taps, d).to(dev), x,
                          CHUNK, dev)).cpu().numpy()
    snr_k2 = snr_db(k2, y)
    require(snr_k2 >= SNR_BAR, f"path P vs fir_decimate_block (K2): "
                               f"{snr_k2:.1f} dB < {SNR_BAR}")
    cpu = run_p("cpu", 2)
    snr_cpu = require_match("path_P: card vs CPU", y[: len(cpu)], cpu,
                            SNR_BAR, x[:2 * CHUNK], lambda: run_p("cuda", 2),
                            lambda: run_p("cpu", 2), frame=CHUNK // d)
    emit("path", path="P", pipeline="fir_decimate_poly_or_plain(xcat, "
         "lowpass T=1023, D=10), tail carried by the caller",
         chunks=CHUNKS_P, chunk=CHUNK, launches=launches,
         vs_fir_decimate_block_k2_snr_db=snr_k2, card_vs_cpu_snr_db=snr_cpu,
         stream_s=wall)
    return launches


def receiver_path(torch, key, make, x, chunk, per_chunk, cpu_chunks,
                  settle=0):
    """``make()`` over ``x`` on the card through run_offline, launch counts
    zeroed just before and read just after (``per_chunk`` launches of each
    kernel a chunk); the card's first ``cpu_chunks`` chunks against the
    port on the CPU, from audio sample ``settle`` on, at RECEIVER_BAR."""
    from csdr_tpu_torch import run_offline

    chunks = len(x) // chunk
    reset_all()
    t0 = time.perf_counter()
    audio = run_offline(make(), x, block_size=chunk)
    wall = time.perf_counter() - t0
    launches = launches_all()
    require_launches(launches, {k: chunks for k in per_chunk}, f"path {key}")
    require(audio.dtype == np.float32 and np.all(np.isfinite(audio))
            and len(audio) == chunks * chunk // 50,
            f"path {key}: audio not finite float32")

    def on(device):
        return run_offline(make(), x[: cpu_chunks * chunk], block_size=chunk,
                           device=device)

    cpu = on("cpu")
    snr = require_match(f"path_{key}: card vs CPU audio",
                        audio[settle: len(cpu)], cpu[settle:], RECEIVER_BAR,
                        x[: cpu_chunks * chunk],
                        lambda: on("cuda")[settle:],
                        lambda: on("cpu")[settle:], frame=chunk // 50)
    lint_pipeline(torch, key, make(), x[:chunk])
    return audio, launches, wall, snr, cpu


def rms_db(a: np.ndarray) -> float:
    return float(10 * np.log10(np.mean(np.square(a, dtype=np.float64))))


def phase_receiver_paths(torch):
    """Paths D (NFM), E (SSB with its AGC) and F (AM)."""
    from csdr_tpu_torch import run_offline
    from csdr_tpu_torch.models import receivers

    require_no_tf32(torch)
    result = {}

    # D: the reference README's NFM chain at 48 ksps audio
    def nfm():
        return receivers.nfm_receiver(decimation=50, audio_rate=AUDIO_RATE,
                                      fastagc_block_size=CHUNK // 50)
    x = fm_tone(SECONDS * FS, carrier=0.0, dev=5_000.0)
    audio, launches, wall, snr, cpu = receiver_path(
        torch, "D", nfm, x, CHUNK, ("fir_decimate",), 4)
    hz = tone_hz(audio)
    require(abs(hz - 1000.0) < 5.0, f"path D: tone at {hz} Hz, not 1 kHz")
    require(rms_db(cpu[2 * CHUNK // 50:]) > -30.0, "path D: compared "
            "chunks carry no audio")
    emit("path", path="D", pipeline="nfm_receiver(decimation=50, "
         "audio_rate=48000, fastagc_block_size=48000)",
         chunks=len(x) // CHUNK,
         chunk=CHUNK, launches=launches, tone_hz=hz,
         card_vs_cpu_snr_db=snr, run_offline_s=wall)
    result["D"] = (launches, nfm, x, CHUNK, wall)

    # E: the full SSB chain, AGC included, on path C's input
    def ssb():
        return receivers.ssb_receiver(0.0, 0.1, 0.05, decimation=50)
    s = np.arange(CHUNKS_C * CHUNK_C, dtype=np.float64)
    x = np.exp(2j * np.pi * np.mod(0.0005 * s, 1.0)).astype(np.complex64)
    audio, launches, wall, snr, cpu = receiver_path(
        torch, "E", ssb, x, CHUNK_C, ("fir_decimate", "fft_ko", "ifft_ko",
                                      "agc_relax"), 2, SSB_SETTLE)
    peak = abs(peak_cycles(audio[2000:]))
    require(abs(peak - 0.0005 * 50) < 0.002, f"path E: tone at {peak}")
    whole = snr_db(cpu, audio[: len(cpu)])
    # the AGC's level: the same input 40 dB quieter, 3 chunks, the last
    # chunk of each within 3 dB
    quiet = run_offline(ssb(), 0.01 * x[:3 * CHUNK_C], block_size=CHUNK_C)
    per = CHUNK_C // 50
    loud_db, quiet_db = rms_db(audio[2 * per:3 * per]), rms_db(quiet[2 * per:])
    require(abs(loud_db - quiet_db) <= 3.0, f"path E: AGC levels "
            f"{loud_db:.2f} and {quiet_db:.2f} dB for inputs 40 dB apart")
    emit("path", path="E", pipeline="ssb_receiver(0.0, 0.1, 0.05, "
         "decimation=50) (agc_on=True)", chunks=CHUNKS_C, chunk=CHUNK_C,
         launches=launches, tone_cycles=peak, tone_want=0.025,
         card_vs_cpu_snr_db=snr, card_vs_cpu_from_audio_sample=SSB_SETTLE,
         card_vs_cpu_whole_snr_db=whole, agc_level_db={
             "input_0_dB": loud_db, "input_minus_40_dB": quiet_db},
         run_offline_s=wall)
    result["E"] = (launches, ssb, x, CHUNK_C, wall)

    # F: the reference's AM chain
    t = np.arange(SECONDS * FS) / FS
    x = (1.0 + 0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.complex64)
    audio, launches, wall, snr, _ = receiver_path(
        torch, "F", receivers.am_receiver, x, CHUNK,
        ("fir_decimate", "agc_relax"), 2)
    hz = tone_hz(audio)
    require(abs(hz - 1000.0) < 5.0, f"path F: tone at {hz} Hz, not 1 kHz")
    emit("path", path="F", pipeline="am_receiver()", chunks=len(x) // CHUNK,
         chunk=CHUNK, launches=launches, tone_hz=hz, card_vs_cpu_snr_db=snr,
         run_offline_s=wall)
    result["F"] = (launches, receivers.am_receiver, x, CHUNK, wall)
    return result


def agc_cost(torch, x_chunk, blk=None, kernel: str = "agc_relax"):
    """Launches, host syncs, scalar uploads and time of one AGC block step
    (``blk``, agc_block() by default) on a chunk of audio on the card:
    torch.profiler's launch calls and syncs, and utils/dispatch_lint's
    launching ops, kernel launches and uploads.  The step must be one
    launch of ``kernel`` with no host sync and no upload."""
    from csdr_tpu_torch.ops import agc
    from csdr_tpu_torch.utils import dispatch_lint
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    blk = agc.agc_block() if blk is None else blk
    a = torch.from_numpy(x_chunk).to(dev)
    state, _ = blk(blk.init(dev), a)        # a continuing chunk
    prof = profile_call(torch, lambda: blk(state, a))
    # teeth: a planted read of a card value counts one card sync
    planted = profile_call(torch, lambda: float(a.sum()))["card_syncs"]
    require(planted == 1, f"profile_call: a planted .item() on the card "
                          f"counts {planted} card syncs, not 1")
    trace, _ = dispatch_lint.trace_fn(blk, state, a)
    lint = {"lint_launching": trace.launching,
            "lint_kernel_launches": dict(trace.kernel_launches),
            "lint_host_syncs": len(trace.syncs),
            "lint_scalar_uploads": len(trace.uploads)}
    require(lint["lint_kernel_launches"] == {kernel: 1}
            and not trace.syncs and not trace.uploads
            and prof["card_syncs"] == 0 and prof["cuda_launch_calls"] == 1,
            f"agc step: not one kernel launch without syncs: {lint} {prof}")
    ms = time_cuda(lambda: blk(state, a), iters=5, warmup=1, repeats=3)
    return {"samples": len(x_chunk), "ms": ms, **prof, **lint}


def phase_receiver_throughput(torch, paths):
    """Throughput of D, E and F as for C, then the AGC's own cost."""
    from csdr_tpu_torch import run_offline

    dev = torch.device("cuda")
    labels = {"D": "nfm_receiver(50, 48000, fastagc 48000)",
              "E": "ssb_receiver(agc_on=True)", "F": "am_receiver()"}
    for key, label in labels.items():
        _, make, x, chunk, wall = paths[key]
        xs = [torch.from_numpy(x[c * chunk:(c + 1) * chunk]).to(dev)
              for c in range(3)]
        tp = throughput(torch, make().to(dev), xs)
        emit("throughput", path=key, pipeline=label, **tp,
             run_offline_msps=(len(x) // chunk) * chunk / wall / 1e6,
             note=TP_NOTE)
    _, make, x, chunk, _ = paths["E"]
    pre = run_offline(_pre_agc(make), x[:2 * chunk], block_size=chunk)
    emit("agc_cost", path="E", **agc_cost(torch, pre[chunk // 50:]),
         note="one agc_block (chunked) step on path E's second chunk of "
              "audio; cuda_launch_calls, host_syncs (reads of the block's "
              "CPU 'started' flag included) and card_syncs from "
              "torch.profiler, lint_* from utils/dispatch_lint")


# ---------------------------------------------------------------------------
# the chunked AGC's relaxation kernel (csrc/agc.cu), at E's and F's shapes
# ---------------------------------------------------------------------------

AGC_SOURCE = "csdr_tpu_torch/csrc/agc.cu"
AGC_CHUNK = 8192           # agc_block's and the CLI's chunk: a kernel row
AGC_PROBE_SCANS = 100      # affine scans of each probe run
AGC_PROBE_STEPS = 13       # the probe's steps a scan: log2(AGC_CHUNK)
AGC_FLOPS = 42             # float ops a sample a scan: ~13 steps of 3, 3 more


def agc_signal(n: int = 50_000) -> np.ndarray:
    """tests/test_agc.py's signal: a modulated tone with a zero run (the
    attack, hang, decay and zero branches all run)."""
    s = ((0.3 + 0.25 * np.sin(2 * np.pi * 0.0007 * np.arange(n)))
         * np.sin(2 * np.pi * 0.043 * np.arange(n))).astype(np.float32)
    s[10_000:10_100] = 0.0
    return s


def pre_agc_audio(torch, make, x: np.ndarray, chunk: int):
    """The audio a receiver's AGC takes on its second chunk, and the AGC's
    state (on the card) after its first."""
    from csdr_tpu_torch import run_offline
    from csdr_tpu_torch.ops import agc

    pre = run_offline(_pre_agc(make), x[:2 * chunk], block_size=chunk)
    per = chunk // 50
    blk = agc.agc_block()
    state, _ = blk(blk.init("cuda"), torch.from_numpy(pre[:per]).to("cuda"))
    return pre[per:2 * per], {"started": True, "last_gain": state[0],
                              "last_hang": state[1]}


def agc_cases(torch, receivers) -> dict:
    """name -> (input, relax's keywords): E's and F's second audio chunk
    continuing from the state of their first, _agc_signal from the
    stream's start (its padded 7th chunk never settles), the zero run at
    max_gain 100 (tests/test_torch_agc.py), n = 1, 5 x 8192 and 5 x 8192 +
    1; E's audio tiled over the fewest rows that get each other cluster
    size and layout agc_cuda.plan picks, and over 2 rows more than
    clusters fit on the card (rows in turns) at chunk 8192 and 2048."""
    from csdr_tpu_torch.kernels import agc_cuda

    e, e_kw = pre_agc_audio(torch, *receivers["E"][1:4])
    f, f_kw = pre_agc_audio(torch, *receivers["F"][1:4])
    k = 5 * AGC_CHUNK
    zero = np.concatenate([np.full(4096, 1e-6, np.float32),
                           np.zeros(15_904, np.float32)])

    def tiled(rows, chunk=AGC_CHUNK):
        return np.tile(e, -(-rows * chunk // len(e)))[:rows * chunk - 100]
    cases = {
        "E": (e, e_kw), "F": (f, f_kw),
        "agc_signal_start": (agc_signal(), {}),
        "zero_run_max_gain_100": (zero, {"max_gain": 100.0}),
        "n1": (e[:1], e_kw),
        "n5x8192": (e[:k], e_kw),
        "n5x8192+1": (e[:k + 1], {})}
    resident = agc_cuda.resident_rows(AGC_CHUNK)
    first = agc_cuda.plan(len(e))
    seen = {(first["size"], first["spread"])}
    for rows in range(1, resident + 1):
        p = agc_cuda.plan(rows * AGC_CHUNK)
        if (p["size"], p["spread"]) not in seen:
            seen.add((p["size"], p["spread"]))
            name = f"K{p['size']}{'' if p['spread'] else '_shared'}"
            cases[f"{name}_{rows}_rows"] = (tiled(rows), e_kw)
    for chunk in (AGC_CHUNK, 2048):
        rows = agc_cuda.resident_rows(chunk) + 2
        cases[f"past_resident_{rows}_rows" + (
            "" if chunk == AGC_CHUNK else f"_chunk{chunk}")] = (
            tiled(rows, chunk), dict(e_kw, chunk=chunk))
    return cases


def agc_case(torch, name: str, x: np.ndarray, kw: dict,
             scan_cycles: float) -> dict:
    """agc_cuda.relax (one launch) against relax_plain on the card, bit for
    bit (y, gain, hang, converged); the rounds it ran; its cluster (size,
    layout, CTAs, and the SMs they ran on from one more launch); its time
    (queued, the device alone), the plain version's (one call) and its
    bound: the scans on the chain (per outer round the most of any row) x
    the probe's chain of a scan (scaled to the chunk's steps) at the top
    SM clock, or the bytes and flops if longer.  E's case, the kernel
    table's row, also runs through roofline_row (time_kernel)."""
    from csdr_tpu_torch.kernels import agc_cuda
    from csdr_tpu_torch.utils.timing import time_cuda

    chunk = kw.get("chunk", AGC_CHUNK)
    a = torch.from_numpy(x).to("cuda")
    *got, table = agc_cuda.relax(a, rounds=True, **kw)
    box = {}
    plain_ms = time_cuda(lambda: box.setdefault("p", agc_cuda.relax_plain(
        a, **kw)), iters=1, warmup=0, repeats=1)
    torch.cuda.synchronize()
    same = [same_bits(torch, g, w) for g, w in zip(got, box["p"])]
    require(all(same), f"agc {name} ({len(x)} samples): kernel differs from "
                       f"relax_plain (y, gain, hang, converged): {same}")
    ms = time_cuda(lambda: agc_cuda.relax(a, **kw), iters=20,
                   queue_ahead_ms=20.0)
    rounds, settled = table.cpu().numpy()
    outer = int((rounds[:, 0] > 0).sum())
    require(1 <= outer and np.all(rounds[:outer] >= 1)
            and np.all(rounds <= 14) and np.all(rounds[outer:] == 0),
            f"agc {name}: rounds {rounds[:outer].tolist()}")
    plan = agc_cuda.plan(len(x), chunk)
    cluster = {**plan, "sms": agc_cuda.sms_used(a, **kw)}
    require(cluster["sms"] <= cluster["ctas"]
            and (not plan["spread"] or cluster["sms"] == cluster["ctas"]),
            f"agc {name}: cluster {cluster}")
    scans = rounds - settled
    chain = int(scans.max(1).sum())
    depth = int(np.ceil(np.log2(chunk)))
    nbytes = 8 * len(x) + 16
    flops = AGC_FLOPS * chunk * int(scans.sum())
    t_bytes = least_ms(torch, nbytes, flops)[0]
    scan = scan_cycles * depth / AGC_PROBE_STEPS
    t_chain = chain * scan / SM_CLOCK_HZ * 1e3
    row = {
        "name": "agc_relax", "route": "cuda", "source": AGC_SOURCE,
        "replaces": "csdr_tpu/ops/agc.py:385, 437 (while_loop; no Pallas "
                    "kernel)",
        "case": name,
        "shape": {"samples": len(x), "rows": rounds.shape[1],
                  "chunk": chunk, "started": bool(kw.get("started"))},
        "cluster": cluster,
        "bit_exact": True, "max_abs_err": 0.0,
        "converged": bool(got[3]),
        "outer_rounds": outer,
        "inner_rounds_most": rounds[:outer].max(1).tolist(),
        **({"inner_rounds": rounds[:outer].tolist(),
            "settled": settled[:outer].tolist()}
           if rounds.shape[1] <= 8 else {}),
        "scans_on_chain": chain, "scans": int(scans.sum()),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_chain),
        "bound_by": "bytes" if t_bytes >= t_chain else "operations",
        "bound_note": (f"dependent chain: {chain} scans x {scan:.1f} SM "
                       f"cycles ({depth} Hillis-Steele steps of a "
                       f"{chunk}-sample row, each a store, a barrier, the "
                       f"partner's load, a product and a sum, probed) at "
                       f"{SM_CLOCK_HZ / 1e6:.0f} MHz"),
        "cycles_a_step": (ms * 1e-3 * SM_CLOCK_HZ / (chain * depth)
                          if chain else None),
        "library_ms": None, "bytes": nbytes, "flops": flops,
    }
    if name == "E":
        row.update(path="E", **roofline_row(
            torch, "agc_relax", lambda v: agc_cuda.relax(v, **kw)[0], a,
            None, nbytes, flops, ms, ops_s=t_chain / 1e3))
    return row


def phase_agc_kernels(torch, receivers) -> list:
    """The AGC kernel's registers and spills (nvcc -Xptxas -v; a spill
    fails), then the kernel against its plain version on the card, bit
    for bit, in every case of agc_cases, with the probe chain that bounds
    it; E's case is the kernel table's row, with time_kernel.  Returns
    it."""
    from csdr_tpu_torch.kernels import _build, agc_cuda

    # one instance a number of samples a thread (agc_relax_kernel<E>)
    usage = {k: v for k, v in _build.ptxas_usage("agc.cu").items()
             if "agc_relax_kernel" in k}
    require(len(usage) >= 1 and all("registers" in v
                                     for v in usage.values()),
            f"agc_relax_kernel: no ptxas report {usage}")
    emit("kernels", name="agc_relax_ptxas", source=AGC_SOURCE,
         check="nvcc -Xptxas -v for each agc_relax_kernel instance",
         instances=usage)
    require(all(v.get("spill_store_bytes", 1) == 0
                and v.get("spill_load_bytes", 1) == 0
                for v in usage.values()),
            f"agc_relax_kernel spills: {usage}")
    scan = min(agc_cuda.scan_cycles(AGC_PROBE_SCANS) for _ in range(3))
    require(scan > AGC_PROBE_STEPS * 8.0,
            f"agc chain probe: {scan} cycles a scan")
    emit("kernels", name="agc_chain_probe", check="SM cycles of the chain "
         "of one affine scan of an 8192-sample row (csrc/agc.cu: 13 "
         "dependent steps on one warp, each a store to shared memory, a "
         "warp barrier, the partner's load, a product and a sum), the "
         "AGC's bound", scan_cycles=scan,
         step_cycles_mean=scan / AGC_PROBE_STEPS,
         cluster_max=agc_cuda.CLUSTER_MAX)
    rows = []
    for name, (x, kw) in agc_cases(torch, receivers).items():
        c = agc_case(torch, name, x, kw, scan)
        emit("kernels", **c)
        if name == "E":
            rows.append(c)
    return rows


# ---------------------------------------------------------------------------
# agc_ff's exact recurrence (csrc/agc_exact.cu): the CLI's agc_ff with an
# attack wait
# ---------------------------------------------------------------------------

AGC_EXACT_SOURCE = "csdr_tpu_torch/csrc/agc_exact.cu"
AGC_EXACT_CLI = ["agc_ff", "200", "0.2", "0.01", "0.0001", "65536", "5"]
AGC_EXACT_KW = {"hang_time": 200, "reference": 0.2, "attack_rate": 0.01,
                "decay_rate": 0.0001, "max_gain": 65536.0,
                "attack_wait_time": 5}      # AGC_EXACT_CLI's parameters
AGC_EXACT_CHUNK = 1 << 16  # the CLI's default chunk (X_CHUNK)
AGC_EXACT_SAMPLES = 3 * AGC_EXACT_CHUNK + 1001   # the CLI case: 4 chunks
AGC_EXACT_FLOPS = 10       # float ops a sample: the quotient, the error,
                           # both rates' products and sums, the filter's
                           # two adds and product, the output's product


def agc_exact_input(n: int, seed: int) -> np.ndarray:
    """Speech-like audio for the exact AGC: noise low-passed under a
    syllable envelope from 0.001 to 0.5, a pause of exact zeros."""
    r = np.random.default_rng(seed)
    w = np.convolve(r.standard_normal(n + 15), np.ones(16) / 16, "valid")
    env = 0.001 + 0.5 * np.abs(np.sin(2 * np.pi * 3.1 * np.arange(n) / 48e3))
    s = (w[:n] * env).astype(np.float32)
    s[n // 3: n // 3 + 2000] = 0.0
    return s


def agc_exact_cases() -> dict:
    """name -> (input, agc_ff's keywords): _agc_signal (50 000 samples, its
    zero run) from the stream's start at attack wait 0, 5 and 200; its
    second half continuing (started, the state the host loop leaves after
    the first half); one sample; a NaN, +inf and -inf; the clamp's and
    the error's edges (-0.0 and subnormal samples, so ref/|x| is inf and
    the gain hits max_gain, and loud bursts at attack rate 2.5, so it
    falls below 0); a negative max_gain; a gain of -0.0 held by the hang;
    and the CLI's 65 536-sample chunk at AGC_EXACT_CLI's parameters,
    continuing (the kernel table's row)."""
    import torch
    from csdr_tpu_torch.kernels import agc_cuda

    s = agc_signal()
    half = len(s) // 2
    _, g, h, p, a = agc_cuda.scan_plain(torch.from_numpy(s[:half]), 1.0, 0,
                                        np.float32(0.2), 0,
                                        attack_wait_time=5)
    bad = agc_signal(20_000)
    bad[3000], bad[9000], bad[9001] = np.nan, np.inf, -np.inf
    edges = agc_signal(20_000)
    edges[100:110] = -0.0
    edges[500:520] = np.float32(1e-40)
    edges[12_000:12_040] = np.float32(3e4)
    edges[12_040:12_050] = -np.float32(1e-44)
    cli = agc_exact_input(AGC_EXACT_CHUNK, 140)
    return {
        "agc_signal_wait0": (s, {}),
        "agc_signal_wait5": (s, {"attack_wait_time": 5}),
        "agc_signal_wait200": (s, {"attack_wait_time": 200}),
        "continuing_wait5": (s[half:], {
            "attack_wait_time": 5, "started": True, "last_gain": g,
            "last_hang": h, "last_peak": p, "last_awc": a}),
        "n1": (s[:1], {"attack_wait_time": 5, "last_gain": 2.0}),
        "nan_inf": (bad, {"attack_wait_time": 5}),
        "edges": (edges, {"attack_wait_time": 3, "hang_time": 20,
                          "attack_rate": 2.5, "max_gain": 50.0,
                          "started": True, "last_gain": 0.5,
                          "last_peak": np.float32(0.05)}),
        "max_gain_negative": (s[:3000], {"attack_wait_time": 2,
                                         "max_gain": -1.0}),
        "negative_zero_gain": (s[20_000:23_000], {
            "attack_wait_time": 2, "started": True, "last_gain": -0.0,
            "last_hang": 4, "last_peak": np.float32(0.05)}),
        "cli_chunk": (cli, dict(AGC_EXACT_KW, started=True, last_gain=1.5,
                                last_hang=0, last_peak=np.float32(0.133),
                                last_awc=0))}


def agc_exact_case(torch, name: str, x: np.ndarray, kw: dict,
                   cycles: float) -> dict:
    """agc_ff on the card (one launch of the exact kernel, the state
    uploaded once beforehand) against the host loop, bit for bit (y and
    the four state values; where both hold a NaN, its place); its time
    (queued, the device alone), the host loop's (one call) and its
    bound: samples x the probe's SM cycles a sample at the top SM clock,
    or the bytes if longer.  The CLI chunk's case, the kernel table's row,
    also runs through roofline_row."""
    from csdr_tpu_torch.kernels import agc_cuda
    from csdr_tpu_torch.ops import agc
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    kw = dict(kw)
    started = kw.pop("started", False)
    state = [kw.pop("last_gain", 1.0), kw.pop("last_hang", 0),
             kw.pop("last_peak", None), kw.pop("last_awc", 0)]
    a = torch.from_numpy(x).to(dev)
    before = agc_cuda.LAUNCHES["agc_ff_scan"]
    got = agc.agc_ff(a, full_state=True, started=started,
                     last_gain=state[0], last_hang=state[1],
                     last_peak=state[2], last_awc=state[3], **kw)
    require(agc_cuda.LAUNCHES["agc_ff_scan"] == before + 1,
            f"agc_ff {name}: not one launch")
    box = {}
    plain_ms = time_cuda(lambda: box.setdefault("p", agc.agc_ff(
        torch.from_numpy(x), full_state=True, started=started,
        last_gain=state[0], last_hang=state[1], last_peak=state[2],
        last_awc=state[3], **kw)), iters=1, warmup=0, repeats=1)
    torch.cuda.synchronize()
    same = [same_bits_or_nan(torch, g.cpu(), w)
            for g, w in zip(got, box["p"])]
    require(all(same), f"agc_ff {name} ({len(x)} samples): the kernel "
                       f"differs from the host loop (y, gain, hang, peak, "
                       f"awc; NaN payloads aside): {same}")
    # the timed call: the same inputs, the state on the card as a
    # streaming block carries it
    peak = state[2] if state[2] is not None else np.float32(
        float(kw.get("reference", 0.2)) / float(np.float32(state[0])))
    dstate = [torch.tensor(np.float32(state[0]), device=dev),
              torch.tensor(int(state[1]), dtype=torch.int32, device=dev),
              torch.tensor(np.float32(peak), device=dev),
              torch.tensor(int(state[3]), dtype=torch.int32, device=dev)]
    params = dict(kw, started=started)
    ms = time_cuda(lambda: agc_cuda.scan(a, *dstate, **params), iters=20,
                   queue_ahead_ms=20.0)
    n = len(x)
    nbytes = 8 * n + 2 * 16
    flops = AGC_EXACT_FLOPS * n
    bound = scan_bound(torch, n, 1, cycles, nbytes, flops,
                       "a sample of agc_ff's shortest chain from shared "
                       "memory on one thread, probed")
    row = {
        "name": "agc_ff_scan", "route": "cuda", "source": AGC_EXACT_SOURCE,
        "replaces": "csdr_tpu/ops/agc.py:171 (lax.scan; no Pallas kernel)",
        "case": name,
        "shape": {"samples": n, "started": bool(started),
                  "attack_wait_time": kw.get("attack_wait_time", 0)},
        "bit_exact": True, "max_abs_err": 0.0,
        "nan_outputs": int(torch.isnan(got[0]).sum()),
        "ms": ms, "plain_ms": plain_ms, **bound,
        "cycles_a_sample": ms * 1e-3 * SM_CLOCK_HZ / n,
        "library_ms": None,
    }
    if name == "cli_chunk":
        row.update(path="X' agc_ff", **roofline_row(
            torch, "agc_ff_scan",
            lambda v, st: agc_cuda.scan(v, *st, **params)[0], a, dstate,
            nbytes, flops, ms, ops_s=bound["chain_ms"] / 1e3))
    return row


def agc_exact_step_cost(torch) -> dict:
    """Launches, card syncs and scalar uploads of one agc_block(method=
    "scan") step at AGC_EXACT_CLI's parameters on a continuing 65 536-sample
    chunk on the card (agc_cost): one kernel launch, none of the rest."""
    from csdr_tpu_torch.ops import agc

    blk = agc.agc_block(method="scan", **AGC_EXACT_KW)
    return agc_cost(torch, agc_exact_input(AGC_EXACT_CHUNK, 141), blk,
                    "agc_ff_scan")


def phase_agc_exact(torch) -> list:
    """agc_ff's exact scan on the card against the host loop, bit for bit,
    in every case of agc_exact_cases, with the probe chain that bounds it
    and one block step's launches, syncs and uploads.  Returns the CLI
    chunk's row (its launches come from path X')."""
    from csdr_tpu_torch.kernels import agc_cuda

    probe_in = torch.from_numpy(agc_exact_input(agc_cuda.PROBE_MAX, 142)
                                ).to("cuda")
    cycles = min(agc_cuda.exact_cycles(probe_in, **AGC_EXACT_KW)
                 for _ in range(3))
    require(cycles > 8.0, f"agc_ff chain probe: {cycles} cycles a sample")
    emit("kernels", name="agc_ff_chain_probe", check="SM cycles a sample of "
         "agc_ff's shortest chain from shared memory on one thread, what "
         "the step decides beside it precomputed, its last gain the "
         "step's (csrc/agc_exact.cu), the exact scan's bound",
         cycles_a_sample=cycles, samples=agc_cuda.PROBE_MAX)
    rows = []
    for name, (x, kw) in agc_exact_cases().items():
        c = agc_exact_case(torch, name, x, kw, cycles)
        emit("kernels", **c)
        if name == "cli_chunk":
            rows.append(c)
    emit("agc_cost", path="agc_block(method='scan')",
         **agc_exact_step_cost(torch),
         note="one agc_block(method='scan', attack_wait_time=5) step on a "
              "continuing 65 536-sample chunk: torch.profiler and "
              "utils/dispatch_lint, as for the chunked step")
    return rows


# ---------------------------------------------------------------------------
# the timing recovery kernel (csrc/ted.cu), at the bank's shape
# ---------------------------------------------------------------------------

TED_SOURCE = "csdr_tpu_torch/csrc/ted.cu"
TED_SEGMENTS = 4           # the segmented case's lanes a row
TED_WARM = 32              # its warmup symbols (the block's default)
TED_PROBE_LINKS = 1 << 14  # links of each probe chain
TED_FLOPS = 8              # float operations a slot (subs, products, fma)


def ted_inputs(torch, rows: int, n: int, nsb: int, segs: int, seed: int):
    """The TED kernel's inputs as TimingRecoveryBlock buffers a chunk of
    ``n`` samples a row behind its 4*nsb tail, on the card: BPSK at nsb
    samples a symbol (half-sine pulses, a Q part, noise, a gain a row),
    a random valid start s0 and carried corr a row; with ``segs`` > 1 the
    segmented mode's (R, S) lanes as ``_segmented`` lays them out.
    Returns (planes, size, bitstart, corr, cap, span_hi, emit_lo)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    margin = 4 * nsb
    size = margin + n
    sym = torch.randint(0, 2, (rows, size // nsb + 1), device=dev,
                        generator=gen) * 2.0 - 1.0
    k = torch.arange(size, device=dev)
    shape = torch.sin(np.pi * ((k % nsb) + 0.5) / nsb)
    base = sym.repeat_interleave(nsb, 1)[:, :size] * shape
    gain = 0.2 + 2.8 * torch.rand((rows, 1), device=dev, generator=gen)
    x = torch.complex(gain * base, 0.2 * gain * base) + 0.05 * torch.complex(
        torch.randn((rows, size), device=dev, generator=gen),
        torch.randn((rows, size), device=dev, generator=gen))
    planes = torch.view_as_real(x).reshape(rows, 2 * size)
    s0 = torch.randint(0, margin + 1, (rows,), device=dev, generator=gen,
                       dtype=torch.int32)
    corr0 = torch.randint(-nsb // 8, nsb // 8 + 1, (rows,), device=dev,
                          generator=gen, dtype=torch.int32)
    if segs == 1:
        return planes, size, s0, corr0, (n + margin) // nsb + 2, None, None
    span = torch.div(size - s0, segs, rounding_mode="floor")
    s_idx = torch.arange(segs, dtype=torch.int32, device=dev)
    emit_lo = (s0[:, None] + s_idx * span[:, None]).to(torch.int32)
    span_hi = torch.where(s_idx == segs - 1, int(np.iinfo(np.int32).max),
                          emit_lo + span[:, None] + nsb).to(torch.int32)
    bs0 = torch.maximum(emit_lo - TED_WARM * nsb, s0[:, None])
    corr = torch.where(s_idx == 0, corr0[:, None], 0).to(torch.int32)
    return (planes, size, bs0.to(torch.int32).contiguous(), corr,
            (n + margin) // (segs * nsb) + TED_WARM + 4, span_hi, emit_lo)


def ted_chains(torch) -> dict:
    """SM cycles a TED slot takes on the probe chain in csrc/ted.cu (three
    picks from a window staged in shared memory and the step's arithmetic
    to the next bitstart, the chain that bounds the function), the least
    of three runs of TED_PROBE_LINKS slots each."""
    from csdr_tpu_torch.kernels import ted_cuda

    slot = min(ted_cuda.chain_cycles(TED_PROBE_LINKS) for _ in range(3))
    require(slot > 30.0, f"ted chain probe: {slot} cycles a slot")
    return {"slot_cycles": slot}


def same_bits(torch, a, b) -> bool:
    """Equal tensors, floats compared by their bits (a NaN included)."""
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def same_bits_or_nan(torch, a, b) -> bool:
    """same_bits, but where both hold a NaN only its place is compared: a
    NaN's payload is the hardware's (x86 keeps the input's, the card
    writes its canonical one)."""
    if not a.is_floating_point():
        return same_bits(torch, a, b)
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and same_bits(torch, torch.where(nan, 0.0, a),
                          torch.where(nan, 0.0, b)))


def ted_case(torch, name: str, rows: int, n: int, nsb: int, segs: int,
             chains: dict, seed: int, loop_gain: float = 0.5,
             early_late: bool = False) -> dict:
    """ted_cuda.scan on one launch's inputs (ted_inputs) against
    scan_plain on the card, bit for bit (the final state and every slot's
    picks, raw error, start and emit), through the route ring_plan picks
    for the parameters (the ring, or the L2 design for a backward-stepping
    loop gain); config 5's Gardner loop, or early-late with the error from
    I alone.  Its time, the plain version's (one call) and its bound: the
    slots a lane stays alive (the most of any lane, what this data needs)
    x the probe's slot chain at the top SM clock, or the bytes (3 picks a
    slot, the lane's inputs and every output) if longer."""
    from csdr_tpu_torch.kernels import ted_cuda
    from csdr_tpu_torch.utils.timing import time_cuda

    planes, size, bs, corr, cap, hi, lo = ted_inputs(torch, rows, n, nsb,
                                                     segs, seed)
    wing = nsb // 4
    params = (ted_cuda.TedParams(nsb, (3 * wing, wing, nsb // 2), False,
                                 False, 2.0, loop_gain) if early_late else
              ted_cuda.TedParams(nsb, (3 * nsb // 2, nsb // 2, nsb), True,
                                 True, 2.0, loop_gain))
    plan = ted_cuda.ring_plan(size, params)
    key = "ted_scan" if plan.route == "ring" else "ted_scan_l2"

    def kern(p, aux):
        return ted_cuda.scan(p, size, *aux[:2], cap, *aux[2:],
                             params=params)

    aux = (bs, corr, hi, lo)
    before = dict(ted_cuda.LAUNCHES)
    got = kern(planes, aux)
    require(ted_cuda.LAUNCHES == dict(before, **{key: before[key] + 1}),
            f"{name}: not one {key} launch")
    box = {}
    plain_ms = time_cuda(lambda: box.setdefault("p", ted_cuda.scan_plain(
        planes, size, bs, corr, cap, hi, lo, params=params)), iters=1,
        warmup=0, repeats=1)
    torch.cuda.synchronize()
    same = [same_bits(torch, a, b) for a, b in zip(got, box["p"])]
    require(all(same), f"{name} ({rows} x {segs} lanes, {cap} slots): the "
                       f"kernel differs from scan_plain: {same}")
    ms = time_cuda(lambda: kern(planes, aux), iters=20, queue_ahead_ms=20.0)
    lanes = rows * segs
    # a lane is alive at slot k iff bitstart moved after it
    starts = torch.cat([got[4].reshape(lanes, cap),
                        got[0].reshape(lanes, 1)], 1)
    alive = (starts[:, 1:] != starts[:, :-1]).sum(1)
    slots = int(alive.max())
    back = int((starts[:, 1:] < starts[:, :-1]).sum())
    left_back = None
    if early_late:      # slots whose left pick lies below the slot before's
        c = starts[:, 1:-1] - starts[:, :-2] - nsb
        c = torch.where(c.abs().float() >= np.float32(0.9 * (nsb // 4)), 0, c)
        left = starts[:, 1:-1] + wing - c
        moved = (starts[:, 2:] != starts[:, 1:-1])[:, 1:]
        left_back = int(((left[:, 1:] < left[:, :-1]) & moved).sum())
    nbytes = lanes * (slots * 3 * 8 + cap * (24 + 4 + 4 + 1) + 4 * (
        4 if segs > 1 else 2) + 8)
    flops = lanes * slots * TED_FLOPS
    bound = scan_bound(torch, slots, 1, chains["slot_cycles"], nbytes, flops,
                       "an alive slot's dependent shared-memory load and "
                       "arithmetic, probed; the lanes side by side")
    row = {
        "name": key, "route": "cuda", "source": TED_SOURCE,
        "replaces": "csdr_tpu/ops/sync.py:374, 397 (lax.scan; no Pallas "
                    "kernel)",
        "shape": {"rows": rows, "segments": segs, "lanes": lanes,
                  "slots": cap, "alive_slots_most": slots,
                  "samples_a_row": size, "sps": nsb,
                  "algorithm": "early-late" if early_late else "gardner",
                  "loop_gain": loop_gain},
        "ring_plan": plan._asdict(), "backward_steps": back,
        "left_pick_below_slot_before": left_back,
        "bit_exact": True, "max_abs_err": 0.0,
        "emitted": int(got[5].sum()),
        "ms": ms, "plain_ms": plain_ms,
        "share_of_bound": bound["bound_ms"] / ms, **bound,
        "cycles_a_slot": ms * 1e-3 * SM_CLOCK_HZ / slots,
        "library_ms": None,
    }
    if key == "ted_scan" and not early_late:
        row.update(roofline_row(torch, "ted_scan", kern, planes, aux, nbytes,
                                flops, ms, ops_s=bound["chain_ms"] / 1e3))
    return row


def phase_ted_kernels(torch) -> list:
    """The TED kernel against its plain version on the card at the bank's
    shape (G and G' both give it 64 rows of 58 368 samples, sps 256: 230
    slots) and in the segmented mode (64 x TED_SEGMENTS lanes), through the
    ring, and with a loop gain of 4 (|corr| up to 2 symbols: bitstart steps
    back) through the L2 route, whose time at G's shape is the ring's
    in-run yardstick; early-late at loop gain 1 through the ring (a
    correction up to a symbol: the left pick steps back below the slot
    before's); and the probe chain that bounds it.  Returns the row of
    G's shape."""
    chains = ted_chains(torch)
    emit("kernels", name="ted_chain_probe", check="SM cycles a slot of the "
         "chain that bounds the TED (csrc/ted.cu)", **chains)
    m = FRAMES_G // 25 * 448            # G's channel samples a chunk
    serial = dict(ted_case(torch, "ted_scan", CHANNELS, m, SPS, 1, chains,
                           51), path="G")
    seg = ted_case(torch, "ted_scan segmented", CHANNELS, m, SPS,
                   TED_SEGMENTS, chains, 52)
    back = ted_case(torch, "ted_scan loop gain 4", CHANNELS, m, SPS, 1,
                    chains, 53, loop_gain=4.0)
    el = ted_case(torch, "ted_scan early-late loop gain 1", CHANNELS,
                  8_192, 64, 3, chains, 54, loop_gain=1.0, early_late=True)
    require(serial["name"] == seg["name"] == el["name"] == "ted_scan"
            and back["name"] == "ted_scan_l2",
            "ted: the routes are not ring, ring, l2, ring")
    require(el["left_pick_below_slot_before"] > 0,
            "ted early-late at loop gain 1: no left pick stepped back")
    serial.update(l2_route_ms=back["ms"],
                  l2_route_cycles_a_slot=back["cycles_a_slot"],
                  l2_route_note="the L2 design in this run at G's shape, "
                                "loop gain 4 (the 'ted_scan loop gain 4' "
                                "line)")
    emit("kernels", **serial)
    emit("kernels", check="the segmented mode (not on a gated path)", **seg)
    emit("kernels", check="the L2 route: a backward-stepping loop gain "
         "(not on a gated path)", **back)
    emit("kernels", check="early-late at loop gain 1, sps 64, 3 segments: "
         "corrections up to a symbol, the left pick below the slot "
         "before's (not on a gated path)", **el)
    return [serial]


# ---------------------------------------------------------------------------
# the carrier loops (csrc/carrier.cu) and the RTTY Baudot decoder
# (csrc/baudot.cu): csdr_tpu's last three scans
# ---------------------------------------------------------------------------

CARRIER_SOURCE = "csdr_tpu_torch/csrc/carrier.cu"
BAUDOT_SOURCE = "csdr_tpu_torch/csrc/baudot.cu"
# float operations a sample (the transcendentals aside): the Costas
# loop's rotation, error, filter, clamp and phase wrap; the PLL's wraps,
# filter and negation; the Baudot machine runs integer operations only
COSTAS_FLOPS = 16
PLL_FLOPS = 12


def scan_tone(n: int, seed: int) -> np.ndarray:
    """The PLL's input: a unit tone 0.002 cycles a sample off the carrier
    (tests/test_torch_sync.py's) in complex noise of 0.01 a part."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    return (np.exp(1j * (2 * np.pi * 0.002 * k + 1.0)) + 0.01 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def scan_bpsk(n: int, seed: int) -> np.ndarray:
    """The Costas loop's CLI input: BPSK at 32 samples a symbol 0.001
    cycles a sample off the carrier (csdr_tpu's test_digital.py input), in
    complex noise of 0.01 a part: the loop locks."""
    rng = np.random.default_rng(seed)
    bb = np.repeat(rng.integers(0, 2, n // 32 + 1) * 2.0 - 1.0, 32)[:n]
    k = np.arange(n)
    return (bb * np.exp(1j * (2 * np.pi * 0.001 * k + 0.3)) + 0.01 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


# the Baudot decoder's bound: its serial step's transition, as
# csrc/baudot.cu's baudot_next writes it, is 31 integer operations a symbol
# (8 compares, 4 logic, 13 selects, a shift, an or, a mask, an add and the
# code's mask); the card's INT32 rate is 64 lanes a SM (NVIDIA's Hopper
# architecture white paper) at the top SM clock
BAUDOT_INT_OPS = 31
INT32_LANES = 64


def baudot_bound(torch, rows: int, n: int, cap: int, cycles: float) -> dict:
    """The Baudot decoder's bound by the rule of the kernel table: the
    bytes it must move (the symbols in, the characters, counts and states
    out) at the measured memory ceiling (the published rate outside run()),
    or its integer operations at the card's INT32 rate, whichever is
    longer; beside it the serial machine's chain (rows x n x the probe's
    SM cycles a symbol, rows side by side), the floor of a design that
    runs a row on one thread."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peaks = MEASURE["peaks"] or published(torch)
    nbytes = rows * (n + cap + 44)
    t_bytes = nbytes / (peaks["hbm_bw_GBps"] * 1e9) * 1e3
    ops = rows * n * BAUDOT_INT_OPS
    t_ops = ops / (sms * INT32_LANES * SM_CLOCK_HZ) * 1e3
    chain = -(-rows // sms) * n * cycles / SM_CLOCK_HZ * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_note": (f"{nbytes} bytes at "
                           f"{'measured' if MEASURE['peaks'] else 'published'}"
                           f" {peaks['hbm_bw_GBps']:.0f} GB/s, or {ops} "
                           f"integer operations ({BAUDOT_INT_OPS} a symbol) "
                           f"at {sms} SMs x {INT32_LANES} INT32 lanes x "
                           f"{SM_CLOCK_HZ / 1e6:.0f} MHz"),
            "serial_chain_ms": chain, "bytes": nbytes, "int_ops": ops}


def baudot_cases(n: int) -> tuple:
    """The Baudot kernel's adversarial rows of n symbols and their carried
    states: 6 rows of framed characters (2 from carried states a stream
    never makes), then all ones, all zeros, a periodic word whose framing
    never converges (from the seven states its period's map keeps two
    apart: tests/test_torch_baudot.py's _nonconverging word), noise as
    bytes 0, 5 and 10, and framed rows from a bit counter of -60 (state 2
    for 64 symbols, so the first segment, run exactly, ends outside the
    seven states: the tile takes the serial route) and of 5 (never out of
    state 2 in the row): rows (12, n) uint8 and the state as five int32
    lists."""
    rows = np.stack([rtty_symbols(n, s) for s in range(155, 161)] + [
        np.ones(n, np.uint8), np.zeros(n, np.uint8),
        np.resize(np.asarray([0, 1, 1, 1, 1, 0, 0, 1, 1, 1, 1], np.uint8),
                  n), np.random.default_rng(162).integers(0, 3, n) * 5,
        rtty_symbols(n, 163), rtty_symbols(n, 164)]).astype(np.uint8)
    rows[5] = np.random.default_rng(161).integers(0, 3, n) * 5
    state = ([0, 1, 2, 0, -1, 7, 0, 1, 2, 0, 2, 2],
             [0, 0, 1, 0, 5, 0, 1, 0, 5, 0, 0, 1],
             [0, 3, 27, 31, -9, 1 << 20, 27, 0, -4, 31, 5, 3],
             [0, 0, 4, 0, -1, (1 << 31) - 1, 0, 5, 2, 0, -60, 5],
             [0, 1, 0, 1, -3, 0, 1, 0, -3, 1, 1, 0])
    return rows, state


def rtty_symbols(n: int, seed: int) -> np.ndarray:
    """RTTY bit symbols: characters (a start bit 0, five data bits, two
    stop bits 1) with idle gaps of 1 to 3 ones, mode selects among them,
    n bytes."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        out += [1] * int(rng.integers(1, 4))
        out += [0] + list(rng.integers(0, 2, 5)) + [1, 1]
    return np.asarray(out[:n], np.uint8)


def scan_compare(got, want) -> dict:
    """Two (rows, n) outputs (complex64, float32 or integer): bit for bit
    (a NaN compared by its place), or the first differing sample (the
    least sample index over the rows, and its row) and the least SNR over
    the rows."""
    g, w = np.asarray(got), np.asarray(want)
    g2, w2 = np.atleast_2d(g), np.atleast_2d(w)
    if g2.dtype.kind in "fc":
        gf = g2.view(np.float32).reshape(len(g2), -1, 1 + (g2.dtype.kind
                                                            == "c"))
        wf = w2.view(np.float32).reshape(gf.shape)
        nan = np.isnan(gf) & np.isnan(wf)
        diff = ((gf.view(np.uint32) != wf.view(np.uint32)) & ~nan).any(-1)
    else:
        diff = g2 != w2
    if not diff.any():
        return {"bit_for_bit": True, "first_diff": None,
                "snr_db_min": float("inf")}
    firsts = [int(np.argmax(d)) if d.any() else None for d in diff]
    row = min((k for k, f in enumerate(firsts) if f is not None),
              key=lambda k: firsts[k])
    return {"bit_for_bit": False,
            "first_diff": {"row": row, "sample": firsts[row],
                           "rows_differing": int(diff.any(1).sum())},
            "snr_db_min": float(np.min(channel_snrs(w2, g2)))}


def scan_bound(torch, n: int, rows: int, cycles: float, nbytes: float,
               flops: float, what: str = "a step of the function's shortest "
               "chain on one thread from shared memory, probed") -> dict:
    """A scan kernel's bound: a row's n steps x the probe's SM cycles a
    step at the top SM clock (rows up to the card's SMs run side by side),
    or the bytes if longer; ``what`` says what the probe timed."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_bytes = least_ms(torch, nbytes, flops)[0]
    t_chain = -(-rows // sms) * n * cycles / SM_CLOCK_HZ * 1e3
    side = f"; {rows} rows side by side" if rows > 1 else ""
    return {"bound_ms": max(t_bytes, t_chain),
            "bound_by": "bytes" if t_bytes >= t_chain else "operations",
            "bound_note": (f"dependent chain: {n} steps x {cycles:.2f} SM "
                           f"cycles ({what}) at {SM_CLOCK_HZ / 1e6:.0f} MHz"
                           f"{side}"),
            "chain_ms": t_chain, "bytes": nbytes, "flops": flops}


def host_once(fn) -> tuple:
    """(fn(), its host-clock ms): one call of a plain version on the CPU."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def card_vs_plain(torch, name: str, kern, plain, outs, bar: float,
                  first_bar: float | None = None) -> dict:
    """``kern()`` (one launch) against ``plain()`` on the card, output by
    output (``outs`` names them): bit for bit, or each output's first
    differing sample and least SNR over its rows at ``bar`` dB (and at
    ``first_bar`` over the first 256 samples).  Returns the comparison
    and the plain version's ms (one call, CUDA events)."""
    from csdr_tpu_torch.utils.timing import time_cuda

    got = kern()
    box = {}
    plain_ms = time_cuda(lambda: box.setdefault("p", plain()), iters=1,
                         warmup=0, repeats=1)
    torch.cuda.synchronize()
    cmp = {}
    for k, a, b in zip(outs, got, box["p"]):
        c = scan_compare(a.cpu().numpy(), b.cpu().numpy())
        if not c["bit_for_bit"] and first_bar is not None:
            c["snr_db_min_first_256"] = scan_compare(
                a[..., :256].cpu().numpy(),
                b[..., :256].cpu().numpy())["snr_db_min"]
        require(c["bit_for_bit"] or (c["snr_db_min"] >= bar and (
            first_bar is None or c["snr_db_min_first_256"] >= first_bar)),
            f"{name}: the kernel's {k} against the plain version on the "
            f"card: {c} (bars {first_bar}, {bar} dB)")
        cmp[k] = c
    return {"card_vs_plain": cmp,
            "bit_for_bit": all(c["bit_for_bit"] for c in cmp.values()),
            "plain_ms": plain_ms, "plain_on": "card"}


def scan_case_line(torch, name: str, source: str, replaces: str, ms: float,
                   bound: dict, launches: int, **fields) -> None:
    """A kernel-against-plain case's line: its time beside its bound."""
    emit("kernels", name=name, route="cuda", source=source,
         replaces=replaces, ms=ms, **bound,
         share_of_bound=bound["bound_ms"] / ms, launches=launches, **fields)


def phase_scan_kernels(torch) -> list:
    """The PLL's and the Baudot decoder's kernels against their plain
    versions: on the card on 4096 samples (the PLL P and PI, 3 rows of the
    tone; the Baudot decoder on baudot_cases' 12 rows, carried states the
    stream never makes, all ones, all zeros, a periodic word that never
    frames, noise, tiles on the serial route, at a cap that drops
    characters), bit for bit (the decoder: characters, count and state,
    and its serial route the same) or (the PLL) the first differing sample
    and the least SNR at SWEEP_BAR; the decoder at n of 1, 33 and 1001;
    each chain's probe; then each at the CLI's shape (a 65 536-sample
    chunk, X''s) against the plain version on the CPU host (the PLL at
    SWEEP_BAR, the Baudot decoder bit for bit and its two routes bit for
    bit), its time beside its bound (the decoder: beside the serial
    chain, its serial route, an empty launch and its phases' SM cycles,
    and at 134 x 65 536 the two routes bit for bit).  Returns those two
    rows."""
    from csdr_tpu_torch.kernels import baudot_cuda, carrier_cuda
    from csdr_tpu_torch.ops import digital, sync
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    tables = digital._baudot_tables(dev)
    replaces_pll = "csdr_tpu/ops/sync.py:67 (lax.scan; no Pallas kernel)"
    replaces_baudot = ("csdr_tpu/ops/digital.py:182 (lax.scan; no Pallas "
                       "kernel)")
    tone = scan_tone(XP_SCANS, 150)
    cycles = {}
    for mode, (alpha, beta) in (("PI", sync.pll_loop_params(0.01)),
                                ("P", (0.01, None))):
        probe_in = torch.from_numpy(tone[:carrier_cuda.PROBE_MAX]).to(dev)
        cycles[mode] = min(carrier_cuda.pll_cycles(probe_in, alpha, beta)
                           for _ in range(3))
        require(cycles[mode] > 8.0, f"pll chain probe: {cycles[mode]} cycles")
        emit("kernels", name="pll_chain_probe", mode=mode, check="SM cycles "
             "a sample of the PLL's shortest chain (its wraps as an add and "
             "a select of the step's picks, and the loop filter) on one "
             "thread from shared memory, its last state the kernel's "
             "(csrc/carrier.cu), the PLL's bound",
             cycles_a_sample=cycles[mode], samples=carrier_cuda.PROBE_MAX)
        rows = torch.from_numpy(np.stack([scan_tone(COSTAS_SAMPLES, s)
                                          for s in (151, 152, 153)])).to(dev)
        n0 = carrier_cuda.LAUNCHES["pll_scan"]
        got = card_vs_plain(
            torch, f"pll {mode}",
            lambda: carrier_cuda.pll(rows, alpha, beta)[:2],
            lambda: carrier_cuda.pll_plain(rows, alpha, beta)[:2],
            ("dphase", "nco"), SWEEP_BAR)
        require(carrier_cuda.LAUNCHES["pll_scan"] == n0 + 1,
                f"pll {mode}: not one launch")
        ms = time_cuda(lambda: carrier_cuda.pll(rows, alpha, beta),
                       iters=10, queue_ahead_ms=20.0)
        scan_case_line(torch, "pll_scan", CARRIER_SOURCE, replaces_pll, ms,
                       scan_bound(torch, COSTAS_SAMPLES, 3, cycles[mode],
                                  3 * COSTAS_SAMPLES * 20 + 72,
                                  3 * COSTAS_SAMPLES * PLL_FLOPS),
                       1, check=f"the PLL ({mode}) against pll_plain on "
                       "the card (not on a gated path)",
                       shape={"rows": 3, "samples": COSTAS_SAMPLES},
                       **got)
    sym = rtty_symbols(XP_SCANS, 154)
    probe_sym = torch.from_numpy(sym[:baudot_cuda.PROBE_MAX]).to(dev)
    cycles["baudot"] = min(baudot_cuda.chain_cycles(probe_sym, *tables)
                           for _ in range(3))
    require(cycles["baudot"] > 2.0, f"baudot chain probe: "
                                    f"{cycles['baudot']} cycles")
    emit("kernels", name="baudot_chain_probe", check="SM cycles a symbol of "
         "the serial Baudot machine's shortest chain (the transition, "
         "branch-free; the table read and the emit off it) on one thread "
         "from shared memory, its last state and characters the kernel's "
         "(csrc/baudot.cu): the floor of a design that runs a row on one "
         "thread", cycles_a_symbol=cycles["baudot"],
         symbols=baudot_cuda.PROBE_MAX)
    rows, state = baudot_cases(COSTAS_SAMPLES)
    nrows = len(rows)
    rb = torch.from_numpy(rows).to(dev)
    carried = tuple(torch.tensor(v, dtype=torch.int32, device=dev)
                    for v in state)
    outs = ("chars", "count", "st", "fig", "shr", "cnt", "rcvd")

    def flat(r):
        return (r[0], r[1], *r[2])

    for cap in (COSTAS_SAMPLES // 7 + 4, 40):
        n0 = baudot_cuda.LAUNCHES["baudot_scan"]
        got = card_vs_plain(
            torch, f"baudot cap {cap}",
            lambda: flat(baudot_cuda.decode(rb, cap, carried, *tables)),
            lambda: flat(baudot_cuda.decode_plain(rb, cap, carried,
                                                  *tables)), outs, 0.0)
        require(got["bit_for_bit"], f"baudot cap {cap}: not bit for bit")
        require(baudot_cuda.LAUNCHES["baudot_scan"] == n0 + 1,
                f"baudot cap {cap}: not one launch")
        ser = baudot_cuda.decode_serial(rb, cap, carried, *tables)
        seg = baudot_cuda.decode(rb, cap, carried, *tables)
        require(all(torch.equal(a, b) for a, b in zip(flat(seg), flat(ser))),
                f"baudot cap {cap}: the segmented route is not the serial "
                "route's")
        ms = time_cuda(lambda: baudot_cuda.decode(rb, cap, carried, *tables),
                       iters=10, queue_ahead_ms=20.0)
        bound = baudot_bound(torch, nrows, COSTAS_SAMPLES, cap,
                             cycles["baudot"])
        scan_case_line(torch, "baudot_scan", BAUDOT_SOURCE, replaces_baudot,
                       ms, bound, 1, check=f"the Baudot decoder against "
                       f"decode_plain on the card (chars, count, state) and "
                       f"the serial route, cap {cap}; rows: baudot_cases "
                       f"(not on a gated path)",
                       shape={"rows": nrows, "symbols": COSTAS_SAMPLES,
                              "cap": cap},
                       beats_chain_by=bound["serial_chain_ms"] / ms, **got)
    # n of 1 and a ragged tail; rows of 1001 (the CLI's tail) start off
    # 16-byte alignment, so the threads load them (no bulk copy)
    for n in (1, 33, 1001):
        r = torch.from_numpy(np.ascontiguousarray(rows[:, :n])).to(dev)
        for cap in (n // 7 + 4, 2):
            got = baudot_cuda.decode(r, cap, carried, *tables)
            want = baudot_cuda.decode_plain(r, cap, carried, *tables)
            ser = baudot_cuda.decode_serial(r, cap, carried, *tables)
            require(all(torch.equal(a, b) and torch.equal(a, c) for a, b, c
                        in zip(flat(got), flat(want), flat(ser))),
                    f"baudot n {n} cap {cap}: not decode_plain's bits")
    emit("kernels", name="baudot_scan", check="n of 1, 33 and 1001 (rows "
         "off 16-byte alignment, loaded by the threads) x 12 rows of "
         "baudot_cases at two caps: kernel, serial route and decode_plain "
         "on the card, bit for bit")

    # the CLI's shape: one 65 536-sample chunk, kernel on the card against
    # the plain version on the CPU host (the table's rows)
    out_rows = []
    alpha, beta = sync.pll_loop_params(0.01)
    x = torch.from_numpy(tone[:X_CHUNK])
    xd = x.to(dev)
    st = tuple(torch.zeros((), device=dev) for _ in range(3))
    got = carrier_cuda.pll(xd, alpha, beta, st)
    want, plain_ms = host_once(lambda: carrier_cuda.pll(x, alpha, beta))
    torch.cuda.synchronize()
    dph = scan_compare(got[0].cpu().numpy(), want[0].numpy())
    nco = scan_compare(got[1].cpu().numpy(), want[1].numpy())
    require(min(dph["snr_db_min"], nco["snr_db_min"]) >= SWEEP_BAR,
            f"pll at the CLI's chunk: card against the CPU {dph}, {nco}")
    ms = time_cuda(lambda: carrier_cuda.pll(xd, alpha, beta, st), iters=10,
                   queue_ahead_ms=20.0)
    nbytes, flops = X_CHUNK * 20 + 24, X_CHUNK * PLL_FLOPS
    bound = scan_bound(torch, X_CHUNK, 1, cycles["PI"], nbytes, flops)
    row = {"name": "pll_scan", "route": "cuda", "source": CARRIER_SOURCE,
           "replaces": replaces_pll, "path": "X' pll_cc",
           "shape": {"rows": 1, "samples": X_CHUNK, "controller": "PI",
                     "command": " ".join(PLL_CLI)},
           "max_abs_err": float(max(
               np.max(np.abs(got[0].cpu().numpy() - want[0].numpy())),
               np.max(np.abs(got[1].cpu().numpy() - want[1].numpy())))),
           "card_vs_cpu": {"dphase": dph, "nco": nco, "bar_db": SWEEP_BAR},
           "ms": ms, "plain_ms": plain_ms, "plain_on": "cpu",
           "library_ms": None, "cycles_a_sample": ms * 1e-3 * SM_CLOCK_HZ
           / X_CHUNK, **bound}
    row["share_of_bound"] = row["bound_ms"] / ms
    row.update(roofline_row(torch, "pll_scan",
                            lambda v, s: carrier_cuda.pll(v, alpha, beta,
                                                          s)[0],
                            xd, st, nbytes, flops, ms,
                            ops_s=bound["chain_ms"] / 1e3))
    emit("kernels", **row)
    out_rows.append(row)

    s = torch.from_numpy(sym[:X_CHUNK])
    sd = s.to(dev)
    cap = X_CHUNK // 7 + 4
    zero = baudot_cuda.zero_state((), dev)
    n0 = baudot_cuda.LAUNCHES["baudot_scan"]
    got = baudot_cuda.decode(sd, cap, zero, *tables)
    require(baudot_cuda.LAUNCHES["baudot_scan"] == n0 + 1,
            "baudot at the CLI's chunk: not one launch")
    want, plain_ms = host_once(lambda: baudot_cuda.decode(
        s, cap, baudot_cuda.zero_state((), "cpu"),
        *digital._baudot_tables(torch.device("cpu"))))
    ser = baudot_cuda.decode_serial(sd, cap, zero, *tables)
    torch.cuda.synchronize()
    same = [torch.equal(a.cpu(), b) for a, b in zip(got[:2] + got[2],
                                                    want[:2] + want[2])]
    require(all(same), f"baudot at the CLI's chunk: card against the CPU "
                       f"(chars, count, state): {same}")
    require(all(torch.equal(a, b) for a, b in zip(got[:2] + got[2],
                                                  ser[:2] + ser[2])),
            "baudot at the CLI's chunk: the segmented route is not the "
            "serial route's")
    ms = time_cuda(lambda: baudot_cuda.decode(sd, cap, zero, *tables),
                   iters=10, queue_ahead_ms=20.0)
    serial_ms = time_cuda(lambda: baudot_cuda.decode_serial(sd, cap, zero,
                                                            *tables),
                          iters=3, queue_ahead_ms=20.0)
    empty_ms = time_cuda(baudot_cuda.empty_launch, iters=10,
                         queue_ahead_ms=20.0)
    z1 = tuple(t.reshape(1) for t in zero)
    phases = baudot_cuda.phase_cycles(sd[None], cap, z1, *tables)
    # 134 rows of the chunk (past the 132 SMs: rows in turns), segmented
    # against serial, bit for bit
    big = torch.from_numpy(np.stack([rtty_symbols(X_CHUNK, 300 + r)
                                     for r in range(134)])).to(dev)
    zb = baudot_cuda.zero_state((134,), dev)
    seg = baudot_cuda.decode(big, cap, zb, *tables)
    ser = baudot_cuda.decode_serial(big, cap, zb, *tables)
    require(all(torch.equal(a, b) for a, b in zip(seg[:2] + seg[2],
                                                  ser[:2] + ser[2])),
            "baudot at 134 x 65 536: the segmented route is not the serial "
            "route's")
    big_ms = time_cuda(lambda: baudot_cuda.decode(big, cap, zb, *tables),
                       iters=10, queue_ahead_ms=20.0)
    emit("kernels", name="baudot_scan", check="134 rows x 65 536 symbols "
         "(rows in turns past the SMs): the segmented route bit for bit the "
         "serial route's", ms=big_ms, chars=int(seg[1].sum()),
         **baudot_bound(torch, 134, X_CHUNK, cap, cycles["baudot"]))
    bound = baudot_bound(torch, 1, X_CHUNK, cap, cycles["baudot"])
    nbytes = bound["bytes"]
    row = {"name": "baudot_scan", "route": "cuda", "source": BAUDOT_SOURCE,
           "replaces": replaces_baudot, "path": "X' rtty",
           "shape": {"rows": 1, "symbols": X_CHUNK, "cap": cap,
                     "chars": int(got[1]), "command": RTTY_CLI[0],
                     "threads": baudot_cuda.plan(X_CHUNK),
                     "segment": baudot_cuda.SEGMENT},
           "bit_exact": True, "max_abs_err": 0.0, "ms": ms,
           "plain_ms": plain_ms, "plain_on": "cpu", "library_ms": None,
           "serial_route_ms": serial_ms, "empty_ms": empty_ms,
           "beats_chain_by": bound["serial_chain_ms"] / ms,
           "phase_cycles": phases,
           "cycles_a_symbol": ms * 1e-3 * SM_CLOCK_HZ / X_CHUNK, **bound}
    row["share_of_bound"] = row["bound_ms"] / ms
    row.update(roofline_row(torch, "baudot_scan",
                            lambda v, z: baudot_cuda.decode(v, cap, z,
                                                            *tables)[0],
                            sd, zero, nbytes, 0, ms,
                            ops_s=bound["bound_ms"] / 1e3))
    emit("kernels", **row)
    out_rows.append(row)
    return out_rows


# ---------------------------------------------------------------------------
# BASELINE config 5 whole: the channelizer and the BPSK31 modem bank (G, G')
# ---------------------------------------------------------------------------

def bank_plan():
    """64 channel rates: 56 drawn as bench.py's flagship draws them, and 8
    channels (every 8th) tuned to the centres of 8 BPSK31 transmissions,
    0.1 apart.  Returns (rates, BPSK channel indexes, centres)."""
    rates = np.empty(CHANNELS)
    bpsk = np.arange(BPSK_CHANNELS) * (CHANNELS // BPSK_CHANNELS)
    centres = np.linspace(-0.35, 0.35, BPSK_CHANNELS)
    rates[bpsk] = -centres
    rates[np.setdiff1d(np.arange(CHANNELS), bpsk)] = \
        np.random.default_rng(3).uniform(-0.35, 0.35,
                                         CHANNELS - BPSK_CHANNELS)
    return rates, bpsk, centres


def bank_input(torch, decim: int, n: int, centres, seed: int):
    """The wideband stream on the card: each centre carries a BPSK31
    transmission (tx_chain at SPS*decim samples a symbol, mixed there by
    a float64 phase), plus complex noise of BANK_NOISE per part.  Returns
    (TX bits per transmission, x (n,) complex64)."""
    from csdr_tpu_torch.core.cplx import expj
    from csdr_tpu_torch.models import bpsk31

    dev = torch.device("cuda")
    k = torch.arange(n, dtype=torch.float64, device=dev)
    x = torch.zeros(n, dtype=torch.complex64, device=dev)
    tx_bits = []
    for i, f in enumerate(centres):
        text = f"CHANNEL {i} DE CSDR_TPU_TORCH PSE K ".encode()
        while True:
            bits, bb = bpsk31.tx_chain(text, SPS * decim, device=dev)
            if bb.shape[0] >= n:
                break
            text *= 2
        tx_bits.append(bits)
        turn = expj(2 * np.pi * torch.remainder(f * k, 1.0))
        x += bb[:n] * turn.to(torch.complex64)
        del bb, turn
    gen = torch.Generator(device=dev).manual_seed(seed)
    x += BANK_NOISE * torch.complex(
        torch.randn(n, device=dev, generator=gen),
        torch.randn(n, device=dev, generator=gen))
    return tx_bits, x


def bank_floor_db(ref: np.ndarray, test: np.ndarray) -> float:
    """The least, over channels, of the bank's mean channel power over the
    channel's error power, dB."""
    err = np.mean(np.abs(ref - test) ** 2, axis=1)
    mean = np.mean(np.abs(ref) ** 2)
    return float("inf") if not err.max() else float(
        10 * np.log10(mean / err.max()))


def bank_bits(outs, c: int) -> np.ndarray:
    """Channel c's valid bits over every chunk, on the host."""
    return np.concatenate([b[c, :int(k[c])].cpu().numpy() for b, k in outs])


def drive_bank(torch, step, state, xs):
    """``step`` (the bank's, or its modem) from ``state`` over the chunks
    ``xs``: per chunk (bits, counts), synchronised."""
    outs = []
    for x in xs:
        state, out = step(state, x)
        outs.append(out)
    if xs[0].is_cuda:
        torch.cuda.synchronize()
    return outs


def profile_call(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler: its launches, the kernels
    the card ran and their time (the union of their intervals), the five
    kernels of most device time (ms, summed by name), the host syncs
    (aten::_local_scalar_dense, a read of a CPU host flag included) and of
    them the card syncs (those that copy from the card: a cudaMemcpy or
    cudaStreamSynchronize call inside them on the same thread)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    names = [e.name for e in events]
    dev_events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    by_name: dict = {}
    for e in dev_events:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    copies = [e for e in events if e.name.startswith(
        ("cudaMemcpy", "cudaStreamSynchronize"))]
    reads = [e for e in events if e.name == "aten::_local_scalar_dense"]
    card_syncs = sum(1 for e in reads if any(
        c.thread == e.thread and e.time_range.start <= c.time_range.start
        and c.time_range.end <= e.time_range.end for c in copies))
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {"cuda_launch_calls": sum(1 for n in names if n.startswith((
                "cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchCooperativeKernel", "cuLaunchCooperativeKernel"))),
            "device_kernels": len(spans), "device_ms": busy / 1e3,
            "top_kernels_ms": dict(sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:5]),
            "host_syncs": len(reads), "card_syncs": card_syncs}


def bank_cost(torch, bank, step, state, x) -> dict:
    """Step time as issued (CUDA events around back-to-back steps) and
    queued behind a spin kernel (the device's own time), the split of
    steps between channelizer and modem (events between the two halves,
    as issued), and from torch.profiler the kernels of one step and of its
    modem alone, their busy time, launches and host syncs."""
    from csdr_tpu_torch.utils.timing import time_cuda

    box = {"state": state}

    def one_step():
        box["state"], out = step(box["state"], x)
        return out

    with torch.no_grad():
        step_ms = time_cuda(one_step, iters=3, warmup=1, repeats=3)
        queued_ms = time_cuda(one_step, iters=10, warmup=1, repeats=5,
                              queue_ahead_ms=100.0)
        split = []
        for _ in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            y = bank.channelize(x)
            ev[1].record()
            box["state"], _ = bank.modem(box["state"], y)
            ev[2].record()
            ev[2].synchronize()
            split.append((ev[0].elapsed_time(ev[1]),
                          ev[1].elapsed_time(ev[2])))
        chan_ms, modem_ms = (float(np.median(v)) for v in zip(*split))
        whole = profile_call(torch, one_step)
        modem = profile_call(torch, lambda: bank.modem(box["state"], y))
    return {"chunk": int(x.shape[0]), "step_ms": step_ms,
            "msps": x.shape[0] / step_ms / 1e3,
            "device_ms": whole["device_ms"],
            "device_busy_share": whole["device_ms"] / step_ms,
            "queued_device_ms": queued_ms,
            "queued_busy_share": queued_ms / step_ms,
            "channelizer_ms": chan_ms, "modem_ms": modem_ms,
            "modem_share_of_step": modem_ms / (chan_ms + modem_ms),
            "step_profile": whole, "modem_profile": modem}


def bank_path(torch, key, decim, frames, chunks, kernel):
    """One bank path on the card: launches, BER on the BPSK31 channels,
    channel streams and bits card vs CPU, and the modem bit for bit on
    the CPU's channel streams."""
    from csdr_tpu_torch.models import bpsk31, multichannel

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    rates, bpsk, centres = bank_plan()
    init, step, meta = multichannel.build_ddc_bpsk31_bank(
        rates, decim, SPS, device=dev)
    bank = meta["bank"]
    chunk = frames * meta["input_size"]
    tx_bits, x = bank_input(torch, decim, chunks * chunk, centres, 40 + decim)
    xs = [x[c * chunk:(c + 1) * chunk] for c in range(chunks)]
    reset_all()
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = drive_bank(torch, step, init(chunk), xs)
    wall = time.perf_counter() - t0
    launches = launches_all()
    require_launches(launches, {kernel: chunks, "ted_scan": chunks},
                     f"path {key}")
    with torch.no_grad():
        lint_step(torch, key, bank.step, init(chunk), xs[0])

    bers = {}
    for i, c in enumerate(bpsk):
        errs, total = bpsk31.align_errors(tx_bits[i][8:],
                                          bank_bits(outs, c)[8:],
                                          range(-6, 6))
        bers[int(c)] = errs / total
        require(total > 200 and errs / total < BER_BAR,
                f"path {key}: channel {c} BER {errs}/{total}")

    # the same bank on the CPU: channel streams, modem and bits
    cinit, cstep, cmeta = multichannel.build_ddc_bpsk31_bank(
        rates, decim, SPS, device=cpu)
    cbank = cmeta["bank"]
    xs_cpu = [v.cpu() for v in xs]
    with torch.no_grad():
        y_cpu = [cbank.channelize(v) for v in xs_cpu]
        y_card = [bank.channelize(v) for v in xs]
    # channels carrying a transmission at CHANNEL_BAR each; every channel
    # at CHANNEL_BAR against the bank's mean channel power: the channels
    # holding only the noise sit ~50 dB below the carriers, under the
    # float32 rounding floor of the wideband FFT (csdr_tpu against the
    # port on the CPU reads them at ~92-99 dB too)
    snr = min(require_match(f"path_{key}: card vs CPU channel streams",
                            b[bpsk].cpu().numpy(), a[bpsk].numpy(),
                            CHANNEL_BAR, frame=meta["group_out"])
              for a, b in zip(y_cpu, y_card))
    floor = min(float(np.min(channel_snrs(a.numpy(), b.cpu().numpy())))
                for a, b in zip(y_cpu, y_card))
    vs_mean = min(bank_floor_db(a.numpy(), b.cpu().numpy())
                  for a, b in zip(y_cpu, y_card))
    require(vs_mean >= CHANNEL_BAR, f"path {key}: card vs CPU channel "
            f"streams {vs_mean:.1f} dB against the mean channel power")
    m = y_cpu[0].shape[-1]
    with torch.no_grad():
        outs_cpu = drive_bank(torch, cbank.modem, cinit(chunk), y_cpu)
        outs_mix = drive_bank(torch, bank.modem, init(chunk),
                              [v.to(dev) for v in y_cpu])
    for (bc, kc), (bm, km) in zip(outs_cpu, outs_mix):
        require(torch.equal(kc, km.cpu()) and torch.equal(bc, bm.cpu()),
                f"path {key}: the card's modem on the CPU's channel streams "
                "differs from the CPU's in bits or counts")
    ted_cpu, ted_card = bank.tr.init(cpu, CHANNELS), bank.tr.init(dev,
                                                                  CHANNELS)
    with torch.no_grad():
        for v in y_cpu:
            ted_cpu, sc = cbank.tr(ted_cpu, v)
            ted_card, sk = bank.tr(ted_card, v.to(dev))
            require(torch.equal(sc.count, sk.count.cpu())
                    and torch.equal(sc.data, sk.data.cpu()),
                    f"path {key}: TED symbols card vs CPU differ")
    slips = [bpsk31.align_errors(bank_bits(outs_cpu, c),
                                 bank_bits(outs, c), range(-6, 6))[0]
             for c in range(CHANNELS)]
    worst_bpsk = max(slips[c] for c in bpsk)
    require(max(slips) <= BANK_SLIP_BAR,
            f"path {key}: card vs CPU bits {max(slips)} errors on channel "
            f"{int(np.argmax(slips))}")
    emit("path", path=key, pipeline=f"build_ddc_bpsk31_bank(64 rates, "
         f"decimation={decim}, sps={SPS})", chunks=chunks, chunk=chunk,
         channel_samples_per_chunk=m, launches=launches, ber=bers,
         ber_bar=BER_BAR, bits_per_bpsk_channel=int(min(
             len(bank_bits(outs, c)) for c in bpsk)),
         card_vs_cpu_bpsk_channel_min_snr_db=snr,
         card_vs_cpu_any_channel_min_snr_db=floor,
         card_vs_cpu_vs_mean_channel_power_min_db=vs_mean,
         card_modem_on_cpu_streams="bits, counts and TED symbols equal",
         card_vs_cpu_bit_errors_bpsk_channels_max=int(worst_bpsk),
         card_vs_cpu_bit_errors_other_channels_max=int(max(
             slips[c] for c in range(CHANNELS) if c not in set(bpsk))),
         stream_s=wall)
    # what the mesh paths (M, M') are held against: the first MESH_CHUNKS
    # chunks' input, bits and counts, and channel streams card and CPU
    mesh_ref = {"x": x[:MESH_CHUNKS * chunk].cpu().numpy(),
                "tx_bits": tx_bits,
                "outs": [(b.cpu().numpy(), k.cpu().numpy())
                         for b, k in outs[:MESH_CHUNKS]],
                "y_card": [v.cpu().numpy() for v in y_card[:MESH_CHUNKS]],
                "y_cpu": [v.numpy() for v in y_cpu[:MESH_CHUNKS]]}
    return {"launches": launches, "bank": bank, "step": step, "init": init,
            "xs": xs, "y_cpu": y_cpu, "y_card0": y_card[0].cpu().numpy(),
            "bpsk": bpsk, "wall": wall, "chunk": chunk, "mesh_ref": mesh_ref}


def costas_case(torch, g) -> float:
    """The Costas kernel against costas_plain on the card on COSTAS_SAMPLES
    samples of G's 8 BPSK31 channel streams, in both error modes (and the
    reset-to-zero form of the clamp): bit for bit, or each output's first
    differing sample and least SNR at csdr_tpu's bars (COSTAS_BARS); each
    with its time beside its chain bound.  Returns the probe's SM cycles
    a sample of the chain in the mode G_c runs (not decision-directed)."""
    from csdr_tpu_torch.kernels import carrier_cuda
    from csdr_tpu_torch.models import multichannel
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    _, bpsk, _ = bank_plan()
    params = multichannel.build_ddc_bpsk31_bank(
        bank_plan()[0][bpsk], 50, SPS, use_costas=True,
        device=dev)[2]["bank"].costas
    y = g["y_cpu"][0][bpsk, :COSTAS_SAMPLES].contiguous().to(dev)
    cycles = {}
    for dd, reset in ((False, False), (True, False), (False, True)):
        mode = ("decision_directed" if dd else "pi_yre_yim") + (
            ", reset" if reset else "")
        probe_in = y[0, :carrier_cuda.PROBE_MAX]
        c = min(carrier_cuda.costas_cycles(probe_in, *params, dd, reset)
                for _ in range(3))
        cycles[(dd, reset)] = c
        require(c > 20.0, f"costas chain probe ({mode}): {c} cycles")
        emit("kernels", name="costas_chain_probe", mode=mode,
             check="SM cycles a sample of the Costas loop's shortest chain "
             "(one sin/cos range reduction, the rotation, the error, the "
             "loop filter, the clamp and the wraps as an add and a select "
             "of the step's picks) on one thread from shared memory, its "
             "last state "
             "the kernel's (csrc/carrier.cu), the loop's bound",
             cycles_a_sample=c, samples=carrier_cuda.PROBE_MAX)
        n0 = carrier_cuda.LAUNCHES["costas_scan"]
        got = card_vs_plain(
            torch, f"costas {mode}",
            lambda: carrier_cuda.costas(y, *params, dd, reset)[:3],
            lambda: carrier_cuda.costas_plain(y, *params, dd, reset)[:3],
            ("y", "error", "dphase"), COSTAS_BARS[1], COSTAS_BARS[0])
        require(carrier_cuda.LAUNCHES["costas_scan"] == n0 + 1,
                f"costas {mode}: not one launch")
        ms = time_cuda(lambda: carrier_cuda.costas(y, *params, dd, reset),
                       iters=10, queue_ahead_ms=20.0)
        rows = len(bpsk)
        scan_case_line(
            torch, "costas_scan", CARRIER_SOURCE,
            "csdr_tpu/ops/sync.py:142 (lax.scan; no Pallas kernel)", ms,
            scan_bound(torch, COSTAS_SAMPLES, rows, c,
                       rows * COSTAS_SAMPLES * 24 + rows * 24,
                       rows * COSTAS_SAMPLES * COSTAS_FLOPS), 1,
            check=f"the Costas loop ({mode}) against costas_plain on the "
            f"card, on G's 8 BPSK31 channel streams (not on a gated path)",
            shape={"rows": rows, "samples": COSTAS_SAMPLES}, **got)
    return cycles[(False, False)]


def bank_costas_path(torch, g, cycles: float) -> dict:
    """Path G_c: BASELINE config 5 as BASELINE.md names it ("Costas/
    Gardner"), build_ddc_bpsk31_bank(64 rates, 50, sps=256,
    use_costas=True) at full width on G's input, 3 chunks of 3200 frames
    (64 rows x 57 344 channel samples a chunk), captured (the step it
    returns) and eager (``meta["bank"].step``) from one state: every output,
    count and state leaf bit for bit; one Costas launch (and K3 forward
    and the TED's) a chunk; BER < BER_BAR on every BPSK31 channel; the
    card's bits within BANK_SLIP_BAR errors a BPSK31 channel of the CPU
    bank's over the first 2 chunks (the Costas loop locks to a
    transmission, not to noise: on the other channels card and CPU part,
    reported); the Costas kernel against costas_plain on the card on the
    first COSTAS_SAMPLES of the first chunk's card channel streams, all 64
    rows, bit for bit; the kernel on the first chunk's CPU channel streams
    against costas_plain on the CPU host at COSTAS_BARS on the BPSK31
    channels and |y| = |x| on every channel (a rotation), with its time,
    the plain version's and its chain bound (the table's row); the eager
    step's lint; each step's cost.  Returns the row."""
    from csdr_tpu_torch.kernels import carrier_cuda
    from csdr_tpu_torch.models import bpsk31, multichannel
    from csdr_tpu_torch.utils.timing import time_cuda

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    rates, bpsk, _ = bank_plan()
    init, step, meta = multichannel.build_ddc_bpsk31_bank(
        rates, 50, SPS, use_costas=True, device=dev)
    bank = meta["bank"]
    xs, chunk = g["xs"], g["chunk"]
    tx_bits = g["mesh_ref"]["tx_bits"]
    with torch.no_grad():
        reset_all()
        t0 = time.perf_counter()
        state, outs = init(chunk), []
        for x in xs:
            state, out = step(state, x)
            outs.append(out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_all()
        final = [t.clone() for t in state]
        state_e, outs_e = init(chunk), []
        for x in xs:
            state_e, out = bank.step(state_e, x)
            outs_e.append(out)
        torch.cuda.synchronize()
    require_launches(launches, {"fft_ko": CHUNKS_G, "ted_scan": CHUNKS_G,
                                "costas_scan": CHUNKS_G}, "path G_c")
    require(all(same_tree(torch, a, b) for a, b in zip(outs, outs_e))
            and same_tree(torch, final, list(state_e)),
            "path G_c: the captured step differs from the eager step")
    require(len(final) == 7, f"path G_c: {len(final)} state leaves")
    with torch.no_grad():
        lint_step(torch, "G_c", bank.step, init(chunk), xs[0])

    bers = {}
    for i, c in enumerate(bpsk):
        errs, total = bpsk31.align_errors(tx_bits[i][8:],
                                          bank_bits(outs, c)[8:],
                                          range(-6, 6))
        bers[int(c)] = errs / total
        require(total > 200 and errs / total < BER_BAR,
                f"path G_c: channel {c} BER {errs}/{total}")

    # the CPU bank over the first 2 chunks: bits
    cinit, _, cmeta = multichannel.build_ddc_bpsk31_bank(
        rates, 50, SPS, use_costas=True, device=cpu)
    cbank = cmeta["bank"]
    y_cpu = g["y_cpu"][:2]
    with torch.no_grad():
        outs_cpu = drive_bank(torch, cbank.modem, cinit(chunk), y_cpu)
    slips = [bpsk31.align_errors(bank_bits(outs_cpu, c),
                                 bank_bits(outs[:2], c), range(-6, 6))[0]
             for c in range(CHANNELS)]
    worst = max(slips[c] for c in bpsk)
    require(worst <= BANK_SLIP_BAR, f"path G_c: card vs CPU bits {worst} "
                                    f"errors on a BPSK31 channel")

    # the Costas kernel against costas_plain on the card on the first
    # COSTAS_SAMPLES of the first chunk's card channel streams, every row
    # (the ones the loop locks to and the noise rows), bit for bit
    params = bank.costas
    st = tuple(torch.zeros(CHANNELS, device=dev) for _ in range(3))
    head = torch.from_numpy(np.ascontiguousarray(
        g["y_card0"][:, :COSTAS_SAMPLES])).to(dev)
    with torch.no_grad():
        every_row = card_vs_plain(
            torch, "path_G_c costas, every row",
            lambda: carrier_cuda.costas(head, *params, state=st)[:3],
            lambda: carrier_cuda.costas_plain(head, *params, state=st)[:3],
            ("y", "error", "dphase"), COSTAS_BARS[1], COSTAS_BARS[0])
    require(every_row["bit_for_bit"], f"path G_c: the Costas kernel differs "
            f"from costas_plain on the card: {every_row['card_vs_plain']}")
    # ... and on the first chunk's CPU channel streams against costas_plain
    # on the CPU host
    y0 = y_cpu[0]
    y0d = y0.to(dev)
    with torch.no_grad():
        card = carrier_cuda.costas(y0d, *params, state=st)[0].cpu().numpy()
        want, plain_ms = host_once(lambda: carrier_cuda.costas(y0, *params))
    cpu_y = want[0].numpy()
    early = channel_snrs(cpu_y[bpsk, :256], card[bpsk, :256])
    whole = channel_snrs(cpu_y[bpsk], card[bpsk])
    if min(early) < COSTAS_BARS[0] or min(whole) < COSTAS_BARS[1]:
        require_match("path_G_c_costas: BPSK31 channels, first 256",
                      card[bpsk, :256], cpu_y[bpsk, :256], COSTAS_BARS[0])
        require_match("path_G_c_costas: BPSK31 channels, whole", card[bpsk],
                      cpu_y[bpsk], COSTAS_BARS[1])
    x0 = y0.numpy()
    rotation = bool(np.allclose(np.abs(card), np.abs(x0), rtol=1e-5,
                                atol=1e-7))
    require(rotation, "path G_c: the Costas kernel's |y| differs from |x|")
    every = channel_snrs(cpu_y, card)
    with torch.no_grad():
        ms = time_cuda(lambda: carrier_cuda.costas(y0d, *params, state=st),
                       iters=5, queue_ahead_ms=20.0)
    m = y0.shape[-1]
    nbytes = CHANNELS * m * 24 + CHANNELS * 24
    flops = CHANNELS * m * COSTAS_FLOPS
    bound = scan_bound(torch, m, CHANNELS, cycles, nbytes, flops)
    row = {"name": "costas_scan", "route": "cuda", "source": CARRIER_SOURCE,
           "replaces": "csdr_tpu/ops/sync.py:142 (lax.scan; no Pallas "
                       "kernel)", "path": "G_c",
           "shape": {"rows": CHANNELS, "samples": m,
                     "mode": "pi_yre_yim", "costas_bw": 2 * np.pi / 100},
           "max_abs_err": 0.0,         # every row bit for bit (required)
           "max_abs_err_vs_cpu_bpsk": float(np.max(np.abs(
               card[bpsk] - cpu_y[bpsk]))),
           "card_vs_plain_every_row": {
               "rows": CHANNELS, "samples": COSTAS_SAMPLES,
               "stream": "the first chunk's card channel streams",
               "plain_ms": every_row["plain_ms"],
               **every_row["card_vs_plain"]},
           "card_vs_cpu": {
               "bpsk_first_256_min_snr_db": float(min(early)),
               "bpsk_whole_min_snr_db": float(min(whole)),
               "bars_db": list(COSTAS_BARS),
               "every_channel_abs_y_equals_abs_x": rotation,
               "other_channels_min_snr_db": float(np.min(np.delete(
                   every, bpsk))),
               "other_channels_below_bar": int(np.sum(np.delete(
                   every, bpsk) < COSTAS_BARS[1])),
               "note": "max_abs_err_vs_cpu_bpsk over the BPSK31 channels; "
                       "the loop does not lock to noise, so off them card "
                       "and CPU "
                       "part (their SNRs here, not gated; on the card "
                       "the kernel is costas_plain bit for bit on every "
                       "row, card_vs_plain_every_row)"},
           "ms": ms, "plain_ms": plain_ms, "plain_on": "cpu",
           "library_ms": None,
           "cycles_a_sample": ms * 1e-3 * SM_CLOCK_HZ / m, **bound}
    row["share_of_bound"] = row["bound_ms"] / ms
    row.update(roofline_row(
        torch, "costas_scan",
        lambda v, s: carrier_cuda.costas(v, *params, state=s)[0], y0d, st,
        nbytes, flops, ms, ops_s=bound["chain_ms"] / 1e3))
    emit("kernels", **row)
    emit("path", path="G_c", pipeline="build_ddc_bpsk31_bank(64 rates, "
         f"decimation=50, sps={SPS}, use_costas=True) (BASELINE config 5, "
         "Costas/Gardner)", chunks=len(xs), chunk=chunk,
         channel_samples_per_chunk=m, launches=launches, ber=bers,
         ber_bar=BER_BAR, bits_per_bpsk_channel=int(min(
             len(bank_bits(outs, c)) for c in bpsk)),
         captured_vs_eager="outputs, counts and state bit for bit",
         card_vs_cpu_bit_errors_bpsk_channels_max=int(worst),
         card_vs_cpu_bit_errors_other_channels_max=int(max(
             slips[c] for c in range(CHANNELS) if c not in set(bpsk))),
         cpu_chunks=len(y_cpu), stream_s=wall,
         estimate_uncaptured_python_loop_s="13-25 a chunk (~1.15 M launches "
         "at 11.5-22 us, not run)")
    for key, fn in (("G_c eager", bank.step), ("G_c", step)):
        cost = bank_cost(torch, bank, fn, init(chunk), xs[0])
        emit("throughput", path=key, pipeline="build_ddc_bpsk31_bank(64 "
             f"rates, decimation=50, sps={SPS}, use_costas=True)"
             + (" eager (meta['bank'].step)" if "eager" in key else
                " captured (the step it returns)"),
             **cost, smi=nvidia_smi_line(),
             note="step_ms: CUDA events around back-to-back steps as "
                  "issued; queued_device_ms: 10 steps queued behind a spin "
                  "kernel, median of 5; channelizer_ms, modem_ms: eager "
                  "halves split by an event; launches and host syncs from "
                  "torch.profiler")
    return dict(row, launches_path=launches)


def phase_bank_paths(torch):
    """Paths G (D=50, K3 forward) and G' (D=16, K4): BASELINE config 5
    whole, then the Costas kernel against its plain version on G's BPSK31
    streams and G_c (config 5 with its Costas loop), and each bank's first
    chunk of channel streams, card and CPU, against float64 (the quiet
    channels).  Returns ({"G": ..., "G'": ...}, G_c's table row)."""
    require_no_tf32(torch)
    g = bank_path(torch, "G", 50, FRAMES_G, CHUNKS_G, "fft_ko")
    cycles = costas_case(torch, g)
    gc_row = bank_costas_path(torch, g, cycles)
    quiet_bank(torch, "G", g)
    del g["y_cpu"], g["y_card0"]
    gp = bank_path(torch, "G'", 16, FRAMES_GP, CHUNKS_GP, "fastddc_inv")
    quiet_bank(torch, "G'", gp)
    del gp["y_cpu"], gp["y_card0"]
    return {"G": g, "G'": gp}, gc_row


def phase_bank_throughput(torch, banks):
    for key, b in banks.items():
        state = b["init"](b["chunk"])
        cost = bank_cost(torch, b["bank"], b["step"], state, b["xs"][0])
        emit("throughput", path=key, pipeline=f"build_ddc_bpsk31_bank("
             f"64 rates, decimation={50 if key == 'G' else 16}, sps={SPS})",
             **cost, stream_msps=len(b["xs"]) * b["chunk"] / b["wall"] / 1e6,
             note="step_ms: CUDA events around back-to-back steps as "
                  "issued; channelizer_ms, modem_ms: medians of 5 steps "
                  "split by an event between the halves; device_ms: the "
                  "union of the kernels' intervals in one profiled step; "
                  "queued_device_ms: 10 steps queued behind a spin kernel, "
                  "median of 5; launches and host syncs from "
                  "torch.profiler")


# ---------------------------------------------------------------------------
# the captured step (core/graph.CapturedStep) against the eager step
# ---------------------------------------------------------------------------

GRAPH_CHUNKS = 6           # chunks of each path through both steps
GRAPH_SAVED_AT = 3         # chunks before the checkpoint the resume starts at
GRAPH_MOVING = -0.123456789    # a WFM shift whose NCO phase moves each chunk
GRAPH_API = {"kernel": ("cudaLaunchKernel", "cuLaunchKernel",
                        "cudaLaunchCooperativeKernel",
                        "cuLaunchCooperativeKernel", "cudaLaunchKernelEx",
                        "cuLaunchKernelEx"),
             "graph": ("cudaGraphLaunch", "cuGraphLaunch"),
             "copy": ("cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")}


def host_api_calls(torch, fn) -> dict:
    """The CUDA API calls (cuda* and cu*) of one call of ``fn`` that put
    work on the card, under torch.profiler: kernel launches, graph
    launches and copies (memsets among them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    calls = {k: sum(1 for n in names if n.startswith(v))
             for k, v in GRAPH_API.items()}
    calls["total"] = sum(calls.values())
    return calls


def host_tree(torch, tree):
    """``tree`` with every tensor copied to the host."""
    from torch.utils import _pytree as pytree
    return pytree.tree_map(lambda v: v.to("cpu", copy=True)
                           if isinstance(v, torch.Tensor) else v, tree)


def same_tree(torch, a, b) -> bool:
    """Two host pytrees bit for bit, NaNs compared by place."""
    from torch.utils import _pytree as pytree
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    if sa != sb:
        return False
    for u, v in zip(la, lb):
        if isinstance(u, torch.Tensor):
            if not (isinstance(v, torch.Tensor) and u.dtype == v.dtype):
                return False
            if u.is_complex():
                u, v = torch.view_as_real(u), torch.view_as_real(v)
            if not same_bits_or_nan(torch, u, v):
                return False
        elif u != v:
            return False
    return True


def graph_paths(torch):
    """(key, label, eager step, captured step, init, chunks on the card)
    for each path of the graph phase."""
    from csdr_tpu_torch.models import multichannel, receivers, wfm

    dev = torch.device("cuda")

    def pipe_path(key, label, pipe, x, chunk):
        pipe = pipe.to(dev)
        xs = [torch.from_numpy(x[c * chunk:(c + 1) * chunk]).to(dev)
              for c in range(GRAPH_CHUNKS)]
        return key, label, pipe, pipe.jit_apply(), lambda: pipe.init(dev), xs

    n = GRAPH_CHUNKS * CHUNK
    yield pipe_path("WFM", "wfm_advanced(shift_rate=-0.2)",
                    wfm.wfm_advanced(shift_rate=SHIFT), fm_tone(n), CHUNK)
    yield pipe_path("WFM moving", f"wfm_advanced(shift_rate={GRAPH_MOVING})",
                    wfm.wfm_advanced(shift_rate=GRAPH_MOVING),
                    fm_tone(n, carrier=-GRAPH_MOVING), CHUNK)
    n = GRAPH_CHUNKS * CHUNK_C
    s = np.arange(n, dtype=np.float64)
    ssb = np.exp(2j * np.pi * np.mod(0.0005 * s, 1.0)).astype(np.complex64)
    yield pipe_path("C", "ssb_receiver(agc_on=False)",
                    receivers.ssb_receiver(0.0, 0.1, 0.05, decimation=50,
                                           agc_on=False), ssb, CHUNK_C)
    yield pipe_path("D", "nfm_receiver(50, 48000, fastagc_block_size="
                    f"{CHUNK_C // 50})", receivers.nfm_receiver(
                        decimation=50, audio_rate=AUDIO_RATE,
                        fastagc_block_size=CHUNK_C // 50),
                    fm_tone(n, carrier=0.0, dev=5_000.0), CHUNK_C)
    yield pipe_path("E", "ssb_receiver(0.0, 0.1, 0.05, decimation=50)",
                    receivers.ssb_receiver(0.0, 0.1, 0.05, decimation=50),
                    ssb, CHUNK_C)
    am = (1.0 + 0.5 * np.sin(2 * np.pi * 1000.0 * s / FS)
          ).astype(np.complex64)
    yield pipe_path("F", "am_receiver()", receivers.am_receiver(), am,
                    CHUNK_C)
    # the byte edge from raw u8 I/Q, a chunk W_CHUNK (W1_CHUNK) samples of
    # two bytes
    yield pipe_path("W", "waterfall: convert_u8_c | fft_cc_block(4096, "
                    "2867) | logaveragepower_block(-70, 4096, 93) | "
                    "fft_exchange_sides_ff | compress_fft_adpcm_rows",
                    waterfall_chain(), np.concatenate(
                        [waterfall_u8(c) for c in range(GRAPH_CHUNKS)]),
                    2 * W_CHUNK)
    yield pipe_path("W1", "config 1: convert_u8_c | wfm_basic() | "
                    "convert_f_s16 | paired_encode_block()", config1_chain(),
                    config1_u8(GRAPH_CHUNKS * W1_CHUNK), 2 * W1_CHUNK)
    rates, _, centres = bank_plan()
    for key, decim, frames in (("G", 50, FRAMES_G), ("G'", 16, FRAMES_GP)):
        init, step, meta = multichannel.build_ddc_bpsk31_bank(
            rates, decim, SPS, device=dev)
        chunk = frames * meta["input_size"]
        _, x = bank_input(torch, decim, GRAPH_CHUNKS * chunk, centres,
                          60 + decim)
        yield (key, f"build_ddc_bpsk31_bank(64 rates, decimation={decim}, "
               f"sps={SPS})", meta["bank"].step, step,
               lambda init=init, chunk=chunk: init(chunk),
               [x[c * chunk:(c + 1) * chunk] for c in range(GRAPH_CHUNKS)])


def graph_run(torch, step, init, xs, captured=None):
    """``step`` over ``xs`` from ``init()``: per chunk the output and the
    state on the host and the launches; with ``captured`` (the step
    itself), also whether each output held on the card is unchanged after
    the next call, and the captures after the first chunk."""
    from torch.utils import _pytree as pytree

    from csdr_tpu_torch.core import checkpoint

    state, rows, held, saved = init(), [], None, None
    for i, x in enumerate(xs):
        before = launches_all()
        t0 = time.perf_counter()
        state, y = step(state, x)
        if i == 0:
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        after = launches_all()
        host_y = host_tree(torch, y)
        rows.append({"y": host_y, "state": host_tree(torch, state),
                     "launches": {k: after[k] - before[k] for k in after}})
        if held is not None:
            rows[-2]["held"] = same_tree(torch, host_tree(torch, held[0]),
                                         held[1])
        held = (y, host_y)
        if i == 0 and captured is not None:
            first = captured.captures
        if i + 1 == GRAPH_SAVED_AT and captured is not None:
            saved = MISMATCH_DIR / "graph_checkpoint.npz"
            saved.parent.mkdir(exist_ok=True)
            checkpoint.save_state(str(saved), state)
            # the structure to load into: the saved state's shapes (W1's
            # carry holds a sample the stream's start did not)
            like = pytree.tree_map(lambda v: torch.empty_like(v)
                                   if isinstance(v, torch.Tensor) else v,
                                   state)
    torch.cuda.synchronize()
    out = {"rows": rows, "first_call_s": first_s}
    if captured is not None:
        out["captures_after_first"] = captured.captures - first
        state = checkpoint.load_state(str(saved), like)
        resumed = []
        for x in xs[GRAPH_SAVED_AT:]:
            state, y = step(state, x)
            resumed.append({"y": host_tree(torch, y),
                            "state": host_tree(torch, state)})
        out["resumed"] = resumed
        saved.unlink()
    return out


def graph_cost(torch, step, init, x) -> dict:
    """Issued step ms (back to back), device-only ms (queued behind a
    spin) and the busy share, the host's calls a step (torch.profiler) and
    dispatch_lint's launching ops a step."""
    from csdr_tpu_torch.utils import dispatch_lint
    from csdr_tpu_torch.utils.timing import time_cuda

    box = {"s": init()}

    def one():
        box["s"], y = step(box["s"], x)
        return y

    issued = time_cuda(one, iters=10, warmup=3, repeats=5)
    device = time_cuda(one, iters=10, warmup=1, repeats=5,
                       queue_ahead_ms=100.0)
    calls = host_api_calls(torch, one)
    trace, (box["s"], _) = dispatch_lint.trace_fn(step, box["s"], x)
    return {"issued_ms": issued, "device_only_ms": device,
            "busy_share": device / issued, "host_api_calls": calls,
            "lint_ops": sum(trace.ops.values()),
            "lint_syncs": len(trace.syncs),
            "lint_uploads": len(trace.uploads)}


def phase_graph(torch):
    """The graph phase: every path's captured step against its eager step
    over GRAPH_CHUNKS chunks from one state, bit for bit in every output,
    count and carried state leaf; at most 2 captures a path (1 after the
    first chunk where the NCO phase moves); each step's launches equal;
    an output held from one call unchanged after the next; a state saved
    through core/checkpoint after GRAPH_SAVED_AT chunks resumed bit for
    bit; then each step's cost, eager beside graph."""
    smi = nvidia_smi_line()
    results = {}
    with torch.no_grad():
        for key, label, eager, captured, init, xs in graph_paths(torch):
            ref = graph_run(torch, eager, init, xs)
            got = graph_run(torch, captured, init, xs, captured)
            for i, (a, b) in enumerate(zip(ref["rows"], got["rows"])):
                require(same_tree(torch, a["y"], b["y"]),
                        f"graph {key}: chunk {i}'s output differs from the "
                        "eager step's")
                require(same_tree(torch, a["state"], b["state"]),
                        f"graph {key}: chunk {i}'s state differs from the "
                        "eager step's")
                require(a["launches"] == b["launches"],
                        f"graph {key}: chunk {i} launched {b['launches']}, "
                        f"the eager step {a['launches']}")
                require(b.get("held", True), f"graph {key}: chunk {i}'s "
                        "output changed under the next call")
            for i, (a, b) in enumerate(zip(ref["rows"][GRAPH_SAVED_AT:],
                                           got["resumed"])):
                require(same_tree(torch, a["y"], b["y"])
                        and same_tree(torch, a["state"], b["state"]),
                        f"graph {key}: resumed from a checkpoint, chunk "
                        f"{GRAPH_SAVED_AT + i} differs from the eager step")
            require(captured.captures <= 2,
                    f"graph {key}: {captured.captures} captures")
            if key == "WFM moving":
                require(got["captures_after_first"] <= 1,
                        f"graph {key}: {got['captures_after_first']} "
                        "captures after the first chunk")
            cost_e = graph_cost(torch, eager, init, xs[1])
            cost_g = graph_cost(torch, captured, init, xs[1])
            require(cost_g["lint_syncs"] == 0 and cost_g["lint_uploads"] == 0,
                    f"graph {key}: the captured step syncs or uploads")
            results[key] = {"eager": cost_e, "graph": cost_g,
                            "captures": captured.captures}
            emit("graph", path=key, pipeline=label, chunks=len(xs),
                 chunk=int(xs[0].shape[0]), bit_for_bit="outputs, counts "
                 "and state leaves, every chunk; checkpoint resume",
                 launches_a_step={k: v for k, v in
                                  got["rows"][-1]["launches"].items() if v},
                 captures=captured.captures, replays=captured.replays,
                 captures_after_first=got["captures_after_first"],
                 first_call_s={"eager": ref["first_call_s"],
                               "graph": got["first_call_s"]},
                 eager=cost_e, graph=cost_g,
                 issued_speedup=cost_e["issued_ms"] / cost_g["issued_ms"],
                 smi=smi, note="issued_ms: CUDA events around 10 steps "
                 "back to back (median of 5); device_only_ms: the same "
                 "queued behind a 100 ms spin; host_api_calls: CUDA "
                 "API calls of one step under torch.profiler; "
                 "lint_ops: dispatch_lint's dispatcher ops a step (the "
                 "graph's replay is not one); first_call_s: host clock of "
                 "the first chunk to a sync (the graph's: its eager warm-up "
                 "and its capture)")
            del eager, captured, xs, ref, got
            torch.cuda.empty_cache()
        for key in SERVER_PATHS:
            results[key] = graph_server(torch, key, smi)
            torch.cuda.empty_cache()
    return results


def graph_server(torch, key: str, smi: str) -> dict:
    """Server path ``key``: ``DdcdServer``'s captured step (``_step``, a
    CapturedStep of ``step``) against an eager twin (``_step = step``),
    each driven through ``_run_chunk`` by drive_server's schedule (the
    claims, the retune, the release and the retune back); every chunk's
    outputs, counts and carried state bit for bit, its launches equal, one
    capture, the row buffers where ``__init__`` put them; then both steps'
    costs and ``_run_chunk``'s host ms."""
    from csdr_tpu_torch.server.ddcd import DdcdServer

    args = SERVER_PATHS[key][0]
    runs = {}
    for mode in ("eager", "graph"):
        srv = DdcdServer(transition_bw=0.05, device="cuda", **args)
        if mode == "eager":
            srv._step = srv.step
        c, d, n = srv.max_channels, srv.decimation, srv.chunk_in
        x = server_input(SERVER_CHUNKS * n, d, 60 + d + c)
        ptrs = [r.data_ptr() for r in srv.rows]
        rows = []

        def each(k, seconds, srv=srv, rows=rows):
            rows.append({"state": host_tree(torch, srv.state),
                         "launches": launches_all(), "s": seconds})

        reset_all()
        outs, _, _ = drive_server(srv, x, server_slots(c), each=each)
        prev = {k: 0 for k in rows[0]["launches"]}
        for r in rows:
            r["launches"], prev = ({k: v - prev[k] for k, v in
                                    r["launches"].items()}, r["launches"])
        require([r.data_ptr() for r in srv.rows] == ptrs,
                f"graph {key} ({mode}): a retune or release moved the rows")
        runs[mode] = {"srv": srv, "x": x, "outs": outs, "rows": rows}
    e, g = runs["eager"], runs["graph"]
    for k in range(SERVER_CHUNKS):
        (de, ce), (dg, cg) = e["outs"][k], g["outs"][k]
        require(np.array_equal(ce, cg) and same_tree(
            torch, torch.from_numpy(de), torch.from_numpy(dg)),
            f"graph {key}: chunk {k}'s output differs from the eager step's")
        require(same_tree(torch, e["rows"][k]["state"], g["rows"][k]["state"]),
                f"graph {key}: chunk {k}'s state differs from the eager "
                "step's")
        require(e["rows"][k]["launches"] == g["rows"][k]["launches"],
                f"graph {key}: chunk {k} launched {g['rows'][k]['launches']}"
                f", the eager step {e['rows'][k]['launches']}")
    step = g["srv"]._step
    replays = step.replays
    require(step.captures == 1 and replays == SERVER_CHUNKS - 1,
            f"graph {key}: {step.captures} captures, {replays} replays")
    xc = e["x"][:e["srv"].chunk_in]
    run_ms = {m: host_ms(lambda m=m: runs[m]["srv"]._run_chunk(xc))
              for m in runs}
    xd = torch.from_numpy(xc).to(e["srv"].device)
    cost_e = graph_cost(torch, e["srv"].step, e["srv"].init, xd)
    cost_g = graph_cost(torch, step, g["srv"].init, xd)
    require(cost_g["lint_syncs"] == 0 and cost_g["lint_uploads"] == 0,
            f"graph {key}: the captured step syncs or uploads")
    require(step.captures == 1, f"graph {key}: a fresh state was captured "
            "again instead of copied in")
    emit("graph", path=key, pipeline=f"DdcdServer {args}",
         chunks=SERVER_CHUNKS, chunk=int(xc.shape[0]),
         bit_for_bit="outputs, counts and state leaves, every chunk, "
         f"through a retune before chunk {RETUNE_AT + 1}, a release before "
         f"{RELEASE_AT + 1} and the retune back before {BACK_AT + 1}",
         rows_storage_unchanged=True,
         rows_bytes=int(sum(r.nbytes for r in g["srv"].rows)),
         launches_a_step={k: v for k, v in
                          g["rows"][-1]["launches"].items() if v},
         captures=step.captures, replays_in_the_run=replays,
         first_call_s={"eager": e["rows"][0]["s"], "graph": g["rows"][0]["s"]},
         eager=cost_e, graph=cost_g,
         issued_speedup=cost_e["issued_ms"] / cost_g["issued_ms"],
         run_chunk_ms={m: v[0] for m, v in run_ms.items()},
         run_chunk_ms_span={m: v[1] for m, v in run_ms.items()},
         smi=smi, note="as the other graph lines; first_call_s: host clock "
         "of the first _run_chunk (rows up, the step, the output down; the "
         "graph's: its eager warm-up and its capture); run_chunk_ms: host "
         "clock of _run_chunk on one chunk (input up, the step, every slot "
         "down), median of 7, span min and max")
    return {"eager": cost_e, "graph": cost_g, "captures": step.captures,
            "run_chunk_ms": run_ms}


# ---------------------------------------------------------------------------
# the sharded banks (paths M, M', M''), one rank a process
# ---------------------------------------------------------------------------

MESH_CHUNKS = 2            # M, M': G's (G''s) first chunks (depth cut from 3)
MESH_TIMED_STEPS = 3       # steps a rank times after the counted run
MESH_COST_ITERS = 5        # steps each cost repeat times back to back
MESH_DDC_ATOL = 2e-4       # sharded vs one shard (tests/test_sharded.py)
WFM_BANK_CHANNELS = 64     # bench_scaling.py's default --channels
WFM_BANK_BARS = (90.0, 5e-3)   # 2x2 vs 1x1, dB and atol (test_sharded.py)
# the bank against itself with K1's plain version in K1's place, per
# channel: dB and atol
WFM_PLAIN_BARS = (100.0, 5e-5)
WFM_D1, WFM_D2 = 10, 5
C64 = 8                    # bytes of a complex64 sample


def rank_info(mesh, info: dict) -> list:
    """Every rank's ``info`` in rank order (an uncounted gather)."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, info)
    return out


def summed_launches(mesh) -> dict:
    """Kernel launches since the last reset, summed over the ranks."""
    per = rank_info(mesh, launches_all())
    return {k: sum(p[k] for p in per) for k in per[0]}


def mesh_startup(mesh) -> list:
    """Each rank's host clock as it reaches its first job (so start-up =
    this minus the parent's clock at the spawn)."""
    return rank_info(mesh, {"first_job_at": time.time()})


def timed_steps(torch, mesh, run, steps: int = MESH_TIMED_STEPS) -> dict:
    """``run()`` ``steps`` times, each between two CUDA events and under
    the host clock to a synchronise: per rank the median event ms, host
    ms, and the collectives' host ms a step (staging included)."""
    from csdr_tpu_torch.utils import collectives
    ev_ms, host_ms = [], []
    collectives.reset_collectives()
    for _ in range(steps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        run()
        b.record()
        b.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(a.elapsed_time(b))
    coll = collectives.read_collectives()["host_ms"]
    return rank_info(mesh, {
        "rank": mesh.coords, "event_ms": float(np.median(ev_ms)),
        "host_ms": float(np.median(host_ms)),
        "collective_host_ms_a_step": {k: v / steps for k, v in coll.items()}})


def counted_run(torch, mesh, run):
    """``run()`` with every kernel count and collective count zeroed just
    before and read just after: (its result, launches summed over the
    ranks, the mesh's collective bytes)."""
    from csdr_tpu_torch.utils import collectives
    reset_all()
    collectives.reset_collectives()
    out = run()
    torch.cuda.synchronize()
    launches = summed_launches(mesh)
    return out, launches, collectives.mesh_total(mesh)


def mesh_cost(torch, mesh, one) -> list:
    """Every rank's cost of a step ``one()``: issued ms (CUDA events around
    MESH_COST_ITERS steps back to back, median of 3), device-only ms (the
    same queued behind a 100 ms spin, as graph_cost) and its busy share,
    the host's CUDA calls a step, and from torch.profiler the rank's own
    kernels in one step (the union of their intervals, its share of the
    issued step, the five of most time).  A host-staged collective waits
    for the card, so on a staged mesh the spin cannot queue past it, and
    only the profiler's share is the device's alone."""
    from csdr_tpu_torch.utils.timing import time_cuda
    issued = time_cuda(one, iters=MESH_COST_ITERS, warmup=1, repeats=3)
    device = time_cuda(one, iters=MESH_COST_ITERS, warmup=0, repeats=3,
                       queue_ahead_ms=100.0)
    prof = profile_call(torch, one)
    return rank_info(mesh, {"issued_ms": issued, "device_only_ms": device,
                            "busy_share": device / issued,
                            "host_api_calls": host_api_calls(torch, one),
                            "profiler_device_ms": prof["device_ms"],
                            "profiler_busy_share": prof["device_ms"]
                            / issued,
                            "top_kernels_ms": prof["top_kernels_ms"]})


def eager_vs_graph(torch, mesh, steps: dict, drive) -> dict:
    """``drive(step, after)`` -> (state, outputs a chunk), appending to
    ``after`` the step's captures after each chunk, for the eager and the
    captured step of ``steps``, each with every count zeroed just before
    and read just after (counted_run): each one's launches, collective
    bytes and outputs, and every rank's outputs and state compared bit for
    bit (a flag a rank)."""
    runs = {}
    for mode, step in steps.items():
        after = []
        (st, outs), launches, nbytes = counted_run(
            torch, mesh, lambda step=step: drive(step, after))
        runs[mode] = {"tree": host_tree(torch, (st, outs)), "outs": outs,
                      "launches": launches, "bytes": nbytes,
                      "captures": after}
    same = rank_info(mesh, same_tree(torch, runs["eager"].pop("tree"),
                                     runs["graph"].pop("tree")))
    return {"runs": runs, "same_by_rank": same}


def graph_fields(pair: dict, graph, costs: dict) -> dict:
    """What a mesh line prints of a step's eager and captured runs, the
    captured step's segments and its captures: after each chunk of the
    compared run, and in all once its costs were taken."""
    return {"eager_vs_graph_bit_for_bit_by_rank": pair["same_by_rank"],
            "segments": sorted(graph.segments),
            "captures_by_chunk": pair["runs"]["graph"]["captures"],
            "captures": graph.captures,
            "launches_eager": pair["runs"]["eager"]["launches"],
            "bytes_eager": pair["runs"]["eager"]["bytes"],
            "cost_by_rank": costs}


def mesh_bank_job(mesh, decim: int, frames: int, x_path: str,
                  flagship: bool) -> dict:
    """One rank of path M (1x1) or M' (2x2) at one decimation, on G's (or
    G''s) first MESH_CHUNKS chunks (``x_path``, saved by the parent): the
    DDC bank (``sharded_ddc``), then, where ``flagship``,
    ``build_ddc_bpsk31_bank(..., mesh=mesh)``, each as the builder gives
    it on the card (captured, parallel/segments) and eagerly, on the same
    chunks in this rank."""
    import torch
    from csdr_tpu_torch.models import multichannel
    from csdr_tpu_torch.ops import fastddc as fd
    from csdr_tpu_torch.parallel import mesh as pm, sharded_ddc

    torch.cuda.reset_peak_memory_stats()
    rates, _, _ = bank_plan()
    ddc = fd.fastddc_init(0.05, decim)
    chunk = frames * ddc.input_size
    x = torch.from_numpy(np.load(x_path))
    xs = [pm.shard_input(x[c * chunk:(c + 1) * chunk], mesh)
          for c in range(MESH_CHUNKS)]
    del x
    where = {"comm": mesh.comm, "mesh": dict(mesh.shape)}
    out = {"decim": decim, "chunk": chunk, **where}
    graph, _ = sharded_ddc.build_ddc_bank_step(mesh, ddc, rates)
    steps = {"eager": sharded_ddc.DdcBankStep(mesh, ddc, rates),
             "graph": graph}

    def drive_ddc(step, after):
        ys = []
        for v in xs:
            ys.append(step(v))
            after.append(getattr(step, "captures", 0))
        return (), ys

    def cost(step, v):
        return lambda: step(v)

    with torch.no_grad():
        pair = eager_vs_graph(torch, mesh, steps, drive_ddc)
        g = pair["runs"]["graph"]
        costs = {m: mesh_cost(torch, mesh, cost(st, xs[0]))
                 for m, st in steps.items()}
        out["ddc"] = {"y": pm.gather_output(g["outs"][0], mesh),
                      "streams": [pm.gather_output(y, mesh)
                                  for y in g["outs"]],
                      "launches": g["launches"], "bytes": g["bytes"],
                      **where, **graph_fields(pair, graph, costs),
                      "ranks": timed_steps(torch, mesh,
                                           lambda: graph(xs[0]))}
    if flagship:
        init, step, meta = multichannel.build_ddc_bpsk31_bank(
            rates, decim, SPS, mesh=mesh)
        bank = meta["bank"]
        steps = {"eager": bank.step, "graph": step}

        def drive(step, after):
            st, outs = init(chunk), []
            for v in xs:
                st, o = step(st, v)
                outs.append(o)
                after.append(getattr(step, "captures", 0))
            return st, outs

        def stepping(step):
            box = {"state": init(chunk)}

            def one():
                box["state"], o = step(box["state"], xs[0])
                return o
            return one

        with torch.no_grad():
            pair = eager_vs_graph(torch, mesh, steps, drive)
            g = pair["runs"]["graph"]
            costs = {m: mesh_cost(torch, mesh, stepping(st))
                     for m, st in steps.items()}
            one = stepping(step)
            ranks = timed_steps(torch, mesh, one)
        out["flagship"] = {
            "outs": [(pm.gather_output(b, mesh, time_sharded=False),
                      pm.gather_output(k, mesh, time_sharded=False))
                     for b, k in g["outs"]],
            "launches": g["launches"], "bytes": g["bytes"], "ranks": ranks,
            "m": bank.samples_per_chunk(chunk), **where,
            **graph_fields(pair, step, costs)}
    out["peak_memory_bytes_by_rank"] = rank_info(
        mesh, torch.cuda.max_memory_allocated())
    return out


def wfm_bank_input(torch, centres, n: int = CHUNK):
    """One 2.4 M-sample chunk: an FM 1 kHz tone on each centre (fm_tone,
    75 kHz for a full-scale tone) plus complex noise of 0.01 a part."""
    x = sum(fm_tone(n, carrier=float(f)).astype(np.complex128)
            for f in centres)
    rng = np.random.default_rng(61)
    x = x + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return torch.from_numpy(x.astype(np.complex64))


@contextlib.contextmanager
def k1_plain():
    """K1's plain version in the kernel's place
    (``fir_cuda.shift_fir_decimate``, what ``sharded_wfm`` calls) inside
    the ``with`` block: the same step on the same shards and halos, with
    the reference FIR."""
    from csdr_tpu_torch.kernels import fir_cuda
    kernel = fir_cuda.shift_fir_decimate
    fir_cuda.shift_fir_decimate = fir_cuda.shift_fir_decimate_plain
    try:
        yield
    finally:
        fir_cuda.shift_fir_decimate = kernel


def wfm_bank_job(mesh) -> dict:
    """One rank of path M'': ``sharded_wfm`` at 64 channels over one 2.4
    M-sample chunk, firdes_lowpass_f(81, 0.05), D1=10, D2=5, as the
    builder gives it on the card (captured) and eagerly, twice each; then
    the eager step with K1's plain version (counted: it must launch no K1,
    not timed)."""
    import torch
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.parallel import mesh as pm, sharded_wfm

    torch.cuda.reset_peak_memory_stats()
    # bank_plan's rates: its 8 BPSK31 channels carry the FM tones here
    rates, _, centres = bank_plan()
    args = (mesh, rates, firdes.firdes_lowpass_f(81, 0.05), WFM_D1, WFM_D2)
    steps = {"eager": sharded_wfm.WfmBankStep(*args),
             "graph": sharded_wfm.build_wfm_bank_step(*args)}
    xl = pm.shard_input(wfm_bank_input(torch, centres), mesh)

    def drive(step, after):
        ys = []
        for _ in range(2):
            ys.append(step(xl))
            after.append(getattr(step, "captures", 0))
        return (), ys

    with torch.no_grad():
        pair = eager_vs_graph(torch, mesh, steps, drive)
        g = pair["runs"]["graph"]
        costs = {m: mesh_cost(torch, mesh, lambda st=st: st(xl))
                 for m, st in steps.items()}
        ranks = timed_steps(torch, mesh, lambda: steps["graph"](xl))
        with k1_plain():
            y_plain, plain_launches, _ = counted_run(
                torch, mesh, lambda: steps["eager"](xl))

    def a_step(counts):          # drive's two calls
        return {k: v // 2 for k, v in counts.items()}

    fields = graph_fields(pair, steps["graph"], costs)
    for k in ("launches_eager", "bytes_eager"):
        fields[k] = a_step(fields[k])
    return {"audio": pm.gather_output(g["outs"][1], mesh),
            "audio_plain": pm.gather_output(y_plain, mesh),
            "launches": a_step(g["launches"]), "bytes": a_step(g["bytes"]),
            "k1_plain_launches": plain_launches,
            "ranks": ranks, "tail_ext": steps["eager"].tail_ext,
            "comm": mesh.comm, "mesh": dict(mesh.shape),
            "peak_memory_bytes_by_rank": rank_info(
                mesh, torch.cuda.max_memory_allocated()), **fields}


def predicted_bytes(kind: str, chan: int, time_: int, **shape) -> dict:
    """The collective bytes a step of a bank must send on a (chan, time)
    mesh: a halo of ``halo`` samples from every time shard but the last
    of each chan row; the WFM bank's fixup, a (2, C_l) float32 pair from
    every rank to its time-1 peers; the flagship's corner turn, each
    rank's (C_l, m/time) streams to its time-1 peers."""
    out = {"halo": chan * (time_ - 1) * shape["halo"] * C64, "fixup": 0,
           "corner_turn": 0, "gather": 0}
    if kind == "wfm":
        out["fixup"] = time_ * (time_ - 1) * 2 * 4 * shape["channels"]
    if kind == "flagship":
        out["corner_turn"] = (time_ - 1) * shape["channels"] * shape["m"] \
            * C64
    return out


GRAPH_FIELDS = ("eager_vs_graph_bit_for_bit_by_rank", "segments",
                "captures_by_chunk", "captures", "cost_by_rank",
                "peak_memory_bytes_by_rank")
# a captured step's segments where the mesh's time axis is > 1: a graph
# between each two collectives (parallel/segments); one, "step", where 1
MESH_SEGMENTS = {"ddc": ["body"], "flagship": ["body", "modem"],
                 "wfm": ["body", "finish"]}


def require_graph(what: str, kind: str, res: dict, time_: int,
                  chunks: int) -> None:
    """The captured step against the eager one in every rank: outputs and
    state bit for bit, the same launches and collective bytes, its
    segments, one capture a segment, none after the first chunk nor while
    its costs were taken."""
    require(all(res["eager_vs_graph_bit_for_bit_by_rank"]),
            f"{what}: the captured step differs from the eager step, by "
            f"rank {res['eager_vs_graph_bit_for_bit_by_rank']}")
    require(res["launches_eager"] == res["launches"]
            and res["bytes_eager"] == res["bytes"],
            f"{what}: the eager step launched {res['launches_eager']}, sent "
            f"{res['bytes_eager']}; the captured one {res['launches']}, "
            f"{res['bytes']}")
    segs = ["step"] if time_ == 1 else MESH_SEGMENTS[kind]
    require(res["segments"] == segs, f"{what}: segments {res['segments']}, "
            f"want {segs}")
    want = [len(segs)] * chunks
    require(res["captures_by_chunk"] == want and res["captures"] == len(segs),
            f"{what}: captures {res['captures_by_chunk']} by chunk, "
            f"{res['captures']} in all, want {want}")


def mesh_line(key: str, pipeline: str, res: dict, wide: int, steps: int,
              startup: list, t_spawn: float, **extra) -> dict:
    """A path's printed line: per rank the event and host ms a step, the
    wideband Msps of the whole mesh (the chunk over the slowest rank's
    host step), the collective bytes a step, the staged collectives' host
    ms, each rank's start-up apart from the steps, and the captured step
    against the eager one (graph_fields)."""
    ranks = res["ranks"]
    slowest = max(r["host_ms"] for r in ranks)
    line = {"path": key, "pipeline": pipeline, "mesh": res["mesh"],
            "comm": res["comm"], "launches": res["launches"],
            "collective_bytes_a_step": {k: v / steps for k, v in
                                        res["bytes"].items()},
            "event_ms_by_rank": [r["event_ms"] for r in ranks],
            "host_ms_by_rank": [r["host_ms"] for r in ranks],
            "wideband_msps_mesh": wide / slowest / 1e3,
            "collective_host_ms_a_step_by_rank": [
                r["collective_host_ms_a_step"] for r in ranks],
            "rank_startup_s": [s["first_job_at"] - t_spawn
                               for s in startup],
            **{k: res[k] for k in GRAPH_FIELDS if k in res}, **extra}
    emit("path", **line)
    return line


def run_mesh_jobs(jobs, chan: int, time_: int, backend: str) -> tuple:
    """The jobs on one spawn of ``chan*time_`` ranks on the card; rank 0's
    results and the parent's clock at the spawn.  A failing rank fails
    the run."""
    import functools
    from csdr_tpu_torch.parallel import mesh as pm
    t_spawn = time.time()
    res = pm.run_mesh(functools.partial(pm.run_jobs,
                                        jobs=[mesh_startup] + jobs),
                      chan, time_, backend=backend, device="cuda")
    return res[0], res[1:], t_spawn


def bits_of(outs, c: int) -> np.ndarray:
    return np.concatenate([b[c, :k[c]] for b, k in outs])


def mesh_flagship_gates(key: str, f: dict, ref_outs, tx_bits, bpsk,
                        slip_bar: int) -> dict:
    """BER < BER_BAR over > 200 bits on every BPSK31 channel, and every
    channel's bits within ``slip_bar`` errors of ``ref_outs`` after
    alignment."""
    from csdr_tpu_torch.models import bpsk31
    bers = {}
    for i, c in enumerate(bpsk):
        errs, total = bpsk31.align_errors(tx_bits[i][8:],
                                          bits_of(f["outs"], c)[8:],
                                          range(-6, 6))
        require(total > 200 and errs / total < BER_BAR,
                f"path {key}: channel {c} BER {errs}/{total}")
        bers[int(c)] = errs / total
    slips = [bpsk31.align_errors(bits_of(ref_outs, c), bits_of(f["outs"], c),
                                 range(-6, 6))[0] for c in range(CHANNELS)]
    require(max(slips) <= slip_bar, f"path {key}: bits {max(slips)} errors "
            f"from the reference on channel {int(np.argmax(slips))}")
    return {"ber": bers, "bits_vs_ref_errors_max": int(max(slips))}


def add_launches(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_mesh_paths(torch, banks) -> dict:
    """Paths M (1x1, NCCL), M' (2x2, gloo: four ranks on the one card,
    collectives staged through the host) and M'' (sharded_wfm at 64
    channels, 1x1 and 2x2): one spawn for the 1x1 jobs and one for the
    2x2 jobs; the kernel library is built in this process before either.
    Returns each path's launches for the kernel table."""
    import functools
    import tempfile

    from csdr_tpu_torch.ops import fastddc as fd

    require_no_tf32(torch)
    cases = ((50, "G", FRAMES_G, "fft_ko"), (16, "G'", FRAMES_GP,
                                             "fastddc_inv"))

    def jobs(flagship16: bool) -> list:
        return [functools.partial(
            mesh_bank_job, decim=d, frames=frames, x_path=f"{tmp}/x{d}.npy",
            flagship=d == 50 or flagship16)
            for d, g, frames, _ in cases] + [wfm_bank_job]

    with tempfile.TemporaryDirectory() as tmp:
        for d, g, _, _ in cases:
            np.save(f"{tmp}/x{d}.npy", banks[g]["mesh_ref"]["x"])
        start1, (m50, m16, w1), t1 = run_mesh_jobs(jobs(True), 1, 1, "nccl")
        start4, (p50, p16, w4), t4 = run_mesh_jobs(jobs(False), 2, 2,
                                                   "gloo")
    _, bpsk, _ = bank_plan()
    launches = {"M": [], "M'": []}

    # M: the 1x1 mesh is paths G and G' bit for bit, its captured step one
    # graph a step
    for res, (d, g, _, kernel) in zip((m50, m16), cases):
        ref, f, b = banks[g]["mesh_ref"], res["flagship"], res["ddc"]
        ov = fd.fastddc_init(0.05, d).overlap_length
        require_graph(f"path M D={d} DDC bank", "ddc", b, 1, MESH_CHUNKS)
        require_graph(f"path M D={d}", "flagship", f, 1, MESH_CHUNKS)
        require(np.array_equal(b["y"], ref["y_card"][0]),
                f"path M D={d}: the 1x1 DDC bank differs from path {g}'s "
                "channelizer")
        for (bits, k), (rb, rk) in zip(f["outs"], ref["outs"]):
            require(np.array_equal(k, rk) and np.array_equal(bits, rb),
                    f"path M D={d}: bits or counts differ from path {g}'s")
        for st, rs in zip(b["streams"], ref["y_card"]):
            require(np.array_equal(st, rs), f"path M D={d}: channel streams "
                    f"differ from path {g}'s")
        snr = min(require_match(f"path_M_D{d}: card vs CPU channel streams",
                                st[bpsk], c[bpsk], CHANNEL_BAR)
                  for st, c in zip(b["streams"], ref["y_cpu"]))
        gates = mesh_flagship_gates(f"M D={d}", f, ref["outs"],
                                    ref["tx_bits"], bpsk, 0)
        require_launches(b["launches"], {kernel: MESH_CHUNKS},
                         f"path M D={d} DDC bank")
        require_launches(f["launches"], {kernel: MESH_CHUNKS,
                                         "ted_scan": MESH_CHUNKS},
                         f"path M D={d}")
        require(f["bytes"] == predicted_bytes("flagship", 1, 1, halo=ov,
                                              channels=CHANNELS, m=f["m"]),
                f"path M D={d}: collective bytes {f['bytes']} on a 1x1 mesh")
        launches["M"] += [b["launches"], f["launches"]]
        mesh_line("M", f"build_ddc_bpsk31_bank(64 rates, {d}, sps={SPS}, "
                  "mesh=1x1)", f, res["chunk"], MESH_CHUNKS, start1, t1,
                  chunks=MESH_CHUNKS, chunk=res["chunk"],
                  bits_and_streams_vs_path=f"{g}: equal",
                  card_vs_cpu_bpsk_channel_min_snr_db=snr,
                  ddc_bank={k: b[k] for k in GRAPH_FIELDS if k in b},
                  peak_memory_bytes_by_rank=res["peak_memory_bytes_by_rank"],
                  **gates)

    # M': 2x2 on the one card against M's 1x1
    for res, one, (d, g, frames, kernel) in zip((p50, p16), (m50, m16),
                                                 cases):
        ov = fd.fastddc_init(0.05, d).overlap_length
        b = res["ddc"]
        require_graph(f"path M' D={d} DDC bank", "ddc", b, 2, MESH_CHUNKS)
        y, y1 = b["y"], one["ddc"]["y"]
        err = float(np.abs(y - y1).max())
        require(err <= MESH_DDC_ATOL, f"path M' D={d}: DDC bank 2x2 vs 1x1 "
                f"max abs error {err} > {MESH_DDC_ATOL}")
        snr = require_match(f"path_M'_D{d}: DDC bank 2x2 vs 1x1",
                            y[bpsk], y1[bpsk], CHANNEL_BAR)
        require_launches(b["launches"], {kernel: 4 * MESH_CHUNKS},
                         f"path M' D={d} DDC bank")
        want = {k: v * MESH_CHUNKS
                for k, v in predicted_bytes("ddc", 2, 2, halo=ov).items()}
        require(b["bytes"] == want, f"path M' D={d}: DDC bank "
                f"collective bytes {b['bytes']}, predicted {want}")
        launches["M'"].append(b["launches"])
        extra = {"ddc_bank_vs_1x1_max_abs": err,
                 "ddc_bank_vs_1x1_bpsk_min_snr_db": snr,
                 "ddc_bank_collective_bytes": b["bytes"],
                 "ddc_bank_host_ms_by_rank": [
                     r["host_ms"] for r in b["ranks"]],
                 "peak_memory_bytes_by_rank":
                     res["peak_memory_bytes_by_rank"]}
        if "flagship" not in res:
            mesh_line("M'", f"sharded_ddc.build_ddc_bank_step(64 rates, "
                      f"D={d}), mesh=2x2", b, res["chunk"], MESH_CHUNKS,
                      start4, t4, **extra)
            continue
        f = res["flagship"]
        require_graph(f"path M' D={d}", "flagship", f, 2, MESH_CHUNKS)
        gates = mesh_flagship_gates(f"M' D={d}", f,
                                    one["flagship"]["outs"],
                                    banks[g]["mesh_ref"]["tx_bits"], bpsk,
                                    BANK_SLIP_BAR)
        # every rank runs the modem on its chan rows, once a chunk
        require_launches(f["launches"], {kernel: 4 * MESH_CHUNKS,
                                         "ted_scan": 4 * MESH_CHUNKS},
                         f"path M' D={d}")
        want = {k: v * MESH_CHUNKS for k, v in predicted_bytes(
            "flagship", 2, 2, halo=ov, channels=CHANNELS, m=f["m"]).items()}
        require(f["bytes"] == want, f"path M' D={d}: collective bytes "
                f"{f['bytes']}, predicted {want}")
        launches["M'"].append(f["launches"])
        mesh_line("M'", f"build_ddc_bpsk31_bank(64 rates, {d}, sps={SPS}, "
                  "mesh=2x2)", f, res["chunk"], MESH_CHUNKS, start4, t4,
                  chunks=MESH_CHUNKS, predicted_bytes=want,
                  ddc_bank={k: b[k] for k in GRAPH_FIELDS if k in b},
                  **gates, **extra)

    # M'': the WFM bank against itself with K1's plain version (through
    # the eager step: a replayed graph would launch K1) at both mesh
    # shapes, then tones, 2x2 against 1x1, K1 once a channel a time shard
    vs_plain = {}
    for res, name in ((w1, "1x1"), (w4, "2x2")):
        require(res["k1_plain_launches"]["shift_fir_decimate"] == 0,
                f"path M'' {name}: the K1-plain step launched K1 "
                f"{res['k1_plain_launches']['shift_fir_decimate']} times")
        a, p = res["audio"], res["audio_plain"]
        err = float(np.abs(a - p).max())
        db = require_match(f"path_M''_{name}: the WFM bank vs K1's plain "
                           "version", a, p, WFM_PLAIN_BARS[0])
        require(err <= WFM_PLAIN_BARS[1], f"path M'' {name}: the WFM bank "
                f"vs K1's plain version, max abs {err} > "
                f"{WFM_PLAIN_BARS[1]}")
        vs_plain[name] = {"vs_k1_plain_min_snr_db": db,
                          "vs_k1_plain_max_abs": err,
                          "k1_plain_run_k1_launches": 0}
    hz = [tone_hz(w1["audio"][c]) for c in bpsk]
    require(all(abs(h - 1000.0) < 5.0 for h in hz),
            f"path M'': tones at {hz} Hz")
    db, atol = WFM_BANK_BARS
    wfm_snr = snr_db(w1["audio"], w4["audio"])
    wfm_err = float(np.abs(w1["audio"] - w4["audio"]).max())
    require(wfm_snr >= db and wfm_err <= atol, f"path M'': 2x2 vs 1x1 "
            f"{wfm_snr:.1f} dB, max abs {wfm_err}")
    for res, (chan, time_), start, t0 in ((w1, (1, 1), start1, t1),
                                          (w4, (2, 2), start4, t4)):
        name = f"{chan}x{time_}"
        # the run compared eager and captured over two calls each
        require_graph(f"path M'' {name}", "wfm", res, time_, 2)
        require_launches(res["launches"], {
            "shift_fir_decimate": WFM_BANK_CHANNELS * time_},
            f"path M'' {name}")
        want = predicted_bytes("wfm", chan, time_, halo=res["tail_ext"],
                               channels=WFM_BANK_CHANNELS)
        require(res["bytes"] == want, f"path M'' {name}: collective "
                f"bytes {res['bytes']}, predicted {want}")
        mesh_line("M''", f"sharded_wfm.build_wfm_bank_step(64 rates, "
                  f"firdes_lowpass_f(81, 0.05), {WFM_D1}, {WFM_D2}), "
                  f"mesh={name}", res, CHUNK, 1, start, t0,
                  tones_hz=hz, vs_1x1_snr_db=wfm_snr, vs_1x1_max_abs=wfm_err,
                  predicted_bytes=want, **vs_plain[name])
    return {"M": add_launches(*launches["M"]),
            "M'": add_launches(*launches["M'"]),
            "M'' 1x1": w1["launches"], "M'' 2x2": w4["launches"]}


# ---------------------------------------------------------------------------
# the DDC server (paths S, S', S''), driven through DdcdServer itself
# ---------------------------------------------------------------------------

SERVER_CHUNKS = 6
SERVER_RATES = (-0.3, -0.18, -0.06, 0.06, 0.18, 0.3)   # the claimed shifts
# each claimed slot's tone, cycles a channel sample, distinct so that a
# retuned slot's tone is told from its own
SERVER_TONES = (0.05, -0.1, 0.15, -0.2, 0.1, -0.05)
RETUNE_AT, RELEASE_AT, BACK_AT = 3, 4, 5   # before these chunks (0-based)
SERVER_PATHS = {           # DdcdServer arguments, kernel, launches a chunk
    "S": (dict(decimation=16, max_channels=CHANNELS, method="fastddc",
               frames=FRAMES_A), "fastddc_inv", 1),
    "S'": (dict(decimation=50, max_channels=CHANNELS, method="fastddc",
                frames=FRAMES_B), "fft_ko", 1),
    "S''": (dict(decimation=16, max_channels=8, method="td", frames=64),
            "fir_decimate", 8)}
QUIET_RATES = (-0.24, -0.12, 0.0, 0.12, 0.24, 0.42)   # noise-only channels
SOCKET_WAIT = 60.0         # seconds any wait of the socket run may take


def server_slots(c: int) -> list[int]:
    """Six claimed slots spread over the server's c."""
    return [int(round(v)) for v in np.linspace(0, c - 1, len(SERVER_RATES))]


def server_input(n: int, decim: int, seed: int) -> np.ndarray:
    """A tone in each claimed slot's channel (at its SERVER_TONES offset
    once decimated) plus complex noise of BANK_NOISE per part."""
    return tones(n, [-r + f / decim for r, f in zip(SERVER_RATES,
                                                    SERVER_TONES)],
                 seed, noise=BANK_NOISE)


def slot_rows(srv, s: int) -> tuple:
    """Copies of one slot's host rows."""
    if srv.method == "fastddc" and not srv.factored:
        w = srv._block_cols
        return (srv.fold_np[..., s * w:(s + 1) * w].copy(),
                srv.rate_np[s].copy())
    return tuple(np.array(a[s]) for a in srv._host_rows())


def drive_server(srv, x: np.ndarray, slots, changes: bool = True,
                 each=None):
    """Claim ``slots`` at SERVER_RATES, then SERVER_CHUNKS chunks through
    ``_run_chunk``: slot 1 retuned to slot 4's shift before chunk
    RETUNE_AT, slot 2 released before RELEASE_AT, slot 1 back before
    BACK_AT (``changes=False``: the claims alone).  ``each(k, seconds)``,
    if given, runs after chunk k with its ``_run_chunk``'s host seconds.
    Returns the outputs (data, counts) a chunk, and slot 1's rows at the
    claim and after the retune back."""
    for s, r in zip(slots, SERVER_RATES):
        srv.set_shift(s, r)
    first = back = slot_rows(srv, slots[1])
    n, outs = srv.chunk_in, []
    for k in range(SERVER_CHUNKS):
        if changes and k == RETUNE_AT:
            srv.set_shift(slots[1], SERVER_RATES[4])
        if changes and k == RELEASE_AT:
            with srv.lock:
                srv._zero_slot_locked(slots[2])
        if changes and k == BACK_AT:
            srv.set_shift(slots[1], SERVER_RATES[1])
            back = slot_rows(srv, slots[1])
        t0 = time.perf_counter()
        outs.append(srv._run_chunk(x[k * n:(k + 1) * n]))
        if each is not None:
            each(k, time.perf_counter() - t0)
    return outs, first, back


def server_tone_plan(i: int) -> list:
    """(chunks, wanted tone) for claimed slot i: slot 1 moves to slot 4's
    tone and back, slot 2 is released."""
    if i == 1:
        return [(range(RETUNE_AT), SERVER_TONES[1]),
                (range(RETUNE_AT, BACK_AT), SERVER_TONES[4]),
                (range(BACK_AT, SERVER_CHUNKS), SERVER_TONES[1])]
    if i == 2:
        return [(range(RELEASE_AT), SERVER_TONES[2])]
    return [(range(SERVER_CHUNKS), SERVER_TONES[i])]


def server_path(torch, key):
    """One server path on the card: launches, tones, the retune, the
    retune back, the release, the slots these leave alone against a run
    without them bit for bit, and each claimed slot card vs CPU."""
    from csdr_tpu_torch.server.ddcd import DdcdServer

    args, kernel, per_chunk = SERVER_PATHS[key]

    def make(device):
        return DdcdServer(transition_bw=0.05, device=device, **args)

    srv = make("cuda")
    c, d, n = srv.max_channels, srv.decimation, srv.chunk_in
    slots = server_slots(c)
    x = server_input(SERVER_CHUNKS * n, d, 60 + d + c)
    reset_all()
    t0 = time.perf_counter()
    outs, first, back = drive_server(srv, x, slots)
    wall = time.perf_counter() - t0
    launches = launches_all()
    require_launches(launches, {kernel: per_chunk * SERVER_CHUNKS},
                     f"path {key}")
    if key in LINT_ALLOW:
        # the eager step that _run_chunk captures, past its upload and
        # before its download to the sockets, on the rows the chunks ran
        # with, from a fresh state
        lint_step(torch, key, srv.step, srv.init(),
                  torch.from_numpy(x[:n]).to(srv.device))
    count = int(outs[0][1][0])
    require(all(o.shape[0] == c and np.all(k == count) and
                np.all(np.isfinite(o.view(np.float32))) for o, k in outs),
            f"path {key}: output shape, counts or values")
    got = {}
    for i, s in enumerate(slots):
        for ks, want in server_tone_plan(i):
            f = peak_cycles(np.concatenate([outs[k][0][s, :count]
                                            for k in ks]))
            got[f"slot {s} chunks {ks.start + 1}-{ks.stop}"] = f
            require(abs(f - want) < 1e-3, f"path {key}: slot {s} tone at "
                    f"{f:.5f} in chunks {list(ks)}, want {want}")
    unclaimed = [s for s in range(c) if s not in slots]
    gone = slots[2]
    for k in range(RELEASE_AT, SERVER_CHUNKS):
        if srv.method == "td":
            # as csdr_tpu's td method: a released slot goes back to shift
            # 0, the unclaimed slots' channel, turned by its carried phase
            y, u = outs[k][0][gone, :count], outs[k][0][unclaimed[0], :count]
            turn = np.vdot(u, y) / np.vdot(u, u)
            require(abs(abs(turn) - 1) < 1e-4 and np.abs(
                y - turn * u).max() < 1e-4 * np.abs(u).max(),
                f"path {key}: released slot {gone} is not at shift 0")
        else:
            require(not np.any(outs[k][0][gone]),
                    f"path {key}: released slot {gone} gives non-zeros")
    require(all(np.array_equal(a, b) for a, b in zip(first, back)),
            f"path {key}: retuning back did not rewrite the rows bit for "
            "bit")

    # the slots the retune and the release leave alone, against a run
    # with the claims alone, bit for bit
    ctrl, _, _ = drive_server(make("cuda"), x, slots, changes=False)
    steady = [s for i, s in enumerate(slots) if i not in (1, 2)] + unclaimed
    for k in range(SERVER_CHUNKS):
        rows = steady + ([slots[1]] if k < RETUNE_AT else []) + \
            ([gone] if k < RELEASE_AT else [])
        require(np.array_equal(outs[k][0][rows], ctrl[k][0][rows]),
                f"path {key}: chunk {k + 1} of a slot the retune and the "
                "release leave alone differs from the run without them")
    del ctrl

    # every slot claimed in a chunk, card vs CPU (the released slot until
    # its release)
    cpu, _, _ = drive_server(make("cpu"), x, slots)

    def claimed(k):
        return [s for s in slots if s != gone or k < RELEASE_AT]

    snr = min(require_match(
        f"path_{key}: card vs CPU chunk {k + 1}",
        outs[k][0][claimed(k), :count], cpu[k][0][claimed(k), :count],
        CHANNEL_BAR, x[k * n:(k + 1) * n],
        lambda k=k: drive_server(make("cuda"), x,
                                 slots)[0][k][0][claimed(k)],
        lambda k=k: drive_server(make("cpu"), x, slots)[0][k][0][claimed(k)],
        frame=max(1, count // 64)) for k in range(SERVER_CHUNKS))
    emit("path", path=key, pipeline=f"DdcdServer({d}, 0.05, max_channels="
         f"{c}, method={srv.method!r}, frames={args['frames']})",
         chunks=SERVER_CHUNKS, chunk=n, channel_samples_per_chunk=count,
         claimed_slots=slots, launches=launches, tones_at=got,
         retune=f"slot {slots[1]} to shift {SERVER_RATES[4]} before chunk "
         f"{RETUNE_AT + 1}, back before chunk {BACK_AT + 1}: rows bit for bit",
         release=f"slot {gone} before chunk {RELEASE_AT + 1}",
         untouched_slots_bitwise_vs_run_without_changes=True,
         card_vs_cpu_min_claimed_slot_snr_db=snr, bar_db=CHANNEL_BAR,
         drive_s=wall)
    return {"launches": launches, "srv": srv, "x": x, "slots": slots,
            "wall": wall}


def host_ms(fn, reps=7):
    """Median milliseconds of ``fn`` by the host clock, and [min, max]."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), [float(min(ts)), float(max(ts))]


def server_cost(torch, srv, x: np.ndarray, slot: int) -> dict:
    """The server's step (the captured one ``_run_chunk`` calls) as issued
    and device-only (CUDA events), and by the host clock ``_run_chunk``
    (input up, rows up when changed, step, slots back) and a retune to
    the next chunk's output."""
    import itertools

    from csdr_tpu_torch.utils.timing import time_cuda

    n = srv.chunk_in
    xc = x[:n]
    xd = torch.from_numpy(xc).to(srv.device)
    srv._run_chunk(xc)
    box = {"s": srv.state}

    def one():
        box["s"], y = srv._step(box["s"], xd)
        return y

    step_ms = time_cuda(one, iters=10, warmup=2, repeats=5)
    device_ms = time_cuda(one, iters=10, warmup=1, repeats=5,
                          queue_ahead_ms=100.0)
    profile = profile_call(torch, one)
    srv.state = box["s"]                 # the state the step returned last
    run_ms, run_span = host_ms(lambda: srv._run_chunk(xc))
    flip = itertools.cycle((SERVER_RATES[4], SERVER_RATES[1]))
    retune_ms, retune_span = host_ms(
        lambda: (srv.set_shift(slot, next(flip)), srv._run_chunk(xc)))
    return {"chunk": n, "step_ms": step_ms, "msps": n / step_ms / 1e3,
            "device_ms": device_ms, "device_busy_share": device_ms / step_ms,
            "step_profile": profile,
            "run_chunk_ms": run_ms, "run_chunk_ms_span": run_span,
            "retune_to_output_ms": retune_ms,
            "retune_to_output_ms_span": retune_span,
            "rows_bytes": int(sum(a.nbytes for a in srv._host_rows()))}


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def socket_run(torch):
    """serve() on the card in a thread over loopback, its input a pipe fed
    chunk by chunk: two clients send shift= and get their tones, one
    retunes mid-stream, the other switches to bypass=1 and gets the raw
    bytes.  Every wait has a deadline of SOCKET_WAIT seconds."""
    import os
    import queue
    import socket
    import threading

    from csdr_tpu_torch.ops import fastddc as fd
    from csdr_tpu_torch.server.ddcd import DdcdServer

    port = free_port()
    srv = DdcdServer(transition_bw=0.05, port=port, device="cuda",
                     **SERVER_PATHS["S"][0])
    n, d = srv.chunk_in, srv.decimation
    per = n // d * 8                         # a channel chunk's bytes
    off = (0.005, -0.008)
    x = tones(3 * n, [0.11 + off[0], -0.27 + off[1]], 70, noise=BANK_NOISE)
    todo: queue.Queue = queue.Queue()
    r, w = os.pipe()
    pipe_in, pipe_out = os.fdopen(r, "rb"), os.fdopen(w, "wb")

    def feed():
        try:
            while (data := todo.get()) is not None:
                pipe_out.write(data)
                pipe_out.flush()
        except OSError:
            pass
        finally:
            pipe_out.close()

    def wait(cond, what):
        end = time.time() + SOCKET_WAIT
        while not cond():
            require(time.time() < end, f"socket run: no {what} in "
                    f"{SOCKET_WAIT} s")
            time.sleep(0.01)

    def connect():
        end = time.time() + SOCKET_WAIT
        while True:
            try:
                return socket.create_connection(("127.0.0.1", port),
                                                timeout=5)
            except OSError:
                require(time.time() < end and server.is_alive(),
                        "socket run: the server does not listen")
                time.sleep(0.05)

    def recv(sock, nbytes):
        sock.settimeout(SOCKET_WAIT)
        got = bytearray()
        while len(got) < nbytes:
            part = sock.recv(min(nbytes - len(got), 1 << 20))
            require(bool(part), "socket run: a client's stream ended")
            got += part
        return bytes(got)

    def peak(payload):
        return peak_cycles(np.frombuffer(payload, np.complex64))

    def tuned(s, rate):
        return np.array_equal(srv.tq_np[s],
                              fd.dynamic_channelizer_rows(srv.ddc, rate)[0])

    feeder = threading.Thread(target=feed, daemon=True)
    server = threading.Thread(target=srv.serve, args=(pipe_in,),
                              daemon=True)
    feeder.start()
    server.start()
    c1 = c2 = None
    reset_all()
    t0 = time.perf_counter()
    try:
        c1 = connect()
        wait(lambda: len(srv.clients) == 1, "slot for the first client")
        c2 = connect()
        wait(lambda: len(srv.clients) == 2, "slot for the second client")
        c1.sendall(b"shift=-0.11\n")
        c2.sendall(b"shift=0.27\n")
        wait(lambda: tuned(0, -0.11) and tuned(1, 0.27), "shift applied")
        todo.put(x[:n].tobytes())
        p1, p2 = peak(recv(c1, per)), peak(recv(c2, per))
        require(abs(p1 - off[0] * d) < 1e-3 and abs(p2 - off[1] * d) < 1e-3,
                f"socket run: tones at {p1:.5f}, {p2:.5f}")
        c1.sendall(b"shift=0.27\n")           # c1 retunes mid-stream
        wait(lambda: tuned(0, 0.27), "retune applied")
        todo.put(x[n:2 * n].tobytes())
        q1, q2 = peak(recv(c1, per)), peak(recv(c2, per))
        require(abs(q1 - off[1] * d) < 1e-3 and abs(q2 - off[1] * d) < 1e-3,
                f"socket run: after the retune, tones at {q1:.5f}, {q2:.5f}")
        c2.sendall(b"bypass=1\n")
        wait(lambda: any(cl.bypass for cl in list(srv.clients.values())),
             "bypass applied")
        todo.put(x[2 * n:].tobytes())
        raw_ok = recv(c2, n * 8) == x[2 * n:].tobytes()
        recv(c1, per)
        require(raw_ok, "socket run: bypass bytes differ from the input")
    finally:
        todo.put(None)
        feeder.join(SOCKET_WAIT)
        server.join(SOCKET_WAIT)
        for cl in (c1, c2):
            if cl is not None:
                cl.close()
    wall = time.perf_counter() - t0
    require(not server.is_alive() and not feeder.is_alive(),
            "socket run: serve() did not end at the end of its input")
    launches = launches_all()
    require_launches(launches, {"fastddc_inv": 3}, "socket run")
    emit("path", path="S sockets", pipeline="DdcdServer(16, 0.05, "
         "max_channels=64, frames=1024).serve() over loopback",
         chunks=3, launches=launches, tones_at=[p1, p2],
         after_retune_tones_at=[q1, q2], tone_want=[off[0] * d, off[1] * d],
         bypass_bytes_equal=raw_ok, wall_s=wall)


def k2_server_case(torch):
    """K2 at the shape S'' gives it, one slot's chunk: D=16, T=79,
    kout=16 384."""
    case = dict(kernel_case(torch, "fir_decimate", 16, 79, 16_384, 0.0, 0.0,
                            27), path="S''")
    emit("kernels", **case)
    return case


def phase_server_paths(torch):
    """K2 at the shape of S'', then paths S (K4), S' (K3 forward) and S''
    (K2) through DdcdServer, each with its cost, then serve() over
    sockets."""
    require_no_tf32(torch)
    case = k2_server_case(torch)
    servers = {}
    for key in SERVER_PATHS:
        sv = server_path(torch, key)
        cost = server_cost(torch, sv["srv"], sv.pop("x"), sv["slots"][1])
        emit("throughput", path=key,
             pipeline=f"DdcdServer {SERVER_PATHS[key][0]}", **cost,
             drive_msps=SERVER_CHUNKS * sv["srv"].chunk_in / sv["wall"] / 1e6,
             note="step_ms: CUDA events around back-to-back captured steps "
                  "(the graph's replays) as issued; device_ms: the same "
                  "queued ahead of the card; "
                  "run_chunk_ms: host clock, input up, rows up when changed, "
                  "the step and every slot back to the host; "
                  "retune_to_output_ms: host clock from set_shift to the "
                  "next chunk's output on the host; spans: min and max of 7")
        del sv["srv"]
        servers[key] = sv
    socket_run(torch)
    return servers, [case]


# ---------------------------------------------------------------------------
# quiet channels: card and CPU, each against a float64 channelizer
# ---------------------------------------------------------------------------

def f64_frames(x: np.ndarray, ins: int, ov: int) -> np.ndarray:
    """Overlap frames of one chunk from zero history, complex128."""
    x = x.astype(np.complex128)
    b = len(x) // ins
    blk = x[: b * ins].reshape(b, ins)
    prev = np.concatenate([np.zeros((1, ov)), blk[:-1, ins - ov:]], 0)
    return np.concatenate([prev, blk], 1)


def f64_factored(x, ddc, tq2, wdft, w, d, ramp) -> np.ndarray:
    """The fused channelizer in float64 on the block's own complex64
    matrices and float32 NCO phases: split DFT, fold, iDFT, diagonal,
    per-frame NCO.  (C, B*M)."""
    ins, ov = ddc.input_size, ddc.overlap_length
    pre, inv = ddc.pre_decimation, ddc.fft_inv_size
    frames = f64_frames(x, ins, ov)
    b = frames.shape[0]
    s = frames.reshape(b, inv, pre).transpose(0, 2, 1) @ \
        wdft.astype(np.complex128)                       # (b, pre, inv)
    z = np.einsum("bjm,cjm->cbm", s, tq2.astype(np.complex128))
    y = (z @ w.astype(np.complex128)) * d.astype(np.complex128)[:, None, :]
    y *= np.exp(2j * np.pi * ramp.astype(np.float64))[:, :, None]
    return y.reshape(len(tq2), -1)


def f64_classed(x, ddc, inv_blk) -> np.ndarray:
    """The forward FFT and the classed inverse in float64 on the block's
    own complex64 class matrices (kernel bin order) and float32 NCO
    phases."""
    from csdr_tpu_torch.kernels import fft_cuda

    frames = f64_frames(x, ddc.input_size, ddc.overlap_length)
    b, q = frames.shape[0], inv_blk.q
    spectra = np.fft.fft(frames)[:, fft_cuda.gather_idx(ddc.fft_size)]
    g = inv_blk.g.cpu().numpy().astype(np.complex128)
    groups = b // q
    z = np.matmul(spectra.reshape(groups, q, -1).transpose(1, 0, 2), g)
    c, m = inv_blk.n_channels, inv_blk.m_max
    z = z.reshape(q, groups, c, m).transpose(2, 1, 0, 3)
    ramp = inv_blk._host_ramps(b)[0].astype(np.float64)
    y = z * np.exp(2j * np.pi * ramp)[..., None]
    sel = inv_blk.sel.cpu().numpy()
    return y.reshape(c, groups, -1)[..., sel].reshape(c, -1)


def quiet_line(key, ref, card, cpu, loud, quiet) -> dict:
    """Per-channel SNRs of card and CPU against the float64 reference."""
    sc, su = channel_snrs(ref, card), channel_snrs(ref, cpu)
    row = {"path": key, "quiet_channels": len(quiet),
           "card_vs_f64_quiet_min_db": float(sc[quiet].min()),
           "cpu_vs_f64_quiet_min_db": float(su[quiet].min()),
           "card_vs_f64_quiet_median_db": float(np.median(sc[quiet])),
           "cpu_vs_f64_quiet_median_db": float(np.median(su[quiet])),
           "card_vs_f64_loud_min_db": float(sc[loud].min()),
           "cpu_vs_f64_loud_min_db": float(su[loud].min()),
           "card_vs_cpu_quiet_min_db": float(
               channel_snrs(cpu, card)[quiet].min()),
           "card_further_off_on_quiet": bool(sc[quiet].min()
                                             < su[quiet].min())}
    emit("quiet_channels", **row)
    return row


def quiet_bank(torch, key, g):
    """Chunk 1 of bank path G or G': its channel streams on the card and
    on the CPU against float64; quiet = the channels without a BPSK31
    carrier."""
    bank = g["bank"]
    x = g["xs"][0].cpu().numpy()
    chan = bank.channelizer
    if hasattr(chan, "tq2"):
        b = len(x) // bank.ddc.input_size
        ref = f64_factored(x, bank.ddc, *(t.cpu().numpy() for t in (
            chan.tq2, chan.wdft, chan.w, chan.d)), chan._host_ramps(b)[0])
    else:
        ref = f64_classed(x, bank.ddc, chan.blocks[1])
    loud = np.asarray(g["bpsk"])
    quiet = np.setdiff1d(np.arange(len(ref)), loud)
    return quiet_line(key, ref, g["y_card0"], g["y_cpu"][0].numpy(), loud,
                      quiet)


def quiet_server(torch):
    """Path S's server, one chunk from a fresh state on the card and on
    the CPU, its six tone slots claimed and six more at shifts whose
    channels hold only the noise, against float64."""
    from csdr_tpu_torch.ops import fastddc as fd
    from csdr_tpu_torch.server.ddcd import DdcdServer

    outs = {}
    for dev in ("cuda", "cpu"):
        srv = DdcdServer(transition_bw=0.05, device=dev,
                         **SERVER_PATHS["S"][0])
        slots = server_slots(srv.max_channels)
        quiet = [s for s in range(srv.max_channels)
                 if s not in slots][:len(QUIET_RATES)]
        for s, r in zip(slots + quiet, SERVER_RATES + QUIET_RATES):
            srv.set_shift(s, r)
        x = server_input(srv.chunk_in, srv.decimation, 80)
        outs[dev] = srv._run_chunk(x)[0]
    ddc, m = srv.ddc, srv.chan.m
    b = srv.chunk_in // ddc.input_size
    ramp = fd._frame_ramp(b, torch.from_numpy(srv.rate_np)).numpy()
    ref = f64_factored(x, ddc, srv.tq_np, srv.chan.wdft.numpy(),
                       srv.chan.w.numpy(), srv.d_np[:, :m], ramp)
    keep = slots + quiet
    loud_i, quiet_i = list(range(len(slots))), list(range(len(slots),
                                                           len(keep)))
    row = quiet_line("S", ref[keep], outs["cuda"][keep], outs["cpu"][keep],
                     loud_i, quiet_i)
    emit("quiet_channels", **quiet_inverse_split(torch, srv, x, ramp, keep,
                                                 loud_i, quiet_i))
    return row


def quiet_inverse_split(torch, srv, x, ramp, keep, loud, quiet) -> dict:
    """Which half of the card's channelizer sets its quiet-channel floor:
    the card's own split-DFT spectra of the chunk through K4 and through
    K4's plain version on the card (cuBLAS, full float32), each against
    float64 on those same spectra."""
    from csdr_tpu_torch.kernels import fastddc_cuda
    from csdr_tpu_torch.ops import fastddc as fd

    dev = torch.device("cuda")
    ddc, chan = srv.ddc, srv.chan.to(dev)
    b, m = srv.chunk_in // ddc.input_size, chan.m
    xd = torch.from_numpy(x).to(dev)
    frames = fd.overlap_frames(xd, torch.zeros(ddc.overlap_length,
                                               dtype=torch.complex64,
                                               device=dev),
                               ddc.input_size, ddc.overlap_length)
    x6 = frames.reshape(b, ddc.fft_inv_size, ddc.pre_decimation
                        ).transpose(1, 2)
    require_no_tf32(torch)
    spectra = torch.matmul(x6, chan.wdft).reshape(b, ddc.fft_size)
    tq = torch.from_numpy(srv.tq_np).to(dev)
    d = torch.from_numpy(srv.d_np).to(dev)
    rot = torch.polar(torch.ones(ramp.shape, device=dev),
                      2 * np.pi * torch.from_numpy(ramp).to(dev))
    with torch.no_grad():
        k4 = fastddc_cuda.fastddc_inv(spectra, tq, chan.w, d, rot, m)
        plain = fastddc_cuda.fastddc_inv_plain(spectra, tq, chan.w, d, rot,
                                               m)
    s128 = spectra.cpu().numpy().astype(np.complex128)
    pre, inv = ddc.pre_decimation, ddc.fft_inv_size
    z = np.einsum("bjm,cjm->cbm", s128.reshape(b, pre, inv),
                  srv.tq_np.astype(np.complex128))
    ref = (z @ chan.w.cpu().numpy().astype(np.complex128)) \
        * srv.d_np[:, None, :m].astype(np.complex128) \
        * np.exp(2j * np.pi * ramp.astype(np.float64))[:, :, None]
    ref = ref.reshape(len(ref), -1)[keep]
    sk = channel_snrs(ref, k4.reshape(len(k4), -1).cpu().numpy()[keep])
    sp = channel_snrs(ref, plain.reshape(len(plain), -1).cpu().numpy()[keep])
    return {"path": "S inverse alone", "on": "the card's split-DFT spectra",
            "k4_vs_f64_quiet_min_db": float(sk[quiet].min()),
            "plain_on_card_vs_f64_quiet_min_db": float(sp[quiet].min()),
            "k4_vs_f64_loud_min_db": float(sk[loud].min()),
            "plain_on_card_vs_f64_loud_min_db": float(sp[loud].min())}


# ---------------------------------------------------------------------------
# the byte edge: the waterfall (W) and BASELINE config 1 (W1), both from raw
# u8 I/Q, and the ADPCM codec kernel they end in
# ---------------------------------------------------------------------------

ADPCM_SOURCE = "csdr_tpu_torch/csrc/adpcm.cu"
W_FFT = 4096               # OpenWebRX's defaults: fft_size 4096,
W_FPS = 9                  # fft_fps 9 and fft_voverlap_factor 0.3 at 2.4 Msps
W_AVG = int(round(FS / W_FFT / W_FPS / (1 - 0.3)))     # fft_averages: 93
W_EVERY = int(FS / W_FPS / W_AVG)                      # fft_block_size: 2867
W_CHUNK = W_EVERY * W_AVG * W_FPS    # 2 399 679 samples: 1 s, 9 rows, 837 frames
W_CHUNKS = 10
W_ADD_DB = -70.0
W_TONES = (-0.3125, -0.1, 0.05, 0.21)   # cycles/sample, loudest first
W_POWER_BAR = 100.0        # card vs CPU, linear averaged power, dB (fastddc's)
W1_FS = 240_000            # BASELINE config 1: 240 ksps u8 I/Q
W1_CHUNK = 240_000
W1_CHUNKS = 10
ADPCM_CUT = 2048           # samples a chunk where the plain codec runs on a path
SM_CLOCK_HZ = 1.98e9       # H100 SXM top SM clock
INT32_OPS = 132 * 64 * SM_CLOCK_HZ   # H100 SXM: 132 SMs x 64 INT32 lanes
# integer ops a codec step, counted from csdr_tpu's _encode_step and
# _decode_step (csrc/adpcm.cu's note)
STEP_OPS = {"adpcm_encode": 44, "adpcm_decode": 23}
PROBE_LINKS = 1 << 16      # links of each chain the probe times


def waterfall_u8(c: int) -> np.ndarray:
    """Chunk ``c`` of W's input: the tones of W_TONES (float64 phase over the
    whole stream) plus complex noise, quantised to interleaved u8 I/Q as an
    RTL-SDR delivers it."""
    rng = np.random.default_rng(100 + c)
    s = np.arange(c * W_CHUNK, (c + 1) * W_CHUNK, dtype=np.float64)
    x = 0.02 * (rng.standard_normal(W_CHUNK)
                + 1j * rng.standard_normal(W_CHUNK))
    for k, f in enumerate(W_TONES):
        x += 0.25 / (k + 1) * np.exp(2j * np.pi * np.mod(f * s, 1.0))
    return iq_to_u8(x, 127.5)


def iq_to_u8(x: np.ndarray, scale: float) -> np.ndarray:
    iq = np.empty(2 * len(x))
    iq[0::2], iq[1::2] = x.real, x.imag
    return np.clip(np.round(127.5 + scale * iq), 0, 255).astype(np.uint8)


def waterfall_chain():
    """OpenWebRX's waterfall from raw u8 I/Q: convert_u8_c | fft_cc 4096 2867
    | logaveragepower_cf -70 4096 93 | fft_exchange_sides_ff 4096 |
    compress_fft_adpcm_f_u8 4096; a chunk's dB rows are block 3's output."""
    from csdr_tpu_torch import Pipeline, stateless
    from csdr_tpu_torch.ops import convert, spectrum

    return Pipeline([
        stateless("convert_u8_c", convert.convert_u8_c),
        spectrum.fft_cc_block(W_FFT, W_EVERY),
        spectrum.logaveragepower_block(W_ADD_DB, W_FFT, W_AVG),
        stateless("fft_exchange_sides_ff", lambda x: (
            spectrum.fft_exchange_sides_ff(x.reshape(-1, W_FFT)))),
        stateless("compress_fft_adpcm_f_u8", lambda rows: (
            spectrum.compress_fft_adpcm_rows(rows, W_FFT))),
    ], name="waterfall")


def config1_chain():
    """BASELINE config 1 with OpenWebRX's compressed audio, from raw u8
    I/Q: convert_u8_c | wfm_basic | convert_f_s16 | encode_ima_adpcm, the
    encoder fed whole sample pairs as csdr_tpu's CLI pumps it (cli.py:1303:
    wfm_basic's first chunk gives an odd count; its last sample waits)."""
    from csdr_tpu_torch import Pipeline, stateless
    from csdr_tpu_torch.models import wfm
    from csdr_tpu_torch.ops import adpcm, convert

    return Pipeline([stateless("convert_u8_c", convert.convert_u8_c),
                     wfm.wfm_basic(),
                     stateless("convert_f_s16", convert.convert_f_s16),
                     adpcm.paired_encode_block()], name="config 1")


def drive_blocks(pipe, state, x):
    """``pipe(state, x)`` as Pipeline.forward runs it, block by block,
    keeping every block's output."""
    states, outs = [], []
    for blk, s in zip(pipe.blocks, state):
        s, x = blk(s, x)
        states.append(s)
        outs.append(x)
    return tuple(states), outs


def adpcm_chains(torch):
    """SM cycles a link of the two chains that set the codec's bounds
    (csrc/adpcm.cu's note), the least of three runs of PROBE_LINKS links
    each, and the SM clock the card ran them at (a long run against CUDA
    events)."""
    from csdr_tpu_torch.kernels import adpcm_cuda

    enc = min(adpcm_cuda.chain_cycles(0, PROBE_LINKS) for _ in range(3))
    lvl = min(adpcm_cuda.chain_cycles(1, PROBE_LINKS) for _ in range(3))
    require(enc > 1.0 and lvl > 1.0, f"adpcm chain probe: {enc} and {lvl} "
                                     "cycles a link")
    links = 64 * PROBE_LINKS
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    per_link = adpcm_cuda.chain_cycles(1, links)
    stop.record()
    stop.synchronize()
    mhz = per_link * links / (start.elapsed_time(stop) * 1e3)
    return {"encode_step_cycles": enc, "scan_level_cycles": lvl,
            "sm_mhz_during_probe": mhz}


def adpcm_case(torch, name, x, state, chains):
    """The codec kernel ``name`` on (B, L) input against its plain version
    on the card, bit for bit (outputs and states); its time, the plain
    version's (one call) and its bound at the top SM clock: the encoder's
    steps x the cycles of its shortest step chain, the decoder's 2 x
    ceil(log2 steps) scan levels (``chains``, from adpcm_chains), or the
    bytes or the integer ops if longer."""
    from csdr_tpu_torch.kernels import adpcm_cuda
    from csdr_tpu_torch.utils.timing import time_cuda

    op = name.split("_")[1]
    kern, plain = (getattr(adpcm_cuda, op),
                   getattr(adpcm_cuda, op + "_plain"))
    yk, sk = kern(x, state)
    box = {}
    plain_ms = time_cuda(lambda: box.setdefault("p", plain(x, state)),
                         iters=1, warmup=0, repeats=1)
    yp, sp = box["p"]
    torch.cuda.synchronize()
    rows, width = x.shape
    require(torch.equal(yk, yp) and torch.equal(sk, sp),
            f"{name} ({rows}, {width}): kernel differs from plain")
    ms = time_cuda(lambda: kern(x, state), iters=20, queue_ahead_ms=20.0)
    steps = width if op == "encode" else 2 * width
    nbytes = x.numel() * x.element_size() + yk.numel() * yk.element_size() \
        + 2 * state.numel() * 4
    t_bytes = least_ms(torch, nbytes, 0)[0]
    if op == "encode":
        cycles = steps * chains["encode_step_cycles"]
        note = (f"serial chain: {steps} steps x "
                f"{chains['encode_step_cycles']:.2f} SM cycles (the "
                f"shortest step chain, probed)")
    else:
        levels = 2 * int(np.ceil(np.log2(steps)))
        cycles = levels * chains["scan_level_cycles"]
        note = (f"prefix scan: {levels} levels x "
                f"{chains['scan_level_cycles']:.2f} SM cycles (probed)")
    t_ops = max(cycles / SM_CLOCK_HZ,
                rows * steps * STEP_OPS[name] / INT32_OPS) * 1e3
    return {
        "name": name, "route": "cuda", "source": ADPCM_SOURCE,
        "replaces": ("csdr_tpu/ops/adpcm.py:69" if op == "encode" else
                     "csdr_tpu/ops/adpcm.py:82") + " (lax.scan; no Pallas "
                    "kernel)",
        "shape": {"rows": rows, "steps": steps},
        "bit_exact": True, "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_note": note + f" at {SM_CLOCK_HZ / 1e6:.0f} MHz",
        "cycles_a_step": ms * 1e-3 * SM_CLOCK_HZ / steps,
        "library_ms": None, "bytes": nbytes,
        **roofline_row(torch, name, kern, x, state, nbytes, 0, ms,
                       ops_s=t_ops / 1e3),
    }


def codec_stream_case(torch, x):
    """(1, 2*ADPCM_CUT) samples in two chunks with the state carried,
    encoded and decoded: kernel and plain on the card, bit for bit."""
    from csdr_tpu_torch.kernels import adpcm_cuda

    st0 = torch.zeros((1, 2), dtype=torch.int32, device=x.device)
    out = {}
    for key, enc, dec in (("kernel", adpcm_cuda.encode, adpcm_cuda.decode),
                          ("plain", adpcm_cuda.encode_plain,
                           adpcm_cuda.decode_plain)):
        b1, s1 = enc(x[:, :ADPCM_CUT], st0)
        b2, s2 = enc(x[:, ADPCM_CUT:], s1)
        d1, t1 = dec(b1, st0)
        d2, t2 = dec(b2, t1)
        out[key] = (torch.cat([b1, b2], 1), s2, torch.cat([d1, d2], 1), t2)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(out["kernel"],
                                                 out["plain"]))


ADPCM_SATURATING = 150_000  # bytes: 300 000 nibbles of 0x7 / 0xF runs
ADPCM_LONG = 1_200_000     # bytes: a 2 400 000-nibble row, one block
ADPCM_ROWS = 33            # encoder rows: two blocks of its 32
ADPCM_PLAIN = 2048         # samples (nibbles) a row the serial loops check


def codec_redesign_cases(torch) -> dict:
    """The codec kernels against their plain versions on the card, bit for
    bit with the state: the decoder on a saturating row (runs of nibbles
    0x7 and 0xF pin prev at 32767 and -32768 and index at 88) against
    decode_scan_plain whole and decode_plain on its first ADPCM_PLAIN
    nibbles, and on a 2 400 000-nibble random row against decode_scan_plain;
    both directions from carried states whose index is -5 and 100; the
    encoder on ADPCM_ROWS rows, one of them alternating +-32767 (index to
    88), against encode_plain and encode_select_plain."""
    from csdr_tpu_torch.kernels import adpcm_cuda as codec
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    gen = np.random.default_rng(61)
    out = {}

    def same(a, b) -> bool:
        return all(torch.equal(u, v) for u, v in zip(a, b))

    zero = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    third = ADPCM_SATURATING // 3
    sat = np.full(ADPCM_SATURATING, 0x77, np.uint8)
    sat[third: 2 * third] = 0xFF
    sat_t = torch.from_numpy(sat).to(dev)[None]
    got = codec.decode(sat_t, zero)
    scan = codec.decode_scan_plain(sat_t, zero)
    half = ADPCM_PLAIN // 2
    serial = codec.decode_plain(sat_t[:, :half], zero)
    pinned = got[0][0].cpu().numpy()
    out["decode_saturating"] = {
        "nibbles": 2 * ADPCM_SATURATING,
        "vs_scan_plain": same(got, scan),
        "vs_plain_first": same(codec.decode(sat_t[:, :half], zero), serial)
        and torch.equal(got[0][:, :ADPCM_PLAIN], serial[0]),
        "pinned": bool(pinned[2 * third - 1] == 32767
                       and pinned[4 * third - 1] == -32768
                       and pinned[-1] == 32767),
        "state": got[1][0].tolist(),
        "ms": time_cuda(lambda: codec.decode(sat_t, zero), iters=5,
                        queue_ahead_ms=20.0)}
    require(out["decode_saturating"]["vs_scan_plain"]
            and out["decode_saturating"]["vs_plain_first"]
            and out["decode_saturating"]["pinned"]
            and out["decode_saturating"]["state"] == [32767, 88],
            f"adpcm decode, saturating row: {out['decode_saturating']}")

    long_t = torch.from_numpy(gen.integers(0, 256, ADPCM_LONG, dtype=np.uint8)
                              ).to(dev)[None]
    st = torch.tensor([[-1234, 17]], dtype=torch.int32, device=dev)
    out["decode_long_row"] = {"nibbles": 2 * ADPCM_LONG, "vs_scan_plain": same(
        codec.decode(long_t, st), codec.decode_scan_plain(long_t, st)),
        "ms": time_cuda(lambda: codec.decode(long_t, st), iters=5,
                        queue_ahead_ms=20.0)}
    require(out["decode_long_row"]["vs_scan_plain"],
            "adpcm decode: the 2 400 000-nibble row differs from "
            "decode_scan_plain")

    # carried states out of range: index -5 (csdr_tpu's gather reads row
    # 84) and 100 (row 88), prev in and out of int16
    carried = torch.tensor([[1000, -5], [-3000, 100], [40000, -5],
                            [-40000, 100]], dtype=torch.int32, device=dev)
    x = np.clip(gen.normal(0, 9000, (4, ADPCM_PLAIN)), -32768, 32767
                ).astype(np.int16)
    x_t = torch.from_numpy(x).to(dev)
    enc = codec.encode(x_t, carried)
    y_t = torch.from_numpy(gen.integers(0, 256, (4, half), dtype=np.uint8)
                           ).to(dev)
    out["carried_out_of_range"] = {
        "states": carried.tolist(),
        "encode_vs_plain": same(enc, codec.encode_plain(x_t, carried)),
        "decode_vs_plain": same(codec.decode(y_t, carried),
                                codec.decode_plain(y_t, carried)),
        "decode_vs_scan_plain": same(codec.decode(y_t, carried),
                                     codec.decode_scan_plain(y_t, carried))}
    require(all(v for k, v in out["carried_out_of_range"].items()
                if k != "states"),
            f"adpcm, carried states out of range: "
            f"{out['carried_out_of_range']}")

    rows = np.clip(gen.normal(0, 6000, (ADPCM_ROWS, ADPCM_PLAIN)), -32768,
                   32767).astype(np.int16)
    rows[7, 0::2], rows[7, 1::2] = 32767, -32767
    rows_t = torch.from_numpy(rows).to(dev)
    st = torch.tensor([[int(v), int(i)] for v, i in zip(
        gen.integers(-32768, 32768, ADPCM_ROWS),
        gen.integers(0, 89, ADPCM_ROWS))], dtype=torch.int32, device=dev)
    got = codec.encode(rows_t, st)
    out["encode_rows"] = {
        "rows": ADPCM_ROWS,
        "vs_plain": same(got, codec.encode_plain(rows_t, st)),
        "vs_select_plain": same(got, codec.encode_select_plain(rows_t, st)),
        "alternating_row_index": int(got[1][7, 1])}
    torch.cuda.synchronize()
    require(out["encode_rows"]["vs_plain"]
            and out["encode_rows"]["vs_select_plain"]
            and out["encode_rows"]["alternating_row_index"] == 88,
            f"adpcm encode, {ADPCM_ROWS} rows: {out['encode_rows']}")
    return out


def phase_byte_edge_kernels(torch):
    """K3 forward at the waterfall's N=4096, B=837 (on no path); fft_natural
    (K3's natural-order forward) at W's and X''s shapes and its sweep over
    every N; the ADPCM kernel, encode and decode, against its plain
    version on the card: on the 9 rows of a real waterfall chunk (W's
    first), through compress_fft_adpcm_rows on dB rows holding -inf, +inf,
    NaN and +-400 dB, on a stream in two chunks with the state carried, at
    W1's 48 000-sample audio chunk, and on the cases of
    codec_redesign_cases."""
    from csdr_tpu_torch.ops import adpcm, spectrum
    from csdr_tpu_torch.kernels import adpcm_cuda

    dev = torch.device("cuda")
    frames = W_CHUNK // W_EVERY
    # K3 in kernel order at W's shape: on no path since fft_natural
    # stores natural order itself
    case_k3 = dict(fft_case(torch, "fft_ko", W_FFT, frames, 41),
                   path="not on a path")
    # what W's fft_cc runs, and X''s fft_cc at its 22 frames a chunk
    case_nat = dict(fft_case(torch, "fft_natural", W_FFT, frames, 43),
                    path="W")
    case_xp = dict(fft_case(torch, "fft_natural", W_FFT, 22, 44),
                   path="X' fft_cc")
    emit("kernels", name="fft_natural", check="bit for bit "
         "ko_to_natural(fft_ko(x)) at every N, B = 1 and 37",
         **fft_natural_sweep(torch, 45))
    chains = adpcm_chains(torch)
    emit("kernels", name="adpcm_chain_probe", check="SM cycles a link of "
         "the chains that bound the codec (csrc/adpcm.cu)", **chains)
    pipe = waterfall_chain().to(dev)
    with torch.no_grad():
        _, outs = drive_blocks(pipe, pipe.init(dev),
                               torch.from_numpy(waterfall_u8(0)).to(dev))
    rows = outs[3]
    s16 = adpcm.compress_fft_s16(rows)
    zeros = torch.zeros((s16.shape[0], 2), dtype=torch.int32, device=dev)
    case_w = dict(adpcm_case(torch, "adpcm_encode", s16, zeros, chains),
                  path="W")
    packed, _ = adpcm_cuda.encode(s16, zeros)
    dec_w = adpcm_case(torch, "adpcm_decode", packed, zeros, chains)

    # dB rows with every edge of the saturating float32 -> int16 cast
    gen = np.random.default_rng(42)
    edge = gen.uniform(-130, -20, (4, W_FFT)).astype(np.float32)
    edge[0, :6] = [-np.inf, np.inf, np.nan, 400.0, -400.0, 327.675]
    edge[1, 0], edge[2, 0], edge[3, 0] = -np.inf, np.nan, 400.0
    edge[3, 100:120] = -400.0
    edge_t = torch.from_numpy(edge).to(dev)
    got = spectrum.compress_fft_adpcm_rows(edge_t, W_FFT)
    e16 = adpcm.compress_fft_s16(edge_t)
    want, _ = adpcm_cuda.encode_plain(
        e16, torch.zeros((4, 2), dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    edges_same = torch.equal(got, want)
    require(edges_same, "compress_fft_adpcm_rows: kernel differs from plain "
                        "on the edge rows")
    require(int(e16[0, 10]) == -32768 and int(e16[0, 11]) == 32767
            and int(e16[0, 12]) == 0 and int(e16[3, 0]) == 32767,
            "compress_fft_s16 does not saturate")

    # W1's audio chunk: a 1 kHz tone at 48 ksps with its noise
    t = np.arange(2 * AUDIO_RATE) / AUDIO_RATE
    audio = (0.5 * np.sin(2 * np.pi * 1000 * t)
             + 0.01 * gen.standard_normal(len(t)))
    a16 = torch.from_numpy(np.round(audio * 32767).astype(np.int16)).to(dev)
    stream_same = codec_stream_case(torch, a16[None, : 2 * ADPCM_CUT])
    require(stream_same, "adpcm: kernel differs from plain on a stream in "
                         "two chunks with the state carried")
    one = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    x1 = a16[None, :AUDIO_RATE].contiguous()
    case_w1 = dict(adpcm_case(torch, "adpcm_encode", x1, one, chains),
                   path="W1")
    p1, _ = adpcm_cuda.encode(x1, one)
    case_w1d = dict(adpcm_case(torch, "adpcm_decode", p1, one, chains),
                    path="W1")
    redesign = codec_redesign_cases(torch)
    for c in (case_k3, case_nat, case_xp, case_w, dec_w, case_w1, case_w1d):
        emit("kernels", **c)
    emit("kernels", name="adpcm", check="edges and a carried stream",
         edge_rows_bit_exact=edges_same, stream_two_chunks_bit_exact=
         stream_same, stream_chunk=ADPCM_CUT)
    emit("kernels", name="adpcm", check="saturating and long decoder rows, "
         "carried states out of range, encoder rows over two blocks; bit "
         "for bit with the state", **redesign)
    return [case_nat, case_w, case_w1, case_w1d]


def phase_waterfall_path(torch):
    """Path W: 10 chunks of 1 s of u8 I/Q at 2.4 Msps through the waterfall
    chain on the card, with every launch count zeroed just before and read
    just after: fft_natural (K3's natural-order forward) once and the
    codec once a chunk, each tone in its column, the card's bytes equal
    to the plain codec's on the card's own dB rows, the linear averaged
    power equal to the port's CPU run at W_POWER_BAR (and the share of
    rows whose bytes equal the CPU's, ungated); then the same through
    run_offline from the host array (the host clock with the u8 upload),
    bit for bit the first run."""
    from csdr_tpu_torch import run_offline
    from csdr_tpu_torch.kernels import adpcm_cuda
    from csdr_tpu_torch.ops import adpcm

    dev = torch.device("cuda")
    u8 = [waterfall_u8(c) for c in range(W_CHUNKS)]
    pipe = waterfall_chain().to(dev)

    def drive(device):
        p = pipe.to(device)
        state, rows, sent = p.init(device), [], []
        with torch.no_grad():
            for b in u8:
                state, outs = drive_blocks(p, state,
                                           torch.from_numpy(b).to(device))
                rows.append(outs[3])
                sent.append(outs[4])
        return torch.cat(rows), torch.cat(sent)

    reset_all()
    t0 = time.perf_counter()
    rows, sent = drive(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_all()
    nrows = W_CHUNKS * W_FPS
    require_launches(launches, {"fft_natural": W_CHUNKS,
                                "adpcm_encode": W_CHUNKS}, "path W")
    require(rows.shape == (nrows, W_FFT) and sent.shape == (
        nrows, (W_FFT + 10) // 2), f"path W: rows {tuple(rows.shape)}, "
                                   f"bytes {tuple(sent.shape)}")
    plain, _ = adpcm_cuda.encode_plain(adpcm.compress_fft_s16(rows), torch.zeros(
        (nrows, 2), dtype=torch.int32, device=dev))
    require(torch.equal(plain, sent), "path W: the card's bytes differ from "
                                      "the plain codec's on its own rows")
    db = rows.cpu().numpy()
    require(np.all(np.isfinite(db)), "path W: dB rows not finite")
    tone_cols = {}
    for f in W_TONES:
        col = (round(f * W_FFT) + W_FFT // 2) % W_FFT
        win = db[:, col - 8: col + 9]
        off = np.argmax(win, axis=1) - 8
        above = win.max(axis=1) - np.median(db, axis=1)
        require(np.all(np.abs(off) <= 1) and np.all(above > 20),
                f"path W: tone {f} not in column {col} (offsets "
                f"{sorted(set(off.tolist()))}, {above.min():.1f} dB above "
                f"the median)")
        tone_cols[str(f)] = {"column": col, "worst_offset": int(
            np.abs(off).max()), "min_db_above_median": float(above.min())}
    lint_pipeline(torch, "W", waterfall_chain(), u8[0])
    cpu_rows, cpu_sent = drive(torch.device("cpu"))
    pipe.to(dev)
    power_snr = require_match("path_W: card vs CPU linear averaged power",
                              10 ** (db / 10), 10 ** (cpu_rows.numpy() / 10),
                              W_POWER_BAR)
    same_rows = float(np.mean(np.all(sent.cpu().numpy() == cpu_sent.numpy(),
                                     axis=1)))
    reset_all()
    t0 = time.perf_counter()
    out = run_offline(pipe, np.concatenate(u8), block_size=2 * W_CHUNK)
    wall_ro = time.perf_counter() - t0
    launches_ro = launches_all()
    require_launches(launches_ro, {"fft_natural": W_CHUNKS,
                                   "adpcm_encode": W_CHUNKS},
                     "path W through run_offline")
    require(np.array_equal(out, sent.cpu().numpy()),
            "path W: run_offline's bytes differ from the first run's")
    emit("path", path="W", pipeline="convert_u8_c | fft_cc_block(4096, "
         "2867) | logaveragepower_block(-70, 4096, 93) | "
         "fft_exchange_sides_ff | compress_fft_adpcm_rows",
         chunks=W_CHUNKS, chunk=W_CHUNK, frames=W_CHUNK // W_EVERY,
         rows=nrows, launches=launches, tones=tone_cols,
         card_vs_cpu_power_snr_db=power_snr, power_bar_db=W_POWER_BAR,
         rows_bytes_equal_cpu_share=same_rows, drive_s=wall,
         run_offline_s=wall_ro,
         host_clock_msps=W_CHUNKS * W_CHUNK / wall_ro / 1e6)
    return {"launches": launches, "pipe": pipe, "u8": u8[:3],
            "wall": wall_ro}


def config1_u8(n: int) -> np.ndarray:
    """The verify skill's FM 1 kHz tone (75 kHz deviation) at 240 ksps,
    quantised to u8 I/Q."""
    return iq_to_u8(fm_tone(n, fs=W1_FS, carrier=0.0), 120.0)


def phase_config1_path(torch):
    """Path W1: 10 s of u8 I/Q through config1_chain on the card, the bytes
    decoded chunk by chunk by decode_block as a client would, launch
    counts zeroed just before and read just after: the codec once a chunk
    each way, the audio tone at 1 kHz, card vs CPU audio at AUDIO_BAR, the
    card's bytes equal to the plain codec's on the card's s16 over 2 x
    ADPCM_CUT samples (state carried), the decoded tone at 1 kHz."""
    from csdr_tpu_torch import Pipeline, VarOut
    from csdr_tpu_torch.kernels import adpcm_cuda
    from csdr_tpu_torch.ops import adpcm

    dev = torch.device("cuda")
    b = config1_u8(W1_CHUNKS * W1_CHUNK)
    chunks = [b[2 * c * W1_CHUNK: 2 * (c + 1) * W1_CHUNK]
              for c in range(W1_CHUNKS)]
    pipe = config1_chain()

    def drive(device, blocks):
        """The first ``blocks`` blocks over every chunk; with all four, the
        bytes decoded chunk by chunk as a client decodes them."""
        p = Pipeline(list(pipe.blocks)[:blocks]).to(device)
        state, dec = p.init(device), adpcm.decode_block()
        sd = dec.init(device)
        got = [[] for _ in range(blocks + 1)]
        with torch.no_grad():
            for chunk in chunks:
                state, outs = drive_blocks(p, state,
                                           torch.from_numpy(chunk).to(device))
                for k, y in enumerate(outs):
                    got[k].append(y.compact() if isinstance(y, VarOut)
                                  else y)
                if blocks == len(pipe.blocks):
                    sd, y = dec(sd, outs[-1])
                    got[-1].append(y)
        return [torch.cat(v).cpu().numpy() for v in got if v]

    reset_all()
    t0 = time.perf_counter()
    _, audio, s16, sent, back = drive(dev, 4)
    wall = time.perf_counter() - t0
    launches = launches_all()
    require_launches(launches, {"adpcm_encode": W1_CHUNKS,
                                "adpcm_decode": W1_CHUNKS}, "path W1")
    lint_pipeline(torch, "W1", config1_chain(), chunks[0])
    hz = tone_hz(audio)
    require(np.all(np.isfinite(audio)) and abs(hz - 1000.0) < 5.0,
            f"path W1: audio tone at {hz} Hz")
    require(len(sent) == len(s16) // 2 and len(back) == len(sent) * 2,
            "path W1: byte and sample counts")
    cpu_audio = drive(torch.device("cpu"), 2)[1]
    pipe.to(dev)
    snr = require_match("path_W1: card vs CPU audio", audio, cpu_audio,
                        AUDIO_BAR, frame=W1_CHUNK // 5)
    cut = torch.from_numpy(s16[: 2 * ADPCM_CUT]).to(dev)[None]
    st = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    p1, st = adpcm_cuda.encode_plain(cut[:, :ADPCM_CUT], st)
    p2, _ = adpcm_cuda.encode_plain(cut[:, ADPCM_CUT:], st)
    plain = torch.cat([p1, p2], 1)[0].cpu().numpy()
    require(np.array_equal(plain, sent[:ADPCM_CUT]),
            "path W1: the card's bytes differ from the plain codec's")
    dec_hz = tone_hz(back.astype(np.float32))
    require(abs(dec_hz - 1000.0) < 5.0,
            f"path W1: decoded tone at {dec_hz} Hz")
    emit("path", path="W1", pipeline="convert_u8_c | wfm_basic() | "
         "convert_f_s16 | paired_encode_block(), decode_block() at the "
         "client", chunks=W1_CHUNKS, chunk=W1_CHUNK, launches=launches,
         adpcm_launches_a_chunk={k: v / W1_CHUNKS for k, v in
                                 launches.items() if k.startswith("adpcm")},
         audio_samples=len(audio), bytes=len(sent), tone_hz=hz,
         decoded_tone_hz=dec_hz, card_vs_cpu_snr_db=snr,
         plain_codec_samples=2 * ADPCM_CUT, drive_s=wall,
         host_clock_msps=W1_CHUNKS * W1_CHUNK / wall / 1e6)
    return {"launches": launches, "pipe": pipe,
            "u8": chunks[:3], "wall": wall}


def phase_byte_edge_paths(torch):
    """Paths W and W1, then the cost of each a chunk."""
    paths = {"W": phase_waterfall_path(torch),
             "W1": phase_config1_path(torch)}
    dev = torch.device("cuda")
    for key, chunk, label in (("W", W_CHUNK, "waterfall"),
                              ("W1", W1_CHUNK, "config 1")):
        p = paths[key]
        xs = [torch.from_numpy(b).to(dev) for b in p["u8"]]
        tp = throughput(torch, p["pipe"], xs)
        tp["chunk_samples"] = chunk
        tp["msps"] = chunk / tp["step_ms"] / 1e3
        emit("throughput", path=key, pipeline=label, **tp,
             device_msps=chunk / tp["device_ms"] / 1e3,
             note="chunk: u8 bytes a step (2 a sample); msps: complex "
                  "samples over step_ms; " + TP_NOTE.replace(
                      "run_offline_msps", "the path line's host_clock_msps"))
    return {k: v["launches"] for k, v in paths.items()}


# ---------------------------------------------------------------------------
# the csdr-compatible CLI (paths X, X', X'')
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parent
X_STAGES = (["convert_u8_f"], ["shift_addition_cc", "-0.2"],
            ["fir_decimate_cc", "10", "0.05", "HAMMING"],
            ["fmdemod_quadri_cf"], ["fractional_decimator_ff", "5"],
            ["deemphasis_wfm_ff", "48000", "50e-6"], ["convert_f_s16"])
X_CPU_SECONDS = 2          # the CPU pipeline's share of X's input
X_CPU_FLIP_SHARE = 1e-3    # int16 samples card vs CPU that may differ by 1
X_CHUNK = 1 << 16          # the CLI's default chunk (CSDR_FIXED_BUFSIZE)
XP_SAMPLES = 16 * X_CHUNK + 97   # X' input: 16 chunks and an odd tail
XP_CODEC = X_CHUNK // 4 + 97    # X' codec input (its plain loop on the CPU)
XP_SCANS = X_CHUNK + 1001  # X''s Costas, PLL and RTTY stdin: a chunk, a tail
PLL_CLI = ["pll_cc", "2", "0.01"]
COSTAS_CLI = ["bpsk_costas_loop_cc", "0.01"]
RTTY_CLI = ["rtty_line_decoder_u8_u8"]
X_TIMEOUT = 300.0          # seconds any CLI process of X may take
NO_PUMP = {"normalized_timing_variance_u32_f", "shift_addition_cc_test",
           "--help"}       # device commands that read all stdin, no pump


# a CLI process whose steps run uncaptured (cli.STEP the block itself)
EAGER_CLI = ("import sys\nfrom csdr_tpu_torch import cli\n"
             "cli.STEP = lambda block, graphs: block\n"
             "sys.exit(cli.main(['csdr_tpu_torch', *sys.argv[1:]]))\n")


def cli_cmd(args, device="cuda", eager=False):
    head = ["-c", EAGER_CLI] if eager else ["-m", "csdr_tpu_torch.cli"]
    return [sys.executable, *head, *args, "--device", device]


def _read_timed(stream, sink, box):
    """Copy ``stream`` to the file ``sink``, noting when the first byte
    came (box["first"], perf_counter seconds)."""
    while True:
        d = stream.read1(1 << 16)
        if not d:
            break
        box.setdefault("first", time.perf_counter())
        sink.write(d)
    stream.close()


def run_pipeline(cmds, in_path: Path, out_path: Path, env=None) -> dict:
    """``cmds`` as one shell pipeline of processes, stdin from ``in_path``,
    the last stdout to ``out_path``: wall seconds, seconds to the first
    output byte, each exit code and standard error.  Every process is
    waited for or killed."""
    import threading

    procs, box = [], {}
    t0 = time.perf_counter()
    try:
        with open(in_path, "rb") as fin, open(out_path, "wb") as fout:
            for i, c in enumerate(cmds):
                procs.append(subprocess.Popen(
                    c, stdin=fin if i == 0 else procs[-1].stdout,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=ROOT,
                    env=env))
                if i:
                    procs[-2].stdout.close()   # the next process owns it
            reader = threading.Thread(target=_read_timed,
                                      args=(procs[-1].stdout, fout, box))
            reader.start()
            errs = [p.stderr.read().decode() for p in procs]
            rcs = [p.wait(timeout=X_TIMEOUT) for p in procs]
            reader.join(timeout=X_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    return {"rcs": rcs, "stderr": errs, "wall_s": wall,
            "first_byte_s": box.get("first", t0 + wall) - t0}


# a CLI process's start-up, piece by piece (startup_split): the monotonic
# clock after the interpreter starts, after torch is imported, after the
# card's context is up, after the kernel library is loaded (built once
# into build/ beside the package), after the CLI module is imported, and
# two runs of the command in process on one chunk of its input, the
# first with its blocks' imports, set-up and its step's warm-up and
# capture, the second warm
STARTUP_PROBE = """
import io, json, sys, time
t = [time.perf_counter()]
import torch
t.append(time.perf_counter())
torch.empty(1, device="cuda")
torch.cuda.synchronize()
t.append(time.perf_counter())
from csdr_tpu_torch.kernels import _build
_build.lib()
t.append(time.perf_counter())
from csdr_tpu_torch import cli
t.append(time.perf_counter())
data = open(sys.argv[1], "rb").read()
runs = []
for _ in range(2):
    saved = sys.stdin, sys.stdout
    sys.stdin = io.TextIOWrapper(io.BytesIO(data))
    sys.stdout = io.TextIOWrapper(io.BytesIO(), write_through=True)
    t0 = time.perf_counter()
    try:
        rc = cli.main(["csdr_tpu_torch", *sys.argv[2:], "--device", "cuda"])
        torch.cuda.synchronize()
    finally:
        sys.stdin, sys.stdout = saved
    runs.append(time.perf_counter() - t0)
print(json.dumps({"t": t, "runs": runs, "rc": rc}))
"""
STARTUP_STAGES = 2         # X's stages whose start-up is split


def startup_split(stage, in_path: Path, chunk_bytes: int, tmp: Path) -> dict:
    """Seconds of a CLI process of ``stage`` (startup_probe) on the first
    ``chunk_bytes`` of its input: interpreter start, torch import, CUDA
    context, kernel library load, CLI import, the command's first chunk
    (block imports and set-up, warm-up and capture, output) and the same
    again warm."""
    (tmp / "probe").write_bytes(in_path.read_bytes()[:chunk_bytes])
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", STARTUP_PROBE,
                        str(tmp / "probe"), *stage], capture_output=True,
                       text=True, cwd=ROOT, timeout=X_TIMEOUT)
    wall = time.perf_counter() - t0
    require(p.returncode == 0, f"path X start-up {stage}: {p.stderr[-400:]}")
    got = json.loads(p.stdout.strip().splitlines()[-1])
    t = got["t"]
    return {"stage": " ".join(stage), "process_s": wall,
            "interpreter_s": t[0] - t0, "torch_import_s": t[1] - t[0],
            "cuda_context_s": t[2] - t[1], "kernel_library_s": t[3] - t[2],
            "cli_import_s": t[4] - t[3], "first_chunk_s": got["runs"][0],
            "warm_chunk_s": got["runs"][1]}


def x_input() -> np.ndarray:
    """X's input: SECONDS of WFM's FM 1 kHz tone at 2.4 Msps (carrier at
    +0.2*fs) as rtl_sdr's u8 I/Q."""
    return iq_to_u8(fm_tone(SECONDS * FS), 127.0)


def phase_cli_pipeline(torch):
    """Path X: the csdr-fm pipeline as a shell pipeline of seven CLI
    processes on the card over SECONDS of u8 I/Q (48 MB), the default
    chunk, each stage's step captured; each stage alone on the same bytes
    first (its wall-clock rate; their outputs, chained, are also what the
    pipeline must give bit for bit), then the pipeline (its rate and the
    seconds to its first output byte), then the same pipeline with every
    step uncaptured (EAGER_CLI: the same audio bit for bit, its rate and
    first byte beside), then the pipeline with --device cpu on the first
    X_CPU_SECONDS: every int16 sample within 1 of the card's, at most
    X_CPU_FLIP_SHARE of them different; the 1 kHz tone dominates.  Last,
    fractional_decimator_ff 5 in process on its stage's input: its
    captures, replays and keys, no key captured twice."""
    import os
    import tempfile

    n = SECONDS * FS
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "x0").write_bytes(x_input().tobytes())
        stages = []
        for i, st in enumerate(X_STAGES):
            r = run_pipeline([cli_cmd(st)], tmp / f"x{i}", tmp / f"x{i + 1}")
            require(r["rcs"] == [0], f"path X: {st[0]} alone exited "
                                     f"{r['rcs']}: {r['stderr'][0][-600:]}")
            after = r["wall_s"] - r["first_byte_s"]
            stages.append({"stage": " ".join(st),
                           "input_bytes": (tmp / f"x{i}").stat().st_size,
                           "wall_s": r["wall_s"],
                           "first_byte_s": r["first_byte_s"],
                           "msps": n / r["wall_s"] / 1e6,
                           "msps_after_first_byte": n / after / 1e6
                           if after > 0 else None})
        alone = (tmp / f"x{len(X_STAGES)}").read_bytes()
        r = run_pipeline([cli_cmd(st) for st in X_STAGES], tmp / "x0",
                         tmp / "pipe")
        require(r["rcs"] == [0] * len(X_STAGES),
                f"path X: exit codes {r['rcs']}: "
                + " | ".join(e[-300:] for e in r["stderr"] if e))
        audio_b = (tmp / "pipe").read_bytes()
        require(audio_b == alone, "path X: the pipeline's audio differs from "
                                  "its stages run one after another")
        re_ = run_pipeline([cli_cmd(st, eager=True) for st in X_STAGES],
                           tmp / "x0", tmp / "eager")
        require(re_["rcs"] == [0] * len(X_STAGES),
                f"path X uncaptured: exit codes {re_['rcs']}: "
                + " | ".join(e[-300:] for e in re_["stderr"] if e))
        require((tmp / "eager").read_bytes() == audio_b,
                "path X: the uncaptured pipeline's audio differs")
        startup = [startup_split(st, tmp / f"x{i}", X_CHUNK * (
            1 if i == 0 else 8 if i < 4 else 4), tmp)
            for i, st in enumerate(X_STAGES[:STARTUP_STAGES])]
        fd = X_STAGES.index(["fractional_decimator_ff", "5"])
        with cli_setting() as made:
            rc_fd, _, err_fd, _ = cli_run(X_STAGES[fd],
                                          (tmp / f"x{fd}").read_bytes())
            fd_steps = require_steps("path X", X_STAGES[fd][0], list(made))
        require(rc_fd == 0, f"path X: {X_STAGES[fd]}: {err_fd[-400:]}")
        cut = X_CPU_SECONDS * FS * 2
        (tmp / "cpu0").write_bytes((tmp / "x0").read_bytes()[:cut])
        env = dict(os.environ, OMP_NUM_THREADS="1")
        rc = run_pipeline([cli_cmd(st, "cpu") for st in X_STAGES],
                          tmp / "cpu0", tmp / "cpu", env)
        require(rc["rcs"] == [0] * len(X_STAGES),
                f"path X on the CPU: exit codes {rc['rcs']}")
        cpu = np.frombuffer((tmp / "cpu").read_bytes(), np.int16)
    audio = np.frombuffer(audio_b, np.int16)
    hz = tone_hz(audio.astype(np.float32))
    require(len(audio) > SECONDS * AUDIO_RATE * 0.99 and abs(hz - 1000) < 5,
            f"path X: {len(audio)} samples, tone at {hz} Hz")
    require(len(cpu) > X_CPU_SECONDS * AUDIO_RATE * 0.99,
            f"path X on the CPU: {len(cpu)} samples")
    diff = np.abs(audio[: len(cpu)].astype(np.int32) - cpu)
    flips = float(np.mean(diff != 0))
    require(int(diff.max()) <= 1 and flips <= X_CPU_FLIP_SHARE,
            f"path X: card vs CPU int16 max |diff| {int(diff.max())}, "
            f"share differing {flips}")
    emit("path", path="X", pipeline=" | ".join(" ".join(s)
                                               for s in X_STAGES),
         input_mb=2 * n / 1e6, audio_samples=len(audio), tone_hz=hz,
         pipeline_wall_s=r["wall_s"], pipeline_msps=n / r["wall_s"] / 1e6,
         first_output_byte_s=r["first_byte_s"],
         pipeline_msps_after_first_byte=n / (r["wall_s"] - r[
             "first_byte_s"]) / 1e6,
         uncaptured={"wall_s": re_["wall_s"],
                     "msps": n / re_["wall_s"] / 1e6,
                     "first_output_byte_s": re_["first_byte_s"],
                     "msps_after_first_byte": n / (re_["wall_s"] - re_[
                         "first_byte_s"]) / 1e6, "audio_bit_for_bit": True},
         fractional_decimator_steps=fd_steps, startup_split=startup,
         stages_alone=stages,
         cpu_samples=len(cpu), cpu_wall_s=rc["wall_s"],
         card_vs_cpu_max_abs_diff=int(diff.max()),
         card_vs_cpu_share_differing=flips,
         smi=nvidia_smi_line(),
         note="msps: input complex samples over wall seconds, process "
              "start-up included; msps_after_first_byte: over the time "
              "after the stage's first output byte; uncaptured: the same "
              "pipeline with every step uncaptured; fractional_decimator_"
              "steps: its stage in process, captured; startup_split: "
              "seconds of a stage's process by piece (STARTUP_PROBE)")
    return {"pipeline_msps": n / r["wall_s"] / 1e6}


class _HookStdin:
    """stdin over bytes; ``hook(pos)`` runs before each read that starts
    at byte ``pos``."""

    def __init__(self, data: bytes, hook):
        self.buffer = self
        self.data, self.pos, self.hook = data, 0, hook

    def read(self, n=-1):
        self.hook(self.pos)
        end = len(self.data) if n is None or n < 0 else self.pos + n
        out = self.data[self.pos:end]
        self.pos += len(out)
        return out


def cli_run(argv, inp: bytes = b"", device="cuda", hook=None):
    """``csdr_tpu_torch.cli.main`` in this process, stdin and stdout
    swapped for temporary files (the fifo command selects on them) or
    for ``_HookStdin``: (exit code, stdout bytes, stderr text, wall s)."""
    import io
    import os
    import tempfile

    from csdr_tpu_torch import cli

    saved = (sys.stdin, sys.stdout, sys.stderr)
    err = io.StringIO()
    with tempfile.TemporaryFile() as fi, tempfile.TemporaryFile() as fo:
        if hook is None:
            fi.write(inp)
            fi.seek(0)
            sys.stdin = io.TextIOWrapper(open(os.dup(fi.fileno()), "rb"))
        else:
            sys.stdin = _HookStdin(inp, hook)
        sys.stdout = io.TextIOWrapper(open(os.dup(fo.fileno()), "wb"),
                                      write_through=True)
        sys.stderr = err
        t0 = time.perf_counter()
        try:
            rc = cli.main(["csdr_tpu_torch", *argv, "--device", device])
            sys.stdout.flush()
        finally:
            if device == "cuda":
                torch_sync()
            wall = time.perf_counter() - t0
            if hook is None:
                sys.stdin.close()
            sys.stdout.close()
            sys.stdin, sys.stdout, sys.stderr = saved
        fo.seek(0)
        return rc or 0, fo.read(), err.getvalue(), wall


def torch_sync():
    import torch
    torch.cuda.synchronize()


def pumped_chunks(samples: int, quantum: int, chunk: int = X_CHUNK) -> int:
    """Chunks the CLI's pump runs for ``samples`` input samples: whole
    chunks, and the EOF tail truncated to the quantum where any is left."""
    n = max(quantum, chunk // quantum * quantum)
    return samples // n + (1 if samples % n >= quantum else 0)


def _c64(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.complex64)


def keeping_steps():
    """A cli.STEP that makes the default captured step and keeps it, with
    the first input it is given: (the maker, the steps it made)."""
    from csdr_tpu_torch.core.graph import CapturedStep

    class Kept(CapturedStep):
        first = None

        def __call__(self, state, x):
            if self.first is None:
                self.first = x
            return super().__call__(state, x)

    kept = []

    def make(block, graphs):
        kept.append(Kept(block, graphs))
        return kept[-1]

    return make, kept


def chunk_cost(torch, step) -> dict:
    """A command's step on its first chunk, uncaptured (its block) and
    captured afresh: graph_cost's issued ms, device-only ms, busy share,
    host CUDA calls and lint, and the host clock of one chunk to a
    synchronize (median of 7, span min and max)."""
    from csdr_tpu_torch.core.graph import CapturedStep

    blk, x = step.fn, step.first
    out = {}
    for mode, fn in (("eager", blk),
                     ("graph", CapturedStep(blk, step.max_graphs))):
        init = (lambda: blk.init(x.device))
        cost = graph_cost(torch, fn, init, x)
        box = {"s": init()}

        def one(fn=fn, box=box):
            box["s"], _ = fn(box["s"], x)
            torch.cuda.synchronize()

        for _ in range(3):
            one()
        cost["host_ms"], cost["host_ms_span"] = host_ms(one)
        out[mode] = cost
    require(out["graph"]["lint_syncs"] == 0
            and out["graph"]["lint_uploads"] == 0,
            f"path X' {blk.name}: the captured step syncs or uploads")
    return out


def x_prime_case(name, argv, inp: bytes, want: dict, bar,
                 kind=np.complex64, match=None) -> dict:
    """One CLI command in process on the card, captured, with the launch
    counts zeroed just before and read just after (``want``: kernel ->
    launches), then with --device cpu on the same bytes: bit for bit (bar
    None), card vs CPU at ``bar`` dB, or by ``match(card, cpu)`` (a dict
    for the line; it raises on a mismatch); its step captured, no key
    twice; then its step's chunk_cost on the first chunk, eager and
    captured."""
    import torch

    make, kept = keeping_steps()
    reset_all()
    with cli_setting(make) as made:
        rc, out, err, wall = cli_run(argv, inp)
        steps = list(made)
    launches = launches_all()
    require(rc == 0 and len(out) > 0, f"path X' {name}: rc {rc}: "
                                      f"{err[-600:]}")
    require_launches(launches, want, f"path X' {name}")
    graph = require_steps("path X'", name, steps)
    rc, cpu, err, wall_cpu = cli_run(argv, inp, device="cpu")
    require(rc == 0, f"path X' {name} on the CPU: {err[-600:]}")
    require(len(cpu) == len(out), f"path X' {name}: {len(out)} bytes on the "
                                  f"card, {len(cpu)} on the CPU")
    line = {"command": " ".join(argv), "launches": launches,
            "card_s": wall, "cpu_s": wall_cpu, "out_bytes": len(out),
            **graph}
    if match is not None:
        line.update(match(out, cpu))
    elif bar is None:
        require(out == cpu, f"path X' {name}: card and CPU bytes differ")
        line["bit_exact"] = True
    else:
        snr = require_match(f"path_Xp_{name}: card vs CPU",
                            np.frombuffer(out, kind), np.frombuffer(cpu, kind),
                            bar)
        line.update(card_vs_cpu_snr_db=snr, bar_db=bar)
    with torch.no_grad():
        line["chunk"] = {k.fn.name: chunk_cost(torch, k) for k in kept}
    del kept
    emit("path", path="X'", **line, smi=nvidia_smi_line(),
         note="chunk: the command's step on its first chunk (x as the pump "
         "passes it), eager (the block) and graph (a CapturedStep of it): "
         "issued_ms, device_only_ms, host_api_calls as the graph lines; "
         "host_ms: host clock of one step to a synchronize")
    return {"launches": launches, "out": out}


def fd_run(argv, inp: bytes, lines: dict, first: bytes | None = None):
    """``argv`` in process on the card, captured, with ``--fd`` a pipe:
    ``first`` written before the start, each ``lines[byte]`` just before
    the read of the chunk that starts at that byte.  (rc, stdout, stderr,
    captures the chunk after each line made, the lines left unwritten,
    the steps' rows)."""
    import os

    make, kept = keeping_steps()
    r, w = os.pipe()
    if first:
        os.write(w, first)
    todo, marks = dict(lines), []

    def hook(pos):
        now = sum(k.captures for k in kept)
        if marks and len(marks[-1]) == 1:
            marks[-1].append(now)
        if pos in todo:
            marks.append([now])
            os.write(w, todo.pop(pos))

    try:
        with cli_setting(make) as made:
            rc, out, err, _ = cli_run([argv[0], "--fd", str(r), *argv[1:]],
                                      inp, hook=hook)
            steps = list(made)
    finally:
        os.close(r)
        os.close(w)
    return rc, out, err, [m[1] - m[0] for m in marks if len(m) == 2], \
        todo, steps


def retune_case(name, argv, inp: bytes, at: int, line: bytes,
                fresh_argv, first: bytes | None = None, skip: int = 0,
                fresh_first: bytes | None = None, captures: int = 0):
    """One live retune through --fd on the card, the command captured:
    ``line`` written just before the read of the chunk that starts at
    byte ``at`` (``first`` before the start); the chunk after it makes at
    most ``captures`` captures and no key is captured twice; the output
    after it against a fresh run of ``fresh_argv`` on the rest of the
    input (given ``fresh_first`` through --fd before its start), up to
    one constant phase, at RETUNE_BAR, from sample ``skip`` on."""
    rc, out, err, made, todo, steps = fd_run(argv, inp, {at: line}, first)
    require(rc == 0 and not todo and len(made) == 1,
            f"path X' retune {name}: rc {rc}, lines left {list(todo)}: "
            f"{err[-400:]}")
    graph = require_steps("path X' retune", name, steps)
    require(made[0] <= captures, f"path X' retune {name}: the retune made "
                                 f"{made[0]} captures, at most {captures}")
    if fresh_first is None:
        rc, fresh, err_f, _ = cli_run(fresh_argv, inp[at:])
    else:
        rc, fresh, err_f, *_ = fd_run(fresh_argv, inp[at:], {}, fresh_first)
    require(rc == 0, f"path X' fresh {name}: {err_f[-400:]}")
    y, f = _c64(out), _c64(fresh)
    after = y[len(y) - len(f):]
    require(len(f) > 0 and len(after) == len(f),
            f"path X' retune {name}: {len(y)} samples, fresh {len(f)}")
    rot = np.mean(after[skip:] * np.conj(f[skip:]))
    rot /= abs(rot)
    snr = snr_db(f[skip:] * rot, after[skip:])
    require(snr >= RETUNE_BAR, f"path X' retune {name}: after the retune "
                               f"{snr:.1f} dB against a fresh run < "
                               f"{RETUNE_BAR}")
    emit("path", path="X'", retune=name, command=" ".join(argv),
         retune_line=line.decode().strip(), at_byte=at,
         after_vs_fresh_snr_db=snr, bar_db=RETUNE_BAR,
         after_bit_for_bit=bool(np.array_equal(after[skip:], f[skip:])),
         retune_captures=made[0], retune_captures_at_most=captures,
         **graph, stderr=err.strip()[-200:])


RETUNE_BAR = 100.0         # the output after a retune against a fresh run


def xp_input() -> np.ndarray:
    """X''s input: WFM's FM 1 kHz tone at baseband (inside every X'
    command's passband) over complex noise 20 dB down, which fills the
    bands the tone does not, XP_SAMPLES at 2.4 Msps."""
    rng = np.random.default_rng(130)
    noise = 0.1 * (rng.standard_normal(XP_SAMPLES)
                   + 1j * rng.standard_normal(XP_SAMPLES))
    return (fm_tone(XP_SAMPLES, carrier=0.0) + noise).astype(np.complex64)


def phase_cli_kernels(torch):
    """Path X': each kernel command in process on the card (stdin and
    stdout swapped for byte buffers), launch counts zeroed just before
    and read just after, then the same command with --device cpu:
    fir_decimate_cc 10 0.05 HAMMING (K2; SSB_BAR, path C's bar for K2),
    bandpass_fir_fft_cc 0 0.2 0.05 (K3 forward and inverse; SSB_BAR, C's
    bar for K3), fft_cc 4096 2867 (fft_natural; W_POWER_BAR),
    fastddc_fwd_cc 16 (no kernel: its natural-order forward is
    torch.fft) then fastddc_inv_cc 0.1 16 on the card's spectra (K4;
    CHANNEL_BAR), encode_ima_adpcm_i16_u8 and decode_ima_adpcm_u8_i16
    (the codec on XP_CODEC samples; bit for bit), agc_ff 200 0.2 0.01
    0.0001 65536 5 (an attack wait: the exact scan's kernel once a chunk;
    bit for bit), bpsk_costas_loop_cc 0.01 (a BPSK stream the loop locks
    to; the first 256 samples at COSTAS_BARS[0] and |y| = |x|, as X''
    holds it), pll_cc 2 0.01 (a tone; SWEEP_BAR) and rtty_line_decoder_u8_u8
    (framed symbols; bit for bit), each over XP_SCANS samples, its kernel
    once a chunk.  K2 at the CLI's
    shape (D=10, T=79, kout=6553) against its plain version as the
    kernels phase runs it.  Then one live retune each through --fd:
    shift_addition_cc and fastddc_inv_cc."""
    from csdr_tpu_torch.ops import fastddc, fftfilt

    cf = xp_input().tobytes()
    k2 = dict(kernel_case(torch, "fir_decimate", 10, 79, X_CHUNK // 10,
                          0.0, 0.0, 5), path="X'")
    emit("kernels", **k2)
    got = {}
    got["fir_decimate_cc"] = x_prime_case(
        "fir_decimate_cc", ["fir_decimate_cc", "10", "0.05", "HAMMING"], cf,
        {"fir_decimate": pumped_chunks(XP_SAMPLES, 10)}, SSB_BAR)
    ins = fftfilt.bandpass_fir_fft_block(0.0, 0.2, 0.05).input_size
    nb = pumped_chunks(XP_SAMPLES, ins)
    got["bandpass_fir_fft_cc"] = x_prime_case(
        "bandpass_fir_fft_cc", ["bandpass_fir_fft_cc", "0", "0.2", "0.05"],
        cf, {"fft_ko": nb, "ifft_ko": nb}, SSB_BAR)
    got["fft_cc"] = x_prime_case(
        "fft_cc", ["fft_cc", str(W_FFT), str(W_EVERY)], cf,
        {"fft_natural": pumped_chunks(XP_SAMPLES, W_EVERY)}, W_POWER_BAR)
    ddc = fastddc.fastddc_init(0.05, 16)
    fwd = x_prime_case("fastddc_fwd_cc", ["fastddc_fwd_cc", "16"], cf,
                       {}, CHANNEL_BAR)["out"]
    got["fastddc_inv_cc"] = x_prime_case(
        "fastddc_inv_cc", ["fastddc_inv_cc", "0.1", "16"], fwd,
        {"fastddc_inv": pumped_chunks(len(fwd) // 8, ddc.fft_size)},
        CHANNEL_BAR)
    t = np.arange(XP_CODEC) / AUDIO_RATE
    s16 = np.round(16000 * np.sin(2 * np.pi * 1000 * t)).astype(np.int16)
    enc = x_prime_case("encode_ima_adpcm_i16_u8",
                       ["encode_ima_adpcm_i16_u8"], s16.tobytes(),
                       {"adpcm_encode": pumped_chunks(XP_CODEC, 2)}, None)
    got["encode_ima_adpcm_i16_u8"] = enc
    got["decode_ima_adpcm_u8_i16"] = x_prime_case(
        "decode_ima_adpcm_u8_i16", ["decode_ima_adpcm_u8_i16"],
        enc["out"], {"adpcm_decode": pumped_chunks(len(enc["out"]), 1)},
        None)
    # agc_ff with an attack wait: the exact scan's kernel once a chunk,
    # bytes equal to --device cpu's (the host loop)
    agc_in = agc_exact_input(AGC_EXACT_SAMPLES, 143).tobytes()
    got["agc_ff"] = x_prime_case(
        "agc_ff", AGC_EXACT_CLI, agc_in,
        {"agc_ff_scan": pumped_chunks(AGC_EXACT_SAMPLES, 1)}, None)
    # the carrier loops and the RTTY decoder: one kernel a chunk, bytes
    # against --device cpu's (the plain loops) as X'' holds them
    scans = pumped_chunks(XP_SCANS, 1)
    bpsk_in = scan_bpsk(XP_SCANS, 144).tobytes()
    got["bpsk_costas_loop_cc"] = x_prime_case(
        "bpsk_costas_loop_cc", COSTAS_CLI, bpsk_in, {"costas_scan": scans},
        None, match=lambda out, cpu: sweep_match("bpsk_costas_loop_cc", out,
                                                 cpu, bpsk_in))
    got["pll_cc"] = x_prime_case(
        "pll_cc", PLL_CLI, scan_tone(XP_SCANS, 145).tobytes(),
        {"pll_scan": scans}, SWEEP_BAR, kind=np.float32)
    got["rtty_line_decoder_u8_u8"] = x_prime_case(
        "rtty_line_decoder_u8_u8", RTTY_CLI,
        rtty_symbols(XP_SCANS, 146).tobytes(), {"baudot_scan": scans}, None)

    # live retunes, each command captured: shift_addition_cc half way (a
    # new rate is a new key: one capture), fastddc_inv_cc at its third
    # chunk (the rows rewritten in place: none), bandpass_fir_fft_cc at
    # its fourth (the taps' spectra copied into the block's buffers: none,
    # compared past the old band's overlap) and squelch_and_smeter_cc
    # (a new level, a state leaf on the card: none)
    retune_case("shift_addition_cc", ["shift_addition_cc", "0.1"], cf,
                XP_SAMPLES // X_CHUNK // 2 * X_CHUNK * 8, b"-0.2\n",
                ["shift_addition_cc", "-0.2"], captures=1)
    per = X_CHUNK // ddc.fft_size * ddc.fft_size * 8
    retune_case("fastddc_inv_cc", ["fastddc_inv_cc", "16"], fwd,
                2 * per, b"-0.3\n", ["fastddc_inv_cc", "-0.3", "16"],
                first=b"0.1\n")
    retune_case("bandpass_fir_fft_cc", ["bandpass_fir_fft_cc", "0.05"], cf,
                3 * (X_CHUNK // ins * ins) * 8, b"-0.4 -0.2\n",
                ["bandpass_fir_fft_cc", "-0.4", "-0.2", "0.05"],
                first=b"0.0 0.2\n", skip=ins)
    retune_case("squelch_and_smeter_cc", ["squelch_and_smeter_cc", "1", "1"],
                squelch_input().tobytes(), 4 * X_CHUNK * 8,
                f"{SQUELCH_LEVEL}\n".encode(),
                ["squelch_and_smeter_cc", "1", "1"],
                fresh_first=f"{SQUELCH_LEVEL}\n".encode())
    return k2, {k: v["launches"] for k, v in got.items()}


SQUELCH_LEVEL = 0.002      # X''s squelch retune: closes its quiet chunks


def squelch_input() -> np.ndarray:
    """The squelch retune's input: 8 chunks of X_CHUNK complex noise, the
    odd ones 20 dB down (power 0.02 and 0.0002, either side of
    SQUELCH_LEVEL)."""
    rng = np.random.default_rng(131)
    x = 0.1 * (rng.standard_normal(8 * X_CHUNK)
               + 1j * rng.standard_normal(8 * X_CHUNK))
    x.reshape(8, -1)[1::2] *= 0.1
    return x.astype(np.complex64)


def sweep_cases() -> dict:
    """tests/test_cli_smoke.py's CASES, rebuilt here without importing
    csdr_tpu (the test file does): the same seeded inputs, arguments and
    output expectations; tests/test_torch_cli_sweep.py holds the two
    tables equal."""
    n = 4096
    rng = np.random.default_rng(0)
    f32 = (0.3 * rng.standard_normal(n)).astype(np.float32).tobytes()
    cf64 = np.stack([0.3 * rng.standard_normal(n),
                     0.3 * rng.standard_normal(n)],
                    -1).astype(np.float32).tobytes()
    u8 = (rng.integers(0, 2, n)).astype(np.uint8).tobytes()
    s16 = (rng.integers(-1000, 1000, n)).astype(np.int16).tobytes()
    return {
        "convert_u8_f": ([], bytes(range(256)) * 16, True),
        "convert_f_u8": ([], f32, True),
        "convert_s8_f": ([], u8, True),
        "convert_f_s8": ([], f32, True),
        "convert_s16_f": ([], s16, True),
        "convert_f_s16": ([], f32, True),
        "convert_s24_f": ([], u8 * 3, True),
        "convert_f_s24": ([], f32, True),
        "convert_f_samplerf": (["100"], f32, True),
        "realpart_cf": ([], cf64, True),
        "mono2stereo_s16": ([], s16, True),
        "stereo2mono_s16": ([], s16, True),
        "clone": ([], u8, True),
        "setbuf": (["1024"], u8, True),
        "through": ([], f32, True),
        "dump_f": ([], f32[:64], True),
        "dump_u8": ([], u8[:64], True),
        "yes_f": (["1.0", "64"], b"", True),
        "tee": (["/dev/null"], u8, True),
        "fifo": (["256", "16"], u8, True),
        "flowcontrol": (["1000000", "100"], u8[:2048], True),
        "none": ([], b"", False),
        "gain_ff": (["2.0"], f32, True),
        "limit_ff": ([], f32, True),
        "clipdetect_ff": ([], f32, True),
        "detect_nan_ff": ([], f32, True),
        "dcblock_ff": ([], f32, True),
        "fastdcblock_ff": ([], f32, True),
        "add_n_zero_samples_at_beginning_f": (["16"], f32, True),
        "add_const_cc": (["0.1", "0.2"], cf64, True),
        "shift_math_cc": (["0.1"], cf64, True),
        "shift_addition_cc": (["0.1"], cf64, True),
        "shift_table_cc": (["0.1", "1024"], cf64, True),
        "shift_addfast_cc": (["0.1"], cf64, True),
        "shift_unroll_cc": (["0.1"], cf64, True),
        "shift_addition_fc": (["0.1"], f32, True),
        "shift_addition_cc_test": ([], b"", False),
        "decimating_shift_addition_cc": (["0.1", "4"], cf64, True),
        "fir_decimate_cc": (["4", "0.05", "HAMMING"], cf64, True),
        "fir_interpolate_cc": (["4", "0.05", "HAMMING"], cf64, True),
        "plain_interpolate_cc": (["4"], cf64, True),
        "rational_resampler_ff": (["5", "2"], f32, True),
        "suboptimal_rational_resampler_ff": (["5", "2"], f32, True),
        "fractional_decimator_ff": (["2.5"], f32, True),
        "old_fractional_decimator_ff": (["2.5"], f32, True),
        "bandpass_fir_fft_cc": (["0.0", "0.2", "0.05"], cf64 * 4, True),
        "peaks_fir_cc": (["33", "0.1"], cf64, True),
        "pulse_shaping_filter_cc": (["RRC", "8", "33", "0.25"], cf64, True),
        "firdes_lowpass_f": (["0.1", "21"], b"", True),
        "firdes_bandpass_c": (["-0.1", "0.1", "21"], b"", True),
        "firdes_peak_c": (["0.1", "21"], b"", True),
        "firdes_pulse_shaping_filter_f": (["RRC", "8", "33", "0.25"], b"",
                                          True),
        "fmdemod_atan_cf": ([], cf64, True),
        "fmdemod_quadri_cf": ([], cf64, True),
        "amdemod_cf": ([], cf64, True),
        "amdemod_estimator_cf": ([], cf64, True),
        "deemphasis_wfm_ff": (["48000", "50e-6"], f32, True),
        "deemphasis_nfm_ff": (["8000"], f32, True),
        "fmmod_fc": ([], f32, True),
        "dsb_fc": (["0.0"], f32, True),
        "add_dcoffset_cc": ([], cf64, True),
        "fixed_amplitude_cc": (["0.5"], cf64, True),
        "agc_ff": ([], f32, True),
        "fastagc_ff": ([], f32 * 4, True),
        "simple_agc_cc": (["0.01"], cf64, True),
        "squelch_and_smeter_cc": (["1", "1"], cf64, True),
        "fft_cc": (["256", "256"], cf64, True),
        "fft_fc": (["256", "256"], f32, True),
        "logpower_cf": (["0"], cf64, True),
        "logaveragepower_cf": (["0", "256", "2"], cf64, True),
        "fft_exchange_sides_ff": (["256"], f32, True),
        "fft_one_side_ff": (["256"], f32, True),
        "compress_fft_adpcm_f_u8": (["256"], f32, True),
        "encode_ima_adpcm_i16_u8": ([], s16, True),
        "decode_ima_adpcm_u8_i16": ([], u8, True),
        "psk31_varicode_encoder_u8_u8": ([], b"HELLO", True),
        "psk31_varicode_decoder_u8_u8": ([], u8, False),
        "differential_encoder_u8_u8": ([], u8, True),
        "differential_decoder_u8_u8": ([], u8, True),
        "psk_modulator_u8_c": (["2"], u8, True),
        "psk31_interpolate_sine_cc": (["8"], cf64, True),
        "duplicate_samples_ntimes_u8_u8": (["1", "4"], u8, True),
        "pack_bits_1to8_u8_u8": ([], u8, True),
        "pack_bits_8to1_u8_u8": ([], u8, True),
        "invert_u8_u8": ([], u8, True),
        "binary_slicer_f_u8": ([], f32, True),
        "generic_slicer_f_u8": (["4"], f32, True),
        "dbpsk_decoder_c_u8": ([], cf64, True),
        "bfsk_demod_cf": (["0.2", "33"], cf64, True),
        "timing_recovery_cc": (["GARDNER", "8"], cf64, True),
        "bpsk_costas_loop_cc": (["0.01"], cf64, True),
        "pll_cc": (["2", "0.01"], cf64, True),
        "normalized_timing_variance_u32_f": (
            ["8", "0"], np.arange(0, 512, 8, dtype=np.uint32).tobytes(),
            False),
        "serial_line_decoder_f_u8": (["8"], f32, False),
        "pattern_search_u8_u8": (["4", "1", "0", "1"], u8, False),
        "syncword_search": (["af", "8"], u8, False),
        "awgn_cc": (["10"], cf64, True),
        "octave_complex_c": (["16", "32"], cf64, True),
        "_fft2octave": (["256"], cf64, True),
        "rtty_line_decoder_u8_u8": ([], u8, False),
        "rtty_baudot2ascii_u8_u8": ([], u8, False),
        "fastddc_fwd_cc": (["4"], cf64 * 2, True),
        "--help": ([], b"", False),
    }


# output wire format of the sweep's float commands (the rest compare as
# bytes or text)
SWEEP_F32 = set("""convert_u8_f convert_s8_f convert_s16_f convert_s24_f
realpart_cf gain_ff limit_ff clipdetect_ff detect_nan_ff dcblock_ff
fastdcblock_ff rational_resampler_ff suboptimal_rational_resampler_ff
fractional_decimator_ff old_fractional_decimator_ff fmdemod_atan_cf
fmdemod_quadri_cf amdemod_cf amdemod_estimator_cf deemphasis_wfm_ff
deemphasis_nfm_ff agc_ff fastagc_ff logpower_cf logaveragepower_cf
fft_exchange_sides_ff fft_one_side_ff bfsk_demod_cf pll_cc
normalized_timing_variance_u32_f add_n_zero_samples_at_beginning_f through
yes_f""".split())
SWEEP_C64 = set("""add_const_cc shift_math_cc shift_addition_cc shift_table_cc
shift_addfast_cc shift_unroll_cc shift_addition_fc
decimating_shift_addition_cc fir_decimate_cc fir_interpolate_cc
plain_interpolate_cc bandpass_fir_fft_cc peaks_fir_cc
pulse_shaping_filter_cc fmmod_fc dsb_fc add_dcoffset_cc fixed_amplitude_cc
simple_agc_cc squelch_and_smeter_cc fft_cc fft_fc psk_modulator_u8_c
psk31_interpolate_sine_cc timing_recovery_cc bpsk_costas_loop_cc awgn_cc
fastddc_fwd_cc""".split())
SWEEP_BAR = 100.0          # float outputs card vs CPU, dB
NOISE_SOURCES = ("uniform_noise_f", "gaussian_noise_c")


def sweep_match(name, out, cpu, x: bytes) -> dict:
    """The card's output of ``name`` against the CPU's: bit for bit for
    bytes, integers and text (shift_addition_cc_test's error vectors
    within 0.5 dB); floats at SWEEP_BAR; Costas at its first bar over 256
    samples and |y| = |x| (a rotation; the loop does not lock to noise);
    awgn_cc by its noise power and mean."""
    import re

    if name in SWEEP_F32 or name in SWEEP_C64:
        dt = np.float32 if name in SWEEP_F32 else np.complex64
        a, b = np.frombuffer(cpu, dt), np.frombuffer(out, dt)
        require(len(a) == len(b), f"path X'' {name}: {len(b)} samples on the "
                                  f"card, {len(a)} on the CPU")
        if name == "awgn_cc":
            r = 10 ** 0.5
            xs = _c64(x) * r / (r + 1)
            p = [float(np.mean(np.abs(y - xs) ** 2)) for y in (a, b)]
            want = 2 * (0.707 / (r + 1)) ** 2
            ok = all(abs(v / want - 1) < 0.05 for v in p) and abs(
                np.mean(b - xs)) < 0.01
            require(ok, f"path X'' awgn_cc: noise power {p}, want {want}")
            return {"noise_power": p, "noise_power_want": want}
        if name == "bpsk_costas_loop_cc":
            first = snr_db(a[:256], b[:256])
            ok = first >= COSTAS_BARS[0] and np.allclose(
                np.abs(b), np.abs(a), rtol=1e-5, atol=1e-7)
            require(ok, f"path X'' costas: first 256 at {first:.1f} dB")
            return {"snr_db_first_256": first,
                    "snr_db_all": snr_db(a, b)}
        snr = snr_db(a, b)
        require(snr >= SWEEP_BAR, f"path X'' {name}: card vs CPU {snr:.1f} "
                                  f"dB < {SWEEP_BAR}")
        return {"snr_db": snr}
    if name == "shift_addition_cc_test":
        num = re.compile(r"-?\d+\.\d+ dB")
        la, lb = cpu.decode().splitlines(), out.decode().splitlines()
        ok = len(la) == len(lb) == 2 and all(
            num.sub("", u) == num.sub("", v) and abs(
                float(num.search(u).group()[:-3])
                - float(num.search(v).group()[:-3])) < 0.5
            for u, v in zip(la, lb))
        require(ok, f"path X'' shift_addition_cc_test: {lb} vs {la}")
        return {"lines": lb}
    require(out == cpu, f"path X'' {name}: card and CPU bytes differ")
    return {"bit_exact": True}


# the pumped commands of X' and X'' whose pump runs uncaptured on the card,
# each at a site that says why (csdr_tpu pumps them unjitted: a host read
# or a fresh generator a chunk, an outer apply around a step of its own),
# with the captured steps each still makes
UNCAPTURED = {"clipdetect_ff": 0, "detect_nan_ff": 0, "awgn_cc": 0,
              "fastddc_inv_cc": 1}
SWEEP_MIN_CHUNKS = 3       # chunks of each pumped command's stdin


def eager_step(block, graphs):
    """cli.STEP for an uncaptured run on the card: the block itself."""
    return block


@contextlib.contextmanager
def cli_setting(step=None, bufsize=None):
    """csdr_tpu_torch.cli's step maker and CSDR_FIXED_BUFSIZE for a run in
    this process; each step's row of cli.STEPS is the run's."""
    import os

    from csdr_tpu_torch import cli

    saved = (cli.STEP, os.environ.get("CSDR_FIXED_BUFSIZE"))
    cli.STEP = step or cli.CapturedStep
    if bufsize:
        os.environ["CSDR_FIXED_BUFSIZE"] = str(bufsize)
    cli.STEPS.clear()
    try:
        yield cli.STEPS
    finally:
        cli.STEP = saved[0]
        if saved[1] is None:
            os.environ.pop("CSDR_FIXED_BUFSIZE", None)
        else:
            os.environ["CSDR_FIXED_BUFSIZE"] = saved[1]


def require_steps(what: str, name: str, steps: list) -> dict:
    """A command's steps (cli.STEPS rows): each captured, or, for a
    command of UNCAPTURED, its pump's alone uncaptured beside the captured
    steps it names; no capture of a key a step had dropped (none after the
    first lap of its key cycle).  Their captures, replays and keys."""
    captured = [r for r in steps if r["captured"]]
    want = (1, UNCAPTURED[name]) if name in UNCAPTURED else (0, len(steps))
    require(steps and (len(steps) - len(captured), len(captured)) == want,
            f"{what} {name}: steps {steps}; uncaptured and captured "
            f"steps want {want}")
    for r in captured:
        require(r["recaptures"] == 0,
                f"{what} {name}: {r['recaptures']} captures of a key "
                "dropped earlier")
    return {"captured": [r["captured"] for r in steps],
            "captures": sum(r.get("captures", 0) for r in steps),
            "replays": sum(r.get("replays", 0) for r in steps),
            "keys": sum(r.get("keys", 0) for r in steps),
            "max_graphs": [r.get("max_graphs") for r in steps]}


def phase_cli_sweep(torch):
    """Path X'': every command of the smoke sweep (tests/test_cli_smoke.py's
    CASES, sweep_cases()) in process on the card and with --device cpu on
    the same stdin, at a CSDR_FIXED_BUFSIZE that gives each pumped command
    at least SWEEP_MIN_CHUNKS chunks (a third of its stdin as 8-byte
    samples, which the pump rounds down to its quantum; a command that pins
    its chunk keeps it): exit 0, the same stderr, and the outputs matched
    by sweep_match; the pump's device check held on every chunk of every
    pumped command (a chunk output off the card fails the command).  Each
    pumped command runs captured (cli.STEP the default, one CUDA graph a
    key) and uncaptured (cli.STEP = eager_step) on the card: the same
    bytes and stderr bit for bit; every step captured unless its command
    is one of UNCAPTURED, and no key captured twice.  Then the endless
    noise sources stopped after 4 writes, by their statistics, and
    fft_benchmark timed with CUDA events over a captured FFT."""
    from csdr_tpu_torch import cli

    rows, total = [], {"graph": 0.0, "eager": 0.0}
    for name, (args, inp, expect) in sweep_cases().items():
        pumped = name not in cli.HOST_ONLY and name not in NO_PUMP
        bufsize = max(1, len(inp) // 8 // SWEEP_MIN_CHUNKS) if pumped \
            else None
        before = cli.PUMP_CHECKS["chunks"]
        with cli_setting(bufsize=bufsize) as made:
            rc, out, err, wall = cli_run([name, *args], inp)
            steps = list(made)
        checked = cli.PUMP_CHECKS["chunks"] - before
        require(rc == 0, f"path X'' {name}: rc {rc}: {err[-600:]}")
        require(len(out) > 0 or not expect, f"path X'' {name}: no output")
        require(checked >= SWEEP_MIN_CHUNKS or not pumped,
                f"path X'' {name}: the pump checked {checked} chunks on the "
                f"card, want {SWEEP_MIN_CHUNKS}")
        line = {"bufsize": bufsize, "pump_chunks_checked": checked}
        if pumped:
            line.update(require_steps("path X''", name, steps))
            with cli_setting(eager_step, bufsize):
                rc, eager, err_e, wall_e = cli_run([name, *args], inp)
            require(rc == 0 and eager == out,
                    f"path X'' {name}: the captured run's bytes differ from "
                    f"the uncaptured run's (rc {rc}, {len(out)} and "
                    f"{len(eager)} bytes)")
            require(err_e == err, f"path X'' {name}: stderr captured "
                    f"{err[-300:]!r}, uncaptured {err_e[-300:]!r}")
            line.update(eager_bit_for_bit=True, eager_s=wall_e)
            total["eager"] += wall_e
        with cli_setting(bufsize=bufsize):
            rc, cpu, err_cpu, wall_cpu = cli_run([name, *args], inp, "cpu")
        require(rc == 0, f"path X'' {name} on the CPU: {err_cpu[-600:]}")
        if name == "shift_addition_cc_test":
            require(err.count("\n") == err_cpu.count("\n"),
                    f"path X'' {name}: stderr lines differ")
        elif name != "--help":
            require(err == err_cpu, f"path X'' {name}: stderr differs: "
                                    f"{err[-300:]!r} vs {err_cpu[-300:]!r}")
        got = sweep_match(name, out, cpu, inp)
        total["graph"] += wall
        rows.append(name)
        emit("sweep", command=name, args=args, card_s=wall, cpu_s=wall_cpu,
             out_bytes=len(out), **line, **got)
    for name in NOISE_SOURCES:
        stats = noise_source_stats(name)
        emit("sweep", command=name, **stats)
    with cli_setting() as made:
        rc, _, err, wall = cli_run(["fft_benchmark", "4096", "200"])
        steps = list(made)
    require(rc == 0 and "seconds each" in err, f"fft_benchmark: {err}")
    got = require_steps("fft_benchmark", "fft_benchmark", steps)
    require(got["captures"] == 1 and got["replays"] == 200,
            f"fft_benchmark: {got['captures']} captures, {got['replays']} "
            "replays")
    emit("sweep", command="fft_benchmark 4096 200", card_s=wall,
         stderr=err.strip().splitlines(), **got)
    emit("path", path="X''", commands=len(rows),
         card_s_total=total["graph"], eager_card_s_total=total["eager"],
         pump_chunks_checked=cli.PUMP_CHECKS["chunks"])


class _Enough(Exception):
    pass


class _Sink:
    """stdout that stops an endless source after ``limit`` bytes."""

    def __init__(self, limit):
        self.buffer, self.parts, self.limit = self, [], limit

    def write(self, b):
        self.parts.append(bytes(b))
        if sum(map(len, self.parts)) >= self.limit:
            raise _Enough

    def flush(self):
        pass


def noise_source_stats(name) -> dict:
    """``name`` on the card stopped after 4 writes of 65 536 samples:
    uniform on [-1, 1) with variance 1/3, or unit-variance complex
    gaussian parts; each write its own draw."""
    from csdr_tpu_torch import cli

    dt = np.float32 if name == "uniform_noise_f" else np.complex64
    saved = sys.stdout
    sink = sys.stdout = _Sink(4 * 65536 * np.dtype(dt).itemsize)
    try:
        cli.main(["csdr_tpu_torch", name, "--device", "cuda"])
        raise SmokeFailure(f"{name} ended")
    except _Enough:
        pass
    finally:
        sys.stdout = saved
    y = np.frombuffer(b"".join(sink.parts), dt)
    w = y.reshape(4, -1)
    if dt == np.float32:
        ok = y.min() >= -1 and y.max() < 1 and abs(y.mean()) < 0.01 and \
            abs(y.var() - 1 / 3) < 0.01
        stats = {"mean": float(y.mean()), "var": float(y.var())}
    else:
        ok = all(abs(p.mean()) < 0.01 and abs(p.var() - 1) < 0.02
                 for p in (y.real, y.imag))
        stats = {"var_re": float(y.real.var()), "var_im": float(y.imag.var())}
    require(ok and not np.array_equal(w[0], w[1]),
            f"{name}: statistics {stats}")
    return stats


def phase_cli(torch):
    """Paths X, X', X''."""
    x = phase_cli_pipeline(torch)
    k2, launches = phase_cli_kernels(torch)
    phase_cli_sweep(torch)
    return x, k2, launches


def _pre_agc(make):
    """A receiver's blocks before its AGC (SSB's and AM's first three)."""
    from csdr_tpu_torch import Pipeline
    pipe = make()
    return Pipeline(list(pipe.blocks)[:3], name=f"{pipe.name} before its AGC")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    return run(torch)


def run(torch) -> int:
    """Every phase, in order; ``torch`` is the torch module."""
    from csdr_tpu_torch.kernels import _build

    smi = phase_env(torch, _build)
    probe_row, probe_launches = phase_measure(torch)
    cases, _ = phase_kernels(torch)
    new_cases = phase_fastddc_kernels(torch)
    poly_cases = phase_poly_kernels(torch)
    x, launches, launches_u, wall, chunks = phase_path(torch)
    phase_throughput(torch, x, wall, chunks)
    paths = phase_fastddc_paths(torch)
    ssb = phase_ssb_path(torch)
    phase_new_throughput(torch, paths, ssb)
    launches_p = phase_poly_path(torch)
    receivers = phase_receiver_paths(torch)
    phase_receiver_throughput(torch, receivers)
    agc_rows = phase_agc_kernels(torch, receivers)
    agc_exact_rows = phase_agc_exact(torch)
    ted_cases = phase_ted_kernels(torch)
    scan_rows = phase_scan_kernels(torch)
    banks, gc_row = phase_bank_paths(torch)
    phase_bank_throughput(torch, banks)
    mesh = phase_mesh_paths(torch, banks)
    g_launches = {k: b["launches"] for k, b in banks.items()}
    del banks
    phase_graph(torch)
    servers, server_cases = phase_server_paths(torch)
    quiet_server(torch)
    edge_cases = phase_byte_edge_kernels(torch)
    edge = phase_byte_edge_paths(torch)
    _, k2_cli, cli_launches = phase_cli(torch)
    phase_measure_report()

    # launches of each kernel on the path that gives it its shape: K1 from
    # wfm_advanced, K2 from the unfused chain and from C, K3 forward from B
    # and C, K3 inverse from C, K4 from A, K5 from P, K2 at T=81 from D,
    # K2 at D=16/T=79 from the td server, K3's natural-order forward at
    # N=4096 and the codec's encoder on 9 rows from W, the codec both
    # ways on one audio stream from W1, the TED from G (and G', M, M'),
    # the AGC from E (and F), the Costas loop from G_c (and X'), the PLL
    # and the Baudot decoder from X' at the CLI's chunk
    paths_of = {
        "D": ("D: nfm_receiver(decimation=50, audio_rate=48000)",
              receivers["D"][0]),
        "E": ("E: ssb_receiver(0.0, 0.1, 0.05, decimation=50) (agc_on=True)",
              receivers["E"][0]),
        "wfm": ("wfm_advanced(shift_rate=-0.2)", launches),
        "wfm_unfused": ("wfm_advanced(shift_rate=-0.2, fuse_shift=False)",
                        launches_u),
        "A": ("A: fastddc_channelizer_block(ddc16)", paths["A"][0]),
        "B": ("B: fastddc50 fwd (kernel order) | classed inverse",
              paths["B"][0]),
        "C": ("C: ssb_receiver(agc_on=False)", ssb[0]),
        "G": ("G: build_ddc_bpsk31_bank(64 rates, decimation=50, sps=256)",
              g_launches["G"]),
        "P": ("P: fir_decimate_poly_or_plain, D=10, T=1023", launches_p),
        "S''": ("S'': DdcdServer(16, 0.05, max_channels=8, method='td', "
                "frames=64)", servers["S''"]["launches"]),
        "W": ("W: convert_u8_c | fft_cc_block(4096, 2867) | "
              "logaveragepower_block(-70, 4096, 93) | fft_exchange_sides_ff "
              "| compress_fft_adpcm_rows", edge["W"]),
        "W1": ("W1: convert_u8_c | wfm_basic() | convert_f_s16 | "
               "paired_encode_block(), decode_block() at the client",
               edge["W1"]),
        "X'": ("X': python -m csdr_tpu_torch.cli fir_decimate_cc 10 0.05 "
               "HAMMING, in process, 65 536-sample chunks",
               cli_launches["fir_decimate_cc"]),
        "X' agc_ff": ("X': python -m csdr_tpu_torch.cli " + " ".join(
            AGC_EXACT_CLI) + ", in process, 65 536-sample chunks",
            cli_launches["agc_ff"]),
        "G_c": ("G_c: build_ddc_bpsk31_bank(64 rates, decimation=50, "
                "sps=256, use_costas=True)", gc_row["launches_path"]),
        "X' pll_cc": ("X': python -m csdr_tpu_torch.cli " + " ".join(
            PLL_CLI) + ", in process, 65 536-sample chunks",
            cli_launches["pll_cc"]),
        "X' rtty": ("X': python -m csdr_tpu_torch.cli " + " ".join(
            RTTY_CLI) + ", in process, 65 536-symbol chunks",
            cli_launches["rtty_line_decoder_u8_u8"]),
        "measure": ("measure: utils/roofline.measure_fp32_flops (the FP32 "
                    "ceiling; launches captured in its CUDA graphs)",
                    probe_launches)}
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "path")
    # G and S' run K3 forward at B's shape, G' and S run K4 at A's
    # the CLI's kernel commands of X' (csdr_tpu_torch.cli in process):
    # K3 at N=256 through bandpass_fir_fft_cc, at N=4096 through fft_cc,
    # K4 at D=16 through fastddc_inv_cc, the codec both ways
    xp = {k: {"X' " + k: v} for k, v in cli_launches.items()}
    also = {("shift_fir_decimate", "wfm"): {"M'' 1x1": mesh["M'' 1x1"],
                                            "M'' 2x2": mesh["M'' 2x2"]},
            ("fft_ko", "B"): {"G": g_launches["G"],
                              "S'": servers["S'"]["launches"],
                              "M": mesh["M"], "M'": mesh["M'"]},
            ("fastddc_inv", "A"): {"G'": g_launches["G'"],
                                   "S": servers["S"]["launches"],
                                   "M": mesh["M"], "M'": mesh["M'"],
                                   **xp["fastddc_inv_cc"]},
            ("fft_ko", "C"): xp["bandpass_fir_fft_cc"],
            ("ifft_ko", "C"): xp["bandpass_fir_fft_cc"],
            ("fft_natural", "W"): xp["fft_cc"],
            ("adpcm_encode", "W1"): xp["encode_ima_adpcm_i16_u8"],
            ("adpcm_decode", "W1"): xp["decode_ima_adpcm_u8_i16"],
            ("ted_scan", "G"): {"G'": g_launches["G'"], "M": mesh["M"],
                                "M'": mesh["M'"]},
            ("agc_relax", "E"): {"F": receivers["F"][0]},
            ("costas_scan", "G_c"): xp["bpsk_costas_loop_cc"]}
    table = []
    for c in ([probe_row] + cases + new_cases + poly_cases + agc_rows
              + agc_exact_rows + ted_cases + scan_rows + [gc_row]
              + server_cases + edge_cases + [k2_cli]):
        path, counts = paths_of[c["path"]]
        key, extra = c["path"], also.get((c["name"], c["path"]), {})
        c = dict(c, launches=counts[c["name"]], path=path)
        require(c["launches"] > 0, f"{c['name']} not launched on its path")
        if extra:
            c["launches_by_path"] = {key: c["launches"]}
            for other, got in extra.items():
                require(got[c["name"]] > 0,
                        f"{c['name']} not launched on path {other}")
                c["launches_by_path"][other] = got[c["name"]]
        table.append({k: c[k] for k in keys + (
            "cluster", "bound_tc_ms", "launches_by_path", "bound_note",
            "serial_chain_ms", "beats_chain_by", "empty_ms",
            "tk_ms", "plain_on", "share_of_bound", "two_launch_ms",
            "share_published", "share_measured") if k in c})
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
