"""GPU smoke check of the PyTorch port (webaudio_tpu_torch) on one card.

    python3 chip_smoke.py [--old SOURCE] [--old SOURCE]

Builds the port's CUDA kernels from the sources in this checkout and
drives its main path on `device="cuda"`:

  a. the WaveShaper curve kernels against their plain PyTorch version, bit
     for bit, at 2 x 262,144 samples (values outside [-1, 1], NaN and +-inf
     included): one curve of 2, 2048, 44100 (MDN's distortion curve) and
     65536 points; tables of per-instance curves of 2048 and 8192 points
     (staged in shared memory) and of 8193 and 65536 (through the read-only
     cache), (2, n) at the main path's shape and R rows of 2 x L samples,
     (R, L) = (1, 4099), (3, 4099), (32, 4099), (32, 16384) and (300, 99);
     lengths 1, 3, 5 and 262,147; x and y 0-3 floats off a 16-byte
     boundary, one curve and tables of both kinds; a non-contiguous input
     and a plan asking for more shared memory than a block has must raise,
     and the next launch must still be right;
  b. the slice graph at full size: 10 s, 48 kHz, stereo, a looping
     AudioBufferSourceNode (bench.py's synthetic 2 s buffer, the aligned
     read) -> lowpass BiquadFilterNode (2000 Hz, Q 2) -> WaveShaperNode
     (tanh curve, 2048 points) -> destination, through
     OfflineAudioContext.start_rendering_sync.  Oracle: scipy lfilter in
     f64 on the looped buffer, then a numpy gather-lerp through the curve;
     tolerance 1e-5 x peak.  The plan must be 2 blocks of 262,144 frames,
     no node may fail, and the curve kernel must have launched;
  c. the same graph fed by a 44.1 kHz buffer (the pair-gather read), against
     the same kind of oracle with the buffer resampled the way the
     closed-form playhead reads it; tolerance 1e-5 x peak;
  d. the README's a-rate filter sweep (synthetic buffer), which runs the
     f64 log-depth scan on the card, against the port's own CPU render;
     tolerance 1e-4 x peak, because torch's CPU and CUDA sin/cos round the
     f32 filter coefficients differently in the last ulp and the resonant
     sweep amplifies that (an exact f64 recurrence moves by 2e-5 x peak);
  e. timing with CUDA events: the phase-b render end to end (one warm-up,
     then the median of 5) and its block loop alone on a compiled plan, as
     realtime factors; the curve kernel as called from Python, and
     grid_sample at the main path's shape.  After phase j (phase i's
     shaper bucket gives S3 and S4), the curve kernel's device time
     against its plain version and its bound, warm and cold L2 (as in
     phase m), at S1 the slice (2 x 262,144, n 2,048), S2 a 4x-oversampled
     10 s block (2 x 1,048,576), S4 the shaper bucket's own launch (32 x 2
     x 16,384 through a (32, 2048) table of per-instance curves), S3 its
     samples through one curve, S5 MDN's 44,100-point curve and S6 a
     65,536-point curve at S1's samples, each beside the other kernels of
     the launch plan that can take the shape; S1's shape on uniformly
     random samples and S1's samples through 32 copies of its curve; for
     tables, staged against the read-only cache as rows shorten and curves
     lengthen; and the floor, the one-curve kernel launched on S1's grid
     with no samples, in the same CUDA-graph replay.

Then batched serving (GraphBatch, MixedGraphBatch and the bounces), with
the dither and u-law kernels:

  f. the dither (int16) and u-law (uint8) kernels against their plain
     versions at (512, 98304) f32 from a uniform on [-1.2, 1.2] with NaN
     and +-inf planted, for three seeds: int16 bit-equal, uint8 within one
     code with at most 1e-6 of the codes off (the count is printed: any two
     uniforms give codes at most one apart, so only the count can catch a
     wrong random stream); one seed twice gives the same codes,
     two seeds differ; a non-contiguous input, an f64 input and a CPU input
     beside an output on the card raise KernelError;
  g. GraphBatch at full width: 256 instances of benches/suite.py's batched
     graph (2 s, 48 kHz, stereo, looping buffer -> lowpass Q 3 sweeping
     200 -> 8000 Hz), planned as 6 blocks of 16,384 frames.  Before the
     override every lane carries the context's rows and lane 0 matches its
     start_rendering_sync (1e-6 x peak); with the per-instance sweep rows,
     lanes 0 and 255 match a 2-instance batch on the CPU (1e-4 x peak, the
     sin/cos ulps of phase d); with 256 distinct buffers, lanes 0, 128 and
     255 match 1-instance batches on the card (1e-6 x peak);
  h. the bounces on that batch: render_i16 codes are floor(32767 x) or
     one more and equal the plain dither of the render bit for bit,
     render_u8 holds to the plain u-law as in f and, decoded, lies within
     0.06 of the render,
     render_stream(3, "i16") equals render_i16, and render_stream with
     updates of the sweep rows gives, batch by batch, the direct render
     after the same update;
  i. MixedGraphBatch over 96 contexts, 32 each of three topologies (the
     sweep; buffer -> constant lowpass -> WaveShaper with a curve of its
     own; buffer -> gain envelope): 3 buckets, every output within 1e-6 x
     peak of its own start_rendering_sync on the card, the shaper bucket
     through a (32, 2048) table of per-instance curves.  The dither, u-law
     and curve kernels must each have launched on the path g-i;
  j. timing: the staged batch's render at 256 and 1,024 instances
     (instances x audio seconds per wall second, graphs/s), end to end with
     the host copy (f32 and int16), render_stream pipelined (int16, uint8),
     the device-busy share of the 256-instance render (torch.profiler), and
     the dither and u-law kernels against their plain versions at
     (512, 98304) as device time from CUDA-graph replay, L2 warm (the same
     input) and cold (two copies in turn, each four times the L2).

Then granular synthesis (source fusion, grain lanes), with the grain
kernels: benches/suite.py::case_granular_grains at full width (10 s,
44.1 kHz, stereo, the suite's synthetic 2 s stereo sample sin(0.05 n);
grains of 90 ms with linear attack/release envelopes at rates 0.9-1.1):

  k. the grouped-lerp kernel (K3/K4/K7) against its plain version, bit for
     bit, at (g, w) = (16, 21) and (128, 192), 5 rows of 441,088 samples,
     1, 2 and 3 channels, with and without a whole-buffer wrap; the grain
     bank kernel (K2) bit for bit on the 400-grain case's own inputs
     (captured from its render) and on synthetic lanes whose grains cross
     both buffer ends; then the shapes the kernels' indexing must get
     right: the grouped lerp at groups of 1, 2, 3, 8, 12, 16 and 128, rows
     whose length is not a multiple of 4, per-instance playheads and
     pointers one float off a 16-byte boundary, the grain bank at 1, 3
     and 3,446 quanta times 1, 9 and 33 lanes with mixed instance axes
     and offset gain and out; a non-contiguous input or a wrong dtype
     raises;
  l. the 400-grain case through start_rendering_sync on the card: one
     block of 441,088 frames, read mode "fused" (K2, counted), against the
     port's CPU render (3e-5 absolute, error energy <= 1e-9 of the
     signal's: the JAX suite's fused-vs-grouped_t bound) and a numpy f64
     oracle that sums every grain directly (1e-4 x peak); then forced
     WEBAUDIO_GRAIN_READ=grouped_v, window, grouped_pl (each counting K3's
     kernel) and gather, each held to the fused render at 3e-5 / 1e-9;
  m. the 800-grain case, as l; then for both cases: start_rendering_sync
     end to end (CUDA events, one warm-up, median of 5), the block loop on
     a compiled plan, host planning (fusion with the lane plan, the lane
     plan alone, the per-lane envelope splicing, compile_graph), the
     device-busy share (torch.profiler), and K2 and K3 (both grain
     counts) and K3 at the `window` geometry of the 400-grain case (K4's
     row) at the path's inputs against their plain versions and their
     bound (CUDA-graph replay), with the L2 warm (the same inputs every
     call) and cold (each call on its own copy of the inputs, rotating
     through more than 150 MB), in GB/s, the cold time also as share of
     the bound.  With --old SOURCE (an earlier revision of
     csrc/grain_read.cu, csrc/curve_lookup.cu or csrc/detector.cu, told
     apart by their C entry points; once for each; the detector's A/B runs
     in phase v) that source and this checkout's are also
     built with `-Xptxas -v` (registers, shared memory and spills are
     printed), the old kernels are checked bit-equal to the plain versions
     on the same inputs and timed in turns with the new: plain, old, new,
     new, old, plain, twice (K1 at S1-S6 in phase e, the grain kernels
     here);
  n. a MixedGraphBatch of 64 granular contexts (2 s, 80 grains: the
     400-grain case's density) that differ only in each grain's buffer
     offset: one bucket, every output within 1e-6 x peak of its own
     start_rendering_sync.

Then oscillators and voice banks (10 s, 48 kHz, stereo), each main path
with every kernel's launch count from 0:

  o. BASELINE config 2 auto-fused (benches/suite.py::case_many_oscillators:
     500 sine oscillators, 80-2,080 Hz, +-15 cents, each through its ADSR
     gain envelope into a 1/500 mix gain; RandomState(42)): the plan must
     hold one 500-voice bank with a gain stage over 30 blocks of 16,000
     frames (the JAX planner's, as tests/test_torch_voices.py holds on the
     CPU); the render's first 2 s within 1e-5 x peak of the port's CPU
     render.  The default render follows the reference's back-extrapolated
     setTarget plateau between each decay's snap and its release, which no
     formula states, so the same graph also renders with
     WEBAUDIO_STRICT_SPEC=1 (W3C hold semantics): its first 2 s against
     the CPU render at 1e-5 x peak and all 10 s against a numpy f64 oracle
     (closed-form phase per voice at the f32-rounded computed frequency
     from the sub-sample start, the envelope's formulas) at 1e-4 x peak;
  p. config 2 as one OscillatorBankNode (case_many_oscillators_fused:
     per-voice pans, analytic ADSR): one _BankKernel, no dense rows; first
     2 s against the CPU render at 1e-5 x peak, 10 s against a numpy f64
     oracle at 1e-4 x peak;
  q. a 64-voice distortion bank: sawtooth voices, each through its own
     WaveShaper (2,048-point tanh curve, a drive of its own), a constant
     lowpass, a gain envelope and a constant StereoPanner: the four stages
     must fuse into one bank, whose shaper launches the curve kernel
     (counted) over a (64, 2048) table of per-voice curves; the captured
     launch bit-equal to its plain version; the render within 1e-5 x peak
     of the CPU render and 2e-5 x peak (the JAX suite's fused-against-
     unfused bound) of the unfused render on the card;
  r. for o, p and q: start_rendering_sync end to end (one warm-up, median
     of 5), the block loop on a compiled plan with its rows staged, host
     planning apart (fusion, the param timelines' compile, compile_graph,
     packing the dense rows and their bytes, their copy, the param-state
     advance) and the device-busy share (torch.profiler); then the curve
     kernel at S7, phase q's captured launch, warm and cold L2 against
     its plain version, its bound and grid_sample.

Then the mastering chain (BASELINE config 5: benches/suite.py::
case_mastering_chain with bench.py's synthetic buffer, a looping source ->
WaveShaper oversample 4x, tanh over 2,048 points -> DynamicsCompressor
threshold -18 dB, ratio 4 -> AnalyserNode fft 2,048), with the detector
kernel, each main path with every kernel's launch count from 0:

  s. the detector kernel (csrc/detector.cu) against its plain version (a
     loop over samples, run on the host) bit for bit at N 1, 3 and 1,024
     instances of 4,096 samples, taus per instance and per sample,
     attack 0, release 0, and B = 1; then at the kernel's edges: N 1, 7,
     8, 9, 132, 1,024 and 1,025 (about its CTA sizes) times B 1, 3 and
     4,097, B a tile's length from its launch plan times 1, 4 and 9 plus
     or minus one (9 wraps its 4-slot ring twice), and rows off a 16-byte
     boundary (the 4-byte staging); a non-contiguous, an f64 and a CPU
     input raise KernelError; upsample and downsample x2 and x4 on the card
     against the CPU at 1e-6 x peak, with cuDNN allowed TF32 as PyTorch
     has it by default;
  t. 5a: 10 s, 48 kHz, stereo through start_rendering_sync: one block of
     480,000 frames, the detector kernel (the card's default detector)
     launched once and K1 once (over (1, 2, 1,920,000) samples), within
     1e-5 x peak of the port's CPU render (whose default is the chunked
     fixed point) and 1e-4 x peak of a numpy f64 oracle (zero-stuffed FIR
     with the firwin taps, the lerp, the decimating FIR, the sequential
     detector); the compressor's reduction and the analyser's time,
     frequency and byte data against the CPU render's; with
     WEBAUDIO_DETECTOR=chunked (the chunked fixed point on the card, its
     solves counted) the render holds to the oracle (1e-4) and the
     default render to it (2e-4 x peak, the JAX suite's bound between
     detectors); the detector kernel bit-equal to its plain version on
     the captured attenuation row, and the chunked detector within 1e-4
     of it; end to end (one warm-up, median of 5), host planning, the
     block loop and the device-busy share;
  u. 5b: a GraphBatch of the chain at 2 s, 1,024 instances, each with its
     own synthetic clip (a third each at 38,000, 44,100 and 48,000 Hz,
     resampled to 48 kHz by AudioBuffer.resample, cut or padded to 96,000
     frames): one block, K1, K5 and the detector kernel (once a render)
     launched, lanes 0, 511 and 1,023 within 1e-6 x peak of their own
     start_rendering_sync on the card, a 4-instance batch within 1e-5 x
     peak of the port's CPU batch with the card's detector
     (WEBAUDIO_DETECTOR=seq) and 2e-4 x peak of the CPU batch with the
     CPU's default (the chunked fixed point), render_i16 equal to the
     plain dither of render(); throughput, peak device memory and the busy
     share;
  v. K1 at S8 (5a's captured launch) and MDN's 44,100-point curve on S8's
     samples, warm and cold L2, against the plain version, the bound and
     grid_sample; the detector's step alone (one thread, clock64: the
     kernel's byte-permute select, the same step with ?:, the earlier
     kernel's select-tau step, multiply + add), then the detector kernel
     against the chunked fixed point (forced) at 5a's and 5b's detector
     inputs and at DETECTOR_SWEEP's shapes (cut and tiled from 5b's), the
     rule behind detector_mode, with its bound and its latency floor (B
     steps of 3 dependent operations, the earlier 4 beside it, and of the
     step's measured cycles); with --old an earlier detector.cu against
     this one at 5a's and 5b's shapes, in turns (plain, old, new, new,
     old, plain), each bit-equal to the plain version; the resamplers'
     device time.

Then delay, feedback cycles, the ConvolverNode and the IIRFilterNode
(BASELINE config 3: benches/suite.py::case_convolution_reverb at 44.1 kHz,
stereo, with seeded stand-ins for its two WAV files: bench.py's synthetic
2 s buffer, looped, as the dry signal and 2 s of stereo noise decaying
with a 0.4 s time constant as the IR, normalized; a 0.31 s delay fed back
through 0.4), each main path with every kernel's launch count from 0:

  w. config 3, 10 s, through start_rendering_sync: the plan must be the
     JAX package's (one block of 442,368 frames, the cycle group stepped
     36 times at 12,288 frames, the convolver's partition 16,384 with K 6);
     within 1e-5 x peak of the port's CPU render and 1e-4 x peak of a
     numpy f64 oracle (scipy fftconvolve of the looped dry signal with the
     scaled IR, plus the feedback loop stepped in chunks one delay long
     with the delay's lerp); end to end (one warm-up, median of 5), the
     block loop, and the device-busy share, device operations per render
     and top device ops (torch.profiler).  Then case_iir_chain (10 s, 48
     kHz, butter(4, 0.2) on bench.py's looping buffer) against scipy
     lfilter in f64 at 1e-4 x peak, and its end to end;
  x. one-quantum stepping: config 3 at 2 s with WEBAUDIO_CYCLE_BLOCKS=1
     (690 blocks of 128 frames, the convolver's FDL 690 partitions of
     128) within 3e-6 of its two-rate render (the JAX suite's bound); the
     golden modulated_feedback_delay topology stretched to 2 s on bench.py's
     looping buffer (a flanger with feedback: its automated delay pins 750
     blocks of 128; in the cycle the delay is held to one quantum) within
     1e-5 x peak of a numpy f64 oracle stepped a quantum at a time; for
     both, ms (one warm-up, one timed render) and device operations per
     128-frame quantum;
  y. the reverb corpus: a GraphBatch of config 3 at 2 s (90,112 / 8 /
     11,264), 256 instances, each its own synthetic clip through
     override_buffer, the IR shared: K5 launched by render_i16 and equal
     to the plain dither, a second render equal to the first, lanes 0, 127
     and 255 within 1e-6 x peak of their own start_rendering_sync on the
     card; instance-audio-seconds per wall second, peak device memory and
     the busy share.

Then spatial audio (the PannerNode, its HRTF model and the AudioListener)
and the buffer source's automated-rate playhead, 44.1 kHz, stereo, each
main path with every kernel's launch count from 0:

  z. BASELINE config 4 (benches/suite.py::case_hrtf_moving), 10 s: a 220
     Hz sawtooth into an HRTF PannerNode at z = -2, the listener orbiting
     at radius 3 (64 linear ramps of position_x and position_z).  The plan
     must be one block of 441,088 frames; the render within 1e-5 x peak
     of the port's CPU render and 1e-4 x peak of a numpy f64 oracle (each
     quantum's HRIR interpolated in the time domain at the port's grid
     cell, the quanta whose cell differs from the f64 geometry's counted;
     direct convolution, the crossfade and the gain lerp in f64); end to
     end (one warm-up, median of 5), the block loop, peak device memory,
     and device operations, device time by op and the busy share
     (torch.profiler);
  za. examples/doppler.py's graph, 10 s (bench.py's synthetic buffer,
     looped, standing in for siren.mp3): a delay swept 0.29 -> 0 -> 0.29 s
     into an equal-power inverse-distance panner moving along y from +100
     to -100; then again with the playback rate ramped 0.8 -> 1.25 (the
     automated-rate playhead on the card).  Each within 1e-5 x peak of the
     port's CPU render and 1e-4 x peak of a numpy f64 oracle on the
     params' compiled rows (a sequential f64 playhead, the delay's lerp,
     the panner's gains from f64 geometry); end to end and the busy share;
  zb. the binaural corpus: a GraphBatch of the graph looping clip -> HRTF
     panner -> destination, 2 s, 256 instances, each its own mono clip
     (override_buffer) and listener orbit (override_param on the
     listener's position_x and position_z, seeded phases and radii): K5
     launched by render_i16 and equal to the plain dither, a second render
     equal to the first, lanes 0, 127 and 255 within 1e-6 x peak of their
     own start_rendering_sync on the card; instance-audio-seconds per wall
     second, peak device memory and the busy share.

Then resumable, segmented and off-thread renders and user code, each
main path with every kernel's launch count from 0:

  zc. RenderSession at full width, steps of 128 quanta (16,384 frames),
     every param a dense row compiled on the host each step: the slice
     graph of phase b, 30 steps (491,520 frames), K1 once a step and its
     first launch bit-equal to its plain version; saved after step 15 and
     restored into a fresh context's session, whose steps 16-30 must be
     bit-equal to the uninterrupted session's; the first 2 s within
     1e-5 x peak of the port's CPU session, all 10 s within 1e-4 x peak of
     the one-shot start_rendering_sync; K5 bounces each step's chunk, equal
     to the plain dither.  The same for config 3 (27 steps, the cycle
     clamps the block to 8,192 frames, saved after step 13: the FDL and
     the delay ring cross the checkpoint).  Printed: host ms a step (the
     dense rows and the timelines' advance), the block walk's device ms a
     step, the realtime factor and the checkpoint's bytes.  Then 64 grains
     of case_granular_grains over 1 s through RenderSession(
     quanta_per_block=1): 128-frame blocks through the grain bank, the
     kernel its read mode picks bit-equal to its plain version, the card's
     session within 3e-5 of the CPU session's;
  zd. render_time_sharded of the slice graph at 10 s in 8 segments on the
     card (devices=["cuda"] * 8, in turn): the JAX package's block (117
     quanta) and halo, K1 once a block in every segment, within 5e-5 x
     peak of the sequential render; wall time against it; config 3 and 5a
     raise NotTimeShardableError;
  ze. bench.py's graph (a looping source -> lowpass 2000 Hz, Q 2) -> a
     PyTorch port of examples/worklet_bitcrusher.py's processor (bit_depth
     ramped 16 -> 4 a-rate, frequency_reduction 0.5) -> destination, 10 s:
     within 1e-5 x peak of the port's CPU render and 1e-6 x peak of a
     per-sample numpy oracle on the worklet's recorded input, apart from
     rounding-boundary flips (samples one quantization step apart whose
     input lies within the inputs' difference of a boundary, counted);
     the same graph as a 64-instance GraphBatch with a bit_depth ramp of
     its own a lane (the worklet under torch.func.vmap), lanes 0, 31 and
     63 within 1e-6 x peak of their own renders, flips apart; a
     ScriptProcessorNode(4096, 2, 2) doubling its input after bench.py's
     graph: the output equals the handler's input x2 delayed 8,192 frames
     exactly, the input within 1e-5 x peak of the graph rendered alone;
     the callbacks and ms a callback;
  zf. start_rendering() of the slice graph with suspend(5.0), the filter's
     frequency set to 500 Hz while suspended, resume(): bit-equal to the
     same mutation through suspend_sync; profile_render's Chrome trace
     holds CUDA kernel events; collect_diagnostics reports the block.

Then the real-time AudioContext and media I/O (phases zg-zi):

  zg. decoding on the host into a 48 kHz context on the card: the native
     libraries (webaudio_tpu_torch/native/*.cpp) built with g++ into
     webaudio_tpu_torch/build/ (path and build seconds printed; whether
     the FFmpeg codec host built is information only); 10 s of stereo
     16-bit codes at 44.1 kHz written as a FLAC (tests/flac_ref.py's
     encoder), an f32 WAV and a 16-bit WAV (the port's write_wav): the
     FLAC and the f32 WAV decode to the source samples exactly, the
     16-bit WAV within one LSB; resampled to 48 kHz they equal
     AudioBuffer.resample of the source (the 16-bit file: of its decode)
     bit for bit;
  zh. AudioContext(sample_rate=48000, device="cuda") with a callback
     sink, 2 channels, unpaced: the decoded FLAC looping through a lowpass
     (2,000 Hz, Q 2), a WaveShaper 4x (tanh, 2,048 points) and a
     DynamicsCompressor into the destination.  10 s of callbacks at
     "playback" (1,024 frames) and at render_size_hint=16384, each within
     1e-5 x peak of the same graph's OfflineAudioContext render on the
     card; K1 and the detector kernel launched once a chunk; no
     processorerror event; the stream not silent; chunk ms (median, p99)
     and the realtime factor; on the card, 20 chunks under torch.profiler
     (busy share, device operations a chunk) and the dense rows' host ms.
     Then paced, for 2 s of wall time each, at "interactive",
     "balanced" and "playback": the render-capacity events' loads and
     underrun ratios, the share of chunks over their budget and
     playback_stats (measurements, not gates).  Automation scheduled on
     the filter from the sink callback re-plans nothing; a gain connected
     from it re-plans once, every other node's state carried.  A
     `file:` sink's WAV, decoded by the port, holds the callback stream
     bit for bit;
  zi. the media nodes on the card: a MediaElementAudioSourceNode over a
     10 s WAV file into the slice graph of phase b in an
     OfflineAudioContext, within 1e-5 x peak of the graph fed by the
     decoded buffer; a PushStreamTrack through a MediaStreamAudioSourceNode
     and a gain of 1 gives the pushed blocks exactly; a
     MediaStreamAudioDestinationNode's MediaRecorder capture (f32 WAV)
     equals the render bit for bit; the uploads and host copies a block.

Prints the measurements, a {"kernels": [...]} line (each kernel's launches
on its path, error against its plain version, device time, the plain
version's, the least time the card could take (`bound_ms`: the larger of
the bytes it must move at 3.35 TB/s and its f32 operations at 67 TFLOP/s),
its share of that bound (for the curve and grain kernels, of their
cold-L2 time: the bound reads every input from HBM) and one PyTorch call's
time where one computes the same function; the curve kernel's row also
carries S1-S8, the floor and its launches on the offline, voice,
mastering and corpus paths; the curve kernel's row also its launches on
the session and segment paths and on the online path (zh: 1,024- and
16,384-frame chunks); the dither kernel's its launches on the three corpus paths and the
session's bounce; the grain kernels' their launches in the 128-frame
session; the detector kernel's row its launches on the
default 5a and 5b paths and the forced-chunked 5a path, its plain
version's host time, the latency floors of one sequential chain, the
step's cycles, the chunked path's time, 5b's and the sweep's times,
and its launches on the online path)
and the card's name and power limit, then as
its last line {"ok": true, "device": {...}}.  Exits non-zero, printing no result, if CUDA is unavailable or any
phase fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

FS = 48000.0
SECONDS = 10.0
FRAMES = int(FS * SECONDS)
CURVE_POINTS = 2048
KERNEL_SAMPLES = 2 * 262144
SEED = 20261016
BATCH_SECONDS = 2.0
BATCH_FRAMES = int(FS * BATCH_SECONDS)
BATCH = 256
BIG_BATCH = 1024
QUANT_SHAPE = (512, 98304)
MIXED_PER_TOPOLOGY = 32
DEVICE = "cuda"              # where the batch phases g-i render
GRAIN_FS = 44100.0
GRAIN_SECONDS = 10.0
GRAIN_FRAMES = int(GRAIN_FS * GRAIN_SECONDS)
GRAIN_BLOCK = 441088         # the plan's one block (3,446 quanta)
MIXED_GRAIN_CONTEXTS = 64
OSC_VOICES = 500             # BASELINE config 2
DRIVE_VOICES = 64
CPU_SECONDS = 2.0            # the CPU renders o and p are held to
ORACLE_CHUNK = 16000         # frames per chunk of the f64 oracles
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12        # f32 outside the tensor cores


def _bound(nbytes, ops):
    """(ms, what bounds it): the larger of moving `nbytes` at the HBM rate
    and doing `ops` f32 operations at the f32 peak."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / F32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def _curve(n, rng=None):
    c = np.tanh(np.linspace(-2.0, 2.0, n))
    if rng is not None:
        c = c + 0.01 * rng.standard_normal(n)
    return c.astype(np.float32)


def _bench_data():
    # bench.py:34-37: the synthetic 2 s stereo buffer
    return np.sin(np.arange(2 * 48000) * 0.03, dtype=np.float32)[None].repeat(2, 0)


def _resampled_data():
    n = 2 * 44100
    t = np.arange(n)
    return np.stack([np.sin(t * 0.031) + 0.3 * np.sin(t * 0.0007),
                     np.cos(t * 0.017)]).astype(np.float32)


def slice_context(wt, device, data, buf_rate, frames=FRAMES):
    """source (loop) -> lowpass 2000 Hz, Q 2 -> WaveShaper -> destination."""
    ctx = wt.OfflineAudioContext(2, frames, FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(data, buf_rate)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0, q=2.0)
    shaper = ctx.create_wave_shaper(curve=_curve(CURVE_POINTS))
    src.connect(filt)
    filt.connect(shaper)
    shaper.connect(ctx.destination)
    return ctx


def sweep_context(wt, device, frames=FRAMES):
    """README.md's a-rate example with bench.py's synthetic buffer."""
    ctx = wt.OfflineAudioContext(2, frames, FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(_bench_data(), FS)
    filt = ctx.create_biquad_filter(type="lowpass", q=8.0)
    filt.frequency.set_value_at_time(200.0, 0.0)
    filt.frequency.exponential_ramp_to_value_at_time(8000.0, frames / FS)
    src.connect(filt)
    filt.connect(ctx.destination)
    src.start()
    return ctx


def oracle(looped, curve):
    """scipy lfilter in f64 (the spec's lowpass, Q in dB) then a numpy
    gather + lerp through the curve."""
    from scipy.signal import lfilter

    w0 = 2.0 * np.pi * 2000.0 / FS
    alpha = np.sin(w0) / (2.0 * 10.0 ** (2.0 / 20.0))
    cw = np.cos(w0)
    b = np.array([(1 - cw) / 2, 1 - cw, (1 - cw) / 2])
    a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    y = lfilter(b / a[0], a / a[0], looped.astype(np.float64), axis=1)
    n = len(curve)
    v = np.clip((n - 1) / 2.0 * (y + 1.0), 0.0, n - 1)
    k = np.minimum(np.floor(v).astype(np.int64), n - 2)
    f = v - k
    c = curve.astype(np.float64)
    return c[k] * (1.0 - f) + c[k + 1] * f


def looped_read(data, buf_rate, frames):
    """The closed-form playhead's looped read at rate 1: position
    n * buf_rate / fs wrapped into [0, L) (with the sticky snap at the
    loop end), lerped in f32 with the wrap neighbour at the seam."""
    L = data.shape[1]
    pos = np.arange(frames, dtype=np.float64) * (buf_rate / FS)
    wrapped = np.fmod(pos, L)
    wrapped = np.where(L - wrapped <= 1.5e-8 * np.maximum(pos, 1.0), 0.0, wrapped)
    k = np.floor(wrapped).astype(np.int64)
    frac = (wrapped - k).astype(np.float32)
    nxt = np.where(k + 1 >= L, 0, k + 1)
    return data[:, k] * (1.0 - frac) + data[:, nxt] * frac


def _check_close(name, got, want, rel):
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    ok = got.shape == want.shape and bool(np.isfinite(got).all()) and \
        err <= rel * peak
    print(f"{name}: max_abs_err {err:.3e} peak {peak:.6f} "
          f"limit {rel:g} x peak -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: {err} > {rel} x {peak}")
    return err


def _events_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _graph_ms(fn, reps):
    """Device ms per call of fn: `reps` calls captured in one CUDA graph,
    replayed 5 times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, 5) / reps


def _curve_equal(name, got, want):
    """Bit for bit, NaN positions included; returns the max |difference|."""
    torch.cuda.synchronize()
    same = torch.equal(got.isnan(), want.isnan()) and torch.equal(
        torch.nan_to_num(got), torch.nan_to_num(want))
    err = float((torch.nan_to_num(got) - torch.nan_to_num(want)).abs().max()) \
        if got.numel() else 0.0
    if not same:
        raise AssertionError(f"{name}: the curve kernel differs from plain")
    return err


def _plan_text(p):
    return f"{p.mode}, grid {p.grid} x {p.threads}, {p.smem_bytes} B"


def _tables(n, R, L, rng):
    """R per-instance n-point curves and R rows of 2 x L samples."""
    tab = torch.stack([torch.from_numpy(_curve(n, rng)).cuda()
                       for _ in range(R)])
    xs = rng.uniform(-1.6, 1.6, (R, 2, L)).astype(np.float32)
    xs.reshape(-1)[:6] = [np.nan, np.inf, -np.inf, -1.0, 1.0, 0.0]
    return tab, torch.from_numpy(xs).cuda()


def phase_a(ck, KernelError):
    rng = np.random.default_rng(SEED)
    x = rng.uniform(-1.6, 1.6, KERNEL_SAMPLES).astype(np.float32)
    x[:6] = [np.nan, np.inf, -np.inf, -1.0, 1.0, 0.0]
    xd = torch.from_numpy(x).reshape(2, -1).cuda()   # the main path's shape
    kern = ck._kernel()
    sms, smem = kern.limits()
    print(f"a. card: {sms} SMs, {smem} B of shared memory a block; tables "
          f"stage curves of up to {ck._STAGE_MAX_POINTS} points "
          f"({ck.staged_bytes(ck._STAGE_MAX_POINTS)} B)", flush=True)
    worst = 0.0
    for n in (2, 2048, 44100, 65536):
        curve = torch.from_numpy(_curve(n, rng)).cuda()
        err = _curve_equal(f"a. n={n}", ck.curve_lookup(curve, xd),
                           ck.curve_lookup_reference(curve, xd))
        worst = max(worst, err)
        print(f"a. curve_lookup n={n} ({_plan_text(kern.plan(n, xd.numel(), 1))}"
              f"): bit-equal True max_abs_err {err:.3e}", flush=True)

    # tables of per-instance curves on each side of the longest staged
    # curve: (2, n) at the main path's shape, then R rows of 2 x L samples
    # (4099 is not a multiple of 4, 16384 a shaper bucket's, 300 rows more
    # than a wave's blocks: each block walks several rows and refills its
    # copy)
    edge = ck._STAGE_MAX_POINTS
    for n in (2048, edge, edge + 1, 65536):
        table = torch.stack([torch.from_numpy(_curve(n, rng)).cuda()
                             for _ in range(2)])
        worst = max(worst, _curve_equal(
            f"a. (2, {n}) table", ck.curve_lookup(table, xd),
            ck.curve_lookup_reference(table, xd)))
        for R, L in ((1, 4099), (3, 4099), (32, 4099), (32, 16384),
                     (300, 99)):
            tab, xs = _tables(n, R, L, rng)
            worst = max(worst, _curve_equal(
                f"a. ({R}, {n}) table", ck.curve_lookup(tab, xs),
                ck.curve_lookup_reference(tab, xs)))
        print(f"a. curve_lookup (R, {n}) tables "
              f"({_plan_text(kern.plan(n, 32 * 2 * 16384, 32))} at R 32, L "
              f"16384): bit-equal True", flush=True)

    # lengths not a multiple of 4, and x and y off a 16-byte boundary
    curve = torch.from_numpy(_curve(CURVE_POINTS, rng)).cuda()
    for m in (1, 3, 5, 262147):
        xs = xd.reshape(-1)[:m].clone()
        worst = max(worst, _curve_equal(
            f"a. m={m}", ck.curve_lookup(curve, xs),
            ck.curve_lookup_reference(curve, xs)))
    cases = [(curve, xd)] + [_tables(n, 3, 4099, rng) for n in (2048, edge + 1)]
    for c, xs0 in cases:
        for x_off, y_off in ((1, 1), (1, 0), (0, 1), (3, 2)):
            xs = _offset(xs0, x_off)
            want = ck.curve_lookup_reference(c, xs)
            out = _offset(torch.full_like(want, float("nan")), y_off)
            worst = max(worst, _curve_equal(
                f"a. {tuple(c.shape)} x +{x_off}, y +{y_off} floats",
                ck._launch(kern, out, c, xs), want))
    print("a. m = 1, 3, 5, 262147; one curve and (3, 2048) and "
          f"(3, {edge + 1}) tables with x and y 0-3 floats off a 16-byte "
          "boundary: bit-equal True", flush=True)

    bad = [("a non-contiguous input", lambda: ck.curve_lookup(
               curve, torch.zeros((2, 64), device="cuda").t())),
           ("a plan asking for more shared memory than a block has",
            lambda: ck._launch(kern, torch.empty_like(xd), curve, xd,
                               ck.LaunchPlan("shared", (1, 1), 512,
                                             smem + 16)))]
    for what, call in bad:
        try:
            call()
        except KernelError as exc:
            print(f"a. {what} raises: {exc}", flush=True)
        else:
            raise AssertionError(f"{what} did not raise")
    # the refused launch leaves no error behind for the next one
    worst = max(worst, _curve_equal("a. after the refusal",
                                    ck.curve_lookup(curve, xd),
                                    ck.curve_lookup_reference(curve, xd)))
    return worst


def phase_b(wt, ck):
    """Returns the curve kernel's launches and the (curve, x) of its first
    call (the first block's shaper input: S1)."""
    from webaudio_tpu_torch.nodes import waveshaper

    data = _bench_data()
    ctx = slice_context(wt, "cuda", data, FS)
    ck.curve_lookup.launches = 0
    with _recording(waveshaper, "curve_lookup") as shaped:
        out = ctx.start_rendering_sync().to_array()
    launches = ck.curve_lookup.launches
    segs = ctx.render_stats["segments"]
    print(f"b. main path: segments {segs} curve_lookup launches {launches}",
          flush=True)
    if len(segs) != 1 or segs[0]["block_frames"] != 262144 or segs[0]["failed"]:
        raise AssertionError(f"unexpected plan or failed nodes: {segs}")
    if launches < 1:
        raise AssertionError("the curve kernel never launched on the main path")
    idx = np.arange(FRAMES) % data.shape[1]
    _check_close("b. 10 s slice render vs lfilter oracle", out,
                 oracle(data[:, idx], _curve(CURVE_POINTS)), 1e-5)
    return launches, shaped[0]


def phase_c(wt):
    data = _resampled_data()
    ctx = slice_context(wt, "cuda", data, 44100.0)
    out = ctx.start_rendering_sync().to_array()
    if any(seg["failed"] for seg in ctx.render_stats["segments"]):
        raise AssertionError("a node failed in the 44.1 kHz render")
    want = oracle(looped_read(data, 44100.0, FRAMES), _curve(CURVE_POINTS))
    _check_close("c. 44.1 kHz buffer render vs resampled oracle", out, want, 1e-5)


def phase_d(wt):
    got = sweep_context(wt, "cuda").start_rendering_sync().to_array()
    want = sweep_context(wt, "cpu").start_rendering_sync().to_array()
    _check_close("d. README a-rate sweep, cuda vs cpu", got, want, 1e-4)


def _render_ms(label, make, seconds, reps=5):
    """start_rendering_sync of a fresh context from make() between CUDA
    events: one warm-up, then the median of `reps`; printed with the
    realtime factor."""
    runs = []
    for i in range(reps + 1):
        ctx = make()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        ctx.start_rendering_sync()
        stop.record()
        torch.cuda.synchronize()
        if i:                                  # the first run is warm-up
            runs.append(start.elapsed_time(stop))
    ms = statistics.median(runs)
    print(f"{label}: start_rendering_sync median {ms:.3f} ms of "
          f"{['%.3f' % r for r in runs]} -> realtime factor "
          f"{seconds * 1000.0 / ms:.1f}x", flush=True)
    return ms


def phase_e(wt, ck, compiler):
    _render_ms("e. 10 s slice",
               lambda: slice_context(wt, "cuda", _bench_data(), FS), SECONDS)

    ctx = slice_context(wt, "cuda", _bench_data(), FS)
    cg = compiler.compile_graph(dict(ctx._nodes), list(ctx._edges), FS,
                                FRAMES, ctx._destination.node_id, "cuda")
    compiler.render_compiled(cg, FRAMES)
    loop = [_events_ms(lambda: compiler.render_compiled(cg, FRAMES), 5)
            for _ in range(3)]
    loop_ms = statistics.median(loop)
    print(f"e. block loop on a compiled plan: median {loop_ms:.3f} ms of "
          f"{['%.3f' % r for r in loop]} (5 renders each) -> realtime factor "
          f"{SECONDS * 1000.0 / loop_ms:.1f}x", flush=True)

    rng = np.random.default_rng(SEED + 1)
    xd = torch.from_numpy(rng.uniform(-1.6, 1.6, KERNEL_SAMPLES).astype(
        np.float32)).reshape(2, -1).cuda()
    curve = torch.from_numpy(_curve(CURVE_POINTS)).cuda()
    for _ in range(10):
        ck.curve_lookup(curve, xd)
        ck.curve_lookup_reference(curve, xd)

    def kernel():
        return ck.curve_lookup(curve, xd)

    def plain():
        return ck.curve_lookup_reference(curve, xd)

    # per call from Python, back to back: what the block loop pays (device
    # times come from curve_times, after phase j)
    k_host = _events_ms(kernel, 200)
    p_host = _events_ms(plain, 200)
    print(f"e. curve_lookup at {KERNEL_SAMPLES} samples, n={CURVE_POINTS}, "
          f"called from Python back to back: kernel {k_host * 1000:.2f} us, "
          f"plain {p_host * 1000:.2f} us", flush=True)

    # yardstick: grid_sample's 1-D linear mode with align_corners=True maps
    # x in [-1, 1] onto [0, n - 1] and lerps, with border clamping; it
    # computes the curve lookup if it gives the same numbers
    grid = torch.stack([xd.reshape(1, 1, -1), torch.zeros_like(
        xd.reshape(1, 1, -1))], dim=-1)                   # (1, 1, M, 2)
    img = curve.reshape(1, 1, 1, -1)

    def library():
        return torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    lib_err = float((library().reshape(2, -1) - kernel()).abs().max())
    lib_ms = statistics.median(_graph_ms(library, 100) for _ in range(3))
    print(f"e. grid_sample (1-D linear, align_corners) at the same shape: "
          f"{lib_ms * 1000:.2f} us, max |grid_sample - kernel| "
          f"{lib_err:.3e}", flush=True)
    return lib_ms, lib_err


def _forced(ck, mode, curve, x):
    """The one-wave plan of K1's kernel `mode` for (curve, x) whichever
    kernel the launch plan picks there, or None where a block's shared
    memory cannot hold the staged curve: the kernels that compete with the
    plan's choice at a shape."""
    kern = ck._kernel()
    sms, smem = kern.limits()
    rows = curve.shape[0] if curve.dim() == 2 else 1
    n = curve.shape[-1]
    if mode == "shared" and ck.staged_bytes(n) > smem:
        return None
    return ck._grid(mode, n, x.numel() // rows, rows, sms, kern.resident)


def _floor_ms(ck, plan, device):
    """Device ms of a launch of the plan's kernel on its grid with no
    samples (every thread returns at once), in the same CUDA-graph replay
    as the timings: what a launch costs before any work."""
    kern = ck._kernel()

    def launch():
        err = kern._launch(None, None, None, 0, 0, 2, 0.5,
                           ck.KERNELS[plan.mode], plan.grid[0], plan.grid[1],
                           plan.threads, plan.smem_bytes,
                           torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"the zero-sample launch failed: {err}")
    return statistics.median(_graph_ms(launch, 20) for _ in range(4))


def curve_times(ck, s1, s4, old=None):
    """Phase e's kernel timings (run after phase j; phase i's shaper bucket
    gives S3 and S4): K1 at S1-S6 against its plain version and its bound,
    warm and cold L2, by `_kernel_times`, beside the other kernels of the
    launch plan that can take each shape and, where given, `old` (an
    earlier curve_lookup.cu) in turns; the same at S1's shape on uniformly
    random samples (every tap a random point: the gathers' worst case) and
    on S1's samples through a table of 32 copies of its curve (one curve
    read from 32 places); a table's two kernels as rows shorten and curves
    lengthen; then the floor.  s1: (curve, x) of the slice's first block;
    s4: (table, x) of the shaper bucket's last launch (a curve per
    instance), the samples the paths really shape; S3 is S4's samples
    through the table's first curve alone."""
    kern = ck._kernel()
    rng = np.random.default_rng(SEED + 6)
    c1, x1 = s1[0].reshape(-1).contiguous(), s1[1].contiguous()
    table, x3 = s4[0].contiguous(), s4[1].contiguous()
    R, n1 = table.shape
    # a 4x-oversampled block: the slice's block, linearly upsampled
    x2 = torch.nn.functional.interpolate(
        x1.reshape(1, -1, x1.shape[-1]), scale_factor=4, mode="linear",
        align_corners=True).reshape(*x1.shape[:-1], -1).contiguous()
    noise = torch.from_numpy(rng.uniform(-1.6, 1.6, tuple(x1.shape)).astype(
        np.float32)).cuda()
    copies = c1.expand(32, n1).contiguous()
    shapes = [
        ("S1", c1, x1),
        ("S1 random", c1, noise),
        ("S1 copies", copies, x1.reshape(32, -1)),
        ("S2", c1, x2),
        ("S3", table[0].contiguous(), x3),
        ("S4", table, x3),
        ("S5", torch.from_numpy(_curve(44100)).cuda(), x1),
        ("S6", torch.from_numpy(_curve(65536)).cuda(), x1),
    ]

    def launch(e, out, curve, x):
        return ck._launch(e[0], out, curve, x, e[1])

    def times(key, curve, x, olds):
        rows = curve.shape[0] if curve.dim() == 2 else 1
        plan = kern.plan(curve.shape[-1], x.numel(), rows)
        entries = dict(olds) | {"new": (kern, None)}
        for mode in ("shared", "cached"):
            p = _forced(ck, mode, curve, x)
            if p is not None and p.mode != plan.mode:
                entries[mode] = (kern, p)
        label = (f"e. curve_lookup {key} {tuple(x.shape)}, "
                 f"{'table ' if rows > 1 else ''}{tuple(curve.shape)} "
                 f"[{_plan_text(plan)}]")
        print(f"{label}: beside {[k for k in entries if k != 'new']}",
              flush=True)
        res = _kernel_times(
            label, launch, entries, ck.curve_lookup_reference, (curve, x),
            _nbytes(curve, x) + x.numel() * 4, 11 * x.numel())
        res["plan"] = _plan_text(plan)
        return res

    olds = {} if old is None else {"old": (old, None)}
    out = {key: times(key, curve, x, olds) for key, curve, x in shapes}
    # the library call beside the one-curve shapes that had none
    for key, curve, x in shapes:
        if key in ("S2", "S5"):
            out[key]["library_ms"], out[key]["library_err"] = \
                _curve_library(f"e. {key}", ck, curve, x)
    # a table's two kernels as a block's share of its row shrinks (S4's
    # curves, rows of L samples of the bucket's audio) and as the curves
    # lengthen (S4's samples): where staging stops paying
    xr = x3.reshape(R, -1)
    xr = torch.cat([xr, xr], 1)
    for L in (1024, 4096, 16384, 65536):
        out[f"table L {L}"] = times(f"table L {L}", table,
                                    xr[:, :L].contiguous(), {})
    for n in (4096, 8192):
        tab = torch.stack([torch.from_numpy(_curve(n, rng)).cuda()
                           for _ in range(R)])
        out[f"table n {n}"] = times(f"table n {n}", tab, x3, {})

    plan = kern.plan(n1, x1.numel(), 1)
    floor = _floor_ms(ck, plan, x1.device)
    print(f"e. floor: the one-curve kernel launched on S1's grid {plan.grid} "
          f"x {plan.threads} with no samples, same CUDA-graph replay: "
          f"{floor * 1000:.2f} us", flush=True)
    out["floor_ms"] = floor
    return out


def _curve_library(label, ck, c, x):
    """grid_sample's bilinear mode with align_corners=True through one
    curve (K1's contract, not bit-equal): (device ms, max |grid_sample -
    kernel|), printed."""
    grid = torch.stack([x.reshape(1, 1, -1), torch.zeros_like(
        x.reshape(1, 1, -1))], dim=-1)
    img = c.reshape(1, 1, 1, -1)

    def library():
        return torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    err = float((library().reshape(x.shape) - ck.curve_lookup(c, x))
                .abs().max())
    ms = statistics.median(_graph_ms(library, 10) for _ in range(3))
    print(f"{label}: grid_sample {tuple(x.shape)} through {tuple(c.shape)} "
          f"{ms * 1000:.2f} us, max |grid_sample - kernel| {err:.3e}",
          flush=True)
    return ms, err


def _host(t):
    return t.detach().cpu().numpy()


def _ulaw_off(name, got, want):
    """Codes of got off want: at most one apart, and at most 1e-6 of them
    (a wrong key, counter or word order moves about half of all codes)."""
    diff = (got.int() - want.int()).abs()
    off, worst = int(torch.count_nonzero(diff)), int(diff.max())
    print(f"{name}: ulaw_u8 codes off by one {off} of {diff.numel()}, max "
          f"off {worst} (limits: 1 code, {1e-6 * diff.numel():.0f} codes)",
          flush=True)
    if worst > 1 or off > 1e-6 * diff.numel():
        raise AssertionError(f"{name}: ulaw_u8 disagrees with its plain "
                             "version")
    return worst


def phase_f(dither, KernelError):
    rng = np.random.default_rng(SEED + 2)
    x = rng.uniform(-1.2, 1.2, QUANT_SHAPE).astype(np.float32)
    flat = x.reshape(-1)
    planted = rng.choice(flat.size, 3000, replace=False)
    flat[planted[:1000]] = np.nan
    flat[planted[1000:2000]] = np.inf
    flat[planted[2000:]] = -np.inf
    xd = torch.from_numpy(x).cuda()
    dither_err, ulaw_off = 0, 0
    for seed in (0, 1, 2**31 + 12345):
        q = dither.dither_i16(xd, seed)
        u = dither.ulaw_u8(xd, seed)
        torch.cuda.synchronize()
        err = int((q.int() - dither.dither_i16_reference(xd, seed).int())
                  .abs().max())
        dither_err = max(dither_err, err)
        print(f"f. seed {seed}: dither_i16 max |kernel - plain| {err} codes",
              flush=True)
        if err:
            raise AssertionError(f"dither_i16 differs from plain, seed {seed}")
        ulaw_off = max(ulaw_off, _ulaw_off(
            f"f. seed {seed}", u, dither.ulaw_u8_reference(xd, seed)))
    for fn in (dither.dither_i16, dither.ulaw_u8):
        a, b, c = fn(xd, 3), fn(xd, 3), fn(xd, 4)
        if not torch.equal(a, b) or torch.equal(a, c):
            raise AssertionError(f"{fn.__name__}: seeds do not act as seeds")
        for bad, args in (("non-contiguous", (xd.t(),)),
                          ("f64", (xd.double(),)),
                          ("x on the cpu, out on the card",
                           (xd[:2].cpu(), 0, torch.empty_like(a[:2])))):
            try:
                fn(*args)
            except KernelError as exc:
                print(f"f. {fn.__name__} {bad} raises: {exc}", flush=True)
            else:
                raise AssertionError(f"{fn.__name__}: {bad} did not raise")
    print("f. same seed twice gives the same codes, two seeds differ",
          flush=True)
    return float(dither_err), float(ulaw_off)


def batched_context(wt, device, f0=200.0, f1=8000.0):
    """benches/suite.py::_build_batched_ctx with bench.py's synthetic
    buffer: looping buffer -> lowpass Q 3, frequency f0 -> f1 Hz."""
    ctx = wt.OfflineAudioContext(2, BATCH_FRAMES, FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(_bench_data(), FS)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", q=3.0)
    filt.frequency.set_value_at_time(f0, 0.0)
    filt.frequency.exponential_ramp_to_value_at_time(f1, BATCH_SECONDS)
    src.connect(filt)
    filt.connect(ctx.destination)
    return ctx, src, filt


def sweep_rows(batch):
    sweeps = np.linspace(0.5, 2.0, batch, dtype=np.float32)
    base = np.geomspace(200.0, 8000.0, BATCH_FRAMES, dtype=np.float32)
    return sweeps[:, None] * base[None, :]


def lane_buffers(batch):
    """`batch` distinct synthetic stereo buffers of 2 s, amplitude 0.5."""
    w = np.linspace(0.004, 0.06, batch)[:, None]
    t = np.arange(BATCH_FRAMES)[None, :]
    return (0.5 * np.stack([np.sin(w * t), np.cos(1.3 * w * t)], axis=1)
            ).astype(np.float32)


def single_batch(wt, rows, buf):
    ctx, src, filt = batched_context(wt, DEVICE)
    gb = wt.GraphBatch(ctx, batch=1)
    gb.override_param(filt, "frequency", rows)
    gb.override_buffer(src, buf)
    return _host(gb.render())[0]


def phase_g(wt):
    ctx, src, filt = batched_context(wt, DEVICE)
    gb = wt.GraphBatch(ctx, batch=BATCH)
    print(f"g. plan: {gb.nb} blocks of {gb.cg.block_frames} frames, dense "
          f"params {gb.cg.dense_params}", flush=True)
    if gb.nb != 6 or gb.cg.block_frames != 16384:
        raise AssertionError("the batched graph did not plan 6 x 16384")
    own = _host(gb.render())
    spread = float(np.abs(own - own[:1]).max())
    print(f"g. before the override, max |lane - lane 0| = {spread:.3e}",
          flush=True)
    if spread > 0.0:
        raise AssertionError("lanes differ before any override")
    ref = batched_context(wt, DEVICE)[0].start_rendering_sync().to_array()
    _check_close("g. lane 0 vs the context's start_rendering_sync",
                 own[0, :, :BATCH_FRAMES], ref, 1e-6)

    rows = sweep_rows(BATCH)
    gb.override_param(filt, "frequency", rows)
    out = _host(gb.render())
    cctx, _, cfilt = batched_context(wt, "cpu")
    cpu = wt.GraphBatch(cctx, batch=2)
    cpu.override_param(cfilt, "frequency", rows[[0, BATCH - 1]])
    _check_close(f"g. lanes 0 and {BATCH - 1} vs a 2-instance CPU batch",
                 out[[0, BATCH - 1]], cpu.render().numpy(), 1e-4)

    bufs = lane_buffers(BATCH)
    gb.override_buffer(src, bufs)
    out = _host(gb.render())
    for i in (0, BATCH // 2, BATCH - 1):
        _check_close(f"g. per-instance buffer, lane {i} vs its single batch",
                     out[i], single_batch(wt, rows[i:i + 1], bufs[i:i + 1]),
                     1e-6)
    if gb.cg.failed:
        raise AssertionError(f"nodes failed: {gb.cg.failed}")
    return gb, filt, rows


def phase_h(gb, filt, rows, dither):
    x = gb.render()
    q = gb.render_i16()
    inside = x.abs() < 1.0
    base = torch.floor(x * 32767.0)
    qf = q.float()
    ok = ((qf == base) | (qf == base + 1.0)) | ~inside
    print(f"h. render_i16 {tuple(q.shape)} {q.dtype}: {int(inside.sum())} "
          f"samples in (-1, 1), all floor(32767 x) or +1: {bool(ok.all())}",
          flush=True)
    if q.dtype != torch.int16 or not bool(ok.all()):
        raise AssertionError("render_i16 codes are not the dithered render")
    if not torch.equal(q, dither.dither_i16_reference(x, 0)):
        raise AssertionError("render_i16 differs from the plain dither")
    print("h. render_i16 equals the plain dither of the render", flush=True)
    u = gb.render_u8()
    _ulaw_off("h. render_u8 vs the plain u-law of the render", u,
              dither.ulaw_u8_reference(x, 0))
    err = float(np.abs(dither.ulaw_decode_u8(_host(u))
                       - _host(x.clamp(-1.0, 1.0))).max())
    print(f"h. render_u8 decoded vs the render (clipped to [-1, 1]): max "
          f"|err| {err:.4f} (limit 0.06)", flush=True)
    if u.dtype != torch.uint8 or err >= 0.06:
        raise AssertionError("render_u8 does not track the render")
    direct = _host(gb.render_i16())
    for k, host in enumerate(gb.render_stream(3, fetch="i16")):
        if not np.array_equal(host, direct):
            raise AssertionError(f"render_stream batch {k} != render_i16")
    print("h. render_stream(3, 'i16') equals render_i16", flush=True)

    def updates(gb_, k):
        gb_.override_param(filt, "frequency", rows * (1.0 + 0.25 * k))

    streamed = list(gb.render_stream(3, updates=updates, fetch="f32"))
    for k, host in enumerate(streamed):
        updates(gb, k)
        d = float(np.abs(host - _host(gb.render())).max())
        print(f"h. render_stream with updates, batch {k}: max |stream - "
              f"direct| {d:.3e}", flush=True)
        if d != 0.0:
            raise AssertionError("render_stream batch differs from direct")
    gb.override_param(filt, "frequency", rows)


def mixed_corpus(wt):
    """32 each of three topologies, in one shuffled list; each shaper
    context drives its own curve (tanh at a drive of its own), so the
    shaper bucket shapes through a table of per-instance curves."""
    bufs = lane_buffers(MIXED_PER_TOPOLOGY)
    out = []
    for i in range(MIXED_PER_TOPOLOGY):
        s = 0.5 + 1.5 * i / (MIXED_PER_TOPOLOGY - 1)
        out.append(batched_context(wt, DEVICE, 200.0 * s, 8000.0 * s)[0])

        ctx = wt.OfflineAudioContext(2, BATCH_FRAMES, FS, device=DEVICE)
        src = ctx.create_buffer_source(loop=True)
        src.buffer = wt.AudioBuffer.from_array(bufs[i], FS)
        src.start()
        filt = ctx.create_biquad_filter(type="lowpass", frequency=3000.0, q=1.0)
        shaper = ctx.create_wave_shaper(curve=np.tanh(
            2.0 * s * np.linspace(-1.0, 1.0, CURVE_POINTS)).astype(np.float32))
        src.connect(filt)
        filt.connect(shaper)
        shaper.connect(ctx.destination)
        out.append(ctx)

        ctx = wt.OfflineAudioContext(2, BATCH_FRAMES, FS, device=DEVICE)
        src = ctx.create_buffer_source(loop=True)
        src.buffer = wt.AudioBuffer.from_array(_bench_data(), FS)
        src.start()
        env = ctx.create_gain(gain=0.0)
        env.gain.linear_ramp_to_value_at_time(s / 2.0, BATCH_SECONDS)
        src.connect(env)
        env.connect(ctx.destination)
        out.append(ctx)
    return out


def phase_i(wt, kernels):
    """Returns the launches on the batch path and the (curve table, x) of
    the shaper bucket's last curve-kernel call."""
    from webaudio_tpu_torch.nodes import waveshaper
    from webaudio_tpu_torch.ops import curve_kernel as ck

    mb = wt.MixedGraphBatch(mixed_corpus(wt))
    with _recording(waveshaper, "curve_lookup") as shaped:
        outs = mb.render()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"i. MixedGraphBatch: {len(outs)} contexts in {mb.num_buckets} "
          f"buckets; launches on the batch path (g-i): {launches}", flush=True)
    if mb.num_buckets != 3:
        raise AssertionError(f"expected 3 buckets, got {mb.num_buckets}")
    worst = 0.0
    for i, ctx in enumerate(mixed_corpus(wt)):
        want = ctx.start_rendering_sync().to_array()
        peak = float(np.abs(want).max())
        err = float(np.abs(outs[i] - want).max())
        worst = max(worst, err / peak)
        if outs[i].shape != want.shape or not err <= 1e-6 * peak:
            raise AssertionError(f"context {i}: {err} > 1e-6 x {peak}")
    print(f"i. every output vs its own start_rendering_sync: worst "
          f"{worst:.3e} x peak (limit 1e-6) -> ok", flush=True)
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} never launched on the batch path")
    curve, x = shaped[-1]
    print(f"i. the shaper bucket's curve kernel calls: {len(shaped)}, the "
          f"last at x {tuple(x.shape)}, curve table {tuple(curve.shape)} ("
          f"{_plan_text(ck._kernel().plan(CURVE_POINTS, x.numel(), len(curve)))})",
          flush=True)
    if curve.shape != (MIXED_PER_TOPOLOGY, CURVE_POINTS):
        raise AssertionError("the shaper bucket did not shape through a "
                             "table of per-instance curves")
    return launches, (curve, x)


def _median_events_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    return statistics.median(_events_ms(fn, 1) for _ in range(reps))


def _rates(name, batch, ms):
    print(f"j. {name}: median {ms:.3f} ms -> "
          f"{batch * BATCH_SECONDS * 1000.0 / ms:.1f} instance-audio-s per "
          f"wall s, {batch * 1000.0 / ms:.1f} graphs/s", flush=True)


def _profile(calls):
    """(device-busy us, wall us, top ops by device us per call, device
    operations (kernels, copies, fills) per call) over the calls, run back
    to back under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fn in calls:
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in rows
                  if e.device_type == DeviceType.CUDA)
    # device time by the aten op that launched it
    ops = sorted((e for e in rows if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:6]
    launches = sum(e.count for e in rows if e.device_type == DeviceType.CUDA)
    return busy_us, wall_us, [(e.key, e.self_device_time_total / len(calls))
                              for e in ops], launches / len(calls)


def _busy_launches(label, what, calls):
    """The device-busy share over `calls` run back to back under
    torch.profiler, printed with the device time per call by op and the
    device operations per call; returns (the share, the operations per
    call), (None, None) where the profiler saw no device time."""
    busy, wall, top, launches = _profile(calls)
    if busy <= 0:
        print(f"{label}: profiler saw no device time over {what}: busy "
              "share not measured", flush=True)
        return None, None
    print(f"{label}: profiler over {len(calls)} x {what}: device busy "
          f"{busy / 1000:.3f} ms of {wall / 1000:.3f} ms wall "
          f"({100.0 * busy / wall:.1f}% busy), {launches:.1f} device "
          f"operations a call; device us per call by op: "
          f"{[(k, round(t, 1)) for k, t in top]}", flush=True)
    return busy / wall, launches


def _busy_share(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    return _profile([fn] * reps)


def phase_j(wt, gb, filt, dither):
    ms = _median_events_ms(gb.render)
    _rates(f"staged render, {BATCH} instances", BATCH, ms)
    big_ctx, _, big_filt = batched_context(wt, DEVICE)
    big = wt.GraphBatch(big_ctx, batch=BIG_BATCH)
    big.override_param(big_filt, "frequency", sweep_rows(BIG_BATCH))
    _rates(f"staged render, {BIG_BATCH} instances", BIG_BATCH,
           _median_events_ms(big.render))
    del big
    _rates(f"render + host copy f32, {BATCH} instances", BATCH,
           _median_events_ms(lambda: gb.render().cpu()))
    _rates(f"render_i16 + host copy, {BATCH} instances", BATCH,
           _median_events_ms(lambda: gb.render_i16().cpu()))
    for fetch in ("i16", "u8"):
        for _ in gb.render_stream(2, fetch=fetch):
            pass
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in gb.render_stream(6, fetch=fetch):
                pass
            walls.append((time.perf_counter() - t0) * 1000.0 / 6)
        _rates(f"render_stream pipelined {fetch} (host clock, per batch, "
               f"median of 3 streams of 6)", BATCH, statistics.median(walls))
    busy_us, wall_us, top, _ = _busy_share(gb.render)
    if busy_us > 0:
        print(f"j. profiler over 3 renders of {BATCH}: device busy "
              f"{busy_us / 1000:.3f} ms of {wall_us / 1000:.3f} ms wall "
              f"({100.0 * busy_us / wall_us:.1f}% busy); device us per "
              f"render by op: {[(k, round(t, 1)) for k, t in top]}",
              flush=True)
    else:
        print("j. profiler saw no device time: device-busy share not "
              "measured", flush=True)

    xd = torch.from_numpy(np.random.default_rng(SEED + 3).uniform(
        -1.2, 1.2, QUANT_SHAPE).astype(np.float32)).cuda()
    # cold L2: calls alternate between two copies of x (201 MB each, four
    # times the L2), so no call finds its input in L2
    copies = [xd.clone() for _ in range(2)]
    times = {}
    for name, kern, plain, out_bytes in (
            ("dither_i16", dither.dither_i16, dither.dither_i16_reference, 2),
            ("ulaw_u8", dither.ulaw_u8, dither.ulaw_u8_reference, 1)):
        turn = [0]

        def cold():
            turn[0] += 1
            return kern(copies[turn[0] % 2], 0)

        k_dev, c_dev, p_dev = [], [], []
        for _ in range(2):
            p_dev.append(_graph_ms(lambda: plain(xd, 0), 5))
            k_dev.append(_graph_ms(lambda: kern(xd, 0), 20))
            c_dev.append(_graph_ms(cold, 20))
            c_dev.append(_graph_ms(cold, 20))
            k_dev.append(_graph_ms(lambda: kern(xd, 0), 20))
            p_dev.append(_graph_ms(lambda: plain(xd, 0), 5))
        k_ms, p_ms = statistics.median(k_dev), statistics.median(p_dev)
        c_ms = statistics.median(c_dev)
        nbytes = xd.numel() * (4 + out_bytes)
        print(f"j. {name} at {QUANT_SHAPE}: device time kernel warm L2 "
              f"{k_ms * 1000:.2f} us ({nbytes / k_ms / 1e6:.0f} GB/s of x in "
              f"+ codes out), cold L2 {c_ms * 1000:.2f} us "
              f"({nbytes / c_ms / 1e6:.0f} GB/s), plain {p_ms * 1000:.2f} us "
              f"({p_ms / k_ms:.1f}x)", flush=True)
        times[name] = (k_ms, p_ms, c_ms)
    del copies
    return times


# --- granular synthesis, k-n ------------------------------------------------


def _grain_sample():
    # benches/suite.py:509-511: the synthetic 2 s stereo sample
    return np.sin(np.arange(2 * 44100) * 0.05, dtype=np.float32)[None] \
        .repeat(2, 0)


def _grain_schedule(n_grains, seconds, offsets=None):
    """benches/suite.py::case_granular_grains' grains as (when, offset,
    rate), drawn from RandomState(1) in the suite's order; `offsets`
    replaces the offsets."""
    rng = np.random.RandomState(1)
    out = []
    for i in range(n_grains):
        when = i * (seconds - 0.2) / n_grains
        offset = 0.3 + 2.0 * (i / n_grains) + rng.rand() * 0.05
        rate = float(0.9 + 0.2 * rng.rand())
        out.append((when, float(offset if offsets is None else offsets[i]),
                    rate))
    return out


def granular_context(wt, device, n_grains, seconds=GRAIN_SECONDS,
                     offsets=None):
    """benches/suite.py::case_granular_grains: one buffer source and one
    gain envelope (0 -> 0.4 -> 0 over 90 ms) per grain, into the
    destination; 2 channels, 44.1 kHz."""
    ctx = wt.OfflineAudioContext(2, int(GRAIN_FS * seconds), GRAIN_FS,
                                 device=device)
    sample = wt.AudioBuffer.from_array(_grain_sample(), GRAIN_FS)
    for when, offset, rate in _grain_schedule(n_grains, seconds, offsets):
        src = ctx.create_buffer_source(playback_rate=rate)
        src.buffer = sample
        env = ctx.create_gain(gain=0.0)
        env.gain.set_value_at_time(0.0, when)
        env.gain.linear_ramp_to_value_at_time(0.4, when + 0.045)
        env.gain.linear_ramp_to_value_at_time(0.0, when + 0.09)
        src.connect(env)
        env.connect(ctx.destination)
        src.start(when, offset, 0.09)
    return ctx


def grain_oracle(wt, n_grains, seconds=GRAIN_SECONDS):
    """Every grain summed directly in numpy float64: the sub-sample start,
    the playhead in buffer samples, the duration limit in buffer time and
    the two-tap lerp with the non-looping end-of-buffer rule (reference
    audio_buffer_source.rs:795-815), times the grain's own envelope as its
    AudioParam compiles it (the reference's automation places a ramp's
    end on the quantum grid, up to a sample away from the analytic
    breakpoint; the fused bank splices the same values per lane)."""
    fs = GRAIN_FS
    x = _grain_sample().astype(np.float64)
    L = x.shape[1]
    edge = (2.0 * x[:, L - 1] - x[:, L - 2])[:, None]
    frames = int(fs * seconds)
    envs = [n.gain for n in granular_context(
        wt, "cpu", n_grains, seconds)._nodes.values()
        if type(n).__name__ == "GainNode"]
    out = np.zeros((2, frames))
    for (when, offset, rate), env in zip(
            _grain_schedule(n_grains, seconds), envs):
        rate = float(np.float32(rate))           # an AudioParam holds f32
        f = when * fs
        if abs(f - round(f)) <= 1.5e-8 * max(abs(f), 1.0):
            f = round(f)
        start = math.ceil(f)
        delta = start / fs - when
        pos0 = min(max(offset + delta * rate, 0.0), L / fs) * fs
        n = np.arange(int(0.09 * fs / rate) + 4)
        t = start + n
        pos = pos0 + rate * n
        ok = ((t < frames) & (n * rate + abs(delta * rate) * fs < 0.09 * fs)
              & (pos >= 0.0) & (pos < L))
        t, pos = t[ok], pos[ok]
        k = np.floor(pos).astype(np.int64)
        fr = pos - k
        nxt = np.where(k + 1 < L, x[:, np.minimum(k + 1, L - 1)],
                       np.where((fr >= 1.0 - 1e-6) | (k == 0), 0.0, edge))
        smp = x[:, k] * (1.0 - fr) + nxt * fr
        gain = env.compile_for_render(fs, frames).dense
        out[:, t] += smp * gain[t]
    return out


@contextlib.contextmanager
def _env(name, value):
    """Environment variable `name` set to `value` for the block (None:
    unset)."""
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def _grain_read(mode):
    """WEBAUDIO_GRAIN_READ=mode for the block (None: unset, i.e. auto)."""
    return _env("WEBAUDIO_GRAIN_READ", mode)


@contextlib.contextmanager
def _recording(module, name):
    """Wrap module.name so each call's arguments are recorded (the kernel
    still launches and counts); yields the list of calls."""
    calls = []
    orig = getattr(module, name)

    def spy(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def _fused_kernel(compiler, ctx):
    cg = compiler.compile_graph(dict(ctx._nodes), list(ctx._edges),
                                ctx.sample_rate, ctx.length,
                                ctx._destination.node_id, ctx.device)
    fused = [k for k in cg.kernels.values()
             if type(k).__name__ == "_FusedVoicesKernel"]
    if len(fused) != 1:
        raise AssertionError(f"expected one fused bank, got {len(fused)}")
    return cg, fused[0]


def _check_render(name, got, want):
    """The JAX suite's bound between grain read modes: 3e-5 absolute, and
    an error energy at most 1e-9 of the signal's."""
    err = float(np.abs(got - want).max())
    energy = float(np.sum((got.astype(np.float64) - want) ** 2)
                   / np.sum(want.astype(np.float64) ** 2))
    ok = (got.shape == want.shape and bool(np.isfinite(got).all())
          and err <= 3e-5 and energy <= 1e-9)
    print(f"{name}: max_abs_err {err:.3e} (limit 3e-5), error energy "
          f"{energy:.3e} of the signal's (limit 1e-9) -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: {err}, {energy}")
    return err


def _equal(name, got, want):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    same = torch.equal(got, want)
    print(f"{name}: bit-equal {same} max_abs_err {err:.3e}", flush=True)
    if not same:
        raise AssertionError(f"{name}: kernel differs from plain")
    return err


def _offset(t, offset):
    """A contiguous copy of t starting `offset` elements past a 16-byte
    boundary (offset 0: an aligned copy)."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


# (g, w, B): groups of 1 and 3 on rows whose length is not a multiple of 4,
# 2, 8, 16 and 128 (group ends by warp shuffle), 12 (a multiple of 4 that
# does not divide 128)
LERP_EDGE = [(1, 4, 1001), (1, 4, 1024), (2, 5, 1026), (3, 7, 999),
             (8, 12, 4736), (12, 16, 4740), (16, 21, 4736), (128, 192, 4736)]


def _lerp_edge_cases(gr, rng):
    """grouped_lerp bit for bit at LERP_EDGE, 1-3 channels, with and
    without a wrap, per-instance playheads, and pi, fr and out aligned
    and one float off a 16-byte boundary (the scalar path)."""
    L, R = 5000, 3
    worst, n = 0.0, 0
    for g, w, B in LERP_EDGE:
        base = rng.integers(0, L - w, size=(2, R, B // g))
        step = rng.random((2, R, B // g)) * ((w - 3) / g)
        pif = base[..., None] + np.arange(g) * step[..., None]
        pi = np.floor(pif).astype(np.int32).reshape(2, R, B)
        fr = torch.from_numpy((pif - np.floor(pif)).astype(np.float32)
                              .reshape(2, R, B)).cuda()
        for C in (1, 2, 3):
            ext = torch.from_numpy(rng.standard_normal(
                (1, C, L + w + 2)).astype(np.float32)).cuda()
            for wrap in (0, L):
                p = torch.from_numpy(pi + (3 * L if wrap else 0)).cuda()
                for offset in (0, 1):
                    po, fo = _offset(p, offset), _offset(fr, offset)
                    got = gr.grouped_lerp(ext, po, fo, g, w, wrap)
                    want = gr.grouped_lerp_reference(ext, po, fo, g, w, wrap)
                    # and through the launcher into an output as offset
                    out = _offset(torch.full_like(want, float("nan")), offset)
                    gr._launch_lerp(gr._launchers()["grouped_lerp"], out,
                                    ext, po, fo, g, w, wrap)
                    torch.cuda.synchronize()
                    worst = max(worst, float((got - want).abs().max()))
                    n += 1
                    if not (torch.equal(got, want)
                            and torch.equal(out, want)):
                        raise AssertionError(
                            f"k. grouped_lerp differs at g {g}, B {B}, C {C}, "
                            f"wrap {wrap}, offset {offset}")
    print(f"k. grouped_lerp at {n} edge shapes (g in "
          f"{sorted({c[0] for c in LERP_EDGE})}, B in "
          f"{sorted({c[2] for c in LERP_EDGE})}, C 1-3, wrap, offset pointers)"
          f": bit-equal True max_abs_err {worst:.3e}", flush=True)
    return worst


def _bank_edge_cases(gr, rng):
    """grain_bank bit for bit at nq in {1, 3, 3446} x K in {1, 9, 33} (33:
    more lanes than a warp), with mixed instance axes and gain and out
    aligned and one float off a 16-byte boundary."""
    I, C, L, frame0 = 2, 2, 3000, 128 * 5
    data = np.sin(np.arange(L) * 0.05)[None].repeat(C, 0)
    axes_cycle = [(False, True, True), (True, False, False),
                  (True, True, True)]
    worst, n = 0.0, 0
    for a_i, (nq, K) in enumerate([(x, k) for x in (1, 3, 3446)
                                   for k in (1, 9, 33)]):
        ext_i, fld_i, gain_i = axes_cycle[a_i % 3]
        nf, B = (I if fld_i else 1), nq * 128
        sv = frame0 + 128 * np.arange(nq) + rng.integers(-200, 128,
                                                         (nf, K, nq))
        ok = (rng.random((nf, K, nq)) > 0.15).astype(np.int32)
        ev = sv + rng.integers(0, 600, (nf, K, nq))
        ok[:, 0] = 1                             # lane 0 sounds throughout
        sv[:, 0], ev[:, 0] = frame0 - 200, frame0 + B
        base = rng.integers(-150, L + 20, (nf, K, nq))
        base[..., ::4] = L - 60
        base[..., 1::7] = -40
        ext = np.zeros((I if ext_i else 1, C, L + 41), np.float32)
        ext[:, :, :L] = data * np.float32([1.0, -0.5])[:ext.shape[0], None,
                                                         None]
        ext[:, :, L] = 2.0 * ext[:, :, L - 1] - ext[:, :, L - 2]
        args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
            ext, ext[:, :, L], ok, sv.astype(np.int32), ev.astype(np.int32),
            base.astype(np.int32), rng.random((nf, K, nq)).astype(np.float32),
            rng.uniform(0.9, 1.37, (nf, K, nq)).astype(np.float32))]
        gain = torch.from_numpy(rng.uniform(-0.2, 1.3, (
            I if gain_i else 1, K, B)).astype(np.float32)).cuda()
        for offset in (0, 1):
            full = args + [_offset(gain, offset), frame0, L, 0.0, 1.0]
            got = gr.grain_bank(*full)
            want = gr.grain_bank_reference(*full)
            # and through the launcher into an output as offset as gain
            out = _offset(torch.full_like(want, float("nan")), offset)
            gr._launch_bank(gr._launchers()["grain_bank"], out, *full)
            torch.cuda.synchronize()
            worst = max(worst, float((got - want).abs().max()))
            n += 1
            if not (torch.equal(got, want) and torch.equal(out, want)) \
                    or float(want.abs().max()) <= 0.1:
                raise AssertionError(f"k. grain_bank differs (or is silent) "
                                     f"at nq {nq}, K {K}, offset {offset}")
    print(f"k. grain_bank at {n} edge shapes (nq 1, 3, 3446 x K 1, 9, 33, "
          f"mixed instance axes, offset gain and out): bit-equal True "
          f"max_abs_err {worst:.3e}", flush=True)
    return worst


def phase_k(wt, gr, fusion, KernelError):
    rng = np.random.default_rng(SEED + 4)
    L, R, B = 2 * 44100, 5, GRAIN_BLOCK
    worst = {"grain_bank": 0.0, "grouped_lerp": 0.0}
    for g, w in ((16, 21), (128, 192)):
        # playheads monotone within each g-sample group, as a lane's are
        base = rng.integers(0, L - w, size=(R, B // g))
        step = rng.random((R, B // g)) * ((w - 3) / g)
        pif = base[:, :, None] + np.arange(g) * step[:, :, None]
        pi = np.floor(pif).astype(np.int32).reshape(1, R, B)
        fr = torch.from_numpy((pif - np.floor(pif)).astype(np.float32)
                              .reshape(1, R, B)).cuda()
        for C in (1, 2, 3):
            ext = torch.from_numpy(rng.standard_normal(
                (1, C, L + w + 2)).astype(np.float32)).cuda()
            for wrap in (0, L):
                p = torch.from_numpy(pi + (3 * L if wrap else 0)).cuda()
                got = gr.grouped_lerp(ext, p, fr, g, w, wrap)
                worst["grouped_lerp"] = max(worst["grouped_lerp"], _equal(
                    f"k. grouped_lerp (g, w) = ({g}, {w}), C = {C}, "
                    f"wrap {wrap}, {R} x {B}", got,
                    gr.grouped_lerp_reference(ext, p, fr, g, w, wrap)))

    with _grain_read(None), _recording(fusion, "grain_bank") as calls:
        granular_context(wt, "cuda", 400).start_rendering_sync()
    args = calls[-1]
    worst["grain_bank"] = _equal(
        f"k. grain_bank on the 400-grain case's inputs, gain "
        f"{tuple(args[8].shape)}", gr.grain_bank(*args),
        gr.grain_bank_reference(*args))

    # synthetic lanes: grains that start and stop inside quanta, quanta
    # without a grain, playheads that begin before sample 0 and run past
    # the buffer's end every fourth quantum
    K, nq = 5, B // 128
    sv = rng.integers(-300, B, (K, nq))
    base = rng.integers(-150, L + 20, (K, nq))
    base[:, ::4] = L - 60
    base[:, 1::7] = -40
    data = _grain_sample()
    ext = np.zeros((2, L + 41), np.float32)
    ext[:, :L] = data
    ext[:, L] = 2.0 * data[:, L - 1] - data[:, L - 2]
    synth = [torch.from_numpy(np.ascontiguousarray(a))[None].cuda() for a in (
        ext, ext[:, L],
        (rng.random((K, nq)) > 0.15).astype(np.int32), sv.astype(np.int32),
        (sv + rng.integers(0, 600, (K, nq))).astype(np.int32),
        base.astype(np.int32), rng.random((K, nq)).astype(np.float32),
        rng.uniform(0.9, 1.0995, (K, nq)).astype(np.float32),
        rng.uniform(-0.2, 1.3, (K, B)).astype(np.float32))]
    synth += [0, L, 0.0, 1.0]
    worst["grain_bank"] = max(worst["grain_bank"], _equal(
        "k. grain_bank on synthetic lanes crossing both buffer ends",
        gr.grain_bank(*synth), gr.grain_bank_reference(*synth)))

    worst["grouped_lerp"] = max(worst["grouped_lerp"],
                                _lerp_edge_cases(gr, rng))
    worst["grain_bank"] = max(worst["grain_bank"], _bank_edge_cases(gr, rng))

    ext2 = torch.zeros((1, 2, 100), device="cuda")
    p2 = torch.zeros((1, 2, 64), dtype=torch.int32, device="cuda")
    f2 = torch.zeros((1, 2, 64), device="cuda")
    bad = [
        ("grouped_lerp, non-contiguous pi", lambda: gr.grouped_lerp(
            ext2, p2.transpose(1, 2), f2.transpose(1, 2), 16, 21)),
        ("grouped_lerp, f64 fr", lambda: gr.grouped_lerp(
            ext2, p2, f2.double(), 16, 21)),
        ("grouped_lerp, pi on the cpu", lambda: gr.grouped_lerp(
            ext2, p2.cpu(), f2, 16, 21)),
        ("grain_bank, non-contiguous gain", lambda: gr.grain_bank(
            *args[:8], args[8].transpose(1, 2), *args[9:])),
        ("grain_bank, int64 ok", lambda: gr.grain_bank(
            args[0], args[1], args[2].long(), *args[3:])),
    ]
    for what, call in bad:
        try:
            call()
        except KernelError as exc:
            print(f"k. {what} raises: {exc}", flush=True)
        else:
            raise AssertionError(f"{what} did not raise")
    return worst


def phase_l(wt, gr, compiler, fusion, n, phase="l"):
    label = f"{phase}. {n} grains"
    with _grain_read(None):
        ctx = granular_context(wt, "cuda", n)
        cg, kern = _fused_kernel(compiler, ctx)
        print(f"{label}: plan {cg.block_frames}-frame blocks, V {kern.V}, "
              f"K {kern.K} lanes of {kern.lane_start.shape[1]} slots, read "
              f"mode {kern.read_mode} (g, w) = ({kern.win_Qs}, "
              f"{kern.win_W})", flush=True)
        if kern.read_mode != "fused" or cg.block_frames != GRAIN_BLOCK:
            raise AssertionError("the granular case did not plan K2 over "
                                 "one 441,088-frame block")
        gr.grain_bank.launches = 0
        gr.grouped_lerp.launches = 0
        out = ctx.start_rendering_sync().to_array()
        launches = {"grain_bank": gr.grain_bank.launches,
                    "grouped_lerp": gr.grouped_lerp.launches}
        segs = ctx.render_stats["segments"]
        print(f"{label}: start_rendering_sync launched {launches}, segments "
              f"{segs}", flush=True)
        if launches["grain_bank"] < 1 or any(s["failed"] for s in segs):
            raise AssertionError("K2 did not launch on the granular path")
        cpu = granular_context(wt, "cpu", n).start_rendering_sync() \
            .to_array()
    _check_render(f"{label}: cuda vs the port's cpu render", out, cpu)
    oracle = grain_oracle(wt, n)
    err = _check_close(f"{label}: vs the numpy f64 oracle", out, oracle,
                       1e-4)
    print(f"{label}: oracle error {err / np.abs(oracle).max():.3e} x peak",
          flush=True)
    lerp = 0
    for mode in ("grouped_v", "window", "grouped_pl", "gather"):
        with _grain_read(mode):
            ctx = granular_context(wt, "cuda", n)
            _, kern = _fused_kernel(compiler, ctx)
            gr.grouped_lerp.launches = 0
            forced = ctx.start_rendering_sync().to_array()
            moved = gr.grouped_lerp.launches
        print(f"{label}, WEBAUDIO_GRAIN_READ={mode}: read mode "
              f"{kern.read_mode} (g, w) = ({kern.win_Qs}, {kern.win_W}), "
              f"grouped_lerp launches {moved}", flush=True)
        if kern.read_mode != mode or (mode != "gather") != (moved > 0):
            raise AssertionError(f"{mode}: not read through its route")
        lerp += moved
        if mode == "window":
            launches["window"] = moved
        _check_render(f"{label}, {mode} vs fused", forced, out)
    launches["grouped_lerp"] = lerp
    return {"n": n, "launches": launches}


def _entries(new, old, name):
    """{"old": old[name], "new": new[name]}, without "old" when old is None."""
    return ({} if old is None else {"old": old[name]}) | {"new": new[name]}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def phase_m(wt, gr, compiler, fusion, cases, old=None):
    out = {"grain_bank": {}, "grouped_lerp": {}, "window": {}}
    for case in cases:
        n = case["n"]
        label = f"m. {n} grains"
        with _grain_read(None):
            _render_ms(label, lambda: granular_context(wt, "cuda", n),
                       GRAIN_SECONDS)

            ctx = granular_context(wt, "cuda", n)
            dest = ctx._destination.node_id
            t0 = time.perf_counter()
            nodes2, _, _ = fusion.fuse_sources(
                dict(ctx._nodes), list(ctx._edges), dest,
                sample_rate=GRAIN_FS)
            t_fuse = time.perf_counter() - t0
            (fnode,) = [v for v in nodes2.values()
                        if type(v).__name__ == "_FusedVoicesNode"]
            t0 = time.perf_counter()
            fusion._plan_grain_lanes(fnode.sources, GRAIN_FS)
            t_lane = time.perf_counter() - t0
            t0 = time.perf_counter()
            for p in fnode.params.values():
                p.compile_for_render(GRAIN_FS, GRAIN_BLOCK, 0)
            t_splice = time.perf_counter() - t0
            t0 = time.perf_counter()
            cg = compiler.compile_graph(dict(ctx._nodes), list(ctx._edges),
                                        GRAIN_FS, GRAIN_FRAMES, dest, "cuda")
            t_compile = time.perf_counter() - t0
            # the offline context then advances every member's timeline to
            # the segment's end (its control-side state after the render)
            t0 = time.perf_counter()
            ctx._advance_param_state(GRAIN_FRAMES)
            t_advance = time.perf_counter() - t0
            print(f"{label}: host planning (host clock): fuse_sources with "
                  f"the lane plan {t_fuse * 1e3:.3f} ms, the lane plan alone "
                  f"{t_lane * 1e3:.3f} ms, splicing {len(fnode.params)} lane "
                  f"envelopes {t_splice * 1e3:.3f} ms, compile_graph "
                  f"{t_compile * 1e3:.3f} ms; advancing the {3 * n} param "
                  f"timelines to the render's end {t_advance * 1e3:.3f} ms",
                  flush=True)

            compiler.render_compiled(cg, GRAIN_FRAMES)
            loop = [_events_ms(lambda: compiler.render_compiled(
                cg, GRAIN_FRAMES), 5) for _ in range(3)]
            loop_ms = statistics.median(loop)
            print(f"{label}: block loop on a compiled plan median "
                  f"{loop_ms:.3f} ms of {['%.3f' % r for r in loop]} (5 "
                  f"renders each) -> realtime factor "
                  f"{GRAIN_SECONDS * 1000.0 / loop_ms:.1f}x", flush=True)

            ctxs = [granular_context(wt, "cuda", n) for _ in range(3)]
            _busy_launches(label, "start_rendering_sync",
                           [c.start_rendering_sync for c in ctxs])
            _busy_launches(label, "block loop", [
                lambda: compiler.render_compiled(cg, GRAIN_FRAMES)] * 3)

            with _recording(fusion, "grain_bank") as calls:
                granular_context(wt, "cuda", n).start_rendering_sync()
        a = calls[-1]
        _, K, nq = a[2].shape
        B, C = nq * 128, a[0].shape[1]
        key = "" if n == 400 else "_800"
        out["grain_bank"].update({f"{k}{key}": v for k, v in _kernel_times(
            f"{label}: grain_bank (K2) at K {K}, B {B}, C {C}",
            gr._launch_bank, _entries(gr._launchers(), old, "grain_bank"),
            gr.grain_bank_reference, a, _nbytes(*a) + C * B * 4,
            (14 + 8 * C) * K * B).items()})

        for mode, name in (("grouped_v", "grouped_lerp"),
                           ("window", "window")):
            if mode == "window" and n != 400:
                continue
            with _grain_read(mode), \
                    _recording(fusion, "grouped_lerp") as calls:
                granular_context(wt, "cuda", n).start_rendering_sync()
            a = calls[-1]
            ext, pi, fr, g, w = a[:5]
            _, R, B = pi.shape
            C = ext.shape[1]
            res = _kernel_times(
                f"{label}: grouped_lerp ({'K4, ' if mode == 'window' else ''}"
                f"{mode}) at (g, w) = ({g}, {w}), {R} x {B}, C {C}",
                gr._launch_lerp, _entries(gr._launchers(), old,
                                          "grouped_lerp"),
                gr.grouped_lerp_reference, a,
                _nbytes(ext, pi, fr) + C * R * B * 4, (8 + 3 * C) * R * B)
            res["library_ms"], res["library_err"] = _grid_sample(gr, a)
            print(f"{label}: grid_sample at the {mode} inputs "
                  f"{res['library_ms'] * 1000:.2f} us, max |grid_sample - "
                  f"kernel| {res['library_err']:.3e}", flush=True)
            out[name].update({f"{k}{key}": v for k, v in res.items()})
    return out


def _kernel_times(label, launch, entries, plain, a, nbytes, ops):
    """A kernel at the path's inputs `a`: `launch(e, out, *a)` runs entry
    `e` into `out`, for each of `entries` (name -> entry: "new" this
    source's kernel, "old" an earlier build of the same source, others
    variants).  Each is first checked bit-equal to the plain version.
    Device ms per call from CUDA-graph replay with the L2 warm (the same
    inputs and output every call) and cold (each call on its own copy of
    them, rotating through more than 150 MB; the H100's L2 holds 50 MB), in
    turns: plain, the entries, the entries backwards, plain, twice.  The
    share of the bound is the cold time's: the bound reads every input from
    HBM, the warm calls from L2.  Printed, and returned with GB/s (keys of
    entries other than "new" carry their name as a prefix)."""
    want = plain(*a)
    for name, e in entries.items():
        got = launch(e, torch.full_like(want, float("nan")), *a)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: the {name} kernel differs from "
                                 "its plain version")
    count = max(2, math.ceil(150e6 / nbytes))
    sets = [[x.clone() if isinstance(x, torch.Tensor) else x for x in a]
            for _ in range(count)]
    outs = [torch.empty_like(want) for _ in range(count)]

    def warm(e):
        return lambda: launch(e, outs[0], *a)

    def cold(e):
        turn = [0]

        def call():
            k = turn[0] % count
            turn[0] += 1
            return launch(e, outs[k], *sets[k])
        return call

    order = list(entries) + list(entries)[::-1]
    runs = {(x, t): [] for x in entries for t in ("warm", "cold")}
    p_runs = []
    for _ in range(2):
        p_runs.append(_graph_ms(lambda: plain(*a), 5))
        for x in order:
            runs[x, "warm"].append(_graph_ms(warm(entries[x]), 20))
        for x in order:
            runs[x, "cold"].append(_graph_ms(cold(entries[x]), count))
        p_runs.append(_graph_ms(lambda: plain(*a), 5))
    med = {k: statistics.median(v) for k, v in runs.items()}
    b_ms, b_by = _bound(nbytes, ops)
    p_ms = statistics.median(p_runs)
    res = {}
    for x in entries:
        warm_ms, cold_ms = med[x, "warm"], med[x, "cold"]
        pre = "" if x == "new" else f"{x}_"
        res.update({f"{pre}ms": warm_ms, f"{pre}cold_ms": cold_ms,
                    f"{pre}share_of_bound": b_ms / cold_ms,
                    f"{pre}gb_per_s": nbytes / warm_ms / 1e6,
                    f"{pre}cold_gb_per_s": nbytes / cold_ms / 1e6})
        tag = {"new": "", "old": " [old kernel]"}.get(x, f" [{x}]")
        print(f"{label}{tag}: device time warm L2 "
              f"{warm_ms * 1000:.2f} us ({nbytes / warm_ms / 1e6:.1f} GB/s; "
              f"runs {[round(t * 1000, 2) for t in runs[x, 'warm']]}), cold "
              f"L2 {cold_ms * 1000:.2f} us ({100 * b_ms / cold_ms:.1f}% of "
              f"the bound, {nbytes / cold_ms / 1e6:.1f} GB/s; runs "
              f"{[round(t * 1000, 2) for t in runs[x, 'cold']]}, {count} "
              f"input copies)", flush=True)
    res.update({"plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by})
    print(f"{label}: plain {p_ms * 1000:.2f} us, bound {b_ms * 1000:.2f} us "
          f"({b_by}; {nbytes / 1e6:.2f} MB)", flush=True)
    return res


def _grid_sample(gr, a):
    """Yardstick for the grouped lerp: grid_sample's linear mode with
    align_corners=True at the positions pi + fr (the group's row clip
    never binds on the path, so the contract is the lerp at pi + fr).  The
    positions reach it as f32 coordinates, so it is not bit-equal.
    Returns (device ms, max |grid_sample - kernel|)."""
    ext, pi, fr = a[:3]
    _, R, B = pi.shape
    C, Lx = ext.shape[1], ext.shape[2]
    pos = pi.double() + fr.double()
    grid = torch.stack([pos / (Lx - 1) * 2.0 - 1.0,
                        torch.zeros_like(pos)], -1).float() \
        .reshape(1, 1, R * B, 2)
    img = ext.reshape(1, C, 1, Lx)

    def library():
        return torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    err = float((library().reshape(1, C, R, B) - gr.grouped_lerp(*a))
                .abs().max())
    return statistics.median(_graph_ms(library, 20) for _ in range(3)), err


def phase_n(wt, gr):
    rng = np.random.default_rng(SEED + 5)
    n, seconds = 80, 2.0
    # offsets that keep every grain inside the 2 s sample, so the grains'
    # audible ends (and so the lanes) do not depend on them
    offsets = [0.1 + 1.5 * np.arange(n) / n + 0.05 * rng.random(n)
               for _ in range(MIXED_GRAIN_CONTEXTS)]
    with _grain_read(None):
        ctxs = [granular_context(wt, DEVICE, n, seconds, o) for o in offsets]
        t0 = time.perf_counter()
        mb = wt.MixedGraphBatch(ctxs)
        t1 = time.perf_counter()
        gr.grain_bank.launches = 0
        outs = mb.render()
        t2 = time.perf_counter()
        print(f"n. MixedGraphBatch of {len(ctxs)} granular contexts ({n} "
              f"grains, {seconds} s): {mb.num_buckets} bucket(s), planned "
              f"in {t1 - t0:.3f} s, rendered and fetched in {t2 - t1:.3f} s "
              f"(host clock), grain_bank launches {gr.grain_bank.launches}",
              flush=True)
        if mb.num_buckets != 1 or gr.grain_bank.launches < 1:
            raise AssertionError("the granular corpus did not form one "
                                 "bucket through K2")
        worst = 0.0
        for o, got in zip(offsets, outs):
            want = granular_context(wt, DEVICE, n, seconds, o) \
                .start_rendering_sync().to_array()
            peak = float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            worst = max(worst, err / peak)
            if got.shape != want.shape or not err <= 1e-6 * peak:
                raise AssertionError(f"n. {err} > 1e-6 x {peak}")
    print(f"n. every output vs its own start_rendering_sync: worst "
          f"{worst:.3e} x peak (limit 1e-6) -> ok", flush=True)


# --- oscillators and voice banks, o-r ---------------------------------------


def _start_frame(t, fs):
    """ceil(t fs) with the sticky sample-grid snap of a scheduled start."""
    f = t * fs
    if abs(f - round(f)) <= 1.5e-8 * max(abs(f), 1.0):
        f = round(f)
    return math.ceil(f)


def _osc_schedule(n_osc):
    """benches/suite.py::case_many_oscillators' voices as (frequency,
    detune, t0), drawn from RandomState(42) in the suite's order."""
    rng = np.random.RandomState(42)
    return [(float(80 + rng.rand() * 2000), float(rng.randn() * 15),
             float(rng.rand() * 2.0)) for _ in range(n_osc)]


def oscillators_context(wt, device, seconds=SECONDS, n_osc=OSC_VOICES):
    """benches/suite.py::case_many_oscillators (BASELINE config 2): sine
    oscillators at 80-2,080 Hz with +-15-cent detune, each through its ADSR
    gain envelope (a 50 ms linear attack, setTarget decay to 0.6 with tau
    0.1 s, setTarget release at t0 + 4 s with tau 0.3 s), into a mix gain of
    1/n, into the stereo destination; 48 kHz."""
    ctx = wt.OfflineAudioContext(2, int(FS * seconds), FS, device=device)
    mix = ctx.create_gain(gain=1.0 / n_osc)
    mix.connect(ctx.destination)
    for f, d, t0 in _osc_schedule(n_osc):
        o = ctx.create_oscillator(frequency=f, detune=d)
        env = ctx.create_gain(gain=0.0)
        env.gain.set_value_at_time(0.0, t0)
        env.gain.linear_ramp_to_value_at_time(1.0, t0 + 0.05)
        env.gain.set_target_at_time(0.6, t0 + 0.05, 0.1)
        env.gain.set_target_at_time(0.0, t0 + 4.0, 0.3)
        o.connect(env)
        env.connect(mix)
        o.start(t0)
    return ctx


def oscillators_oracle(n_osc=OSC_VOICES, frames=FRAMES):
    """Config 2 in numpy float64 under W3C hold semantics, one channel (the
    destination copies it to both): each voice's phase in closed form from
    its start time t0 (so the sub-sample start) at its computed frequency
    f 2^(d / 1200) rounded to f32 as the engine rounds it on the host,
    sounding from frame ceil(t0 fs), times its envelope by the spec's
    formulas: the linear ramp from 0 at t0 to 1 at t0 + 0.05, then
    0.6 + 0.4 exp(-(t - t0 - 0.05) / 0.1), from t0 + 4 that value times
    exp(-(t - t0 - 4) / 0.3); summed in chunks, times the mix gain."""
    sched = np.array(_osc_schedule(n_osc))
    f, d = sched[:, 0].astype(np.float32), sched[:, 1].astype(np.float32)
    comp = (f * np.exp2(d / np.float32(1200.0))).astype(np.float32)
    comp = comp.astype(np.float64)[:, None]
    t0 = sched[:, 2][:, None]
    start = np.array([_start_frame(x, FS) for x in sched[:, 2]])[:, None]
    at_release = 0.6 + 0.4 * np.exp(-3.95 / 0.1)
    out = np.zeros(frames)
    for c0 in range(0, frames, ORACLE_CHUNK):
        n = np.arange(c0, min(c0 + ORACLE_CHUNK, frames))
        rel = n[None] / FS - t0
        ph = rel * comp
        ph -= np.floor(ph)
        env = np.where(
            rel < 0.05, rel / 0.05,
            np.where(rel < 4.0, 0.6 + 0.4 * np.exp(-(rel - 0.05) / 0.1),
                     at_release * np.exp(-(rel - 4.0) / 0.3)))
        out[n] = np.where(n[None] >= start, np.sin(2.0 * np.pi * ph) * env,
                          0.0).sum(0)
    return out * float(np.float32(1.0 / n_osc))


def _bank_voices(n_osc):
    """benches/suite.py::case_many_oscillators_fused's voices: frequencies,
    starts, stops and pans from RandomState(42) in the suite's order."""
    rng = np.random.RandomState(42)
    freqs = 80 + rng.rand(n_osc) * 2000
    starts = rng.rand(n_osc) * 2.0
    stops = rng.rand(n_osc) * 2.0 + 6.0
    return freqs, starts, stops, rng.rand(n_osc) * 2 - 1


def bank_context(wt, device, seconds=SECONDS, n_osc=OSC_VOICES):
    """benches/suite.py::case_many_oscillators_fused: config 2 as one
    OscillatorBankNode, analytic ADSR (attack 50 ms, decay 0.1 s to 0.6,
    release 0.3 s), per-voice pans, stereo; 48 kHz."""
    ctx = wt.OfflineAudioContext(2, int(FS * seconds), FS, device=device)
    freqs, starts, stops, pans = _bank_voices(n_osc)
    ctx.create_oscillator_bank(
        frequencies=freqs, starts=starts, stops=stops, attacks=0.05,
        decays=0.1, sustains=0.6, releases=0.3, volumes=1.0 / n_osc,
        stereo=True, pans=pans).connect(ctx.destination)
    return ctx


def bank_oracle(n_osc=OSC_VOICES, frames=FRAMES):
    """The bank in numpy float64 from its voices' f32 values: phase
    f (t - start) mod 1, the envelope clip((t - start) / a, 0, 1) up to
    the attack's end, s + (1 - s) exp(-(t - start - a) / d) after it, times
    exp(-(t - stop) / r) after the stop, each voice times its volume and
    its equal-power pan gains sin((1 - x) pi / 2), sin(x pi / 2) at
    x = (pan + 1) / 2; summed in chunks."""
    freqs, starts, stops, pans = (np.asarray(a, np.float32).astype(
        np.float64)[:, None] for a in _bank_voices(n_osc))
    a, dcy, s, rel = (float(np.float32(v)) for v in (0.05, 0.1, 0.6, 0.3))
    vol = float(np.float32(1.0 / n_osc))
    x = (pans + 1.0) / 2.0
    gains = np.stack([np.sin((1.0 - x) * np.pi / 2), np.sin(x * np.pi / 2)])
    out = np.zeros((2, frames))
    for c0 in range(0, frames, ORACLE_CHUNK):
        n = np.arange(c0, min(c0 + ORACLE_CHUNK, frames))
        t = n[None] / FS
        on = t - starts
        ph = freqs * on
        ph -= np.floor(ph)
        env = np.where(on - a > 0.0, s + (1.0 - s) * np.exp(-(on - a) / dcy),
                       np.clip(on / a, 0.0, 1.0))
        off = t - stops
        env = np.where(off > 0.0, env * np.exp(-off / rel), env)
        voice = np.where(on >= 0.0, np.sin(2.0 * np.pi * ph) * env, 0.0) * vol
        out[:, n] = (voice[None] * gains).sum(1)
    return out


def drive_context(wt, device, seconds=SECONDS, n_voices=DRIVE_VOICES):
    """A voice-distortion bank: sawtooth voices at 55-495 Hz, each through
    its own WaveShaper (a 2,048-point tanh curve at a drive of 1-8 of its
    own), a constant lowpass biquad (600-4,600 Hz, Q 1), a gain envelope
    (20 ms linear attack to 0.1, held, a 0.3 s linear release) and a
    constant StereoPanner, into the destination; drawn from
    RandomState(7); 48 kHz."""
    ctx = wt.OfflineAudioContext(2, int(FS * seconds), FS, device=device)
    rng = np.random.RandomState(7)
    for _ in range(n_voices):
        freq, drive = 55.0 + 440.0 * rng.rand(), 1.0 + 7.0 * rng.rand()
        cutoff, pan = 600.0 + 4000.0 * rng.rand(), 2.0 * rng.rand() - 1.0
        t0 = 2.0 * rng.rand()
        t1 = t0 + 2.0 + 5.0 * rng.rand()
        o = ctx.create_oscillator(type="sawtooth", frequency=float(freq))
        shaper = ctx.create_wave_shaper(curve=np.tanh(
            drive * np.linspace(-1.0, 1.0, CURVE_POINTS)).astype(np.float32))
        filt = ctx.create_biquad_filter(type="lowpass",
                                        frequency=float(cutoff), q=1.0)
        env = ctx.create_gain(gain=0.0)
        env.gain.set_value_at_time(0.0, t0)
        env.gain.linear_ramp_to_value_at_time(0.1, t0 + 0.02)
        env.gain.set_value_at_time(0.1, t1)
        env.gain.linear_ramp_to_value_at_time(0.0, t1 + 0.3)
        panner = ctx.create_stereo_panner(pan=float(pan))
        o.connect(shaper)
        shaper.connect(filt)
        filt.connect(env)
        env.connect(panner)
        panner.connect(ctx.destination)
        o.start(t0)
        o.stop(t1 + 0.3)
    return ctx


def _blocks(compiler, cg):
    """The number of blocks a compiled plan walks."""
    return compiler._pad_len(cg.total_frames, cg.block_frames) // \
        cg.block_frames


def _plan(compiler, ctx):
    """(compiled plan, block count) of the context's whole render."""
    cg = compiler.compile_graph(dict(ctx._nodes), list(ctx._edges),
                                ctx.sample_rate, ctx.length,
                                ctx._destination.node_id, ctx.device)
    return cg, _blocks(compiler, cg)


def _main_path(ctx, kernels):
    """start_rendering_sync of ctx with every kernel's count from 0: (the
    render, the launches)."""
    for k in kernels:
        k.launches = 0
    out = ctx.start_rendering_sync().to_array()
    segs = ctx.render_stats["segments"]
    if any(s["failed"] for s in segs):
        raise AssertionError(f"nodes failed: {segs}")
    return out, {k.__name__: k.launches for k in kernels}


def phase_o(wt, compiler, kernels):
    label = f"o. config 2, {OSC_VOICES} oscillators, auto-fused"
    ctx = oscillators_context(wt, "cuda")
    cg, kern = _fused_kernel(compiler, ctx)
    nb = _blocks(compiler, cg)
    print(f"{label}: plan {len(cg.kernels)} kernels, one "
          f"_FusedVoicesKernel of V {kern.V} ({kern.kind}, gain stage "
          f"{kern.has_gain}, closed-form phase {kern.all_const_freq}), "
          f"{len(cg.dense_params)} dense param rows; block_frames "
          f"{cg.block_frames}, {nb} blocks", flush=True)
    # the JAX planner's choice for this graph (tests/test_torch_voices.py
    # holds the port's plan to it on the CPU)
    if (kern.V, kern.has_gain, cg.block_frames, nb) != (OSC_VOICES, True,
                                                         16000, 30):
        raise AssertionError("config 2 did not plan one 500-voice bank "
                             "with a gain stage over 30 blocks of 16,000")
    out, launches = _main_path(ctx, kernels)
    print(f"{label}: main path launched {launches} (none of the hand "
          f"kernels is on it: the bank is plain PyTorch ops); peak "
          f"{np.abs(out).max():.4f} (the reference's back-extrapolated "
          f"setTarget plateau between each decay's snap and its release)",
          flush=True)
    frames = int(FS * CPU_SECONDS)
    cpu = oscillators_context(wt, "cpu", CPU_SECONDS).start_rendering_sync() \
        .to_array()
    err_cpu = _check_close(f"{label}: first {CPU_SECONDS:g} s vs the port's "
                           "CPU render", out[:, :frames], cpu, 1e-5)
    err_cpu /= np.abs(cpu).max()
    # the oracle's formulas are the spec's: W3C hold semantics before the
    # release's setTarget
    with _env("WEBAUDIO_STRICT_SPEC", "1"):
        strict = oscillators_context(wt, "cuda").start_rendering_sync() \
            .to_array()
        cpu = oscillators_context(wt, "cpu", CPU_SECONDS) \
            .start_rendering_sync().to_array()
    err_strict = _check_close(
        f"{label}, WEBAUDIO_STRICT_SPEC=1: first {CPU_SECONDS:g} s vs the "
        "port's CPU render", strict[:, :frames], cpu, 1e-5)
    want = oscillators_oracle()
    err = _check_close(f"{label}, WEBAUDIO_STRICT_SPEC=1: 10 s vs the numpy "
                       "f64 oracle", strict, np.stack([want, want]), 1e-4)
    print(f"{label}: errors {err_cpu:.3e} x peak (CPU); with "
          f"WEBAUDIO_STRICT_SPEC=1 {err_strict / np.abs(cpu).max():.3e} x "
          f"peak (CPU), {err / np.abs(want).max():.3e} x peak (oracle)",
          flush=True)
    return launches


def phase_p(wt, compiler, kernels):
    label = f"p. config 2 as a bank, {OSC_VOICES} voices"
    ctx = bank_context(wt, "cuda")
    cg, nb = _plan(compiler, ctx)
    banks = [k for k in cg.kernels.values()
             if type(k).__name__ == "_BankKernel"]
    print(f"{label}: plan {len(cg.kernels)} kernels, {len(banks)} "
          f"_BankKernel, {len(cg.dense_params)} dense param rows; "
          f"block_frames {cg.block_frames}, {nb} blocks", flush=True)
    if len(banks) != 1 or cg.dense_params:
        raise AssertionError("the bank did not plan one _BankKernel without "
                             "dense rows")
    out, launches = _main_path(ctx, kernels)
    print(f"{label}: main path launched {launches}", flush=True)
    frames = int(FS * CPU_SECONDS)
    cpu = bank_context(wt, "cpu", CPU_SECONDS).start_rendering_sync() \
        .to_array()
    err_cpu = _check_close(f"{label}: first {CPU_SECONDS:g} s vs the port's "
                           "CPU render", out[:, :frames], cpu, 1e-5)
    want = bank_oracle()
    err = _check_close(f"{label}: 10 s vs the numpy f64 oracle", out, want,
                       1e-4)
    print(f"{label}: errors {err_cpu / np.abs(cpu).max():.3e} x peak (CPU), "
          f"{err / np.abs(want).max():.3e} x peak (oracle)", flush=True)
    return launches


def phase_q(wt, compiler, fusion, ck, kernels):
    """Returns the curve kernel's launches on the voice path and the
    (table, x) of its last call there (S7)."""
    label = f"q. {DRIVE_VOICES}-voice distortion bank"
    ctx = drive_context(wt, "cuda")
    cg, kern = _fused_kernel(compiler, ctx)
    nb = _blocks(compiler, cg)
    stages = {s: getattr(kern, f"has_{s}")
              for s in ("shaper", "filter", "gain", "pan")}
    print(f"{label}: plan {len(cg.kernels)} kernels, one _FusedVoicesKernel "
          f"of V {kern.V} ({kern.kind}), stages {stages}; block_frames "
          f"{cg.block_frames}, {nb} blocks", flush=True)
    if len(cg.kernels) != 2 or kern.V != DRIVE_VOICES or \
            not all(stages.values()):
        raise AssertionError("the four stages did not fuse into one bank")
    with _recording(fusion, "curve_lookup") as calls:
        out, launches = _main_path(ctx, kernels)
    print(f"{label}: main path launched {launches}", flush=True)
    if launches["curve_lookup"] < 1:
        raise AssertionError("K1 never launched on the voice path")
    table, x = calls[-1]
    err = _curve_equal(f"{label}: K1 on the captured launch", ck.curve_lookup(
        table, x), ck.curve_lookup_reference(table, x))
    print(f"{label}: K1's last launch, table {tuple(table.shape)} over x "
          f"{tuple(x.shape)} "
          f"({_plan_text(ck._kernel().plan(table.shape[1], x.numel(), len(table)))})"
          f": bit-equal True max_abs_err {err:.3e}", flush=True)
    cpu = drive_context(wt, "cpu").start_rendering_sync().to_array()
    _check_close(f"{label}: vs the port's CPU render", out, cpu, 1e-5)
    with _env("WEBAUDIO_FUSE_THRESHOLD", "1000"):
        unfused = drive_context(wt, "cuda")
        ucg, _ = _plan(compiler, unfused)
        unfused = unfused.start_rendering_sync().to_array()
    print(f"{label}: unfused plan {len(ucg.kernels)} kernels", flush=True)
    _check_close(f"{label}: vs the unfused render on the card", out, unfused,
                 2e-5)
    return launches["curve_lookup"], (table, x), err


def _host_planning(label, compiler, fusion, make):
    """Host planning of a fresh context from make(), apart (host clock):
    fusion, the param timelines' compile, compile_graph (both and the
    kernels), packing and blocking the dense rows, their copy to the card,
    and the param-state advance the offline context runs after the render.
    Returns the plan."""
    ctx = make()
    fs, frames = ctx.sample_rate, ctx.length
    dest = ctx._destination.node_id
    t0 = time.perf_counter()
    nodes2, _, _ = fusion.fuse_sources(dict(ctx._nodes), list(ctx._edges),
                                       dest, sample_rate=fs)
    t_fuse = time.perf_counter() - t0
    t0 = time.perf_counter()
    cg = compiler.compile_graph(dict(ctx._nodes), list(ctx._edges), fs,
                                frames, dest, "cuda")
    t_compile = time.perf_counter() - t0
    padded = compiler._pad_len(frames, cg.block_frames)
    t0 = time.perf_counter()
    count = 0
    for node in nodes2.values():
        for p in node.params.values():
            p.compile_for_render(fs, padded, 0)
            count += 1
    t_params = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = compiler.block_rows(compiler.pack_dense_params(cg, padded),
                               cg.block_frames)[None].copy()
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.from_numpy(rows).to("cuda")
    torch.cuda.synchronize()
    t_copy = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx._advance_param_state(frames)
    t_advance = time.perf_counter() - t0
    print(f"{label}: host planning (host clock): fuse_sources "
          f"{t_fuse * 1e3:.3f} ms; compiling the {count} param timelines "
          f"{t_params * 1e3:.3f} ms; compile_graph (fusion, timelines, "
          f"kernels) {t_compile * 1e3:.3f} ms; packing {len(cg.dense_params)} "
          f"dense rows into {rows.nbytes} B {t_pack * 1e3:.3f} ms; their "
          f"copy to the card {t_copy * 1e3:.3f} ms; advancing the param "
          f"timelines to the render's end {t_advance * 1e3:.3f} ms",
          flush=True)
    return cg


def phase_r(wt, compiler, fusion, ck, s7):
    """Timing of o, p and q: start_rendering_sync end to end, the block loop
    on a compiled plan with its dense rows staged, host planning apart, the
    device-busy share; then K1 at S7.  Returns S7's timings."""
    cases = [("r. o (config 2, auto-fused)",
              lambda: oscillators_context(wt, "cuda"), 2),
             ("r. p (config 2 as a bank)", lambda: bank_context(wt, "cuda"),
              3),
             ("r. q (distortion bank)", lambda: drive_context(wt, "cuda"),
              3)]
    for label, make, profiled in cases:
        _render_ms(label, make, SECONDS)
        cg = _host_planning(label, compiler, fusion, make)
        args = compiler.render_args(cg, FRAMES)
        compiler.scan_render(cg, *args)
        loop = [_events_ms(lambda: compiler.scan_render(cg, *args), 3)
                for _ in range(3)]
        loop_ms = statistics.median(loop)
        print(f"{label}: block loop on a compiled plan, rows staged: median "
              f"{loop_ms:.3f} ms of {['%.3f' % r for r in loop]} (3 renders "
              f"each) -> realtime factor {SECONDS * 1000.0 / loop_ms:.1f}x",
              flush=True)
        _busy_launches(label, "start_rendering_sync",
                       [make().start_rendering_sync for _ in range(profiled)])
        _busy_launches(label, "block loop",
                       [lambda: compiler.scan_render(cg, *args)] * profiled)
        del args, cg
        torch.cuda.empty_cache()

    table, x = (t.contiguous() for t in s7)
    kern = ck._kernel()
    plan = kern.plan(table.shape[1], x.numel(), len(table))
    res = _kernel_times(
        f"r. curve_lookup S7 {tuple(x.shape)}, table {tuple(table.shape)} "
        f"[{_plan_text(plan)}]", ck._launch, {"new": kern},
        ck.curve_lookup_reference,
        (table, x), _nbytes(table, x) + x.numel() * 4, 11 * x.numel())
    res["plan"] = _plan_text(plan)

    # yardstick: grid_sample over R one-row images, each voice's samples
    # through its own curve (as phase e's, per row)
    R, L = x.shape
    grid = torch.stack([x, torch.zeros_like(x)], -1).reshape(R, 1, L, 2)
    img = table.reshape(R, 1, 1, -1)

    def library():
        return torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    res["library_err"] = float((library().reshape(R, L) - ck.curve_lookup(
        table, x)).abs().max())
    res["library_ms"] = statistics.median(_graph_ms(library, 20)
                                          for _ in range(3))
    print(f"r. grid_sample (a one-row image per voice) at S7: "
          f"{res['library_ms'] * 1000:.2f} us, max |grid_sample - kernel| "
          f"{res['library_err']:.3e}", flush=True)
    return res


# --- the mastering chain, s-v -------------------------------------------------


def _firwin_taps(factor):
    """The resamplers' design, apart from the port's code: scipy firwin,
    48 x factor + 1 taps, Kaiser 9.0, cutoff 0.92 / factor, gain factor,
    rounded to f32 as the port stores them."""
    from scipy.signal import firwin

    h = firwin(48 * factor + 1, 0.92 / factor, window=("kaiser", 9.0))
    return (h * factor).astype(np.float32).astype(np.float64)


def mastering_context(wt, device, frames=FRAMES, data=None, rate=FS):
    """benches/suite.py::case_mastering_chain (BASELINE config 5a) with the
    synthetic buffer of bench.py:34-37 for sample.wav: a looping
    AudioBufferSourceNode -> WaveShaperNode (oversample 4x, tanh over
    2,048 points) -> DynamicsCompressorNode (threshold -18 dB, ratio 4) ->
    AnalyserNode (fft 2,048) -> destination.  Returns (context, source,
    compressor, analyser)."""
    ctx = wt.OfflineAudioContext(2, frames, FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(
        _bench_data() if data is None else data, rate)
    src.start()
    shaper = ctx.create_wave_shaper(oversample="4x",
                                    curve=_curve(CURVE_POINTS))
    comp = ctx.create_dynamics_compressor(threshold=-18.0, ratio=4.0)
    an = ctx.create_analyser(fft_size=2048)
    src.connect(shaper)
    shaper.connect(comp)
    comp.connect(an)
    an.connect(ctx.destination)
    return ctx, src, comp, an


def mastering_oracle(frames=FRAMES):
    """5a in f64 numpy: the looped buffer, zero-stuffed to 4x and filtered
    by the resamplers' taps, the gather-lerp through the curve, filtered
    by the taps / 4 and decimated, then the compressor of the reference
    (dynamics_compressor.rs:364-470): the max-|x| sidechain in dB, the soft
    knee, the sequential attack/release detector, the makeup gain and the
    384-frame lookahead."""
    from scipy.signal import oaconvolve

    data = _bench_data().astype(np.float64)
    x = data[:, np.arange(frames) % data.shape[1]]
    h = _firwin_taps(4)
    up = np.zeros((2, 4 * frames))
    up[:, ::4] = x
    up = oaconvolve(up, h[None], axes=1)[:, :4 * frames]
    curve = _curve(CURVE_POINTS).astype(np.float64)
    n = len(curve)
    v = np.clip((n - 1) / 2.0 * (up + 1.0), 0.0, n - 1)
    k = np.minimum(np.floor(v).astype(np.int64), n - 2)
    shaped = curve[k] * (1.0 - (v - k)) + curve[k + 1] * (v - k)
    d = oaconvolve(shaped, h[None] / 4.0, axes=1)[:, :4 * frames:4]

    threshold, knee, ratio, attack, release = -18.0, 30.0, 4.0, 0.003, 0.25
    peak = np.abs(d).max(axis=0)
    with np.errstate(divide="ignore"):
        db = np.where(peak == 0.0, -1000.0, 20.0 * np.log10(peak))
    over = db - threshold
    att = np.where(db <= threshold - knee / 2, db, np.where(
        db <= threshold + knee / 2,
        db + (over + knee / 2) ** 2 * (1.0 / ratio - 1.0) / (2.0 * knee),
        threshold + over / ratio))
    xl = (db - att).tolist()
    a, r = math.exp(-1.0 / (attack * FS)), math.exp(-1.0 / (release * FS))
    det = np.empty(frames)
    prev = 0.0
    for i, xi in enumerate(xl):
        tau = a if xi > prev else r
        prev = tau * prev + (1.0 - tau) * xi
        det[i] = prev
    makeup = 20.0 * np.log10((1.0 / 10.0 ** (
        (threshold - threshold / ratio) / 20.0)) ** 0.6)
    gain = 10.0 ** ((makeup - det) / 20.0)
    lookahead = int(np.ceil(FS * 0.006 / 128)) * 128
    delayed = np.concatenate([np.zeros((2, lookahead)), d[:, :-lookahead]],
                             axis=1)
    return delayed * gain


@contextlib.contextmanager
def _solves(dc):
    """Count the branch-pattern solves of each fixed-point detector call
    in the block (the iteration's host syncs); yields the list of counts."""
    counts = []
    orig = dc._fixed_point

    def spy(solve, *args):
        n = [0]

        def counted(pat):
            n[0] += 1
            return solve(pat)

        out = orig(counted, *args)
        counts.append(n[0])
        return out

    dc._fixed_point = spy
    try:
        yield counts
    finally:
        dc._fixed_point = orig


def _host_profile(label, fn):
    """Where the host's time goes in one call of fn (synchronised at its
    end): cProfile's eight functions of the most own time."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    top = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])
    print(f"{label}: host profile of one call ({wall_ms:.3f} ms under "
          "cProfile), own ms by function: " + ", ".join(
              f"{fn_name} ({os.path.basename(path)}:{line}) {st[2] * 1e3:.2f}"
              for (path, line, fn_name), st in top[:8]), flush=True)


def _detector_kernel_check(label, det, y0, x, at, rt):
    """The detector kernel against its plain version, bit for bit, on the
    same inputs (the plain version on the host: a loop over samples that
    would launch kernels a sample on the card).  Returns (max |kernel -
    plain|, the plain version's host ms)."""
    got = det.detector_scan(y0, x, at, rt)
    cpu = [t.cpu() if isinstance(t, torch.Tensor) else t
           for t in (y0, x, at, rt)]
    t0 = time.perf_counter()
    want = det.detector_reference(*cpu)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _equal(label, got.cpu(), want)
    return err, plain_ms


def _unaligned(a, offset=1):
    """numpy `a` on the card `offset` floats into its storage: contiguous,
    its rows off a 16-byte boundary."""
    store = torch.zeros(a.size + offset, device="cuda")
    view = store[offset:].view(a.shape)
    view.copy_(torch.from_numpy(a))
    return view


def phase_s(det, rs, KernelError):
    """The detector kernel against its plain version on synthetic inputs,
    and the resamplers on the card against the CPU under PyTorch's default
    TF32 flags.  Returns the worst |kernel - plain|."""
    rng = np.random.default_rng(SEED + 7)
    worst = 0.0
    cases = [(1, 4096, False, "none"), (3, 4096, False, "none"),
             (3, 4096, True, "none"), (1024, 4096, False, "none"),
             (1024, 4096, True, "none"), (3, 4096, False, "attack 0"),
             (3, 4096, True, "release 0"), (5, 1, False, "none"),
             (5, 1, True, "attack 0")]
    # the redesigned kernel's edges: N about its CTA sizes (8 instances a
    # CTA at 1,024; 1,025 leaves one in the last), B one short tile or
    # past one and not a multiple of 4 (the 4-byte staging), B a tile's
    # length (the launch plan's) times 1, 4 and 9 plus or minus one (9
    # wraps the 4-slot ring twice), rows off a 16-byte boundary
    for N in (1, 7, 8, 9, 132, 1024, 1025):
        for B in (1, 3, 4097):
            cases += [(N, B, False, "none"), (N, B, True, "none")]
    cases += [(3, 4097, False, "release 0"), (1025, 4097, True, "attack 0")]
    for N in (1, 1024):
        for per_sample in (False, True):
            tile = det.launch_plan(N, 1 << 20, per_sample)["tile"]
            for tiles, delta in ((1, -1), (1, 1), (4, 1), (9, -1)):
                cases.append((N, tiles * tile + delta, per_sample,
                              f"tile {tile} x {tiles} {delta:+d}"))
    cases += [(N, B, per_sample, "unaligned rows")
              for N, B in ((1, 4096), (1, 4097), (1024, 4096), (9, 12288))
              for per_sample in (False, True)]
    for N, B, per_sample, edge in cases:
        x = (np.abs(rng.standard_normal((N, B))) * 20).astype(np.float32)
        x[:, B // 3: B // 2] = 25.0
        shape = (N, B) if per_sample else (N,)
        at = rng.uniform(0.5, 0.999, shape).astype(np.float32)
        rt = rng.uniform(0.9, 0.99999, shape).astype(np.float32)
        if edge == "attack 0":
            at[:] = 0.0
        elif edge == "release 0":
            rt[:] = 0.0
        y0 = rng.uniform(0, 10, N).astype(np.float32)
        move = (_unaligned if edge == "unaligned rows"
                else lambda a: torch.from_numpy(a).cuda())
        err, _ = _detector_kernel_check(
            f"s. detector_scan N {N} B {B} taus per "
            f"{'sample' if per_sample else 'instance'}, {edge} "
            f"{det.launch_plan(N, B, per_sample)}", det,
            *(move(a) for a in (y0, x, at, rt)))
        worst = max(worst, err)
    y0, x = torch.zeros(4).cuda(), torch.ones(4, 64).cuda()
    for what, args in (("non-contiguous", (y0, x.t().contiguous().t())),
                       ("f64", (y0, x.double())), ("x on the cpu",
                                                   (y0, x.cpu()))):
        try:
            det.detector_scan(*args, 0.5, 0.9)
        except KernelError as exc:
            print(f"s. detector_scan, {what} raises: {exc}", flush=True)
        else:
            raise AssertionError(f"detector_scan took a {what} input")

    # the resamplers, with cuDNN allowed TF32 as PyTorch has it by default
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for factor in (2, 4):
            x = torch.from_numpy(rng.standard_normal((3, 2, 48000)).astype(
                np.float32))
            st = torch.from_numpy(rng.standard_normal((3, 2, 48)).astype(
                np.float32))
            dst = torch.from_numpy(rng.standard_normal(
                (3, 2, 48 * factor)).astype(np.float32))
            up, _ = rs.upsample(x, factor, st)
            down, _ = rs.downsample(up, factor, dst)
            gup, _ = rs.upsample(x.cuda(), factor, st.cuda())
            gdown, _ = rs.downsample(gup, factor, dst.cuda())
            for name, g, w in (("upsample", gup, up), ("downsample", gdown,
                                                       down)):
                _check_close(f"s. {name} x{factor} (3, 2, 48000), default TF32 "
                             "flags, cuda vs cpu", _host(g), w.numpy(), 1e-6)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = old
    return worst


def _analyser_data(an):
    """(float time, float frequency, byte time, byte frequency) data."""
    out = (np.zeros(an.fft_size, np.float32),
           np.zeros(an.frequency_bin_count, np.float32),
           np.zeros(an.fft_size, np.uint8),
           np.zeros(an.frequency_bin_count, np.uint8))
    an.get_float_time_domain_data(out[0])
    an.get_float_frequency_data(out[1])
    an.get_byte_time_domain_data(out[2])
    an.get_byte_frequency_data(out[3])
    return out


def phase_t(wt, compiler, ck, det, dc, waveshaper, kernels):
    """5a end to end.  Returns a dict: the main paths' launches (the default
    detector, the kernel; then WEBAUDIO_DETECTOR=chunked), K1's captured
    launch (S8), the detector's captured input, the detector kernel's check
    and timings."""
    label = "t. 5a mastering chain, 10 s"
    ctx, _, comp, an = mastering_context(wt, "cuda")
    cg, nb = _plan(compiler, ctx)
    (ck_comp,) = [k for k in cg.kernels.values()
                  if type(k).__name__ == "_CompressorKernel"]
    mode = dc.detector_mode(ck_comp.const_taus, cg.block_frames, "cuda")
    print(f"{label}: plan {len(cg.kernels)} kernels, block_frames "
          f"{cg.block_frames}, {nb} block(s); compressor const_taus "
          f"{ck_comp.const_taus}, detector {mode}", flush=True)
    if (cg.block_frames, nb, mode) != (FRAMES, 1, "seq"):
        raise AssertionError("5a did not plan one 480,000-frame block with "
                             "the detector kernel")
    with _recording(waveshaper, "curve_lookup") as shaped, \
            _recording(dc, "_detector") as detected, \
            _solves(dc) as solves:
        out, launches = _main_path(ctx, kernels)
    print(f"{label}: main path launched {launches}; detector inputs "
          f"{[tuple(c[1].shape) for c in detected]}, fixed-point solves a "
          f"block {solves} (one host sync each)", flush=True)
    if launches["curve_lookup"] != 1 or launches["detector_scan"] != 1:
        raise AssertionError("K1 or the detector kernel did not launch once "
                             "on 5a's one block")
    cpu_ctx, _, cpu_comp, cpu_an = mastering_context(wt, "cpu")
    cpu = cpu_ctx.start_rendering_sync().to_array()
    err_cpu = _check_close(f"{label}: vs the port's CPU render", out, cpu,
                           1e-5)
    want = mastering_oracle()
    err = _check_close(f"{label}: vs the f64 numpy oracle", out, want, 1e-4)
    red = (comp.reduction, cpu_comp.reduction)
    print(f"{label}: errors {err_cpu / np.abs(cpu).max():.3e} x peak (CPU), "
          f"{err / np.abs(want).max():.3e} x peak (oracle); reduction "
          f"{red[0]:.6f} dB (CPU {red[1]:.6f})", flush=True)
    if not abs(red[0] - red[1]) <= 1e-4 or not red[0] < -1.0:
        raise AssertionError(f"reduction {red}")
    got_a, want_a = _analyser_data(an), _analyser_data(cpu_an)
    td_err = float(np.abs(got_a[0] - want_a[0]).max())
    mag, cmag = 10.0 ** (got_a[1] / 20.0), 10.0 ** (want_a[1] / 20.0)
    fd_err = float(np.abs(mag - cmag).max()) / float(cmag.max())
    byte_err = max(int(np.abs(g.astype(np.int64) - w).max())
                   for g, w in zip(got_a[2:], want_a[2:]))
    print(f"{label}: analyser vs the CPU render's: time data "
          f"{td_err:.3e} (limit 1e-5 x peak), frequency magnitudes "
          f"{fd_err:.3e} x their peak (limit 1e-5), bytes within {byte_err} "
          f"code(s) (limit 1); spectral peak at bin {int(np.argmax(got_a[1]))}",
          flush=True)
    if td_err > 1e-5 * np.abs(cpu).max() or fd_err > 1e-5 or byte_err > 1:
        raise AssertionError("the analyser's data differ from the CPU's")

    # the chunked fixed point, forced: the CPU's default and the card's
    # before the detector kernel was
    with _env("WEBAUDIO_DETECTOR", "chunked"), _solves(dc) as chunked_solves:
        ch_ctx = mastering_context(wt, "cuda")[0]
        chunked_out, chunked_launches = _main_path(ch_ctx, kernels)
    print(f"{label}, WEBAUDIO_DETECTOR=chunked: main path launched "
          f"{chunked_launches}; fixed-point solves a block {chunked_solves}",
          flush=True)
    if chunked_launches["curve_lookup"] != 1:
        raise AssertionError("K1 did not launch once on the chunked path")
    _check_close(f"{label}: default (the detector kernel) vs the "
                 "WEBAUDIO_DETECTOR=chunked render (the JAX suite's bound "
                 "between detectors)", out, chunked_out, 2e-4)
    _check_close(f"{label}, WEBAUDIO_DETECTOR=chunked: vs the f64 numpy "
                 "oracle", chunked_out, want, 1e-4)

    # the detector kernel on 5a's captured attenuation row
    y0, xl, at, rt = detected[0][:4]
    kerr, plain_ms = _detector_kernel_check(
        f"{label}: detector_scan on the captured attenuation row "
        f"{tuple(xl.shape)}", det, y0.contiguous(), xl.contiguous(), at, rt)
    with _env("WEBAUDIO_DETECTOR", "chunked"):
        chunked = dc._detector(y0, xl, at, rt, const_taus=ck_comp.const_taus)
    exact = det.detector_scan(y0.contiguous(), xl.contiguous(), at, rt)
    rel = float((chunked - exact).abs().max() / exact.abs().max())
    print(f"{label}: chunked detector vs the sequential kernel on that row: "
          f"{rel:.3e} relative (limit 1e-4); plain version {plain_ms:.1f} ms "
          "on the host", flush=True)
    if not rel <= 1e-4:
        raise AssertionError("the chunked detector strays from the "
                             "sequential recurrence")

    # timings, host planning apart
    def make():
        return mastering_context(wt, "cuda")[0]

    e2e = _render_ms(f"{label}", make, SECONDS)
    t0 = time.perf_counter()
    cg, _ = _plan(compiler, make())
    plan_ms = (time.perf_counter() - t0) * 1e3
    args = compiler.render_args(cg, FRAMES)
    compiler.scan_render(cg, *args)
    loop = [_events_ms(lambda: compiler.scan_render(cg, *args), 3)
            for _ in range(3)]
    loop_ms = statistics.median(loop)
    print(f"{label}: host planning (compile_graph) {plan_ms:.3f} ms; block "
          f"loop on a compiled plan: median {loop_ms:.3f} ms of "
          f"{['%.3f' % r for r in loop]} (3 renders each) -> realtime factor "
          f"{SECONDS * 1000.0 / loop_ms:.1f}x", flush=True)
    _host_profile(label, lambda: compiler.scan_render(cg, *args))
    busy, _ = _busy_launches(label, "start_rendering_sync",
                             [make().start_rendering_sync for _ in range(3)])
    loop_busy, _ = _busy_launches(label, "block loop",
                                  [lambda: compiler.scan_render(cg, *args)]
                                  * 3)
    del args, cg
    torch.cuda.empty_cache()
    return {"launches": launches, "chunked_launches": chunked_launches,
            "s8": shaped[0], "detector_row": (y0, xl, at, rt),
            "const_taus": ck_comp.const_taus, "detector_err": kerr,
            "detector_plain_ms": plain_ms, "e2e_ms": e2e, "loop_ms": loop_ms,
            "busy": busy, "loop_busy": loop_busy}


CLIP_RATES = (38000.0, 44100.0, 48000.0)


def corpus_clips(wt, count, frames, seed):
    """Config 5b's clips: synthetic stereo clips made with numpy from a
    seed (a sine of 80-2,000 Hz a channel and noise, 0.9-1.1 x the render's
    length), a third each at 38,000, 44,100 and 48,000 Hz, each resampled
    to 48 kHz host-side with AudioBuffer.resample (reference
    buffer.rs:311-363) and cut or zero-padded to `frames`.  (count, 2,
    frames) f32."""
    rng = np.random.default_rng(seed)
    clips = np.zeros((count, 2, frames), np.float32)
    for i in range(count):
        rate = CLIP_RATES[i % 3]
        n = int(rate * frames / FS * rng.uniform(0.9, 1.1))
        t = np.arange(n) / rate
        f = rng.uniform(80.0, 2000.0, (2, 1))
        x = (rng.uniform(0.3, 1.2) * np.sin(2 * np.pi * f * t)
             + 0.05 * rng.standard_normal((2, n))).astype(np.float32)
        buf = wt.AudioBuffer.from_array(x, rate)
        buf.resample(FS)
        m = min(buf.length, frames)
        clips[i, :, :m] = buf.to_array()[:, :m]
    return clips


def phase_u(wt, compiler, dither, dc, kernels):
    """5b: a GraphBatch of the chain at 2 s an instance, BIG_BATCH
    instances, each with its own clip.  Returns the launches, throughput,
    peak memory and the detector's captured (N, B) input."""
    label = f"u. 5b corpus, {BIG_BATCH} clips of {BATCH_SECONDS:g} s"
    t0 = time.perf_counter()
    clips = corpus_clips(wt, BIG_BATCH, BATCH_FRAMES, SEED + 8)
    make_s = time.perf_counter() - t0
    ctx, src, _, _ = mastering_context(wt, "cuda", BATCH_FRAMES,
                                       data=np.zeros((2, BATCH_FRAMES),
                                                     np.float32))
    gb = wt.GraphBatch(ctx, batch=BIG_BATCH)
    gb.override_buffer(src, clips)
    nb = gb.nb
    print(f"{label}: clips made and resampled to 48 kHz in {make_s:.2f} s "
          f"(set-up); plan block_frames {gb.cg.block_frames}, {nb} block(s)",
          flush=True)
    if (gb.cg.block_frames, nb) != (BATCH_FRAMES, 1):
        raise AssertionError("5b did not plan one 96,000-frame block")
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with _recording(dc, "_detector") as detected, _solves(dc) as solves:
        out = gb.render()
        codes = gb.render_i16(SEED)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"{label}: render() and render_i16 launched {launches}; "
          f"fixed-point solves a render {solves}; peak "
          f"device memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} "
          f"GiB above the staged batch)", flush=True)
    if launches["curve_lookup"] != 2 or launches["dither_i16"] != 1 or \
            launches["detector_scan"] != 2:
        raise AssertionError("K1, K5 or the detector kernel (once a render) "
                             "did not launch on the corpus path")
    host = _host(out)[..., :BATCH_FRAMES]
    if not np.isfinite(host).all() or np.abs(host).max() < 0.1:
        raise AssertionError("the corpus render is not finite or silent")
    for i in (0, BIG_BATCH // 2 - 1, BIG_BATCH - 1):
        own = mastering_context(wt, "cuda", BATCH_FRAMES, data=clips[i])[0]
        _check_close(f"{label}: lane {i} vs its own start_rendering_sync on "
                     "the card", host[i], own.start_rendering_sync()
                     .to_array(), 1e-6)
    pick = [0, BIG_BATCH // 2 - 1, BIG_BATCH - 1, 1]
    small = {}
    # the card's default detector is the sequential kernel, the CPU's the
    # chunked fixed point: the CPU batch with WEBAUDIO_DETECTOR=seq runs the
    # card's algorithm (the plain version of its kernel)
    for device, detector in (("cuda", None), ("cpu", "seq"), ("cpu", None)):
        with _env("WEBAUDIO_DETECTOR", detector):
            c, s, _, _ = mastering_context(wt, device, BATCH_FRAMES,
                                           data=np.zeros((2, BATCH_FRAMES),
                                                         np.float32))
            g = wt.GraphBatch(c, batch=len(pick))
            g.override_buffer(s, clips[pick])
            small[device, detector] = _host(g.render())[..., :BATCH_FRAMES]
    _check_close(f"{label}: a {len(pick)}-instance batch on the card vs the "
                 "port's CPU batch with the same detector "
                 "(WEBAUDIO_DETECTOR=seq)", small["cuda", None],
                 small["cpu", "seq"], 1e-5)
    _check_close(f"{label}: that batch vs the port's CPU batch with the "
                 "CPU's default detector (the chunked fixed point; the JAX "
                 "suite's bound between detectors)", small["cuda", None],
                 small["cpu", None], 2e-4)
    _check_close(f"{label}: that batch vs the same lanes of the "
                 f"{BIG_BATCH}", small["cuda", None], host[pick], 1e-6)
    want = dither.dither_i16_reference(out, SEED)
    if not torch.equal(codes, want):
        raise AssertionError("render_i16 differs from the plain dither of "
                             "render()")
    print(f"{label}: render_i16 {tuple(codes.shape)} equals the plain dither "
          "of render()", flush=True)
    del out, codes, want
    torch.cuda.empty_cache()
    ms = _median_events_ms(gb.render)
    print(f"{label}: staged render median {ms:.3f} ms -> "
          f"{BIG_BATCH * BATCH_SECONDS * 1000.0 / ms:.1f} instance-audio-s per "
          f"wall s, {BIG_BATCH * 1000.0 / ms:.1f} clips/s", flush=True)
    i16_ms = _median_events_ms(lambda: gb.render_i16(SEED).cpu())
    print(f"{label}: render_i16 + host copy median {i16_ms:.3f} ms -> "
          f"{BIG_BATCH * BATCH_SECONDS * 1000.0 / i16_ms:.1f} "
          "instance-audio-s per wall s", flush=True)
    busy, _ = _busy_launches(label, "staged render", [gb.render] * 2)
    row = detected[0][:4]
    del gb
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "i16_ms": i16_ms, "peak": peak,
            "busy": busy, "detector_rows": row}


BOOST_HZ = 1.98e9            # H100 SXM boost clock
F32_LATENCY = 4              # cycles of a dependent f32 multiply or add
# the detector kernel's chain: multiply, add, select (3 dependent
# operations); the earlier kernel's: compare, select tau, multiply, add (4)
CHAIN_OPS, OLD_CHAIN_OPS = 3, 4
# (N, B) beyond 5a's and 5b's at which the detector kernel and the
# chunked fixed point are timed for the card's default (detector_mode)
DETECTOR_SWEEP = ((1, 128), (1024, 128), (1, 16384), (1024, 16384),
                  (8192, 16384))


def _chain_floor_ms(B, ops):
    """The latency floor of one instance: B steps of `ops` dependent f32
    operations of F32_LATENCY cycles at the boost clock."""
    return B * ops * F32_LATENCY / BOOST_HZ * 1e3


# One thread walks the detector's step 2^16 times on registers, timed by
# clock64: the kernel's step (csrc/detector.cu: both candidates, a byte
# permute selected by the compare), the same step with `?:` (ptxas then
# predicates the second add on the compare), the earlier kernel's
# select-tau step, and multiply + add with no select.
CHAIN_BENCH = r"""
#include <cuda_runtime.h>
template <int V>
__global__ void chain(const float* __restrict__ x, float* out, int steps,
                      long long* cyc) {
  float xs[16], ax[16], rx[16];
  const float a = x[100], r = x[101];
  const float oma = __fsub_rn(1.0f, a), omr = __fsub_rn(1.0f, r);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    xs[j] = x[j];
    ax[j] = __fmul_rn(oma, xs[j]);
    rx[j] = __fmul_rn(omr, xs[j]);
  }
  float prev = x[102];
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long t0 = clock64();
  for (int i = 0; i < steps; i += 16) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (V == 0) {
        asm("{\n\t.reg .pred p;\n\t.reg .f32 ta, tr, ya, yr;\n\t"
            ".reg .b32 s;\n\t"
            "setp.gt.f32 p, %1, %0;\n\t"
            "mul.rn.f32 ta, %2, %0;\n\t"
            "mul.rn.f32 tr, %3, %0;\n\t"
            "add.rn.f32 ya, ta, %4;\n\t"
            "add.rn.f32 yr, tr, %5;\n\t"
            "selp.b32 s, 0x3210, 0x7654, p;\n\t"
            "prmt.b32 %0, ya, yr, s;\n\t}"
            : "+f"(prev) : "f"(xs[j]), "f"(a), "f"(r), "f"(ax[j]),
              "f"(rx[j]));
      } else if (V == 1) {
        const float ya = __fadd_rn(__fmul_rn(a, prev), ax[j]);
        const float yr = __fadd_rn(__fmul_rn(r, prev), rx[j]);
        prev = xs[j] > prev ? ya : yr;
      } else if (V == 2) {
        const float tau = xs[j] > prev ? a : r;
        prev = __fadd_rn(__fmul_rn(tau, prev),
                         __fmul_rn(__fsub_rn(1.0f, tau), xs[j]));
      } else {
        prev = __fadd_rn(__fmul_rn(a, prev), ax[j]);
      }
    }
  }
  const long long t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[V] = prev;
  cyc[V] = t1 - t0;
  cyc[4 + V] = static_cast<long long>(g1 - g0);   // ns
}
extern "C" int chain_bench(const float* x, float* out, int steps,
                           long long* cyc) {
  chain<0><<<1, 1>>>(x, out, steps, cyc);
  chain<1><<<1, 1>>>(x, out, steps, cyc);
  chain<2><<<1, 1>>>(x, out, steps, cyc);
  chain<3><<<1, 1>>>(x, out, steps, cyc);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""
CHAIN_FORMS = ("the kernel's step (byte-permute select)",
               "the same step written with ?: (predicated add)",
               "the earlier kernel's step (select tau, multiply, add)",
               "multiply + add, no select")


def chain_cycles(cuda_lib):
    """Cycles a step of each of CHAIN_FORMS, one thread on the card."""
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_lib.BUILD_DIR / "chain_bench.cu"
    src.write_text(CHAIN_BENCH)
    so = cuda_lib.BUILD_DIR / "chain_bench.so"
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(str(so)).chain_bench
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.c_int, p]
    x = torch.rand(128, device="cuda") * 20
    x[100], x[101], x[102] = 0.9993, 0.99992, 3.0
    out = torch.zeros(4, device="cuda")
    cyc = torch.zeros(8, dtype=torch.int64, device="cuda")
    steps = 1 << 20
    for _ in range(2):                  # the first run warms up
        if fn(x.data_ptr(), out.data_ptr(), steps, cyc.data_ptr()):
            raise RuntimeError("the chain benchmark failed")
    c = cyc.cpu().double()
    cycles = (c[:4] / steps).tolist()
    # the SM clock while the steps ran: clock64 cycles over %globaltimer ns
    ghz = float(c[:4].sum() / c[4:].sum())
    print("v. the detector's step, one thread, cycles a step: " + "; ".join(
        f"{what} {cy:.2f}" for what, cy in zip(CHAIN_FORMS, cycles))
        + f"; SM clock meanwhile {ghz:.3f} GHz", flush=True)
    res = dict(zip(("kernel", "conditional", "earlier", "no_select"),
                   cycles))
    res["sm_ghz"] = ghz
    return res


def _bind_detector(lib):
    """An earlier detector.cu's `detector_seq_launch`, called as
    ops/detector.py::_launch calls this checkout's."""
    fn = lib.detector_seq_launch
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, p]
    fn.restype = ctypes.c_int

    def launch(y0, x, at, rt, out):
        N, B = x.shape
        rc = fn(y0.data_ptr(), x.data_ptr(), at.data_ptr(), rt.data_ptr(),
                out.data_ptr(), N, B, int(at.shape[1] != 1),
                torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the earlier detector kernel: CUDA error {rc}")
        return out

    return launch


def detector_ab(det, old, key, y0, xl, at, rt):
    """The earlier detector kernel (`old`, from --old) against this one at
    (N, B), in turns: plain (the host loop), old, new, new, old, plain,
    each turn the median of 5 CUDA-event timings (the plain version's one
    host-clock run); each kernel checked bit-equal to the plain version.
    Returns {version: [ms of each turn]}."""
    at, rt = (t.contiguous() for t in det._taus(xl, at, rt))
    cpu = [t.cpu() for t in (y0, xl, at, rt)]
    want = det.detector_reference(*cpu)
    out = torch.empty_like(xl)
    runs = {"new": lambda: det._launch(y0, xl, at, rt, out),
            "old": lambda: old(y0, xl, at, rt, out)}
    for name, run in runs.items():
        out.fill_(float("nan"))
        run()
        _equal(f"v. detector {key} {tuple(xl.shape)}: the {name} kernel vs "
               "the plain version", out.cpu(), want)
    times = {"plain": [], "old": [], "new": []}
    for name in ("plain", "old", "new", "new", "old", "plain"):
        if name == "plain":
            t0 = time.perf_counter()
            det.detector_reference(*cpu)
            times[name].append((time.perf_counter() - t0) * 1e3)
        else:
            times[name].append(_median_events_ms(runs[name]))
    print(f"v. detector {key} {tuple(xl.shape)} in turns (plain, old, new, "
          f"new, old, plain): " + ", ".join(
              f"{k} {['%.3f' % v for v in vs]} ms" for k, vs in times.items()),
          flush=True)
    return times


def phase_v(ck, det, dc, rs, cuda_lib, t, u, old_detector=None):
    """Times: K1 at S8 (5a's captured launch) and MDN's 44,100-point curve
    on S8's samples, warm and cold L2, against the plain version, the bound
    and grid_sample; the detector kernel against the chunked path at 5a's
    and 5b's detector inputs and at DETECTOR_SWEEP's shapes (cut and tiled
    from 5b's), and against an earlier detector kernel (--old) in turns;
    the resamplers' device time at 5a's and 5b's shapes.  Returns the
    timings."""
    curve, x = t["s8"]
    curve = (curve[0] if curve.dim() == 2 else curve).contiguous()
    x = x.contiguous()
    kern = ck._kernel()
    res = {}
    for key, c in (("S8", curve),
                   ("S8 n 44100", torch.from_numpy(_curve(44100)).cuda())):
        plan = kern.plan(c.shape[-1], x.numel(), 1)
        r = _kernel_times(
            f"v. curve_lookup {key} {tuple(x.shape)}, {tuple(c.shape)} "
            f"[{_plan_text(plan)}]", ck._launch, {"new": kern},
            ck.curve_lookup_reference, (c, x),
            _nbytes(c, x) + x.numel() * 4, 11 * x.numel())
        r["plan"] = _plan_text(plan)
        r["library_ms"], r["library_err"] = _curve_library(f"v. {key}", ck,
                                                           c, x)
        res[key] = r

    # the detector kernel against the chunked fixed point (forced), the
    # card's default before this kernel was; the measured floor is B steps
    # at the kernel's step alone
    cycles = chain_cycles(cuda_lib)
    res["chain_cycles"] = cycles
    y5b = u["detector_rows"]
    sweep = [(f"{N} x {B}", (y5b[0][:1].repeat(N), y5b[1][:1, :B].repeat(
        N, 1).contiguous(), y5b[2], y5b[3])) for N, B in DETECTOR_SWEEP]
    for key, (y0, xl, at, rt) in [("5a", t["detector_row"]),
                                  ("5b", y5b)] + sweep:
        y0, xl = y0.contiguous(), xl.contiguous()
        N, B = xl.shape
        k_ms = _median_events_ms(lambda: det.detector_scan(y0, xl, at, rt))
        with _env("WEBAUDIO_DETECTOR", "chunked"):
            c_ms = _median_events_ms(lambda: dc._detector(
                y0, xl, at, rt, const_taus=t["const_taus"]))
        nbytes = _nbytes(y0, xl) + xl.numel() * 4 + 8
        b_ms, b_by = _bound(nbytes, 6 * N * B)
        lat_ms = _chain_floor_ms(B, CHAIN_OPS)
        old_lat_ms = _chain_floor_ms(B, OLD_CHAIN_OPS)
        step_ms = B * cycles["kernel"] / (cycles["sm_ghz"] * 1e9) * 1e3
        plan = det.launch_plan(N, B, at.dim() == 2 and at.shape[-1] > 1)
        print(f"v. detector {key} ({N}, {B}) [{plan}]: kernel {k_ms:.3f} ms "
              f"({k_ms * 1e6 * cycles['sm_ghz'] / B:.2f} cycles a step at "
              f"the measured SM clock), the chunked fixed point {c_ms:.3f} ms "
              f"({'kernel' if k_ms <= c_ms else 'chunked'} ahead); bound "
              f"{b_ms * 1000:.2f} us ({b_by}); latency floor of one chain "
              f"~{lat_ms:.3f} ms at {CHAIN_OPS} dependent operations of "
              f"{F32_LATENCY} cycles (~{old_lat_ms:.3f} ms at the earlier "
              f"{OLD_CHAIN_OPS}), {step_ms:.3f} ms at the step's measured "
              f"{cycles['kernel']:.2f} cycles and SM clock", flush=True)
        res[f"detector {key}"] = {"ms": k_ms, "chunked_ms": c_ms,
                                  "bound_ms": b_ms, "bound_by": b_by,
                                  "latency_bound_ms": lat_ms,
                                  "latency_bound_ms_4_ops": old_lat_ms,
                                  "step_bound_ms": step_ms, "plan": plan}
        if old_detector is not None and key in ("5a", "5b"):
            res[f"detector {key}"]["ab"] = detector_ab(
                det, old_detector, key, y0, xl, at, rt)
        del xl
    del sweep
    torch.cuda.empty_cache()

    # the resamplers (f64 convolutions) at 5a's and 5b's shapes
    for key, shape in (("5a", (1, 2, FRAMES)),
                       ("5b", (BIG_BATCH, 2, BATCH_FRAMES))):
        xr = torch.rand(shape, device="cuda") * 2 - 1
        ust = rs.up_fir_state(2, 4, "cuda").expand(shape[0], 2, -1)
        dst = rs.down_fir_state(2, 4, "cuda").expand(shape[0], 2, -1)
        up_ms = _median_events_ms(lambda: rs.upsample(xr, 4, ust))
        up = rs.upsample(xr, 4, ust)[0]
        dn_ms = _median_events_ms(lambda: rs.downsample(up, 4, dst))
        print(f"v. resamplers x4 at {shape}: upsample {up_ms:.3f} ms, "
              f"downsample {dn_ms:.3f} ms (f64 conv1d, device time by CUDA "
              "events)", flush=True)
        res[f"resample {key}"] = {"up_ms": up_ms, "down_ms": dn_ms}
        del xr, up
        torch.cuda.empty_cache()
    return res


# --- config 3: delay, feedback cycles, the convolver, the IIR filter --------

REVERB_FS = 44100.0
REVERB_FRAMES = int(REVERB_FS * SECONDS)
REVERB_SHORT = int(REVERB_FS * BATCH_SECONDS)
REVERB_DELAY = 0.31          # s, the feedback delay of config 3
REVERB_FEEDBACK = 0.4
REVERB_CORPUS = 256
IR_SECONDS = 2.0


def _reverb_dry():
    # bench.py:34-37's synthetic 2 s buffer, at the context's 44.1 kHz
    n = int(2 * REVERB_FS)
    return np.sin(np.arange(n) * 0.03, dtype=np.float32)[None].repeat(2, 0)


def reverb_ir(seed=SEED + 30):
    """The stand-in for parking-garage-response.wav: 2 s of stereo noise
    decaying with a 0.4 s time constant, from a seed."""
    n = int(IR_SECONDS * REVERB_FS)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, n))
            * np.exp(-np.arange(n) / REVERB_FS / 0.4)).astype(np.float32)


def reverb_context(wt, device, frames=REVERB_FRAMES, dry=None):
    """BASELINE config 3 (benches/suite.py::case_convolution_reverb) with
    synthetic stand-ins for its two WAV files: a looping source (the dry
    signal, bench.py's synthetic buffer unless given) into a normalized
    ConvolverNode (reverb_ir) and into a DelayNode of 0.31 s whose output
    feeds back through a 0.4 gain; the convolver and the feedback gain
    into the destination.  Returns (ctx, src)."""
    ctx = wt.OfflineAudioContext(2, frames, REVERB_FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(
        _reverb_dry() if dry is None else dry, REVERB_FS)
    src.start()
    verb = ctx.create_convolver()
    verb.set_buffer(wt.AudioBuffer.from_array(reverb_ir(), REVERB_FS))
    src.connect(verb)
    verb.connect(ctx.destination)
    d = ctx.create_delay(max_delay_time=1.0)
    d.delay_time.value = REVERB_DELAY
    fb = ctx.create_gain(gain=REVERB_FEEDBACK)
    src.connect(d)
    d.connect(fb)
    fb.connect(d)
    fb.connect(ctx.destination)
    return ctx, src


def reverb_oracle(frames=REVERB_FRAMES):
    """Config 3 in numpy f64: the looped dry signal convolved with the IR
    (scipy fftconvolve) at the reference's equal-power scale
    (convolver.rs:16-50, the power in f64), plus the feedback loop stepped
    in chunks one delay long, each sample read at t - d (d the f32 delay
    in f64 frames) with the delay's lerp: x = dry + 0.4 y, y[t] = k0
    x[t-n-1] + (1-k0) x[t-n]."""
    from scipy.signal import fftconvolve

    dry = _reverb_dry().astype(np.float64)
    looped = dry[:, np.arange(frames) % dry.shape[1]]
    ir = reverb_ir().astype(np.float64)
    power = max(np.sqrt(np.sum(ir ** 2) / ir.size), 0.000125)
    ir = ir * (0.00125 / power * 44100.0 / REVERB_FS)
    wet = np.stack([fftconvolve(looped[c], ir[c])[:frames] for c in range(2)])
    d = float(np.float32(REVERB_DELAY)) * REVERB_FS
    n = math.floor(d)
    k0 = d - n
    x = np.zeros_like(looped)
    y = np.zeros_like(looped)
    for c0 in range(0, frames, n):
        t = np.arange(c0, min(c0 + n, frames))
        a = np.where(t - n - 1 >= 0, x[:, np.maximum(t - n - 1, 0)], 0.0)
        b = np.where(t - n >= 0, x[:, np.maximum(t - n, 0)], 0.0)
        y[:, t] = k0 * a + (1.0 - k0) * b
        x[:, t] = looped[:, t] + REVERB_FEEDBACK * y[:, t]
    return wet + REVERB_FEEDBACK * y


def iir_context(wt, device, frames=FRAMES):
    """benches/suite.py::case_iir_chain with bench.py's synthetic buffer:
    a looping source through butter(4, 0.2) as an IIRFilterNode, 48 kHz,
    stereo."""
    from scipy.signal import butter

    ctx = wt.OfflineAudioContext(2, frames, FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(_bench_data(), FS)
    src.start()
    f = ctx.create_iir_filter(*butter(4, 0.2))
    src.connect(f)
    f.connect(ctx.destination)
    return ctx


def flanger_context(wt, device, frames=BATCH_FRAMES):
    """tests/test_goldens.py's `modulated_feedback_delay` topology stretched
    to `frames`: a source into a delay swept from 10.5 to 40.25 frames over
    the render, fed back through 0.6, the delay into the destination (a
    flanger with feedback).  The source is bench.py's looping synthetic
    buffer, not the golden's 8-sample impulse, so the sweep has a signal
    to act on the whole render.  The automated delay pins the graph to
    128-frame blocks."""
    ctx = wt.OfflineAudioContext(1, frames, FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(_bench_data()[:1], FS)
    d = ctx.create_delay(max_delay_time=0.01)
    d.delay_time.set_value_at_time(10.5 / FS, 0.0)
    d.delay_time.linear_ramp_to_value_at_time(40.25 / FS, frames / FS)
    fb = ctx.create_gain(gain=0.6)
    src.connect(d)
    d.connect(fb)
    fb.connect(d)
    d.connect(ctx.destination)
    src.start()
    return ctx


def flanger_oracle(frames=BATCH_FRAMES):
    """flanger_context in numpy f64: x = src + 0.6 y, y[t] the lerp of x
    at t - d[t], d the swept delay held to one quantum (128 frames) in the
    cycle (delay.rs:535-542), stepped 128 frames at a time (every read
    lies in an earlier step)."""
    src = _bench_data()[0].astype(np.float64)[np.arange(frames) % 96000]
    t = np.arange(frames)
    d = np.maximum(10.5 / FS + (40.25 - 10.5) / FS * t / frames, 128 / FS)
    pos = t - d * FS
    prev = np.floor(pos).astype(np.int64)
    k = pos - prev
    x = np.zeros(frames)
    y = np.zeros(frames)
    for c0 in range(0, frames, 128):
        s = slice(c0, c0 + 128)
        p0, p1 = prev[s], prev[s] + 1
        a = np.where(p0 >= 0, x[np.maximum(p0, 0)], 0.0)
        b = np.where(p1 >= 0, x[np.maximum(p1, 0)], 0.0)
        y[s] = (1.0 - k[s]) * a + k[s] * b
        x[s] = src[s] + 0.6 * y[s]
    return y[None]


def _reverb_plan(compiler, ctx):
    """(plan, blocks, the convolver's (partition, K), the delay's ring)."""
    cg, nb = _plan(compiler, ctx)
    (conv,) = [k for k in cg.kernels.values()
               if type(k).__name__ == "_ConvolverKernel"]
    (dl,) = [k for k in cg.kernels.values()
             if type(k).__name__ == "_DelayKernel"]
    return cg, nb, (conv.partition, conv.k), dl.R


def _loop_ms(compiler, cg, frames, reps=3):
    """The block walk alone on a compiled plan: median of 3 x `reps`
    `scan_render`s between CUDA events."""
    args = compiler.render_args(cg, frames)
    compiler.scan_render(cg, *args)
    runs = [_events_ms(lambda: compiler.scan_render(cg, *args), reps)
            for _ in range(3)]
    return statistics.median(runs), runs, args


def phase_w(wt, compiler, kernels):
    """Config 3 at full width through start_rendering_sync, and the
    padenot suite's IIR chain.  Returns the timings and launches."""
    label = "w. config 3, reverb + feedback delay, 10 s 44.1 kHz"
    ctx, _ = reverb_context(wt, "cuda")
    cg, nb, (P, K), R = _reverb_plan(compiler, ctx)
    plan = (cg.block_frames, cg.two_rate_m, cg.inner_frames, P, K)
    print(f"{label}: plan block_frames {cg.block_frames} ({nb} block(s)), "
          f"two-rate m {cg.two_rate_m} x inner {cg.inner_frames} frames, "
          f"convolver partition {P} K {K}, delay ring {R} frames", flush=True)
    if plan != (442368, 36, 12288, 16384, 6):
        raise AssertionError(f"config 3's plan {plan} is not the JAX "
                             "package's (442368, 36, 12288, 16384, 6)")
    out, launches = _main_path(ctx, kernels)
    print(f"{label}: main path launched {launches} (no hand kernel lies on "
          "this path: cuFFT and PyTorch ops)", flush=True)
    cpu = reverb_context(wt, "cpu")[0].start_rendering_sync().to_array()
    err_cpu = _check_close(f"{label}: vs the port's CPU render", out, cpu,
                           1e-5)
    want = reverb_oracle()
    err = _check_close(f"{label}: vs the f64 numpy oracle (fftconvolve, "
                       "the lerped feedback loop)", out, want, 1e-4)
    print(f"{label}: errors {err_cpu / np.abs(cpu).max():.3e} x peak (CPU), "
          f"{err / np.abs(want).max():.3e} x peak (oracle)", flush=True)

    def make():
        return reverb_context(wt, "cuda")[0]

    e2e = _render_ms(label, make, SECONDS)
    loop_ms, runs, args = _loop_ms(compiler, cg, REVERB_FRAMES)
    print(f"{label}: block loop on a compiled plan: median {loop_ms:.3f} ms "
          f"of {['%.3f' % r for r in runs]} (3 renders each) -> realtime "
          f"factor {SECONDS * 1000.0 / loop_ms:.1f}x", flush=True)
    busy, ops = _busy_launches(label, "start_rendering_sync",
                               [make().start_rendering_sync
                                for _ in range(3)])
    loop_busy, loop_ops = _busy_launches(
        label, "block loop", [lambda: compiler.scan_render(cg, *args)] * 3)
    del args, cg

    ilabel = "w. case_iir_chain, butter(4, 0.2), 10 s 48 kHz"
    ictx = iir_context(wt, "cuda")
    icg, inb = _plan(compiler, ictx)
    iout, _ = _main_path(ictx, kernels)
    from scipy.signal import butter, lfilter

    looped = _bench_data().astype(np.float64)[:, np.arange(FRAMES) % 96000]
    iwant = lfilter(*butter(4, 0.2), looped, axis=1)
    print(f"{ilabel}: plan block_frames {icg.block_frames} ({inb} "
          "block(s))", flush=True)
    ierr = _check_close(f"{ilabel}: vs scipy lfilter in f64", iout, iwant,
                        1e-4)
    i_ms = _render_ms(ilabel, lambda: iir_context(wt, "cuda"), SECONDS)
    torch.cuda.empty_cache()
    return {"launches": launches, "e2e_ms": e2e, "loop_ms": loop_ms,
            "busy": busy, "ops": ops, "loop_busy": loop_busy,
            "loop_ops": loop_ops, "err_cpu": err_cpu, "err_oracle": err,
            "iir_ms": i_ms, "iir_err": ierr}


def phase_x(wt, compiler, kernels):
    """One-quantum stepping (WEBAUDIO_CYCLE_BLOCKS=1): config 3 at 2 s
    against its two-rate render, and the modulated feedback delay (a
    flanger, one quantum a block by its automated delay) against the CPU.
    Returns ms and device operations per 128-frame quantum."""
    res = {}
    label = "x. config 3 at 2 s, WEBAUDIO_CYCLE_BLOCKS=1"
    two = reverb_context(wt, "cuda", REVERB_SHORT)[0].start_rendering_sync() \
        .to_array()
    with _env("WEBAUDIO_CYCLE_BLOCKS", "1"):
        ctx, _ = reverb_context(wt, "cuda", REVERB_SHORT)
        cg, nb, (P, K), R = _reverb_plan(compiler, ctx)
        print(f"{label}: plan block_frames {cg.block_frames} ({nb} blocks), "
              f"convolver partition {P} K {K}", flush=True)
        if (cg.block_frames, P, K) != (128, 128, 690):
            raise AssertionError("one-quantum stepping did not plan 128-frame "
                                 "blocks with a 690-partition FDL")
        one, launches = _main_path(ctx, kernels)
        err = float(np.abs(one - two).max())
        print(f"{label}: vs the two-rate render (90,112 / 8 / 11,264): "
              f"max_abs_err {err:.3e} (limit 3e-6, the JAX suite's bound) "
              f"-> {'ok' if err <= 3e-6 else 'FAIL'}", flush=True)
        if not err <= 3e-6 or not np.abs(two).max() > 0.1:
            raise AssertionError(f"{label}: {err} > 3e-6")

        def make():
            return reverb_context(wt, "cuda", REVERB_SHORT)[0]

        # one-quantum renders take seconds: the median of three timed
        # renders after a warm-up, one under the profiler
        ms = _render_ms(label, make, BATCH_SECONDS, reps=3)
        _, ops = _busy_launches(label, "start_rendering_sync",
                                [make().start_rendering_sync])
    res["reverb"] = {"ms": ms, "blocks": nb, "ms_per_quantum": ms / nb,
                     "ops_per_quantum": ops / nb if ops else None}

    flabel = "x. modulated feedback delay (flanger), 2 s 48 kHz"
    fctx = flanger_context(wt, "cuda")
    fcg, fnb = _plan(compiler, fctx)
    print(f"{flabel}: plan block_frames {fcg.block_frames} ({fnb} blocks)",
          flush=True)
    if fcg.block_frames != 128:
        raise AssertionError("the automated delay did not pin 128-frame "
                             "blocks")
    fout, _ = _main_path(fctx, kernels)
    _check_close(f"{flabel}: vs the f64 numpy oracle", fout,
                 flanger_oracle(), 1e-5)
    fms = _render_ms(flabel, lambda: flanger_context(wt, "cuda"),
                     BATCH_SECONDS, reps=3)
    _, fops = _busy_launches(flabel, "start_rendering_sync",
                             [flanger_context(wt, "cuda")
                              .start_rendering_sync])
    res["flanger"] = {"ms": fms, "blocks": fnb, "ms_per_quantum": fms / fnb,
                      "ops_per_quantum": fops / fnb if fops else None}
    for key, r in res.items():
        print(f"x. {key}: {r['ms_per_quantum'] * 1000:.1f} us and "
              f"{r['ops_per_quantum'] or float('nan'):.1f} device operations "
              f"per 128-frame quantum ({r['blocks']} quanta)", flush=True)
    res["launches"] = launches
    return res


def reverb_clips(count, frames, seed):
    """The reverb corpus's dry clips: synthetic stereo clips made with
    numpy from a seed (a sine of 80-2,000 Hz a channel, a slow tremolo and
    noise), (count, 2, frames) f32 at 44.1 kHz."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / REVERB_FS
    f = rng.uniform(80.0, 2000.0, (count, 2, 1))
    trem = 1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.2, 3.0, (count, 1, 1))
                              * t)
    x = rng.uniform(0.2, 0.9, (count, 1, 1)) * trem * np.sin(2 * np.pi * f * t)
    x += 0.03 * rng.standard_normal((count, 2, frames))
    return x.astype(np.float32)


def phase_y(wt, compiler, dither, kernels):
    """The reverb corpus: a GraphBatch of config 3 at 2 s, REVERB_CORPUS
    instances, a clip each, the IR shared, bounced by K5.  Returns the
    launches, throughput and peak memory."""
    label = f"y. reverb corpus, {REVERB_CORPUS} clips of {BATCH_SECONDS:g} s"
    clips = reverb_clips(REVERB_CORPUS, int(2 * REVERB_FS), SEED + 31)
    ctx, src = reverb_context(wt, "cuda", REVERB_SHORT)
    gb = wt.GraphBatch(ctx, batch=REVERB_CORPUS)
    gb.override_buffer(src, clips)
    plan = (gb.cg.block_frames, gb.cg.two_rate_m, gb.cg.inner_frames)
    print(f"{label}: plan block_frames {plan[0]} ({gb.nb} block(s)), m "
          f"{plan[1]} x inner {plan[2]}", flush=True)
    if plan != (90112, 8, 11264):
        raise AssertionError(f"the corpus plan {plan} is not (90112, 8, "
                             "11264)")
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = gb.render()
    codes = gb.render_i16(SEED)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"{label}: render() and render_i16 launched {launches}; peak "
          f"device memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} "
          "GiB above the staged batch)", flush=True)
    if launches["dither_i16"] != 1:
        raise AssertionError("K5 did not launch on the reverb corpus path")
    host = _host(out)[..., :REVERB_SHORT]
    if not np.isfinite(host).all() or np.abs(host).max() < 0.05:
        raise AssertionError("the corpus render is not finite or silent")
    again = _host(gb.render())[..., :REVERB_SHORT]
    if not np.array_equal(host, again):
        raise AssertionError("a second render of the staged batch differs "
                             "(a state written in place?)")
    for i in (0, REVERB_CORPUS // 2 - 1, REVERB_CORPUS - 1):
        own = reverb_context(wt, "cuda", REVERB_SHORT, dry=clips[i])[0]
        _check_close(f"{label}: lane {i} vs its own start_rendering_sync on "
                     "the card", host[i], own.start_rendering_sync()
                     .to_array(), 1e-6)
    want = dither.dither_i16_reference(out, SEED)
    if not torch.equal(codes, want):
        raise AssertionError("render_i16 differs from the plain dither of "
                             "render()")
    print(f"{label}: render_i16 {tuple(codes.shape)} equals the plain dither "
          "of render(); a second render() equals the first", flush=True)
    del out, codes, want
    torch.cuda.empty_cache()
    ms = _median_events_ms(gb.render)
    rate = REVERB_CORPUS * BATCH_SECONDS * 1000.0 / ms
    print(f"{label}: staged render median {ms:.3f} ms -> {rate:.1f} "
          f"instance-audio-s per wall s, {REVERB_CORPUS * 1000.0 / ms:.1f} "
          "clips/s", flush=True)
    i16_ms = _median_events_ms(lambda: gb.render_i16(SEED).cpu())
    print(f"{label}: render_i16 + host copy median {i16_ms:.3f} ms -> "
          f"{REVERB_CORPUS * BATCH_SECONDS * 1000.0 / i16_ms:.1f} "
          "instance-audio-s per wall s", flush=True)
    busy, ops = _busy_launches(label, "staged render", [gb.render] * 2)
    del gb
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "rate": rate, "i16_ms": i16_ms,
            "peak": peak, "busy": busy, "ops": ops}


SPATIAL_FS = 44100.0
SPATIAL_FRAMES = int(SPATIAL_FS * SECONDS)
HRTF_BLOCK = 441088          # config 4's one block (3,446 quanta)
BINAURAL_CORPUS = 256
BINAURAL_FRAMES = int(SPATIAL_FS * BATCH_SECONDS)
DOPPLER_MAX = 100.0 / 343.0  # s: 100 m at the speed of sound


def hrtf_context(wt, device, frames=SPATIAL_FRAMES):
    """BASELINE config 4 (benches/suite.py::case_hrtf_moving): a 220 Hz
    sawtooth into an HRTF PannerNode at z = -2, the listener orbiting it
    at radius 3 once in 10 s (64 linear ramps a coordinate), 44.1 kHz,
    stereo."""
    ctx = wt.OfflineAudioContext(2, frames, SPATIAL_FS, device=device)
    osc = ctx.create_oscillator(type="sawtooth", frequency=220.0)
    p = ctx.create_panner(panning_model="HRTF", position_z=-2.0)
    for t in np.linspace(0, SECONDS, 64):
        ang = 2 * np.pi * t / SECONDS
        ctx.listener.position_x.linear_ramp_to_value_at_time(
            float(np.sin(ang) * 3), float(t))
        ctx.listener.position_z.linear_ramp_to_value_at_time(
            float(np.cos(ang) * 3), float(t))
    osc.connect(p)
    p.connect(ctx.destination)
    osc.start()
    return ctx


def _hrtf_kernel(compiler, ctx):
    """(plan, blocks, the HRTF kernel's node id) of ctx's whole render."""
    cg, nb = _plan(compiler, ctx)
    (nid,) = [k for k, kern in cg.kernels.items()
              if type(kern).__name__ == "HrtfPannerKernel"]
    return cg, nb, nid


def _quantum_params(cg, nid, node, nq):
    """The panner's own and foreign (listener) params at each quantum's
    first sample, from a compiled plan: alias -> (nq,) f32."""
    items = [(p, nid, p) for p in node.params]
    items += [(a, src.node_id, p)
              for a, (src, p) in node.foreign_params().items()]
    out = {}
    for alias, pnid, pname in items:
        plan = cg.param_plan[(pnid, pname)]
        out[alias] = (np.full(nq, plan.scalar, np.float32) if plan.is_constant
                      else np.asarray(plan.dense, np.float32)[::128][:nq])
    return out


def _geometry64(q):
    """Azimuth, elevation (degrees) and the inverse-distance gain of
    spatial.rs:205-270 and panner.rs:955-985 in numpy f64, for the default
    cone, from per-quantum params q (the config 4 panner's settings)."""
    sp = np.stack([q[f"position_{a}"] for a in "xyz"]).astype(np.float64)
    lp = np.stack([q[f"l_position_{a}"] for a in "xyz"]).astype(np.float64)
    lf = np.stack([q[f"l_forward_{a}"] for a in "xyz"]).astype(np.float64)
    lu = np.stack([q[f"l_up_{a}"] for a in "xyz"]).astype(np.float64)

    def unit(v):
        n = np.linalg.norm(v, axis=0)
        return v / np.where(n > 0, n, 1.0), n

    rel, dist = unit(sp - lp)
    right, _ = unit(np.cross(lf, lu, axis=0))
    fwd, _ = unit(lf)
    up = np.cross(right, fwd, axis=0)
    dot_up = np.clip(np.sum(rel * up, axis=0), -1.0, 1.0)
    el = 90.0 - np.degrees(np.arccos(dot_up))
    proj, _ = unit(rel - up * dot_up)
    az = np.degrees(np.arccos(np.clip(np.sum(proj * right, axis=0), -1, 1)))
    az = np.where(np.sum(proj * fwd, axis=0) < 0.0, 360.0 - az, az)
    az = np.where((az >= 0.0) & (az <= 270.0), 90.0 - az, 450.0 - az)
    gain = np.where(dist > 0.0, 1.0 / (1.0 + (np.maximum(dist, 1.0) - 1.0)),
                    1.0)
    return az, el, gain


def _sawtooth64(freq, frames, fs):
    """The OscillatorNode's sawtooth with the polyBLEP step correction
    (oscillator.rs:588-645) in f64, phase 0 at frame 0."""
    dt = freq / fs
    p = np.mod(np.arange(frames) * dt + 0.5, 1.0)
    t1, t2 = p / dt, (p - 1.0) / dt
    blep = np.where(p < dt, 2 * t1 - t1 * t1 - 1.0,
                    np.where(p > 1.0 - dt, t2 * t2 + 2 * t2 + 1.0, 0.0))
    return 2.0 * p - 1.0 - blep


def hrtf_oracle(compiler, ctx, frames=SPATIAL_FRAMES):
    """Config 4 in numpy f64, the HRTF panner quantum by quantum: the
    HRIR of each quantum interpolated in the time domain at the port's
    grid cell (irfft of the staged spectra; a cell differing from the f64
    geometry's is counted), direct convolution of the f64 sawtooth with
    it and with the previous quantum's HRIR (the front direction at gain 0
    before the first), their crossfade and the f64 gains' lerp.  Returns
    (the (2, frames) oracle, quanta whose cell differs from the f64
    geometry's, quanta)."""
    from webaudio_tpu_torch.nodes import hrtf

    cg, _, nid = _hrtf_kernel(compiler, ctx)
    kern = cg.kernels[nid]
    P, nq = 128, -(-frames // 128)
    q = _quantum_params(cg, nid, ctx._nodes[nid], nq)
    dense = {k: torch.from_numpy(np.repeat(v, P))[None, None]
             for k, v in q.items()}
    az, el, _ = kern.quantum_directions(dense, 1, nq)
    cells = [t[0].numpy() for t in hrtf.grid_cells(az, el, kern.az_bins,
                                                   kern.el_bins)]
    az64, el64, gain = _geometry64(q)
    az_i = np.clip(((np.radians(az64) / (2 * np.pi) + 0.5) * kern.az_bins)
                   .astype(np.int64), 0, kern.az_bins - 1)
    el_i = np.clip(((np.radians(el64) / np.pi + 0.5) * kern.el_bins)
                   .astype(np.int64), 0, kern.el_bins - 1)
    differ = int(np.sum((az_i != cells[0]) | (el_i != cells[1])))

    # the vertex HRIRs in the time domain, (V, 2, K * P)
    spectra = kern.spectra_host.astype(np.complex128)
    hrir = np.fft.irfft(spectra, axis=-1)[..., :P]
    hrir = hrir.reshape(spectra.shape[0], 2, -1)
    vids, w = kern.vids_host, kern.w_host.astype(np.float64)

    def interp(ai, ei):
        return np.einsum("qv,qvet->qet", w[ai, ei], hrir[vids[ai, ei]])

    h = interp(*cells)                                     # (nq, 2, taps)
    front = interp(np.array([kern.az_bins // 2]),
                   np.array([kern.el_bins // 2]))[0]
    h_prev = np.concatenate([front[None], h[:-1]])
    g_prev = np.concatenate([[0.0], gain[:-1]])
    taps = h.shape[-1]
    x = np.concatenate([np.zeros(taps - 1), _sawtooth64(220.0, nq * P,
                                                        SPATIAL_FS)])
    win = np.lib.stride_tricks.sliding_window_view(x, taps)[:, ::-1]
    k = np.arange(P) / P
    out = np.zeros((2, nq * P))
    for q0 in range(0, nq, 256):
        q1 = min(q0 + 256, nq)
        xs = win[q0 * P:q1 * P].reshape(q1 - q0, P, taps)
        yn = np.matmul(xs, h[q0:q1].transpose(0, 2, 1)).transpose(0, 2, 1)
        yp = np.matmul(xs, h_prev[q0:q1].transpose(0, 2, 1)).transpose(0, 2, 1)
        g = g_prev[q0:q1, None] + (gain - g_prev)[q0:q1, None] * k
        y = (yp * (1.0 - k) + yn * k) * g[:, None, :]
        out[:, q0 * P:q1 * P] = y.transpose(1, 0, 2).reshape(2, -1)
    return out[:, :frames], differ, nq


def phase_z(wt, compiler, kernels):
    """BASELINE config 4 at full width through start_rendering_sync:
    the plan, the CPU render, the f64 oracle, end to end, the block loop,
    and the profile (device operations, device time by op, busy share,
    peak memory).  Returns the numbers."""
    label = "z. config 4, HRTF panner, moving listener, 10 s 44.1 kHz"
    ctx = hrtf_context(wt, "cuda")
    cg, nb, _ = _hrtf_kernel(compiler, ctx)
    print(f"{label}: plan block_frames {cg.block_frames} ({nb} block(s)), "
          f"dense rows {cg.dense_params}", flush=True)
    if (cg.block_frames, nb) != (HRTF_BLOCK, 1):
        raise AssertionError(f"config 4's plan ({cg.block_frames}, {nb}) is "
                             f"not the JAX package's ({HRTF_BLOCK}, 1)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, launches = _main_path(ctx, kernels)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"{label}: main path launched {launches} (no hand kernel lies on "
          f"this path: cuFFT, gathers and PyTorch ops); peak device memory "
          f"{peak / 2**20:.1f} MiB above the context's", flush=True)
    cpu = hrtf_context(wt, "cpu").start_rendering_sync().to_array()
    err_cpu = _check_close(f"{label}: vs the port's CPU render", out, cpu,
                           1e-5)
    want, differ, nq = hrtf_oracle(compiler, hrtf_context(wt, "cpu"))
    print(f"{label}: the port's grid cell differs from the f64 geometry's "
          f"in {differ} of {nq} quanta", flush=True)
    err = _check_close(f"{label}: vs the f64 numpy oracle (time-domain "
                       "HRIRs, direct convolution, crossfade, gain lerp)",
                       out, want, 1e-4)
    print(f"{label}: errors {err_cpu / np.abs(cpu).max():.3e} x peak (CPU), "
          f"{err / np.abs(want).max():.3e} x peak (oracle)", flush=True)

    def make():
        return hrtf_context(wt, "cuda")

    e2e = _render_ms(label, make, SECONDS)
    loop_ms, runs, args = _loop_ms(compiler, cg, SPATIAL_FRAMES)
    print(f"{label}: block loop on a compiled plan: median {loop_ms:.3f} ms "
          f"of {['%.3f' % r for r in runs]} (3 renders each) -> realtime "
          f"factor {SECONDS * 1000.0 / loop_ms:.1f}x", flush=True)
    busy, ops = _busy_launches(label, "start_rendering_sync",
                               [make().start_rendering_sync
                                for _ in range(3)])
    loop_busy, loop_ops = _busy_launches(
        label, "block loop", [lambda: compiler.scan_render(cg, *args)] * 3)
    del args, cg
    torch.cuda.empty_cache()
    return {"launches": launches, "e2e_ms": e2e, "loop_ms": loop_ms,
            "busy": busy, "ops": ops, "loop_busy": loop_busy,
            "loop_ops": loop_ops, "peak": peak, "err_cpu": err_cpu,
            "err_oracle": err, "cells_differ": differ, "quanta": nq}


def doppler_context(wt, device, rate_ramp=False, frames=SPATIAL_FRAMES):
    """examples/doppler.py's graph at 44.1 kHz: a looping source (bench.py's
    synthetic buffer standing in for siren.mp3) -> a DelayNode swept 0.29
    -> 0 -> 0.29 s (the finite speed of sound) -> an equal-power,
    inverse-distance PannerNode moving along y from +100 to -100 (cone
    inner 360, outer 0); with `rate_ramp` the source's playback_rate ramps
    0.8 -> 1.25 over the render (the automated-rate playhead)."""
    seconds = frames / SPATIAL_FS
    ctx = wt.OfflineAudioContext(2, frames, SPATIAL_FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(_reverb_dry(), SPATIAL_FS)
    if rate_ramp:
        src.playback_rate.set_value_at_time(0.8, 0.0)
        src.playback_rate.linear_ramp_to_value_at_time(1.25, seconds)
    panner = ctx.create_panner(
        panning_model="equalpower", distance_model="inverse",
        position_x=0.0, position_y=100.0, position_z=1.0,
        orientation_x=1.0, orientation_y=0.0, orientation_z=0.0,
        ref_distance=1.0, max_distance=10000.0, rolloff_factor=1.0,
        cone_inner_angle=360.0, cone_outer_angle=0.0, cone_outer_gain=0.0)
    panner.position_y.linear_ramp_to_value_at_time(-100.0, seconds)
    delay = ctx.create_delay(max_delay_time=1.0)
    delay.delay_time.set_value_at_time(DOPPLER_MAX, 0.0)
    delay.delay_time.linear_ramp_to_value_at_time(0.0, seconds / 2)
    delay.delay_time.linear_ramp_to_value_at_time(DOPPLER_MAX, seconds)
    src.connect(delay)
    delay.connect(panner)
    panner.connect(ctx.destination)
    src.start()
    return ctx, src, delay, panner


def doppler_oracle(compiler, rate_ramp=False, frames=SPATIAL_FRAMES):
    """doppler_context in numpy f64 on its params' compiled f32 rows: the
    source read by a sequential f64 playhead (np.cumsum of the k-rate
    playback rates, wrapped into the 2 s loop and lerped), the delay's lerp
    at t - d(t) fs (silence before the first sample), and the panner in
    f64: the source lies behind the listener (azimuth 180, folded to 0),
    so the stereo input's ears take L = l + r cos(pi/2) and
    R = r sin(pi/2), times 1 / max(distance, 1) (the inverse model, ref 1,
    rolloff 1; the cone passes everything 90 degrees off the source's
    axis)."""
    import webaudio_tpu_torch as wt

    ctx, src, delay, panner = doppler_context(wt, "cpu", rate_ramp, frames)
    cg, _ = _plan(compiler, ctx)

    def row(node, name):
        plan = cg.param_plan[(node.node_id, name)]
        if plan.is_constant:
            return np.full(frames, np.float32(plan.scalar), np.float64)
        return np.asarray(plan.dense[:frames], np.float64)

    data = _reverb_dry().astype(np.float64)          # (2, L), equal rows
    L = data.shape[1]
    rate = row(src, "playback_rate")
    pos = np.mod(np.concatenate([[0.0], np.cumsum(rate)[:-1]]), L)
    i0 = np.floor(pos).astype(np.int64)
    fr = pos - i0
    x = data[:, i0] * (1.0 - fr) + data[:, (i0 + 1) % L] * fr
    dpos = np.arange(frames) - row(delay, "delay_time") * SPATIAL_FS
    j0 = np.floor(dpos).astype(np.int64)
    k = dpos - j0
    xa = np.where(j0 >= 0, x[:, np.clip(j0, 0, frames - 1)], 0.0)
    xb = np.where(j0 + 1 >= 0, x[:, np.clip(j0 + 1, 0, frames - 1)], 0.0)
    y = xa * (1.0 - k) + xb * k
    g = 1.0 / np.maximum(np.sqrt(row(panner, "position_y") ** 2
                                 + row(panner, "position_z") ** 2), 1.0)
    return np.stack([(y[0] + y[1] * np.cos(np.pi / 2)) * g,
                     y[1] * np.sin(np.pi / 2) * g])


def phase_za(wt, compiler, kernels):
    """The Doppler graph at full width, at a constant and an automated
    playback rate: the CPU render, the f64 oracle, end to end and the busy
    share.  Returns the numbers."""
    res = {}
    for rate_ramp in (False, True):
        key = "rate ramp" if rate_ramp else "constant rate"
        label = f"za. Doppler, {key}, 10 s 44.1 kHz"
        ctx = doppler_context(wt, "cuda", rate_ramp)[0]
        cg, nb = _plan(compiler, ctx)
        (src,) = [k for k in cg.kernels.values()
                  if type(k).__name__ == "_BufferSourceKernel"]
        print(f"{label}: plan block_frames {cg.block_frames} ({nb} "
              f"block(s)), the source's playhead "
              f"{'cumsum' if src.const_rate is None else 'closed form'} "
              f"({src.read_mode} read)", flush=True)
        if (src.const_rate is None) != rate_ramp:
            raise AssertionError(f"{label}: the wrong playhead")
        out, launches = _main_path(ctx, kernels)
        cpu = doppler_context(wt, "cpu", rate_ramp)[0] \
            .start_rendering_sync().to_array()
        err_cpu = _check_close(f"{label}: vs the port's CPU render", out,
                               cpu, 1e-5)
        want = doppler_oracle(compiler, rate_ramp)
        err = _check_close(f"{label}: vs the f64 numpy oracle (playhead, "
                           "delay lerp, panner gains)", out, want, 1e-4)
        print(f"{label}: errors {err_cpu / np.abs(cpu).max():.3e} x peak "
              f"(CPU), {err / np.abs(want).max():.3e} x peak (oracle); "
              f"launched {launches}", flush=True)

        def make(rate_ramp=rate_ramp):
            return doppler_context(wt, "cuda", rate_ramp)[0]

        e2e = _render_ms(label, make, SECONDS)
        busy, ops = _busy_launches(label, "start_rendering_sync",
                                   [make().start_rendering_sync
                                    for _ in range(3)])
        res[key] = {"e2e_ms": e2e, "busy": busy, "ops": ops,
                    "err_cpu": err_cpu, "err_oracle": err,
                    "blocks": nb, "launches": launches}
    return res


def orbit(listener, phase, radius, seconds):
    """One binaural-corpus instance's listener orbit: 16 linear ramps a
    coordinate once around the source in `seconds`, from angle `phase`."""
    for t in np.linspace(0.0, seconds, 16):
        ang = phase + 2 * np.pi * t / seconds
        listener.position_x.linear_ramp_to_value_at_time(
            float(radius * np.sin(ang)), float(t))
        listener.position_z.linear_ramp_to_value_at_time(
            float(radius * np.cos(ang)), float(t))


def binaural_context(wt, device, clip=None, phase=0.0, radius=2.0):
    """The binaural corpus's graph, 2 s at 44.1 kHz: a looping mono clip
    (bench.py's synthetic buffer unless given) -> an HRTF PannerNode at
    z = -1 -> destination, the listener orbiting (`orbit`).  Returns
    (ctx, src)."""
    ctx = wt.OfflineAudioContext(2, BINAURAL_FRAMES, SPATIAL_FS,
                                 device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(
        _reverb_dry()[:1] if clip is None else clip, SPATIAL_FS)
    p = ctx.create_panner(panning_model="HRTF", position_z=-1.0)
    orbit(ctx.listener, phase, radius, BATCH_SECONDS)
    src.connect(p)
    p.connect(ctx.destination)
    src.start()
    return ctx, src


def binaural_orbits(wt, count, seed):
    """Each instance's orbit, a phase and a radius from a seed, and its
    listener rows as a context compiles them: (phases, radii, (2, count,
    frames) f32 position_x and position_z rows)."""
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0.0, 2 * np.pi, count)
    radii = rng.uniform(1.5, 4.0, count)
    rows = np.zeros((2, count, BINAURAL_FRAMES), np.float32)
    for i in range(count):
        ctx = wt.OfflineAudioContext(2, BINAURAL_FRAMES, SPATIAL_FS,
                                     device="cpu")
        orbit(ctx.listener, phases[i], radii[i], BATCH_SECONDS)
        for r, name in enumerate(("position_x", "position_z")):
            rows[r, i] = getattr(ctx.listener, name).compile_for_render(
                SPATIAL_FS, BINAURAL_FRAMES).dense[:BINAURAL_FRAMES]
    return phases, radii, rows


def phase_zb(wt, compiler, dither, kernels):
    """The binaural corpus: a GraphBatch of BINAURAL_CORPUS instances of
    the binaural graph, each its own mono clip (override_buffer) and
    listener orbit (override_param on the listener's position_x and
    position_z), bounced by K5.  Returns the launches, throughput, peak
    memory and busy share."""
    label = (f"zb. binaural corpus, {BINAURAL_CORPUS} clips of "
             f"{BATCH_SECONDS:g} s")
    clips = reverb_clips(BINAURAL_CORPUS, BINAURAL_FRAMES, SEED + 40)[:, :1]
    phases, radii, rows = binaural_orbits(wt, BINAURAL_CORPUS, SEED + 41)
    ctx, src = binaural_context(wt, "cuda")
    gb = wt.GraphBatch(ctx, batch=BINAURAL_CORPUS)
    gb.override_buffer(src, clips)
    gb.override_param(ctx.listener, "position_x", rows[0])
    gb.override_param(ctx.listener, "position_z", rows[1])
    print(f"{label}: plan block_frames {gb.cg.block_frames} ({gb.nb} "
          f"block(s)), dense rows {gb.cg.dense_params}", flush=True)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = gb.render()
    codes = gb.render_i16(SEED)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"{label}: render() and render_i16 launched {launches}; peak "
          f"device memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} "
          "GiB above the staged batch)", flush=True)
    if launches["dither_i16"] != 1:
        raise AssertionError("K5 did not launch on the binaural corpus path")
    host = _host(out)[..., :BINAURAL_FRAMES]
    if not np.isfinite(host).all() or np.abs(host).max() < 0.05:
        raise AssertionError("the corpus render is not finite or silent")
    again = _host(gb.render())[..., :BINAURAL_FRAMES]
    if not np.array_equal(host, again):
        raise AssertionError("a second render of the staged batch differs "
                             "(a state written in place?)")
    for i in (0, BINAURAL_CORPUS // 2 - 1, BINAURAL_CORPUS - 1):
        own = binaural_context(wt, "cuda", clips[i], phases[i], radii[i])[0]
        _check_close(f"{label}: lane {i} vs its own start_rendering_sync on "
                     "the card", host[i], own.start_rendering_sync()
                     .to_array(), 1e-6)
    want = dither.dither_i16_reference(out, SEED)
    if not torch.equal(codes, want):
        raise AssertionError("render_i16 differs from the plain dither of "
                             "render()")
    print(f"{label}: render_i16 {tuple(codes.shape)} equals the plain dither "
          "of render(); a second render() equals the first", flush=True)
    del out, codes, want
    torch.cuda.empty_cache()
    ms = _median_events_ms(gb.render)
    rate = BINAURAL_CORPUS * BATCH_SECONDS * 1000.0 / ms
    print(f"{label}: staged render median {ms:.3f} ms -> {rate:.1f} "
          f"instance-audio-s per wall s, {BINAURAL_CORPUS * 1000.0 / ms:.1f} "
          "clips/s", flush=True)
    i16_ms = _median_events_ms(lambda: gb.render_i16(SEED).cpu())
    print(f"{label}: render_i16 + host copy median {i16_ms:.3f} ms -> "
          f"{BINAURAL_CORPUS * BATCH_SECONDS * 1000.0 / i16_ms:.1f} "
          "instance-audio-s per wall s", flush=True)
    busy, ops = _busy_launches(label, "staged render", [gb.render] * 2)
    del gb
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "rate": rate, "i16_ms": i16_ms,
            "peak": peak, "busy": busy, "ops": ops}


SESSION_QPB = 128            # 16,384-frame session steps
SESSION_STEPS = 30           # 491,520 frames >= 10 s at 48 kHz
SESSION_SAVE_AT = 15         # save after this step; restore and go on
REVERB_STEPS = 27            # 442,368 frames >= 10 s at 44.1 kHz
REVERB_SAVE_AT = 13
CPU_PREFIX_STEPS = 6         # 98,304 frames >= the 2 s CPU prefix
GRAIN_SESSION_SECONDS = 1.0
GRAIN_SESSION_GRAINS = 64
SEGMENTS = 8                 # render_time_sharded's segments on one card
CRUSH_BATCH = 64
CRUSH_FRED = 0.5             # frequency_reduction: exact in f32 sums
SCRIPT_BUFFER = 4096


def bench_context(wt, device, frames=FRAMES):
    """bench.py's graph without its destination edge: a looping source of
    the synthetic 2 s buffer -> lowpass 2000 Hz, Q 2.  Returns (ctx,
    filt); the caller connects filt."""
    ctx = wt.OfflineAudioContext(2, frames, FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(_bench_data(), FS)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0, q=2.0)
    src.connect(filt)
    return ctx, filt


def bitcrusher_processor(wt):
    """A PyTorch port of examples/worklet_bitcrusher.py's processor (the
    reference's examples/worklet_bitcrusher.rs): quantize to `bit_depth`
    bits and sample-and-hold at the rate `frequency_reduction`, with a
    cumsum for the phase and a cummax for the index of the latest trigger.
    A class attribute `record`, when a list, receives each block's input
    and bit depth (single-instance renders only)."""
    from webaudio_tpu_torch.param import AudioParamDescriptor, AutomationRate

    class BitCrusherProcessor(wt.AudioWorkletProcessor):
        record = None

        @classmethod
        def parameter_descriptors(cls):
            return [AudioParamDescriptor("bit_depth", AutomationRate.A,
                                         12.0, 1.0, 16.0),
                    AudioParamDescriptor("frequency_reduction",
                                         AutomationRate.A, 0.5, 0.0, 1.0)]

        def init_state(self, rc):
            f32 = dict(dtype=torch.float32, device=rc.device)
            return {"phase": torch.zeros((), **f32),
                    "held": torch.zeros((max(1, rc.input_channel_counts[0]),),
                                        **f32)}

        def process(self, scope, state, inputs, params):
            x = inputs[0]                                    # (C, B)
            B = x.shape[1]
            depth = torch.broadcast_to(params["bit_depth"], (B,))
            fred = torch.broadcast_to(params["frequency_reduction"], (B,))
            if self.record is not None:
                self.record.append((x.clone(), depth.clone()))
            step = torch.pow(0.5, depth)                     # quantum step
            quant = step * torch.floor(x / step + 0.5)       # (C, B)
            # phase accumulation with subtract-1-on-trigger == ceil
            # arithmetic on the running sum
            P = state["phase"] + torch.cumsum(fred, 0)
            prev = torch.cat([state["phase"][None], P[:-1]])
            trig = P > 1.0 + torch.clamp(torch.ceil(prev - 1.0), min=0.0)
            phase_out = P[-1] - torch.clamp(torch.ceil(P[-1] - 1.0), min=0.0)
            # sample-and-hold: the quantized value at the latest trigger
            idx = torch.where(trig, torch.arange(B, device=x.device), -1)
            last = torch.cummax(idx, 0).values
            taken = quant.index_select(1, torch.clamp(last, min=0))
            out = torch.where(last[None, :] >= 0, taken, state["held"][:, None])
            return {"phase": phase_out, "held": out[:, -1]}, [out]

    return BitCrusherProcessor


def crusher_context(wt, device, frames=FRAMES, depth_end=4.0, proc=None):
    """bench_context -> the bitcrusher worklet (bit_depth ramped a-rate
    from 16 to `depth_end` over the render, frequency_reduction
    CRUSH_FRED) -> destination.  Returns (ctx, crusher)."""
    ctx, filt = bench_context(wt, device, frames)
    crusher = ctx.create_audio_worklet(proc or bitcrusher_processor(wt))
    crusher.parameters["bit_depth"].set_value_at_time(16.0, 0.0)
    crusher.parameters["bit_depth"].linear_ramp_to_value_at_time(
        depth_end, frames / FS)
    crusher.parameters["frequency_reduction"].value = CRUSH_FRED
    filt.connect(crusher)
    crusher.connect(ctx.destination)
    return ctx, crusher


def crusher_oracle(x, depth, fred=CRUSH_FRED):
    """The reference bitcrusher sample by sample in numpy f32: x (C, T)
    the worklet's input, depth (T,) its bit depth.  The phase gains
    `fred` a sample; when it passes 1 it drops by 1 and the held value
    takes the sample quantized to 0.5 ** depth.  Returns (the output, each
    sample's trigger sample, -1 before the first)."""
    x = np.asarray(x, np.float32)
    step = np.power(np.float32(0.5), np.asarray(depth, np.float32))
    quant = step * np.floor(x / step + np.float32(0.5))
    src = np.empty(x.shape[1], np.int64)
    phase, last = 0.0, -1
    for t in range(x.shape[1]):
        phase += fred
        if phase > 1.0:
            phase -= 1.0
            last = t
        src[t] = last
    out = np.where(src >= 0, quant[:, np.maximum(src, 0)], 0.0)
    return out.astype(np.float32), src


def crush_close(name, got, want, depth, rel, x, src, delta):
    """A bitcrusher's output against another render or an oracle: every
    sample within rel x peak, apart from rounding-boundary flips: samples
    that differ by one quantization step (0.5 ** depth) and whose trigger
    sample's input, x at src (the input of `want`), lies within `delta` of
    a rounding boundary, where inputs that differ by up to `delta` may
    round to neighbouring levels.  Returns (max error off the flips,
    flips)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    peak = float(np.abs(want).max())
    diff = np.abs(got - want)
    depth = np.asarray(depth, np.float64)
    step = 0.5 ** depth[np.maximum(src, 0)]
    v = np.asarray(x, np.float64)[:, np.maximum(src, 0)] / step + 0.5
    near = (np.abs(v - np.round(v)) * step <= delta) & (src >= 0)
    flips = (diff > rel * peak) & (np.abs(diff - step) <= 1e-2 * step) & near
    err = float(np.where(flips, 0.0, diff).max())
    n_flips = int(flips.sum())
    ok = got.shape == want.shape and bool(np.isfinite(got).all()) and \
        err <= rel * peak
    print(f"{name}: max_abs_err {err:.3e} peak {peak:.6f} limit {rel:g} x "
          f"peak, apart from {n_flips} rounding-boundary flips of one "
          f"quantization step ({n_flips / diff.size:.2e} of the samples; "
          f"their inputs within {delta:.2e} of a boundary) -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: {err} > {rel} x {peak}")
    return err, n_flips


def _session_steps(session, n_steps, kernels=()):
    """`n_steps` session steps of its block on the card with every
    kernel's count from 0: (each step's (C, frames) output on the card,
    host ms, block-walk device ms and wall s per step, launches)."""
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    chunks, host, walk, wall = [], [], [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        chunks.append(session.step_device(session.block_frames))
        walk.append(session.walk_ms())       # waits for the step's walk
        wall.append(time.perf_counter() - t0)
        host.append(session.host_ms)
    return chunks, host, walk, wall, {k.__name__: k.launches for k in kernels}


def _resumed_session(wt, make, steps, save_at, tmp):
    """A session of a fresh context from make(): `save_at` steps, saved;
    a fresh context's session restored from it runs the remaining steps.
    Returns (the restored session's output, the checkpoint's bytes)."""
    first = wt.RenderSession(make(), quanta_per_block=SESSION_QPB)
    for _ in range(save_at):
        first.step_device(first.block_frames)
    path = os.path.join(tmp, "session.npz")
    first.save(path)
    second = wt.RenderSession(make(), quanta_per_block=SESSION_QPB)
    second.restore(path)
    if second.frame != save_at * second.block_frames:
        raise AssertionError(f"restored at frame {second.frame}")
    out = torch.cat([second.step_device(second.block_frames)
                     for _ in range(steps - save_at)], dim=-1)
    return out, os.path.getsize(path)


def _session_case(wt, label, make, make_cpu, steps, save_at, oneshot_frames,
                  kernels, fs):
    """A RenderSession of make()'s context on the card (steps of
    SESSION_QPB quanta): resumed at `save_at` bit-equal, the CPU session's
    2 s prefix at 1e-5 x peak, the one-shot render at 1e-4 x peak.
    Returns (each step's output on the card, measurements)."""
    import tempfile

    session = wt.RenderSession(make(), quanta_per_block=SESSION_QPB)
    chunks, host, walk, wall, launches = _session_steps(session, steps,
                                                        kernels)
    out = torch.cat(chunks, dim=-1)
    cg = session._cg
    print(f"{label}: {steps} steps of {session.block_frames} frames, plan "
          f"block {cg.block_frames} ({session.block_frames // cg.block_frames}"
          f" a step), dense rows {len(cg.dense_params)}; launched "
          f"{launches}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        resumed, nbytes = _resumed_session(wt, make, steps, save_at, tmp)
    tail = out[:, save_at * session.block_frames:]
    if not torch.equal(resumed, tail):
        err = float((resumed - tail).abs().max())
        raise AssertionError(f"{label}: the restored session differs from "
                             f"the uninterrupted one by {err}")
    print(f"{label}: saved after step {save_at} ({nbytes} bytes), restored "
          f"into a fresh context: steps {save_at + 1}-{steps} bit-equal to "
          "the uninterrupted session", flush=True)
    host_out = _host(out)
    cpu = wt.RenderSession(make_cpu(), quanta_per_block=SESSION_QPB)
    want = np.concatenate([cpu.step(cpu.block_frames)
                           for _ in range(CPU_PREFIX_STEPS)], axis=1)
    n = min(int(2.0 * fs), want.shape[1])
    err_cpu = _check_close(f"{label}: first 2 s vs the port's CPU session",
                           host_out[:, :n], want[:, :n], 1e-5)
    one = make().start_rendering_sync().to_array()
    err_one = _check_close(f"{label}: vs the one-shot start_rendering_sync",
                           host_out[:, :oneshot_frames], one, 1e-4)
    step_s = session.block_frames / fs
    med_host, med_walk = statistics.median(host[1:]), statistics.median(walk[1:])
    med_wall = statistics.median(wall[1:])
    total = sum(wall)
    print(f"{label}: per step (median of steps 2-{steps}; step 1 in "
          f"brackets) host {med_host:.3f} ms [{host[0]:.3f}] (dense rows and "
          f"timelines), block walk {med_walk:.3f} ms [{walk[0]:.3f}] device "
          f"time, wall {1000 * med_wall:.3f} ms [{1000 * wall[0]:.3f}] -> "
          f"realtime factor {step_s / med_wall:.1f}x a step, "
          f"{steps * step_s / total:.1f}x over the {steps} steps "
          f"({total:.3f} s); checkpoint {nbytes} bytes", flush=True)
    return chunks, {"launches": launches, "host_ms": med_host,
                    "walk_ms": med_walk, "step_wall_ms": 1000 * med_wall,
                    "first_step_ms": 1000 * wall[0], "wall_s": total,
                    "realtime_step": step_s / med_wall,
                    "realtime": steps * step_s / total, "ckpt_bytes": nbytes,
                    "err_cpu": err_cpu, "err_oneshot": err_one}


def phase_zc(wt, ck, gr, dither, fusion, kernels):
    """RenderSession at full width: the slice graph (K1 once a step, K5
    bouncing its chunks), config 3 (steps clamped by the cycle) and the
    64-grain session in 128-frame blocks (R5).  Returns the
    measurements."""
    from webaudio_tpu_torch.nodes import waveshaper

    res = {}
    label = "zc. RenderSession, slice graph 10 s 48 kHz"
    with _recording(waveshaper, "curve_lookup") as shaped:
        chunks, res["slice"] = _session_case(
            wt, label, lambda: slice_context(wt, "cuda", _bench_data(), FS),
            lambda: slice_context(wt, "cpu", _bench_data(), FS),
            SESSION_STEPS, SESSION_SAVE_AT, FRAMES, kernels, FS)
    k1 = res["slice"]["launches"]["curve_lookup"]
    if k1 != SESSION_STEPS or len(shaped) < SESSION_STEPS:
        raise AssertionError(f"{label}: K1 launched {k1} times in "
                             f"{SESSION_STEPS} steps")
    curve, x = shaped[0]
    res["k1_err"] = _curve_equal(f"{label}: K1's first launch",
                                 ck.curve_lookup(curve, x),
                                 ck.curve_lookup_reference(curve, x))
    print(f"{label}: K1 launched once a step, its launch {tuple(x.shape)} "
          "bit-equal to its plain version", flush=True)
    dither.dither_i16.launches = 0
    for i, chunk in enumerate(chunks):
        codes = dither.dither_i16(chunk, SEED + i)
        if not torch.equal(codes, dither.dither_i16_reference(chunk,
                                                              SEED + i)):
            raise AssertionError(f"{label}: K5 differs from the plain "
                                 f"dither on chunk {i}")
    res["k5_launches"] = dither.dither_i16.launches
    print(f"{label}: K5 bounced the {len(chunks)} chunks "
          f"({res['k5_launches']} launches), each equal to the plain "
          "dither", flush=True)
    del chunks

    label = "zc. RenderSession, config 3 10 s 44.1 kHz"
    _, res["reverb"] = _session_case(
        wt, label, lambda: reverb_context(wt, "cuda")[0],
        lambda: reverb_context(wt, "cpu")[0], REVERB_STEPS, REVERB_SAVE_AT,
        REVERB_FRAMES, kernels, REVERB_FS)

    # R5: 128-frame blocks through the grain bank
    label = (f"zc. RenderSession(quanta_per_block=1), "
             f"{GRAIN_SESSION_GRAINS} grains {GRAIN_SESSION_SECONDS:g} s")
    steps = -(-int(GRAIN_FS * GRAIN_SESSION_SECONDS) // (SESSION_QPB * 128))

    def grains(device):
        return granular_context(wt, device, GRAIN_SESSION_GRAINS,
                                GRAIN_SESSION_SECONDS)

    outs = {}
    with _grain_read(None), _recording(fusion, "grain_bank") as banked, \
            _recording(fusion, "grouped_lerp") as lerped:
        for device in ("cuda", "cpu"):
            s = wt.RenderSession(grains(device), quanta_per_block=1)
            for k in kernels:
                k.launches = 0
            outs[device] = np.concatenate(
                [s.step(SESSION_QPB * 128) for _ in range(steps)], axis=1)
            if device == "cuda":
                (fk,) = [k for k in s._cg.kernels.values()
                         if type(k).__name__ == "_FusedVoicesKernel"]
                glaunch = {k.__name__: k.launches for k in kernels}
                calls = list(banked if fk.read_mode == "fused" else lerped)
    print(f"{label}: plan block {s._cg.block_frames}, read mode "
          f"{fk.read_mode}, lanes {fk.use_lanes}; launched {glaunch}",
          flush=True)
    kern = gr.grain_bank if fk.read_mode == "fused" else gr.grouped_lerp
    ref = gr.grain_bank_reference if fk.read_mode == "fused" else \
        gr.grouped_lerp_reference
    if glaunch[kern.__name__] < 1 or not calls:
        raise AssertionError(f"{label}: {kern.__name__} did not launch")
    cuda_args = [a for a in calls if any(isinstance(t, torch.Tensor)
                                         and t.is_cuda for t in a)]
    res["grain_err"] = {kern.__name__: max(
        _equal(f"{label}: {kern.__name__} launch {i}", kern(*a), ref(*a))
        for i, a in enumerate(cuda_args[:3]))}
    err = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    energy = float(np.sum((outs["cuda"] - outs["cpu"]) ** 2.0))
    ok = err <= 3e-5 and energy <= 1e-9 * float(np.sum(outs["cpu"] ** 2.0))
    print(f"{label}: card vs CPU session max_abs_err {err:.3e} (limit 3e-5, "
          f"the granular bound), error energy {energy:.3e} -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok or np.abs(outs["cpu"]).max() < 0.05:
        raise AssertionError(f"{label}: {err} > 3e-5 or silent")
    res["grain"] = {"read_mode": fk.read_mode, "launches": glaunch,
                    "err": err}
    torch.cuda.empty_cache()
    return res


def phase_zd(wt, compiler, ck, kernels):
    """render_time_sharded on one card: the slice graph in SEGMENTS
    segments against the sequential render; config 3 and 5a refuse."""
    from webaudio_tpu_torch.parallel import segments

    label = f"zd. render_time_sharded, slice graph 10 s, {SEGMENTS} segments"
    devices = ["cuda"] * SEGMENTS
    ctx = slice_context(wt, "cuda", _bench_data(), FS)
    qpb = max(1, min(-(-FRAMES // 128) // (SEGMENTS * 4) or 1, 128))
    cg = compiler.compile_graph(dict(ctx._nodes), list(ctx._edges), FS,
                                FRAMES, ctx._destination.node_id, "cuda",
                                quanta_per_block=qpb)
    halo = segments.halo_frames(cg)
    halo_blocks, nb_net, starts = segments.segment_plan(
        FRAMES, SEGMENTS, cg.block_frames, halo)
    print(f"{label}: block {cg.block_frames} frames, halo {halo} frames -> "
          f"{halo_blocks} block(s) a segment, {nb_net} net blocks a "
          f"segment, segment starts {starts[:, halo_blocks].tolist()}",
          flush=True)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = segments.render_time_sharded(ctx, devices=devices)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    per_segment = starts.shape[1]
    if launches["curve_lookup"] != SEGMENTS * per_segment:
        raise AssertionError(f"{label}: K1 launched {launches} times, not "
                             f"once a block in every segment")
    seq_ctx = slice_context(wt, "cuda", _bench_data(), FS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = seq_ctx.start_rendering_sync().to_array()
    seq_wall = time.perf_counter() - t0
    err = _check_close(f"{label}: vs the sequential render", got, seq, 5e-5)
    print(f"{label}: launched {launches} (K1 once a block, "
          f"{per_segment} blocks in each of {SEGMENTS} segments); wall "
          f"{wall:.3f} s against {seq_wall:.3f} s sequential (segments run "
          "in turn on one card)", flush=True)
    for name, make in (("config 3", lambda: reverb_context(wt, "cuda")[0]),
                       ("5a", lambda: mastering_context(wt, "cuda")[0])):
        try:
            segments.render_time_sharded(make(), devices=devices)
        except segments.NotTimeShardableError as exc:
            print(f"zd. {name} refuses: NotTimeShardableError: {exc}",
                  flush=True)
        else:
            raise AssertionError(f"zd. {name} did not refuse")
    torch.cuda.empty_cache()
    return {"launches": launches, "err": err, "wall_s": wall,
            "seq_wall_s": seq_wall, "halo": halo}


def phase_ze(wt, kernels):
    """User code at full width: the bitcrusher worklet after bench.py's
    graph (against the CPU render and a per-sample numpy oracle on its
    input), the same as a CRUSH_BATCH-instance GraphBatch, and a
    ScriptProcessorNode passthrough x2."""
    label = "ze. bench graph -> bitcrusher worklet, 10 s 48 kHz"
    proc = bitcrusher_processor(wt)

    def recorded(depth_end, device="cuda"):
        """A single render of the crusher graph with its worklet's input
        and bit depth recorded: (output, input, depth)."""
        proc.record = []
        ctx, _ = crusher_context(wt, device, depth_end=depth_end, proc=proc)
        out, launches = _main_path(ctx, kernels)
        rec, proc.record = proc.record, None
        x = np.concatenate([_host(r[0]) for r in rec], axis=1)[:, :FRAMES]
        d = np.concatenate([_host(r[1]) for r in rec])[:FRAMES]
        return out, x, d, launches, ctx

    out, x, d, launches, ctx = recorded(4.0)
    print(f"{label}: segments {ctx.render_stats['segments']}, launched "
          f"{launches}", flush=True)
    want, src = crusher_oracle(x, d)
    cpu, cx, _, _, _ = recorded(4.0, "cpu")
    peak_in = float(np.abs(x).max())
    err_cpu, flips_cpu = crush_close(
        f"{label}: vs the port's CPU render", out, cpu, d, 1e-5, cx, src,
        1e-5 * peak_in)
    err_or, flips_or = crush_close(
        f"{label}: vs a per-sample numpy oracle on the worklet's input",
        out, want, d, 1e-6, x, src, 1e-6 * peak_in)
    e2e = _render_ms(label, lambda: crusher_context(wt, "cuda")[0], SECONDS)

    blabel = f"ze. the same as a {CRUSH_BATCH}-instance GraphBatch"
    ends = 4.0 + 8.0 * np.arange(CRUSH_BATCH) / (CRUSH_BATCH - 1)
    rows = np.stack([crusher_context(wt, "cpu", depth_end=e)[1]
                     .parameters["bit_depth"].compile_for_render(
                         FS, FRAMES).dense for e in ends])
    bctx, bcrusher = crusher_context(wt, "cuda")
    gb = wt.GraphBatch(bctx, batch=CRUSH_BATCH)
    gb.override_param(bcrusher, "bit_depth", rows)
    host = _host(gb.render())[..., :FRAMES]
    (wk,) = [k for k in gb.cg.kernels.values()
             if type(k).__name__ == "_WorkletKernel"]
    print(f"{blabel}: plan block_frames {gb.cg.block_frames}, the worklet "
          f"ran {'under torch.func.vmap' if wk.vmap_ok else 'per instance'}",
          flush=True)
    for i in (0, CRUSH_BATCH // 2 - 1, CRUSH_BATCH - 1):
        own, ox, od, _, _ = recorded(ends[i])
        crush_close(f"{blabel}: lane {i} vs its own render on the card",
                    host[i], own, od, 1e-6, ox, src, 1e-6 * peak_in)
    b_ms = _median_events_ms(gb.render)
    print(f"{blabel}: staged render median {b_ms:.3f} ms -> "
          f"{CRUSH_BATCH * SECONDS * 1000.0 / b_ms:.1f} instance-audio-s "
          "per wall s", flush=True)
    del gb, host

    slabel = (f"ze. ScriptProcessorNode({SCRIPT_BUFFER}, 2, 2) passthrough "
              "x2 after bench.py's graph, 10 s")
    seen, times = [], []

    def handler(ev):
        seen.append(np.array(ev.input_buffer))
        ev.output_buffer[:] = ev.input_buffer * 2.0

    from webaudio_tpu_torch.nodes import script_processor as spn

    def timed(self, chunk, frame):
        t0 = time.perf_counter()
        r = orig(self, chunk, frame)
        times.append(time.perf_counter() - t0)
        return r

    sctx, filt = bench_context(wt, "cuda")
    sp = sctx.create_script_processor(SCRIPT_BUFFER, 2, 2)
    sp.set_onaudioprocess(handler)
    filt.connect(sp)
    sp.connect(sctx.destination)
    orig = spn._ScriptProcessorKernel._host_process
    spn._ScriptProcessorKernel._host_process = timed
    try:
        t0 = time.perf_counter()
        sout = sctx.start_rendering_sync().to_array()
        s_wall = time.perf_counter() - t0
    finally:
        spn._ScriptProcessorKernel._host_process = orig
    lag = 2 * SCRIPT_BUFFER
    inp = np.concatenate(seen, axis=1)
    if np.any(sout[:, :lag]) or not np.array_equal(
            sout[:, lag:], 2.0 * inp[:, :FRAMES - lag]):
        raise AssertionError(f"{slabel}: the output is not the input x2 "
                             f"delayed {lag} frames")
    pctx, pfilt = bench_context(wt, "cuda")
    pfilt.connect(pctx.destination)
    plain = pctx.start_rendering_sync().to_array()
    _check_close(f"{slabel}: its input vs bench.py's graph rendered alone",
                 inp[:, :FRAMES], plain, 1e-5)
    cb_ms = 1000.0 * statistics.mean(times)
    print(f"{slabel}: plan block {sctx.render_stats['segments']}; the "
          f"output equals the input x2 delayed {lag} frames exactly; "
          f"{len(seen)} callbacks, {cb_ms:.3f} ms a callback (device->host "
          f"copy, handler, upload), render {s_wall:.3f} s -> realtime "
          f"factor {SECONDS / s_wall:.1f}x", flush=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "err_cpu": err_cpu, "flips_cpu": flips_cpu,
            "err_oracle": err_or, "flips_oracle": flips_or, "e2e_ms": e2e,
            "batch_ms": b_ms, "callbacks": len(seen), "callback_ms": cb_ms}


def phase_zf(wt, kernels):
    """start_rendering with suspend(5.0)/resume and a mutation while
    suspended, against suspend_sync; profile_render and
    collect_diagnostics."""
    import json as _json
    import tempfile

    from webaudio_tpu_torch.diagnostics import (collect_diagnostics,
                                                 profile_render)

    label = "zf. start_rendering + suspend(5.0)/resume, slice graph 10 s"

    def filt_of(ctx):
        (f,) = [n for n in ctx._nodes.values()
                if type(n).__name__ == "BiquadFilterNode"]
        return f

    ctx = slice_context(wt, "cuda", _bench_data(), FS)
    for k in kernels:
        k.launches = 0
    reached = ctx.suspend(SECONDS / 2.0)
    fut = ctx.start_rendering()
    reached.result(timeout=300)
    if ctx.state.value != "suspended" or fut.done():
        raise AssertionError(f"{label}: not parked at the suspend")
    filt_of(ctx).frequency.value = 500.0
    ctx.resume().result(timeout=10)
    got = fut.result(timeout=300).to_array()
    launches = {k.__name__: k.launches for k in kernels}
    sync = slice_context(wt, "cuda", _bench_data(), FS)
    sync.suspend_sync(SECONDS / 2.0, lambda c: setattr(filt_of(c).frequency, "value",
                                             500.0))
    want = sync.start_rendering_sync().to_array()
    if not np.array_equal(got, want):
        raise AssertionError(f"{label}: differs from the suspend_sync "
                             f"render by {np.abs(got - want).max()}")
    print(f"{label}: launched {launches}; bit-equal to the same mutation "
          f"through suspend_sync (segments' blocks "
          f"{[s['block_frames'] for s in ctx.render_stats['segments']]})",
          flush=True)

    plabel = "zf. profile_render of the 10 s slice"
    with tempfile.TemporaryDirectory() as tmp:
        pctx = slice_context(wt, "cuda", _bench_data(), FS)
        with profile_render(tmp) as prof:
            pctx.start_rendering_sync()
        with open(prof.path) as f:
            events = _json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    names = sorted({e["name"] for e in kern if "curve" in e["name"]})
    if not kern:
        raise AssertionError(f"{plabel}: the trace holds no CUDA kernel")
    diag = collect_diagnostics(pctx)
    block = diag["compiled"]["block_frames"]
    if block != pctx.render_stats["segments"][-1]["block_frames"]:
        raise AssertionError(f"{plabel}: diagnostics report block {block}")
    print(f"{plabel}: the Chrome trace holds {len(kern)} CUDA kernel "
          f"events ({names}); collect_diagnostics: block_frames {block}, "
          f"{len(diag['graph']['nodes'])} nodes, fusion "
          f"{diag['fusion']}", flush=True)
    return {"launches": launches, "trace_kernels": len(kern)}


# --- the real-time context and media I/O, zg-zi --------------------------

CLIP_FS = 44100.0            # zg's source rate: decoded into 48 kHz contexts
PACED_SECONDS = 2.0          # each paced run of zh
LATENCY_HINTS = ("interactive", "balanced", "playback")
PUSH_BLOCKS = 100            # zi's pushed blocks (the track keeps 128)
PUSH_FRAMES = 1024


def decode_source(seconds=SECONDS):
    """zg's source: `seconds` of stereo 16-bit codes at 44.1 kHz (two
    slow-swept tones and seeded noise), and its f32 samples codes / 32768:
    what a 16-bit FLAC of it decodes to exactly."""
    n = int(CLIP_FS * seconds)
    t = np.arange(n)
    rng = np.random.default_rng(SEED + 40)
    x = np.stack([0.55 * np.sin(t * 0.031) + 0.2 * np.sin(t * 0.0021),
                  0.5 * np.cos(t * 0.017) + 0.15 * np.sin(t * 0.00093)])
    x = x + 0.02 * rng.standard_normal((2, n))
    codes = np.clip(np.round(x * 32767), -32768, 32767).astype(np.int64)
    return codes, (codes / 32768.0).astype(np.float32)


def flac_bytes(codes):
    """A FLAC stream of the codes from tests/flac_ref.py's encoder: blocks
    of 4,096 frames, order-2 fixed predictors, one Rice partition."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from flac_ref import encode_flac

    sub = [dict(kind="fixed", order=2, ks=[10])] * 2
    total = codes.shape[1]
    plans = [(min(4096, total - p), "independent", sub)
             for p in range(0, total, 4096)]
    return encode_flac(codes, int(CLIP_FS), 16, plans)


def phase_zg(wt, device="cuda", seconds=SECONDS):
    """Decoding on the host into a context on the card: the native
    libraries built from the checkout, a FLAC, an f32 and a 16-bit WAV of
    zg's source.  Returns the files and the decoded buffers."""
    from webaudio_tpu_torch import native
    from webaudio_tpu_torch.media.decoding import decode_audio_data
    from webaudio_tpu_torch.media.wav import write_wav

    label = "zg. decoding"
    lib = native.get_lib()
    codec = native.get_codec_lib()
    for name in ("wahost", "wacodec"):
        path, took = native.builds.get(name, (None, "not attempted"))
        said = (f"built in {took:.2f} s" if isinstance(took, float) and took
                else "found built" if path else
                f"did not build: {str(took).strip()[-300:]}")
        print(f"{label}: lib{name} {path}: {said}", flush=True)
    if lib is None:
        raise AssertionError(f"{label}: the host library did not build")
    print(f"{label}: the FFmpeg codec host "
          f"{'built' if codec is not None else 'is unavailable'} "
          "(information only)", flush=True)
    codes, src = decode_source(seconds)
    t0 = time.perf_counter()
    files = {"flac": flac_bytes(codes), "wav f32": write_wav(None, src, CLIP_FS),
             "wav i16": write_wav(None, src, CLIP_FS, bits=16)}
    print(f"{label}: {seconds:g} s stereo at {CLIP_FS:g} Hz, files "
          f"{ {k: len(v) for k, v in files.items()} } bytes, written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ctx = wt.OfflineAudioContext(2, 128, FS, device=device)
    want = wt.AudioBuffer.from_array(src, CLIP_FS)
    want.resample(FS)
    lsb = 1.0 / 32768.0
    out = {"files": files, "source": src}
    for name, blob in files.items():
        t0 = time.perf_counter()
        raw = decode_audio_data(blob)
        t1 = time.perf_counter()
        buf = ctx.decode_audio_data_sync(blob)
        t2 = time.perf_counter()
        got = raw.to_array()
        if raw.sample_rate != CLIP_FS or got.shape != src.shape or \
                buf.sample_rate != FS:
            raise AssertionError(f"{label}: {name} decoded to {got.shape} at "
                                 f"{raw.sample_rate}, resampled at "
                                 f"{buf.sample_rate}")
        err = float(np.abs(got - src).max())
        own = wt.AudioBuffer.from_array(got, CLIP_FS)
        own.resample(FS)
        r_err = float(np.abs(buf.to_array() - want.to_array()).max())
        exact = name != "wav i16"
        # the 16-bit file: each sample within one LSB, and the resampled
        # buffer AudioBuffer.resample of what was decoded, bit for bit
        ok = (err == 0.0 and r_err == 0.0) if exact else \
            (err <= lsb and np.array_equal(buf.to_array(), own.to_array()))
        print(f"{label}: {name}: {got.shape[1]} frames, max |decoded - "
              f"source| {err:.3e}, resampled to {buf.length} frames at "
              f"{FS:g} Hz, max |- AudioBuffer.resample(source)| {r_err:.3e} "
              f"({'bit-equal' if exact else 'decoded within one LSB, equal to the resample of the decode'} required) -> "
              f"{'ok' if ok else 'FAIL'}; decode {1000 * (t1 - t0):.1f} ms, "
              f"decode + resample {1000 * (t2 - t1):.1f} ms", flush=True)
        if not ok:
            raise AssertionError(f"{label}: {name} decodes wrong")
        out[name] = buf
    return out


def online_graph(ctx, buf, start=None):
    """zh's graph: `buf` looping -> lowpass 2,000 Hz, Q 2 -> WaveShaper
    4x (tanh, 2,048 points) -> DynamicsCompressor (threshold -18 dB,
    ratio 4) -> destination, the source starting at `start` (the
    context's current time by default).  Returns its nodes."""
    src = ctx.create_buffer_source(loop=True)
    src.buffer = buf
    filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0, q=2.0)
    shaper = ctx.create_wave_shaper(oversample="4x",
                                    curve=_curve(CURVE_POINTS))
    comp = ctx.create_dynamics_compressor(threshold=-18.0, ratio=4.0)
    src.connect(filt)
    filt.connect(shaper)
    shaper.connect(comp)
    comp.connect(ctx.destination)
    src.start(ctx.current_time if start is None else start)
    return {"src": src, "filt": filt, "shaper": shaper, "comp": comp}


def online_run(wt, buf, device, frames, kernels=(), latency="playback",
               hint=None, paced=False, sink=None, on_callback=None,
               capacity=None, prepare=None, timeout=600.0, wall_s=None):
    """online_graph's graph in an AudioContext on `device`: suspended as
    it starts, the graph built with its source at the current time,
    resumed with every kernel's count from 0 until the callbacks after the
    resume hold `frames` frames, then suspended and closed.
    `on_callback(k, ctx, nodes)` runs on the render thread after callback
    k; `capacity` an update interval for render-capacity events;
    `prepare(ctx)` runs once the context is suspended; with `wall_s` the
    run ends after that many wall seconds instead.  Returns
    the callbacks' stream, each chunk's host ms (the walk and its one
    host copy), the launches, the chunks rendered, the processorerror
    events, capacity events, playback stats, wall s and the context."""
    from webaudio_tpu_torch.events import EventType
    from webaudio_tpu_torch.io_backends import CallbackBackend

    chunks, errors, events, state = [], [], [], {}

    def on_chunk(chunk, ts):
        chunks.append(np.array(chunk))
        if on_callback is not None and "nodes" in state:
            on_callback(len(chunks), state["ctx"], state["nodes"])

    ctx = wt.AudioContext(latency_hint=latency, sample_rate=FS,
                          sink_id=sink or CallbackBackend(on_chunk),
                          render_size_hint=hint, device=device)
    try:
        ctx.set_realtime_pacing(paced)
        ctx.suspend_sync()
        ctx._event_loop.add_handler(EventType.PROCESSOR_ERROR, errors.append)
        if prepare is not None:
            prepare(ctx)
        del chunks[:]
        state["nodes"] = online_graph(ctx, buf)
        state["ctx"] = ctx
        ms, inner = [], ctx._render_one_chunk

        def timed():
            t = time.perf_counter()
            out = inner()
            ms.append(1000.0 * (time.perf_counter() - t))
            return out

        ctx._render_one_chunk = timed
        f0 = ctx._frame
        if capacity:
            ctx.render_capacity.set_onupdate(events.append)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        ctx.resume_sync()
        if capacity:
            ctx.render_capacity.start(update_interval=capacity)
        deadline = time.time() + (wall_s or timeout)

        def rendered():
            return (sum(c.shape[1] for c in chunks) if sink is None
                    else ctx._frame - f0)

        while rendered() < frames and time.time() < deadline:
            time.sleep(0.002)
        ctx.suspend_sync()
        wall = time.perf_counter() - t0
        ctx.render_capacity.stop()
        launches = {k.__name__: k.launches for k in kernels}
        n_chunks = (ctx._frame - f0) // ctx._buffer_frames
        stats = ctx.playback_stats.to_json()
    finally:
        ctx.close_sync()
    if rendered() < frames and wall_s is None:
        raise AssertionError(f"online run: {rendered()} of {frames} frames "
                             f"in {timeout} s")
    stream = np.concatenate(chunks, axis=1)[:, :frames] if chunks else None
    return {"stream": stream, "chunk_ms": ms, "launches": launches,
            "chunks": n_chunks, "errors": errors, "events": events,
            "stats": stats, "wall": wall, "ctx": ctx, "f0": f0,
            "nodes": state["nodes"]}


def _online_checks(label, run, kernels):
    """No processorerror, sound, and each kernel once a chunk."""
    if run["errors"]:
        raise AssertionError(f"{label}: {len(run['errors'])} processorerror "
                             f"events, the first {run['errors'][0]!r}")
    if run["stream"] is not None and float(np.abs(run["stream"]).max()) < 0.05:
        raise AssertionError(f"{label}: the stream is silent")
    for k in kernels:
        if run["launches"][k.__name__] != run["chunks"]:
            raise AssertionError(
                f"{label}: {k.__name__} launched {run['launches'][k.__name__]}"
                f" times in {run['chunks']} chunks")


def phase_zh(wt, zg, kernels, device="cuda", seconds=SECONDS,
             paced_seconds=PACED_SECONDS):
    """The AudioContext at full width on the card: 10 s of callbacks at
    1,024 and 16,384 frames against the offline render, paced runs at the
    three latency hints, automation and a topology change while running,
    and a file sink.  Returns the measurements."""
    import tempfile

    frames = int(seconds * FS)
    buf = zg["flac"]
    on_card = device == "cuda"
    counted = kernels if on_card else ()
    off = wt.OfflineAudioContext(2, frames, FS, device=device)
    online_graph(off, buf, start=0.0)
    want = off.start_rendering_sync().to_array()
    res = {}
    for name, latency, hint in (("1024", "playback", None),
                                ("16384", "playback", 16384)):
        label = (f"zh. AudioContext, {device}, {name} chunks, "
                 f"{seconds:g} s unpaced")
        run = online_run(wt, buf, device, frames, counted, latency, hint)
        _online_checks(label, run, counted)
        B = run["ctx"]._buffer_frames
        err = _check_close(f"{label}: callbacks vs OfflineAudioContext on "
                           f"the same device", run["stream"], want, 1e-5)
        ms = run["chunk_ms"]
        p50 = statistics.median(ms)
        p99 = float(np.percentile(ms, 99))
        print(f"{label}: {run['chunks']} chunks of {B} frames, plan block "
              f"{run['ctx']._cg.block_frames}, launched {run['launches']}, "
              f"no processorerror; chunk ms median {p50:.3f}, p99 "
              f"{p99:.3f}, max {max(ms):.3f} (budget "
              f"{1000 * B / FS:.3f}); realtime factor "
              f"{run['chunks'] * B / FS / run['wall']:.2f}x over "
              f"{run['wall']:.3f} s (the first chunk's plan and staging "
              f"included), {1000 * B / FS / p50:.2f}x at the median chunk",
              flush=True)
        res[name] = {"launches": run["launches"], "chunks": run["chunks"],
                     "chunk_ms_p50": p50, "chunk_ms_p99": p99,
                     "realtime": run["chunks"] * B / FS / run["wall"],
                     "err": err, "stream": run["stream"]}

    if on_card:
        # where a chunk's time goes: its dense rows on the host, and the
        # walk and copy under the profiler, on the calling thread
        label = "zh. 1,024-frame chunks under torch.profiler"
        ctx = wt.AudioContext(latency_hint="playback", sample_rate=FS,
                              sink_id="none", device=device)
        try:
            ctx.suspend_sync()
            online_graph(ctx, buf)
            for _ in range(3):             # plan, stage resources, warm
                ctx._render_one_chunk()
            cg = ctx._cg
            t0 = time.perf_counter()
            for _ in range(20):
                for key in cg.dense_params:
                    cg.param_objects[key].advance_dense(FS, 1024, ctx._frame)
            rows_ms = (time.perf_counter() - t0) * 1000.0 / 20
            share, ops = _busy_launches(label, "1,024-frame chunks",
                                        [ctx._render_one_chunk] * 20)
        finally:
            ctx.close_sync()
        print(f"{label}: {len(cg.dense_params)} dense rows, built on the "
              f"host in {rows_ms:.3f} ms a chunk", flush=True)
        res["profile"] = {"busy_share": share, "ops_a_chunk": ops,
                          "rows_ms": rows_ms}

    for hint in LATENCY_HINTS:
        label = f"zh. paced, {paced_seconds:g} s of wall time at {hint!r}"
        run = online_run(wt, buf, device, frames, counted, hint,
                         paced=True, capacity=0.25, wall_s=paced_seconds)
        _online_checks(label, run, counted)
        ev = run["events"]
        avg = float(np.mean([e.average_load for e in ev])) if ev else None
        peak = max((e.peak_load for e in ev), default=None)
        under = [e.underrun_ratio for e in ev]
        # each chunk is one callback at these hints: the share of chunks
        # over the callback's budget
        budget = 1000.0 * run["ctx"]._buffer_frames / FS
        over = float(np.mean(np.asarray(run["chunk_ms"]) > budget))
        print(f"{label}: {run['chunks']} chunks of "
              f"{run['ctx']._buffer_frames} frames in {run['wall']:.3f} s; "
              f"{len(ev)} render-capacity events (0.25 s intervals): "
              f"average load {avg}, peak load {peak}, underrun ratios "
              f"{under}; chunks over the {budget:.3f} ms budget {over:.4f}; "
              f"chunk ms median {statistics.median(run['chunk_ms']):.3f}, "
              f"p99 {float(np.percentile(run['chunk_ms'], 99)):.3f}; "
              f"playback_stats (the last interval) {json.dumps(run['stats'])}",
              flush=True)
        res[hint] = {"average_load": avg, "peak_load": peak,
                     "underrun_ratios": under, "over_budget": over,
                     "events": len(ev),
                     "chunk_ms_p50": statistics.median(run["chunk_ms"])}

    # automation, then a new gain, scheduled from the sink callback
    label = "zh. automation and a topology change while running"
    plans, replans = [], []

    def on_callback(k, ctx, nodes):
        plans.append(ctx._cg)
        if k == 10:
            f = nodes["filt"].frequency
            f.set_value_at_time(2000.0, ctx.current_time)
            f.exponential_ramp_to_value_at_time(500.0, ctx.current_time + 0.4)
        if k == 30:
            gain = ctx.create_gain(gain=0.5)
            nodes["comp"].disconnect()
            nodes["comp"].connect(gain)
            gain.connect(ctx.destination)

    def recording(ctx):
        """Record, at each re-plan, the nodes whose states carried."""
        inner = ctx._recompile_locked

        def replan():
            before = ctx._states
            inner()
            replans.append([k for k in before or {}
                            if ctx._states.get(k) is before[k]])
        ctx._recompile_locked = replan

    run = online_run(wt, buf, device, 48 * 1024, counted,
                     on_callback=on_callback, prepare=recording)
    _online_checks(label, run, counted)
    keys = {f"n{run['nodes'][k].node_id}" for k in
            ("src", "filt", "shaper", "comp")}
    after = replans[-1]
    same = all(p is plans[0] for p in plans[:30])
    if not same or plans[30] is plans[29] or \
            any(p is not plans[30] for p in plans[30:]) or \
            not keys <= set(after):
        raise AssertionError(f"{label}: plans {[id(p) for p in plans]}, "
                             f"carried {after}")
    print(f"{label}: callbacks 1-30 (the ramp from callback 10) on one plan, "
          f"one re-plan for the gain; states carried for {sorted(keys)}",
          flush=True)

    label = "zh. file sink"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "zh.wav")
        n = min(BATCH_FRAMES, frames)
        run = online_run(wt, buf, device, n, counted, sink=f"file:{path}")
        data = run["ctx"].decode_audio_data_sync(path).to_array()
    f0 = run["f0"]
    stream = res["1024"]["stream"][:, :n]
    if data[:, :f0].any() or not np.array_equal(data[:, f0:f0 + n], stream):
        raise AssertionError(f"{label}: the WAV differs from the callback "
                             "stream")
    print(f"{label}: the WAV (decoded by the port) holds {f0} frames of "
          f"silence from before the graph, then the 1,024-frame run's "
          f"callback stream bit for bit ({n} frames)", flush=True)
    for r in ("1024", "16384"):
        del res[r]["stream"]
    return res


def phase_zi(wt, zg, kernels, device="cuda", seconds=SECONDS):
    """The media nodes on the card: an element over a WAV file into the
    slice graph, a pushed track through a unit gain, a recorder on a
    stream destination.  Returns the transfers a block."""
    import tempfile

    from webaudio_tpu_torch.media.decoding import decode_audio_data
    from webaudio_tpu_torch.media.element import MediaElement
    from webaudio_tpu_torch.media.recorder import MediaRecorder
    from webaudio_tpu_torch.media.streams import MediaStream, PushStreamTrack
    from webaudio_tpu_torch.media.wav import read_wav, write_wav
    from webaudio_tpu_torch.nodes import media_nodes as mn

    frames = int(seconds * FS)

    def slice_graph(ctx, src):
        filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0,
                                        q=2.0)
        shaper = ctx.create_wave_shaper(curve=_curve(CURVE_POINTS))
        src.connect(filt)
        filt.connect(shaper)
        shaper.connect(ctx.destination)
        return shaper

    label = "zi. MediaElementAudioSourceNode over a 10 s WAV, slice graph"
    with tempfile.TemporaryDirectory() as tmp:
        # zg's source and its first quantum again: the element does not
        # reach the media's end within the render (at the last frame it
        # stops one output frame before a buffer source, whose lerp reads
        # the silence after the end)
        path = os.path.join(tmp, "clip.wav")
        src = zg["source"]
        write_wav(path, np.concatenate([src, src[:, :128]], axis=1), CLIP_FS)
        el = MediaElement(path)
        el.play()
        ctx = wt.OfflineAudioContext(2, frames, FS, device=device)
        node = mn.MediaElementAudioSourceNode(ctx, el)
        slice_graph(ctx, node)
        for k in kernels:
            k.launches = 0
        got = ctx.start_rendering_sync().to_array()
        launches = {k.__name__: k.launches for k in kernels}
        streaming = el.streaming
        el.close()
        media = decode_audio_data(path)
    blocks = -(-frames // ctx._cg.block_frames)
    ref = wt.OfflineAudioContext(2, frames, FS, device=device)
    bsrc = ref.create_buffer_source()
    bsrc.buffer = media
    bsrc.start()
    slice_graph(ref, bsrc)
    err = _check_close(f"{label}: vs the graph fed by the decoded buffer",
                       got, ref.start_rendering_sync().to_array(), 1e-5)
    print(f"{label}: {'streamed from disk by the codec host' if streaming else 'decoded whole (no codec host)'}; "
          f"{blocks} blocks of {ctx._cg.block_frames}, {node.uploads} "
          f"uploads ({node.uploads / blocks:g} a block); launched "
          f"{launches}", flush=True)

    label = "zi. PushStreamTrack -> MediaStreamAudioSourceNode -> gain 1"
    rng = np.random.default_rng(SEED + 41)
    pushed = (0.5 * rng.standard_normal((2, PUSH_BLOCKS * PUSH_FRAMES))) \
        .astype(np.float32)
    track = PushStreamTrack()
    for b in range(PUSH_BLOCKS):
        track.push(wt.AudioBuffer.from_array(
            pushed[:, b * PUSH_FRAMES:(b + 1) * PUSH_FRAMES], FS))
    track.close()
    n = pushed.shape[1] + 4 * PUSH_FRAMES
    pctx = wt.OfflineAudioContext(2, n, FS, device=device)
    psrc = mn.MediaStreamAudioSourceNode(pctx, MediaStream([track]))
    g = pctx.create_gain(gain=1.0)
    psrc.connect(g)
    g.connect(pctx.destination)
    out = pctx.start_rendering_sync().to_array()
    if not np.array_equal(out[:, :pushed.shape[1]], pushed) or \
            out[:, pushed.shape[1]:].any():
        raise AssertionError(f"{label}: the output is not the pushed blocks")
    pblocks = -(-n // pctx._cg.block_frames)
    print(f"{label}: {PUSH_BLOCKS} blocks of {PUSH_FRAMES} frames out "
          f"exactly, then silence; {psrc.uploads} uploads in {pblocks} "
          f"render blocks", flush=True)

    label = ("zi. slice graph -> MediaStreamAudioDestinationNode -> "
             "MediaRecorder")

    def recorded(record=True):
        rctx = wt.OfflineAudioContext(2, frames, FS, device=device)
        src = rctx.create_buffer_source(loop=True)
        src.buffer = zg["flac"]
        src.start()
        shaper = slice_graph(rctx, src)
        dest = mn.MediaStreamAudioDestinationNode(rctx)
        shaper.connect(dest)
        if not record:
            return rctx.start_rendering_sync()
        rec = MediaRecorder(dest.stream)
        blobs = []
        rec.set_ondataavailable(lambda ev: blobs.append(ev.blob))
        rec.start()
        try:
            render = rctx.start_rendering_sync().to_array()
            deadline = time.time() + 60
            while dest._track._queue and time.time() < deadline:
                time.sleep(0.01)
        finally:
            rec.stop()
        return render, (read_wav(blobs[0]) if blobs else (None, None)), \
            dest, rctx

    recorded(record=False)          # warm: the recorder waits 1 s a chunk
    render, (cap, rate), dest, rctx = recorded()
    if cap is None:
        raise AssertionError(f"{label}: the recorder delivered no blob")
    rblocks = -(-frames // rctx._cg.block_frames)
    if rate != FS or not np.array_equal(cap[:, :frames], render):
        raise AssertionError(f"{label}: the capture differs from the render")
    print(f"{label}: the capture (f32 WAV) equals the render bit for bit; "
          f"{dest.host_copies} host copies in {rblocks} blocks "
          f"({dest.host_copies / rblocks:g} a block)", flush=True)
    return {"element_err": err, "uploads_a_block": node.uploads / blocks,
            "host_copies_a_block": dest.host_copies / rblocks,
            "element_streaming": streaming}


def _ptxas_build(cuda_lib, name, source):
    """nvcc `source` with the port's flags and `-Xptxas -v` into the
    git-ignored build directory; returns the loaded library and ptxas's
    lines (each kernel's registers, shared memory and spills)."""
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = cuda_lib.BUILD_DIR / f"report-{name}.so"
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", str(so), str(source)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr[-4000:]}")
    return ctypes.CDLL(str(so)), [
        ln.strip() for ln in proc.stderr.splitlines()
        if "Compiling entry" in ln or "Used" in ln or "spill" in ln]


class _EarlierCurve:
    """A curve_lookup.cu of 75dd7af or before: its entry point
    `curve_lookup_f32(x, curve, y, m, n, half_nm1, row_len, stream)` picks
    its own grid.  Called as the port's `_Kernel` is, for the A/B."""

    def __init__(self, lib, half_nm1):
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
            ctypes.c_float
        self._launch = lib.curve_lookup_f32
        self._launch.argtypes = [p, p, p, ll, i, f, ll, p]
        self._launch.restype = i
        self._half_nm1 = half_nm1

    def __call__(self, out, curve, x, rows, plan):
        n = curve.shape[-1]
        return self._launch(
            x.data_ptr(), curve.data_ptr(), out.data_ptr(), x.numel(), n,
            self._half_nm1(n), x.numel() // rows if curve.dim() == 2 else 0,
            torch.cuda.current_stream(x.device).cuda_stream)


def _bind_curve(ck, lib):
    """An earlier curve_lookup.cu's launcher, told by its C entry point."""
    if hasattr(lib, "curve_lookup_launch"):
        return ck._Kernel(lib)
    return _EarlierCurve(lib, ck._half_nm1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", metavar="SOURCE", action="append", default=[],
                    help="an earlier grain_read.cu, curve_lookup.cu or "
                    "detector.cu (told apart by their C entry points) to "
                    "time against this one; may be given once for each")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    import webaudio_tpu_torch as wt
    from webaudio_tpu_torch.graph import compiler
    from webaudio_tpu_torch.ops import cuda_lib
    from webaudio_tpu_torch.ops import curve_kernel as ck
    from webaudio_tpu_torch.ops import dither
    from webaudio_tpu_torch.graph import fusion
    from webaudio_tpu_torch.ops import grain_read as gr
    from webaudio_tpu_torch.ops import detector as det
    from webaudio_tpu_torch.ops import resample as rs
    from webaudio_tpu_torch.nodes import dynamics_compressor as dc
    from webaudio_tpu_torch.nodes import waveshaper

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    sources = sorted(p.name for p in cuda_lib.CSRC_DIR.glob("*.cu"))
    olds = [(f"old-{i}", src) for i, src in enumerate(args.old)]
    with ThreadPoolExecutor(len(sources) + len(olds)) as pool:
        built = [pool.submit(cuda_lib.load_library, x) for x in sources]
        reported = [pool.submit(_ptxas_build, cuda_lib, *r) for r in olds]
        for f in built:                 # one nvcc per source, all at once
            f.result()
        reported = [f.result() for f in reported]
    # each earlier source, told apart by its C entry points, and with it
    # this checkout's source of the same kernels (also with -Xptxas -v)
    old = {}
    for (_, source), (lib, lines) in zip(olds, reported):
        kind = ("grain" if hasattr(lib, "grain_bank_f32") else "curve"
                if hasattr(lib, "curve_lookup_f32")
                or hasattr(lib, "curve_lookup_launch") else "detector"
                if hasattr(lib, "detector_seq_launch") else None)
        if kind is None or kind in old:
            raise SystemExit(f"chip_smoke: --old {source} is none of "
                             "grain_read.cu, curve_lookup.cu and detector.cu, "
                             "or repeats one")
        old[kind] = {"grain": gr._bind, "curve": lambda lb: _bind_curve(ck, lb),
                     "detector": _bind_detector}[kind](lib)
        new = cuda_lib.CSRC_DIR / {"grain": "grain_read.cu",
                                   "curve": "curve_lookup.cu",
                                   "detector": "detector.cu"}[kind]
        _, new_lines = _ptxas_build(cuda_lib, f"new-{kind}", new)
        for name, src, lns in (("old", source, lines), ("new", new, new_lines)):
            print(f"build ({name}: {src}, -Xptxas -v):", flush=True)
            for ln in lns:
                print(f"  {ln}", flush=True)
    ck._kernel()
    dither._launchers()
    gr._launchers()
    det._launcher()
    print(f"build: {', '.join(sources)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    max_err = phase_a(ck, wt.KernelError)
    offline_launches, s1 = phase_b(wt, ck)
    phase_c(wt)
    phase_d(wt)
    k1_lib_ms, k1_lib_err = phase_e(wt, ck, compiler)
    q_err = phase_f(dither, wt.KernelError)

    # the batch path, g-i: every count from 0
    kernels = (ck.curve_lookup, dither.dither_i16, dither.ulaw_u8)
    for k in kernels:
        k.launches = 0
    gb, filt, rows = phase_g(wt)
    phase_h(gb, filt, rows, dither)
    launches, s4 = phase_i(wt, kernels)
    times = phase_j(wt, gb, filt, dither)
    # K1's device timings, after the batch path's own (phase j runs as it
    # did before they existed)
    k1 = curve_times(ck, s1, s4, old.get("curve"))
    del gb, s1, s4
    torch.cuda.empty_cache()

    # granular synthesis, k-n
    grain_err = phase_k(wt, gr, fusion, wt.KernelError)
    l400 = phase_l(wt, gr, compiler, fusion, 400)
    l800 = phase_l(wt, gr, compiler, fusion, 800, phase="m")
    grain_times = phase_m(wt, gr, compiler, fusion, (l400, l800),
                          old.get("grain"))
    phase_n(wt, gr)

    # oscillators and voice banks, o-r: each main path counts every
    # kernel's launches from 0
    every = (ck.curve_lookup, dither.dither_i16, dither.ulaw_u8,
             gr.grain_bank, gr.grouped_lerp)
    phase_o(wt, compiler, every)
    phase_p(wt, compiler, every)
    voice_launches, s7, s7_err = phase_q(wt, compiler, fusion, ck, every)
    k1["S7"] = phase_r(wt, compiler, fusion, ck, s7)

    # the mastering chain, s-v: each main path counts every kernel's
    # launches from 0
    det_err = phase_s(det, rs, wt.KernelError)
    master = (ck.curve_lookup, dither.dither_i16, det.detector_scan)
    t5a = phase_t(wt, compiler, ck, det, dc, waveshaper, master)
    u5b = phase_u(wt, compiler, dither, dc, master)
    v = phase_v(ck, det, dc, rs, cuda_lib, t5a, u5b, old.get("detector"))
    k1.update({k: v[k] for k in ("S8", "S8 n 44100")})
    del t5a["s8"], t5a["detector_row"], u5b["detector_rows"]
    torch.cuda.empty_cache()

    # config 3, w-y: delay, feedback cycles, the convolver, the IIR
    # filter; each main path counts every kernel's launches from 0
    every = every + (det.detector_scan,)
    phase_w(wt, compiler, every)
    phase_x(wt, compiler, every)
    y = phase_y(wt, compiler, dither, every)

    # spatial audio, z-zb: config 4, the Doppler graph with and without
    # the automated-rate playhead, the binaural corpus; each main path
    # counts every kernel's launches from 0
    phase_z(wt, compiler, every)
    phase_za(wt, compiler, every)
    zb = phase_zb(wt, compiler, dither, every)

    # sessions, segments, futures and user code, zc-zf: each main path counts
    # every kernel's launches from 0
    zc = phase_zc(wt, ck, gr, dither, fusion, every)
    zd = phase_zd(wt, compiler, ck, every)
    phase_ze(wt, every)
    phase_zf(wt, every)

    # the real-time context and media I/O, zg-zi: the online path counts
    # K1's and the detector's launches from 0 in each run
    zg = phase_zg(wt)
    zh = phase_zh(wt, zg, (ck.curve_lookup, det.detector_scan))
    phase_zi(wt, zg, every)

    n_q = QUANT_SHAPE[0] * QUANT_SHAPE[1]
    k5_bound = _bound(n_q * 6, 25 * n_q)
    k6_bound = _bound(n_q * 5, 50 * n_q)
    k2, k3, k4 = (grain_times[k] for k in ("grain_bank", "grouped_lerp",
                                           "window"))

    def grain(t, extra):
        """A grain kernel's timing keys, the 800-grain ones (where timed)
        ending in _800_grains."""
        d = dict(extra)
        d.update({k.replace("_800", "_800_grains"): v for k, v in t.items()
                  if not k.startswith("library")})
        return d

    rows = [
        {"name": "curve_lookup", "route": "cuda",
         "source": "webaudio_tpu_torch/csrc/curve_lookup.cu",
         "replaces": "webaudio_tpu/ops/curve_kernel.py:164",
         "also_replaces": ["webaudio_tpu/ops/curve_kernel.py:268",
                           "webaudio_tpu/ops/curve_kernel.py:224"],
         "launches": launches["curve_lookup"],
         "launches_offline_path": offline_launches,
         "launches_voice_path": voice_launches,
         "launches_mastering_path": t5a["launches"]["curve_lookup"],
         "launches_corpus_path": u5b["launches"]["curve_lookup"],
         "launches_session_path": zc["slice"]["launches"]["curve_lookup"],
         "launches_segments_path": zd["launches"]["curve_lookup"],
         "launches_online_path": zh["1024"]["launches"]["curve_lookup"],
         "launches_online_16384":
             zh["16384"]["launches"]["curve_lookup"],
         "online_chunks": zh["1024"]["chunks"],
         "max_abs_err": max(max_err, s7_err, zc["k1_err"]),
         **{k: v for k, v in k1["S1"].items() if k != "plan"},
         "library_ms": k1_lib_ms, "library_max_abs_err": k1_lib_err,
         "floor_ms": k1["floor_ms"],
         "shapes": {s: k1[s] for s in ("S1", "S1 random", "S1 copies", "S2",
                                       "S3", "S4", "S5", "S6", "S7", "S8",
                                       "S8 n 44100")}},
        {"name": "dither_i16", "route": "cuda",
         "source": "webaudio_tpu_torch/csrc/quantize.cu",
         "replaces": "webaudio_tpu/ops/dither.py:37",
         "launches": launches["dither_i16"],
         "launches_corpus_path": u5b["launches"]["dither_i16"],
         "launches_reverb_corpus_path": y["launches"]["dither_i16"],
         "launches_binaural_corpus_path": zb["launches"]["dither_i16"],
         "launches_session_path": zc["k5_launches"],
         "max_abs_err": q_err[0],
         "ms": times["dither_i16"][0], "plain_ms": times["dither_i16"][1],
         "cold_ms": times["dither_i16"][2],
         "share_of_bound": k5_bound[0] / times["dither_i16"][2],
         "bound_ms": k5_bound[0], "bound_by": k5_bound[1],
         "library_ms": None},
        {"name": "ulaw_u8", "route": "cuda",
         "source": "webaudio_tpu_torch/csrc/quantize.cu",
         "replaces": "webaudio_tpu/ops/dither.py:113",
         "launches": launches["ulaw_u8"], "max_abs_err": q_err[1],
         "ms": times["ulaw_u8"][0], "plain_ms": times["ulaw_u8"][1],
         "cold_ms": times["ulaw_u8"][2],
         "share_of_bound": k6_bound[0] / times["ulaw_u8"][2],
         "bound_ms": k6_bound[0], "bound_by": k6_bound[1],
         "library_ms": None},
        {"name": "grain_bank", "route": "cuda",
         "source": "webaudio_tpu_torch/csrc/grain_read.cu",
         "replaces": "webaudio_tpu/ops/grain_read.py:634",
         "launches": l400["launches"]["grain_bank"],
         "launches_800_grains": l800["launches"]["grain_bank"],
         "launches_128_frame_session": zc["grain"]["launches"]["grain_bank"],
         "max_abs_err": max(grain_err["grain_bank"],
                            zc["grain_err"].get("grain_bank", 0.0)),
         **grain(k2, {"library_ms": None})},
        {"name": "grouped_lerp", "route": "cuda",
         "source": "webaudio_tpu_torch/csrc/grain_read.cu",
         "replaces": "webaudio_tpu/ops/grain_read.py:453",
         "also_replaces": ["webaudio_tpu/ops/grain_read.py:297"],
         "launches": l400["launches"]["grouped_lerp"],
         "launches_800_grains": l800["launches"]["grouped_lerp"],
         "launches_128_frame_session":
             zc["grain"]["launches"]["grouped_lerp"],
         "max_abs_err": max(grain_err["grouped_lerp"],
                            zc["grain_err"].get("grouped_lerp", 0.0)),
         **grain(k3, {"library_ms": k3["library_ms"],
                      "library_max_abs_err": k3["library_err"]})},
        {"name": "grouped_lerp (window geometry)", "route": "cuda",
         "source": "webaudio_tpu_torch/csrc/grain_read.cu",
         "replaces": "webaudio_tpu/ops/grain_read.py:62",
         "launches": l400["launches"]["window"],
         "launches_800_grains": l800["launches"]["window"],
         "max_abs_err": grain_err["grouped_lerp"],
         **grain(k4, {"library_ms": k4["library_ms"],
                      "library_max_abs_err": k4["library_err"]})},
        {"name": "detector_scan", "route": "cuda",
         "source": "webaudio_tpu_torch/csrc/detector.cu",
         "replaces": "webaudio_tpu/nodes/dynamics_compressor.py:28",
         "launches": t5a["launches"]["detector_scan"],
         "launches_default_5a": t5a["launches"]["detector_scan"],
         "launches_default_5b": u5b["launches"]["detector_scan"],
         "launches_chunked_5a": t5a["chunked_launches"]["detector_scan"],
         "launches_online_path":
             zh["1024"]["launches"]["detector_scan"],
         "launches_online_16384": zh["16384"]["launches"]["detector_scan"],
         "online_chunks": zh["1024"]["chunks"],
         "max_abs_err": max(det_err, t5a["detector_err"]),
         "ms": v["detector 5a"]["ms"],
         "plain_ms": t5a["detector_plain_ms"], "plain_on": "host cpu",
         "bound_ms": v["detector 5a"]["bound_ms"],
         "bound_by": v["detector 5a"]["bound_by"],
         "latency_bound_ms": v["detector 5a"]["latency_bound_ms"],
         "latency_bound_ms_4_ops": v["detector 5a"]["latency_bound_ms_4_ops"],
         "step_bound_ms": v["detector 5a"]["step_bound_ms"],
         "chain_cycles": v["chain_cycles"],
         "chunked_ms": v["detector 5a"]["chunked_ms"],
         "at_5b": v["detector 5b"],
         "sweep": {k[len("detector "):]: v[k] for k in v
                   if k.startswith("detector ") and k[9:] not in ("5a", "5b")},
         "library_ms": None},
    ]
    for row in rows:
        row.setdefault("share_of_bound", row["bound_ms"] / row["ms"])
    print(json.dumps({"kernels": rows}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
