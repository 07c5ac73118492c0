#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (gnuradio4_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero and prints no
result line:

1. device: the card's name, and ``nvidia-smi``'s name and power limit;
2. build: compile the hand-written kernels from ``gnuradio4_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version, on the card, at the headline
   chain's shapes (T = 2^23), a ragged length and multi-channel input, and at
   the shapes the kernels once refused (``fir_banded`` and ``fir_demod`` at
   decim 1024 and 2048, K 16384 complex taps against a float64 FIR, 65539
   channels; ``iir_sos`` with 17 and 33 sections, two calls with the state
   carried against one, a narrow-band design against float64); device times
   by CUDA events over calls queued behind a spin kernel, and for each timed
   ``fir_banded``, ``fir_demod`` and ``iir_sos`` shape its bound (bytes over
   the HBM rate or FLOPs over the FP32 peak) and the share of it reached,
   with ``F.conv1d``'s time (cuDNN TF32 off) as the FIR's yardstick and the
   unfused ``fir_banded`` → ``quadrature_demod`` as the fused kernel's;
4. the headline chain (ComplexToneSource → FreqXlatingFir(127) → {FFT(4096) ;
   QuadratureDemod → FirFilter(63, ÷8)}) through ``Graph`` → ``Scheduler`` at
   block_len 2^23 for 4 steps with rotation absorption (the default): tone peak
   and demod constant checked, kernel launches counted, Msps timed;
5. the same chain with absorption off (GR4TPU_NO_ROTATION_ABSORB=1), which runs
   the NCO mixer kernel; its sinks must match phase 4;
6. the chain at block_len 2^16 on the CPU (plain versions) against the card;
7. Path A, suite config 3: ComplexToneSource(10 kHz) → WbfmReceiver (nested
   graph: FreqXlatingFir(127) → QuadratureDemod → FirFilter(127, ÷5) →
   FmDeemphasis) at quad rate 250 kHz, block_len 2^22 (rounded to a multiple
   of 5), 4 steps: two banded-FIR launches per step, the audio settles to the
   tone's constant 10/75, Msps timed; CPU against the card at block_len 5·8192
   (blocked one-pole de-emphasis) and 5·8191 (its O(log T) scan);
8. Path B: SignalGenerator(Sin 1 kHz, 16 channels) → IirFilter(Butterworth 5,
   15 kHz, engine auto) at 48 kHz, block_len 2^20, 3 steps: the biquad
   cascade's three launches per step, the sink against scipy's float64
   sosfilt, ms/step and the device-busy share timed; the order-4 design
   takes the parallel engine (no launch), timed against the ``pallas``
   engine (the kernel) in turns; CPU against the card at block_len 2^12;
9. the fused FIR→demod entry point ``fir_quad_demod_fused`` streamed over 4
   chunks of 2^22 samples of Path A's input with Path A's channel taps: one
   launch per chunk, the demod constant checked;
10. the full scheduler on the chain (absorbed and derotated, block_len 2^23)
    and Path A (2^22): ``pipeline_depth=2, async_delivery=True``, then
    ``batch_steps=4``, each bitwise equal to the synchronous unbatched run
    (``pipeline_depth=1``) with the same kernel launches per logical step;
    Msps over 5 windows by CUDA events per setting, host ms per step from the
    scheduler's profiler spans;
11. Path C, suite config 5 (``bench_suite.py:205-253``): a tagged complex
    noise source (threefry, a ``trigger_time`` tag every 2^20 samples) →
    PFBChannelizer(256 channels, 8 taps per phase) → QuadratureDemod → sink,
    block_len 2^21, ``pipeline_depth=2, async_delivery=True, batch_steps=8``:
    the threefry bits equal on the card and the CPU, 64 tags at output
    indices i·4096 over 4 super-steps, the card against the CPU at block_len
    2^16, Msps, host share, per-op device times and peak memory;
12. Path D, suite config 6 (``bench_suite.py:256-279``): CountingSource → 20 ×
    (MultiplyConst(2) → DivideConst(2)) → CountingSink at block_len 2^16: the
    count and the data checked, host ms per step over 200 steps, sync and
    async;
13. suite config 1 (``bench_suite.py:103-118``): ComplexToneSource(1 MHz) →
    FirFilter(127) → FFT(4096, Hann, magnitude) → NullSink at 20 MHz,
    compiled at block_len 2^22: one ``fir_banded`` launch (c64 data, f32
    taps) per step, the tone's bin checked;
14. suite config 2 (``:121-131``): NoiseSource → RationalResampler(3, 2) →
    NullSink at 2^22, and both resampler forms timed at that shape (the
    choice behind ``auto`` on CUDA in ``ops/resample.py``);
15. suite config 4 (``:151-162``): complex NoiseSource → PFBChannelizer(64,
    8) → Abs → NullSink at 2^22;
16. suite config 7 (``:282-315``): a device-resident VectorSource of encoded
    BPSK LLRs (seed 0, σ 0.6) → LdpcDecoder(256, 128) → NullSink under
    ``Scheduler(pipeline_depth=2, async_delivery=True)`` at 2^17: the first
    64 frames' bits equal ``decode_np``'s;
17. suite config 7k (``:318-332``): NoiseSource(gaussian) → LdpcDecoder →
    NullSink compiled at 2^19, both decoder forms timed at 2048 frames (the
    choice behind ``ops/ldpc.py``'s ``decode`` on CUDA), and both run twice on
    4 dB codewords: hard bits and flags equal run to run and to the CPU's;
18. a Rotator from a phase just below 2^32: one ``nco_mix`` launch per step,
    the card's output and end phase against the CPU's;
19. ``fir_apply``'s methods on a CUDA tensor: ``pallas`` and ``pallas_ilv``
    launch ``fir_banded`` for a complex stream, ``pallas`` for a real one;
    every method against ``matmul``, each timed, ``conv`` under PyTorch's
    default cuDNN flags;
20. the IFFT's engines (cuFFT against the float32 matmul FFT) at fft_size
    1024, 4096 and 16384 over 2^22 samples (the choice behind the IFFT's
    ``auto`` on CUDA in ``blocks/fourier.py``), and the FFT's
    ``matmul_exact`` at 4096.

21. the YAML entry point (``core/yaml_io``, the port's own YAML reader: the
    script makes PyYAML unimportable before it imports the port): (a) the
    chain through ``load_grc(save_grc(...))`` at 2^23, absorbed and
    derotated, bitwise equal to phases 4 and 5 with their launches, and
    timed; (b) ``python -m gnuradio4_tpu_torch run`` on
    ``examples/fm_receiver.yaml`` as written (16 steps of 24000) and at
    ``--block-len 5242880 --steps 4``, and ``blocks``; (c) ``run_grc`` of
    that flow on a loopback FM station (1 kHz at 100 MHz) at 5242880: the
    audio's strongest bin at 1 kHz, ``fir_banded`` counted, the card against
    the CPU at 24000; (d) ``examples/channelizer.yaml`` with a
    ``StreamingPoller``, card against CPU; (e) a checkpoint of the chain at
    2^23 after 2 steps, resumed on the card, bitwise equal to steps 3–4;
    (f) ``GraphGRC`` Get and Set (suite config 1) on a running scheduler.

22. feedback loops, the Agc block and the precision ladder: (a) ``python -m
    gnuradio4_tpu_torch run examples/agc_loop.yaml`` on the card; (b) the
    same flow through ``Scheduler`` (delay 1: 4096 sub-steps per step) on
    the card against the CPU and against the ``Agc`` block on the card, the
    output's mean magnitude 0.8–1.2, and the expression evaluator's host
    scalars beside CUDA tensors against the CPU; (c) the loop at delay 64;
    sub-steps, torch ops and kernel launches (torch.profiler) and ms per
    step of each, and of ``Agc``; (d) FirFilter at every precision rung at
    config 1's shape (c64 × f32 K 127, 2^22) and at the chain's audio FIR
    (f32 K 63 ÷8, 2^23): each rung's SNR against a float64 FIR, held to the
    JAX package's contracts (``high`` ≥ 90 dB, ``bf16``/``default`` > 45;
    ``int8`` > 40 real and > 38 complex on white taps, the contract's data,
    and on the designed taps equal to the CPU's integer result), with its ms
    beside ``highest``'s matmul and the ``fir_banded`` kernel; (e) the FFT's
    matmul engines at
    4096 over 2^22 samples: SNR against a float64 FFT and ms beside cuFFT.

23. the coded link and the digital-modem layer: (a)
    ``examples/coded_link.yaml`` as written by ``run_grc`` on the card and
    on the CPU (tx == rx over 8192 bits, the card's bits equal the CPU's)
    and by the CLI on the card; (b) the same flow at n_bits 0 for 8 steps
    of 2^16 bits (2^17 LLRs per step at the decoder, config 7's size): the
    raw BER at the channel's output against Q(1/0.42), the decoded BER
    ≤ 1e-4, ms and host ms per step, launches per step and the device-busy
    share; (c) the JAX package's own scenarios at their test sizes (the
    clean and noisy QPSK links with ``BerSink``, RRC + ``MMSymbolSync``
    with ``fir_banded`` counted, ``PfbClockSync``, 16 framed packets, OFDM
    through AWGN, Schmidl & Cox timing and CFO, ``CmaEqualizer``, the
    ``ChannelModel`` statistics), each asserting what its reference test
    asserts, and each scan block's launches, torch ops and ms per step; (d)
    ``fir_banded`` at ``RrcFilter``'s shapes (c64 × f32 ÷1: the RRC +
    ``MMSymbolSync`` scenario's K 45 at 4096, the default K 65 at 4096 and
    2^22) against its plain version, its bound and ``F.conv1d``.

24. carrier and timing recovery, the RDS receiver and the terminal spectrum
    analyzer: (a) ``examples/rds_receiver.yaml`` by ``run_grc`` for the 60
    steps of ``tests/test_rds.py:98-112`` (PI, PS, radiotext, > 100 groups;
    one ``nco_mix`` and one ``fir_banded`` launch per step), and the card's
    ``CostasLoop`` against the port on the CPU over 3 steps of the card's
    own filter output; (b) the FM stereo + RDS capstone of
    ``tests/test_acceptance.py:74-131`` at its sizes (separation > 40 dB,
    PI, PS, ≥ 12 groups), then ms and host ms per step, kernel launches and
    torch ops per step and the device-busy share; (c)
    ``examples/spectrum_analyzer.yaml`` for 20 steps (renders, the 100 and
    230 kHz peaks 12.04 dB apart) and ``run ... --draw`` by the CLI; (d) each
    new device block's launches, torch ops and ms per step at its JAX test's
    size; (e) ``nco_mix`` and ``fir_banded`` at the RDS channel filter's
    shapes (c64 T 65568 and 24000, 241 f32 taps ÷24) against their plain
    versions, with bound and ``F.conv1d``.

25. trigger-driven acquisition: (a) qa_TriggerBlocks' timeline
    (tests/test_trigger_blocks_golden.py) at 41.94 MS/s, 20 steps of 2^22
    (two 1 s cycles): ClockSource → FunctionGenerator(clk_in) →
    SavitzkyGolayFilter(31, 3) → SchmittTrigger (edge tags) →
    {StreamToDataSet ; TriggerGate → DataSink}: the edges at 0.25 and 0.65 s
    of each cycle (least-squares interpolation), two DataSets of 0.4 s, the
    gate's ten windows, one ``fir_banded`` launch a step (before it, the qa's
    own 1 kHz timeline with each interpolation, the card's edges equal to
    the CPU's); the same chain timed (Msps, ms and host ms
    per step, the delivery's share, launches and torch ops per step, the
    device-busy share); and at 655 360 S/s on the card against the CPU; (b)
    each other new block at its JAX test's step, card against CPU, and its
    launches, torch ops and ms per step; (c) SvdDenoiser's two engines at 2^20
    samples a step; (d) ``fir_banded`` against its plain version at every
    shape (a) and (b) launched it with, with bound and ``F.conv1d``.

26. the convolutional-FEC layer and the five remaining example flows: (a)
    ``examples/lora_link.yaml``, ``wifi_link.yaml``, ``ble_scanner.yaml``,
    ``ais_receiver.yaml`` and ``rtty_teletype.yaml`` by ``run_grc`` at their
    ``meta:`` block_len and sample_rate, on the card and on the CPU: each
    decoder's result as ``tests/test_examples.py`` asserts it, the card's
    equal to the CPU's (floats within ``FLOW_RTOL``); ms per step by CUDA
    events over the run, host ms per step from the profiler's spans, kernel
    launches and torch ops per step (torch.profiler); (b) ConvEncoder →
    ViterbiDecoder on 32 768 random bits in steps of 4096 coded bits, clean
    (exact after the traceback) and at 5% flips (residual < 1%), and soft
    decisions: the card's bits equal the CPU's; (c) Scrambler → Descrambler,
    Golay and Hamming with injected flips, CssDemod at SF 7–9 in noise: the
    card equal to the CPU and to what was sent; each new device block's
    launches, torch ops and ms per step at 4096 samples.

27. GNSS acquisition and tracking, the CCSDS link, polar codes, the six host
    receivers and CVSD: (a) the GPS L1 C/A cold-start sky search at
    GnssAcquisition's widths (PRNs 1–32, ±5 kHz in 250 Hz bins, 2 blocks of
    1 ms) on six satellites at σ 2.0 through VectorSource → GnssAcquisition
    (block_len 2046), card and CPU: exactly those six, each code phase
    exact and Doppler within one bin, the card equal to the CPU;
    ``acquire_all`` (the [32, 41, 2, 2046] batch) and the search program
    alone timed with their bound, and the sink's 32 sequential ``acquire``
    calls; (b) the six with 50 bps nav bits over 300 ms through
    ``track_channels``: every channel's bits as tests/test_gnss.py's cycle
    rule wants, the card's bits equal to the CPU's, ms and launches per
    1 ms block; (c) the CCSDS concatenated link of tests/test_ccsds.py at
    interleave 4 (frames == [payload], card equal to the CPU), and RsEncoder
    → 8 codewords with 16 byte errors and one with 17 → RsDecoder (128
    corrected, 1 failed), with the host ms of the codec and the ms of its
    step; (d) polar N 256, K 128 at σ 0.65 on 64 frames: PolarEncoder on the
    card equal to ``polar_encode``, the decoded bits equal to the sent ones,
    ms per step and the SC walk's host ms; (e) the six host receivers
    (802.15.4, ADS-B, POCSAG, APT, DCF77, WEFAX) through their JAX tests'
    graphs, rates and block lengths on the card and the CPU, each asserting
    what its JAX test asserts: ms per step against the signal a step
    carries, host ms, launches; (f) CVSD at 16 kS/s, 4 steps of 4096 samples
    of band-limited noise: SNR > 10 dB, the card's bits equal to the CPU's,
    the audio within 1e-6; launches a sample and ms per step against the
    256 ms of audio a step carries. No hand kernel lies on these paths.

28. the rest of the host core: (a) the headline chain across two graphs
    under one ``Runtime`` at block_len 2^23: ``acq`` (ComplexToneSource(1
    MHz) → PipeSink, 4 steps) piped into ``dsp`` (StreamSource(complex64,
    capacity 2^24) → the chain's blocks): the sinks bitwise equal to phase
    4's, and with GR4TPU_NO_ROTATION_ABSORB=1 to phase 5's, with their
    ``fir_banded`` and ``nco_mix`` launches a dsp step; then 16 steps with
    NullSinks under ``Profiler("chip_smoke")`` with instant and counter marks
    (the ring's fill): the dsp graph's Msps against phase 4's, host ms a step
    of ``PipeSink.consume`` and ``StreamSource.host_feed`` from the spans, the
    chrome trace read back; and each wait strategy (spin, yield, sleep,
    block) for 2 steps, the sinks equal to phase 4's; (b) ComplexToneSource →
    ``ScheduledSubgraph``(FreqXlatingFir(127) → QuadratureDemod) → VectorSink
    at 2^22 × 4: lossless and bitwise equal to the same blocks run flat,
    ``fir_banded`` launched by the inner scheduler, the warm-up steps and ms
    per step; (c) ``HostBlock``, ``PythonBlock`` (host and jax modes) and
    ``LambdaBlock`` clipping an FM tone's demod output at 2^22: bitwise
    equal, an int16 ``HostBlock`` with ``out_shape_fn``, card vs CPU at
    2^16, each form's ms a step; (d) the chain with a ``domain="host"`` tap on
    the FIR and a ``gpu:cuda:0`` FIR → FFT edge through
    ``save_grc``/``load_grc``: the tap equal to a flat run's FIR output, a
    ``tpu`` edge refused; (e) ``merge(MultiplyConst(2), AddConst(1),
    Decimator(2))`` at 2^22 against the unmerged chain, ``GpsSource`` on a
    ``ReplayNmeaDevice`` and ``PpsSource`` card vs CPU; (f)
    ``Profiler.device_trace`` over one chain step: its kernels include
    ``fir_banded``.

29. the IO entry points, each reading with the wire it crossed: (a) an
    RTL-SDR FM receiver through the RTL2832U + R820T protocol driver:
    ``SdrSource(driver="rtlsdr")`` over ``FakeRtlUsb`` (a seeded FM station
    100 kHz above the tuning, u8 IQ at 2.4 MS/s, converted by the native
    ``u8iq_to_c64``) → ``make_wbfm_receiver`` (channel FIR 127, demod, audio
    FIR 127 ÷50, de-emphasis) → ``AudioSink(backend="file")`` at 48 kHz,
    block 2^18 (rounded to a multiple of 50), 2 + 8 steps: the 2 kHz tone,
    the WAV's frames, ms a step, the host feed split into the driver's bulk
    read and the conversion, the real-time factor, launches a step, the card
    against the CPU; ``fir_banded`` at the receiver's two shapes; (b) phase
    4's input recorded through ``SigmfSink`` as ``cf32_le`` and ``ci16_le``
    and replayed through ``SigmfSource`` into the chain: ``cf32_le`` bitwise
    equal to phase 4's sinks, ``ci16_le`` within the quantisation error the
    phase states; Msps, the source's host ms and the conversion's ms; (c)
    two graphs joined by TCP on localhost under a ``Runtime``
    (ComplexToneSource → FreqXlatingFir(127) → TcpSink ⇒ TcpSource →
    QuadratureDemod → FirFilter(63, ÷8)) at 2^22 complex64, bitwise equal to
    the chain in one graph, Msps and host ms of each side; UDP at a small
    size; (d) phase 28a's timed piped chain, which crosses the native ring,
    read beside PR 16's over the NumPy ring (no second run); (e)
    the 14 new registry names (the ZeroMQ four exactly when pyzmq imports)
    and ``SdrSource(driver="soapy")`` on a fake libSoapySDR built from
    ``tests/fake_soapy.cpp``. Every ring of the phase is native.

30. the time-sharded mesh on the card (``parallel/``, ``Scheduler(mesh=)``):
    (a) the chain at 2^23 under ``make_mesh((8,), ("sp",), devices=[cuda] *
    8)``, absorbed and derotated, against phases 4 and 5 (``compare_sinks``'
    bounds), 8 ``fir_banded`` a FIR a step and 8 ``nco_mix`` a step
    derotated, the tone source and a Rotator from 2^32 − 12345 bitwise equal
    to unsharded, and the NullSink chain unsharded and sharded in turns:
    Msps, host ms, kernels and torch ops a step, device-busy ms; (b)
    ``dryrun_multichip(8)`` on the card (the three topologies of
    ``__graft_entry__.dryrun_multichip``); (c) ``build_sharded_rx`` at
    BASELINE config 4's widths, batch 2, 2^22 a stream, over (dp 2, sp 4)
    against (1, 1) on the card and against the CPU at 2^14, ms a step and a
    profiled step; (d) ``acquire_all`` over a 4-shard mesh against phase
    27's search; (e) a three-stage ``StagePipeline.from_graph`` (FreqXlatingFir
    | QuadratureDemod | FirFilter ÷8, derotated) bitwise equal to the fused
    graph.
31. the chain at 2^23 across two processes sharing the card
    (``parallel/multihost.py``): this file run twice with
    ``--multihost-worker`` on a free local port, each process
    ``init_distributed`` (the backend chosen from the devices and printed:
    Gloo with host staging, as the two share ``cuda:0``) and
    ``global_mesh(("sp",), [cuda] * 4)``; the derotated chain for 4 steps
    with every launch counted (8 ``fir_banded`` and 4 ``nco_mix`` a step a
    process) and each kernel held against its plain version on the run's
    inputs; each process's sink slices against phase 30's 8-shard chain
    (bitwise expected, bound ``MESH_ATOL``) and phase 5's (``compare_sinks``);
    the NullSink chain's ms and host ms a step, the transport's ms, bytes
    and calls a step and each process's peak device memory
    (``MemoryMonitor``), beside phase 30's 8-shard chain run before and
    after. A worker that fails, disagrees or outlives ``MH_DEADLINE`` fails
    the phase.

Phases 13–17 each print the card against the CPU on a short run of the same
graph, Msps (coded Mbit/s for 7 and 7k), ms per step by CUDA events over 5
windows, host ms per step, the device-busy share of one profiled step, peak
device memory and the hand kernels' launches.

Each path's kernel launches are counted from zero just before it runs and read
just after. The last lines are the card's name and power limit, a JSON object
of per-path timings, a JSON object of per-kernel results (launches, error,
kernel, plain, bound and library ms at the main path's shape) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

# a hidden PyYAML dependency fails here as on a machine without PyYAML: the
# port reads and writes YAML itself
sys.modules["yaml"] = None

ROOT = Path(__file__).resolve().parent

FS = 20e6
BLOCK_LEN = 1 << 23
STEPS = 4
CPU_BLOCK_LEN = 1 << 16
CPU_STEPS = 3
SEED = 20261016
# f32 accumulation over ≤127 taps of unit-variance samples: |Δ| ~ 1e-5
FIR_ATOL = 2e-4
# per-sample sincosf vs torch sin/cos, |x| ≲ 5
NCO_ATOL = 1e-5
# spectra: relative to the peak bin (f32 FFT of 4096 points)
SPEC_RTOL = 1e-5
AUDIO_ATOL = 1e-4
# Path A (suite config 3)
QUAD_RATE = 250e3
WBFM_BLOCK_LEN = 1 << 22
WBFM_IN_LEN = 5 * round(WBFM_BLOCK_LEN / 5)   # the rate algebra's rounding
WBFM_STEPS = 4
WBFM_CPU_BLOCK_LENS = (5 * 8192, 5 * 8191)
WBFM_GAIN = QUAD_RATE / (2 * 3.141592653589793 * 75e3)
WBFM_CONST = 10e3 / 75e3          # demod of a 10 kHz tone at 75 kHz deviation
# audio after the filters' transient (FIR 126 + 126/5 samples, de-emphasis
# time constant 3.75 samples): f32 sums and the one-pole scan, |audio| ≈ 0.13
WBFM_ATOL = 1e-5
WBFM_SKIP = 1000
# Path B (IirFilter)
IIR_FS = 48e3
IIR_BLOCK_LEN = 1 << 20
IIR_STEPS = 3
IIR_CHANNELS = 16
IIR_CPU_BLOCK_LEN = 1 << 12
# f32 biquads against each other: max|Δ| relative to the output RMS (FMA
# contraction and summation order differ; ~4e-7 measured on the CPU)
IIR_RTOL = 1e-5
# f32 against scipy's float64 sosfilt, relative to the RMS; the f32 error of a
# stable low-pass settles (~5e-7 measured on the CPU at T = 2^12..2^16)
SCIPY_RTOL = 2e-5
# fused FIR→demod against FIR then demod: rad·gain, differences wrapped into
# (−π, π] (tests/test_pallas_kernels.py:128 uses the same 2e-3)
DEMOD_ATOL = 2e-3
# Path C (suite config 5)
C5_FS = 1e9
C5_BLOCK_LEN = 1 << 21
C5_BATCH = 8
C5_TAG_PERIOD = 1 << 20
C5_CHANNELS = 256
C5_CPU_BLOCK_LEN = 1 << 16
# normal draws: torch's erfinv against XLA's float32 polynomial, |Δ| ≤ 6e-6 of
# max(1, |x|) measured on the CPU; the card's erfinv is a third implementation
NOISE_RTOL = 2e-5
# config 5 on the card against the CPU: the demod's angle, rad, after f32 PFB
# sums and two FFT implementations (5.5e-5 measured against the JAX package)
C5_ATOL = 1e-3
# Path D (suite config 6)
C6_BLOCK_LEN = 1 << 16
C6_STEPS = 200
# suite configs 1, 2, 4, 7 and 7k (bench_suite.py:103-162, 282-332)
C1_FS = 20e6
SUITE_FS = {"1": C1_FS, "2": 1e6, "4": 1e9, "7k": 1e9}
SUITE_BLOCK_LEN = 1 << 22          # configs 1, 2 and 4 on an accelerator
C7_BLOCK_LEN = 1 << 17
C7K_BLOCK_LEN = 1 << 19
C7_SIGMA = 0.6
C7_CHECK_FRAMES = 64
SUITE_CPU_BLOCK_LEN = 1 << 14
C7_CPU_BLOCK_LEN = 1 << 12
# Eb/N0 4 dB at rate 1/2: σ² = 1 / (2 · 10^0.4 · 0.5)
SIGMA_4DB = (1.0 / 10 ** 0.4) ** 0.5
# the resampled and channelized noise, card against CPU, relative to the
# output RMS: the draws agree to 3.2e-7 (phase 11's check), then f32 sums
SUITE_RTOL = 1e-4
ROTATOR_BLOCK_LEN = 1 << 20
ROTATOR_STEPS = 4
IFFT_SIZES = (1024, 4096, 16384)
# phase 21: examples/fm_receiver.yaml's rates, and its full-size block
FM_FS = 240e3
FM_DEV = 37.5e3
FM_BLOCK_LEN = 5242880
# examples/channelizer.yaml, card against CPU: dB of the channel's power
# after f32 PFB sums, two FFT implementations and two erfinvs
CHAN_DB_ATOL = 1e-3
# phase 22: the AGC loop against the Agc block on one device (the same ops
# in the same order: measured bitwise equal on the CPU) and the card against
# the CPU, where the flow's Gaussian noise differs by NOISE_RTOL of max(1,|x|)
# and the loop's gain (~20 at std 0.05) carries that into the output
LOOP_ATOL = 1e-5
LOOP_STEPS = 4
# the precision ladder's dB contracts (tests/test_fir_methods.py:111-145,
# 203-245, 271): SNR against a float64 reference
RUNG_DB = {"high": 90.0, "default": 45.0, "bf16": 45.0}
INT8_DB = {"real": 40.0, "complex": 38.0}
FFT_DB = {"matmul": 90.0, "matmul_bf16": 45.0, "matmul_exact": 90.0}
# ... and a ceiling, so that no rung passes at full float32 (~135 dB here):
# bf16×3 stays HIGH_BELOW_F32_DB under the float32 rung's reading, one bf16
# pass under ONE_PASS_MAX_DB
HIGH_BELOW_F32_DB = 15.0
ONE_PASS_MAX_DB = 70.0
# the int8 rung against the CPU's integers on the first INT8_CPU_N samples
# (the integers are as exact there as at full size; the CPU's int32 matmul
# at full size costs tens of seconds)
INT8_CPU_N = 1 << 16
# an input whose every partial sum is exact in float32: c = 1 + 2^-9 splits
# into bf16 hi = 1, lo = 2^-9, and over K = 16 each rung has one exact value
# (full float32 and TF32 16·c², bf16×3 16·(1 + 2^-8), one bf16 pass 16)
PROBE_C = 1.0 + 2.0 ** -9
PROBE = {"highest": 16.0 + 2.0 ** -4 + 2.0 ** -14, "high": 16.0 + 2.0 ** -4,
         "default": 16.0, "bf16": 16.0}
# phase 23: examples/coded_link.yaml runs at the default block_len 2^16 (its
# meta section is not read, as in the JAX package): the decoder sees 2^17
# LLRs per step, config 7's size; at n_bits 0 it runs CODED_STEPS steps
CODED_BLOCK_LEN = 1 << 16
CODED_STEPS = 8
CODED_BER_MAX = 1e-4
# the RrcFilters of phase 23(c)'s RRC + MMSymbolSync scenario
# (tests/test_digital.py:119), and the (sps, ntaps, beta, T) shapes at which
# (d) holds fir_banded against its plain version: that scenario's own (K 45
# at its block_len 4096), then RrcFilter's defaults (K 65) at 4096 and 2^22
RRC_MM = {"sps": 4, "ntaps": 45, "beta": 0.5}
RRC_BLOCK_LEN = 4096
RRC_SHAPES = ((RRC_MM["sps"], RRC_MM["ntaps"], RRC_MM["beta"], RRC_BLOCK_LEN),
              (4, 65, 0.35, RRC_BLOCK_LEN), (4, 65, 0.35, 1 << 22))
# phase 24: examples/rds_receiver.yaml runs at run_grc's default block_len
# (its meta section is not read, as in the JAX package): 65568 samples per
# step, 2732 into the Costas loop; tests/test_rds.py:98-112 runs 60 steps
RDS_STEPS = 60
RDS_CHECK_STEPS = 3
# the carrier loops on the card against the CPU on the same input, per sample
# relative to max(1, |y|) (tests/test_torch_dsp_extras.py's LOOP_ATOL)
LOOP_SAMPLE_ATOL = 1e-5
# the capstone (tests/test_acceptance.py:74-131): a 456 kHz IF, block_len 48000
CAP_FS = 456000.0
CAP_BLOCK_LEN = 48000
CAP_STEPS = 3
SPECTRUM_STEPS = 20
# phase 25: qa_TriggerBlocks' timeline (tests/test_trigger_blocks_golden.py)
# at a 42 MS/s digitizer: a step of 2^22 samples is 0.1 s, so every segment
# starts on a step boundary, and two 1 s cycles are 20 steps
ACQ_FS = 41943040.0
ACQ_BLOCK_LEN = 1 << 22
ACQ_STEPS = 20
ACQ_CTX = [f"FAIR.SELECTOR.C=1:S=1:P={i}" for i in range(5)]
ACQ_TAG_TIMES = (0.0, 0.1, 0.4, 0.5, 0.8)
# the same chain at 2^16 a step, on the card and on the CPU
ACQ_CHECK_FS = 655360.0
ACQ_CHECK_BLOCK_LEN = 1 << 16
# the 31-tap Savitzky-Golay filter's group delay, and the edges' tolerance
# around (k + 0.25) s and (k + 0.65) s plus that delay
SG_DELAY = 15
EDGE_SAMPLES = 2
# a DataSet spans the rising to the falling edge: 0.4 s ± this many samples
DS_SAMPLES = 3
# SvdDenoiser's engines timed at a step of 2^20 samples (chunk 256, window 16)
SVD_BLOCK_LEN = 1 << 20
# SVD reconstructions, card against CPU: of the signal's peak
# (tests/test_torch_misc_blocks.py's SVD_ATOL)
SVD_ATOL = 1e-4
# float32 blocks, card against CPU, of max(1, |y|)
# (tests/test_torch_misc_blocks.py's F32_ATOL)
F32_ATOL = 1e-5
# phase 26: the five example flows whose receivers the FEC slice ported, each
# with its decoder, the attribute read, and the result tests/test_examples.py
# asserts for the JAX package
FLOWS = ("lora_link", "wifi_link", "ble_scanner", "ais_receiver", "rtty_teletype")
# float fields of the decoded results (the Wi-Fi frame's CFO estimate),
# card against CPU: of |x| (the estimate reads float32 samples that the two
# devices round differently; 1.6e-8 apart between the packages on the CPU)
FLOW_RTOL = 1e-5
# ConvEncoder → ViterbiDecoder: bits, coded bits a step, traceback
VIT_BITS = 32768
VIT_BLOCK_LEN = 4096
VIT_TB = 64
VIT_FLIP = 0.05
VIT_RESIDUAL_MAX = 0.01
# phase 27: the GPS L1 C/A search at GnssAcquisition's widths (PRNs 1–32,
# ±5 kHz in 250 Hz bins, 2 blocks of 1 ms) on six satellites (PRN, Doppler
# Hz, code phase) at tests/test_gnss.py:42-51's SNR; detections exact but
# the Doppler (within one bin) and the metric, card against CPU (a ratio of
# two float32 surface values: tests/test_torch_gnss.py's METRIC_RTOL)
GNSS_FS = 2.046e6
GNSS_SATS = ((3, -3750.0, 100), (7, 1800.0, 300), (11, 2400.0, 42),
             (22, -3250.0, 1501), (29, -1000.0, 1999), (31, 4250.0, 777))
GNSS_N_MS = 4
GNSS_NOISE = 2.0
GNSS_BLOCK_LEN = 2046
GNSS_DOPPLER_STEP = 250.0
GNSS_METRIC_RTOL = 1e-4
# the tracking bank: NAV1 and NAV2 of tests/test_gnss.py:93-95, alternating
GNSS_NAV = ((1, 0, 1, 1, 0, 0, 1, 0), (0, 1, 1, 0, 1, 0, 0, 1))
GNSS_TRACK_MS = 300
GNSS_TRACK_NOISE = 1.0
# the CCSDS link of tests/test_ccsds.py:100-127 at interleave 4; RS codewords
# with t = 16 byte errors each, and one more with 17
CCSDS_INTERLEAVE = 4
CCSDS_FLIPS = 0.02
RS_CODEWORDS = 8
RS_ERRORS = 16
# tests/test_polar.py:99-116's code and channel, 64 frames
POLAR_N = 256
POLAR_K = 128
POLAR_SIGMA = 0.65
POLAR_FRAMES = 64
# APT images behind a discriminator, card against CPU (tests/
# test_torch_receivers.py's APT_ATOL)
APT_ATOL = 1e-4
# CVSD at 16 kS/s (MIL-STD-188-113's 16 kbit/s), 4 steps of 4096 samples of
# noise low-passed at CVSD_BAND; the encoder's launches are counted on
# CVSD_PROFILE samples; audio card against CPU (tests/
# test_torch_vocoder_tensor.py's AUDIO_ATOL)
CVSD_FS = 16000.0
CVSD_BAND = 300.0
CVSD_STEPS = 4
CVSD_BLOCK_LEN = 4096
CVSD_SNR_DB = 10.0
CVSD_AUDIO_ATOL = 1e-6
CVSD_PROFILE = 512
# phase 28: the host core. (a) the chain across two graphs joined by a pipe,
# at the chain's block_len; the ring holds two steps
PIPE_STEPS = 4
PIPE_TIMED_STEPS = 16
PIPE_CAPACITY = 1 << 24
WAIT_STEPS = 2
WAITS = ("spin", "yield", "sleep", "block")
PHASE28_TIMEOUT = 300.0          # bound on every threaded wait of the phase
# (b) FreqXlatingFir → QuadratureDemod under its own scheduler
SUB_BLOCK_LEN = 1 << 22
SUB_STEPS = 4
# (c) the user-function blocks on an FM tone's demod output: ±1 MHz of
# deviation at 50 kHz is ±0.314 rad a sample, ×5 reaches ±1.57, so clip(±1)
# cuts every cycle
USER_BLOCK_LEN = 1 << 22
USER_CPU_BLOCK_LEN = 1 << 16
USER_STEPS = 2
USER_DEV_HZ = 1e6
USER_MOD_HZ = 50e3
USER_GAIN = 5.0
USER_QUANT = 1e4                 # the int16 HostBlock's scale
USER_REPS = 5
# (d) the tapped chain's steps; (e) merge
DOMAIN_STEPS = 2
MERGE_LEN = 1 << 22
MERGE_STEPS = 2
# tests/test_io_blocks.py:145-184
NMEA_OK = "$GPRMC,123519,A,4807.038,N,01131.000,E,022.4,084.4,230394,003.1,W*6A"
NMEA_GGA = "$GPGGA,123519,4807.038,N,01131.000,E,1,08,0.9,545.4,M,46.9,M,,*47"
# phase 29: the IO entry points. (a) an RTL-SDR FM receiver: the driver's
# 2.4 MS/s (28.8 MHz · 2^22 / ratio, exact here), the station 100 kHz above
# the tuning, a 2 kHz tone at 75 kHz deviation, ÷50 to 48 kHz audio; block
# 2^18 (rounded by the rate algebra to a multiple of 50), 2 warm-up and 8
# timed steps; the card against the CPU on 2 steps of 50·4096
RTL_FS = 2.4e6
RTL_FC = 100e6
RTL_OFFSET = 100e3
RTL_TONE = 2000.0
RTL_DEV = 75e3
RTL_DECIM = 50
RTL_BLOCK_LEN = 1 << 18
RTL_WARM = 2
RTL_STEPS = 8
RTL_CPU_BLOCK_LEN = RTL_DECIM * 4096
RTL_NOISE = 0.02                 # seeded complex noise on the fake's air
# WBFM audio (|audio| ≲ 1 at full deviation), card against CPU: f32 FIRs of
# 127 taps, atan2 and the de-emphasis in two libraries (tests/
# test_torch_sdr_drivers.py holds the port to the JAX package within 1e-5)
RTL_ATOL = 1e-4
# (b) SigMF replay of phase 4's input (STEPS steps of 2^23), then 2 + 8
# steps of it repeated for the timing
SIGMF_WARM = 2
SIGMF_TIMED = 8
# (c) two graphs joined by TCP at 2^22 complex64: 2 warm-up steps + 4
TCP_BLOCK_LEN = 1 << 22
TCP_STEPS = 6
UDP_SAMPLES = 80_000
PHASE29_TIMEOUT = 300.0
# phase 30: the time-sharded mesh on one card — 8 time shards of the chain
# at 2^23, the sharded receiver at BASELINE config 4's widths (64 channels,
# 8 taps a phase, audio FIR 32 taps ÷4) over (dp 2, sp 4), the sky search over
# 4 shards, a three-stage pipeline; sharded against unsharded within
# dryrun_multichip's bound MESH_ATOL, bitwise where the JAX tests are; the
# receiver's audio FIR held to fir_banded_ref at both its shapes (FIR_ATOL)
MESH_SP = 8
MESH_ATOL = 1e-4
MESH_TIMED_STEPS = 20
RX_CFG = dict(n_channels=64, taps_per_phase=8, audio_decim=4, audio_ntaps=32,
              batch=2, block_len=1 << 22)
RX_STEPS = 3
RX_CPU_BLOCK_LEN = 1 << 14
RX_OFFSET = 0.2                  # per-channel tone offset, ≤ this/M cycles a sample
# phase 31: the chain at 2^23 across two processes on the one card — a
# global mesh of 4 time shards a process, all on cuda:0, Gloo with host
# staging; each process's slices against phase 30's 8-shard chain (bitwise
# expected, bound MESH_ATOL) and phase 5's; the NullSink chain timed in
# turns with phase 30's; the workers are this file run with
# --multihost-worker
MH_WORLD = 2
MH_LOCAL = 4
MH_TIMEOUT = 120.0      # the process group's set-up and collective timeout
MH_DEADLINE = 420.0     # a worker not done by then fails the phase
MH_WINDOWS = 3
KERNELS = {
    "fir_banded": {
        "source": "gnuradio4_tpu_torch/csrc/fir_banded.cu",
        "replaces": "gnuradio4_tpu/ops/pallas_kernels.py:438",
        "also_replaces": "gnuradio4_tpu/ops/pallas_kernels.py:187",
    },
    "nco_mix": {
        "source": "gnuradio4_tpu_torch/csrc/nco_mix.cu",
        "replaces": "gnuradio4_tpu/ops/pallas_kernels.py:124",
    },
    "iir_sos": {
        "source": "gnuradio4_tpu_torch/csrc/iir_sos.cu",
        "replaces": "gnuradio4_tpu/ops/pallas_kernels.py:79",
    },
    "fir_demod": {
        "source": "gnuradio4_tpu_torch/csrc/fir_demod.cu",
        "replaces": "gnuradio4_tpu/ops/pallas_kernels.py:391",
    },
}
# one H100 SXM at its 700 W limit (NVIDIA's data sheet): float32 outside the
# tensor cores, and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
# f32 sums of 16384 taps against a float64 FFT reference, relative to the
# output RMS: the rounding grows like √K·2^-24 (~1e-5)
LONG_RTOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


_SPIN_CYCLES_PER_MS: list[float] = []


def spin_cycles_per_ms() -> float:
    """Clock cycles per ms of ``torch.cuda._sleep``'s spin kernel (measured
    once with CUDA events)."""
    import torch
    if not _SPIN_CYCLES_PER_MS:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(1_000_000)
        e.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS.append(1_000_000 / s.elapsed_time(e))
    return _SPIN_CYCLES_PER_MS[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Device milliseconds of one call of ``fn``: ``reps`` calls queued behind
    a spin kernel that holds the card while the host enqueues them, timed by
    CUDA events around the calls, over ``reps``. The card then runs the calls
    back to back, so the host's launch time shows only where one call's
    enqueue outlasts the spin (capped at 50 ms) or the previous call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = min(50.0, 1.5 * reps * host_ms + 0.1)
    torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def kernel_vs_plain_ms(kernel, plain, plain_reps: int = 10
                       ) -> tuple[float, float]:
    """Device ms (:func:`cuda_ms`) of the kernel and of its plain version,
    measured in turns (plain, kernel, kernel, plain) so drift on the card hits
    both alike; the median of each pair. ``plain_reps`` < 10 shortens a slow
    plain version's runs."""
    def plain_ms():
        return cuda_ms(plain, reps=plain_reps, warmup=min(2, plain_reps))
    p1, k1, k2, p2 = plain_ms(), cuda_ms(kernel), cuda_ms(kernel), plain_ms()
    return statistics.median((k1, k2)), statistics.median((p1, p2))


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for this work: the larger of the
    operations over the FP32 peak and the bytes over the HBM rate, and which
    of the two it is."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def iir_bound_ms(channels: int, t: int, n_sec: int) -> tuple[float, str]:
    """:func:`bound_ms` of one biquad cascade call: 5 multiply-adds (10 FLOPs)
    per section and sample; x read and y written once, the state in and
    out."""
    return bound_ms(10.0 * channels * t * n_sec,
                    8.0 * channels * t + 16.0 * channels * n_sec)


def fir_work(shape, x_complex: bool, taps_complex: bool, k: int, decim: int
             ) -> tuple[float, float]:
    """(FLOPs, bytes) of one FIR call: K multiply-adds per output (8 FLOPs
    complex by complex, 4 mixed, 2 real); the stream and its K−1 history
    samples read once, the taps once, the outputs written once."""
    ch = 1
    for d in shape[:-1]:
        ch *= d
    t, m = shape[-1], shape[-1] // decim
    per_mac = 8 if x_complex and taps_complex else 4 if x_complex or taps_complex else 2
    sx = 8 if x_complex else 4
    sy = 8 if x_complex or taps_complex else 4
    return (ch * m * k * per_mac,
            ch * (t + k - 1) * sx + k * (8 if taps_complex else 4) + ch * m * sy)


def demod_work(shape, taps_complex: bool, k: int, decim: int
               ) -> tuple[float, float]:
    """(FLOPs, bytes) of one fused FIR→demod call: the FIR's MACs and 6 FLOPs
    of the conjugate product per output (atan2 not counted); the stream read
    once, the taps and prev once, 4 bytes written per output."""
    flops, nbytes = fir_work(shape, True, taps_complex, k, decim)
    ch = 1
    for d in shape[:-1]:
        ch *= d
    m = ch * (shape[-1] // decim)
    return flops + 6.0 * m, nbytes - 4.0 * m + 8.0 * ch


def conv1d_ms(x, hist, h, decim: int) -> float:
    """One PyTorch call computing fir_banded's function: ``F.conv1d`` of the
    history-prefixed stream with the reversed taps at stride ``decim``
    (complex64 when either is complex), cuDNN's TF32 off. A yardstick only;
    the port never calls it for this."""
    import torch
    xc = torch.cat([hist, x], -1).reshape(-1, 1, hist.shape[-1] + x.shape[-1])
    w = h.flip(0)[None, None]
    if xc.is_complex() or w.is_complex():
        xc, w = xc.to(torch.complex64), w.to(torch.complex64)

    def conv():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return torch.nn.functional.conv1d(xc, w, stride=decim)
    return cuda_ms(conv, reps=5)


def fir_float64(xc, taps, decim: int):
    """``y[..., m] = Σ_k h[k]·xc[..., m·decim + K−1−k]`` in float64, as a
    NumPy array: the reference where the plain version's Toeplitz band would
    not fit. A complex128 torch FFT on ``xc``'s device, at a power-of-two
    length (NumPy's FFT at the stream's own length takes seconds)."""
    import numpy as np
    import torch
    k = len(taps)
    nfft = 1 << (xc.shape[-1] + k - 2).bit_length()
    h = torch.from_numpy(np.asarray(taps, np.complex128)).to(xc.device)
    full = torch.fft.ifft(torch.fft.fft(xc.to(torch.complex128), nfft)
                          * torch.fft.fft(h, nfft))
    m = (xc.shape[-1] - (k - 1)) // decim
    return full[..., k - 1: k - 1 + m * decim: decim].cpu().numpy()


def events_ms_per_step(step, n_steps: int, windows: int = 5):
    """Median over ``windows`` windows of ``n_steps`` calls of ``step``: ms per
    call from CUDA events, with every window's (events ms, host wall ms)."""
    import torch
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n_steps):
            step()
        end.record()
        torch.cuda.synchronize()
        out.append((start.elapsed_time(end) / n_steps,
                    (time.perf_counter() - t0) / n_steps * 1e3))
    return statistics.median(w[0] for w in out), out


def chain_xlating_fir():
    """The chain's FreqXlatingFir: 127 taps, low-pass at 2 MHz, 3 MHz shift."""
    import numpy as np
    from gnuradio4_tpu_torch.blocks.filter import FreqXlatingFir
    from gnuradio4_tpu_torch.ops import filter_design as fd
    taps = fd.design_fir("lowpass", 127, sample_rate=FS, f_low=2e6)
    return FreqXlatingFir(taps=taps.astype(np.float32), center_freq=3e6,
                          sample_rate_in=FS, decim=1)


def build_chain(sinks: str, source=None, fft_domain=None):
    """The headline chain of bench.py, built in the port. ``sinks``: 'vector'
    (host capture) or 'null' (count only, no device→host copy). ``source``
    replaces the 1 MHz ComplexToneSource; ``fft_domain`` annotates the FIR →
    FFT edge."""
    import numpy as np
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks.basic import ComplexToneSource
    from gnuradio4_tpu_torch.blocks.filter import FirFilter
    from gnuradio4_tpu_torch.blocks.fourier import FFT
    from gnuradio4_tpu_torch.blocks.sdr import QuadratureDemod
    from gnuradio4_tpu_torch.blocks.testing import NullSink, VectorSink
    from gnuradio4_tpu_torch.ops import filter_design as fd

    g = gt.Graph()
    src = ComplexToneSource(frequency=1e6) if source is None else source
    fir = chain_xlating_fir()
    fft = FFT(fft_size=4096, window="Hann", output="magnitude", calibrate=False)
    dem = QuadratureDemod(gain=1.0)
    audio = FirFilter(taps=fd.design_fir("lowpass", 63, sample_rate=FS,
                                         f_low=1e6).astype(np.float32), decim=8)
    sink = VectorSink if sinks == "vector" else NullSink
    s1, s2 = sink(name="spec"), sink(name="audio")
    g.connect(src, fir)
    g.connect(fir, fft, domain=fft_domain)
    g.connect(fft, s1)
    g.connect(fir, dem)
    g.connect_chain(dem, audio, s2)
    return g, fir, s1, s2


def run_chain(device: str, block_len: int, steps: int, absorb: bool,
              **sched_kw):
    import gnuradio4_tpu_torch as gt
    if absorb:
        os.environ.pop("GR4TPU_NO_ROTATION_ABSORB", None)
    else:
        os.environ["GR4TPU_NO_ROTATION_ABSORB"] = "1"
    try:
        g, fir, s1, s2 = build_chain("vector")
        sched = gt.Scheduler(g, block_len=block_len, sample_rate=FS, device=device,
                             **sched_kw)
        sched.run_and_wait(steps)
        import torch
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        os.environ.pop("GR4TPU_NO_ROTATION_ABSORB", None)
    check(fir._rotation_absorbed == absorb,
          f"rotation absorbed={fir._rotation_absorbed}, expected {absorb}")
    return s1.data(), s2.data()


def check_chain_outputs(spec, audio, block_len: int, steps: int, label: str) -> None:
    import numpy as np
    n = 4096
    check(spec.shape == (block_len * steps,), f"{label}: spectrum shape {spec.shape}")
    check(audio.shape == (block_len * steps // 8,), f"{label}: audio shape {audio.shape}")
    check(bool(np.all(np.isfinite(spec)) and np.all(np.isfinite(audio))),
          f"{label}: non-finite output")
    # the 1 MHz tone translated by -3 MHz lands at -2 MHz: bin -409.6 of 4096
    want = (-2e6 / FS * n) % n
    peaks = np.argmax(spec.reshape(-1, n)[1:], axis=1)   # skip the start transient
    worst_bin = float(np.max(np.abs(peaks - want)))
    check(worst_bin <= 1.0, f"{label}: spectrum peak off by {worst_bin} bins")
    # demod of a pure tone at -2 MHz: gain·2π·(-2 MHz)/20 MHz per sample
    const = 2 * np.pi * (-2e6) / FS
    dev = float(np.max(np.abs(audio[64:] - const)))
    check(dev <= AUDIO_ATOL, f"{label}: audio deviates {dev:.3e} from {const:.6f}")
    print(f"  {label}: peak bin within {worst_bin:.2f} of {want:.1f}; "
          f"audio max|Δ| from {const:.7f} = {dev:.3e} (tol {AUDIO_ATOL})")


def compare_sinks(a, b, label: str, skip_audio: int = 0) -> None:
    import numpy as np
    (sa, aa), (sb, ab) = a, b
    check(sa.shape == sb.shape and aa.shape == ab.shape, f"{label}: shapes differ")
    ds = float(np.max(np.abs(sa - sb)))
    tol_s = SPEC_RTOL * float(np.max(np.abs(sa)))
    da = float(np.max(np.abs(aa[skip_audio:] - ab[skip_audio:])))
    print(f"  {label}: spectrum max|Δ| {ds:.3e} (tol {tol_s:.3e}), "
          f"audio max|Δ| {da:.3e} (tol {AUDIO_ATOL})")
    check(ds <= tol_s and da <= AUDIO_ATOL, f"{label}: sinks disagree")


def build_wbfm(sink: str):
    """Path A, as bench_suite.py:134-148 builds suite config 3: the receiver is
    a nested graph made by the registry. ``sink``: 'vector' or 'null'."""
    import gnuradio4_tpu_torch as gt
    g = gt.Graph()
    src = gt.global_registry.create("ComplexToneSource", frequency=10e3)
    rx = gt.global_registry.create("WbfmReceiver", quad_rate=QUAD_RATE,
                                   audio_decim=5)
    snk = gt.global_registry.create("VectorSink" if sink == "vector" else "NullSink",
                                    name="audio")
    g.add(rx)
    g.connect(src, rx["in"])
    g.connect(rx["out"], snk)
    return g, snk


def run_wbfm(device: str, block_len: int, steps: int, **sched_kw):
    import gnuradio4_tpu_torch as gt
    g, snk = build_wbfm("vector")
    sched = gt.Scheduler(g, block_len=block_len, sample_rate=QUAD_RATE,
                         device=device, **sched_kw)
    sched.run_and_wait(steps)
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    names = [b.name for b in sched.compiled.order]
    check(names[1:5] == ["wbfm.channel", "wbfm.demod", "wbfm.audio", "wbfm.deemph"],
          f"Path A flattened order {names}")
    return sched.compiled, snk.data()


def check_wbfm_audio(audio, n_audio: int, steps: int, label: str) -> None:
    import numpy as np
    check(audio.shape == (n_audio * steps,), f"{label}: audio shape {audio.shape}")
    check(bool(np.all(np.isfinite(audio))), f"{label}: non-finite audio")
    dev = float(np.max(np.abs(audio[WBFM_SKIP:] - WBFM_CONST)))
    print(f"  {label}: audio max|Δ| from {WBFM_CONST:.8f} after {WBFM_SKIP} "
          f"samples = {dev:.3e} (tol {WBFM_ATOL})")
    check(dev <= WBFM_ATOL, f"{label}: audio deviates {dev} from {WBFM_CONST}")


def iir_design(order: int):
    from gnuradio4_tpu_torch.ops import filter_design as fd
    return fd.design_iir("butterworth", "lowpass", order, sample_rate=IIR_FS,
                         f_low=15e3)


def build_iir_path(order: int, sink: str, source_only: bool = False,
                   engine: str = "auto"):
    """Path B: SignalGenerator(Sin, 1 kHz, 16 channels) → IirFilter(b, a,
    engine) → sink. ``source_only``: the generator straight into the sink
    (its samples, for the float64 reference)."""
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks.filter import IirFilter
    g = gt.Graph()
    src = gt.global_registry.create("SignalGenerator", signal="Sin",
                                    frequency=1e3, channels=IIR_CHANNELS)
    snk = gt.global_registry.create("VectorSink" if sink == "vector" else "NullSink")
    res = iir_design(order)
    iir = IirFilter(b=res.b, a=res.a, engine=engine)
    if source_only:
        g.connect(src, snk)
    else:
        g.connect_chain(src, iir, snk)
    return g, iir, snk


def run_iir_path(device: str, order: int, block_len: int, steps: int,
                 source_only: bool = False):
    import gnuradio4_tpu_torch as gt
    g, iir, snk = build_iir_path(order, "vector", source_only)
    gt.Scheduler(g, block_len=block_len, sample_rate=IIR_FS,
                 device=device).run_and_wait(steps)
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    return iir, snk.data()


def rms_err(got, want) -> float:
    import numpy as np
    scale = max(float(np.sqrt(np.mean(np.abs(want) ** 2))), 1e-3)
    return float(np.max(np.abs(got - want))) / scale


def check_against_scipy(y, x, order: int, label: str) -> float:
    """y (f32 filter output) against scipy's float64 sosfilt of x."""
    import numpy as np
    from scipy import signal
    want = signal.sosfilt(iir_design(order).sos, x.astype(np.float64), axis=-1)
    check(y.shape == want.shape, f"{label}: shape {y.shape} vs {want.shape}")
    check(bool(np.all(np.isfinite(y))), f"{label}: non-finite output")
    err = rms_err(y.astype(np.float64), want)
    print(f"  {label}: max|Δ| to scipy float64 sosfilt = {err:.3e}·RMS "
          f"(tol {SCIPY_RTOL})")
    check(err <= SCIPY_RTOL, f"{label}: {err} > {SCIPY_RTOL} against scipy")
    return err


def wbfm_channel_taps():
    """The receiver's channel filter taps (make_wbfm_receiver's design)."""
    import numpy as np
    from gnuradio4_tpu_torch.ops import filter_design as fd
    return fd.design_fir("lowpass", 127, sample_rate=QUAD_RATE,
                         f_low=100e3).astype(np.float32)


def fused_front_end(device, n: int, chunks: int):
    """Path A's input (the 10 kHz tone) through ``fir_quad_demod_fused``, the
    JAX package's fused entry point, chunk by chunk with its framing: the
    history-prefixed stream in, v[-1] carried by the caller. Returns the demod
    output of every chunk and the chunks' inputs."""
    import torch
    from gnuradio4_tpu_torch.ops.fir import fir_quad_demod_fused
    from gnuradio4_tpu_torch.ops.signal import complex_exp_ramp, phase_increment
    taps = wbfm_channel_taps()
    k = len(taps)
    h_rev = torch.from_numpy(taps[::-1].copy()).to(device)
    dphi = int(phase_increment(10e3, QUAD_RATE))
    hist = torch.zeros(k - 1, dtype=torch.complex64, device=device)
    prev = torch.ones((), dtype=torch.complex64, device=device)
    outs, inputs = [], []
    for i in range(chunks):
        x = complex_exp_ramp(i * n * dphi, dphi, n, device=device)
        xc = torch.cat([hist, x])
        outs.append(fir_quad_demod_fused(xc[None], taps, 1, prev, WBFM_GAIN)[0])
        inputs.append(xc)
        # the last FIR output of this chunk, the next chunk's v[-1]
        prev = (xc[-k:] * h_rev).sum()
        hist = x[-(k - 1):]
    return outs, inputs


def drive_windows(sched, steps_per_window: int, windows: int = 5):
    """Drive a warmed-up scheduler through ``windows`` windows of
    ``steps_per_window`` logical steps by its pump (as bench_suite.py's
    ``_run_sched`` does), each window under a fresh recording profiler.
    Returns the median ms per logical step by CUDA events, every window's
    (events ms, wall ms) per step, and the median host ms per logical step
    in the pump (its ``scheduler.step`` spans) with that window's split."""
    import torch
    from gnuradio4_tpu_torch.core.profiler import Profiler
    pumps = steps_per_window // sched.batch_steps
    out, host = [], []
    for _ in range(windows):
        sched.profiler = prof = Profiler()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(pumps):
            check(sched._pump_once(), "the stream ended inside a timing window")
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = pumps * sched.batch_steps
        out.append((start.elapsed_time(end) / n, wall / n * 1e3))
        spans: dict[str, float] = {}
        for ev in prof.events():
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3 / n
        host.append(spans)
    sched.profiler = Profiler()
    ms = statistics.median(w[0] for w in out)
    host_ms = statistics.median(h.get("scheduler.step", 0.0) for h in host)
    split = min(host, key=lambda h: abs(h.get("scheduler.step", 0.0) - host_ms))
    return ms, out, host_ms, split


def finish(sched) -> None:
    """Deliver what is in flight and stop the scheduler's worker thread."""
    sched._drain()
    sched._stop_delivery_worker()


def fmt_windows(windows) -> str:
    return str([(round(a, 4), round(b, 4)) for a, b in windows])


def fmt_split(split: dict) -> str:
    return ", ".join(f"{k.split('.')[-1]} {v:.4f}" for k, v in sorted(split.items()))


def build_config5(sink: str, tag_period: int = C5_TAG_PERIOD):
    """Path C as bench_suite.py:226-251 builds suite config 5: a complex noise
    source tagging ``trigger_time`` every ``tag_period`` input samples →
    PFBChannelizer(256, 8) → QuadratureDemod(1) → ``sink``."""
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks.basic import NoiseSource
    from gnuradio4_tpu_torch.blocks.channelizer import PFBChannelizer
    from gnuradio4_tpu_torch.blocks.sdr import QuadratureDemod

    class TaggedNoise(NoiseSource):
        def emit_tags(self, ctx):
            n = next(iter(ctx.out_len.values()), 0)
            lo, hi = ctx.abs_index, ctx.abs_index + n
            first = -(-lo // tag_period) * tag_period
            return [gt.Tag(i - lo, {"trigger_time": float(i / C5_FS)})
                    for i in range(first, hi, tag_period)]

    g = gt.Graph()
    src = TaggedNoise(noise="complex_gaussian")
    chan = PFBChannelizer(n_channels=C5_CHANNELS, taps_per_phase=8)
    dem = QuadratureDemod(gain=1.0)
    snk = gt.global_registry.create(sink)
    g.connect_chain(g.add(src), g.add(chan), g.add(dem), g.add(snk))
    return g, snk


def config5_scheduler(g, device, block_len=C5_BLOCK_LEN, batch=C5_BATCH):
    import gnuradio4_tpu_torch as gt
    return gt.Scheduler(g, block_len=block_len, sample_rate=C5_FS, device=device,
                        pipeline_depth=2, async_delivery=True, batch_steps=batch)


def build_config6(sink: str, n_samples: int = 0):
    """Path D as bench_suite.py:263-277 builds suite config 6."""
    import gnuradio4_tpu_torch as gt
    g = gt.Graph()
    src = g.emplace("CountingSource", n_samples=n_samples, dtype="float32")
    prev = src
    for _ in range(20):
        m = g.emplace("MultiplyConst", value=2.0)
        d = g.emplace("DivideConst", value=2.0)
        g.connect(prev, m)
        g.connect(m, d)
        prev = d
    snk = g.emplace(sink)
    g.connect(prev, snk)
    return g, snk


def wrapped_err(a, b) -> float:
    """max |a − b| with the difference wrapped into (−π, π] (demod angles)."""
    import numpy as np
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.max(np.abs((d + np.pi) % (2 * np.pi) - np.pi)))


def profile_device(fn):
    """Device time of ``fn`` by torch.profiler: (device ms, top kernels), or
    (None, []) when the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((us / 1e3, e.key.replace("void ", "")
                         .replace("at::native::", "")[:110]))
    if not rows:
        return None, []
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows[:6]


def build_suite(cfg: str, sink: str, tap_source: bool = False):
    """Suite config ``cfg`` ('1', '2', '4' or '7k') as bench_suite.py:103-162
    and 318-332 build it, with ``sink`` in place of its NullSink. With
    ``tap_source`` the source also feeds a VectorSink (returned third; the
    card-against-CPU runs read the decoder's input through it)."""
    import numpy as np
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.ops import filter_design as fd
    g = gt.Graph()
    if cfg == "1":
        chain = [g.emplace("ComplexToneSource", frequency=1e6),
                 g.emplace("FirFilter", taps=fd.design_fir(
                     "lowpass", 127, sample_rate=C1_FS, f_low=2e6).astype(np.float32)),
                 g.emplace("FFT", fft_size=4096, window="Hann", output="magnitude",
                           calibrate=False)]
    elif cfg == "2":
        chain = [g.emplace("NoiseSource"),
                 g.emplace("RationalResampler", interp=3, decim=2)]
    elif cfg == "4":
        chain = [g.emplace("NoiseSource", noise="complex_gaussian"),
                 g.emplace("PFBChannelizer", n_channels=64, taps_per_phase=8),
                 g.emplace("Abs")]
    else:
        chain = [g.emplace("NoiseSource", noise="gaussian"),
                 g.emplace("LdpcDecoder", n=256, m=128, seed=0)]
    snk = g.emplace(sink)
    g.connect_chain(*chain, snk)
    tap = None
    if tap_source:
        tap = g.emplace("VectorSink")
        g.connect(chain[0], tap)
    return g, snk, SUITE_FS[cfg], tap


def config7_llrs(n_frames: int, sigma: float = C7_SIGMA, seed: int = 0):
    """bench_suite.py:290-297: BPSK LLRs of random data bits encoded by the
    code (n 256, m 128, seed 0) over AWGN of ``sigma``. Returns (H, k, data
    bits [n_frames·k], LLRs [n_frames·256] float32). The codewords are
    ``encode``'s, as a float32 product mod 2 (exact for 0/1 sums < 2^24)."""
    import numpy as np
    from gnuradio4_tpu_torch.ops.ldpc import make_ldpc
    H, G = make_ldpc(256, 128, wc=3, seed=0)
    k = G.shape[0]
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, n_frames * k).astype(np.uint8)
    c = ((u.reshape(-1, k).astype(np.float32) @ G.astype(np.float32)) % 2).reshape(-1)
    y = 1.0 - 2.0 * c + sigma * rng.standard_normal(len(c))
    return H, k, u, (2 * y / sigma ** 2).astype(np.float32)


def build_config7(llr, sink: str):
    """Config 7 as bench_suite.py:299-313 builds it: a device-resident
    VectorSource of LLRs → LdpcDecoder(256, 128, seed 0) → ``sink``."""
    import gnuradio4_tpu_torch as gt
    g = gt.Graph()
    src = g.emplace("VectorSource", device_resident=True)
    src.data = llr
    dec = g.emplace("LdpcDecoder", n=256, m=128, seed=0)
    snk = g.emplace(sink)
    g.connect_chain(src, dec, snk)
    return g, snk


def time_compiled(compiled, steps_per_window: int, windows: int = 5) -> dict:
    """A compiled graph's step loop as bench_suite.py:_run drives it: 2 warm
    steps, then ``windows`` windows of ``steps_per_window`` steps. Returns the
    median ms/step by CUDA events, every window's (events ms, host dispatch ms)
    per step (the loop's wall before the closing synchronize), the median
    host ms, the peak device memory over the windows, one profiled step's
    device time and top kernels, the number of steps run and the last step's
    sink inputs."""
    import torch
    box = [compiled.init_states(), None]
    params = compiled.gather_params()

    def step():
        box[0], box[1] = compiled.step(box[0], params)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps_per_window):
            step()
        end.record()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out.append((start.elapsed_time(end) / steps_per_window,
                    host / steps_per_window * 1e3))
    peak = torch.cuda.max_memory_allocated() / 2**30
    dev_ms, top = profile_device(step)
    return {"ms": statistics.median(w[0] for w in out), "windows": out,
            "host_ms": statistics.median(w[1] for w in out), "peak_gib": peak,
            "dev_ms": dev_ms, "top": top, "steps": 3 + windows * steps_per_window,
            "last": next(iter(box[1].values()))}


def report_path(label: str, n_in: int, t: dict, unit: str = "Msps") -> dict:
    """Print one path's timing line and return its entry of the paths JSON."""
    rate = n_in / (t["ms"] * 1e-3) / 1e6
    busy = ("not measured (the profiler saw no device activity)"
            if t["dev_ms"] is None else
            f"{t['dev_ms']:.4f} ms ({t['dev_ms'] / t['ms']:.1%} of the step)")
    print(f"  {label}: {rate:.2f} {unit}, {t['ms']:.4f} ms/step (median of "
          f"{len(t['windows'])} windows, CUDA events; (events ms, host ms) "
          f"{fmt_windows(t['windows'])}); host {t['host_ms']:.4f} ms/step; "
          f"device busy {busy}; peak device memory {t['peak_gib']:.3f} GiB; "
          f"top kernels {[(round(a, 4), k[:60]) for a, k in t['top'][:4]]}")
    return {"name": label, unit.replace(" ", "_").replace("/", "_per_").lower(): rate,
            "ms_per_step": t["ms"], "host_ms_per_step": t["host_ms"],
            "device_busy_share": (None if t["dev_ms"] is None
                                  else t["dev_ms"] / t["ms"]),
            "peak_gib": t["peak_gib"]}


def cpu_vs_card(build, block_len: int, dev, steps: int = CPU_STEPS,
                **sched_kw):
    """The same graph through ``Scheduler(**sched_kw)`` on the CPU and on the card:
    ``build()`` → (graph, sink, sample rate, tap or None). Returns per device
    the sink's data and the tap's (or None), keyed 'cpu' and 'card'."""
    import numpy as np
    import gnuradio4_tpu_torch as gt
    out = {}
    for key, device in (("cpu", "cpu"), ("card", dev)):
        g, snk, fs, tap = build()
        gt.Scheduler(g, block_len=block_len, sample_rate=fs, device=device,
                     **sched_kw).run_and_wait(steps)
        out[key] = (np.asarray(snk.data()),
                       None if tap is None else np.asarray(tap.data()))
    return out


def suite_phases(dev, gen, results: dict) -> list[dict]:
    """Phases 13–20: suite configs 1, 2, 4, 7 and 7k at their suite sizes,
    the Rotator, ``fir_apply``'s methods and the IFFT engines on the card.
    Adds each path's hand-kernel launches to ``results``; returns the paths'
    entries of the paths JSON."""
    import numpy as np
    import torch
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.core.profiler import Profiler
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck
    from gnuradio4_tpu_torch.ops import filter_design as fd
    from gnuradio4_tpu_torch.ops import ldpc, resample
    from gnuradio4_tpu_torch.ops.fft import matmul_fft
    from gnuradio4_tpu_torch.ops.fir import fir_apply
    paths = []

    def count(label: str, want: dict) -> None:
        counts = ck.launch_counts()
        print(f"  launches {counts}")
        check(counts == {**{k: 0 for k in KERNELS}, **want},
              f"{label}: launches {counts}, expected {want}")
        for k in KERNELS:
            results[k]["launches"] += counts[k]

    def compiled_path(cfg: str, block_len: int, steps_per_window: int,
                      per_step: dict) -> dict:
        g, _, fs, _ = build_suite(cfg, "NullSink")
        compiled = gt.compile_graph(g, block_len=block_len, sample_rate=fs,
                                    device=dev)
        ck.reset_launch_counts()
        t = time_compiled(compiled, steps_per_window)
        count(f"config {cfg}", {k: n * t["steps"] for k, n in per_step.items()})
        return t

    def in_turns(label_a, fa, label_b, fb, what: str) -> dict:
        ms_a, ms_b = kernel_vs_plain_ms(fa, fb)
        print(f"  {what}: {label_a} {ms_a:.4f} ms, {label_b} {ms_b:.4f} ms "
              f"(median of 10 by CUDA events, in turns)")
        return {label_a: ms_a, label_b: ms_b}

    # 13. config 1
    print("[13 config 1] ComplexToneSource(1 MHz) → FirFilter(127) → FFT(4096, "
          "Hann, magnitude) → NullSink at 20 MHz, block_len 2^22")
    out = cpu_vs_card(lambda: build_suite("1", "VectorSink"), SUITE_CPU_BLOCK_LEN, dev)
    a, b = out["cpu"][0], out["card"][0]
    check(a.shape == b.shape == (CPU_STEPS * SUITE_CPU_BLOCK_LEN,),
          f"config 1 sink shapes {a.shape} {b.shape}")
    err = float(np.max(np.abs(a - b))) / float(np.max(a))
    print(f"  cpu vs card at block_len 2^14, {CPU_STEPS} steps: spectrum max|Δ| "
          f"{err:.3e} of the peak (tol {SPEC_RTOL})")
    check(err <= SPEC_RTOL, f"config 1 card vs CPU {err}")
    t = compiled_path("1", SUITE_BLOCK_LEN, 20, {"fir_banded": 1})
    spec = t["last"]["in"].cpu().numpy().reshape(-1, 4096)
    want_bin = 1e6 / C1_FS * 4096
    worst = float(np.max(np.abs(np.argmax(spec, axis=1) - want_bin)))
    check(bool(np.isfinite(spec).all()) and worst <= 1.0,
          f"config 1 at 2^22: peak off by {worst} bins")
    print(f"  card at 2^22: {spec.shape[0]} spectra finite, peak within "
          f"{worst:.2f} of bin {want_bin:.1f}")
    paths.append(report_path("config 1", SUITE_BLOCK_LEN, t))

    # 14. config 2, and the two resampler forms at its shape
    print("[14 config 2] NoiseSource → RationalResampler(3, 2) → NullSink, "
          "block_len 2^22")
    out = cpu_vs_card(lambda: build_suite("2", "VectorSink"), SUITE_CPU_BLOCK_LEN, dev)
    a, b = out["cpu"][0], out["card"][0]
    check(a.shape == b.shape == (CPU_STEPS * SUITE_CPU_BLOCK_LEN * 3 // 2,),
          f"config 2 sink shapes {a.shape} {b.shape}")
    err = rms_err(b, a)
    print(f"  cpu vs card at block_len 2^14, {CPU_STEPS} steps: max|Δ| "
          f"{err:.3e}·RMS (tol {SUITE_RTOL})")
    check(err <= SUITE_RTOL, f"config 2 card vs CPU {err}")
    kern = resample.RationalResamplerKernel(3, 2)
    x = torch.randn(SUITE_BLOCK_LEN, device=dev, generator=gen)
    st = kern.init_state(0, np.float32, dev)
    forms = {m: (lambda m=m: kern.apply(x, st, method=m)) for m in
             ("interleave", "matmul")}
    y_i, y_m = forms["interleave"]()[0], forms["matmul"]()[0]
    err = rms_err(y_m.cpu().numpy(), y_i.cpu().numpy())
    print(f"  forms at 2^22: matmul against interleave max|Δ| {err:.3e}·RMS "
          f"(tol {SUITE_RTOL})")
    check(y_m.shape == y_i.shape == (SUITE_BLOCK_LEN * 3 // 2,) and err <= SUITE_RTOL,
          f"resampler forms disagree: {err}")
    ms = in_turns("matmul", forms["matmul"], "interleave", forms["interleave"],
                  "RationalResampler 3/2 real 2^22")
    print(f"  auto on CUDA: matmul (faster here: {min(ms, key=ms.get)})")
    del x, y_i, y_m
    t = compiled_path("2", SUITE_BLOCK_LEN, 10, {})
    y = t["last"]["in"]
    check(y.shape == (SUITE_BLOCK_LEN * 3 // 2,) and bool(torch.isfinite(y).all()),
          f"config 2 at 2^22: output {tuple(y.shape)}")
    paths.append(report_path("config 2", SUITE_BLOCK_LEN, t))

    # 15. config 4
    print("[15 config 4] NoiseSource(complex_gaussian) → PFBChannelizer(64, 8) "
          "→ Abs → NullSink, block_len 2^22")
    out = cpu_vs_card(lambda: build_suite("4", "VectorSink"), SUITE_CPU_BLOCK_LEN, dev)
    a, b = out["cpu"][0], out["card"][0]
    check(a.shape == b.shape == (64, CPU_STEPS * SUITE_CPU_BLOCK_LEN // 64),
          f"config 4 sink shapes {a.shape} {b.shape}")
    err = rms_err(b, a)
    print(f"  cpu vs card at block_len 2^14, {CPU_STEPS} steps: max|Δ| "
          f"{err:.3e}·RMS (tol {SUITE_RTOL})")
    check(err <= SUITE_RTOL, f"config 4 card vs CPU {err}")
    t = compiled_path("4", SUITE_BLOCK_LEN, 5, {})
    y = t["last"]["in"]
    check(y.shape == (64, SUITE_BLOCK_LEN // 64) and bool(torch.isfinite(y).all())
          and bool((y >= 0).all()), f"config 4 at 2^22: output {tuple(y.shape)}")
    paths.append(report_path("config 4", SUITE_BLOCK_LEN, t))

    # 16. config 7 under the pipelined async scheduler
    print("[16 config 7] device-resident LLRs (seed 0, σ 0.6) → LdpcDecoder(256, "
          "128) → NullSink, block_len 2^17, Scheduler(pipeline_depth=2, "
          "async_delivery=True)")
    fpb = C7_BLOCK_LEN // 256
    n_steps = 2 + 5 * 10 + 4
    H, k, u, llr = config7_llrs(n_steps * fpb)
    c7_kw = dict(pipeline_depth=2, async_delivery=True)
    g, snk = build_config7(llr[: 2 * C7_BLOCK_LEN], "VectorSink")
    gt.Scheduler(g, block_len=C7_BLOCK_LEN, sample_rate=1e9, device=dev,
                 **c7_kw).run_and_wait()
    bits = snk.data()
    check(bits.shape == (2 * fpb * k,), f"config 7 sink shape {bits.shape}")
    n_chk = min(C7_CHECK_FRAMES, 2 * fpb)
    want, _ = ldpc.decode_np(H, llr[: n_chk * 256].reshape(-1, 256), 25)
    same = np.array_equal(bits[: n_chk * k], want[:, :k].reshape(-1))
    raw = float(np.mean((llr[: 2 * C7_BLOCK_LEN].reshape(-1, 256)[:, :k] < 0)
                        != u[: 2 * fpb * k].reshape(-1, k)))
    ber = float(np.mean(bits != u[: 2 * fpb * k]))
    print(f"  card, 2 steps: the first {n_chk} frames' bits equal "
          f"decode_np's: {same}; BER {ber:.3e} against raw {raw:.3e} over "
          f"{2 * fpb} frames")
    check(same, "config 7: decoded bits differ from decode_np")
    out = cpu_vs_card(lambda: (*build_config7(llr[: CPU_STEPS * C7_CPU_BLOCK_LEN],
                                              "VectorSink"), 1e9, None),
                      C7_CPU_BLOCK_LEN, dev, **c7_kw)
    same = np.array_equal(out["cpu"][0], out["card"][0])
    print(f"  cpu vs card at block_len 2^12, {CPU_STEPS} steps: bits equal: {same}")
    check(same, "config 7 card vs CPU")
    g, _ = build_config7(llr, "NullSink")
    sched = gt.Scheduler(g, block_len=C7_BLOCK_LEN, sample_rate=1e9, device=dev,
                         profiler=Profiler(), **c7_kw)
    sched.init()
    sched.fsm.transition_to(gt.State.RUNNING)
    ck.reset_launch_counts()
    for _ in range(2):
        sched._pump_once()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, windows, host_ms, split = drive_windows(sched, 10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    dev_ms, top = profile_device(sched._pump_once)
    finish(sched)
    del sched
    count("config 7", {})
    print(f"  pump split per step: {fmt_split(split)}")
    paths.append(report_path("config 7", C7_BLOCK_LEN,
                             {"ms": ms, "windows": windows, "host_ms": host_ms,
                              "peak_gib": peak, "dev_ms": dev_ms, "top": top},
                             unit="coded Mbit/s"))

    # 17. config 7k, and the two decoder forms at its shape
    print("[17 config 7k] NoiseSource(gaussian) → LdpcDecoder(256, 128) → "
          "NullSink, compiled, block_len 2^19")
    out = cpu_vs_card(lambda: build_suite("7k", "VectorSink", tap_source=True),
                      1 << 13, dev)
    (bits_p, llr_p), (bits_c, llr_c) = out["cpu"], out["card"]
    noise_err = float(np.max(np.abs(llr_c - llr_p) / np.maximum(1.0, np.abs(llr_p))))
    tanner = ldpc.LdpcGraph(H)
    want = ldpc.min_sum_decode(tanner, torch.from_numpy(llr_c.reshape(-1, 256)))[0]
    same = np.array_equal(bits_c, want[:, :k].numpy().astype(np.float32).reshape(-1))
    print(f"  cpu vs card at block_len 2^13, {CPU_STEPS} steps: noise "
          f"max|Δ|/max(1,|x|) {noise_err:.3e} (tol {NOISE_RTOL}); the card's bits "
          f"equal the CPU decoder's on the card's LLRs: {same}; bits differing "
          f"between the two whole runs {int(np.sum(bits_c != bits_p))} of "
          f"{bits_c.size}")
    check(noise_err <= NOISE_RTOL and same, "config 7k card vs CPU")
    x = torch.randn(C7K_BLOCK_LEN // 256, 256, device=dev, generator=gen)
    decode_ms = in_turns("dense", lambda: ldpc.min_sum_decode_dense(tanner, x),
                         "segment", lambda: ldpc.min_sum_decode(tanner, x),
                         f"decoder forms at {C7K_BLOCK_LEN // 256} frames × 25 "
                         f"iterations")
    print(f"  auto on CUDA: dense (faster here: "
          f"{min(decode_ms, key=decode_ms.get)})")
    # Eb/N0 4 dB codewords: both forms twice, against the CPU's segment form
    _, _, u4, llr4 = config7_llrs(C7K_BLOCK_LEN // 256, sigma=SIGMA_4DB, seed=1)
    x4 = torch.from_numpy(llr4.reshape(-1, 256))
    n_cpu = 256
    want, ok_want = ldpc.min_sum_decode(tanner, x4[:n_cpu])
    for name, fn in (("segment", ldpc.min_sum_decode),
                     ("dense", ldpc.min_sum_decode_dense)):
        runs = [fn(tanner, x4.to(dev)) for _ in range(2)]
        repro = all(torch.equal(p.cpu(), q.cpu()) for p, q in zip(*runs))
        hard, ok = (r.cpu() for r in runs[0])
        eq_cpu = torch.equal(hard[:n_cpu], want) and torch.equal(ok[:n_cpu], ok_want)
        ber = float((hard[:, :k].numpy().reshape(-1) != u4).mean())
        print(f"  {name} at 4 dB, {x4.shape[0]} frames: bits and flags equal run to "
              f"run: {repro}; equal to the CPU's on the first {n_cpu} frames: "
              f"{eq_cpu}; {int(ok.sum())} frames pass their syndrome; BER {ber:.3e}")
        check(repro and eq_cpu, f"config 7k {name} form at 4 dB: equal run to "
              f"run {repro}, equal to the CPU {eq_cpu}")
    del x, x4
    t = compiled_path("7k", C7K_BLOCK_LEN, 10, {})
    y = t["last"]["in"]
    check(y.shape == (C7K_BLOCK_LEN // 2,) and bool(((y == 0) | (y == 1)).all()),
          f"config 7k at 2^19: output {tuple(y.shape)}")
    paths.append(report_path("config 7k", C7K_BLOCK_LEN, t, unit="coded Mbit/s"))

    # 18. the Rotator: one nco_mix launch per step, across the 2^32 wrap
    print(f"[18 rotator] ComplexToneSource → Rotator(-3.1 MHz) → NullSink at 20 "
          f"MHz, 2^20 × {ROTATOR_STEPS} steps from phase 2^32 − 12345")
    rot_out = {}
    for key, device in (("cpu", "cpu"), ("card", dev)):
        g = gt.Graph()
        src = g.emplace("ComplexToneSource", frequency=1e6)
        rot = g.emplace("Rotator", frequency_shift=-3.1e6)
        snk = g.emplace("NullSink")
        g.connect_chain(src, rot, snk)
        c = gt.compile_graph(g, block_len=ROTATOR_BLOCK_LEN, sample_rate=C1_FS,
                             device=device)
        st = c.init_states()
        st[rot.unique_name] = torch.tensor((1 << 32) - 12345)
        params = c.gather_params()
        ck.reset_launch_counts()
        ys = []
        for _ in range(ROTATOR_STEPS):
            st, sink_ins = c.step(st, params)
            ys.append(sink_ins[snk.unique_name]["in"].cpu())
        if key == "card":
            count("Rotator", {"nco_mix": ROTATOR_STEPS})
        rot_out[key] = (torch.cat(ys), int(st[rot.unique_name]))
    err = float((rot_out["card"][0] - rot_out["cpu"][0]).abs().max())
    print(f"  card vs cpu: max|Δ| {err:.3e} (tol {NCO_ATOL}); end phase "
          f"{rot_out['card'][1]} vs {rot_out['cpu'][1]}")
    check(err <= NCO_ATOL and rot_out["card"][1] == rot_out["cpu"][1],
          "Rotator card vs CPU")

    # 19. fir_apply's methods on a CUDA tensor: pallas* launch the kernel
    print("[19 fir_apply methods] c64 2^22, 127 real taps, on the card; cuDNN "
          f"allow_tf32 {torch.backends.cudnn.allow_tf32} (PyTorch's default)")
    lp = fd.design_fir("lowpass", 127, sample_rate=C1_FS, f_low=2e6).astype(np.float32)
    x = torch.randn(SUITE_BLOCK_LEN, dtype=torch.complex64, device=dev, generator=gen)
    st0 = torch.randn(126, dtype=torch.complex64, device=dev, generator=gen)
    ck.reset_launch_counts()
    y_p = fir_apply(x, lp, st0, method="pallas")[0]
    y_pi = fir_apply(x, lp, st0, method="pallas_ilv")[0]
    y_pr = fir_apply(x.real, lp, st0.real, method="pallas")[0]
    torch.cuda.synchronize()
    count("fir_apply pallas methods", {"fir_banded": 3})
    y_ref = fir_apply(x, lp, st0, method="matmul")[0]
    y_rr = fir_apply(x.real, lp, st0.real, method="matmul")[0]
    err = float((y_pr - y_rr).abs().max()) / float(y_rr.pow(2).mean().sqrt())
    print(f"  pallas, f32 stream: max|Δ| to matmul {err:.3e}·RMS (tol 1e-5)")
    check(y_pr.shape == y_rr.shape and err <= 1e-5, f"fir_apply pallas f32: {err}")
    scale = float(y_ref.abs().pow(2).mean().sqrt())
    method_ms = {}
    for m, y in (("pallas", y_p), ("pallas_ilv", y_pi), ("conv", None), ("fft", None),
                 ("matmul_ilv", None), ("matmul", y_ref)):
        if y is None:
            y = fir_apply(x, lp, st0, method=m)[0]
        err = float((y - y_ref).abs().max()) / scale
        tol = 1e-4 if m == "fft" else 1e-5
        method_ms[m] = cuda_ms(lambda m=m: fir_apply(x, lp, st0, method=m))
        print(f"  {m}: max|Δ| to matmul {err:.3e}·RMS (tol {tol}); "
              f"{method_ms[m]:.4f} ms")
        check(y.shape == y_ref.shape and err <= tol, f"fir_apply {m} on the card: {err}")
    del x, y_p, y_pi, y_pr, y_ref, y_rr

    # 20. the IFFT's engines, and the FFT's matmul_exact, over 2^22 samples
    print("[20 fft engines] cuFFT against the float32 matmul FFT over 2^22 samples")
    x = torch.randn(SUITE_BLOCK_LEN, dtype=torch.complex64, device=dev, generator=gen)
    ifft_ms = {}
    for n in IFFT_SIZES:
        blocks = {e: gt.global_registry.create("IFFT", fft_size=n, engine=e)
                  for e in ("xla", "matmul_exact")}
        run = {e: (lambda b=b: b.apply(None, {"in": x}, None)[1]["out"])
               for e, b in blocks.items()}
        ya, yb = run["xla"](), run["matmul_exact"]()
        err = float((ya - yb).abs().max() / ya.abs().max())
        check(err <= SPEC_RTOL, f"IFFT {n}: engines differ by {err}")
        ifft_ms[n] = in_turns("cuFFT", run["xla"], "matmul_exact", run["matmul_exact"],
                              f"IFFT {n} (engines max|Δ| {err:.3e} of the peak)")
    xr = x.reshape(-1, 4096)
    err = float((matmul_fft(xr, 4096) - torch.fft.fft(xr)).abs().max()
                / torch.fft.fft(xr).abs().max())
    check(err <= SPEC_RTOL, f"FFT matmul_exact 4096: {err}")
    in_turns("cuFFT", lambda: torch.fft.fft(xr), "matmul_exact",
             lambda: matmul_fft(xr, 4096),
             f"FFT 4096 (max|Δ| {err:.3e} of the peak)")
    print(f"  IFFT auto on CUDA: cuFFT (faster here at {list(IFFT_SIZES)}: "
          f"{[min(v, key=v.get) for v in ifft_ms.values()]})")
    del x, xr
    return paths


def fm_station_waveform(fs: float = FM_FS, seconds: float = 1.0):
    """One second of an FM station's baseband: a 1 kHz tone at 37.5 kHz peak
    deviation (whole cycles, so the loopback's repeat is continuous)."""
    import numpy as np
    t = np.arange(int(fs * seconds)) / fs
    return np.exp(1j * 2 * np.pi * FM_DEV * np.cumsum(np.sin(2 * np.pi * 1e3 * t)) / fs)


def fm_flow(driver: str, sink: str, wav_path: str = "") -> str:
    """examples/fm_receiver.yaml on ``driver``, ending in ``sink``: 'wav' (its
    WavSink writing ``wav_path``) or 'vector' (a VectorSink named wav)."""
    text = (ROOT / "examples" / "fm_receiver.yaml").read_text().replace(
        "driver: loopback", f"driver: {driver}")
    if sink == "wav":
        return text.replace("/tmp/fm_audio.wav", wav_path)
    head, _, _ = text.partition("  - name: wav\n")
    return head + "  - name: wav\n    id: VectorSink\n" + text.partition(
        "connections:")[1] + text.partition("connections:")[2]


def wav_frames(path) -> int:
    import wave
    with wave.open(str(path)) as w:
        return w.getnframes()


def yaml_phases(dev, card: str, phase45, paths: list) -> None:
    """Phase 21: the YAML entry point on the card."""
    import tempfile
    import numpy as np
    import torch
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks.sdr import LoopbackDevice, register_sdr_driver
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_yaml_"))
    try:
        # (a) the chain through save_grc → load_grc, absorbed and derotated
        g, _, _, _ = build_chain("vector")
        text = gt.save_grc(g, sample_rate=FS, block_len=BLOCK_LEN)
        print(f"[21a yaml chain] load_grc(save_grc(chain)) ({len(text)} bytes of "
              f"YAML) at block_len 2^23, {STEPS} steps, absorbed then derotated")
        for absorb, ref, label in ((True, phase45[0], "absorbed"),
                                   (False, phase45[1], "derotated")):
            if absorb:
                os.environ.pop("GR4TPU_NO_ROTATION_ABSORB", None)
            else:
                os.environ["GR4TPU_NO_ROTATION_ABSORB"] = "1"
            try:
                gy = gt.load_grc(text)
                sched = gt.Scheduler(gy, block_len=BLOCK_LEN, sample_rate=FS,
                                     device=dev)
                ck.reset_launch_counts()
                sched.run_and_wait(STEPS)
                torch.cuda.synchronize()
                counts = ck.launch_counts()
            finally:
                os.environ.pop("GR4TPU_NO_ROTATION_ABSORB", None)
            sinks = {b.name: b.data() for b in gy.blocks if b.name in ("spec", "audio")}
            want = {"fir_banded": 2 * STEPS, "nco_mix": 0 if absorb else STEPS}
            print(f"  {label}: launches {counts}")
            check(all(counts[k] == v for k, v in want.items()),
                  f"yaml chain {label}: launches {counts}, expected {want}")
            same = (np.array_equal(sinks["spec"], ref[0])
                    and np.array_equal(sinks["audio"], ref[1]))
            print(f"  {label}: sinks bitwise equal to phase {4 if absorb else 5}: {same}")
            check(same, f"yaml chain {label}: sinks differ from phase {4 if absorb else 5}")
        # timed in turns with the chain built in Python (built, yaml, yaml,
        # built): the step is host-bound and windows drift across a run
        def chain_ms(from_yaml: bool):
            gc = build_chain("null")[0]
            if from_yaml:
                gc = gt.load_grc(gt.save_grc(gc, sample_rate=FS, block_len=BLOCK_LEN))
            sc = gt.Scheduler(gc, block_len=BLOCK_LEN, sample_rate=FS, device=dev)
            for _ in range(3):
                sc.step_once()
            torch.cuda.synchronize()
            return events_ms_per_step(sc.step_once, 20)

        turns = {False: [], True: []}
        for from_yaml in (False, True, True, False):
            turns[from_yaml].append(chain_ms(from_yaml))
        for from_yaml, label in ((True, "yaml chain"), (False, "built chain")):
            ms = statistics.median(m for m, _ in turns[from_yaml])
            msps = BLOCK_LEN / (ms * 1e-3) / 1e6
            print(f"  {label}: {msps:.2f} Msps, {ms:.4f} ms/step (median of 2 runs "
                  f"× 5 windows of 20 steps, in turns, CUDA events; (events ms, "
                  f"wall ms) {[fmt_windows(w) for _, w in turns[from_yaml]]}) on {card}")
            if from_yaml:
                paths.append({"name": "chain from YAML", "msps": msps,
                              "ms_per_step": ms})

        # (b) the CLI as users run it
        print("[21b cli] python -m gnuradio4_tpu_torch run examples/fm_receiver.yaml")
        listed = subprocess.run([sys.executable, "-m", "gnuradio4_tpu_torch", "blocks"],
                                capture_output=True, text=True, timeout=300, cwd=ROOT)
        check(listed.returncode == 0 and listed.stdout.split()
              == gt.global_registry.known_blocks(),
              f"`blocks` lists {listed.stdout.split()[:5]}…: {listed.stderr[-500:]}")
        print(f"  blocks: {len(listed.stdout.split())} types, every registered one")
        for extra, frames in ((["--steps", "16"], 16 * 24000 // 5),
                              (["--block-len", str(FM_BLOCK_LEN), "--steps", "4"],
                               4 * FM_BLOCK_LEN // 5)):
            wav = tmp / "cli.wav"
            flow = tmp / "fm_receiver.yaml"
            flow.write_text(fm_flow("loopback", "wav", str(wav)))
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "gnuradio4_tpu_torch", "run",
                                *extra, str(flow)], capture_output=True, text=True,
                               timeout=600, cwd=ROOT)
            wall = time.perf_counter() - t0
            got = wav_frames(wav) if wav.exists() else -1
            print(f"  run {' '.join(extra)}: rc {r.returncode}, {got} WAV frames "
                  f"(expected {frames}), {wall:.1f} s wall; {r.stderr.strip()[-200:]}")
            check(r.returncode == 0 and got == frames, "the CLI run failed")

        # (c) an FM station from YAML
        wf = fm_station_waveform()
        register_sdr_driver("fmstation", lambda: LoopbackDevice(
            waveform=wf, waveform_freq=100e6))
        print(f"[21c fm station] run_grc(fm_receiver.yaml) on a loopback FM "
              f"station (1 kHz tone at 100 MHz) at block_len {FM_BLOCK_LEN}, 4 steps")
        wav = tmp / "station.wav"
        ck.reset_launch_counts()
        sched = gt.run_grc(fm_flow("fmstation", "wav", str(wav)), n_steps=4,
                           scheduler_kwargs={"block_len": FM_BLOCK_LEN, "device": dev})
        torch.cuda.synchronize()
        counts = ck.launch_counts()
        next(b for b in sched.graph.blocks if b.name == "wav").stop()
        import wave
        with wave.open(str(wav)) as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float64)
        skip = 48000 // 10
        spec = np.abs(np.fft.rfft(pcm[skip:]))
        peak = float(np.fft.rfftfreq(len(pcm) - skip, 1 / 48000)[np.argmax(spec[1:]) + 1])
        print(f"  launches {counts}; {len(pcm)} audio samples, strongest bin "
              f"{peak:.2f} Hz")
        # one launch per step: the audio filter's 65 taps (÷5); the flow's
        # FreqXlatingFir has `taps: []`, one unit tap, a scale in both packages
        check(counts["fir_banded"] == 4,
              f"fm station: fir_banded launched {counts['fir_banded']} times, expected 4")
        check(abs(peak - 1e3) <= 1.0, f"fm station: audio peak at {peak} Hz")
        audio = {}
        for where in ("cpu", dev):
            s = gt.run_grc(fm_flow("fmstation", "vector"), n_steps=2,
                           scheduler_kwargs={"device": where})
            audio[str(where)] = next(b for b in s.graph.blocks if b.name == "wav").data()
        a, b = audio["cpu"], audio[str(dev)]
        err = float(np.max(np.abs(a - b)))
        tol = WBFM_ATOL * max(1.0, float(np.max(np.abs(a))))
        print(f"  card vs cpu at block_len 24000, 2 steps: audio max|Δ| {err:.3e} "
              f"(tol {tol:.3e})")
        check(a.shape == b.shape == (2 * 4800,) and err <= tol,
              "fm station: card and CPU audio disagree")

        # (d) examples/channelizer.yaml with a StreamingPoller
        print("[21d channelizer] examples/channelizer.yaml, 8 steps at block_len "
              "65536, StreamingPoller on channel5_power")
        src = (ROOT / "examples" / "channelizer.yaml").read_text()
        runs = {}
        for where in (dev, "cpu"):
            gc = gt.load_grc(src)
            poller = gt.global_data_sink_registry.get_streaming_poller(
                "channel5_power", max_chunks=64)
            s = gt.Scheduler(gc, block_len=65536, sample_rate=16e6, device=where)
            s.run_and_wait(8)
            uname = {b.name: b.unique_name for b in s.compiled.order}
            key = s._states[uname["wideband"]]
            chunks = poller.read_all()
            runs[str(where)] = (np.concatenate([c.data for c in chunks]),
                                [c.abs_index for c in chunks], key.cpu().numpy())
        (dc, ic, kc), (dg, ig, kg) = runs["cpu"], runs[str(dev)]
        med = float(np.median(dg[2000:]))
        err = float(np.max(np.abs(dc - dg)))
        print(f"  card: {len(ig)} chunks, channel-5 power median {med:.2f} dB; "
              f"threefry keys equal: {np.array_equal(kc, kg)}; card vs cpu max|Δ| "
              f"{err:.3e} dB (tol {CHAN_DB_ATOL})")
        check(med > -10.0 and ig == ic and np.array_equal(kc, kg)
              and err <= CHAN_DB_ATOL, "channelizer.yaml: card and CPU disagree")

        # (e) a checkpoint at full size
        print(f"[21e checkpoint] the chain at 2^23: 2 steps, save_checkpoint, "
              f"load_checkpoint on the card, 2 more steps")
        g, _, _, _ = build_chain("vector")
        s = gt.Scheduler(g, block_len=BLOCK_LEN, sample_rate=FS, device=dev)
        s.run_and_wait(2)
        t0 = time.perf_counter()
        gt.save_checkpoint(s, tmp / "ckpt")
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = gt.load_checkpoint(tmp / "ckpt", device=dev)
        t_load = time.perf_counter() - t0
        for _ in range(2):
            r.step_once()
        r._drain()
        sinks = {b.name: b.data() for b in r.graph.blocks if b.name in ("spec", "audio")}
        half = [x[x.shape[-1] // 2:] for x in phase45[0]]
        same = (np.array_equal(sinks["spec"], half[0])
                and np.array_equal(sinks["audio"], half[1]))
        print(f"  save {t_save:.3f} s, load {t_load:.3f} s; steps 3-4 bitwise equal "
              f"to the uninterrupted run (phase 4): {same}")
        check(same, "checkpoint: resumed steps differ from the uninterrupted run")
        del s, r

        # (f) GraphGRC Get and Set on a running scheduler
        print("[21f GraphGRC] Get from the running chain, Set to suite config 1")
        g, _, _, _ = build_chain("null")
        s = gt.Scheduler(g, block_len=BLOCK_LEN, sample_rate=FS, device=dev)
        s.step_once()

        def ask(command, data=None):
            rid = s.bus.send_command(command, "", gt.Property.GRAPH_GRC, data)
            s._process_messages()
            return next(m for m in s.bus.drain_replies() if m.client_request_id == rid)

        got = ask(gt.Command.Get)
        check(not got.is_error, f"GraphGRC Get: {got.data}")
        back = gt.load_grc(got.data["grc"])
        c1, _, _, _ = build_suite("1", "NullSink")
        reply = ask(gt.Command.Set, {"grc": gt.save_grc(c1)})
        check(not reply.is_error, f"GraphGRC Set: {reply.data}")
        ck.reset_launch_counts()
        for _ in range(2):
            s.step_once()
        torch.cuda.synchronize()
        counts = ck.launch_counts()
        types = sorted(type(b).__name__ for b in s.graph.blocks)
        print(f"  Get: {len(got.data['grc'])} bytes, load_grc gives "
              f"{len(back.blocks)} blocks; Set: {reply.data}; then 2 steps of "
              f"{types}: launches {counts}")
        check(len(back.blocks) == len(g.blocks) and counts["fir_banded"] == 2
              and counts["nco_mix"] == 0, "GraphGRC: config 1 did not run as swapped in")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def count_ops(fn):
    """(kernels launched, torch ops called) by one call of ``fn``, from
    torch.profiler's raw events (``key_averages()`` would take seconds over
    the ~50 000 ops of a loop's step); kernels None when it saw no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = ops = 0
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            kernels += 1
        elif e.name().startswith("aten::"):
            ops += 1
    return (kernels or None), ops


def agc_loop_graph(x, rate: float, delay: int):
    """tests/test_feedback.py's AGC as a graph cycle over a host array."""
    import gnuradio4_tpu_torch as gt
    g = gt.Graph()
    src = g.emplace("VectorSource", data=x)
    mul = g.emplace("Multiply", n_inputs=2)
    upd = g.emplace("ExpressionDISO",
                    expression=f"clip(y + {rate}*(1.0 - abs(x)), 1e-6, 65536.0)")
    snk = gt.global_registry.create("VectorSink")
    g.connect(src, mul["in0"])
    g.connect(mul, upd["x"])
    g.connect(upd["out"], mul["in1"], feedback=True, delay=delay, fb_init=1.0)
    g.connect(upd["out"], upd["y"], feedback=True, delay=delay, fb_init=1.0)
    g.connect(mul, snk)
    return g, snk


def snr_db(y, ref) -> float:
    import numpy as np
    y = np.asarray(y, np.complex128)
    err = float(np.sum(np.abs(y - ref) ** 2))
    return float(10 * np.log10(np.sum(np.abs(ref) ** 2) / max(err, 1e-300)))


def loop_phases(dev, paths: list) -> None:
    """Phase 22: feedback loops, Agc and the precision ladder on the card."""
    import numpy as np
    import torch
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck
    from gnuradio4_tpu_torch.ops import filter_design as fd
    from gnuradio4_tpu_torch.ops.expression import compile_expression
    from gnuradio4_tpu_torch.ops.fir import fir_apply
    from gnuradio4_tpu_torch.ops.precision import rung_dot

    secs = {}                   # wall seconds of each sub-phase
    t_sub = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t_sub
        now = time.perf_counter()
        secs[name] = now - t_sub
        t_sub = now

    # (a) the CLI on the card
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "gnuradio4_tpu_torch", "run",
                        "examples/agc_loop.yaml"], capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT), env=env)
    wall = time.perf_counter() - t0
    print(f"[22a agc_loop cli] python -m gnuradio4_tpu_torch run "
          f"examples/agc_loop.yaml: rc {r.returncode} in {wall:.1f} s wall; "
          f"{r.stderr.strip().splitlines()[-1] if r.stderr.strip() else ''}")
    check(r.returncode == 0 and "device=cuda" in r.stderr,
          f"agc_loop.yaml on the card: rc {r.returncode}: {r.stderr[-2000:]}")
    lap("a cli")

    # (b) the flow through Scheduler, card against CPU, loop against Agc
    text = (ROOT / "examples" / "agc_loop.yaml").read_text()
    runs = {}
    for where in ("cpu", dev):
        s = gt.run_grc(text, n_steps=LOOP_STEPS,
                       scheduler_kwargs={"device": where})
        runs[str(where)] = next(b for b in s.compiled.order
                                if b.name == "audio").data()
        del s
    y_card, y_cpu = runs[str(dev)], runs["cpu"]
    err_cpu = float(np.max(np.abs(y_card - y_cpu) / np.maximum(1.0, np.abs(y_cpu))))
    mean_mag = float(np.mean(np.abs(y_card[-512:])))
    g = gt.Graph()
    nz = g.emplace("NoiseSource", seed=7, std=0.05, n_samples=16384)
    agc = g.emplace("Agc", reference=1.0, rate=0.01)
    ka = gt.global_registry.create("VectorSink")
    g.connect_chain(nz, agc, ka)
    gt.Scheduler(g, block_len=4096, sample_rate=48e3, device=dev).run_and_wait(LOOP_STEPS)
    err_agc = float(np.max(np.abs(ka.data() - y_card)))
    print(f"[22b agc loop] examples/agc_loop.yaml via run_grc, {LOOP_STEPS} steps "
          f"of 4096 (delay 1): card vs cpu max|Δ|/max(1,|y|) {err_cpu:.3e} (tol "
          f"{LOOP_ATOL + NOISE_RTOL:.1e}); graph loop vs Agc block on the card "
          f"max|Δ| {err_agc:.3e} (tol {LOOP_ATOL}); mean |y| over the last 512 "
          f"{mean_mag:.4f}")
    check(y_card.shape == (LOOP_STEPS * 4096,) and err_cpu <= LOOP_ATOL + NOISE_RTOL
          and err_agc <= LOOP_ATOL and 0.8 < mean_mag < 1.2,
          "agc loop: card, CPU and Agc disagree or the loop did not converge")
    # host numbers beside CUDA tensors in every evaluator form
    src_expr = ("var k := 0; for (var i := 0; i < 3; i += 1) { k += i }; "
                "min(x, 0.5) + max(0.25, x) + atan2(x, 2) + hypot(x, 1) "
                "+ if(x > 0, x, 0.5) + mod(x, 0.3) + pow(2, x) + k "
                "+ ((x > 0) and 1 ? 1 : 0) + (not x ? 1 : 0) + clamp(-1, x, 1) "
                "+ sum(x) + (x > 0.5 or 0)")
    fn = compile_expression(src_expr, ("x",))
    xe = torch.linspace(-2, 2, 4097, dtype=torch.float32)
    ye_cpu = fn(x=xe)
    ye_card = fn(x=xe.to(dev)).cpu()
    err_expr = float((ye_card - ye_cpu).abs().max())
    print(f"  expression evaluator, CUDA against CPU tensors: max|Δ| {err_expr:.3e}")
    check(err_expr <= 1e-4, "expression evaluator: card and CPU disagree")
    lap("b loop vs cpu and Agc")

    # (c) delay 64, and the per-step cost of each loop form and of Agc
    rng = np.random.default_rng(SEED)
    x = (0.25 * rng.standard_normal(LOOP_STEPS * 4096)).astype(np.float32)
    out = {}
    for where in ("cpu", dev):
        g, snk = agc_loop_graph(x, 0.5, 64)
        gt.Scheduler(g, block_len=4096, device=where).run_and_wait()
        out[str(where)] = snk.data()
    err64 = float(np.max(np.abs(out[str(dev)] - out["cpu"])))
    mag64 = float(np.mean(np.abs(out[str(dev)][-512:])))
    print(f"[22c delay 64] card vs cpu max|Δ| {err64:.3e} (tol {LOOP_ATOL}); "
          f"mean |y| over the last 512 {mag64:.4f}")
    check(err64 <= LOOP_ATOL and 0.8 < mag64 < 1.2, "delay-64 loop")
    lap("c delay 64")
    for label, build, sub in (
            ("loop delay 1", lambda: agc_loop_graph(x, 0.01, 1)[0], 4096),
            ("loop delay 64", lambda: agc_loop_graph(x, 0.5, 64)[0], 64),
            ("Agc block", None, 0)):
        if build is None:
            g = gt.Graph()
            g.connect_chain(g.emplace("VectorSource", data=x),
                            g.emplace("Agc", reference=1.0, rate=0.01),
                            gt.global_registry.create("NullSink"))
        else:
            g = build()
        s = gt.Scheduler(g, block_len=4096, device=dev, pipeline_depth=1)
        s.init()
        s.step_once()
        torch.cuda.synchronize()
        kernels, ops = count_ops(s.step_once)
        ms, windows = events_ms_per_step(s.step_once, 1, windows=2)
        print(f"  {label}: {sub} sub-steps per step of 4096; {ops} torch ops, "
              f"{kernels if kernels is not None else 'not measured'} kernel "
              f"launches per step (torch.profiler); {ms:.3f} ms/step (CUDA "
              f"events, median of 2 one-step windows; (events ms, wall ms) "
              f"{fmt_windows(windows)})")
        paths.append({"name": f"phase 22 {label}", "ms_per_step": ms,
                      "sub_steps": sub, "torch_ops_per_step": ops,
                      "kernels_per_step": kernels})
        del s
    lap("c per-step cost")

    # (d) the precision ladder: each rung's exact value on the probe, then
    # FirFilter at each rung
    a = torch.full((32, 16), PROBE_C, dtype=torch.float32, device=dev)
    w = torch.full((16, 16), PROBE_C, dtype=torch.float32, device=dev)
    got = {r: rung_dot(a, w, r) for r in PROBE}
    probe = {r: float(y[0, 0]) for r, y in got.items()}
    ok = all(bool((got[r] == v).all()) for r, v in PROBE.items())
    print(f"[22d precision probe] 16·c², c = 1 + 2^-9, on the card: {probe} "
          f"(each rung its exact value: {ok})")
    check(ok, f"precision probe: a rung ran at another precision: {probe}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    c1_taps = fd.design_fir("lowpass", 127, sample_rate=C1_FS,
                            f_low=2e6).astype(np.float32)
    audio_taps = fd.design_fir("lowpass", 63, sample_rate=FS,
                               f_low=1e6).astype(np.float32)
    for label, shape, x_dt, taps, decim in (
            ("config 1 c64 × f32 K 127, 2^22", (SUITE_BLOCK_LEN,),
             torch.complex64, c1_taps, 1),
            ("audio FIR f32 K 63 ÷8, 2^23", (BLOCK_LEN,), torch.float32,
             audio_taps, 8)):
        k = len(taps)
        xs = torch.randn(shape, dtype=x_dt, device=dev, generator=gen)
        hist = torch.randn((k - 1,), dtype=x_dt, device=dev, generator=gen)
        ref = fir_float64(torch.cat([hist, xs]), taps, decim)
        cx = "complex" if xs.is_complex() else "real"
        h = torch.from_numpy(taps).to(dev)
        t_kernel = cuda_ms(lambda: ck.fir_banded(xs, hist, h, decim), reps=5)
        print(f"[22d FirFilter rungs] {label}: fir_banded kernel {t_kernel:.4f} ms")
        # int8's contract was set on white taps (tests/test_fir_methods.py:
        # 111-145); a designed low-pass spends the Toeplitz's one int8 scale
        # on its main lobe, so with these taps the rung is held to the CPU's
        # integer result instead, and a white-tap row to the contract
        white = (np.random.default_rng(SEED).standard_normal(k)
                 / np.sqrt(k)).astype(np.float32)
        y8, _ = fir_apply(xs, white, hist, decim=decim, precision="int8")
        db8 = snr_db(y8.cpu().numpy(), fir_float64(torch.cat([hist, xs]),
                                                   white, decim))
        print(f"  int8 on white taps {db8:7.2f} dB (contract > "
              f"{INT8_DB[cx]:.0f})")
        check(db8 > INT8_DB[cx], f"FIR rung int8 (white taps) at {label}: "
              f"{db8:.2f} dB")
        db_of = {}
        for rung in ("highest", "high", "default", "bf16", "int8"):
            g = gt.Graph()
            blk = gt.global_registry.create("FirFilter", taps=taps, decim=decim,
                                            precision=rung)
            src = gt.global_registry.create("VectorSource",
                                            data=xs.cpu().numpy(),
                                            device_resident=True)
            snk = gt.global_registry.create("VectorSink")
            g.connect_chain(src, blk, snk)
            gt.Scheduler(g, block_len=shape[-1], device=dev).run_and_wait(1)
            y_direct, _ = fir_apply(xs, taps, torch.zeros_like(hist),
                                    decim=decim, precision=rung)
            same = np.array_equal(snk.data(), y_direct.cpu().numpy())
            y, _ = fir_apply(xs, taps, hist, decim=decim, precision=rung)
            db = snr_db(y.cpu().numpy(), ref)
            ms = cuda_ms(lambda: fir_apply(xs, taps, hist, decim=decim,
                                           precision=rung), reps=5)
            db_of[rung] = db
            if rung == "int8":
                xn = xs[:INT8_CPU_N]
                y_n, _ = fir_apply(xn, taps, hist, decim=decim, precision=rung)
                y_cpu, _ = fir_apply(xn.cpu(), taps, hist.cpu(), decim=decim,
                                     precision=rung)
                d = float((y_n.cpu() - y_cpu).abs().max() / y_cpu.abs().max())
                held = (f"card vs CPU on the first 2^{INT8_CPU_N.bit_length() - 1}"
                        f" samples {d:.2e} of the peak (tol 1e-6)")
                ok = d <= 1e-6
            else:
                need = RUNG_DB.get(rung, 90.0)
                top = (db_of["highest"] - HIGH_BELOW_F32_DB if rung == "high"
                       else ONE_PASS_MAX_DB if rung in ("default", "bf16")
                       else float("inf"))
                held = (f"contract {'≥' if rung == 'high' else '>'} {need:.0f}"
                        + (f", ceiling {top:.2f}" if top < float("inf") else ""))
                ok = need <= db < top
            print(f"  {rung:8s} {db:7.2f} dB ({held}); {ms:.4f} ms; FirFilter "
                  f"block equal to fir_apply: {same}")
            paths.append({"name": f"phase 22 FIR {rung} {label}", "snr_db": db,
                          "ms": ms, "fir_banded_ms": t_kernel})
            check(same and ok, f"FIR rung {rung} at {label}: {db:.2f} dB; {held}")
    lap("d FIR rungs")

    # (e) the FFT's matmul engines
    n = 4096
    xf = torch.randn((SUITE_BLOCK_LEN // n, n), dtype=torch.complex64,
                     device=dev, generator=gen)
    ref = np.fft.fft(xf.cpu().numpy().astype(np.complex128), axis=-1)
    from gnuradio4_tpu_torch.ops.fft import MATMUL_ENGINES, matmul_fft
    t_cufft = cuda_ms(lambda: torch.fft.fft(xf, dim=-1), reps=5)
    print(f"[22e FFT engines] 4096-point FFTs over 2^22 samples: cuFFT "
          f"{t_cufft:.4f} ms, {snr_db(torch.fft.fft(xf, dim=-1).cpu().numpy(), ref):.2f} dB")
    db_of = {}
    for eng in ("matmul_exact", "matmul", "matmul_bf16"):
        mode = MATMUL_ENGINES[eng]
        y = matmul_fft(xf, n, mode=mode)
        db = db_of[eng] = snr_db(y.cpu().numpy(), ref)
        ms = cuda_ms(lambda: matmul_fft(xf, n, mode=mode), reps=5)
        top = {"matmul": db_of["matmul_exact"] - HIGH_BELOW_F32_DB,
               "matmul_bf16": ONE_PASS_MAX_DB}.get(eng, float("inf"))
        print(f"  {eng:12s} ({mode}) {db:7.2f} dB (contract ≥ {FFT_DB[eng]:.0f}"
              + (f", ceiling {top:.2f}" if top < float("inf") else "")
              + f"); {ms:.4f} ms")
        paths.append({"name": f"phase 22 FFT {eng}", "snr_db": db, "ms": ms,
                      "cufft_ms": t_cufft})
        check(FFT_DB[eng] <= db < top, f"FFT engine {eng}: {db:.2f} dB")
    lap("e FFT engines")
    print(f"[22 seconds] wall s by sub-phase {({k: round(v, 2) for k, v in secs.items()})}"
          f"; phase 22 {sum(secs.values()):.1f} s")
    paths.append({"name": "phase 22 seconds", "seconds": sum(secs.values()),
                  "by_sub_phase": secs})


def block_step_cost(dev, btype: str, settings: dict, ins: dict):
    """(kernel launches, torch ops, ms) of one ``apply`` of a fresh block of
    ``btype`` on the CUDA tensors ``ins`` from its initial state
    (:func:`block_cost`)."""
    import gnuradio4_tpu_torch as gt
    return block_cost(dev, gt.global_registry.create(btype, **settings), ins)[:3]


def modem_phases(dev, paths: list, results: dict) -> None:
    """Phase 23: the coded link and the digital-modem layer on the card."""
    import numpy as np
    import torch
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks.digital import schmidl_cox_preamble
    from gnuradio4_tpu_torch.core.profiler import Profiler
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck
    from gnuradio4_tpu_torch.ops.digital import make_constellation, rrc_taps

    secs = {}                   # wall seconds of each sub-phase
    t_sub = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t_sub
        now = time.perf_counter()
        secs[name] = now - t_sub
        t_sub = now

    def run(g, block_len: int, steps=None):
        s = gt.Scheduler(g, block_len=block_len, sample_rate=1e6, device=dev)
        s.run_and_wait(steps)
        return s

    # (a) examples/coded_link.yaml as written: run_grc on the card and on the
    # CPU, and the CLI on the card
    text = (ROOT / "examples" / "coded_link.yaml").read_text()
    bits = {}
    for where in (dev, "cpu"):
        s = gt.run_grc(text, scheduler_kwargs={"device": where})
        b = {x.name: x for x in s.graph.blocks}
        bits[str(where)] = (b["tx_bits"].data(), b["rx_bits"].data(), str(s.device))
        del s
    tx, rx, ran_on = bits[str(dev)]
    n = min(len(tx), len(rx))
    equal = n >= 8000 and np.array_equal(tx[:n], rx[:n])
    same_cpu = np.array_equal(rx, bits["cpu"][1])
    print(f"[23a coded_link] run_grc on {ran_on}: {n} bits, tx == rx: {equal}; "
          f"the card's rx_bits equal the CPU's: {same_cpu}")
    check(equal and same_cpu and ran_on.startswith("cuda"),
          "coded_link.yaml: bits differ, or the card and the CPU disagree")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "gnuradio4_tpu_torch", "run",
                        "examples/coded_link.yaml"], capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT), env=env)
    print(f"  python -m gnuradio4_tpu_torch run examples/coded_link.yaml: rc "
          f"{r.returncode} in {time.perf_counter() - t0:.1f} s wall; "
          f"{r.stderr.strip().splitlines()[-1] if r.stderr.strip() else ''}")
    check(r.returncode == 0 and "device=cuda" in r.stderr,
          f"coded_link.yaml by the CLI on the card: rc {r.returncode}: "
          f"{r.stderr[-2000:]}")
    lap("a as written")

    # (b) the coded link at full size: 2^17 LLRs per step, CODED_STEPS steps
    full = text.replace("n_bits: 8192", "n_bits: 0")
    check(full != text, "coded_link.yaml: no 'n_bits: 8192' to lift")
    g = gt.load_grc(full)
    blk = {b.name: b for b in g.blocks}
    s_enc = gt.global_registry.create("VectorSink")
    s_real = gt.global_registry.create("VectorSink")
    g.connect(blk["enc"], s_enc)
    g.connect(blk["real"], s_real)
    ck.reset_launch_counts()
    s = run(g, CODED_BLOCK_LEN, CODED_STEPS)
    counts = ck.launch_counts()
    n_llr = s.compiled.in_len[blk["dec"].unique_name]
    tx, rx = blk["tx_bits"].data(), blk["rx_bits"].data()
    n = min(len(tx), len(rx))
    raw_ber = float(np.mean((s_real.data() < 0) != (s_enc.data() > 0.5)))
    dec_ber = float(np.mean(tx[:n] != rx[:n]))
    # BPSK ±1 under N(0, 0.42²) on the real rail: Q(1/0.42)
    raw_theory = 0.5 * math.erfc(1.0 / (0.42 * math.sqrt(2.0)))
    print(f"[23b coded link, full size] {CODED_STEPS} steps of {CODED_BLOCK_LEN} "
          f"bits, {n_llr} LLRs per step at the decoder; raw BER at the "
          f"channel's output {raw_ber:.5f} (Q(1/0.42) = {raw_theory:.5f}); "
          f"decoded BER {dec_ber:.3e} over {n} bits (bound {CODED_BER_MAX}); "
          f"hand-kernel launches {counts}")
    check(n_llr == C7_BLOCK_LEN and n == CODED_STEPS * CODED_BLOCK_LEN
          and abs(raw_ber - raw_theory) < 0.2 * raw_theory
          and dec_ber <= CODED_BER_MAX,
          "coded link at full size: wrong size, channel or decoded BER")
    del s, g, blk, s_enc, s_real
    g = gt.load_grc(full)
    sched = gt.Scheduler(g, block_len=CODED_BLOCK_LEN, sample_rate=1e6,
                         device=dev, profiler=Profiler())
    sched.init()
    sched.fsm.transition_to(gt.State.RUNNING)
    for _ in range(2):
        sched._pump_once()
    torch.cuda.synchronize()
    ms, windows, host_ms, split = drive_windows(sched, CODED_STEPS, windows=3)
    kernels, ops = count_ops(sched._pump_once)
    dev_ms, top = profile_device(sched._pump_once)
    finish(sched)
    del sched, g
    busy = ("not measured (the profiler saw no device activity)"
            if dev_ms is None else f"{dev_ms:.4f} ms, {dev_ms / ms:.1%} of the step")
    print(f"  {ms:.4f} ms/step ({CODED_BLOCK_LEN / (ms * 1e-3) / 1e6:.2f} Mbit/s of "
          f"data; median of 3 windows of {CODED_STEPS} steps, CUDA events; "
          f"(events ms, wall ms) {fmt_windows(windows)}); host {host_ms:.4f} "
          f"ms/step in the pump ({fmt_split(split)}); {kernels} kernel launches, "
          f"{ops} torch ops per step (torch.profiler); device busy {busy}; top "
          f"kernels {[(round(a, 4), k[:60]) for a, k in top[:4]]}")
    paths.append({"name": "phase 23 coded link", "ms_per_step": ms,
                  "host_ms_per_step": host_ms, "kernels_per_step": kernels,
                  "device_busy_share": None if dev_ms is None else dev_ms / ms,
                  "raw_ber": raw_ber, "decoded_ber": dec_ber})
    lap("b full size")

    # (c) the JAX package's own scenarios, at their test sizes
    # the clean and the noisy QPSK links (tests/test_digital.py:358-392)
    for std in (0.0, 0.45):
        g = gt.Graph()
        src = g.emplace("PrbsSource", order=15, n_bits=65536)
        pk = g.emplace("PackBits", k=2)
        mp = g.emplace("ConstellationMapper", constellation="QPSK")
        dm = g.emplace("ConstellationDemapper", constellation="QPSK")
        up = g.emplace("UnpackBits", k=2)
        ber = g.emplace("BerSink", order=15)
        if std:
            ni = g.emplace("NoiseSource", std=std, seed=1, n_samples=32768)
            nq = g.emplace("NoiseSource", std=std, seed=2, n_samples=32768)
            cx = g.emplace("RealImagToComplex")
            ad = g.emplace("Add", n_inputs=2)
            g.connect(ni, cx["real"])
            g.connect(nq, cx["imag"])
            g.connect(mp, ad["in0"])
            g.connect(cx, ad["in1"])
            g.connect_chain(src, pk, mp)
            g.connect_chain(ad, dm, up, ber)
        else:
            g.connect_chain(src, pk, mp, dm, up, ber)
        run(g, 8192)
        rep = ber.report()
        ok = (rep["synced"] and rep["bits"] == 65536 and rep["errors"] == 0
              if not std else rep["synced"] and 0.04 < rep["ber"] < 0.08)
        print(f"[23c QPSK link, AWGN σ {std}/rail] BerSink {rep}")
        check(ok, f"QPSK link at σ {std}: {rep}")
    lap("c BER links")

    # RRC + MMSymbolSync on a half-symbol delay (tests/test_digital.py:119)
    rng = np.random.default_rng(SEED)
    sps, n_sym = RRC_MM["sps"], 8192
    syms = rng.integers(0, 4, n_sym).astype(np.int32)
    up = np.zeros(n_sym * sps, np.complex64)
    up[::sps] = make_constellation("QPSK")[syms] * sps
    g = gt.Graph()
    snk = g.emplace("VectorSink")
    g.connect_chain(g.emplace("VectorSource", data=up),
                    g.emplace("RrcFilter", **RRC_MM),
                    g.emplace("Delay", delay=2),
                    g.emplace("RrcFilter", **RRC_MM),
                    g.emplace("MMSymbolSync", sps=sps, gain=0.05),
                    g.emplace("ConstellationDemapper", constellation="QPSK"), snk)
    ck.reset_launch_counts()
    s = run(g, RRC_BLOCK_LEN)
    counts = ck.launch_counts()
    out = snk.data()
    best = max(float(np.mean(out[2000:7000][:5000] == syms[2000 - k:7000 - k]))
               for k in range(8, 16))
    print(f"[23c RRC + MMSymbolSync] {n_sym} symbols at block_len 4096: decisions "
          f"agree with the sent symbols at the best alignment: {best:.4f} "
          f"(> 0.995); launches {counts} over {s._step} steps (two RrcFilters)")
    check(best > 0.995, f"MMSymbolSync: {best}")
    check(counts == {**{k: 0 for k in KERNELS}, "fir_banded": 2 * s._step},
          f"RrcFilter: launches {counts}, expected 2 per step over {s._step}")
    results["fir_banded"]["launches"] += counts["fir_banded"]
    del s
    lap("c RRC + MM")

    # PfbClockSync at a 0.73-sample delay and 10 ppm drift (:177)
    nsym = 8192
    ph = np.random.default_rng(0).integers(0, 4, nsym)
    ups = np.zeros(nsym * 4, complex)
    ups[::4] = np.exp(1j * (np.pi / 4 + np.pi / 2 * ph))
    shaped = np.convolve(ups, rrc_taps(4, 45, beta=0.35))[: nsym * 4]
    f = np.fft.fftfreq(len(shaped))
    rxs = np.fft.ifft(np.fft.fft(shaped) * np.exp(-2j * np.pi * f * 0.73))
    t = np.arange(len(rxs)) * (1.0 + 1e-5)
    rxs = (np.interp(t, np.arange(len(rxs)), rxs.real)
           + 1j * np.interp(t, np.arange(len(rxs)), rxs.imag)).astype(np.complex64)
    g = gt.Graph()
    snk = g.emplace("VectorSink")
    g.connect_chain(g.emplace("VectorSource", data=rxs),
                    g.emplace("PfbClockSync", sps=4, rolloff=0.35), snk)
    run(g, 4096)
    y = snk.data()
    tail = y[len(y) // 2:]
    ang = np.angle(tail * np.exp(-1j * np.pi / 4))
    err_deg = float(np.degrees(np.abs(((ang + np.pi / 4) % (np.pi / 2)) - np.pi / 4).mean()))
    mag = np.abs(tail)
    print(f"[23c PfbClockSync] τ 0.73, drift 1e-5, {nsym} symbols: |y| mean "
          f"{mag.mean():.4f} (1 ± 0.1), std {mag.std():.4f} (< 0.1), phase "
          f"error {err_deg:.2f}° (< 5)")
    check(len(y) == nsym and abs(mag.mean() - 1.0) < 0.1 and mag.std() < 0.1
          and err_deg < 5.0, "PfbClockSync did not lock")
    lap("c PfbClockSync")

    # 16 packets through AWGN, every CRC ok (:402)
    pb, nframes = 512, 16
    fsyms = 63 + 8 + pb // 2 + 16
    pbits = np.random.default_rng(7).integers(0, 2, nframes * pb).astype(np.int32)
    g = gt.Graph()
    fr = g.emplace("PacketFramer", payload_bits=pb)
    ni = g.emplace("NoiseSource", std=0.05, seed=1, n_samples=nframes * fsyms)
    nq = g.emplace("NoiseSource", std=0.05, seed=2, n_samples=nframes * fsyms)
    cx = g.emplace("RealImagToComplex")
    ad = g.emplace("Add", n_inputs=2)
    cor = g.emplace("PreambleCorrelator", preamble=fr.preamble, threshold=0.6,
                    max_detections=32)
    prx = g.emplace("PacketReceiver")
    g.connect(ni, cx["real"])
    g.connect(nq, cx["imag"])
    g.connect_chain(g.emplace("VectorSource", data=pbits), fr)
    g.connect(fr, ad["in0"])
    g.connect(cx, ad["in1"])
    g.connect(ad, cor)
    g.connect(cor["out"], prx["in"])
    g.connect(cor["det"], prx["det"])
    run(g, fsyms * 4)
    ok = [p for p in prx.packets if p["ok"]]
    sent = {pbits[i * pb:(i + 1) * pb].tobytes() for i in range(nframes)}
    print(f"[23c packets] {len(prx.packets)} packets, {len(ok)} CRC-ok, each "
          f"equal to a sent frame: {all(p['bits'].tobytes() in sent for p in ok)}")
    check(len(ok) == nframes and all(p["bits"].tobytes() in sent for p in ok),
          "packet link: not every frame decoded with its CRC")
    lap("c packets")

    # OFDM through AWGN (:53), Schmidl & Cox timing and CFO (:468)
    n_occ, fft, cp = 48, 64, 16
    osyms = np.random.default_rng(3).integers(0, 4, n_occ * 128).astype(np.int32)
    g = gt.Graph()
    mod = g.emplace("OfdmModulator", fft_size=fft, cp_len=cp, n_occupied=n_occ)
    add = g.emplace("Add", n_inputs=2)
    snk = g.emplace("VectorSink")
    g.connect_chain(g.emplace("VectorSource", data=osyms),
                    g.emplace("ConstellationMapper", constellation="QPSK"), mod)
    g.connect(mod, add["in0"])
    g.connect(g.emplace("NoiseSource", noise="complex_gaussian", std=0.05,
                        n_samples=128 * (fft + cp)), add["in1"])
    g.connect_chain(add, g.emplace("OfdmDemodulator", fft_size=fft, cp_len=cp,
                                   n_occupied=n_occ),
                    g.emplace("ConstellationDemapper", constellation="QPSK"), snk)
    run(g, n_occ * 32)
    errors = int(np.count_nonzero(snk.data() != osyms))
    fft, cp = 256, 32
    pre = schmidl_cox_preamble(fft, cp)
    rng = np.random.default_rng(1)
    sig = ((rng.standard_normal(16384) + 1j * rng.standard_normal(16384)) * 0.05
           ).astype(np.complex64)
    for o in (3000, 9000):
        sig[o:o + len(pre)] += pre
    sig = (sig * np.exp(2j * np.pi * 0.3 * np.arange(16384) / fft)).astype(np.complex64)
    g = gt.Graph()
    sync = g.emplace("OfdmSync", fft_size=fft, cp_len=cp, threshold=0.6)
    det = g.emplace("OfdmSyncSink")
    g.connect(g.emplace("VectorSource", data=sig), sync)
    g.connect(sync["out"], g.emplace("NullSink")["in"])
    g.connect(sync["det"], det["in"])
    run(g, 4096)
    dets = det.detections
    sc_ok = len(dets) == 2 and all(o <= i <= o + cp and m > 0.9 and abs(c - 0.3) < 0.02
                                   for (i, m, c), o in zip(dets, (3000, 9000)))
    print(f"[23c OFDM] QPSK-OFDM through σ 0.05 AWGN: {errors} symbol errors of "
          f"{len(osyms)}; Schmidl & Cox detections {dets}")
    check(errors == 0 and sc_ok, "OFDM link or Schmidl & Cox sync failed")
    lap("c OFDM")

    # CmaEqualizer opening the eye (tests/test_equalizer.py:22)
    ph = np.random.default_rng(0).integers(0, 4, 32768)
    qs = np.exp(1j * (np.pi / 4 + np.pi / 2 * ph)).astype(np.complex64)
    chan = np.array([1.0, 0.35 * np.exp(1j * 0.9), 0.18 * np.exp(-1j * 1.7)],
                    np.complex64)
    isi = np.convolve(qs, chan)[:len(qs)].astype(np.complex64)
    g = gt.Graph()
    snk = g.emplace("VectorSink")
    g.connect_chain(g.emplace("VectorSource", data=isi),
                    g.emplace("CmaEqualizer", num_taps=11, gain=0.01), snk)
    run(g, 8192)
    tail = snk.data()[-8192:]
    print(f"[23c CmaEqualizer] |y| std {np.std(np.abs(isi)):.4f} before, "
          f"{np.std(np.abs(tail)):.4f} after (< 0.08); mean {np.abs(tail).mean():.4f}")
    check(np.std(np.abs(tail)) < 0.08 and abs(np.abs(tail).mean() - 1.0) < 0.1,
          "CmaEqualizer did not open the eye")
    lap("c CMA")

    # ChannelModel statistics (tests/test_channels.py:28-62)
    def through(data, block_len, **settings):
        g = gt.Graph()
        snk = g.emplace("VectorSink")
        g.connect_chain(g.emplace("VectorSource", data=data),
                        g.emplace("ChannelModel", **settings), snk)
        run(g, block_len)
        return snk.data()

    ones = np.ones(200_000, np.complex64)
    nz = through(ones, 65536, noise_voltage=0.5) - 1.0
    corr = float(np.mean(nz[1:] * np.conj(nz[:-1])).real / np.var(nz.real) / 2)
    y = through(ones, 65536, frequency_offset=0.01)
    fo = np.angle(y[1:] * np.conj(y[:-1])) / (2 * np.pi)
    imp = np.zeros(64, np.complex64)
    imp[5] = 1.0
    yi = through(imp, 32, taps=(1.0, 0.5j, -0.25))
    xr = np.random.default_rng(0)
    xs = (xr.standard_normal(4096) + 1j * xr.standard_normal(4096)).astype(np.complex64)
    seam = float(np.max(np.abs(through(xs, 4096, taps=(1.0, -0.3 + 0.2j, 0.1j))
                               - through(xs, 256, taps=(1.0, -0.3 + 0.2j, 0.1j)))))
    a7 = through(ones, 65536, noise_voltage=0.3, seed=7)
    same7 = np.array_equal(a7, through(ones, 65536, noise_voltage=0.3, seed=7))
    diff8 = not np.array_equal(a7, through(ones, 65536, noise_voltage=0.3, seed=8))
    ok = (abs(np.std(nz.real) - 0.5) < 0.01 and abs(np.std(nz.imag) - 0.5) < 0.01
          and abs(np.mean(nz)) < 0.01 and abs(corr) < 0.02
          and abs(np.mean(fo) - 0.01) <= 1e-6 and np.max(np.abs(np.diff(fo))) < 1e-4
          and np.allclose(yi[5:8], [1.0, 0.5j, -0.25], atol=1e-6)
          and np.abs(yi[:5]).max() < 1e-6 and np.abs(yi[8:]).max() < 1e-6
          and seam <= 1e-5 and same7 and diff8)
    print(f"[23c ChannelModel] AWGN std {np.std(nz.real):.4f}/{np.std(nz.imag):.4f} "
          f"(0.5), neighbour correlation {corr:.4f}; CFO mean {np.mean(fo):.8f} "
          f"(0.01), max step {np.max(np.abs(np.diff(fo))):.2e}; impulse response "
          f"{np.round(yi[5:8], 6)}; seams max|Δ| {seam:.2e}; seed 7 repeats: "
          f"{same7}, seed 8 differs: {diff8}")
    check(ok, "ChannelModel statistics")
    lap("c ChannelModel")

    # each scan block's cost per step, at its scenario's step size
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    cx = lambda n: torch.randn(n, dtype=torch.complex64, device=dev, generator=gen)
    for btype, settings, ins in (
            ("MMSymbolSync", {"sps": 4, "gain": 0.05}, {"in": cx(4096)}),
            ("PfbClockSync", {"sps": 4, "rolloff": 0.35}, {"in": cx(4096)}),
            ("OfdmChannelEqualizer", {"smoothing": 0.5}, {"in": cx(48 * 128)}),
            ("CmaEqualizer", {"num_taps": 11, "gain": 0.01}, {"in": cx(8192)}),
            ("SampleAndHold", {}, {"in": cx(8192).real.contiguous(),
                                   "ctrl": cx(8192).real.contiguous()}),
            ("PacketFramer", {"payload_bits": 512},
             {"in": torch.randint(0, 2, (4 * 512,), dtype=torch.int32,
                                  device=dev, generator=gen)})):
        kernels, ops, ms = block_step_cost(dev, btype, settings, ins)
        n_in = next(iter(ins.values())).shape[-1]
        print(f"[23c scan cost] {btype} on {n_in} samples: {kernels} kernel "
              f"launches, {ops} torch ops, {ms:.3f} ms per step")
        paths.append({"name": f"phase 23 {btype}", "samples": n_in,
                      "kernels_per_step": kernels, "torch_ops_per_step": ops,
                      "ms_per_step": ms})
    lap("c scan costs")

    # (d) fir_banded at RrcFilter's shapes: c64 × f32 ÷1, a K−1 history
    for r_sps, k, beta, t_len in RRC_SHAPES:
        h = torch.from_numpy(rrc_taps(r_sps, k, beta=beta).astype(np.float32)).to(dev)
        x = cx(t_len)
        hist = cx(k - 1)
        y = ck.fir_banded(x, hist, h, 1)
        err = float((y - ck.fir_banded_ref(x, hist, h, 1)).abs().max())
        k_ms, p_ms = kernel_vs_plain_ms(lambda: ck.fir_banded(x, hist, h, 1),
                                        lambda: ck.fir_banded_ref(x, hist, h, 1))
        b_ms, b_by = bound_ms(*fir_work((t_len,), True, False, k, 1))
        lib = conv1d_ms(x, hist, h, 1)
        print(f"[23d fir_banded, RrcFilter's shape] c64 × f32 K {k} (β {beta}) ÷1 "
              f"T {t_len}: max|Δ| {err:.3e} (tol {FIR_ATOL}); kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
              f"{b_ms / k_ms:.1%} of it; F.conv1d (TF32 off) {lib:.4f} ms")
        check(err <= FIR_ATOL, f"fir_banded at RrcFilter's K {k} T {t_len}: {err}")
        results["fir_banded"]["max_abs_err"] = max(
            results["fir_banded"]["max_abs_err"], err)
        paths.append({"name": f"phase 23 fir_banded RrcFilter K {k} T {t_len}",
                      "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib})
    lap("d fir_banded")
    print(f"[23 seconds] wall s by sub-phase {({k: round(v, 2) for k, v in secs.items()})}"
          f"; phase 23 {sum(secs.values()):.1f} s")
    paths.append({"name": "phase 23 seconds", "seconds": sum(secs.values()),
                  "by_sub_phase": secs})


def build_capstone(repeat: bool = False):
    """tests/test_acceptance.py:74's FM broadcast: one FM carrier with the
    stereo multiplex and 57 kHz RDS, split after the ÷2 FIR into
    FmStereoDecoder and the RDS arm (FreqXlatingFir(241, ÷24) → CostasLoop →
    MMSymbolSync → RdsDecoder). Returns (graph, left sink, right sink,
    decoder, number of samples)."""
    import numpy as np
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks import rds
    from gnuradio4_tpu_torch.ops.filter_design import design_fir
    dev_hz = 75000.0
    wave = rds.modulate_mpx(rds.make_0a_groups(0x52A1, 9, "GR4-TPU!") * 4, fs=CAP_FS)
    t = np.arange(len(wave)) / CAP_FS
    left, right = np.sin(2 * np.pi * 800.0 * t), np.sin(2 * np.pi * 1400.0 * t)
    th = 2 * np.pi * 19000.0 * t
    mpx = (0.20 * (left + right) + 0.1 * np.sin(th)
           + 0.20 * (left - right) * np.sin(2 * th) + 0.08 * wave)
    tx = np.exp(1j * 2 * np.pi * np.cumsum(dev_hz * mpx) / CAP_FS).astype(np.complex64)
    reg = gt.global_registry
    g = gt.Graph()
    lp = reg.create("FirFilter", decim=2, taps=tuple(design_fir(
        "lowpass", 121, sample_rate=CAP_FS, f_low=80000.0).tolist()))
    st = reg.create("FmStereoDecoder", sample_rate_in=228000.0)
    kl, kr = reg.create("VectorSink"), reg.create("VectorSink")
    dec = reg.create("RdsDecoder")
    g.connect_chain(reg.create("VectorSource", data=tx, repeat=repeat),
                    reg.create("QuadratureDemod", gain=CAP_FS / (2 * np.pi * dev_hz)), lp)
    g.connect(lp["out"], st["in"])
    g.connect(st["left"], kl["in"])
    g.connect(st["right"], kr["in"])
    cvt = reg.create("Convert", to="complex64")
    g.connect(lp["out"], cvt["in"])
    g.connect_chain(cvt, reg.create("FreqXlatingFir", center_freq=57000.0, decim=24,
                                    f_cut=2400.0, ntaps=241),
                    reg.create("CostasLoop", order=2, loop_bw=0.01),
                    reg.create("MMSymbolSync", sps=4, gain=0.05), dec)
    return g, kl, kr, dec, len(tx)


def carrier_phases(dev, paths: list, results: dict) -> None:
    """Phase 24: carrier and timing recovery, the RDS receiver and the
    terminal spectrum analyzer on the card."""
    import numpy as np
    import torch
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.core.profiler import Profiler
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck
    from gnuradio4_tpu_torch.ops.signal import phase_increment

    def xlat_dphi(b) -> int:
        """The mixer increment of a FreqXlatingFir after its run."""
        return int(phase_increment(-float(b.settings.get("center_freq")),
                                   b._fs(b._fs_cached)))

    secs = {}
    t_sub = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t_sub
        now = time.perf_counter()
        secs[name] = now - t_sub
        t_sub = now

    # (a) examples/rds_receiver.yaml through run_grc, the JAX test's 60 steps
    text = (ROOT / "examples" / "rds_receiver.yaml").read_text()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    s = gt.run_grc(text, n_steps=RDS_STEPS, scheduler_kwargs={"device": dev})
    wall = time.perf_counter() - t0
    counts = ck.launch_counts()
    blk = {b.name: b for b in s.graph.blocks}
    n_carrier = s.compiled.in_len[blk["carrier"].unique_name]
    dec = blk["rds"]
    # the shape at which the flow launched fir_banded, with the block's own
    # taps, for (e): (label, stream complex, taps, decim, T, nco_mix's
    # increment before the FIR or None)
    chan = blk["channel"]
    fir_shapes = [("rds_receiver.yaml's channel filter", True, chan._taps_array(),
                   int(chan.settings.get("decim")),
                   s.compiled.in_len[chan.unique_name], xlat_dphi(chan))]
    print(f"[24a rds_receiver.yaml] run_grc on {s.device}, {RDS_STEPS} steps of "
          f"{s.compiled.in_len[blk['channel'].unique_name]} samples ({n_carrier} "
          f"into CostasLoop per step) in {wall:.2f} s wall ({wall / RDS_STEPS * 1e3:.1f} "
          f"ms/step); PI {dec.pi:#06x}, PS {dec.ps!r}, radiotext {dec.radiotext!r}, "
          f"{len(dec.groups)} groups; hand-kernel launches {counts}")
    check(str(s.device).startswith("cuda") and dec.pi == 0x52A1 and dec.ps == "GR4-TPU!"
          and dec.radiotext == "HELLO FROM THE TPU SIDE" and len(dec.groups) > 100,
          "rds_receiver.yaml on the card: wrong decode")
    check(counts["nco_mix"] == counts["fir_banded"] == RDS_STEPS,
          f"rds_receiver.yaml: expected {RDS_STEPS} nco_mix and fir_banded launches")
    for k in ("nco_mix", "fir_banded"):
        results[k]["launches"] += counts[k]
    paths.append({"name": "phase 24 rds_receiver.yaml", "steps": RDS_STEPS,
                  "wall_ms_per_step": wall / RDS_STEPS * 1e3, "groups": len(dec.groups)})
    del s, blk, dec
    # the card's CostasLoop against the port on the CPU, on the card's own
    # channel-filter output over RDS_CHECK_STEPS steps
    g = gt.load_grc(text)
    blk = {b.name: b for b in g.blocks}
    tap_in, tap_out = gt.global_registry.create("VectorSink"), gt.global_registry.create("VectorSink")
    g.connect(blk["channel"], tap_in)
    g.connect(blk["carrier"], tap_out)
    gt.Scheduler(g, block_len=1 << 16, sample_rate=1.0, device=dev).run_and_wait(RDS_CHECK_STEPS)
    xin, ycard = tap_in.data(), tap_out.data()
    g2 = gt.Graph()
    snk = gt.global_registry.create("VectorSink")
    g2.connect_chain(gt.global_registry.create("VectorSource", data=xin),
                     gt.global_registry.create("CostasLoop", order=2, loop_bw=0.01), snk)
    gt.Scheduler(g2, block_len=n_carrier, sample_rate=1.0, device="cpu").run_and_wait(
        RDS_CHECK_STEPS)
    ycpu = snk.data()
    d = np.abs(ycard.astype(np.complex128) - ycpu)
    rel = float(np.max(d / np.maximum(1.0, np.abs(ycpu))))
    print(f"  CostasLoop, card against the CPU on the card's filter output: "
          f"{len(ycard)} samples, max|Δ|/max(1,|y|) {rel:.3e} (tol {LOOP_SAMPLE_ATOL})")
    check(ycard.shape == ycpu.shape == (RDS_CHECK_STEPS * n_carrier,)
          and rel <= LOOP_SAMPLE_ATOL, "CostasLoop card vs CPU")
    del g, g2
    lap("a rds_receiver")

    # (b) the capstone at its own sizes: stereo + RDS from one FM carrier
    g, kl, kr, dec, n = build_capstone()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    sched = gt.Scheduler(g, block_len=CAP_BLOCK_LEN, sample_rate=CAP_FS, device=dev)
    sched.run_and_wait()
    wall = time.perf_counter() - t0
    counts = ck.launch_counts()
    yl, yr = kl.data(), kr.data()

    def tone(y, f0):
        seg = y[65536:65536 + 131072] * np.hanning(131072)
        spec = np.abs(np.fft.rfft(seg))
        return spec[np.argmin(np.abs(np.fft.rfftfreq(131072, 1 / 228000.0) - f0))]
    sep_l = 20 * np.log10(tone(yl, 800) / (tone(yl, 1400) + 1e-12))
    sep_r = 20 * np.log10(tone(yr, 1400) / (tone(yr, 800) + 1e-12))
    steps = sched._step
    print(f"[24b FM stereo + RDS capstone] {n} IF samples, {steps} steps of "
          f"{CAP_BLOCK_LEN} in {wall:.2f} s wall; separation L {sep_l:.1f} dB, "
          f"R {sep_r:.1f} dB; PI {dec.pi:#06x}, PS {dec.ps!r}, {len(dec.groups)} "
          f"groups; hand-kernel launches {counts}")
    check(sep_l > 40 and sep_r > 40 and dec.pi == 0x52A1 and dec.ps == "GR4-TPU!"
          and len(dec.groups) >= 12, "capstone on the card")
    # fir_banded: the ÷2 FirFilter, FmStereoDecoder's four FIRs, the RDS
    # channel filter; nco_mix: the RDS channel filter's mixer
    check(counts["nco_mix"] == steps and counts["fir_banded"] == 6 * steps,
          "capstone: expected one nco_mix and six fir_banded launches per step")
    for k in ("nco_mix", "fir_banded"):
        results[k]["launches"] += counts[k]
    # each of those six FIRs' shape and designed taps, as the run used them
    by_type = {type(b).__name__: b for b in g.blocks}
    in_len = lambda b: sched.compiled.in_len[b.unique_name]
    lp, st, xl = (by_type[k] for k in ("FirFilter", "FmStereoDecoder", "FreqXlatingFir"))
    lp15, bp19c, bp38 = st._filters(st._flt_fs)
    t_lp, t_st = in_len(lp), in_len(st)
    fir_shapes += [("the capstone's ÷2 FirFilter", False, lp._taps_array(),
                    int(lp.settings.get("decim")), t_lp, None),
                   ("FmStereoDecoder's L+R/L−R low-pass", False, lp15, 1, t_st, None),
                   ("FmStereoDecoder's 38 kHz band-pass", False, bp38, 1, t_st, None),
                   ("FmStereoDecoder's analytic pilot filter", True, bp19c, 1, t_st, None),
                   ("the capstone's RDS channel filter", True, xl._taps_array(),
                    int(xl.settings.get("decim")), in_len(xl), xlat_dphi(xl))]
    del sched, g
    g, _, _, _, _ = build_capstone(repeat=True)
    sched = gt.Scheduler(g, block_len=CAP_BLOCK_LEN, sample_rate=CAP_FS, device=dev,
                         profiler=Profiler())
    sched.init()
    sched.fsm.transition_to(gt.State.RUNNING)
    for _ in range(2):
        sched._pump_once()
    torch.cuda.synchronize()
    ms, windows, host_ms, split = drive_windows(sched, CAP_STEPS, windows=3)
    kernels, ops = count_ops(sched._pump_once)
    dev_ms, top = profile_device(sched._pump_once)
    finish(sched)
    del sched, g
    busy = ("not measured (the profiler saw no device activity)"
            if dev_ms is None else f"{dev_ms:.4f} ms, {dev_ms / ms:.1%} of the step")
    print(f"  {ms:.4f} ms/step (median of 3 windows of {CAP_STEPS} steps, CUDA "
          f"events; (events ms, wall ms) {fmt_windows(windows)}); host {host_ms:.4f} "
          f"ms/step in the pump ({fmt_split(split)}); {kernels} kernel launches, "
          f"{ops} torch ops per step (torch.profiler); device busy {busy}; top "
          f"kernels {[(round(a, 4), k[:60]) for a, k in top[:4]]}")
    paths.append({"name": "phase 24 capstone", "ms_per_step": ms,
                  "host_ms_per_step": host_ms, "kernels_per_step": kernels,
                  "torch_ops_per_step": ops,
                  "device_busy_share": None if dev_ms is None else dev_ms / ms,
                  "separation_db": [sep_l, sep_r], "groups": len(dec.groups)})
    lap("b capstone")

    # (c) examples/spectrum_analyzer.yaml, the scope muted; then the CLI's
    # run --draw on a non-TTY stdout
    text = (ROOT / "examples" / "spectrum_analyzer.yaml").read_text()
    muted = text.replace("{window: 2048, refresh_every: 4}",
                         "{window: 2048, refresh_every: 4, stream: none}")
    check(muted != text, "spectrum_analyzer.yaml: no scope settings to mute")
    s = gt.run_grc(muted, n_steps=SPECTRUM_STEPS, scheduler_kwargs={"device": dev})
    mon = {b.name: b for b in s.graph.blocks}["scope"]
    frame = mon._hist.view()[-2048:][:1024]
    k1, k2 = round(100e3 / 1e6 * 2048), round(230e3 / 1e6 * 2048)
    p1 = int(np.argmax(frame))
    p2 = int(np.argmax(np.where(np.abs(np.arange(1024) - k1) > 8, frame, -1e9)))
    ddb = float(frame[k1] - frame[k2])
    print(f"[24c spectrum_analyzer.yaml] {SPECTRUM_STEPS} steps on {s.device}: "
          f"{mon._renders} renders; peaks at bins {p1}, {p2} (expected {k1}, {k2}), "
          f"{ddb:.3f} dB apart (20·log10(4) = {20 * np.log10(4.0):.3f})")
    check(str(s.device).startswith("cuda") and mon._renders >= 1 and p1 == k1
          and p2 == k2 and abs(ddb - 20 * np.log10(4.0)) < 0.5,
          "spectrum_analyzer.yaml on the card")
    del s, mon
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "gnuradio4_tpu_torch", "run",
                        "examples/spectrum_analyzer.yaml", "--steps",
                        str(SPECTRUM_STEPS), "--draw"], capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT), env=env)
    tail = r.stdout[r.stdout.rfind("── scope "):] if "── scope " in r.stdout else ""
    print(f"  python -m gnuradio4_tpu_torch run examples/spectrum_analyzer.yaml "
          f"--steps {SPECTRUM_STEPS} --draw: rc {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s wall, {r.stdout.count('── scope ')} frames; "
          f"last line {tail.rstrip().splitlines()[-1] if tail else None!r}; "
          f"{r.stderr.strip().splitlines()[-1] if r.stderr.strip() else ''}")
    check(r.returncode == 0 and tail.rstrip().endswith(f"[STOPPED] step {SPECTRUM_STEPS}")
          and any("\u2800" < ch <= "\u28ff" for ch in tail)
          and "device=cuda" in r.stderr,
          f"run --draw on the card: rc {r.returncode}: {r.stderr[-2000:]}")
    lap("c spectrum analyzer")

    # (d) each new device block's cost per step, at its JAX test's size
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    cx = lambda n: torch.randn(n, dtype=torch.complex64, device=dev, generator=gen)
    rx = lambda n: torch.randn(n, dtype=torch.float32, device=dev, generator=gen)
    for btype, settings, ins in (
            ("CostasLoop", {"order": 2, "loop_bw": 0.05}, {"in": cx(4096)}),
            ("CostasLoop", {"order": 4, "loop_bw": 0.05}, {"in": cx(4096)}),
            ("PllCarrierTracking", {"loop_bw": 0.02}, {"in": cx(16384)}),
            ("FllBandEdge", {"loop_bw": 0.05}, {"in": cx(8192)}),
            ("GoertzelDetector", {"frequency": 941.0, "chunk": 1024,
                                  "sample_rate_in": 8000.0}, {"in": rx(2048)}),
            ("CtcssSquelch", {"frequency": 88.5, "sample_rate_in": 48000.0},
             {"in": rx(4096)}),
            ("SnrEstimator", {"chunk": 512, "alpha": 0.9}, {"in": cx(2048)}),
            ("FarrowResampler", {"rate": 0.75}, {"in": rx(8000)}),
            ("PowerSquelch", {"threshold_db": -20.0, "alpha": 0.01}, {"in": cx(4096)}),
            ("CoarseFrequencyCorrector", {"order": 4}, {"in": cx(8192)}),
            ("IqImbalanceCorrector", {"alpha": 0.4}, {"in": cx(8192)})):
        kernels, ops, ms = block_step_cost(dev, btype, settings, ins)
        n_in = next(iter(ins.values())).shape[-1]
        label = btype + (f" order {settings['order']}" if "order" in settings else "")
        print(f"[24d step cost] {label} on {n_in} samples: {kernels} kernel launches "
              f"({(kernels or 0) / n_in:.2f} per sample), {ops} torch ops, "
              f"{ms:.3f} ms per step")
        paths.append({"name": f"phase 24 {label}", "samples": n_in,
                      "kernels_per_step": kernels, "torch_ops_per_step": ops,
                      "ms_per_step": ms})
    lap("d step costs")

    # (e) fir_banded at every shape (a) and (b) launched it with, on the taps
    # the blocks designed; where the block is the RDS channel filter, nco_mix
    # first at its increment, and the FIR on the mixed stream
    for label, x_cx, taps_np, decim, t_len, dphi in fir_shapes:
        taps = torch.from_numpy(np.ascontiguousarray(taps_np)).to(dev)
        k = taps.shape[0]
        x = cx(t_len) if x_cx else rx(t_len)
        hist = cx(k - 1) if x_cx else rx(k - 1)
        if dphi is not None:
            y, ph = ck.nco_mix(x, 12345, dphi)
            y_ref, ph_ref = ck.nco_mix_ref(x, 12345, dphi)
            err = float((y - y_ref).abs().max())
            k_ms, p_ms = kernel_vs_plain_ms(lambda: ck.nco_mix(x, 12345, dphi),
                                            lambda: ck.nco_mix_ref(x, 12345, dphi))
            b_ms, b_by = bound_ms(6.0 * t_len, 16.0 * t_len)
            print(f"[24e nco_mix, {label}] c64 T {t_len}: max|Δ| {err:.3e} (tol "
                  f"{NCO_ATOL}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by}), {b_ms / k_ms:.1%} of it")
            check(err <= NCO_ATOL and ph == ph_ref, f"nco_mix, {label}: {err}")
            results["nco_mix"]["max_abs_err"] = max(results["nco_mix"]["max_abs_err"], err)
            paths.append({"name": f"phase 24 nco_mix {label} T {t_len}", "ms": k_ms,
                          "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": None})
            x = y
        yf = ck.fir_banded(x, hist, taps, decim)
        err = float((yf - ck.fir_banded_ref(x, hist, taps, decim)).abs().max())
        k_ms, p_ms = kernel_vs_plain_ms(lambda: ck.fir_banded(x, hist, taps, decim),
                                        lambda: ck.fir_banded_ref(x, hist, taps, decim))
        b_ms, b_by = bound_ms(*fir_work((t_len,), x_cx, taps.is_complex(), k, decim))
        lib = conv1d_ms(x, hist, taps, decim)
        kind = f"{'c64' if x_cx else 'f32'} × {'c64' if taps.is_complex() else 'f32'}"
        print(f"[24e fir_banded, {label}] {kind} K {k} ÷{decim} T {t_len}: max|Δ| "
              f"{err:.3e} (tol {FIR_ATOL}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}), {b_ms / k_ms:.1%} of it; F.conv1d "
              f"(TF32 off) {lib:.4f} ms")
        check(err <= FIR_ATOL, f"fir_banded, {label}: {err}")
        results["fir_banded"]["max_abs_err"] = max(results["fir_banded"]["max_abs_err"], err)
        paths.append({"name": f"phase 24 fir_banded {label} {kind} K {k} ÷{decim} "
                              f"T {t_len}", "ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
    lap("e kernels")
    print(f"[24 seconds] wall s by sub-phase {({k: round(v, 2) for k, v in secs.items()})}"
          f"; phase 24 {sum(secs.values()):.1f} s")
    paths.append({"name": "phase 24 seconds", "seconds": sum(secs.values()),
                  "by_sub_phase": secs})


def acquisition_chain(fs: float, cycles: int, interpolation: str, *,
                      n_samples: int, gate_sink: str, tap: bool = False,
                      savgol: bool = True):
    """qa_TriggerBlocks' timeline (tests/test_trigger_blocks_golden.py:23) as
    an acquisition chain: ClockSource (CMD_BP_START at k + {0, 0.1, 0.4, 0.5,
    0.8} s, contexts P=0..4, per cycle k) → FunctionGenerator(clk_in) with the
    qa's five per-context segments → SavitzkyGolayFilter(31, 3) →
    SchmittTrigger(0.6 ± 0.1, pass, MY_RISING_EDGE / MY_FALLING_EDGE tags) →
    {StreamToDataSet([MY_RISING_EDGE, MY_FALLING_EDGE]) ; TriggerGate(
    CMD_BP_START, n_post fs/20) → DataSink(``gate_sink``) ; a sink recording
    the edge tags' positions, and with ``tap`` a VectorSink of the Schmitt
    block's output}; without ``savgol`` the generator feeds the Schmitt
    block, as in the qa. Returns (graph, blocks by role)."""
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks.misc import (ClockSource, FunctionGenerator,
                                                 SchmittTrigger)
    from gnuradio4_tpu_torch.core.block import Port, SinkBlock
    from gnuradio4_tpu_torch.core.settings import SettingsCtx
    from gnuradio4_tpu_torch.core.tags import Keys

    class EdgeTagSink(SinkBlock):
        """The edge tags' absolute positions (index + offset·fs), without
        the samples (no device→host copy)."""
        IN = (Port("in"),)
        WANTS_HOST_DATA = False
        CONSUME_IGNORES_DATA = True

        def __init__(self):
            super().__init__(name="edges")
            self.edges: list[tuple[str, float]] = []

        def consume(self, arrays, tags, n_valid, abs_index):
            for t in tags.get("in", []):
                name = t.map.get(Keys.TRIGGER_NAME)
                if name in ("MY_RISING_EDGE", "MY_FALLING_EDGE"):
                    self.edges.append((name, abs_index + t.index
                                       + t.map[Keys.TRIGGER_OFFSET] * fs))

    reg = gt.global_registry
    g = gt.Graph()
    times = [k + dt for k in range(cycles) for dt in ACQ_TAG_TIMES]
    clock = ClockSource(sample_rate=fs, n_samples=n_samples, tag_times=times,
                        tag_values=[{Keys.TRIGGER_NAME: "CMD_BP_START",
                                     Keys.CONTEXT: c} for c in ACQ_CTX * cycles])
    fg = FunctionGenerator(sample_rate=fs, start_value=0.1)
    for c, seg in zip(ACQ_CTX, (
            {"signal_type": "Const", "start_value": 0.1},
            {"signal_type": "ParabolicRamp", "start_value": 0.1,
             "final_value": 1.1, "duration": 0.3, "round_off_time": 0.02},
            {"signal_type": "Const", "start_value": 1.1},
            {"signal_type": "ParabolicRamp", "start_value": 1.1,
             "final_value": 0.1, "duration": 0.3, "round_off_time": 0.02},
            {"signal_type": "Const", "start_value": 0.1})):
        fg.settings.set(seg, ctx=SettingsCtx(context=c))
    blk = {"sg": reg.create("SavitzkyGolayFilter", window=31, poly_order=3),
           "schmitt": SchmittTrigger(
               threshold=0.1, offset=0.6, output="pass",
               trigger_name_rising_edge="MY_RISING_EDGE",
               trigger_name_falling_edge="MY_FALLING_EDGE",
               interpolation=interpolation),
           "s2d": reg.create("StreamToDataSet",
                             filter="[MY_RISING_EDGE, MY_FALLING_EDGE]",
                             sample_rate_hint=fs),
           "gate": reg.create("TriggerGate", filter="CMD_BP_START",
                              n_post=int(fs / 20)),
           "gated": reg.create("DataSink", signal_name=gate_sink),
           "edges": EdgeTagSink()}
    g.connect(clock, fg, dst_port="clk_in")
    if savgol:
        g.connect_chain(fg, blk["sg"], blk["schmitt"], blk["s2d"])
    else:
        g.connect_chain(fg, blk["schmitt"], blk["s2d"])
    g.connect_chain(blk["schmitt"], blk["gate"], blk["gated"])
    g.connect(blk["schmitt"], blk["edges"])
    if tap:
        blk["tap"] = reg.create("VectorSink")
        g.connect(blk["schmitt"], blk["tap"])
    return g, blk


def gate_mask(fs: float, cycles: int, n: int):
    """True on the fs/20 samples after each CMD_BP_START tag of the chain."""
    import numpy as np
    mask = np.zeros(n, bool)
    for k in range(cycles):
        for t in ACQ_TAG_TIMES:
            i = int(round((k + t) * fs))
            mask[i:i + int(fs / 20)] = True
    return mask


def drain_poller(poller):
    """Every chunk a StreamingPoller holds, joined."""
    import queue
    import numpy as np
    parts = []
    while True:
        try:
            parts.append(np.asarray(poller.q.get_nowait().data))
        except queue.Empty:
            return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def check_acquisition(label: str, blk, gated, fs: float, cycles: int,
                      delay: int = SG_DELAY):
    """The chain's edges (one rising and one falling per cycle, at 0.25 s
    and 0.65 s plus the S-G delay, each within EDGE_SAMPLES), its DataSets
    (one per cycle, 0.4 s ± DS_SAMPLES) and its gate (the fs/20 samples after
    each CMD_BP_START tag pass, every other sample is zero). Returns (edges,
    DataSets)."""
    import numpy as np
    edges = blk["edges"].edges
    want = [(name, (k + t) * fs + delay) for k in range(cycles)
            for name, t in (("MY_RISING_EDGE", 0.25), ("MY_FALLING_EDGE", 0.65))]
    err = [p - w for (_, p), (_, w) in zip(edges, want)]
    dsets = blk["s2d"].read_all()
    lens = [ds.values.shape[-1] for ds in dsets]
    mask = gate_mask(fs, cycles, gated.shape[-1])
    gate_ok = gated.shape[-1] == cycles * int(round(fs)) and \
        np.array_equal(gated != 0, mask)
    print(f"  {label}: edges {[(n[3:-5].lower(), round(p, 3)) for n, p in edges]} "
          f"(want ± {EDGE_SAMPLES}: off by {[round(e, 3) for e in err]} samples); "
          f"DataSets of {lens} samples (want {0.4 * fs:.0f} ± {DS_SAMPLES}); gate "
          f"{int(np.count_nonzero(gated))} of {gated.shape[-1]} samples nonzero, "
          f"the pattern of the {len(ACQ_TAG_TIMES) * cycles} windows: {gate_ok}")
    check([n for n, _ in edges] == [n for n, _ in want]
          and all(abs(e) <= EDGE_SAMPLES for e in err), f"{label}: edges {edges}")
    check(len(dsets) == cycles and all(abs(n - 0.4 * fs) <= DS_SAMPLES for n in lens),
          f"{label}: DataSets {lens}")
    check(gate_ok, f"{label}: gate pattern")
    return edges, dsets


def block_cost(dev, blk, ins: dict, n_out: int | None = None,
               sample_rate: float = 1e6):
    """(kernel launches seen by torch.profiler, torch ops, ms, hand-kernel
    launches by their wrappers' counts) of one ``apply`` of ``blk`` on the
    CUDA tensors ``ins`` from its initial state: its params from
    ``prepare_params``, each 2-D input's leading axis as its channels,
    ``n_out`` samples out of a source. Launches and ops by
    :func:`count_ops`, ms by CUDA events (median of 2 calls)."""
    import numpy as np
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck
    n = n_out if n_out is not None else next(iter(ins.values())).shape[-1]
    ctx = gt.BlockCtx(in_len={k: v.shape[-1] for k, v in ins.items()},
                      out_len={p.name: n for p in blk.out_ports},
                      sample_rate=sample_rate, params={},
                      channels={k: v.shape[0] if v.ndim == 2 else 0
                                for k, v in ins.items()},
                      dtypes={k: np.dtype(str(v.dtype).split(".")[-1])
                              for k, v in ins.items()}, device=dev)
    ctx.params = blk.prepare_params(blk.settings.dynamic_params())
    state = blk.init_state(ctx)
    step = lambda: blk.apply(state, ins, ctx)
    step()
    ck.reset_launch_counts()
    kernels, ops = count_ops(step)
    hand = sum(ck.launch_counts().values())
    ms, _ = events_ms_per_step(step, 1, windows=2)
    return kernels, ops, ms, hand


def acquisition_phases(dev, card: str, paths: list, results: dict) -> None:
    """Phase 25: trigger-driven acquisition on the card."""
    import numpy as np
    import torch
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.core.profiler import Profiler
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck

    secs = {}
    t_sub = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t_sub
        now = time.perf_counter()
        secs[name] = now - t_sub
        t_sub = now

    # (a) qa_TriggerBlocks' own timeline at 1 kHz (no S-G filter), in steps
    # of 100, with each interpolation: the card's edge tags equal the CPU's
    # (the generator's ramps are bit for bit), and sit where the qa puts them
    for method in ("none", "basic_linear", "regression", "polynomial"):
        got = {}
        for key, device in (("card", dev), ("cpu", "cpu")):
            g, blk = acquisition_chain(1000.0, 1, method, n_samples=1000,
                                       gate_sink=f"acq_qa_{method}_{key}",
                                       savgol=False)
            gt.Scheduler(g, block_len=100, sample_rate=1000.0,
                         device=device).run_and_wait()
            got[key] = blk["edges"].edges
        want = (278.0, 678.0) if method == "none" else (250.0, 650.0)
        print(f"[25a qa timeline, {method}] edges on the card {got['card']}, equal "
              f"to the CPU's: {got['card'] == got['cpu']} (qa: {want} ± 2)")
        check(got["card"] == got["cpu"] and len(got["card"]) == 2
              and all(abs(p - w) <= 2 for (_, p), w in zip(got["card"], want)),
              f"qa timeline {method}: {got}")
    lap("a qa timeline")

    # the chain at full width: 20 steps of 2^22 at 41.94 MS/s. The edges
    # interpolate by least squares over the band (regression): at this rate
    # the ramp moves ~8.5e-8 a sample, over float32's ulp at 0.6 (6.0e-8),
    # so basic_linear's two-sample extrapolation from the band's edge to its
    # middle (0.1 away, ~1.2e6 samples) is off by up to ~6e5 samples
    n_total = ACQ_STEPS * ACQ_BLOCK_LEN
    g, blk = acquisition_chain(ACQ_FS, 2, "regression", n_samples=n_total,
                               gate_sink="acq_gate_full")
    poller = gt.global_data_sink_registry.get_streaming_poller(
        "acq_gate_full", max_chunks=4 * ACQ_STEPS)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    sched = gt.Scheduler(g, block_len=ACQ_BLOCK_LEN, sample_rate=ACQ_FS, device=dev)
    sched.run_and_wait()
    wall = time.perf_counter() - t0
    counts = ck.launch_counts()
    steps = sched._step
    print(f"[25a acquisition chain] ClockSource → FunctionGenerator → "
          f"SavitzkyGolayFilter(31, 3) → SchmittTrigger(regression) → "
          f"{{StreamToDataSet, TriggerGate → DataSink}} at {ACQ_FS / 1e6:.4f} MS/s, "
          f"{steps} steps of {ACQ_BLOCK_LEN} on {sched.device} in {wall:.2f} s wall; "
          f"hand-kernel launches {counts}")
    gated = drain_poller(poller)
    check_acquisition("full width", blk, gated, ACQ_FS, 2)
    check(counts["fir_banded"] == steps >= ACQ_STEPS,
          "acquisition chain: one fir_banded launch (the S-G filter) per step")
    for k in KERNELS:
        results[k]["launches"] += counts[k]
    sg_taps, sg_launches = blk["sg"]._taps(), counts["fir_banded"]
    del sched, g, blk, gated
    lap("a chain")

    # the same chain, timed: windows of 4 steps by CUDA events after 2 warm-up
    # steps (three cycles of tags cover the 24 steps it runs)
    g, blk = acquisition_chain(ACQ_FS, 3, "regression", n_samples=0,
                               gate_sink="acq_gate_timed")
    sched = gt.Scheduler(g, block_len=ACQ_BLOCK_LEN, sample_rate=ACQ_FS,
                         device=dev, profiler=Profiler())
    sched.init()
    sched.fsm.transition_to(gt.State.RUNNING)
    for _ in range(2):
        sched._pump_once()
    torch.cuda.synchronize()
    ms, windows, host_ms, split = drive_windows(sched, 4, windows=5)
    kernels, ops = count_ops(sched._pump_once)
    dev_ms, top = profile_device(sched._pump_once)
    finish(sched)
    del sched, g, blk
    msps = ACQ_BLOCK_LEN / (ms * 1e-3) / 1e6
    deliver = split.get("scheduler.deliver", 0.0)
    print(f"  {card}: {msps:.2f} Msps, {ms:.4f} ms per step (median of 5 windows of 4 "
          f"steps, CUDA events; (events ms, wall ms) {fmt_windows(windows)}); host "
          f"{host_ms:.4f} ms/step in the pump ({fmt_split(split)}), "
          f"scheduler.deliver {deliver / host_ms:.1%} of it; {kernels} kernel "
          f"launches and {ops} torch ops per step")
    if dev_ms is None:
        print("  torch.profiler: no device activity recorded (not measured)")
        busy = None
    else:
        busy = dev_ms / ms
        print(f"  torch.profiler, one step: device busy {dev_ms:.4f} ms, {busy:.1%} "
              f"of the step; top kernels (ms) {[(round(t, 4), k) for t, k in top]}")
    paths.append({"name": "phase 25 acquisition chain", "msps": msps,
                  "ms_per_step": ms, "host_ms_per_step": host_ms,
                  "deliver_ms_per_step": deliver, "kernels_per_step": kernels,
                  "torch_ops_per_step": ops, "busy": busy})
    lap("a timed")

    # the chain at 2^16 a step on the card and on the CPU (regression edges:
    # at this rate basic_linear's extrapolation moves an edge by up to ~190
    # samples for one ulp): the Schmitt block's input (tapped) within
    # FIR_ATOL, the edge positions within that difference over the input's
    # slope per sample, the DataSets within FIR_ATOL where their spans
    # overlap, the gate's pattern equal and its samples within FIR_ATOL
    n_check = ACQ_STEPS * ACQ_CHECK_BLOCK_LEN
    out = {}
    for key, device in (("card", dev), ("cpu", "cpu")):
        g, blk = acquisition_chain(ACQ_CHECK_FS, 2, "regression",
                                   n_samples=n_check, gate_sink=f"acq_gate_{key}",
                                   tap=True)
        poller = gt.global_data_sink_registry.get_streaming_poller(
            f"acq_gate_{key}", max_chunks=4 * ACQ_STEPS)
        ck.reset_launch_counts()
        sched = gt.Scheduler(g, block_len=ACQ_CHECK_BLOCK_LEN,
                             sample_rate=ACQ_CHECK_FS, device=device)
        sched.run_and_wait()
        if key == "card":
            sg_check = (blk["sg"]._taps(), ck.launch_counts()["fir_banded"],
                        sched._step)
        gated = drain_poller(poller)
        edges, dsets = check_acquisition(f"{ACQ_CHECK_FS / 1e3:.2f} kS/s on the {key}",
                                         blk, gated, ACQ_CHECK_FS, 2)
        out[key] = (np.asarray(blk["tap"].data()), edges, dsets, gated)
        del sched, g, blk
    (xc, ec, dc, gc), (xp, ep, dp, gp) = out["card"], out["cpu"]
    dx = float(np.max(np.abs(xc.astype(np.float64) - xp)))
    slope = min(abs(float(xp[int(p) + 1]) - float(xp[int(p)])) for _, p in ep)
    pos_tol = dx / slope + 1e-6
    dpos = max(abs(a - b) for (_, a), (_, b) in zip(ec, ep))
    same_index = [int(a) == int(b) for (_, a), (_, b) in zip(ec, ep)]
    ds_err = 0.0
    for a, b, (_, pa), (_, pb) in zip(dc, dp, ec[::2], ep[::2]):
        ra, rb = int(pa), int(pb)
        lo, hi = max(ra, rb), min(ra + a.values.shape[-1], rb + b.values.shape[-1])
        ds_err = max(ds_err, float(np.max(np.abs(
            a.values[0, lo - ra:hi - ra].astype(np.float64)
            - b.values[0, lo - rb:hi - rb]))))
    gate_err = float(np.max(np.abs(gc.astype(np.float64) - gp)))
    print(f"  card against the CPU: the Schmitt input max|Δ| {dx:.3e} (tol {FIR_ATOL}); "
          f"edge positions max|Δ| {dpos:.3e} samples (tol {pos_tol:.3e}: that Δ over "
          f"the slope {slope:.3e} per sample), "
          f"equal in index {same_index}; DataSets max|Δ| {ds_err:.3e}; gate "
          f"pattern equal {np.array_equal(gc != 0, gp != 0)}, max|Δ| {gate_err:.3e}")
    check(dx <= FIR_ATOL and dpos <= pos_tol and ds_err <= FIR_ATOL
          and np.array_equal(gc != 0, gp != 0) and gate_err <= FIR_ATOL,
          "acquisition chain: card against the CPU")
    check(sg_check[1] == sg_check[2] >= ACQ_STEPS,
          "2^16 chain: one fir_banded launch per step")
    results["fir_banded"]["launches"] += sg_check[1]
    paths.append({"name": "phase 25 chain card vs CPU", "schmitt_in_err": dx,
                  "edge_pos_err": dpos, "edge_pos_tol": pos_tol,
                  "dataset_err": ds_err, "gate_err": gate_err})
    del out, xc, xp, gc, gp
    lap("a card vs CPU")

    # (b) each other new block at its JAX test's step, card against CPU, and
    # its launches, torch ops and ms per step
    b_results = {}

    def versus(label, build, block_len, fs=1.0, steps=None, tol=None, exact=False):
        """Run ``build()`` → (graph, {name: reader}) on the card and on the
        CPU; every reader's arrays equal (``exact``) or within ``tol`` of
        max(1, |y|) (a callable of the CPU's array, or a number)."""
        got = {}
        for key, device in (("card", dev), ("cpu", "cpu")):
            g, readers = build()
            sched = gt.Scheduler(g, block_len=block_len, sample_rate=fs,
                                 device=device)
            sched.run_and_wait(steps)
            got[key] = {n: np.asarray(r()) for n, r in readers.items()}
            got[key + "_steps"] = sched._step
        worst = 0.0
        for n, want in got["cpu"].items():
            have = got["card"][n]
            check(have.shape == want.shape, f"{label} {n}: shape {have.shape} vs {want.shape}")
            if exact:
                check(np.array_equal(have, want), f"{label} {n}: not bit-equal")
                continue
            lim = tol(want) if callable(tol) else tol
            d = np.abs(have.astype(np.complex128) - want)
            rel = float(np.max(d / np.maximum(1.0, np.abs(want)))) if d.size else 0.0
            worst = max(worst, rel)
            check(rel <= lim, f"{label} {n}: {rel:.3e} > {lim:.3e}")
        b_results[label] = "bit-equal" if exact else worst
        return got

    reg = gt.global_registry
    rng = np.random.default_rng(SEED + 25)

    def source_chain(btype, settings, x=None, tags=(), n_out=1):
        def build():
            g = gt.Graph()
            b = reg.create(btype, **settings)
            sinks = [reg.create("VectorSink") for _ in range(n_out)]
            if x is not None:
                g.connect(reg.create("VectorSource", data=x, tags=[
                    gt.Tag(i, {"trigger_name": nm}) for i, nm in tags]), b)
            for i, snk in enumerate(sinks):
                g.connect(b if n_out == 1 else b[f"out{i}"], snk)
            return g, {f"out{i}": snk.data for i, snk in enumerate(sinks)}
        return build

    for mode in ("Const", "LinearRamp", "CubicSpline", "ParabolicRamp",
                 "ImpulseResponse", "Sin", "Cos", "FastSin", "FastCos",
                 "UniformNoise", "TriangularNoise", "GaussianNoise"):
        settings = dict(signal_type=mode, start_value=0.5, final_value=2.0,
                        duration=1.0, round_off_time=0.2, impulse_time0=0.2,
                        impulse_time1=0.3, frequency=50.0, seed=1,
                        n_samples=2000, sample_rate=1000.0)
        tone = mode in ("Sin", "Cos", "FastSin", "FastCos")
        exact = mode not in ("GaussianNoise",) and not tone
        # a tone's sines differ by up to one ulp of its float32 phase
        # (2π·50·2 s ≈ 628 rad), times the amplitude 2
        tol = (F32_ATOL + 2.0 * float(np.spacing(np.float32(2 * np.pi * 100.0)))
               if tone else NOISE_RTOL)
        versus(f"FunctionGenerator {mode}", source_chain("FunctionGenerator", settings),
               500, fs=1000.0, exact=exact, tol=tol)
    fs_fe = 10000.0
    t = np.arange(8192)
    real_tone = np.sin(2 * np.pi * 1234.0 * t / fs_fe).astype(np.float32)
    cx_tone = (np.exp(2j * np.pi * -1875.25 * t / fs_fe)
               + 0.01 * (rng.standard_normal(8192) + 1j * rng.standard_normal(8192))
               ).astype(np.complex64)
    for method in ("fft", "zero_crossing", "period"):
        for name, x in (("real", real_tone), ("complex", cx_tone)):
            versus(f"FrequencyEstimator {method} {name}",
                   source_chain("FrequencyEstimator", {"chunk": 1024, "method": method},
                                x), 2048, fs=fs_fe, tol=F32_ATOL)
    noisy = (np.sin(2 * np.pi * 4 * np.arange(1024) / 256.0)
             + 0.2 * rng.standard_normal(1024)).astype(np.float32)
    for engine in ("xla", "jacobi"):
        versus(f"SvdDenoiser {engine}", source_chain(
            "SvdDenoiser", {"chunk": 256, "window": 24, "rank": 2, "engine": engine},
            noisy), 512, tol=SVD_ATOL * float(np.abs(noisy).max()))
    ones = np.ones(2048, np.complex64) * (1 + 0.5j)
    versus("BurstTaper", source_chain(
        "BurstTaper", {"ramp_len": 32}, ones,
        tags=[(100, "burst_start"), (500, "burst_stop"), (1000, "burst_start"),
              (1030, "burst_stop")]), 1024, tol=F32_ATOL)
    noise_c = (rng.standard_normal(3072) + 1j * rng.standard_normal(3072)).astype(np.complex64)
    versus("StreamFilter", source_chain(
        "StreamFilter", {"filter": "A", "filter_stop": "B"}, noise_c,
        tags=[(10, "A"), (300, "B"), (900, "A"), (1800, "B"), (2100, "A")]),
        1024, exact=True)

    def sync_block():
        g = gt.Graph()
        base = np.arange(2048, dtype=np.float32)
        a = reg.create("VectorSource", data=base, tags=[gt.Tag(100, {"trigger_name": "s"})])
        b = reg.create("VectorSource", data=np.concatenate([np.zeros(7, np.float32),
                                                            base[:-7]]),
                       tags=[gt.Tag(107, {"trigger_name": "s"})])
        sync = reg.create("SyncBlock", n_inputs=2, max_skew=64)
        s0, s1 = reg.create("VectorSink"), reg.create("VectorSink")
        g.connect(a, sync["in0"])
        g.connect(b, sync["in1"])
        g.connect(sync["out0"], s0)
        g.connect(sync["out1"], s1)
        return g, {"out0": s0.data, "out1": s1.data}
    versus("SyncBlock", sync_block, 512, exact=True)

    def sync_sink():
        g = gt.Graph()
        snk = reg.create("SyncSink", n_ports=2, tolerance=3)
        vals = [[1, 0, 1, 2, 3, 0, 1, 2, 3, 4, 0, 1],
                [1, 2, 0, 1, 2, 3, 4, 0, 1, 2, 3, 0, 1, 2]]
        times = [[(1, 100), (5, 200), (10, 300)], [(2, 101), (7, 199), (11, 302)]]
        for p in range(2):
            g.connect(reg.create("VectorSource", data=np.asarray(vals[p], np.float32),
                                 tags=[gt.Tag(i, {"trigger_name": "T", "trigger_time": tt})
                                       for i, tt in times[p]]), snk[f"in{p}"])
        return g, {"p0": lambda: snk.data(0), "p1": lambda: snk.data(1)}
    versus("SyncSink", sync_sink, 5, exact=True)
    ramp = np.arange(50, dtype=np.float32)
    qa = [(5, "A"), (10, "B"), (15, "A"), (20, "B")]

    def host_sink(btype, settings, x, tags, reader):
        def build():
            g = gt.Graph()
            snk = reg.create(btype, **settings)
            g.connect(reg.create("VectorSource", data=x, tags=[
                gt.Tag(i, {"trigger_name": nm}) for i, nm in tags]), snk)
            return g, {"out": lambda: reader(snk)}
        return build
    versus("StreamFilterSink", host_sink("StreamFilterSink", {"filter": "[A, B]"},
                                         ramp, qa, lambda s: s.data()), 16, exact=True)
    xs = rng.standard_normal(4096).astype(np.float32)
    versus("DataSetSink", host_sink("DataSetSink", {"n_length": 1000}, xs, (),
                                    lambda s: np.stack([d.values for d in s.read_all()])),
           700, exact=True)
    versus("SavitzkyGolayDataSetFilter", host_sink(
        "SavitzkyGolayDataSetFilter", {"n_length": 1000, "window_size": 21,
                                       "poly_order": 3}, xs, (),
        lambda s: np.stack([d.values for d in s.read_all()])), 700, exact=True)

    uv_taps = (np.hanning(15) / 7.0).astype(np.float32)

    def uncertain(n, op_chain):
        v = rng.standard_normal(n).astype(np.float32)
        sigma = rng.uniform(0.1, 1, n).astype(np.float32)

        def build():
            g = gt.Graph()
            sv = reg.create("VectorSource", data=v)
            ss = reg.create("VectorSource", data=sigma)
            tu, fu = reg.create("ToUncertain"), reg.create("FromUncertain")
            g.connect(sv, tu, dst_port="in")
            g.connect(ss, tu, dst_port="sigma")
            g.connect_chain(tu, *op_chain(), fu)
            kv, ks = reg.create("VectorSink"), reg.create("VectorSink")
            g.connect(fu["value"], kv)
            g.connect(fu["sigma"], ks)
            return g, {"value": kv.data, "sigma": ks.data}
        return build
    ck.reset_launch_counts()
    got = versus("uncertain FirFilter → MultiplyConst", uncertain(4096, lambda: (
        reg.create("FirFilter", taps=tuple(uv_taps), uncertain=True),
        reg.create("MultiplyConst", value=2.0, value_sigma=0.1, uncertain=True))),
        1024, tol=FIR_ATOL)
    unc_counts = ck.launch_counts()["fir_banded"]
    check(unc_counts == 2 * got["card_steps"] >= 8,
          f"uncertain FirFilter: two fir_banded launches per step, not {unc_counts} "
          f"in {got['card_steps']} steps")
    versus("uncertain IirFilter", uncertain(512, lambda: (
        reg.create("IirFilter", b=(0.2,), a=(1.0, -0.8), uncertain=True),)),
        256, tol=F32_ATOL)
    fs_pm, n_pm, d_pm = 10000.0, 20000, 2000
    tt = np.arange(n_pm) / fs_pm
    u_ = (325.0 * np.sin(2 * np.pi * 50 * tt)).astype(np.float32)
    i_ = (14.1 * np.sin(2 * np.pi * 50 * tt - 0.2)).astype(np.float32)

    def electrical():
        g = gt.Graph()
        pm, pf = reg.create("PowerMetrics", decim=d_pm), reg.create("PowerFactor")
        for port, data in (("u", u_), ("i", i_), ("u_sigma", np.full(n_pm, 3.25, np.float32)),
                           ("i_sigma", np.full(n_pm, 0.141, np.float32))):
            g.connect(reg.create("VectorSource", data=data), pm[port])
        for port in ("p", "s", "p_sigma", "s_sigma"):
            g.connect(pm[port], pf[port])
        readers = {}
        for blk_, port in ((pm, "p"), (pm, "q"), (pm, "u_rms_sigma"),
                           (pf, "power_factor"), (pf, "power_factor_sigma")):
            snk = reg.create("VectorSink")
            g.connect(blk_[port], snk)
            readers[port] = snk.data
        return g, readers
    versus("PowerMetrics → PowerFactor", electrical, 2 * d_pm, fs=fs_pm, tol=F32_ATOL)
    three = {k: (v + rng.uniform(-1, 1, (3, 64))).astype(np.float32)
             for k, v in (("u_rms", 230.0), ("i_rms", 10.0), ("p", 2300.0))}

    def unbalance():
        g = gt.Graph()
        su = reg.create("SystemUnbalance")
        for port, data in three.items():
            g.connect(reg.create("VectorSource", data=data), su[port])
        readers = {}
        for port in ("u_unbalance", "i_unbalance", "p_total"):
            snk = reg.create("VectorSink")
            g.connect(su[port], snk)
            readers[port] = snk.data
        return g, readers
    # a deviation from the mean is a few of the mean's ulps, in percent
    versus("SystemUnbalance", unbalance, 32, tol=F32_ATOL + 100 * 4 * 2.0 ** -23)
    print("[25b card against the CPU] " + "; ".join(
        f"{k} {v if isinstance(v, str) else f'{v:.2e}'}" for k, v in b_results.items()))
    lap("b card vs CPU")

    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    rx = lambda *shape: torch.randn(*shape, dtype=torch.float32, device=dev, generator=gen)
    cx = lambda *shape: torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
    costs = (
        ("FunctionGenerator ParabolicRamp", reg.create(
            "FunctionGenerator", signal_type="ParabolicRamp", final_value=1.0,
            round_off_time=0.2), {}, 2000),
        ("FunctionGenerator GaussianNoise", reg.create(
            "FunctionGenerator", signal_type="GaussianNoise"), {}, 5000),
        ("FrequencyEstimator fft", reg.create("FrequencyEstimator", chunk=1024),
         {"in": rx(8192)}, None),
        ("FrequencyEstimator period", reg.create("FrequencyEstimator", chunk=1024,
                                                 method="period"), {"in": rx(8192)}, None),
        ("SchmittTrigger", reg.create("SchmittTrigger", low=-0.3, high=0.3),
         {"in": rx(2000)}, None),
        ("SavitzkyGolayFilter", reg.create("SavitzkyGolayFilter", window=31,
                                           poly_order=3), {"in": rx(2048)}, None),
        ("SvdDenoiser xla", reg.create("SvdDenoiser", chunk=256, window=24,
                                       engine="xla"), {"in": rx(1024)}, None),
        ("SvdDenoiser jacobi", reg.create("SvdDenoiser", chunk=256, window=24,
                                          engine="jacobi"), {"in": rx(1024)}, None),
        ("BurstTaper", reg.create("BurstTaper", ramp_len=32), {"in": cx(1024)}, None),
        ("StreamFilter", reg.create("StreamFilter", filter="A"), {"in": cx(1024)}, None),
        ("SyncBlock", reg.create("SyncBlock", n_inputs=2, max_skew=64),
         {"in0": rx(512), "in1": rx(512)}, None),
        ("TriggerGate", reg.create("TriggerGate", n_post=700), {"in": rx(1024)}, None),
        ("ToUncertain", reg.create("ToUncertain"), {"in": rx(1024), "sigma": rx(1024)}, None),
        ("FirFilter uncertain", reg.create("FirFilter", taps=tuple(uv_taps),
                                           uncertain=True), {"in": rx(2, 1024)}, None),
        ("MultiplyConst uncertain", reg.create("MultiplyConst", value=2.0,
                                               value_sigma=0.1, uncertain=True),
         {"in": rx(2, 1024)}, None),
        ("IirFilter uncertain", reg.create("IirFilter", b=(0.2,), a=(1.0, -0.8),
                                           uncertain=True), {"in": rx(2, 256)}, None),
        ("PowerMetrics", reg.create("PowerMetrics", decim=2000),
         {"u": rx(4000), "i": rx(4000), "u_sigma": rx(4000), "i_sigma": rx(4000)}, None),
        ("PowerFactor", reg.create("PowerFactor"),
         {"p": rx(2), "s": rx(2), "p_sigma": rx(2), "s_sigma": rx(2)}, None),
        ("SystemUnbalance", reg.create("SystemUnbalance"),
         {"u_rms": rx(3, 32), "i_rms": rx(3, 32), "p": rx(3, 32)}, None))
    for label, b, ins, n_src in costs:
        kernels, ops, ms_b, hand = block_cost(dev, b, ins, n_out=n_src)
        n_in = n_src if n_src is not None else next(iter(ins.values())).shape[-1]
        print(f"[25b step cost] {label} on {n_in} samples: {kernels} kernel launches "
              f"seen by torch.profiler ({hand} hand-kernel launches by their "
              f"wrappers' counts), {ops} torch ops, {ms_b:.3f} ms per step")
        paths.append({"name": f"phase 25 {label}", "samples": n_in,
                      "kernels_per_step": kernels, "hand_kernel_launches": hand,
                      "torch_ops_per_step": ops, "ms_per_step": ms_b})
    lap("b step costs")

    # (c) SvdDenoiser's engines at 2^20 samples a step (chunk 256, window 16)
    # on a tone in noise (two singular values well above the rest, so that
    # both engines keep the same rank-2 subspace): the choice behind engine
    # 'auto' on CUDA
    x_svd = (torch.sin(torch.arange(SVD_BLOCK_LEN, device=dev) * (2 * math.pi / 64))
             + 0.2 * rx(SVD_BLOCK_LEN))
    svd_ms, svd_out = {}, {}
    for engine in ("jacobi", "xla"):
        b = reg.create("SvdDenoiser", chunk=256, window=16, rank=2, engine=engine)
        ctx = gt.BlockCtx(in_len={"in": SVD_BLOCK_LEN}, out_len={"out": SVD_BLOCK_LEN},
                          sample_rate=1.0, params={}, device=dev)
        step = lambda: b.apply((), {"in": x_svd}, ctx)[1]["out"]
        svd_out[engine] = step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        svd_ms[engine], _ = events_ms_per_step(step, 1, windows=3 if first < 2e3 else 1)
    d_svd = float((svd_out["xla"] - svd_out["jacobi"]).abs().max()) / float(x_svd.abs().max())
    faster = min(svd_ms, key=svd_ms.get)
    print(f"[25c SvdDenoiser, 2^20 samples a step, chunk 256, window 16] xla "
          f"(torch.linalg.svd) {svd_ms['xla']:.3f} ms, jacobi {svd_ms['jacobi']:.3f} ms "
          f"per step (CUDA events); the engines agree within {d_svd:.2e} of the peak "
          f"(tol {SVD_ATOL}); engine 'auto' on CUDA takes "
          f"{gt.global_registry.get('SvdDenoiser')._CUDA_AUTO!r}, {faster!r} read faster")
    check(d_svd <= SVD_ATOL, "SvdDenoiser: engines disagree at 2^20")
    paths.append({"name": "phase 25 SvdDenoiser 2^20", "xla_ms": svd_ms["xla"],
                  "jacobi_ms": svd_ms["jacobi"]})
    del x_svd, svd_out
    lap("c svd")

    # (d) fir_banded against its plain version at every shape (a) and (b)
    # launched it with, on the taps the blocks designed
    fir_shapes = [("the S-G filter of (a)", sg_taps, ACQ_BLOCK_LEN, sg_launches),
                  ("the S-G filter at 2^16 a step", sg_check[0], ACQ_CHECK_BLOCK_LEN,
                   sg_check[1]),
                  ("the uncertain FirFilter's value plane", uv_taps, 1024,
                   unc_counts // 2),
                  ("the uncertain FirFilter's sigma² plane", uv_taps * uv_taps, 1024,
                   unc_counts // 2)]
    rows = results["fir_banded"].setdefault("timed_shapes", [])
    for label, taps_np, t_len, launches in fir_shapes:
        taps = torch.from_numpy(np.ascontiguousarray(taps_np)).to(dev)
        k = taps.shape[0]
        x, hist = rx(t_len), rx(k - 1)
        err = float((ck.fir_banded(x, hist, taps, 1)
                     - ck.fir_banded_ref(x, hist, taps, 1)).abs().max())
        k_ms, p_ms = kernel_vs_plain_ms(lambda: ck.fir_banded(x, hist, taps, 1),
                                        lambda: ck.fir_banded_ref(x, hist, taps, 1))
        b_ms, b_by = bound_ms(*fir_work((t_len,), False, False, k, 1))
        lib = conv1d_ms(x, hist, taps, 1)
        print(f"[25d fir_banded, {label}] f32 × f32 K {k} ÷1 T {t_len}: max|Δ| "
              f"{err:.3e} (tol {FIR_ATOL}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}), {b_ms / k_ms:.1%} of it; F.conv1d "
              f"(TF32 off) {lib:.4f} ms; {launches} launches")
        check(err <= FIR_ATOL, f"fir_banded, {label}: {err}")
        results["fir_banded"]["max_abs_err"] = max(results["fir_banded"]["max_abs_err"], err)
        row = {"case": f"phase 25 {label}: f32 × f32 K {k} ÷1 T {t_len}",
               "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
        rows.append(row)
        paths.append({"name": f"phase 25 fir_banded {row['case']}", **row})
    lap("d kernels")
    print(f"[25 seconds] wall s by sub-phase {({k: round(v, 2) for k, v in secs.items()})}"
          f"; phase 25 {sum(secs.values()):.1f} s")
    paths.append({"name": "phase 25 seconds", "seconds": sum(secs.values()),
                  "by_sub_phase": secs})


def same_result(a, b, rtol: float, where: str = "") -> float:
    """Compare two decoded results (lists, tuples, dicts, bytes, strings,
    numbers, arrays): everything exact but floats, which must agree within
    ``rtol`` of |b|. Returns the largest relative float difference."""
    import numpy as np
    if isinstance(b, dict):
        check(isinstance(a, dict) and sorted(a) == sorted(b), f"{where}: keys differ")
        return max([same_result(a[k], b[k], rtol, f"{where}/{k}") for k in b],
                   default=0.0)
    if isinstance(b, (list, tuple)):
        check(type(a) is type(b) and len(a) == len(b), f"{where}: lengths differ")
        return max([same_result(x, y, rtol, where) for x, y in zip(a, b)],
                   default=0.0)
    if isinstance(b, np.ndarray):
        check(isinstance(a, np.ndarray) and a.dtype == b.dtype
              and np.array_equal(a, b), f"{where}: arrays differ")
        return 0.0
    if isinstance(b, float):
        d = abs(a - b) / max(abs(b), 1e-30)
        check(d <= rtol, f"{where}: {a} against {b}")
        return d
    check(type(a) is type(b) and a == b, f"{where}: {a!r} against {b!r}")
    return 0.0


def fec_flow_phases(dev, card: str, paths: list, results: dict) -> None:
    """Phase 26: the five example flows of the FEC slice, the convolutional
    code and the other new device blocks on the card."""
    import numpy as np
    import torch
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks import fec, lora
    from gnuradio4_tpu_torch.core import yaml_pmt
    from gnuradio4_tpu_torch.core.profiler import Profiler
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck

    secs = {}
    t_sub = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t_sub
        now = time.perf_counter()
        secs[name] = now - t_sub
        t_sub = now

    # (a) the five flows as written (their meta: block_len and sample_rate),
    # on the card and on the CPU
    readers = {
        "lora_link": ("rx", lambda b: b.frames),
        "wifi_link": ("rx", lambda b: b.frames),
        "ble_scanner": ("scan", lambda b: (b.devices, b.packets)),
        "ais_receiver": ("tracker", lambda b: (b.vessels, b.packets)),
        "rtty_teletype": ("printer", lambda b: b.text),
    }

    def expected(stem, r) -> bool:
        if stem == "lora_link":
            return r == [b"LoRa over TPU"]
        if stem == "wifi_link":
            return (len(r) == 1 and r[0]["rate_mbps"] == 24 and r[0]["fcs_ok"]
                    and r[0]["psdu"][:-4] == b"Hello from the 802.11a OFDM PHY")
        if stem == "ble_scanner":
            return (set(r[0]) == {"BC:9A:78:56:34:12", "05:04:03:02:01:00"}
                    and r[0]["BC:9A:78:56:34:12"]["name"] == "GR4-TPU")
        if stem == "ais_receiver":
            return (set(r[0]) == {477553000, 211234560}
                    and r[0][477553000]["nav_status"] == 5)
        return r == "CQ CQ CQ DE GR4TPU GR4TPU K"

    for stem in FLOWS:
        text = (ROOT / "examples" / f"{stem}.yaml").read_text()
        meta = yaml_pmt.load(text)["meta"]
        kw = {"block_len": int(meta["block_len"]),
              "sample_rate": float(meta["sample_rate"])}
        name, read = readers[stem]
        got = {}
        for key, device in (("card", dev), ("cpu", "cpu")):
            if key == "card":
                ck.reset_launch_counts()
            sched = gt.run_grc(text, scheduler_kwargs={"device": device, **kw})
            if key == "card":
                counts = ck.launch_counts()
                check(sched.device.type == "cuda", f"{stem}: ran on {sched.device}")
            got[key] = read({b.name: b for b in sched.graph.blocks}[name])
            check(expected(stem, got[key]), f"{stem} on the {key}: {got[key]!r:.300}")
        diff = same_result(got["card"], got["cpu"], FLOW_RTOL, stem)
        for k in KERNELS:
            results[k]["launches"] += counts[k]
        # timed: CUDA events over the whole run, host spans by the profiler
        prof = Profiler()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        sched = gt.run_grc(text, scheduler_kwargs={"device": dev, "profiler": prof,
                                                    **kw})
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        steps = sched._step
        spans: dict[str, float] = {}
        for ev in prof.events():
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
        ms = start.elapsed_time(end) / steps
        host = spans.get("scheduler.step", 0.0) / steps
        deliver = spans.get("scheduler.deliver", 0.0) / steps
        kernels, ops = count_ops(lambda: gt.run_grc(
            text, scheduler_kwargs={"device": dev, **kw}))
        per = (lambda v: None if v is None else v / steps)
        print(f"[26a {stem}] block_len {kw['block_len']}, {steps} steps on "
              f"{sched.device}: {got['card']!r:.160} — as tests/test_examples.py "
              f"asserts; card equal to the CPU (floats within {diff:.2e} of |x|, "
              f"tol {FLOW_RTOL}); {ms:.4f} ms per step (CUDA events over the run, "
              f"{wall / steps:.4f} wall), host {host:.4f} ms per step in the pump, "
              f"delivery {deliver:.4f}; {per(kernels)} kernel launches and "
              f"{per(ops)} torch ops per step (torch.profiler); hand-kernel "
              f"launches {counts} {card}")
        paths.append({"name": f"phase 26 {stem}", "steps": steps,
                      "block_len": kw["block_len"], "ms_per_step": ms,
                      "wall_ms_per_step": wall / steps, "host_ms_per_step": host,
                      "deliver_ms_per_step": deliver,
                      "kernels_per_step": per(kernels),
                      "torch_ops_per_step": per(ops), "float_rel_diff": diff})
        lap(f"a {stem}")

    # (b) ConvEncoder → ViterbiDecoder on VIT_BITS random bits, clean and at
    # VIT_FLIP flips, on the card and on the CPU: bit for bit
    rng = np.random.default_rng(SEED)
    bits = rng.integers(0, 2, VIT_BITS).astype(np.int32)

    def through(device, data, btype, **settings):
        g = gt.Graph()
        snk = gt.global_registry.create("VectorSink")
        g.connect_chain(gt.global_registry.create("VectorSource", data=data),
                        gt.global_registry.create(btype, **settings), snk)
        gt.Scheduler(g, block_len=VIT_BLOCK_LEN, sample_rate=1e6,
                     device=device).run_and_wait()
        return np.asarray(snk.data())

    enc_out, _ = fec._tables(7, (0o171, 0o133))
    ref, s_reg = np.empty((VIT_BITS, 2), np.int32), 0
    for i, b in enumerate(bits):
        ref[i] = enc_out[s_reg, b]
        s_reg = ((s_reg << 1) | int(b)) & 0x3F
    coded = through(dev, bits, "ConvEncoder")[:2 * VIT_BITS]
    check(np.array_equal(coded, ref.reshape(-1))
          and np.array_equal(coded, through("cpu", bits, "ConvEncoder")[:2 * VIT_BITS]),
          "ConvEncoder: the card against the bitwise encoder and the CPU")
    for flip in (0.0, VIT_FLIP):
        rx = coded ^ (rng.random(coded.size) < flip).astype(np.int32)
        dec_card = through(dev, rx, "ViterbiDecoder", traceback=VIT_TB)
        dec_cpu = through("cpu", rx, "ViterbiDecoder", traceback=VIT_TB)
        residual = float(np.mean(dec_card[VIT_TB:VIT_BITS] != bits[:VIT_BITS - VIT_TB]))
        print(f"[26b ConvEncoder → ViterbiDecoder] {VIT_BITS} bits, steps of "
              f"{VIT_BLOCK_LEN} coded bits, flips {flip}: residual {residual:.5f} "
              f"after the {VIT_TB}-bit traceback (clean: exact; flipped: < "
              f"{VIT_RESIDUAL_MAX}); card equal to the CPU bit for bit: "
              f"{np.array_equal(dec_card, dec_cpu)}")
        check(np.array_equal(dec_card, dec_cpu), f"Viterbi at {flip}: card against CPU")
        check(residual == 0.0 if flip == 0.0 else residual < VIT_RESIDUAL_MAX,
              f"Viterbi at {flip}: residual {residual}")
        paths.append({"name": f"phase 26 Viterbi flips {flip}", "residual": residual})
    soft = np.clip(coded[:16384] + rng.normal(0, 0.45, 16384), 0, 1).astype(np.float32)
    s_card = through(dev, soft, "ViterbiDecoder", soft=True, traceback=VIT_TB)
    check(np.array_equal(s_card, through("cpu", soft, "ViterbiDecoder", soft=True,
                                         traceback=VIT_TB)),
          "soft Viterbi: card against CPU")
    print(f"  soft decisions (σ 0.45, 8192 bits): card equal to the CPU bit for bit; "
          f"residual {float(np.mean(s_card[VIT_TB:8192] != bits[:8192 - VIT_TB])):.5f}")
    lap("b viterbi")

    # (c) the scramblers, Golay, Hamming and CssDemod: card against CPU, and
    # against what was sent
    scr = {d: through(d, bits, "Scrambler") for d in (dev, "cpu")}
    desc = {d: through(d, scr[d], "Descrambler") for d in (dev, "cpu")}
    check(np.array_equal(scr[dev], scr["cpu"]) and np.array_equal(desc[dev], desc["cpu"])
          and np.array_equal(desc[dev], bits), "Scrambler → Descrambler round trip")
    msg = rng.integers(0, 2, 12 * 1024).astype(np.float32)
    code = {}
    for name, enc, dec, unit, flips, settings in (
            ("Golay", "GolayEncoder", "GolayDecoder", 24, 3, {}),
            ("Hamming(7,4)", "HammingEncoder", "HammingDecoder", 7, 1, {"m": 3}),
            ("Hamming(15,11)", "HammingEncoder", "HammingDecoder", 15, 1, {"m": 4})):
        k = {24: 12, 7: 4, 15: 11}[unit]
        m_in = msg[:len(msg) // k * k]
        cw = {d: through(d, m_in, enc, **settings) for d in (dev, "cpu")}
        frames = cw[dev][:len(m_in) // k * unit].reshape(-1, unit).copy()
        for row in frames:
            pos = rng.choice(unit, flips, replace=False)
            row[pos] = 1.0 - row[pos]
        out = {d: through(d, frames.reshape(-1), dec, **settings) for d in (dev, "cpu")}
        ok = (np.array_equal(cw[dev], cw["cpu"]) and np.array_equal(out[dev], out["cpu"])
              and np.array_equal(out[dev][:len(m_in)], m_in))
        code[name] = ok
        check(ok, f"{name}: {flips} flips a frame, card against CPU and the message")
    css = {}
    for sf in (7, 8, 9):
        syms = lora.encode_payload(b"CSS ON THE CARD", sf, 4)
        x = np.concatenate([lora.css_symbol(int(v), sf) for v in syms])
        x = np.concatenate([x, np.zeros((-len(x)) % (16 << sf), np.complex64)])
        x = (x + 0.3 * (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
             ).astype(np.complex64)
        g_out = {}
        for d in (dev, "cpu"):
            g = gt.Graph()
            snk = gt.global_registry.create("VectorSink")
            g.connect_chain(gt.global_registry.create("VectorSource", data=x),
                            gt.global_registry.create("CssDemod", sf=sf), snk)
            gt.Scheduler(g, block_len=4 << sf, sample_rate=1e6, device=d).run_and_wait()
            g_out[d] = np.asarray(snk.data())
        css[sf] = (np.array_equal(g_out[dev], g_out["cpu"])
                   and np.array_equal(g_out[dev][:len(syms)], syms))
        check(css[sf], f"CssDemod SF {sf}: card against CPU and the sent symbols")
    print(f"[26c] Scrambler → Descrambler: {VIT_BITS} bits back, card equal to the "
          f"CPU; codes with injected flips decode to the message, card equal to the "
          f"CPU: {code}; CssDemod symbols at 0.3 noise equal to the CPU's and to the "
          f"sent ones: {css}")
    lap("c blocks")

    # each new device block's launches, torch ops and ms per step at 4096
    # samples (CssDemod: 16 frames of SF 8)
    def ints(n):
        return torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(dev)

    def f01(n):
        return ints(n).to(torch.float32)

    reg = gt.global_registry
    x_css = torch.from_numpy(np.concatenate([lora.css_symbol(int(v), 8)
                                             for v in range(16)])).to(dev)
    costs = (("ConvEncoder", reg.create("ConvEncoder"), {"in": ints(VIT_BLOCK_LEN)}),
             ("ViterbiDecoder", reg.create("ViterbiDecoder", traceback=VIT_TB),
              {"in": ints(VIT_BLOCK_LEN)}),
             ("ViterbiDecoder soft", reg.create("ViterbiDecoder", soft=True,
                                                traceback=VIT_TB),
              {"in": f01(VIT_BLOCK_LEN)}),
             ("Scrambler", reg.create("Scrambler"), {"in": ints(VIT_BLOCK_LEN)}),
             ("Descrambler", reg.create("Descrambler"), {"in": ints(VIT_BLOCK_LEN)}),
             ("GolayEncoder", reg.create("GolayEncoder"), {"in": f01(4092)}),
             ("GolayDecoder", reg.create("GolayDecoder"), {"in": f01(4104)}),
             ("HammingEncoder", reg.create("HammingEncoder"), {"in": f01(4096)}),
             ("HammingDecoder", reg.create("HammingDecoder"), {"in": f01(4095)}),
             ("CssDemod", reg.create("CssDemod", sf=8), {"in": x_css}))
    for label, b, ins in costs:
        kernels, ops, ms_b, hand = block_cost(dev, b, ins)
        n_in = next(iter(ins.values())).shape[-1]
        per_launch = "" if not kernels else f" ({ms_b / kernels * 1e3:.2f} µs a launch)"
        print(f"[26 step cost] {label} on {n_in} samples: {kernels} kernel launches "
              f"seen by torch.profiler ({hand} hand-kernel launches), {ops} torch "
              f"ops, {ms_b:.3f} ms per step{per_launch}")
        paths.append({"name": f"phase 26 {label}", "samples": n_in,
                      "kernels_per_step": kernels, "hand_kernel_launches": hand,
                      "torch_ops_per_step": ops, "ms_per_step": ms_b})
    lap("step costs")
    print(f"[26 seconds] wall s by sub-phase {({k: round(v, 2) for k, v in secs.items()})}"
          f"; phase 26 {sum(secs.values()):.1f} s")
    paths.append({"name": "phase 26 seconds", "seconds": sum(secs.values()),
                  "by_sub_phase": secs})


def bits_match_cycle(bits, nav) -> bool:
    """tests/test_gnss.py's rule: the recovered bits are (1 − nav) up to the
    cycle's offset and the Costas loop's polarity."""
    import numpy as np
    exp = np.tile(nav, 30)
    for off in range(len(nav)):
        for pol in (0, 1):
            if np.array_equal(exp[off:off + len(bits)] ^ pol, 1 - bits):
                return True
    return False


def timed_run(dev, run, steps_of):
    """One call of ``run(device, profiler)`` on the card, timed: (ms per step
    by CUDA events over the call, host ms per step in the pump's
    ``scheduler.step`` spans, delivery ms per step, steps, the call's
    result)."""
    import torch
    from gnuradio4_tpu_torch.core.profiler import Profiler
    prof = Profiler()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = run(dev, prof)
    end.record()
    torch.cuda.synchronize()
    steps = max(1, steps_of(out))
    spans: dict[str, float] = {}
    for ev in prof.events():
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    return (start.elapsed_time(end) / steps, spans.get("scheduler.step", 0.0) / steps,
            spans.get("scheduler.deliver", 0.0) / steps, steps, out)


def gnss_coding_phases(dev, card: str, paths: list, results: dict) -> None:
    """Phase 27: GPS acquisition and tracking, the CCSDS link with its RS
    host call, polar codes, the six host receivers and CVSD on the card."""
    import numpy as np
    import torch
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks import (adsb, apt, dcf77, fec, pocsag,
                                            reed_solomon, wefax)
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck
    from gnuradio4_tpu_torch.ops import gnss, polar

    secs = {}
    t_sub = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t_sub
        now = time.perf_counter()
        secs[name] = now - t_sub
        t_sub = now

    reg = gt.global_registry
    ck.reset_launch_counts()

    def sched(g, device, block_len, fs, profiler=None):
        kw = {} if profiler is None else {"profiler": profiler}
        return gt.Scheduler(g, block_len=block_len, sample_rate=fs, device=device,
                            **kw)

    # (a) the cold-start sky search at GnssAcquisition's own widths: PRNs
    # 1–32, ±5 kHz in 250 Hz bins, 2 blocks of 1 ms summed
    rng = np.random.default_rng(SEED)
    sig = gnss.synthesize(GNSS_SATS, fs=GNSS_FS, n_ms=GNSS_N_MS,
                          noise_std=GNSS_NOISE, rng=rng)
    found = {}
    for key, device in (("card", dev), ("cpu", "cpu")):
        g = gt.Graph()
        acq = reg.create("GnssAcquisition", sample_rate_in=GNSS_FS)
        g.connect(reg.create("VectorSource", data=sig), acq)
        sched(g, device, GNSS_BLOCK_LEN, GNSS_FS).run_and_wait()
        found[key] = acq.detections
    truth = {p: (d, c) for p, d, c in GNSS_SATS}
    det = {d["prn"]: d for d in found["card"]}
    print(f"[27a GPS sky search] {len(truth)} satellites at noise σ {GNSS_NOISE}, "
          f"{GNSS_N_MS} ms, block_len {GNSS_BLOCK_LEN}: detected "
          f"{[(d['prn'], d['code_phase'], d['doppler'], round(d['metric'], 2)) for d in found['card']]}"
          f" (truth {sorted(truth.items())}) {card}")
    check(sorted(det) == sorted(truth), f"GPS: detected PRNs {sorted(det)}")
    for prn, (dopp, phase) in truth.items():
        check(det[prn]["code_phase"] == phase
              and abs(det[prn]["doppler"] - dopp) <= GNSS_DOPPLER_STEP,
              f"GPS PRN {prn}: {det[prn]} against ({dopp}, {phase})")
    check([(d["prn"], d["code_phase"], d["doppler"]) for d in found["card"]]
          == [(d["prn"], d["code_phase"], d["doppler"]) for d in found["cpu"]]
          and all(abs(a["metric"] - b["metric"]) <= GNSS_METRIC_RTOL * b["metric"]
                  for a, b in zip(found["card"], found["cpu"])),
          f"GPS: card {found['card']} against CPU {found['cpu']}")
    iq = torch.from_numpy(sig[:2 * GNSS_BLOCK_LEN]).to(dev)
    sky = gnss.acquire_all(iq, fs=GNSS_FS, device=dev)
    check([(d["prn"], d["code_phase"], d["doppler"]) for d in sky]
          == [(d["prn"], d["code_phase"], d["doppler"]) for d in found["card"]],
          f"GPS: acquire_all {sky} against the sink's {found['card']}")
    # the search program alone (the [P, D, K, N] batch, no read-back) and
    # acquire_all with its read-back of [P] numbers, CUDA events
    dopplers = torch.from_numpy(gnss.doppler_grid(5000.0, GNSS_DOPPLER_STEP)).to(dev)
    codes = torch.from_numpy(np.stack([gnss.sampled_code(p, GNSS_FS, GNSS_BLOCK_LEN)
                                       for p in range(1, 33)])).to(dev)
    prog_ms = cuda_ms(lambda: gnss.acquire_metric(iq, codes, dopplers, fs=GNSS_FS,
                                                  n_coherent=2))
    all_ms, _ = events_ms_per_step(
        lambda: gnss.acquire_all(iq, fs=GNSS_FS, device=dev), 1, windows=10)
    seq_ms, _ = events_ms_per_step(
        lambda: [gnss.acquire(iq, p, fs=GNSS_FS, device=dev) for p in range(1, 33)],
        1, windows=3)
    n_d, n_bins = dopplers.numel(), 32 * dopplers.numel() * 2 * GNSS_BLOCK_LEN
    # bound: the IQ read and the [P, D, N] surface written once; the inverse
    # FFTs' 5·N·log2 N flops each, and the products
    s_bytes = iq.numel() * 8 + 32 * n_d * GNSS_BLOCK_LEN * 4
    s_flops = (32 * n_d * 2) * 5 * GNSS_BLOCK_LEN * math.log2(GNSS_BLOCK_LEN) \
        + n_bins * 6
    b_ms, b_by = bound_ms(s_flops, s_bytes)
    print(f"  acquire_all: {all_ms:.4f} ms (CUDA events, median of 10; the [32, "
          f"{n_d}, 2, {GNSS_BLOCK_LEN}] complex64 batch, {n_bins * 8 / 1e6:.1f} MB an "
          f"operand, and 32 × 4 numbers read back); the search program alone "
          f"{prog_ms:.4f} ms (bound {b_ms:.5f} ms by {b_by}: IQ in, surfaces out, "
          f"the inverse FFTs); the sink's 32 sequential acquire calls "
          f"{seq_ms:.4f} ms {card}")
    paths.append({"name": "phase 27 GPS sky search", "acquire_all_ms": all_ms,
                  "program_ms": prog_ms, "program_bound_ms": b_ms,
                  "bound_by": b_by, "sequential_acquire_ms": seq_ms,
                  "detections": [(d["prn"], d["code_phase"], d["doppler"])
                                 for d in found["card"]]})
    del iq, codes, sky
    lap("a sky search")

    # (b) the tracking bank: the six satellites with 50 bps nav bits
    sats = [s + (GNSS_NAV[i % 2],) for i, s in enumerate(GNSS_SATS)]
    sig = gnss.synthesize(sats, fs=GNSS_FS, n_ms=GNSS_TRACK_MS,
                          noise_std=GNSS_TRACK_NOISE, rng=rng)
    acqs = gnss.acquire_all(sig[:2 * GNSS_BLOCK_LEN], fs=GNSS_FS, device=dev)
    check([a["prn"] for a in acqs] == [s[0] for s in GNSS_SATS],
          f"tracking: acquisitions {acqs}")
    sig_t = torch.from_numpy(sig).to(dev)
    trk = []
    for _ in range(2):       # the first call loads the loop's kernels
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        chans = gnss.track_channels(sig_t, acqs, fs=GNSS_FS, device=dev)
        end.record()
        torch.cuda.synchronize()
        trk.append(start.elapsed_time(end) / GNSS_TRACK_MS)
    trk_cold, trk_ms = trk
    chans_cpu = gnss.track_channels(sig, acqs, fs=GNSS_FS, device="cpu")
    kernels, ops = count_ops(lambda: gnss.track_channels(sig_t, acqs, fs=GNSS_FS,
                                                         device=dev))
    for c, c_cpu, s in zip(chans, chans_cpu, sats):
        check(bits_match_cycle(c["bits"], s[3]), f"PRN {c['prn']}: bits {c['bits']}")
        check(np.array_equal(c["bits"], c_cpu["bits"]),
              f"PRN {c['prn']}: card bits {c['bits']} against CPU {c_cpu['bits']}")
    dfreq = max(float(np.max(np.abs(c["doppler"] - d["doppler"])))
                for c, d in zip(chans, chans_cpu))
    per = (lambda v: None if v is None else v / GNSS_TRACK_MS)
    print(f"[27b tracking bank] {len(chans)} channels over {GNSS_TRACK_MS} ms: "
          f"{[len(c['bits']) for c in chans]} nav bits each, every channel's bits "
          f"match its cycle, card equal to the CPU (frequencies within {dfreq:.2e} "
          f"Hz); {trk_ms:.4f} ms per 1 ms block (CUDA events over the second "
          f"track_channels call; the first, which loads the kernels, {trk_cold:.4f}; "
          f"real time at < 1), {per(kernels)} kernel launches and {per(ops)} torch "
          f"ops per block (torch.profiler) {card}")
    paths.append({"name": "phase 27 tracking bank", "channels": len(chans),
                  "ms_per_block": trk_ms, "first_call_ms_per_block": trk_cold,
                  "kernels_per_block": per(kernels),
                  "torch_ops_per_block": per(ops), "freq_diff_hz": dfreq})
    del sig_t
    lap("b tracking")

    # (c) the CCSDS concatenated link at interleave 4, and RS alone
    payload = bytes(rng.integers(0, 256, 223 * CCSDS_INTERLEAVE).tolist())

    def coded_bits(device):
        g = gt.Graph()
        snk = reg.create("VectorSink")
        g.connect_chain(reg.create("CcsdsFramer", payload=payload,
                                   interleave=CCSDS_INTERLEAVE),
                        reg.create("Convert", to="int32"), reg.create("ConvEncoder"),
                        snk)
        sched(g, device, 2048, 1e6).run_and_wait()
        return np.asarray(snk.data()).astype(np.int32)

    coded = coded_bits(dev)
    check(np.array_equal(coded, coded_bits("cpu")), "CCSDS: coded bits card against CPU")
    rx = np.concatenate([coded ^ (rng.random(len(coded)) < CCSDS_FLIPS).astype(np.int32),
                         np.zeros(2 * VIT_TB, np.int32)])

    def deframe(device, profiler=None):
        g = gt.Graph()
        dec = reg.create("CcsdsDeframer", interleave=CCSDS_INTERLEAVE)
        g.connect_chain(reg.create("VectorSource", data=rx),
                        reg.create("ViterbiDecoder", traceback=VIT_TB),
                        reg.create("Convert", to="float32"), dec)
        s = sched(g, device, 2048, 1e6, profiler)
        s.run_and_wait()
        return s, dec

    ms_c, host_c, _, steps_c, (_, dec) = timed_run(dev, deframe, lambda o: o[0]._step)
    _, dec_cpu = deframe("cpu")
    check(dec.frames == [payload] and dec_cpu.frames == dec.frames
          and dec.n_corrected == dec_cpu.n_corrected,
          f"CCSDS: frames {len(dec.frames)} (corrected {dec.n_corrected}) against "
          f"the CPU's {len(dec_cpu.frames)} ({dec_cpu.n_corrected})")
    print(f"[27c CCSDS link] {len(payload)} payload bytes, interleave "
          f"{CCSDS_INTERLEAVE}: framer → ConvEncoder → {CCSDS_FLIPS:.0%} flips → "
          f"ViterbiDecoder(traceback {VIT_TB}) → deframer: frames == [payload], "
          f"{dec.n_corrected} RS symbols corrected, card equal to the CPU; "
          f"{ms_c:.3f} ms per step of 2048 coded bits (host {host_c:.3f}) {card}")
    # RS: 8 codewords with 16 byte errors each and one with 17
    data = rng.integers(0, 256, (RS_CODEWORDS + 1) * 223).astype(np.float32)
    rs_out = {}
    for key, device in (("card", dev), ("cpu", "cpu")):
        g = gt.Graph()
        snk = reg.create("VectorSink")
        g.connect_chain(reg.create("VectorSource", data=data), reg.create("RsEncoder"),
                        snk)
        sched(g, device, (RS_CODEWORDS + 1) * 223, 1e6).run_and_wait()
        rs_out[key] = np.asarray(snk.data())
    check(np.array_equal(rs_out["card"], rs_out["cpu"]), "RsEncoder: card against CPU")
    cws = rs_out["card"].astype(np.int64).reshape(-1, 255)
    for i, cw in enumerate(cws):
        ne = RS_ERRORS + (i == RS_CODEWORDS)
        pos = rng.choice(255, ne, replace=False)
        cw[pos] ^= rng.integers(1, 256, ne)
    noisy = cws.reshape(-1).astype(np.float32)
    got = {}
    for key, device in (("card", dev), ("cpu", "cpu")):
        g = gt.Graph()
        snk = reg.create("VectorSink")
        rsd = reg.create("RsDecoder")
        g.connect_chain(reg.create("VectorSource", data=noisy), rsd, snk)
        sched(g, device, len(noisy), 1e6).run_and_wait()
        got[key] = (np.asarray(snk.data()), rsd.n_corrected, rsd.n_failed)
    out, n_corr, n_fail = got["card"]
    check(n_corr == RS_CODEWORDS * RS_ERRORS and n_fail == 1
          and np.array_equal(out[:RS_CODEWORDS * 223], data[:RS_CODEWORDS * 223]),
          f"RsDecoder: n_corrected {n_corr}, n_failed {n_fail}")
    check(np.array_equal(out, got["cpu"][0]) and got["cpu"][1:] == (n_corr, n_fail),
          "RsDecoder: card against CPU")
    rsd = reg.create("RsDecoder")
    x_rs = torch.from_numpy(noisy).to(dev)
    host_rs = []

    def timed_decode(a):
        t0 = time.perf_counter()
        y = rsd._decode_np(a)
        host_rs.append((time.perf_counter() - t0) * 1e3)
        return y

    rs_step_ms, _ = events_ms_per_step(
        lambda: reed_solomon.host_call(timed_decode, x_rs), 1, windows=5)
    print(f"  RsEncoder → {RS_CODEWORDS} × {RS_ERRORS} + 1 × {RS_ERRORS + 1} byte errors "
          f"→ RsDecoder: n_corrected {n_corr}, n_failed {n_fail}, card equal to the "
          f"CPU; the decoder's step (host call: one copy out, the codec, one copy "
          f"in) {rs_step_ms:.3f} ms, of it the codec on the host "
          f"{statistics.median(host_rs):.3f} ms, for {RS_CODEWORDS + 1} codewords {card}")
    paths.append({"name": "phase 27 CCSDS", "ms_per_step": ms_c, "host_ms_per_step": host_c,
                  "steps": steps_c, "n_corrected": dec.n_corrected,
                  "rs_step_ms": rs_step_ms, "rs_host_ms": statistics.median(host_rs)})
    lap("c ccsds")

    # (d) polar: N 256, K 128 at σ 0.65, 64 frames in steps of 16 frames
    fr = polar.frozen_mask(POLAR_N, POLAR_K)
    bits = rng.integers(0, 2, POLAR_FRAMES * POLAR_K).astype(np.float32)
    bl_enc, bl_dec = 16 * POLAR_K, 16 * POLAR_N

    def through(device, data, btype, block_len, profiler=None):
        g = gt.Graph()
        snk = reg.create("VectorSink")
        g.connect_chain(reg.create("VectorSource", data=data),
                        reg.create(btype, n=POLAR_N, k=POLAR_K), snk)
        s = sched(g, device, block_len, 1e6, profiler)
        s.run_and_wait()
        return s, np.asarray(snk.data())

    ms_e, host_e, _, _, (_, cw) = timed_run(
        dev, lambda d, p: through(d, bits, "PolarEncoder", bl_enc, p), lambda o: o[0]._step)
    check(np.array_equal(cw, polar.polar_encode(bits.astype(np.uint8), fr).astype(np.float32)),
          "PolarEncoder on the card against polar_encode")
    y = 1.0 - 2.0 * cw + POLAR_SIGMA * rng.standard_normal(len(cw))
    llr = (2 * y / POLAR_SIGMA ** 2).astype(np.float32)
    raw = float(np.mean((y < 0) != cw))
    ms_d, host_d, _, _, (_, dec_bits) = timed_run(
        dev, lambda d, p: through(d, llr, "PolarDecoder", bl_dec, p), lambda o: o[0]._step)
    _, dec_cpu = through("cpu", llr, "PolarDecoder", bl_dec)
    check(np.array_equal(dec_bits, bits) and np.array_equal(dec_cpu, dec_bits),
          f"PolarDecoder: {int(np.sum(dec_bits != bits))} bit errors, card equal to "
          f"the CPU: {np.array_equal(dec_cpu, dec_bits)}")
    pd = reg.create("PolarDecoder", n=POLAR_N, k=POLAR_K)
    t0 = time.perf_counter()
    pd._decode_np(llr[:bl_dec])
    sc_ms = (time.perf_counter() - t0) * 1e3
    kernels_e, _ = count_ops(lambda: through(dev, bits, "PolarEncoder", bl_enc))
    print(f"[27d polar] N {POLAR_N}, K {POLAR_K}, σ {POLAR_SIGMA}, {POLAR_FRAMES} "
          f"frames (raw BER {raw:.4f}): PolarEncoder on the card equal to "
          f"polar_encode, the decoded bits equal to the sent ones, card equal to the "
          f"CPU; PolarEncoder {ms_e:.3f} ms per step of 16 frames (host {host_e:.3f}; "
          f"{kernels_e} kernel launches over the run), PolarDecoder {ms_d:.3f} ms "
          f"per step (host {host_d:.3f}), of it the SC walk on the host {sc_ms:.3f} ms "
          f"for 16 frames {card}")
    paths.append({"name": "phase 27 polar", "encoder_ms_per_step": ms_e,
                  "decoder_ms_per_step": ms_d, "sc_host_ms": sc_ms, "raw_ber": raw})
    lap("d polar")

    # (e) the six host receivers, each through its JAX test's graph, rate and
    # block_len, on the card and on the CPU
    def adsb_iq(seed, frames, phase_sd, noise, **kw):
        r = np.random.default_rng(seed)
        wave = adsb.modulate(frames, **kw)
        x = (wave * np.exp(1j * np.cumsum(r.normal(0.0, phase_sd, len(wave))))
             ).astype(np.complex64)
        if noise:
            x += (noise * (r.standard_normal(len(x)) + 1j * r.standard_normal(len(x)))
                  ).astype(np.complex64)
        return x

    ac8 = [adsb.make_df17_identification(0xABC000 + k, f"TPU{k:04d}") for k in range(8)]
    pos3 = [adsb.make_df17_identification(0x40621D, "KLM1023"),
            adsb.make_df17_airborne_position(0x40621D, 52.2572, 3.91937, 38000, odd=False),
            adsb.make_df17_airborne_position(0x40621D, 52.2572, 3.91937, 38000, odd=True)]
    r2 = np.random.default_rng(2)
    pbits = pocsag.encode_transmission(423133, 3, "CALL THE TPU ROOM")
    pfs = 1200.0 * 32
    piq = np.exp(1j * 2 * np.pi * np.cumsum(np.repeat(
        np.where(pbits == 0, 4500.0, -4500.0), 32)) / pfs).astype(np.complex64)
    piq += (0.05 * (r2.standard_normal(len(piq)) + 1j * r2.standard_normal(len(piq)))
            ).astype(np.complex64)

    def apt_image(rows, r=None):
        r = r or np.random.default_rng(0)
        xs = np.linspace(0.0, 1.0, 909, dtype=np.float32)
        img = np.empty((rows, 909), np.float32)
        for i in range(rows):
            img[i] = 0.5 * xs + 0.3 * ((xs * (4 + i % 3)) % 1.0 > 0.5)
        img += r.uniform(0.0, 0.2, img.shape).astype(np.float32)
        return np.clip(img, 0.0, 1.0)

    img6 = apt_image(6)
    audio6 = apt.apt_modulate(img6)
    r3 = np.random.default_rng(3)
    img5 = apt_image(5, r3)
    aiq = np.exp(1j * (2 * np.pi * 4000.0 / 20800.0
                       * np.cumsum(apt.apt_modulate(img5).astype(np.float64)) + 0.7)
                 ).astype(np.complex64)
    aiq += (0.01 * (r3.standard_normal(len(aiq)) + 1j * r3.standard_normal(len(aiq)))
            ).astype(np.complex64)
    t0_ = dict(minute=34, hour=21, day=17, weekday=1, month=8, year2=26, cest=True)
    t2_ = dict(minute=59, hour=23, day=31, weekday=7, month=12, year2=99, cest=False)
    chart = np.zeros((6, 800), np.uint8)
    chart[:] = np.linspace(0, 255, 800)[None, :]
    chart[2], chart[4] = 30, 220
    zb_frames = [{"payload": b"HELLO-PAN", "seq": 1, "src_addr": 0x0001},
                 {"payload": b"SECOND", "seq": 2, "src_addr": 0x0002, "dst_addr": 0x00FE}]

    def chain(*blocks):
        g = gt.Graph()
        made = [reg.create(t, **kw) for t, kw in blocks]
        g.connect_chain(*made)
        return g, made[-1]

    def dcf_graph(minutes, noise=0.0, carrier=False):
        fs, n_total = 1000.0, 60000 * len(minutes)
        g = gt.Graph()
        head = src = g.emplace("Dcf77Source", minutes=minutes, sample_rate=fs)
        if carrier:
            to_iq = g.emplace("Convert", to="complex64")
            tone = g.emplace("ComplexToneSource", frequency=77.5, n_samples=n_total)
            mul = g.emplace("Multiply", n_inputs=2)
            head = g.emplace("Abs")
            g.connect(src, to_iq)
            g.connect(to_iq, mul, dst_port="in0")
            g.connect(tone, mul, dst_port="in1")
            g.connect(mul, head)
        if noise:
            nz = g.emplace("NoiseSource", std=noise, seed=0, n_samples=n_total)
            add = g.emplace("Add", n_inputs=2)
            g.connect(head, add, dst_port="in0")
            g.connect(nz, add, dst_port="in1")
            head = add
        dec = g.emplace("Dcf77Decoder", sample_rate=fs)
        g.connect(head, dec)
        return g, dec

    def ok_apt(img, rows, corr):
        def test(im):
            return im.shape[0] >= rows and min(
                np.corrcoef(im[i], img[i])[0, 1] for i in range(im.shape[0])) > corr
        return test

    zb = (lambda: chain(("Ieee802154Source", {"frames": zb_frames, "sps": 4}),
                        ("Ieee802154Decoder", {"sps": 4})),
          lambda b: b.frames,
          lambda r: ([f["seq"] for f in r] == [1, 2] and r[0]["payload"] == b"HELLO-PAN"
                     and r[1]["payload"] == b"SECOND" and r[1]["dst_addr"] == 0x00FE
                     and all(f["fcs_ok"] for f in r)))
    receivers = (
        ("802.15.4 two frames", 8192, 8e6, *zb),
        ("802.15.4 two frames", 3000, 8e6, *zb),
        ("ADS-B 8 aircraft", 1000, 2e6,
         lambda: chain(("VectorSource", {"data": adsb_iq(1, ac8, 0.3, 0.02, gap_us=137.5)}),
                       ("Abs", {}), ("AdsbDecoder", {"threshold": 0.3})),
         lambda b: (b.frames, b.aircraft),
         lambda r: (len(r[0]) == 8 and {i: a["callsign"] for i, a in r[1].items()}
                    == {0xABC000 + k: f"TPU{k:04d}" for k in range(8)})),
        ("ADS-B position", 700, 2e6,
         lambda: chain(("VectorSource", {"data": adsb_iq(2, pos3, 0.25, 0.0)}),
                       ("Abs", {}), ("AdsbDecoder", {})),
         lambda b: b.aircraft,
         lambda r: (r[0x40621D]["callsign"] == "KLM1023" and r[0x40621D]["alt_ft"] == 38000
                    and abs(r[0x40621D]["lat"] - 52.2572) < 1e-3
                    and abs(r[0x40621D]["lon"] - 3.91937) < 1e-3)),
        ("POCSAG page", 4800, pfs,
         lambda: chain(("VectorSource", {"data": piq}),
                       ("QuadratureDemod", {"gain": pfs / (2 * np.pi * 4500.0)}),
                       ("PocsagDecoder", {"sps": 32.0, "invert": True})),
         lambda b: b.pages,
         lambda r: (len(r) == 1 and r[0]["ric"] == 423133 and r[0]["function"] == 3
                    and r[0]["message"] == "CALL THE TPU ROOM")),
        ("APT audio", 7001, 20800.0,
         lambda: chain(("VectorSource", {"data": audio6}), ("AptDecoder", {})),
         lambda b: b.image, ok_apt(img6, 5, 0.97)),
        ("APT FM downlink", 9973, 20800.0,
         lambda: chain(("VectorSource", {"data": aiq}),
                       ("QuadratureDemod", {"gain": 20800.0 / (2 * np.pi * 4000.0)}),
                       ("AptDecoder", {})),
         lambda b: b.image, ok_apt(img5, 4, 0.93)),
        ("DCF77 noisy envelope", 8192, 1000.0,
         lambda: dcf_graph([t0_], noise=0.08),
         lambda b: b.frames, lambda r: bool(r) and r[0]["minute"] == 34),
        ("DCF77 AM carrier", 8192, 1000.0,
         lambda: dcf_graph([t2_], carrier=True),
         lambda b: b.frames, lambda r: bool(r) and r[0] == t2_),
        ("WEFAX chart", 8192, 11025.0,
         lambda: chain(("WefaxSource", {"image": chart}), ("WefaxDecoder", {})),
         lambda b: b.image,
         lambda r: r.shape == chart.shape
         and float(np.abs(r.astype(float) - chart.astype(float)).mean()) < 0.5),
    )
    for label, block_len, fs, build, read, ok in receivers:
        def run(device, profiler=None):
            g, blk = build()
            s = sched(g, device, block_len, fs, profiler)
            s.run_and_wait()
            return s, read(blk)

        ms_r, host_r, deliver_r, steps, (s_card, r_card) = timed_run(
            dev, run, lambda o: o[0]._step)
        check(s_card.device.type == torch.device(dev).type,
              f"{label}: ran on {s_card.device}")
        _, r_cpu = run("cpu")
        check(ok(r_card) and ok(r_cpu), f"{label}: card {r_card!r:.200} / CPU {r_cpu!r:.200}")
        if isinstance(r_card, np.ndarray) and r_card.dtype.kind == "f":
            diff = float(np.max(np.abs(r_card - r_cpu))) if r_card.size else 0.0
            check(r_card.shape == r_cpu.shape and diff <= APT_ATOL,
                  f"{label}: image card against CPU, max|Δ| {diff}")
        else:
            diff = same_result(r_card, r_cpu, FLOW_RTOL, label)
        kernels, ops = count_ops(lambda: run(dev))
        signal_ms = block_len / fs * 1e3
        per = (lambda v: None if v is None else v / steps)
        print(f"[27e {label}] block_len {block_len} at {fs:g} S/s, {steps} steps: as "
              f"its JAX test asserts on the card and the CPU, card equal to the CPU "
              f"(floats within {diff:.2e}); {ms_r:.3f} ms per step against "
              f"{signal_ms:.3f} ms of signal, host {host_r:.3f} (delivery "
              f"{deliver_r:.3f}), {per(kernels)} kernel launches and {per(ops)} torch "
              f"ops per step {card}")
        paths.append({"name": f"phase 27 {label} {block_len}", "steps": steps,
                      "ms_per_step": ms_r, "signal_ms_per_step": signal_ms,
                      "host_ms_per_step": host_r, "deliver_ms_per_step": deliver_r,
                      "kernels_per_step": per(kernels), "torch_ops_per_step": per(ops)})
    lap("e receivers")

    # (f) CVSD at 16 kS/s, 16 kbit/s: 4 steps of 4096 samples of band-limited
    # noise (tests/test_vocoder.py's _speech at this rate)
    from scipy import signal as sps
    b_, a_ = sps.butter(4, CVSD_BAND / (CVSD_FS / 2))
    x = sps.lfilter(b_, a_, rng.standard_normal(CVSD_STEPS * CVSD_BLOCK_LEN))
    speech = (0.5 * x / np.abs(x).max()).astype(np.float32)

    def cvsd(device, profiler=None):
        g = gt.Graph()
        enc = reg.create("CvsdEncoder")
        v, vb = reg.create("VectorSink"), reg.create("VectorSink")
        g.connect_chain(reg.create("VectorSource", data=speech), enc,
                        reg.create("CvsdDecoder"), v)
        g.connect(enc, vb)
        s = sched(g, device, CVSD_BLOCK_LEN, CVSD_FS, profiler)
        s.run_and_wait()
        return s, np.asarray(v.data()), np.asarray(vb.data())

    ms_v, host_v, _, steps_v, (_, audio, vbits) = timed_run(dev, cvsd, lambda o: o[0]._step)
    _, audio_cpu, vbits_cpu = cvsd("cpu")
    skip = 2000
    err = speech[skip:] - audio[skip:len(speech)]
    snr = float(10 * np.log10(np.mean(speech[skip:] ** 2) / np.mean(err ** 2)))
    a_diff = float(np.max(np.abs(audio - audio_cpu)))
    check(snr > CVSD_SNR_DB, f"CVSD: SNR {snr:.2f} dB")
    check(np.array_equal(vbits, vbits_cpu) and a_diff <= CVSD_AUDIO_ATOL,
          f"CVSD: card against CPU, bits equal {np.array_equal(vbits, vbits_cpu)}, "
          f"audio max|Δ| {a_diff}")
    enc = reg.create("CvsdEncoder")
    kernels, ops, ms_enc, _ = block_cost(dev, enc, {"in": torch.from_numpy(
        speech[:CVSD_PROFILE]).to(dev)}, sample_rate=CVSD_FS)
    audio_ms = CVSD_BLOCK_LEN / CVSD_FS * 1e3
    print(f"[27f CVSD] {CVSD_FS:g} S/s, 1 bit a sample, {steps_v} steps of "
          f"{CVSD_BLOCK_LEN}: SNR {snr:.2f} dB (> {CVSD_SNR_DB}), card bits equal to the "
          f"CPU's, audio within {a_diff:.1e} (tol {CVSD_AUDIO_ATOL}); encoder → decoder "
          f"{ms_v:.1f} ms per step against {audio_ms:.0f} ms of audio (host "
          f"{host_v:.1f}); the encoder alone on {CVSD_PROFILE} samples: "
          f"{None if kernels is None else kernels / CVSD_PROFILE} kernel launches and "
          f"{ops / CVSD_PROFILE} torch ops a sample, {ms_enc / CVSD_PROFILE * 1e3:.2f} "
          f"µs a sample {card}")
    paths.append({"name": "phase 27 CVSD", "ms_per_step": ms_v, "audio_ms_per_step": audio_ms,
                  "host_ms_per_step": host_v, "snr_db": snr,
                  "encoder_kernels_per_sample": None if kernels is None
                  else kernels / CVSD_PROFILE,
                  "encoder_ops_per_sample": ops / CVSD_PROFILE,
                  "encoder_us_per_sample": ms_enc / CVSD_PROFILE * 1e3})
    lap("f cvsd")
    counts = ck.launch_counts()
    for k in KERNELS:
        results[k]["launches"] += counts[k]
    print(f"[27 seconds] wall s by sub-phase {({k: round(v, 2) for k, v in secs.items()})}"
          f"; phase 27 {sum(secs.values()):.1f} s; hand-kernel launches {counts} {card}")
    paths.append({"name": "phase 27 seconds", "seconds": sum(secs.values()),
                  "by_sub_phase": secs})


def sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def span_ms(prof, name: str, *, block: str | None = None,
            tid: int | None = None) -> list[float]:
    """Durations (ms) of the profiler's ``name`` spans, of one block or one
    thread."""
    return [e["dur"] / 1e3 for e in prof.events()
            if e["name"] == name and e.get("ph") == "X"
            and (block is None or e["args"].get("block") == block)
            and (tid is None or e["tid"] == tid)]


def thread_tid(sched) -> int:
    """The profiler's ``tid`` of a started scheduler's runner thread."""
    return sched._runner.ident % 100000


def count_fir_shapes(by_shape: dict, keep: dict | None = None):
    """Context manager: while it is open, each ``fir_banded`` launch that a
    graph's FIR makes is added to ``by_shape`` under (stream 'c64'|'f32',
    taps, decim, samples). It wraps ops/fir.py's name for the kernel's
    wrapper and counts a call only when the wrapper's own count moved. With
    ``keep``, the latest launch's ``(x, hist, taps, decim)`` at each (x's
    shape, taps, decim) is kept there."""
    import contextlib
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck
    from gnuradio4_tpu_torch.ops import fir as tfir

    @contextlib.contextmanager
    def patched():
        inner = tfir.fir_banded

        def counted(x, hist, taps, decim=1):
            before = ck.fir_banded.launches
            y = inner(x, hist, taps, decim)
            if ck.fir_banded.launches > before:
                key = ("c64" if x.is_complex() else "f32", len(taps), int(decim),
                       int(x.shape[-1]))
                by_shape[key] = by_shape.get(key, 0) + ck.fir_banded.launches - before
                if keep is not None:
                    keep[(tuple(x.shape), len(taps), int(decim))] = (x, hist, taps,
                                                                     decim)
            return y
        tfir.fir_banded = counted
        try:
            yield by_shape
        finally:
            tfir.fir_banded = inner
    return patched()


def pipe_source(wait: str = "sleep"):
    """Phase 28(a)'s StreamSource: complex64, a ring of PIPE_CAPACITY items."""
    from gnuradio4_tpu_torch.blocks.python_block import StreamSource
    return StreamSource(name="stream", dtype="complex64", capacity=PIPE_CAPACITY,
                        wait=wait, timeout=PHASE28_TIMEOUT)


def piped_chain(dev, n_steps: int, *, wait: str = "sleep", sinks: str = "vector",
                absorb: bool = True, profiler=None, stream=None):
    """Phase 28(a)'s two graphs under one Runtime: ``acq`` =
    ComplexToneSource(1 MHz, n_steps blocks) → PipeSink, ``dsp`` = ``stream``
    (default :func:`pipe_source`) → build_chain's blocks, both at block_len
    2^23 on ``dev``. Returns (the dsp sinks' data or None, acq scheduler, dsp
    scheduler, wall s of run_all)."""
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks.basic import ComplexToneSource
    if absorb:
        os.environ.pop("GR4TPU_NO_ROTATION_ABSORB", None)
    else:
        os.environ["GR4TPU_NO_ROTATION_ABSORB"] = "1"
    try:
        acq = gt.Graph(name="acq")
        pipe = gt.PipeSink(name="pipe")
        acq.connect(ComplexToneSource(frequency=1e6, n_samples=n_steps * BLOCK_LEN),
                    pipe)
        stream = pipe_source(wait) if stream is None else stream
        dsp, fir, s1, s2 = build_chain(sinks, source=stream)
        rt = gt.Runtime("phase28")
        kw = dict(block_len=BLOCK_LEN, sample_rate=FS, device=dev)
        if profiler is not None:
            kw["profiler"] = profiler
        a = rt.add(acq, name="acq", **kw)
        d = rt.add(dsp, name="dsp", **kw)
        rt.pipe(pipe, stream)
        sync(dev)
        t0 = time.perf_counter()
        rt.run_all(timeout=PHASE28_TIMEOUT)
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("GR4TPU_NO_ROTATION_ABSORB", None)
    check(fir._rotation_absorbed == absorb,
          f"piped chain: rotation absorbed={fir._rotation_absorbed}, expected {absorb}")
    out = (s1.data(), s2.data()) if sinks == "vector" else None
    return out, a, d, wall


def first_steps(sinks, steps: int):
    """The chain's sinks cut to their first ``steps`` steps of 2^23."""
    spec, audio = sinks
    return spec[:steps * BLOCK_LEN], audio[:steps * BLOCK_LEN // 8]


def fm_tone(n: int):
    """An FM tone at +3 MHz (where the chain's FreqXlatingFir looks):
    ±USER_DEV_HZ of deviation at USER_MOD_HZ, complex64."""
    import numpy as np
    k = np.arange(n, dtype=np.float64)
    beta = USER_DEV_HZ / USER_MOD_HZ
    ph = 2 * np.pi * 3e6 / FS * k + beta * np.sin(2 * np.pi * USER_MOD_HZ / FS * k)
    return np.exp(1j * ph).astype(np.complex64)


def host_core_phases(dev, card: str, phase45, chain_msps: float, paths: list,
                     results: dict) -> None:
    """Phase 28: the rest of the host core on the card — the chain across two
    graphs under a Runtime, a ScheduledSubgraph, the user-function blocks,
    compute domains, merge, GPS/PPS timing and the profiler."""
    import json as _json
    import tempfile
    import threading
    import numpy as np
    import torch
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks.basic import ComplexToneSource
    from gnuradio4_tpu_torch.blocks.python_block import (HostBlock, LambdaBlock,
                                                         PythonBlock)
    from gnuradio4_tpu_torch.blocks.sdr import QuadratureDemod
    from gnuradio4_tpu_torch.blocks.testing import VectorSink, VectorSource
    from gnuradio4_tpu_torch.blocks.timing import (GpsSource, PpsSource,
                                                   ReplayNmeaDevice)
    from gnuradio4_tpu_torch.core.subgraph import ScheduledSubgraph
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck

    secs = {}
    t_sub = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_host_core_"))

    def lap(name: str) -> None:
        nonlocal t_sub
        now = time.perf_counter()
        secs[name] = now - t_sub
        t_sub = now

    def tally(counts: dict) -> None:
        for k in KERNELS:
            results[k]["launches"] += counts[k]

    per_step4 = {"fir_banded": 2, "nco_mix": 0}      # phase 4's launches a step
    per_step5 = {"fir_banded": 2, "nco_mix": 1}      # phase 5's

    # (a) the headline chain across two graphs, absorbed then derotated
    for absorb, ref, per_step, label in ((True, phase45[0], per_step4, "absorbed"),
                                         (False, phase45[1], per_step5, "derotated")):
        ck.reset_launch_counts()
        got, a_s, d_s, wall = piped_chain(dev, PIPE_STEPS, absorb=absorb)
        counts = ck.launch_counts()
        tally(counts)
        # the last dsp step carries the end of stream (no valid sample)
        check(d_s.steps == PIPE_STEPS + 1 and a_s.steps >= PIPE_STEPS,
              f"piped {label}: dsp ran {d_s.steps} steps, acq {a_s.steps}")
        for k, want in per_step.items():
            check(counts[k] == want * d_s.steps,
                  f"piped {label}: {k} launched {counts[k]} times over "
                  f"{d_s.steps} dsp steps, expected {want} a step")
        same = [np.array_equal(x, y) for x, y in zip(got, ref)]
        check(all(same) and got[0].shape == ref[0].shape,
              f"piped {label}: sinks equal to phase {4 if absorb else 5}'s: {same}")
        print(f"[28a pipe {label}] acq ComplexToneSource → PipeSink ⇒ dsp "
              f"StreamSource → chain, {PIPE_STEPS} steps of 2^23: sinks bitwise equal "
              f"to phase {4 if absorb else 5}'s; launches {counts} over {d_s.steps} "
              f"dsp steps ({ {k: counts[k] / d_s.steps for k in per_step} } a step, "
              f"phase {4 if absorb else 5}: {per_step}); {wall:.3f} s wall {card}")
    del got
    lap("a checks")

    # timed: NullSinks, 16 steps, one Profiler("chip_smoke") over both graphs
    # with instant and counter marks: the ring's fill sampled every 2 ms
    prof = gt.Profiler("chip_smoke")
    stream = pipe_source()
    ring = stream._ensure_ring()
    check(ring.is_native and ring.producers == "multi",
          f"pipe: ring native {ring.is_native}, producers {ring.producers}")
    stop = threading.Event()

    def sample_ring():
        while not stop.is_set():
            prof.counter("pipe.ring", readable=ring.readable(stream._reader))
            time.sleep(0.002)

    sampler = threading.Thread(target=sample_ring, daemon=True)
    sampler.start()
    prof.instant("phase28a.start", steps=PIPE_TIMED_STEPS)
    try:
        ck.reset_launch_counts()
        _, a_s, d_s, wall = piped_chain(dev, PIPE_TIMED_STEPS, sinks="null",
                                        profiler=prof, stream=stream)
        counts = ck.launch_counts()
    finally:
        stop.set()
        sampler.join(5)
    tally(counts)
    prof.instant("phase28a.end", wall_s=wall)
    check(counts["fir_banded"] == 2 * d_s.steps == 2 * (PIPE_TIMED_STEPS + 1),
          f"piped timed run: fir_banded {counts['fir_banded']} over {d_s.steps} steps")
    dsp_steps = span_ms(prof, "scheduler.step", tid=thread_tid(d_s))
    acq_steps = span_ms(prof, "scheduler.step", tid=thread_tid(a_s))
    consume = span_ms(prof, "block.consume", block="pipe")
    feed = span_ms(prof, "block.host_feed", block="stream")
    deliver_acq = span_ms(prof, "scheduler.deliver", tid=thread_tid(a_s))
    check(len(consume) >= PIPE_TIMED_STEPS and len(feed) >= PIPE_TIMED_STEPS,
          f"profiler spans: {len(consume)} consume, {len(feed)} host_feed")
    steady = dsp_steps[2:] or dsp_steps
    dsp_ms = statistics.median(steady)
    msps = BLOCK_LEN / (dsp_ms * 1e-3) / 1e6
    msps_wall = PIPE_TIMED_STEPS * BLOCK_LEN / wall / 1e6
    trace = tmp / "phase28a.trace.json"
    prof.write(str(trace))
    doc = _json.loads(trace.read_text())
    kinds = {(e["name"], e["ph"]) for e in doc["traceEvents"]}
    check({("phase28a.start", "i"), ("phase28a.end", "i"), ("pipe.ring", "C"),
           ("block.consume", "X"), ("block.host_feed", "X"),
           ("scheduler.step", "X")} <= kinds
          and doc["otherData"] == {"process": "chip_smoke"},
          f"the chrome trace lacks marks: {sorted(kinds)[:12]}")
    fills = [e["args"]["readable"] for e in doc["traceEvents"] if e["name"] == "pipe.ring"]
    print(f"[28a pipe timed] {PIPE_TIMED_STEPS} steps of 2^23 (NullSinks): dsp "
          f"{msps:.2f} Msps (median dsp step {dsp_ms:.3f} ms after 2 steps; "
          f"{msps_wall:.2f} Msps over the {wall:.3f} s wall) against phase 4's "
          f"{chain_msps:.2f} Msps in one graph; host ms a step: PipeSink.consume "
          f"{statistics.median(consume):.3f} (acq delivery "
          f"{statistics.median(deliver_acq):.3f}, acq step "
          f"{statistics.median(acq_steps):.3f}), StreamSource.host_feed "
          f"{statistics.median(feed):.3f}; 4 host copies of 64 MiB a step; the "
          f"ring's fill (items) min/median/max {min(fills, default=0)}/"
          f"{int(statistics.median(fills)) if fills else 0}/{max(fills, default=0)} over "
          f"{len(fills)} samples; trace {len(doc['traceEvents'])} events; the ring "
          f"native {ring.is_native}, producers {ring.producers!r}, capacity "
          f"{ring.capacity} {card}")
    paths.append({"name": "phase 28a piped chain", "msps": msps, "msps_wall": msps_wall,
                  "ms_per_step": dsp_ms, "phase4_msps": chain_msps,
                  "ring_native": ring.is_native, "ring_producers": ring.producers,
                  "ring_capacity": ring.capacity,
                  "pipe_consume_ms": statistics.median(consume),
                  "stream_feed_ms": statistics.median(feed),
                  "acq_deliver_ms": statistics.median(deliver_acq)})
    lap("a timed")

    # each wait strategy, 2 steps: the sinks stay equal to phase 4's
    ref2 = first_steps(phase45[0], WAIT_STEPS)
    wait_msps = {}
    for wait in WAITS:
        wprof = gt.Profiler()
        ck.reset_launch_counts()
        got, _, d_s, wall = piped_chain(dev, WAIT_STEPS, wait=wait, profiler=wprof)
        tally(ck.launch_counts())
        same = [np.array_equal(x, y) for x, y in zip(got, ref2)]
        check(all(same), f"piped wait={wait}: sinks differ from phase 4's: {same}")
        steps_ms = span_ms(wprof, "scheduler.step", tid=thread_tid(d_s))
        feed = span_ms(wprof, "block.host_feed", block="stream")
        wait_msps[wait] = WAIT_STEPS * BLOCK_LEN / (sum(steps_ms) * 1e-3) / 1e6
        print(f"[28a wait={wait}] {WAIT_STEPS} steps of 2^23 with VectorSinks: sinks "
              f"bitwise equal to phase 4's first {WAIT_STEPS} steps; dsp "
              f"{wait_msps[wait]:.2f} Msps over its step spans "
              f"({[round(x, 3) for x in steps_ms]} ms), host_feed "
              f"{[round(x, 3) for x in feed]} ms; {wall:.3f} s wall {card}")
    paths.append({"name": "phase 28a wait strategies", "msps": wait_msps})
    lap("a waits")

    # (b) ScheduledSubgraph: FreqXlatingFir → QuadratureDemod under its own
    # scheduler on the card, against the same blocks run flat
    def sub_run(flat: bool):
        g = gt.Graph()
        src = ComplexToneSource(frequency=1e6, n_samples=SUB_STEPS * SUB_BLOCK_LEN)
        fir, dem = chain_xlating_fir(), QuadratureDemod(gain=1.0)
        snk = VectorSink(name="demod")
        fed = []
        if flat:
            g.connect_chain(src, fir, dem, snk)
            sub = None
        else:
            inner = gt.Graph(name="inner")
            inner.connect(fir, dem)
            inner.export_in("in", fir, "in")
            inner.export_out("out", dem, "out")
            sub = ScheduledSubgraph(inner, name="sub", out_dtypes={"out": "float32"})
            feed = sub.host_feed

            def counted(n, abs_index):
                got = feed(n, abs_index)
                fed.append(None if got is None else got[1])
                return got
            sub.host_feed = counted
            g.connect_chain(src, sub, snk)
        sched = gt.Scheduler(g, block_len=SUB_BLOCK_LEN, sample_rate=FS, device=dev)
        ck.reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        sched.run_and_wait()
        sync(dev)
        wall = time.perf_counter() - t0
        counts = ck.launch_counts()
        tally(counts)
        return snk.data(), sched, sub, fed, wall, counts, fir

    flat, f_s, _, _, f_wall, f_counts, f_fir = sub_run(True)
    out, o_s, sub, fed, wall, counts, fir = sub_run(False)
    n_sub = SUB_STEPS * SUB_BLOCK_LEN
    warm = 0
    for nv in fed:
        if nv:
            break
        warm += 1
    check(fir._rotation_absorbed and f_fir._rotation_absorbed,
          "subgraph: the rotation is absorbed in both runs")
    check(out.shape == flat.shape == (n_sub,),
          f"subgraph: {out.shape} samples against the flat run's {flat.shape}")
    check(out[0] == flat[0] and np.array_equal(out, flat),
          f"subgraph: output differs from the flat run "
          f"(max|Δ| {float(np.max(np.abs(out - flat))) if out.shape == flat.shape else None})")
    # one FIR launch a step of each scheduler; the inner one ends with a
    # step that carries the end of stream
    check(counts["fir_banded"] == sub._inner_sched.steps == SUB_STEPS + 1
          and f_counts["fir_banded"] == f_s.steps and counts["nco_mix"] == 0,
          f"subgraph: launches {counts} over {sub._inner_sched.steps} inner steps, "
          f"flat {f_counts} over {f_s.steps}")
    check(sub._inner_sched.device.type == torch.device(dev).type,
          f"subgraph: inner scheduler on {sub._inner_sched.device}, "
          f"{sub._inner_sched.steps} steps")
    print(f"[28b subgraph] ComplexToneSource → ScheduledSubgraph(FreqXlatingFir(127) → "
          f"QuadratureDemod) → VectorSink, {SUB_STEPS} steps of 2^22: lossless "
          f"({n_sub} samples), bitwise equal to the flat run, first valid sample "
          f"{out[0]:.7f} = the flat run's; fir_banded {counts['fir_banded']} launches "
          f"by the inner scheduler ({sub._inner_sched.steps} inner steps on "
          f"{sub._inner_sched.device}); warm-up {warm} outer steps of n_valid 0, "
          f"{o_s.steps} outer steps, {wall / o_s.steps * 1e3:.3f} ms per outer step "
          f"({wall:.3f} s) against the flat run's {f_wall / f_s.steps * 1e3:.3f} ms "
          f"({f_s.steps} steps) {card}")
    paths.append({"name": "phase 28b scheduled subgraph", "warmup_steps": warm,
                  "outer_steps": o_s.steps, "ms_per_outer_step": wall / o_s.steps * 1e3,
                  "flat_ms_per_step": f_wall / f_s.steps * 1e3})
    del out, flat
    lap("b subgraph")

    # (c) the user-function blocks on the FM tone's demod output
    np_body = "def process(x):\n    return np.clip(x, -1.0, 1.0) * 0.5"
    torch_body = "def process(x):\n    return torch.clamp(x, -1.0, 1.0) * 0.5"

    def forms():
        return {
            "HostBlock": HostBlock(lambda x: np.clip(x, -1.0, 1.0) * 0.5),
            "PythonBlock host": PythonBlock(code=np_body, mode="host"),
            "PythonBlock jax": PythonBlock(code=torch_body, mode="jax"),
            "LambdaBlock": LambdaBlock(lambda x: torch.clamp(x, -1.0, 1.0) * 0.5),
            "HostBlock int16": HostBlock(
                lambda x: np.round(x * USER_QUANT).astype(np.int16),
                out_shape_fn=lambda x: torch.empty(x.shape, dtype=torch.int16,
                                                   device="meta")),
        }

    def user_run(device, block_len):
        g = gt.Graph()
        src = VectorSource(data=fm_tone(USER_STEPS * block_len), device_resident=True)
        dem = QuadratureDemod(gain=USER_GAIN)
        g.connect_chain(src, chain_xlating_fir(), dem)
        sinks = {"demod": VectorSink()}
        g.connect(dem, sinks["demod"])
        blocks = forms()
        for name, blk in blocks.items():
            sinks[name] = VectorSink()
            g.connect_chain(dem, blk, sinks[name])
        gt.Scheduler(g, block_len=block_len, sample_rate=FS, device=device).run_and_wait()
        return {k: v.data() for k, v in sinks.items()}, blocks

    ck.reset_launch_counts()
    card_out, blocks = user_run(dev, USER_BLOCK_LEN)
    tally(ck.launch_counts())
    demod = card_out["demod"]
    want = np.clip(demod, -1.0, 1.0) * np.float32(0.5)
    clipped = float(np.mean(np.abs(demod) > 1.0))
    check(demod.shape == (USER_STEPS * USER_BLOCK_LEN,) and 0.1 < clipped < 0.9,
          f"user blocks: demod {demod.shape}, clipped share {clipped}")
    for name in ("HostBlock", "PythonBlock host", "PythonBlock jax", "LambdaBlock"):
        y = card_out[name]
        check(y.dtype == np.float32 and np.array_equal(y, want),
              f"user blocks: {name} differs ({y.dtype}, max|Δ| "
              f"{float(np.max(np.abs(y - want))) if y.shape == want.shape else y.shape})")
    q = card_out["HostBlock int16"]
    check(q.dtype == np.int16 and q.shape == demod.shape
          and np.array_equal(q, np.round(demod * USER_QUANT).astype(np.int16)),
          f"user blocks: the int16 HostBlock gave {q.dtype} {q.shape}")
    cpu_out, _ = user_run("cpu", USER_CPU_BLOCK_LEN)
    small, _ = user_run(dev, USER_CPU_BLOCK_LEN)
    diffs = {}
    for name, y in small.items():
        y_cpu = cpu_out[name]
        check(y.shape == y_cpu.shape and y.dtype == y_cpu.dtype,
              f"user blocks card vs CPU: {name} {y.shape} {y.dtype} against "
              f"{y_cpu.shape} {y_cpu.dtype}")
        d = float(np.max(np.abs(y.astype(np.float64) - y_cpu)))
        tol = USER_GAIN * AUDIO_ATOL * (USER_QUANT if name == "HostBlock int16" else 1.0)
        diffs[name] = d
        check(d <= tol + (1.0 if name == "HostBlock int16" else 0.0),
              f"user blocks card vs CPU: {name} max|Δ| {d} > {tol}")
    # host ms a step of each form's apply on the card's 2^22 demod tensor
    x = torch.from_numpy(demod[:USER_BLOCK_LEN]).to(dev)
    ctx = gt.BlockCtx(in_len={"in": USER_BLOCK_LEN}, out_len={"out": USER_BLOCK_LEN},
                      sample_rate=FS, params={}, device=torch.device(dev))
    host_ms = {}
    for name, blk in forms().items():
        times = []
        for _ in range(USER_REPS):
            sync(dev)
            t0 = time.perf_counter()
            blk.apply(None, {"in": x}, ctx)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        host_ms[name] = statistics.median(times)
    print(f"[28c user blocks] FM tone → FreqXlatingFir → QuadratureDemod(gain "
          f"{USER_GAIN}) → {{HostBlock, PythonBlock host, PythonBlock jax, "
          f"LambdaBlock}}(clip ±1 · 0.5), {USER_STEPS} steps of 2^22: all four "
          f"bitwise equal ({clipped:.1%} of samples clipped); the int16 HostBlock "
          f"int16 {q.shape}; card vs CPU at 2^16 max|Δ| "
          f"{ {k: float(f'{v:.3g}') for k, v in diffs.items()} }; ms a step of "
          f"apply + sync on the card at 2^22 (median of {USER_REPS}): "
          f"{ {k: round(v, 3) for k, v in host_ms.items()} } {card}")
    paths.append({"name": "phase 28c user blocks", "apply_ms": host_ms})
    del card_out, cpu_out, small, demod, want, x
    lap("c user blocks")

    # (d) compute domains: a host tap on the FIR, a gpu:cuda:0 FIR → FFT edge,
    # through save_grc/load_grc, against the same chain with a plain tap
    def tapped(domain_fft, domain_tap):
        g, fir, _, _ = build_chain("vector", fft_domain=domain_fft)
        g.connect(fir, VectorSink(name="tap"), domain=domain_tap)
        return g

    loaded = gt.load_grc(gt.save_grc(tapped("gpu:cuda:0", "host")))
    doms = {e.dst.name: str(e.domain) for e in loaded.edges if e.domain is not None}
    fft_name = next(e.dst.name for e in loaded.edges
                    if type(e.dst).__name__ == "FFT")
    check(doms == {"tap": "host::0", fft_name: "gpu:cuda:0"},
          f"domains after save_grc/load_grc: {doms}")

    def run_taps(g):
        ck.reset_launch_counts()
        gt.Scheduler(g, block_len=BLOCK_LEN, sample_rate=FS,
                     device=dev).run_and_wait(DOMAIN_STEPS)
        sync(dev)
        tally(ck.launch_counts())
        by = {b.name: b for b in g.blocks}
        return by["tap"].data(), by["spec"].data(), by["audio"].data()

    tap, spec, audio = run_taps(loaded)
    tap_f, spec_f, audio_f = run_taps(tapped(None, None))
    ref = first_steps(phase45[1], DOMAIN_STEPS)
    check(tap.shape == (DOMAIN_STEPS * BLOCK_LEN,) and np.array_equal(tap, tap_f),
          "domains: the host tap differs from the flat run's FIR output")
    check(np.array_equal(spec, spec_f) and np.array_equal(audio, audio_f)
          and np.array_equal(spec, ref[0]) and np.array_equal(audio, ref[1]),
          "domains: the tapped chain's sinks differ from the flat run's or phase 5's")
    try:
        g_tpu, _, _, _ = build_chain("null", fft_domain="tpu")
        gt.Scheduler(g_tpu, block_len=BLOCK_LEN, sample_rate=FS, device=dev).init()
        tpu_err = None
    except gt.GrError as e:
        tpu_err = str(e)
    check(tpu_err is not None and "'tpu'" in tpu_err,
          f"a tpu edge compiled (error: {tpu_err})")
    print(f"[28d domains] the chain with a host tap on the FIR and a gpu:cuda:0 FIR → "
          f"FFT edge: {doms} after save_grc/load_grc; the reloaded chain's tap "
          f"({tap.dtype} {tap.shape}) bitwise equal to the flat run's FIR output, its "
          f"sinks to phase 5's (the tap keeps the rotation); a tpu edge refused: "
          f"{tpu_err.split(' (')[0][:90]}… {card}")
    del tap, tap_f, spec, spec_f, audio, audio_f
    lap("d domains")

    # (e) merge on the card, GPS and PPS timing card vs CPU
    rng = np.random.default_rng(SEED)
    xm = rng.standard_normal(MERGE_STEPS * MERGE_LEN).astype(np.float32)

    def merge_run(fused: bool):
        reg = gt.global_registry
        members = [reg.create("MultiplyConst", value=2.0),
                   reg.create("AddConst", value=1.0),
                   reg.create("Decimator", decim=2)]
        chain = [gt.merge(*members)] if fused else members
        g = gt.Graph()
        snk = VectorSink()
        g.connect_chain(VectorSource(data=xm, device_resident=True), *chain, snk)
        gt.Scheduler(g, block_len=MERGE_LEN, sample_rate=FS, device=dev).run_and_wait()
        return snk.data()

    merged, plain = merge_run(True), merge_run(False)
    check(merged.shape == (MERGE_STEPS * MERGE_LEN // 2,)
          and np.array_equal(merged, plain)
          and np.array_equal(merged, (xm * np.float32(2.0) + np.float32(1.0))[::2]),
          "merge: the merged chain differs from the unmerged one")

    def timing_tags(device):
        tags = {}
        g = gt.Graph()
        snk = VectorSink()
        g.connect(GpsSource(device=ReplayNmeaDevice([NMEA_OK, NMEA_GGA, NMEA_OK]),
                            sample_rate=100.0, n_samples=400), snk)
        gt.Scheduler(g, block_len=100, device=device).run_and_wait()
        tags["gps"] = [(int(t.index), dict(t.map)) for t in snk.tags
                       if t.map.get(gt.Keys.TRIGGER_NAME) == "gps_pps"]
        tags["gps_data"] = snk.data()
        g = gt.Graph()
        snk = VectorSink()
        g.connect(PpsSource(sample_rate=100.0, n_samples=1000), snk)
        gt.Scheduler(g, block_len=250, device=device).run_and_wait()
        tags["pps"] = sorted(int(t.index) for t in snk.tags
                             if t.map.get(gt.Keys.TRIGGER_NAME) == "pps")
        return tags

    on_card, on_cpu = timing_tags(dev), timing_tags("cpu")
    check(len(on_card["gps"]) >= 2 and any("lat" in m for _, m in on_card["gps"]),
          f"GpsSource tags {on_card['gps']}")
    check(on_card["pps"] == [0, 100, 200, 300, 400, 500, 600, 700, 800, 900],
          f"PpsSource tags {on_card['pps']}")
    check(on_card["gps"] == on_cpu["gps"] and on_card["pps"] == on_cpu["pps"]
          and np.array_equal(on_card["gps_data"], on_cpu["gps_data"]),
          "timing: the card's tags differ from the CPU's")
    print(f"[28e merge, timing] merge(MultiplyConst(2), AddConst(1), Decimator(2)) at "
          f"2^22 × {MERGE_STEPS}: bitwise equal to the unmerged chain; GpsSource on "
          f"ReplayNmeaDevice: {len(on_card['gps'])} gps_pps tags at "
          f"{[i for i, _ in on_card['gps']]}, PpsSource: {on_card['pps']}; card equal "
          f"to CPU {card}")
    del xm, merged, plain
    lap("e merge timing")

    # (f) device_trace over one step of the chain
    g, _, _, _ = build_chain("null")
    sched = gt.Scheduler(g, block_len=BLOCK_LEN, sample_rate=FS, device=dev)
    for _ in range(2):
        sched.step_once()
    sync(dev)
    tprof = gt.Profiler("chip_smoke_device")
    with tprof.device_trace(str(tmp / "device")):
        sched.step_once()
        sync(dev)
    files = sorted((tmp / "device").glob("chip_smoke_device.*.trace.json"))
    check(len(files) == 1, f"device_trace wrote {files}")
    events = _json.loads(files[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    fir_k = [k for k in kernels if "fir_banded" in k]
    check(len(fir_k) == 2, f"device_trace: fir_banded kernels {fir_k} among "
                           f"{len(kernels)} kernels")
    print(f"[28f device_trace] one chain step: {len(kernels)} kernels in the chrome "
          f"trace, {len(fir_k)} of them fir_banded ({[k[:60] for k in fir_k]}) {card}")
    del sched, g
    lap("f device trace")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[28 seconds] wall s by sub-phase {({k: round(v, 2) for k, v in secs.items()})}"
          f"; phase 28 {sum(secs.values()):.1f} s {card}")
    paths.append({"name": "phase 28 seconds", "seconds": sum(secs.values()),
                  "by_sub_phase": secs})


def io_phases(dev, card: str, phase45, paths: list, results: dict) -> None:
    """Phase 29: the IO entry points — an RTL-SDR FM receiver through the
    protocol driver, a SigMF replay of the chain, two graphs joined by TCP,
    the piped chain over the native ring, and the registry and drivers."""
    import importlib.util
    import socket
    import tempfile
    import wave
    import numpy as np
    import torch
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks import rtl2832 as trtl
    from gnuradio4_tpu_torch.blocks import sdr as tsdr
    from gnuradio4_tpu_torch.blocks import sigmf as tsigmf
    from gnuradio4_tpu_torch.blocks import soapy as tsoapy
    from gnuradio4_tpu_torch.blocks.audio import AudioSink
    from gnuradio4_tpu_torch.blocks.basic import ComplexToneSource
    from gnuradio4_tpu_torch.blocks.filter import FirFilter
    from gnuradio4_tpu_torch.blocks.network import TcpSink, TcpSource
    from gnuradio4_tpu_torch.blocks.sdr import QuadratureDemod
    from gnuradio4_tpu_torch.blocks.testing import NullSink, VectorSink
    from gnuradio4_tpu_torch.native import convert as cv
    from gnuradio4_tpu_torch.native import ring as nring
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck
    from gnuradio4_tpu_torch.ops import filter_design as fd

    secs = {}
    t_sub = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_io_"))

    def lap(name: str) -> None:
        nonlocal t_sub
        now = time.perf_counter()
        secs[name] = now - t_sub
        t_sub = now

    def tally(counts: dict) -> None:
        for k in KERNELS:
            results[k]["launches"] += counts[k]

    def timed(fn, sink: list):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sink.append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    def med(xs) -> float:
        return statistics.median(xs) if xs else float("nan")

    check(nring.native_available() and cv.native_available(),
          "the native ring and converters did not build")
    print(f"[29 native] ring {nring._lib._name}, converters {cv._lib._name} "
          f"(built at first use by g++) {card}")

    # (a) an RTL-SDR FM receiver through the real protocol driver
    rng = np.random.default_rng(SEED)
    period = int(RTL_FS / RTL_TONE)            # samples a tone cycle
    k = np.arange(100 * period)                # whole cycles: the repeat is seamless
    msg = np.sin(2 * np.pi * k / period)
    air = (0.8 * np.exp(1j * 2 * np.pi * RTL_DEV / RTL_FS * np.cumsum(msg))
           + RTL_NOISE * (rng.standard_normal(len(k)) + 1j * rng.standard_normal(len(k))))

    def rtl_graph(sink):
        fake = trtl.FakeRtlUsb(waveform=air, waveform_freq=RTL_FC + RTL_OFFSET)
        src = tsdr.SdrSource(name="rtl", driver="rtlsdr",
                             device=trtl._make_rtlsdr_device()(usb=fake),
                             sample_rate=RTL_FS, center_frequency=RTL_FC)
        rx = tsdr.make_wbfm_receiver(quad_rate=RTL_FS, audio_decim=RTL_DECIM,
                                     center_freq=RTL_OFFSET, max_dev=RTL_DEV,
                                     ntaps=127)
        g = gt.Graph()
        g.add(rx)
        g.connect(src, rx["in"])
        g.connect(rx["out"], sink)
        return g, rx, fake

    wav = tmp / "rtl_fm.wav"
    asink = AudioSink(name="speaker", backend="file", device=str(wav),
                      sample_rate=RTL_FS / RTL_DECIM)
    g, rx, fake = rtl_graph(asink)
    bulk_ms, conv_ms = [], []
    fake.on_bulk_read(timed(fake._gen_samples, bulk_ms))
    u8iq = cv.u8iq_to_c64
    cv.u8iq_to_c64 = timed(u8iq, conv_ms)
    prof = gt.Profiler()
    by_shape, fir_run = {}, 0         # fir_banded launches of (a)'s runs
    try:
        sched = gt.Scheduler(g, block_len=RTL_BLOCK_LEN, sample_rate=RTL_FS,
                             device=dev, profiler=prof)
        step_ms, per_step = [], []
        for i in range(RTL_WARM + RTL_STEPS):
            if i == RTL_WARM:
                bulk_ms.clear()
                conv_ms.clear()
                sched.profiler = prof = gt.Profiler()
            ck.reset_launch_counts()
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
            with count_fir_shapes(by_shape):
                check(sched.step_once(), "rtl: the stream ended")
            e_ev.record()
            torch.cuda.synchronize()
            counts = ck.launch_counts()
            tally(counts)
            fir_run += counts["fir_banded"]
            if i >= RTL_WARM:
                step_ms.append(s_ev.elapsed_time(e_ev))
                per_step.append(counts)
        finish(sched)
        for b in sched.compiled.order:
            b.stop()
    finally:
        cv.u8iq_to_c64 = u8iq
    bl = sched.compiled.block_len
    n_audio = bl // RTL_DECIM
    with wave.open(str(wav)) as w:
        frames, rate = w.getnframes(), w.getframerate()
        pcm = np.frombuffer(w.readframes(frames), "<i2").astype(np.float32) / 32768.0
    check(rate == int(RTL_FS / RTL_DECIM) and frames == (RTL_WARM + RTL_STEPS) * n_audio,
          f"rtl: WAV {frames} frames at {rate} Hz, expected "
          f"{(RTL_WARM + RTL_STEPS) * n_audio} at {RTL_FS / RTL_DECIM:.0f}")
    settled = pcm[n_audio:]
    spec = np.abs(np.fft.rfft(settled * np.hanning(len(settled))))
    kk = int(np.argmax(spec[1:])) + 1
    f_hz = kk * rate / len(settled)
    share = float(spec[kk - 2:kk + 3].sum() / spec[1:].sum())
    check(abs(f_hz - RTL_TONE) < 20.0 and share > 0.25,
          f"rtl: audio peak at {f_hz:.1f} Hz with {share:.1%} of the spectrum")
    fir_per = {c["fir_banded"] for c in per_step}
    nco_per = {c["nco_mix"] for c in per_step}
    check(fir_per == {2}, f"rtl: fir_banded launches a step {fir_per}")
    feed = span_ms(prof, "block.host_feed", block="rtl")
    consume = span_ms(prof, "block.consume", block="speaker")
    ms = med(step_ms)
    rtf = bl / RTL_FS / (ms * 1e-3)
    print(f"[29a rtl-sdr] wire: USB bulk endpoint 0x81 (FakeRtlUsb, u8 IQ, "
          f"{len(air)}-sample seeded station at +{RTL_OFFSET / 1e3:.0f} kHz) → "
          f"rtlsdr driver → native u8iq → card → WAV file; block_len {bl} at "
          f"{fake.sample_rate:.1f} S/s, {RTL_STEPS} timed steps after {RTL_WARM}: "
          f"{ms:.3f} ms a step (CUDA events; steps {[round(x, 3) for x in step_ms]}), "
          f"real-time factor {rtf:.2f}; host_feed {med(feed):.3f} ms (bulk read "
          f"{med(bulk_ms):.3f}, u8iq conversion {med(conv_ms):.3f}), AudioSink "
          f"consume {med(consume):.3f} ms; launches a step fir_banded {fir_per}, "
          f"nco_mix {nco_per}; WAV {frames} frames at {rate} Hz; audio peak "
          f"{f_hz:.2f} Hz ({share:.1%} of the spectrum) {card}")
    paths.append({"name": "phase 29a rtl-sdr fm", "ms_per_step": ms,
                  "real_time_factor": rtf, "host_feed_ms": med(feed),
                  "bulk_read_ms": med(bulk_ms), "u8iq_ms": med(conv_ms),
                  "consume_ms": med(consume), "block_len": bl})
    del sched, g
    audios = {}
    for device in ("cpu", dev):
        snk = VectorSink()
        g, _, _ = rtl_graph(snk)
        ck.reset_launch_counts()
        with count_fir_shapes(by_shape):
            gt.Scheduler(g, block_len=RTL_CPU_BLOCK_LEN, sample_rate=RTL_FS,
                         device=device).run_and_wait(2)
        sync(dev)
        counts = ck.launch_counts()
        tally(counts)
        fir_run += counts["fir_banded"]
        audios[str(device)] = snk.data()
    a_cpu, a_card = audios["cpu"], audios[str(dev)]
    err = float(np.max(np.abs(a_cpu - a_card))) if a_cpu.shape == a_card.shape else np.inf
    print(f"[29a rtl-sdr] card vs CPU, 2 steps of {RTL_CPU_BLOCK_LEN}: audio "
          f"{a_card.shape}, max|Δ| {err:.3e} (tol {RTL_ATOL}) {card}")
    check(err <= RTL_ATOL, f"rtl: card vs CPU {err}")
    check(sum(by_shape.values()) == fir_run,
          f"rtl: fir_banded launches by shape {by_shape} against {fir_run} counted")
    print(f"[29a rtl-sdr] fir_banded launches by (stream, K, decim, T) over the "
          f"timed run and the card's check run: {by_shape} {card}")
    # fir_banded at the timed run's two shapes, on the receiver's own taps:
    # the channel filter (c64 × f32 K 127 ÷1) and the audio filter (f32 K 127
    # ÷50); each row's launches are those counted at its shape above
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = results["fir_banded"].setdefault("timed_shapes", [])
    for blk, x_dt, decim in ((f"{rx.name}.channel", torch.complex64, 1),
                             (f"{rx.name}.audio", torch.float32, RTL_DECIM)):
        taps_np = next(b for b in rx.blocks if b.name == blk).settings.get("taps")
        taps = torch.from_numpy(np.ascontiguousarray(taps_np, np.float32)).to(dev)
        kt = taps.shape[0]
        launches = by_shape.get(("c64" if x_dt == torch.complex64 else "f32", kt,
                                 decim, bl), 0)
        check(launches == RTL_WARM + RTL_STEPS,
              f"fir_banded, {blk}: {launches} launches at its shape {by_shape}")
        x = torch.randn(bl, dtype=x_dt, device=dev, generator=gen)
        hist = torch.randn(kt - 1, dtype=x_dt, device=dev, generator=gen)
        fe = float((ck.fir_banded(x, hist, taps, decim)
                    - ck.fir_banded_ref(x, hist, taps, decim)).abs().max())
        k_ms, p_ms = kernel_vs_plain_ms(lambda: ck.fir_banded(x, hist, taps, decim),
                                        lambda: ck.fir_banded_ref(x, hist, taps, decim))
        b_ms, b_by = bound_ms(*fir_work((bl,), x.is_complex(), False, kt, decim))
        lib = conv1d_ms(x, hist, taps, decim)
        kind = "c64 × f32" if x.is_complex() else "f32 × f32"
        print(f"[29a fir_banded, {blk}] {kind} K {kt} ÷{decim} T {bl}: max|Δ| "
              f"{fe:.3e} (tol {FIR_ATOL}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}), {b_ms / k_ms:.1%} of it; F.conv1d "
              f"(TF32 off) {lib:.4f} ms; {launches} launches {card}")
        check(fe <= FIR_ATOL, f"fir_banded, {blk}: {fe}")
        results["fir_banded"]["max_abs_err"] = max(results["fir_banded"]["max_abs_err"], fe)
        row = {"case": f"phase 29 {blk}: {kind} K {kt} ÷{decim} T {bl}",
               "launches": launches, "max_abs_err": fe, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
        rows.append(row)
        paths.append({"name": f"phase 29 fir_banded {row['case']}", **row})
    lap("a rtl")

    # (b) SigMF: phase 4's input recorded (cf32_le and ci16_le), replayed
    # into the chain
    def record(base, datatype):
        g = gt.Graph()
        snk = tsigmf.SigmfSink(path=str(base), datatype=datatype)
        g.connect(ComplexToneSource(frequency=1e6, n_samples=STEPS * BLOCK_LEN), snk)
        t0 = time.perf_counter()
        gt.Scheduler(g, block_len=BLOCK_LEN, sample_rate=FS, device=dev).run_and_wait()
        return time.perf_counter() - t0

    def replay(base, sinks, steps, repeat=False, profiler=None):
        src = tsigmf.SigmfSource(name="sigmf", path=str(base), repeat=repeat)
        g, fir, s1, s2 = build_chain(sinks, source=src)
        kw = {"profiler": profiler} if profiler is not None else {}
        return gt.Scheduler(g, block_len=BLOCK_LEN, sample_rate=FS, device=dev,
                            **kw), fir, s1, s2

    absorbed = phase45[0]
    xl_taps = chain_xlating_fir().settings.get("taps")
    audio_taps = fd.design_fir("lowpass", 63, sample_rate=FS, f_low=1e6)
    # ci16_le's error: half a step of rounding and up to one step of the
    # ×32767/÷32768 scales on each of I and Q, through the FIR (ℓ1 of its
    # taps), into the 4096-point Hann FFT (ℓ1 of the window) and the demod
    # (the angle moves by ≤ 2|Δy|/|y| with |y| ≥ 0.5 for the tone in the
    # pass band), then the audio FIR; plus the float32 tolerances
    e_x = np.sqrt(2.0) * 2.0 / 32768
    e_y = float(np.sum(np.abs(xl_taps))) * e_x
    spec_tol = float(np.sum(np.hanning(4096))) * e_y + SPEC_RTOL * float(np.max(absorbed[0]))
    audio_tol = float(np.sum(np.abs(audio_taps))) * 2 * e_y / 0.5 + AUDIO_ATOL
    for datatype in (None, "ci16_le"):
        name = datatype or "cf32_le"
        base = tmp / f"chain_{name}"
        rec_s = record(base, datatype)
        size = (tmp / f"chain_{name}.sigmf-data").stat().st_size
        meta = json.loads((tmp / f"chain_{name}.sigmf-meta").read_text())
        check(meta["global"]["core:datatype"] == name
              and meta["global"]["core:sample_rate"] == FS
              and size == STEPS * BLOCK_LEN * (8 if datatype is None else 4),
              f"sigmf {name}: meta {meta['global']}, {size} bytes")
        ck.reset_launch_counts()
        sched, fir, s1, s2 = replay(base, "vector", STEPS)
        sched.run_and_wait(STEPS)
        sync(dev)
        counts = ck.launch_counts()
        tally(counts)
        got = (s1.data(), s2.data())
        if datatype is None:
            same = [np.array_equal(a, b) for a, b in zip(got, absorbed)]
            check(all(same), f"sigmf cf32_le replay: sinks equal to phase 4's: {same}")
            verdict = "bitwise equal to phase 4's"
        else:
            check(got[0].shape == absorbed[0].shape and got[1].shape == absorbed[1].shape,
                  f"sigmf ci16_le: shapes {got[0].shape} {got[1].shape}")
            ds = float(np.max(np.abs(got[0] - absorbed[0])))
            da = float(np.max(np.abs(got[1][8:] - absorbed[1][8:])))
            check(ds <= spec_tol and da <= audio_tol,
                  f"sigmf ci16_le: spectrum max|Δ| {ds} (tol {spec_tol}), audio "
                  f"{da} (tol {audio_tol})")
            verdict = (f"within the quantisation error of phase 4's: spectrum "
                       f"max|Δ| {ds:.3e} (tol {spec_tol:.3e}), audio max|Δ| "
                       f"{da:.3e} (tol {audio_tol:.3e})")
        check(counts["fir_banded"] == 2 * STEPS and counts["nco_mix"] == 0,
              f"sigmf {name}: launches {counts}")
        del got
        # timing: the recording repeated, NullSinks, per-step CUDA events
        conv = []
        w2iq = tsigmf._wire_to_iq
        tsigmf._wire_to_iq = timed(w2iq, conv)
        tprof = gt.Profiler()
        ck.reset_launch_counts()
        try:
            sched, _, _, _ = replay(base, "null", 0, repeat=True, profiler=tprof)
            for _ in range(SIGMF_WARM):
                sched.step_once()
            sync(dev)
            conv.clear()
            sched.profiler = tprof = gt.Profiler()
            ms_b, windows = events_ms_per_step(sched.step_once, SIGMF_TIMED, windows=1)
            finish(sched)
        finally:
            tsigmf._wire_to_iq = w2iq
        sync(dev)
        t_counts = ck.launch_counts()
        tally(t_counts)
        check(t_counts["fir_banded"] == 2 * (SIGMF_WARM + SIGMF_TIMED),
              f"sigmf {name} timing: launches {t_counts}")
        feed = span_ms(tprof, "block.host_feed", block="sigmf")
        msps = BLOCK_LEN / (ms_b * 1e-3) / 1e6
        print(f"[29b sigmf {name}] wire: disk → page cache → mapped .sigmf-data "
              f"({size / 2**20:.0f} MiB, {size / STEPS / 2**20:.0f} MiB a step) → "
              f"card; recorded by SigmfSink in {rec_s:.3f} s; replay into the chain, "
              f"{STEPS} steps of 2^23: {verdict}; launches {counts}; timed "
              f"{SIGMF_TIMED} steps (repeat): {msps:.2f} Msps ({ms_b:.3f} ms a step, "
              f"CUDA events; launches {t_counts}), SigmfSource.host_feed "
              f"{med(feed):.3f} ms a step"
              + (f", the native ci16 conversion {med(conv):.3f} ms of it" if conv
                 else " (cf32_le: a copy, no conversion)") + f" {card}")
        paths.append({"name": f"phase 29b sigmf {name}", "msps": msps,
                      "ms_per_step": ms_b, "host_feed_ms": med(feed),
                      "convert_ms": med(conv) if conv else 0.0,
                      "record_s": rec_s})
        (tmp / f"chain_{name}.sigmf-data").unlink()
    lap("b sigmf")

    # (c) two graphs joined by TCP on localhost, against one graph
    def free_port(kind=socket.SOCK_STREAM) -> int:
        with socket.socket(socket.AF_INET, kind) as so:
            so.bind(("127.0.0.1", 0))
            return so.getsockname()[1]

    def demod_audio():
        return (QuadratureDemod(gain=1.0),
                FirFilter(taps=fd.design_fir("lowpass", 63, sample_rate=FS,
                                             f_low=1e6).astype(np.float32), decim=8))

    n_tcp = TCP_STEPS * TCP_BLOCK_LEN
    os.environ["GR4TPU_NO_ROTATION_ABSORB"] = "1"   # as the split graph, whose
    try:                                            # FIR feeds a socket
        g = gt.Graph()
        ref_snk = VectorSink()
        dem, aud = demod_audio()
        g.connect_chain(ComplexToneSource(frequency=1e6, n_samples=n_tcp),
                        chain_xlating_fir(), dem, aud, ref_snk)
        ck.reset_launch_counts()
        gt.Scheduler(g, block_len=TCP_BLOCK_LEN, sample_rate=FS, device=dev).run_and_wait()
        sync(dev)
        ref_counts = ck.launch_counts()
    finally:
        os.environ.pop("GR4TPU_NO_ROTATION_ABSORB", None)
    tally(ref_counts)
    port = free_port()
    tprof = gt.Profiler()
    tx, rx = gt.Graph(name="tx"), gt.Graph(name="rx")
    fir = chain_xlating_fir()
    tx.connect_chain(ComplexToneSource(frequency=1e6, n_samples=n_tcp), fir,
                     TcpSink(name="tcp_tx", port=port, listen=True))
    tcp_src = TcpSource(name="tcp_rx", port=port, listen=False, dtype="complex64",
                        n_samples=n_tcp, connect_timeout=PHASE29_TIMEOUT)
    rx_snk = VectorSink()
    dem, aud = demod_audio()
    rx.connect_chain(tcp_src, dem, aud, rx_snk)
    rt = gt.Runtime("phase29")
    kw = dict(block_len=TCP_BLOCK_LEN, sample_rate=FS, device=dev, profiler=tprof)
    a_s, d_s = rt.add(tx, name="tx", **kw), rt.add(rx, name="rx", **kw)
    ck.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    rt.run_all(timeout=PHASE29_TIMEOUT)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = ck.launch_counts()
    tally(counts)
    check(not fir._rotation_absorbed, "tcp: the FIR feeding a socket derotates")
    got, want = rx_snk.data(), ref_snk.data()
    check(got.shape == want.shape == (n_tcp // 8,) and np.array_equal(got, want),
          f"tcp: {got.shape} samples against {want.shape}, equal "
          f"{got.shape == want.shape and np.array_equal(got, want)}")
    check(counts == ref_counts, f"tcp: launches {counts} against one graph's {ref_counts}")
    ring = tcp_src._feeder.ring
    check(ring.is_native, "tcp: the source's ring is not native")
    rx_steps = span_ms(tprof, "scheduler.step", tid=thread_tid(d_s))
    tx_steps = span_ms(tprof, "scheduler.step", tid=thread_tid(a_s))
    send = span_ms(tprof, "block.consume", block="tcp_tx")
    recv = span_ms(tprof, "block.host_feed", block="tcp_rx")
    rx_ms = med(rx_steps[2:] or rx_steps)
    msps = TCP_BLOCK_LEN / (rx_ms * 1e-3) / 1e6
    gbps = TCP_BLOCK_LEN * 8 / (rx_ms * 1e-3) / 1e9
    print(f"[29c tcp] wire: TCP over localhost between two graphs under one Runtime "
          f"(ComplexToneSource → FreqXlatingFir(127) → TcpSink ⇒ TcpSource → "
          f"QuadratureDemod → FirFilter(63, ÷8)), {TCP_STEPS} steps of 2^22 "
          f"complex64: bitwise equal to the chain in one graph (derotated), launches "
          f"{counts} = one graph's; rx {msps:.2f} Msps ({rx_ms:.3f} ms a step after 2, "
          f"{gbps:.2f} GB/s of samples), tx step {med(tx_steps):.3f} ms; host ms a "
          f"step: TcpSink.consume {med(send):.3f}, TcpSource.host_feed "
          f"{med(recv):.3f}; {wall:.3f} s wall; the source's ring native "
          f"(capacity {ring.capacity}) {card}")
    paths.append({"name": "phase 29c tcp", "msps": msps, "ms_per_step": rx_ms,
                  "gbytes_per_s": gbps, "send_ms": med(send), "recv_ms": med(recv)})
    del got, want
    uport = free_port(socket.SOCK_DGRAM)
    rt = gt.Runtime("phase29udp")
    rx, tx = gt.Graph(), gt.Graph()
    usnk = VectorSink()
    usrc = gt.global_registry.create("UdpSource", port=uport, n_samples=UDP_SAMPLES,
                                     idle_timeout=20.0)
    rx.connect(usrc, usnk)
    tx.connect(gt.global_registry.create("CountingSource", n_samples=UDP_SAMPLES),
               gt.global_registry.create("UdpSink", port=uport, payload_items=1000))
    rt.add(rx, block_len=4096, sample_rate=1e6, device=dev)
    rt.add(tx, block_len=8192, sample_rate=1e6, device=dev)
    rt.run_all(timeout=PHASE29_TIMEOUT)
    y = usnk.data()
    check(len(y) >= UDP_SAMPLES * 3 // 4 and bool(np.all(np.diff(y) > 0))
          and usrc._feeder.ring.is_native,
          f"udp: {len(y)} of {UDP_SAMPLES} samples, in order "
          f"{bool(np.all(np.diff(y) > 0))}")
    print(f"[29c udp] wire: UDP datagrams over localhost (1000 samples each): "
          f"{len(y)} of {UDP_SAMPLES} arrived, in order; the source's ring native "
          f"{card}")
    lap("c tcp udp")

    # (d) phase 28a's timed piped chain already crossed the native ring: its
    # reading, beside PR 16's over the NumPy ring (no second run)
    p28 = next((p for p in paths if p["name"] == "phase 28a piped chain"), None)
    if p28 is None:
        print(f"[29d pipe] phase 28a did not run in this process {card}")
    else:
        check(p28["ring_native"] and p28["ring_producers"] == "multi",
              f"pipe: phase 28a's ring native {p28['ring_native']}, producers "
              f"{p28['ring_producers']}")
        print(f"[29d pipe] phase 28a's timed run crossed the native ring (PipeSink ⇒ "
              f"StreamSource, producers 'multi', capacity {p28['ring_capacity']}): "
              f"dsp {p28['msps']:.2f} Msps, PipeSink.consume "
              f"{p28['pipe_consume_ms']:.3f} ms, StreamSource.host_feed "
              f"{p28['stream_feed_ms']:.3f} ms a step (PR 16 over the NumPy ring: "
              f"184.89–235.56 Msps) {card}")

    # (e) the registry and the drivers
    new = ("SigmfSink", "SigmfSource", "AudioSource", "AudioSink", "TcpSource",
           "TcpSink", "UdpSource", "UdpSink", "HttpSource", "HttpSink")
    zmq_names = ("ZmqPushSink", "ZmqPullSource", "ZmqPubSink", "ZmqSubSource")
    known = set(gt.global_registry.known_blocks())
    have_zmq = importlib.util.find_spec("zmq") is not None
    check(set(new) <= known, f"registry lacks {sorted(set(new) - known)}")
    check((set(zmq_names) <= known) == have_zmq
          and (set(zmq_names) & known) in (set(), set(zmq_names)),
          f"zmq blocks {sorted(set(zmq_names) & known)} with pyzmq {have_zmq}")
    check("rtlsdr" in tsdr._SDR_DRIVERS, "the rtlsdr driver is not registered")
    lib = tmp / "soapy" / "libFakeSoapySDR.so"
    lib.parent.mkdir()
    build = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++20",
                            str(ROOT / "tests" / "fake_soapy.cpp"), "-o", str(lib)],
                           capture_output=True, text=True, timeout=120)
    check(build.returncode == 0, f"fake libSoapySDR: {build.stderr[-500:]}")
    had_soapy = tsdr._SDR_DRIVERS.get("soapy")
    tsoapy.register(lib_path=str(lib))
    try:
        g = gt.Graph()
        snk = VectorSink()
        g.connect_chain(tsdr.SdrSource(driver="soapy", sample_rate=1.024e6,
                                       center_frequency=100e6),
                        gt.global_registry.create("HeadBlock", n_samples=1 << 16), snk)
        gt.Scheduler(g, block_len=1 << 14, sample_rate=1.024e6, device=dev).run_and_wait()
    finally:
        if had_soapy is None:
            tsdr._SDR_DRIVERS.pop("soapy", None)
        else:
            tsdr._SDR_DRIVERS["soapy"] = had_soapy
    x = snk.data()
    f_pk = np.fft.fftfreq(len(x), 1 / 1.024e6)[int(np.argmax(np.abs(np.fft.fft(x))))]
    check(x.shape == (1 << 16,) and abs(f_pk - 50e3) < 2 * 1.024e6 / len(x),
          f"soapy: {x.shape}, peak at {f_pk} Hz")
    print(f"[29e registry, drivers] {len(new)} new types registered; ZeroMQ's four "
          f"{'registered' if have_zmq else 'not registered'} with pyzmq "
          f"{'present' if have_zmq else 'absent'} (as the JAX package does); drivers "
          f"{sorted(tsdr._SDR_DRIVERS)}; wire: the SoapySDR C ABI of a fake library "
          f"built from tests/fake_soapy.cpp into {lib.parent}: SdrSource(driver="
          f"'soapy') streamed {len(x)} samples, the station at {f_pk:.1f} Hz "
          f"(+50 kHz) {card}")
    lap("e registry")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[29 seconds] wall s by sub-phase {({k: round(v, 2) for k, v in secs.items()})}"
          f"; phase 29 {sum(secs.values()):.1f} s {card}")
    paths.append({"name": "phase 29 seconds", "seconds": sum(secs.values()),
                  "by_sub_phase": secs})


def rx_tones(cfg: dict, steps: int, dev, seed: int = SEED):
    """The sharded receiver's input, [B, steps·T] complex64 on ``dev``: in
    every stream one tone per channel, channel c's at c/M + δ/M cycles a
    sample (|δ| ≤ RX_OFFSET) with a random phase, each from an exact integer
    phase (uint32 wrap), so every channel's demod is a constant angle far
    from ±π."""
    import numpy as np
    import torch
    m, b, t = cfg["n_channels"], cfg["batch"], cfg["block_len"] * steps
    rng = np.random.default_rng(seed)
    frac = (np.arange(m)[None] + rng.uniform(-RX_OFFSET, RX_OFFSET, (b, m))) / m
    dphi = np.round((frac % 1.0) * 2.0 ** 32).astype(np.int64)
    ph0 = rng.integers(0, 1 << 32, (b, m)).astype(np.int64)
    n = torch.arange(t, dtype=torch.int64, device=dev)
    x = torch.zeros((b, t), dtype=torch.complex64, device=dev)
    for i in range(b):
        for c in range(m):
            ph = (n * int(dphi[i, c]) + int(ph0[i, c])) & 0xFFFFFFFF
            ang = ph.to(torch.float64) * (2.0 * math.pi / 2.0 ** 32)
            x[i] += torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
    return x / math.sqrt(m)


def run_rx(mesh, cfg: dict, x, steps: int):
    """``steps`` steps of ``build_sharded_rx(mesh, ...)`` over ``x``: the
    audio joined over steps, the powers, and each step's ms by CUDA events
    when the mesh is on the card (the first step's includes the FFT plans),
    then the device ms and top kernels of one more step (torch.profiler)."""
    import torch
    from gnuradio4_tpu_torch.parallel.sharded_rx import (ShardedRxConfig,
                                                         build_sharded_rx)
    rcfg = ShardedRxConfig(**cfg)
    step, init_state, _ = build_sharded_rx(mesh, rcfg)
    state, outs, powers, ms = init_state(), [], [], []
    cuda = mesh.home.type == "cuda"
    for k in range(steps):
        xk = x[:, k * rcfg.block_len:(k + 1) * rcfg.block_len]
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        state, audio, power = step(state, xk)
        if cuda:
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        outs.append(audio)
        powers.append(power)
    prof = profile_device(lambda: step(state, xk)) if cuda else (None, [])
    return torch.cat(outs, dim=-1).cpu(), [float(p) for p in powers], ms, prof


def mesh_phases(dev, card: str, phase45, chain_msps: float, paths: list,
                results: dict) -> None:
    """Phase 30: the time-sharded mesh on the card — the chain over 8 time
    shards against phases 4 and 5, dryrun_multichip, the sharded wideband
    receiver, the sky search over a mesh, and a three-stage pipeline."""
    import numpy as np
    import torch
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.core.profiler import Profiler
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck
    from gnuradio4_tpu_torch.ops import gnss
    from gnuradio4_tpu_torch.parallel.dryrun import dryrun_multichip
    from gnuradio4_tpu_torch.parallel.mesh import make_mesh
    from gnuradio4_tpu_torch.parallel.pipeline import StagePipeline

    t_phase = time.perf_counter()
    mesh = make_mesh((MESH_SP,), ("sp",), devices=[dev] * MESH_SP)

    def tally(counts: dict) -> None:
        for k in KERNELS:
            results[k]["launches"] += counts[k]

    # (a) the headline chain at 2^23 over 8 time shards, absorbed and not
    print(f"[30a mesh chain] block_len 2^23 over {mesh} ({MESH_SP} time shards "
          f"on one card), {STEPS} steps, against phases 4 and 5 ({card})")
    derotated = None
    for absorb, ref, label in ((True, phase45[0], "absorbed"),
                               (False, phase45[1], "derotated")):
        ck.reset_launch_counts()
        out = run_chain(str(dev), BLOCK_LEN, STEPS, absorb, mesh=mesh)
        counts = ck.launch_counts()
        tally(counts)
        per_step = {k: counts[k] / STEPS for k in ("fir_banded", "nco_mix")}
        print(f"  {label}: launches {counts}; per step {per_step} (expected "
              f"fir_banded {2 * MESH_SP}: {MESH_SP} per FIR, nco_mix "
              f"{0 if absorb else MESH_SP})")
        check(counts["fir_banded"] == 2 * MESH_SP * STEPS
              and counts["nco_mix"] == (0 if absorb else MESH_SP * STEPS),
              f"mesh chain {label}: launches {counts}")
        check_chain_outputs(*out, BLOCK_LEN, STEPS, f"mesh chain {label}")
        compare_sinks(out, ref, f"mesh chain {label} vs phase "
                      f"{4 if absorb else 5}")
        if not absorb:
            derotated = out     # phase 31's reference
        del out
    # bitwise: the tone source and a Rotator from a phase just below 2^32
    # (the JAX tests assert both bitwise), and the FIR's NCO phase state
    srcs = {}
    for key, m in (("sharded", mesh), ("unsharded", None)):
        g = gt.Graph()
        tone = g.emplace("ComplexToneSource", frequency=1e6)
        snk = g.emplace("VectorSink")
        g.connect(tone, snk)
        gt.Scheduler(g, block_len=BLOCK_LEN, sample_rate=FS, mesh=m,
                     device=None if m is not None else dev).run_and_wait(2)
        g2 = gt.Graph()
        src = g2.emplace("ComplexToneSource", frequency=1e6)
        rot = g2.emplace("Rotator", frequency_shift=-3.1e6)
        snk2 = g2.emplace("NullSink")
        g2.connect_chain(src, rot, snk2)
        c = gt.compile_graph(g2, block_len=ROTATOR_BLOCK_LEN, sample_rate=C1_FS,
                             mesh=m, device=None if m is not None else dev)
        st = c.init_states()
        st[rot.unique_name] = torch.tensor((1 << 32) - 12345)
        params = c.gather_params()
        ck.reset_launch_counts()
        ys = []
        for _ in range(ROTATOR_STEPS):
            st, sink_ins = c.step(st, params)
            ys.append(sink_ins[snk2.unique_name]["in"].cpu())
        counts = ck.launch_counts()
        tally(counts)
        check(counts["nco_mix"] == ROTATOR_STEPS * (MESH_SP if m else 1),
              f"mesh Rotator {key}: launches {counts}")
        srcs[key] = (snk.data(), torch.cat(ys).numpy(), int(st[rot.unique_name]))
    same_tone = np.array_equal(srcs["sharded"][0], srcs["unsharded"][0])
    same_rot = np.array_equal(srcs["sharded"][1], srcs["unsharded"][1])
    print(f"  ComplexToneSource 2^23 × 2 bitwise equal sharded/unsharded: "
          f"{same_tone}; Rotator 2^20 × {ROTATOR_STEPS} from 2^32 − 12345 "
          f"({MESH_SP} nco_mix a step): bitwise {same_rot}, end phase "
          f"{srcs['sharded'][2]} vs {srcs['unsharded'][2]}")
    check(same_tone and same_rot and srcs["sharded"][2] == srcs["unsharded"][2],
          "mesh: tone source / Rotator not bitwise equal to unsharded")
    # the cost of the mesh on one card: the NullSink chain, unsharded and
    # sharded in turns (plain, mesh, mesh, plain), CUDA events over windows
    timing = {"unsharded": [], "sharded": []}
    for key in ("unsharded", "sharded", "sharded", "unsharded"):
        g, _, _, _ = build_chain("null")
        m = mesh if key == "sharded" else None
        sched = gt.Scheduler(g, block_len=BLOCK_LEN, sample_rate=FS, mesh=m,
                             device=None if m is not None else dev,
                             pipeline_depth=1, profiler=Profiler())
        sched.init()
        sched.fsm.transition_to(gt.State.RUNNING)
        for _ in range(2):
            sched._pump_once()
        sync(dev)
        ms, windows, host_ms, split = drive_windows(sched, MESH_TIMED_STEPS)
        finish(sched)
        kernels, ops = count_ops(sched.step_once)
        busy = profile_device(sched.step_once)[0]
        timing[key].append((ms, host_ms, kernels, ops, windows, busy))
        del sched
    row = {}
    for key, runs in timing.items():
        ms = statistics.median(r[0] for r in runs)
        host = statistics.median(r[1] for r in runs)
        row[key] = (ms, host)
        print(f"  chain {key} (sync, NullSinks): {BLOCK_LEN / (ms * 1e-3) / 1e6:.2f} "
              f"Msps, {ms:.4f} ms/step, host {host:.4f} ms/step in the pump; "
              f"{runs[0][2]} kernels and {runs[0][3]} torch ops a step, "
              f"device busy {[r[5] for r in runs]} ms a step (torch.profiler); "
              f"windows (events ms, wall ms) "
              f"{fmt_windows(runs[0][4])} / {fmt_windows(runs[1][4])} on {card}")
        paths.append({"name": f"mesh chain {key}", "msps": BLOCK_LEN / (ms * 1e-3) / 1e6,
                      "ms_per_step": ms, "host_ms_per_step": host})
    print(f"  sharded / unsharded: {row['sharded'][0] / row['unsharded'][0]:.3f}× "
          f"the device ms, {row['sharded'][1] / row['unsharded'][1]:.3f}× the host "
          f"ms (phase 4's chain: {chain_msps:.2f} Msps)")

    # (b) dryrun_multichip: the JAX package's three topologies on the card
    print(f"[30b dryrun_multichip] {MESH_SP} shards on {dev} ({card})")
    ck.reset_launch_counts()
    recs = dryrun_multichip(MESH_SP, device=dev)
    tally(ck.launch_counts())
    check(len(recs) == 3 and all(r["max_abs_err"] < MESH_ATOL for r in recs),
          f"dryrun_multichip: {recs}")

    # (c) the sharded wideband receiver at config 4's widths over (dp 2, sp 4)
    rx_mesh = make_mesh((2, 4), ("dp", "sp"), devices=[dev] * 8)
    one = make_mesh((1, 1), ("dp", "sp"), devices=[dev])
    print(f"[30c sharded rx] {RX_CFG} over {rx_mesh}, {RX_STEPS} steps, against "
          f"(1, 1) on the card and the CPU at block_len {RX_CPU_BLOCK_LEN} ({card})")
    x = rx_tones(RX_CFG, RX_STEPS, dev)
    # each run keeps its audio FIR's last inputs (the profiled step's: the
    # demod output and the history carried from the step before)
    by_shape, kept = ({}, {}), ({}, {})
    ck.reset_launch_counts()
    with count_fir_shapes(by_shape[0], kept[0]):
        got, p_got, ms, prof = run_rx(rx_mesh, RX_CFG, x, RX_STEPS)
    counts = ck.launch_counts()
    tally(counts)
    ck.reset_launch_counts()
    with count_fir_shapes(by_shape[1], kept[1]):
        want, p_want, ms1, prof1 = run_rx(one, RX_CFG, x, RX_STEPS)
    counts1 = ck.launch_counts()
    tally(counts1)
    del x
    m_ = RX_CFG["n_channels"]
    shape = (RX_CFG["batch"], m_, RX_STEPS * RX_CFG["block_len"] // m_
             // RX_CFG["audio_decim"])
    err = float((got - want).abs().max())
    for key, t, pr, c in (("(2, 4)", ms, prof, counts),
                          ("(1, 1)", ms1, prof1, counts1)):
        print(f"  {key}: ms per step {[round(v, 4) for v in t]} (CUDA events; "
              f"the first builds the FFT plans), fir_banded {c['fir_banded']} "
              f"over {RX_STEPS + 1} steps ({c['fir_banded'] // (RX_STEPS + 1)} a "
              f"step); one more step profiled: device "
              f"{pr[0]} ms, top {pr[1][:4]}")
    print(f"  (2, 4) vs (1, 1): {tuple(got.shape)}, max|Δ| {err:.3e} (tol "
          f"{MESH_ATOL}); power {p_got} vs {p_want}")
    check(tuple(got.shape) == shape and bool(torch.isfinite(got).all()),
          f"sharded rx: shape {tuple(got.shape)}, expected {shape}")
    check(err <= MESH_ATOL and counts["fir_banded"] == 8 * (RX_STEPS + 1)
          and counts1["fir_banded"] == RX_STEPS + 1,
          f"sharded rx: max|Δ| {err}, launches {counts} / {counts1}")
    # fir_banded against its plain version at both receivers' audio FIR
    # shapes, on the inputs each run gave it
    rows = results["fir_banded"].setdefault("timed_shapes", [])
    for key, n_shape, keep in (("(2, 4)", by_shape[0], kept[0]),
                               ("(1, 1)", by_shape[1], kept[1])):
        check(len(keep) == 1 and sum(n_shape.values()) == (
            counts if key == "(2, 4)" else counts1)["fir_banded"],
              f"sharded rx {key}: fir_banded shapes {list(keep)}, launches "
              f"{n_shape}")
        (xf, hf, taps, decim), = keep.values()
        launches, = n_shape.values()
        k = len(taps)
        fe = float((ck.fir_banded(xf, hf, taps, decim)
                    - ck.fir_banded_ref(xf, hf, taps, decim)).abs().max())
        k_ms, p_ms = kernel_vs_plain_ms(lambda: ck.fir_banded(xf, hf, taps, decim),
                                        lambda: ck.fir_banded_ref(xf, hf, taps, decim))
        b_ms, b_by = bound_ms(*fir_work(tuple(xf.shape), False, False, k, decim))
        h_dev = torch.from_numpy(np.ascontiguousarray(taps, np.float32)).to(dev)
        lib = conv1d_ms(xf, hf, h_dev, decim)
        print(f"[30c fir_banded, the receiver's audio FIR at {key}] f32 × f32 K {k} "
              f"÷{decim} {tuple(xf.shape)}, the demod output with its carried "
              f"history: max|Δ| {fe:.3e} (tol {FIR_ATOL}); kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), {b_ms / k_ms:.1%} "
              f"of it; F.conv1d (TF32 off) {lib:.4f} ms; {launches} launches {card}")
        check(fe <= FIR_ATOL, f"fir_banded, sharded rx {key}: {fe}")
        results["fir_banded"]["max_abs_err"] = max(results["fir_banded"]["max_abs_err"], fe)
        row = {"case": f"phase 30 sharded rx {key} audio: f32 × f32 K {k} ÷{decim} "
                       f"{list(xf.shape)}",
               "launches": launches, "max_abs_err": fe, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
        rows.append(row)
        paths.append({"name": f"phase 30 fir_banded {row['case']}", **row})
    del kept
    ms = statistics.median(ms[1:])
    check(all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(p_got, p_want)),
          f"sharded rx power {p_got} vs {p_want}")
    small = dict(RX_CFG, block_len=RX_CPU_BLOCK_LEN)
    xs = rx_tones(small, RX_STEPS, "cpu")
    cpu_out = run_rx(make_mesh((2, 4), ("dp", "sp"), devices=["cpu"] * 8),
                     small, xs, RX_STEPS)[0]
    ck.reset_launch_counts()
    card_out = run_rx(rx_mesh, small, xs.to(dev), RX_STEPS)[0]
    tally(ck.launch_counts())
    err_c = float((cpu_out - card_out).abs().max())
    print(f"  CPU vs card at block_len {RX_CPU_BLOCK_LEN}: max|Δ| {err_c:.3e} "
          f"(tol {MESH_ATOL})")
    check(err_c <= MESH_ATOL, f"sharded rx CPU vs card: {err_c}")
    paths.append({"name": "sharded rx (2, 4)", "msps": RX_CFG["batch"]
                  * RX_CFG["block_len"] / (ms * 1e-3) / 1e6, "ms_per_step": ms})

    # (d) the sky search over a 4-shard mesh at phase 27's widths
    rng = np.random.default_rng(SEED)
    sig = gnss.synthesize(GNSS_SATS, fs=GNSS_FS, n_ms=GNSS_N_MS,
                          noise_std=GNSS_NOISE, rng=rng)
    iq = torch.from_numpy(sig[:2 * GNSS_BLOCK_LEN]).to(dev)
    sky = gnss.acquire_all(iq, fs=GNSS_FS, device=dev)
    sky4 = gnss.acquire_all(iq, fs=GNSS_FS, mesh=make_mesh(
        (4,), ("ep",), devices=[dev] * 4))
    key = [(d["prn"], d["code_phase"], d["doppler"]) for d in sky4]
    print(f"[30d sky search over 4 shards] {key} ({card})")
    check(key == [(d["prn"], d["code_phase"], d["doppler"]) for d in sky]
          and [d["prn"] for d in sky4] == [s[0] for s in GNSS_SATS],
          f"acquire_all(mesh=): {sky4} against {sky}")

    # (e) a three-stage pipeline on the card: FreqXlatingFir | demod | FIR ÷8
    def pipe_chain(cut: bool):
        g, fir, _, _ = build_chain("vector")
        order = {type(b).__name__: b for b in g.blocks}
        h = gt.Graph()
        src, dem, aud = (order["ComplexToneSource"], order["QuadratureDemod"],
                         order["FirFilter"])
        h.connect(src, fir)
        h.connect(fir, dem, domain="gpu:cuda:1" if cut else None)
        h.connect(dem, aud, domain="gpu:cuda:2" if cut else None)
        return h, aud
    os.environ["GR4TPU_NO_ROTATION_ABSORB"] = "1"
    try:
        h, _ = pipe_chain(True)
        pipe = StagePipeline.from_graph(h, block_len=BLOCK_LEN, sample_rate=FS,
                                        devices=[dev] * 3)
        ck.reset_launch_counts()
        outs = [pipe.push().cpu() for _ in range(STEPS)]
        counts = ck.launch_counts()
        tally(counts)
        h2, aud = pipe_chain(False)
        snk = gt.global_registry.create("VectorSink")
        h2.connect(aud, snk)
        gt.Scheduler(h2, block_len=BLOCK_LEN, sample_rate=FS,
                     device=dev).run_and_wait(STEPS)
    finally:
        os.environ.pop("GR4TPU_NO_ROTATION_ABSORB", None)
    same = np.array_equal(torch.cat(outs).numpy(), snk.data())
    print(f"[30e pipeline] {len(pipe.stages)} stages on {dev} × 3, {STEPS} pushes "
          f"of 2^23: launches {counts}; bitwise equal to the fused graph: {same} "
          f"({card})")
    check(len(pipe.stages) == 3 and same, "pipeline differs from the fused graph")
    check(counts["fir_banded"] == 2 * STEPS and counts["nco_mix"] == STEPS,
          f"pipeline launches {counts}")
    print(f"  phase 30: {time.perf_counter() - t_phase:.1f} s")
    return derotated


def timed_null_chain(mesh, windows: int):
    """The NullSink chain (absorbed) under ``mesh``, warmed by two steps and
    driven through ``windows`` windows of ``MESH_TIMED_STEPS`` steps
    (``drive_windows``); the process group's transport is counted from the
    first timed step."""
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.core.profiler import Profiler
    from gnuradio4_tpu_torch.parallel import collectives as col
    g, _, _, _ = build_chain("null")
    sched = gt.Scheduler(g, block_len=BLOCK_LEN, sample_rate=FS, mesh=mesh,
                         pipeline_depth=1, profiler=Profiler())
    sched.init()
    sched.fsm.transition_to(gt.State.RUNNING)
    for _ in range(2):
        sched._pump_once()
    sync("cuda")
    col.transport.reset()
    out = drive_windows(sched, MESH_TIMED_STEPS, windows=windows)
    finish(sched)
    return out


def multihost_worker(rank: int, world: int, port: str, out_dir: str) -> int:
    """One process of phase 31 (``python3 chip_smoke.py --multihost-worker
    RANK WORLD PORT DIR``): joins the process group, runs the derotated
    chain over the global mesh with every launch counted and each kernel's
    latest inputs kept, holds those against the plain versions, times the
    NullSink chain, saves its sinks' slices to DIR and prints one
    ``MH_RESULT {json}`` line."""
    import contextlib
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck
    from gnuradio4_tpu_torch.blocks import filter as tfilter
    from gnuradio4_tpu_torch.parallel import collectives as col
    from gnuradio4_tpu_torch.parallel import multihost as mh
    from gnuradio4_tpu_torch.utils.memory import (MemoryMonitor,
                                                  device_memory_stats)

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    ck.build()
    mh.init_distributed(f"127.0.0.1:{port}", world, rank, device=dev,
                        timeout=MH_TIMEOUT)
    backend = mh.backend()
    print(f"[31 process {rank}] backend {backend}: the devices "
          f"{mh.published_devices()}", flush=True)
    mesh = mh.global_mesh(("sp",), [dev] * MH_LOCAL)
    check(mesh.shape["sp"] == world * MH_LOCAL and mesh.home == dev,
          f"global mesh {mesh}")
    torch.cuda.reset_peak_memory_stats(dev)
    mon = MemoryMonitor(interval_s=0.02, device=dev).start()

    @contextlib.contextmanager
    def keep_nco(keep: dict):
        inner = tfilter.nco_mix

        def kept(x, phase0, dphi):
            before = ck.nco_mix.launches
            y = inner(x, phase0, dphi)
            if ck.nco_mix.launches > before:
                keep["last"] = (x, int(phase0), int(dphi))
            return y
        tfilter.nco_mix = kept
        try:
            yield
        finally:
            tfilter.nco_mix = inner

    # the derotated chain over the global mesh: launches counted from 0
    by_shape, fir_kept, nco_kept = {}, {}, {}
    with count_fir_shapes(by_shape, fir_kept), keep_nco(nco_kept):
        ck.reset_launch_counts()
        spec, audio = run_chain("cuda", BLOCK_LEN, STEPS, False, mesh=mesh)
        counts = ck.launch_counts()
    # each kernel against its plain version on the run's inputs
    errs = {"fir_banded": [], "nco_mix": []}
    for (xf, hf, taps, decim) in fir_kept.values():
        errs["fir_banded"].append(float(
            (ck.fir_banded(xf, hf, taps, decim)
             - ck.fir_banded_ref(xf, hf, taps, decim)).abs().max()))
    xn, ph, dphi = nco_kept["last"]
    (y, p1), (y_ref, p_ref) = ck.nco_mix(xn, ph, dphi), ck.nco_mix_ref(xn, ph,
                                                                       dphi)
    errs["nco_mix"].append(float((y - y_ref).abs().max()))
    check(p1 == p_ref, f"nco_mix phase {p1} vs {p_ref}")
    del fir_kept, nco_kept, xn, y, y_ref
    np.save(os.path.join(out_dir, f"rank{rank}_spec.npy"), spec)
    np.save(os.path.join(out_dir, f"rank{rank}_audio.npy"), audio)
    # the NullSink chain, timed; the transport over the same windows
    ms, windows, host_ms, split = timed_null_chain(mesh, MH_WINDOWS)
    n = MH_WINDOWS * MESH_TIMED_STEPS
    moved = dataclasses.asdict(col.transport)
    mon.sample()
    mon.stop()
    stats = device_memory_stats(dev)
    dist.barrier()
    mh.shutdown()
    print("MH_RESULT " + json.dumps({
        "rank": rank, "backend": backend,
        "counts": counts, "shapes": {str(k): v for k, v in by_shape.items()},
        "errs": errs, "spec_shape": list(spec.shape),
        "audio_shape": list(audio.shape), "ms": ms, "host_ms": host_ms,
        "windows": windows, "split": split,
        "transport_ms": moved["seconds"] * 1e3 / n,
        "transport_bytes": moved["bytes"] / n,
        "transport_calls": moved["calls"] / n,
        "peak_device_bytes": mon.peak_device_bytes,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use", 0),
        "bytes_reserved": stats.get("bytes_reserved", 0),
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def multihost_phases(dev, card: str, phase5, mesh_derotated, paths: list,
                     results: dict) -> None:
    """Phase 31: the chain at 2^23 across two processes sharing the card
    (this file's workers), against phase 30's 8-shard chain and phase 5;
    the NullSink chain in turns with phase 30's."""
    import socket
    import tempfile
    import numpy as np
    import torch
    from gnuradio4_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    mesh8 = make_mesh((MESH_SP,), ("sp",), devices=[dev] * MESH_SP)
    print(f"[31 multihost] the chain at 2^23 across {MH_WORLD} processes on "
          f"{dev}, {MH_LOCAL} time shards each, {STEPS} checked steps; the "
          f"NullSink chain in turns with phase 30's 8-shard chain ({card})")
    single = [timed_null_chain(mesh8, MH_WINDOWS)]
    torch.cuda.empty_cache()
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = str(so.getsockname()[1])
    out_dir = tempfile.mkdtemp(prefix="gr4tpu_mh_")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--multihost-worker",
         str(r), str(MH_WORLD), port, out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT)) for r in range(MH_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, t_phase + MH_DEADLINE - time.perf_counter()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise SmokeFailure(f"phase 31: workers not done within {MH_DEADLINE} "
                           f"s:\n" + "\n".join(o[-3000:] for o in outs))
    single.append(timed_null_chain(mesh8, MH_WINDOWS))
    got = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("MH_RESULT ")]
        check(p.returncode == 0 and len(lines) == 1,
              f"phase 31 worker {r} failed (rc {p.returncode}):\n{out[-4000:]}")
        got.append(json.loads(lines[0][len("MH_RESULT "):]))
    # each process's slices against phase 30's 8-shard chain and phase 5
    spec8, audio8 = mesh_derotated
    for r, res in enumerate(got):
        spec = np.load(os.path.join(out_dir, f"rank{r}_spec.npy"))
        audio = np.load(os.path.join(out_dir, f"rank{r}_audio.npy"))

        def mine(a):
            per = a.reshape(STEPS, -1)
            w = per.shape[1] // MH_WORLD
            return per[:, r * w:(r + 1) * w].reshape(-1)
        d8 = max(float(np.max(np.abs(spec - mine(spec8)))),
                 float(np.max(np.abs(audio - mine(audio8)))))
        same = np.array_equal(spec, mine(spec8)) and np.array_equal(
            audio, mine(audio8))
        print(f"  process {r}: spectrum {spec.shape}, audio {audio.shape}; "
              f"against phase 30's slices max|Δ| {d8:.3e} (tol {MESH_ATOL}), "
              f"bitwise {same}")
        check(spec.shape == (BLOCK_LEN * STEPS // MH_WORLD,) and
              audio.shape == (BLOCK_LEN * STEPS // 8 // MH_WORLD,) and
              d8 <= MESH_ATOL, f"phase 31 process {r}: max|Δ| {d8}")
        compare_sinks((spec, audio), (mine(phase5[0]), mine(phase5[1])),
                      f"process {r} vs phase 5")
        c = res["counts"]
        print(f"  process {r}: backend {res['backend']}; launches {c} (expected "
              f"fir_banded {2 * MH_LOCAL * STEPS}, nco_mix {MH_LOCAL * STEPS}); "
              f"fir_banded shapes {res['shapes']}; against the plain versions "
              f"on the run's inputs max|Δ| fir_banded "
              f"{max(res['errs']['fir_banded']):.3e} (tol {FIR_ATOL}), nco_mix "
              f"{max(res['errs']['nco_mix']):.3e} (tol {NCO_ATOL}) ({card})")
        check(res["backend"] == "gloo", f"phase 31 backend {res['backend']}")
        check(c["fir_banded"] == 2 * MH_LOCAL * STEPS
              and c["nco_mix"] == MH_LOCAL * STEPS,
              f"phase 31 process {r}: launches {c}")
        check(max(res["errs"]["fir_banded"]) <= FIR_ATOL
              and max(res["errs"]["nco_mix"]) <= NCO_ATOL,
              f"phase 31 process {r}: kernels against plain {res['errs']}")
        for k in ("fir_banded", "nco_mix"):
            results[k]["launches"] += c[k]
            results[k]["max_abs_err"] = max(results[k]["max_abs_err"],
                                            *res["errs"][k])
        print(f"  process {r}: NullSink chain {res['ms']:.4f} ms a step "
              f"(CUDA events, median of {MH_WINDOWS} windows of "
              f"{MESH_TIMED_STEPS}), host {res['host_ms']:.4f} ms a step in "
              f"the pump ({fmt_split(res['split'])}); windows (events ms, "
              f"wall ms) {fmt_windows(res['windows'])}; transport "
              f"{res['transport_ms']:.4f} ms, {res['transport_bytes']:.0f} "
              f"bytes, {res['transport_calls']:.1f} calls a step; peak device "
              f"memory {res['peak_device_bytes'] / 2**30:.3f} GiB "
              f"(MemoryMonitor; allocator peak "
              f"{res['peak_bytes_in_use'] / 2**30:.3f}, reserved "
              f"{res['bytes_reserved'] / 2**30:.3f}); worker "
              f"{res['seconds']:.1f} s ({card})")
        paths.append({"name": f"multihost chain process {r}",
                      "msps": BLOCK_LEN / (res["ms"] * 1e-3) / 1e6,
                      "ms_per_step": res["ms"],
                      "host_ms_per_step": res["host_ms"],
                      "transport_ms_per_step": res["transport_ms"],
                      "transport_bytes_per_step": res["transport_bytes"],
                      "peak_device_bytes": res["peak_device_bytes"]})
        del spec, audio
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    os.rmdir(out_dir)
    ms1 = [w[0] for w in single]
    host1 = [w[2] for w in single]
    print(f"  phase 30's 8-shard chain in turns (before, after): "
          f"{[round(v, 4) for v in ms1]} ms a step, host "
          f"{[round(v, 4) for v in host1]} ms a step; two processes / one: "
          f"{max(r['ms'] for r in got) / statistics.median(ms1):.3f}× the "
          f"step ({card})")
    print(f"  phase 31: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import numpy as np
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck
    from gnuradio4_tpu_torch.ops import filter_design as fd
    from gnuradio4_tpu_torch.ops.fir import freq_xlating_taps
    from gnuradio4_tpu_torch.ops.signal import phase_increment

    # full float32 everywhere the plain versions multiply matrices
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{kind}; count {torch.cuda.device_count()}")
    print(card)
    dev = torch.device("cuda")

    # 2. build
    lib = ck.build()
    print(f"[2 build] {lib.path.name} in {lib.seconds:.2f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  " + line.strip())

    # 3. kernels against plain versions
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results: dict[str, dict] = {k: {"max_abs_err": 0.0} for k in KERNELS}

    def fir_case(label, shape, x_dt, taps, decim, timed=False):
        k = len(taps)
        x = torch.randn(shape, dtype=x_dt, device=dev, generator=gen)
        hist = torch.randn((*shape[:-1], k - 1), dtype=x_dt, device=dev,
                           generator=gen)
        h = torch.from_numpy(np.ascontiguousarray(taps)).to(dev)
        y = ck.fir_banded(x, hist, h, decim)
        y_ref = ck.fir_banded_ref(x, hist, h, decim)
        torch.cuda.synchronize()
        check(y.shape == y_ref.shape, f"fir_banded {label}: shape {y.shape} vs {y_ref.shape}")
        err = float((y - y_ref).abs().max())
        row = {"case": label, "max_abs_err": err, "tol": FIR_ATOL}
        if timed:
            row["ms"], row["plain_ms"] = kernel_vs_plain_ms(
                lambda: ck.fir_banded(x, hist, h, decim),
                lambda: ck.fir_banded_ref(x, hist, h, decim))
            row["bound_ms"], row["bound_by"] = bound_ms(*fir_work(
                shape, x.is_complex(), h.is_complex(), k, decim))
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["library_ms"] = conv1d_ms(x, hist, h, decim)
        print(f"  fir_banded {label}: max|Δ| {err:.3e} (tol {FIR_ATOL})"
              + (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                 f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                 f"{row['share_of_bound']:.1%} of it; F.conv1d (TF32 off) "
                 f"{row['library_ms']:.4f} ms" if timed else ""))
        check(err <= FIR_ATOL, f"fir_banded {label}: max|Δ| {err} > {FIR_ATOL}")
        results["fir_banded"]["max_abs_err"] = max(results["fir_banded"]["max_abs_err"], err)
        return row

    print("[3 kernels]")
    xl_taps = freq_xlating_taps(fd.design_fir("lowpass", 127, sample_rate=FS,
                                              f_low=2e6), 3e6, FS)
    lp127 = fd.design_fir("lowpass", 127, sample_rate=FS, f_low=2e6).astype(np.float32)
    lp63 = fd.design_fir("lowpass", 63, sample_rate=FS, f_low=1e6).astype(np.float32)
    main_fir = fir_case("c64 x c64 taps K=127 decim 1 T=2^23", (BLOCK_LEN,),
                        torch.complex64, xl_taps, 1, timed=True)
    fir_case("c64 x f32 taps K=127 decim 1 T=2^23", (BLOCK_LEN,),
             torch.complex64, lp127, 1, timed=True)
    fir_case("c64 x f32 taps K=127 decim 1 T=2^22 (config 1)", (SUITE_BLOCK_LEN,),
             torch.complex64, lp127, 1, timed=True)
    fir_case("f32 x f32 taps K=63 decim 8 T=2^23", (BLOCK_LEN,),
             torch.float32, lp63, 8, timed=True)
    fir_case("c64 x c64 taps K=127 ragged T=2^23-1237", (BLOCK_LEN - 1237,),
             torch.complex64, xl_taps, 1)
    fir_case("f32 x f32 taps K=63 decim 8 ragged T=1000003", (1000003,),
             torch.float32, lp63, 8)
    fir_case("f32 x c64 taps K=127 decim 1 T=65536", (65536,),
             torch.float32, xl_taps, 1)
    fir_case("c64 x c64 taps K=127 C=4 T=2^18+77", (4, (1 << 18) + 77),
             torch.complex64, xl_taps, 1)
    fir_case("f32 x f32 taps K=63 decim 8 C=3 T=2^18+5", (3, (1 << 18) + 5),
             torch.float32, lp63, 8)
    # shapes the kernel once refused: staged spans past the shared memory at
    # large decimation, more channels than grid y holds
    fir_case("c64 x f32 taps K=63 decim 1024 T=2^22", (1 << 22,),
             torch.complex64, lp63, 1024)
    fir_case("f32 x f32 taps K=63 decim 2048 T=2^22", (1 << 22,),
             torch.float32, lp63, 2048)
    xl7 = np.ascontiguousarray(xl_taps[60:67])
    fir_case("c64 x c64 taps K=7 C=65539 T=64", (65539, 64), torch.complex64, xl7, 1)
    # K 16384 complex taps: the taps go in chunks (against float64: the plain
    # version's Toeplitz band would take gigabytes)
    rng16 = np.random.default_rng(SEED)
    long_taps = ((rng16.standard_normal(16384) + 1j * rng16.standard_normal(16384))
                 / 128).astype(np.complex64)
    x = torch.randn(1 << 15, dtype=torch.complex64, device=dev, generator=gen)
    hist = torch.randn(16383, dtype=torch.complex64, device=dev, generator=gen)
    y = ck.fir_banded(x, hist, long_taps)
    want = fir_float64(torch.cat([hist, x]), long_taps, 1)
    rel = float(np.max(np.abs(y.cpu().numpy() - want))) / float(
        np.sqrt(np.mean(np.abs(want) ** 2)))
    print(f"  fir_banded c64 x c64 taps K=16384 T=2^15: max|Δ| {rel:.3e}·RMS "
          f"against float64 (tol {LONG_RTOL})")
    check(y.shape == (1 << 15,) and rel <= LONG_RTOL,
          f"fir_banded K=16384: {rel} of the RMS > {LONG_RTOL}")

    dphi = int(phase_increment(-3e6, FS))
    phase0 = (1 << 32) - 12345        # the start phase sits just below the wrap
    for label, shape in (("c64 T=2^23 across a 2^32 wrap", (BLOCK_LEN,)),
                         ("c64 C=4 T=2^18+77", (4, (1 << 18) + 77))):
        x = torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)
        y, ph = ck.nco_mix(x, phase0, dphi)
        y_ref, ph_ref = ck.nco_mix_ref(x, phase0, dphi)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        check(ph == ph_ref == (phase0 + shape[-1] * dphi) % (1 << 32),
              f"nco_mix {label}: phase {ph} vs {ph_ref}")
        row = {"case": label, "max_abs_err": err, "tol": NCO_ATOL}
        if shape == (BLOCK_LEN,):
            # the median of three spin-queued readings (one reading alone
            # once came out 2.4× the others)
            readings = [kernel_vs_plain_ms(
                lambda: ck.nco_mix(x, phase0, dphi),
                lambda: ck.nco_mix_ref(x, phase0, dphi)) for _ in range(3)]
            row["ms"] = statistics.median(r[0] for r in readings)
            row["plain_ms"] = statistics.median(r[1] for r in readings)
            row["readings"] = readings
            main_nco = row
        print(f"  nco_mix {label}: max|Δ| {err:.3e} (tol {NCO_ATOL})"
              + (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms "
                 f"(medians of (kernel, plain) readings "
                 f"{[(round(a, 4), round(b, 4)) for a, b in row['readings']]})"
                 if "ms" in row else ""))
        check(err <= NCO_ATOL, f"nco_mix {label}: max|Δ| {err} > {NCO_ATOL}")
        results["nco_mix"]["max_abs_err"] = max(results["nco_mix"]["max_abs_err"], err)
    results["fir_banded"].update(
        {key: main_fir[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "share_of_bound", "library_ms")})
    nco_bound = bound_ms(6.0 * BLOCK_LEN, 16.0 * BLOCK_LEN)   # complex multiply; c64 in and out
    results["nco_mix"].update(
        ms=main_nco["ms"], plain_ms=main_nco["plain_ms"], bound_ms=nco_bound[0],
        bound_by=nco_bound[1], share_of_bound=nco_bound[0] / main_nco["ms"],
        library_ms=None,
        library_note="no single PyTorch call mixes with an integer phase ramp")

    # Path A's audio FIR (f32, 127 taps, ÷5): its real input length, and the
    # shorter stream of the same shape class
    lp_audio = fd.design_fir("lowpass", 127, sample_rate=QUAD_RATE,
                             f_low=15e3).astype(np.float32)
    fir_case(f"f32 x f32 taps K=127 decim 5 T={WBFM_IN_LEN} (Path A audio FIR)",
             (WBFM_IN_LEN,), torch.float32, lp_audio, 5, timed=True)
    fir_case("f32 x f32 taps K=127 decim 5 T=838865", (838865,),
             torch.float32, lp_audio, 5)

    # iir_sos: against its plain loop where the loop is affordable (T = 4096),
    # against scipy's float64 sosfilt at Path B's shape
    from gnuradio4_tpu_torch.ops.iir import SOS_CHUNK, sos_apply, sos_init_state
    sos5 = iir_design(5).sos
    for label, ch, t in (("C=16 T=4096 S=3", 16, 4096), ("C=1 T=4096 S=3", 0, 4096)):
        shape = (t,) if ch == 0 else (ch, t)
        x = torch.randn(shape, device=dev, generator=gen)
        s0 = 0.1 * torch.randn(sos_init_state(ch, 3).shape, device=dev, generator=gen)
        y, st = ck.iir_sos(x, sos5, s0)
        y_ref, st_ref = ck.iir_sos_ref(x, sos5, s0)
        torch.cuda.synchronize()
        err = max(rms_err(y.cpu().numpy(), y_ref.cpu().numpy()),
                  rms_err(st.cpu().numpy(), st_ref.cpu().numpy()))
        row = {"case": label, "max_abs_err": err, "tol": IIR_RTOL}
        if ch == 16:
            row["ms"], row["plain_ms"] = kernel_vs_plain_ms(
                lambda: ck.iir_sos(x, sos5, s0),
                lambda: ck.iir_sos_ref(x, sos5, s0), plain_reps=3)
            b_ms, b_by = iir_bound_ms(ch, t, 3)
            results["iir_sos"].update(
                ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / row["ms"], library_ms=None,
                library_note="no PyTorch call runs a biquad cascade")
        print(f"  iir_sos {label}: max|Δ| {err:.3e}·RMS (tol {IIR_RTOL})"
              + (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                 f"bound {b_ms:.5f} ms ({b_by}), {b_ms / row['ms']:.2%} of it"
                 if "ms" in row else ""))
        check(err <= IIR_RTOL, f"iir_sos {label}: {err} > {IIR_RTOL}")
        results["iir_sos"]["max_abs_err"] = max(results["iir_sos"]["max_abs_err"], err)
    # two calls with the carried state against one pass of the plain loop and
    # one call of the kernel: within IIR_RTOL, not bit for bit (the chunk grid
    # starts at each call's first sample)
    x = torch.randn(16, 4096, device=dev, generator=gen)
    s0 = torch.zeros(16, 3, 2, device=dev)
    y1, st = ck.iir_sos(x[:, :1500].contiguous(), sos5, s0)
    y2, st = ck.iir_sos(x[:, 1500:].contiguous(), sos5, st)
    y_ref, st_ref = ck.iir_sos_ref(x, sos5, s0)
    y_one, st_one = ck.iir_sos(x, sos5, s0)
    torch.cuda.synchronize()
    two = torch.cat([y1, y2], -1).cpu().numpy()
    err = max(rms_err(two, y_ref.cpu().numpy()), rms_err(st.cpu().numpy(), st_ref.cpu().numpy()))
    err_one = max(rms_err(two, y_one.cpu().numpy()),
                  rms_err(st.cpu().numpy(), st_one.cpu().numpy()))
    print(f"  iir_sos C=16 two calls 1500+2596, state carried: max|Δ| "
          f"{err:.3e}·RMS to the plain loop, {err_one:.3e}·RMS to one call "
          f"(tol {IIR_RTOL})")
    check(max(err, err_one) <= IIR_RTOL, f"iir_sos state carry: {err}, {err_one} > {IIR_RTOL}")
    results["iir_sos"]["max_abs_err"] = max(results["iir_sos"]["max_abs_err"], err)
    # any number of sections: three launches (reduce, carry, rerun) per group
    # of 16, in place after the first; two calls with the carried state
    # within IIR_RTOL of one
    for n_sec in (17, 33):
        many = np.tile(iir_design(4).sos[:1], (n_sec, 1))
        x = torch.randn(3, 4096, device=dev, generator=gen)
        s0 = 0.1 * torch.randn(3, n_sec, 2, device=dev, generator=gen)
        before = ck.iir_sos.launches
        y, st = ck.iir_sos(x, many, s0)
        launched = ck.iir_sos.launches - before
        y_ref, st_ref = ck.iir_sos_ref(x, many, s0)
        y1, st1 = ck.iir_sos(x[:, :1500].contiguous(), many, s0)
        y2, st2 = ck.iir_sos(x[:, 1500:].contiguous(), many, st1)
        torch.cuda.synchronize()
        err = max(rms_err(y.cpu().numpy(), y_ref.cpu().numpy()),
                  rms_err(st.cpu().numpy(), st_ref.cpu().numpy()))
        err_two = max(rms_err(torch.cat([y1, y2], -1).cpu().numpy(), y.cpu().numpy()),
                      rms_err(st2.cpu().numpy(), st.cpu().numpy()))
        print(f"  iir_sos C=3 T=4096 S={n_sec}: {launched} launches; max|Δ| "
              f"{err:.3e}·RMS (tol {IIR_RTOL}); two calls against one {err_two:.3e}·RMS")
        check(launched == 3 * -(-n_sec // 16) and max(err, err_two) <= IIR_RTOL,
              f"iir_sos S={n_sec}: launches {launched}, err {err}, two calls {err_two}")
        results["iir_sos"]["max_abs_err"] = max(results["iir_sos"]["max_abs_err"], err)
    # narrow band (Butterworth 5 at 200 Hz of 48 kHz, poles near the unit
    # circle, where the carry matters most): against scipy's float64 sosfilt,
    # the kernel's error at most twice the plain loop's (run on the CPU)
    from scipy import signal
    narrow = fd.design_iir("butterworth", "lowpass", 5, sample_rate=IIR_FS,
                           f_low=200.0).sos
    x = torch.randn(2, 1 << 15, device=dev, generator=gen)
    s0 = torch.zeros(2, 3, 2, device=dev)
    y, _ = ck.iir_sos(x, narrow, s0)
    y_plain, _ = sos_apply(x.cpu(), narrow, s0.cpu())
    want = signal.sosfilt(narrow, x.cpu().numpy().astype(np.float64), axis=-1)
    err, err_plain = rms_err(y.cpu().numpy(), want), rms_err(y_plain.numpy(), want)
    print(f"  iir_sos narrow band (200 Hz) C=2 T=2^15: max|Δ| to float64 "
          f"{err:.3e}·RMS, plain loop {err_plain:.3e}·RMS (kernel ≤ 2× plain)")
    check(err <= 2 * err_plain, f"iir_sos narrow band: {err} > 2 × {err_plain}")
    # Path B's shape, one channel of it, and the short stream: device time
    # beside the bound; the two long ones against float64
    iir_rows = {}
    for label, ch, t in (("C=16 T=2^20 S=3 (Path B)", IIR_CHANNELS, IIR_BLOCK_LEN),
                         ("C=1 T=2^20 S=3", 1, IIR_BLOCK_LEN),
                         ("C=16 T=4096 S=3", IIR_CHANNELS, IIR_CPU_BLOCK_LEN)):
        x = torch.randn(ch, t, device=dev, generator=gen)
        s0 = torch.zeros(ch, 3, 2, device=dev)
        if t == IIR_BLOCK_LEN:
            y, _ = ck.iir_sos(x, sos5, s0)
            torch.cuda.synchronize()
            check_against_scipy(y.cpu().numpy(), x.cpu().numpy(), 5, f"iir_sos {label}")
        ms = statistics.median(cuda_ms(lambda: ck.iir_sos(x, sos5, s0)) for _ in range(3))
        b_ms, b_by = iir_bound_ms(ch, t, 3)
        iir_rows[label] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                           "share_of_bound": b_ms / ms}
        print(f"  iir_sos {label}: kernel {ms:.4f} ms "
              f"({ch * t / (ms * 1e-3) / 1e6:.2f} Msamples/s over all channels), "
              f"bound {b_ms:.5f} ms ({b_by}), {b_ms / ms:.2%} of it "
              f"(chunk L = {SOS_CHUNK}) on {card}")
    results["iir_sos"]["timed_shapes"] = iir_rows
    del x, y

    # fir_demod against FIR then demod, on FM-modulated input (away from the
    # |v| ≈ 0 points where atan2 turns f32 rounding into any angle)
    from gnuradio4_tpu_torch.ops.demod import quadrature_demod
    def fm_stream(shape):
        n = shape[-1]
        walk = torch.randn(shape, device=dev, generator=gen).cumsum(-1) * 0.05
        ph = torch.sin(walk) * 1.5 + torch.arange(n, device=dev) * 0.3
        noise = torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)
        return (torch.polar(torch.ones_like(ph), ph) + 0.05 * noise).contiguous()

    def wrapped(a, b):
        d = (a - b) / WBFM_GAIN
        return float(torch.remainder(d + np.pi, 2 * np.pi).sub(np.pi).abs().max()
                     ) * WBFM_GAIN

    chan = wbfm_channel_taps()
    xl_wbfm = freq_xlating_taps(chan, 60e3, QUAD_RATE)
    tol_d = DEMOD_ATOL * WBFM_GAIN
    demod_rows = {}
    for label, taps, decim, shape, timed in (
            ("c64 x f32 taps K=127 T=2^22 (Path A)", chan, 1, (WBFM_BLOCK_LEN,), True),
            ("c64 x c64 taps K=127 T=2^23", xl_wbfm, 1, (1 << 23,), True),
            ("c64 x f32 taps K=127 decim 4 T=2^22", chan, 4, (1 << 22,), True),
            ("c64 x f32 taps K=127 decim 2 ragged T=1000003", chan, 2, (1000003,), False),
            ("c64 x c64 taps K=127 C=4 T=2^18+77", xl_wbfm, 1, (4, (1 << 18) + 77), False),
            ("c64 x f32 taps K=127 decim 1024 T=2^22", chan, 1024, (1 << 22,), False),
            ("c64 x c64 taps K=127 decim 2048 T=2^22", xl_wbfm, 2048, (1 << 22,), False),
            ("c64 x c64 taps K=7 C=65539 T=64", np.ascontiguousarray(xl_wbfm[60:67]),
             1, (65539, 64), False)):
        k = len(taps)
        xc = fm_stream((*shape[:-1], shape[-1] + k - 1))
        prev = torch.polar(torch.ones(shape[:-1], device=dev),
                           torch.full(shape[:-1], 0.7, device=dev))
        h = torch.from_numpy(np.ascontiguousarray(taps)).to(dev)
        y = ck.fir_demod(xc, h, decim, prev, WBFM_GAIN)
        y_ref = ck.fir_demod_ref(xc, h, decim, prev, WBFM_GAIN)
        torch.cuda.synchronize()
        check(y.shape == y_ref.shape == (*shape[:-1], shape[-1] // decim),
              f"fir_demod {label}: shape {y.shape} vs {y_ref.shape}")
        err = wrapped(y, y_ref)
        row = {"case": label, "max_abs_err": err, "tol": tol_d}
        if timed:
            row["ms"], row["plain_ms"] = kernel_vs_plain_ms(
                lambda: ck.fir_demod(xc, h, decim, prev, WBFM_GAIN),
                lambda: ck.fir_demod_ref(xc, h, decim, prev, WBFM_GAIN))
            # the fusion's yardstick: the fir_banded kernel, then the demod
            row["unfused_ms"] = cuda_ms(lambda: quadrature_demod(
                ck.fir_banded(xc[k - 1:], xc[: k - 1], h, decim), prev,
                gain=WBFM_GAIN))
            row["bound_ms"], row["bound_by"] = bound_ms(*demod_work(
                shape, h.is_complex(), k, decim))
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            demod_rows[label] = {key: row[key] for key in (
                "ms", "plain_ms", "unfused_ms", "bound_ms", "bound_by", "share_of_bound")}
            if "Path A" in label:
                results["fir_demod"].update(
                    demod_rows[label], library_ms=None,
                    library_note="no single PyTorch call fuses a FIR with the "
                                 "quadrature demod")
        print(f"  fir_demod {label}: max|Δ| {err:.3e} (tol {tol_d:.3e}, wrapped)"
              + (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                 f"unfused (fir_banded, then the demod) {row['unfused_ms']:.4f} ms, "
                 f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}), "
                 f"{row['share_of_bound']:.2%} of it on {card}" if timed else ""))
        check(err <= tol_d, f"fir_demod {label}: {err} > {tol_d}")
        results["fir_demod"]["max_abs_err"] = max(results["fir_demod"]["max_abs_err"], err)
    results["fir_demod"]["timed_shapes"] = demod_rows
    # K 16384 complex taps: the taps go in chunks; against the demod of the
    # float64 FIR rounded to complex64
    xc = fm_stream(((1 << 15) + 16383,))
    prev = torch.ones((), dtype=torch.complex64, device=dev)
    y = ck.fir_demod(xc, long_taps, 1, prev, WBFM_GAIN)
    v = torch.from_numpy(fir_float64(xc, long_taps, 1).astype(np.complex64)).to(dev)
    y_ref, _ = quadrature_demod(v, prev, gain=WBFM_GAIN)
    torch.cuda.synchronize()
    err = wrapped(y, y_ref)
    print(f"  fir_demod c64 x c64 taps K=16384 T=2^15: max|Δ| {err:.3e} against "
          f"float64 (tol {tol_d:.3e}, wrapped)")
    check(y.shape == (1 << 15,) and err <= tol_d, f"fir_demod K=16384: {err} > {tol_d}")
    results["fir_demod"]["max_abs_err"] = max(results["fir_demod"]["max_abs_err"], err)
    # carry across two calls: the second call's prev is the first's last FIR output
    n = 1 << 20
    xc = fm_stream((2 * n + 126,))
    one = torch.ones((), dtype=torch.complex64, device=dev)
    y_one = ck.fir_demod(xc, xl_wbfm, 1, one, WBFM_GAIN)
    y1 = ck.fir_demod(xc[: n + 126], xl_wbfm, 1, one, WBFM_GAIN)
    v_last = ck.fir_banded_ref(xc[126: n + 126], xc[:126], xl_wbfm)[-1]
    y2 = ck.fir_demod(xc[n:], xl_wbfm, 1, v_last, WBFM_GAIN)
    torch.cuda.synchronize()
    err = wrapped(torch.cat([y1, y2]), y_one)
    print(f"  fir_demod c64 x c64 taps two calls of 2^20, v[-1] carried: max|Δ| "
          f"to one call {err:.3e} (tol {tol_d:.3e})")
    check(err <= tol_d, f"fir_demod carry: {err} > {tol_d}")
    results["fir_demod"]["max_abs_err"] = max(results["fir_demod"]["max_abs_err"], err)
    del xc, y_one, y1, y2

    # 4 + 5. the main path, absorbed then not: launches counted over both runs
    ck.reset_launch_counts()
    print(f"[4 chain] block_len 2^23, {STEPS} steps, rotation absorbed")
    absorbed = run_chain("cuda", BLOCK_LEN, STEPS, absorb=True)
    counts4 = ck.launch_counts()
    print(f"  launches {counts4}")
    check(counts4["fir_banded"] == 2 * STEPS,
          f"fir_banded launched {counts4['fir_banded']} times, expected {2 * STEPS}")
    check(counts4["nco_mix"] == 0, "nco_mix launched on the absorbed path")
    check_chain_outputs(*absorbed, BLOCK_LEN, STEPS, "absorbed")

    print(f"[5 chain] block_len 2^23, {STEPS} steps, absorption off")
    derotated = run_chain("cuda", BLOCK_LEN, STEPS, absorb=False)
    counts = ck.launch_counts()
    print(f"  launches {counts}")
    check(counts["nco_mix"] - counts4["nco_mix"] == STEPS,
          f"nco_mix launched {counts['nco_mix']} times, expected {STEPS}")
    check(counts["fir_banded"] - counts4["fir_banded"] == 2 * STEPS,
          "fir_banded launch count on the derotated path")
    check_chain_outputs(*derotated, BLOCK_LEN, STEPS, "derotated")
    # the demod's first sample uses the x[-1] = 1 seed, which absorbed and
    # derotated runs see rotated differently; it reaches the first 8 audio
    # samples (63 taps, ÷8), so those are skipped
    compare_sinks(absorbed, derotated, "absorbed vs derotated", skip_audio=8)
    for k in KERNELS:
        results[k]["launches"] = counts[k]
    phase45 = (absorbed, derotated)      # phase 21 holds the YAML chain to them
    del absorbed, derotated

    # chain throughput: NullSinks (no device→host copy), CUDA events over steps
    g, _, _, _ = build_chain("null")
    sched = gt.Scheduler(g, block_len=BLOCK_LEN, sample_rate=FS, device="cuda")
    for _ in range(3):
        sched.step_once()
    torch.cuda.synchronize()
    # 5 windows of 20 steps; per window, ms/step from CUDA events and host wall
    n_timed, windows = 20, []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n_timed):
            sched.step_once()
        end.record()
        torch.cuda.synchronize()
        windows.append((start.elapsed_time(end) / n_timed,
                        (time.perf_counter() - t0) / n_timed * 1e3))
    ms = statistics.median(w[0] for w in windows)
    msps = BLOCK_LEN / (ms * 1e-3) / 1e6
    chain_msps = msps                    # phase 28 reads the piped chain against it
    torch.cuda.reset_peak_memory_stats()
    sched.step_once()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  chain: {msps:.2f} Msps (median {ms:.4f} ms/step over 5 windows "
          f"of {n_timed} steps, CUDA events; windows (events ms, wall ms) "
          f"{[(round(a, 4), round(b, 4)) for a, b in windows]}; peak device "
          f"memory {peak_gib:.3f} GiB) on {card}")

    # 6. CPU (plain versions) against the card
    print(f"[6 cpu vs gpu] block_len 2^16, {CPU_STEPS} steps")
    for absorb in (True, False):
        label = "absorbed" if absorb else "derotated"
        cpu = run_chain("cpu", CPU_BLOCK_LEN, CPU_STEPS, absorb)
        gpu = run_chain("cuda", CPU_BLOCK_LEN, CPU_STEPS, absorb)
        compare_sinks(cpu, gpu, f"cpu vs gpu, {label}")

    # 7. Path A: suite config 3, the WBFM receiver as a nested graph
    print(f"[7 wbfm] block_len 2^22 → {WBFM_IN_LEN}, {WBFM_STEPS} steps")
    ck.reset_launch_counts()
    compiled, audio = run_wbfm("cuda", WBFM_BLOCK_LEN, WBFM_STEPS)
    counts = ck.launch_counts()
    print(f"  launches {counts}")
    check(compiled.block_len == WBFM_IN_LEN, f"Path A block_len {compiled.block_len}")
    check(counts["fir_banded"] == 2 * WBFM_STEPS,
          f"fir_banded launched {counts['fir_banded']} times on Path A, "
          f"expected {2 * WBFM_STEPS}")
    check(counts["nco_mix"] == counts["iir_sos"] == counts["fir_demod"] == 0,
          f"unexpected launches on Path A: {counts}")
    for k in KERNELS:
        results[k]["launches"] += counts[k]
    check_wbfm_audio(audio, WBFM_IN_LEN // 5, WBFM_STEPS, "Path A (card)")
    del audio, compiled
    g, _ = build_wbfm("null")
    sched = gt.Scheduler(g, block_len=WBFM_BLOCK_LEN, sample_rate=QUAD_RATE,
                         device="cuda")
    for _ in range(3):
        sched.step_once()
    torch.cuda.synchronize()
    ms_a, windows = events_ms_per_step(sched.step_once, 20)
    print(f"  Path A: {WBFM_IN_LEN / (ms_a * 1e-3) / 1e6:.2f} Msps (median {ms_a:.4f} "
          f"ms/step over 5 windows of 20 steps, CUDA events; windows (events ms, "
          f"wall ms) {[(round(a, 4), round(b, 4)) for a, b in windows]}) on {card}")
    del sched, g
    for bl in WBFM_CPU_BLOCK_LENS:
        cpu = run_wbfm("cpu", bl, CPU_STEPS)[1]
        gpu = run_wbfm("cuda", bl, CPU_STEPS)[1]
        check_wbfm_audio(gpu, bl // 5, CPU_STEPS, f"Path A card, block_len {bl}")
        d = float(np.max(np.abs(cpu - gpu))) if cpu.shape == gpu.shape else np.inf
        print(f"  Path A cpu vs gpu, block_len {bl}: audio max|Δ| {d:.3e} "
              f"(tol {WBFM_ATOL})")
        check(d <= WBFM_ATOL, f"Path A cpu vs gpu at block_len {bl}: {d}")

    # 8. Path B: the IIR filter block, whose engine picks the kernel
    print(f"[8 iir] block_len 2^20, {IIR_STEPS} steps, {IIR_CHANNELS} channels")
    _, x_src = run_iir_path("cuda", 5, IIR_BLOCK_LEN, IIR_STEPS, source_only=True)
    ck.reset_launch_counts()
    iir, y_b = run_iir_path("cuda", 5, IIR_BLOCK_LEN, IIR_STEPS)
    counts = ck.launch_counts()
    print(f"  launches {counts}; engine {iir._engine(dev)}")
    # three launches per step: reduce, carry, rerun (one group of sections)
    check(counts["iir_sos"] == 3 * IIR_STEPS,
          f"iir_sos launched {counts['iir_sos']} times, expected {3 * IIR_STEPS}")
    check(counts["fir_banded"] == counts["nco_mix"] == counts["fir_demod"] == 0,
          f"unexpected launches on Path B: {counts}")
    for k in KERNELS:
        results[k]["launches"] += counts[k]
    check(x_src.shape == (IIR_CHANNELS, IIR_BLOCK_LEN * IIR_STEPS),
          f"Path B source shape {x_src.shape}")
    check_against_scipy(y_b, x_src, 5, "Path B order 5 (iir_sos)")
    ck.reset_launch_counts()
    iir4, y4 = run_iir_path("cuda", 4, IIR_BLOCK_LEN, IIR_STEPS)
    counts = ck.launch_counts()
    print(f"  order 4: launches {counts}; engine {iir4._engine(dev)}")
    check(iir4._engine(dev) == "parallel" and counts["iir_sos"] == 0,
          f"order 4 under auto: engine {iir4._engine(dev)}, launches {counts}")
    check_against_scipy(y4, x_src, 4, "Path B order 4 (parallel engine)")
    del y_b, y4, x_src
    def iir_step_ms(order: int, engine: str):
        """Path B's ms per step (CUDA events, 5 windows of 20 steps), the
        windows, and the device ms of one step by torch.profiler."""
        g, _, _ = build_iir_path(order, "null", engine=engine)
        sched = gt.Scheduler(g, block_len=IIR_BLOCK_LEN, sample_rate=IIR_FS,
                             device="cuda")
        for _ in range(3):
            sched.step_once()
        torch.cuda.synchronize()
        ms, windows = events_ms_per_step(sched.step_once, 20)
        dev_ms, top = profile_device(sched.step_once)
        return ms, windows, dev_ms, top

    ms_b, windows, dev_b, top_b = iir_step_ms(5, "auto")
    busy = f"{dev_b / ms_b:.1%}" if dev_b else "not measured (no device events)"
    path_b = {"name": "Path B", "msps": IIR_CHANNELS * IIR_BLOCK_LEN / (ms_b * 1e-3) / 1e6,
              "ms_per_step": ms_b, "device_ms_per_step": dev_b,
              "device_busy": dev_b / ms_b if dev_b else None}
    print(f"  Path B: {ms_b:.4f} ms/step (median over 5 windows of 20 steps, CUDA "
          f"events; windows (events ms, wall ms) {fmt_windows(windows)}); device "
          f"{dev_b} ms per step by torch.profiler, busy {busy}; top "
          f"{[(round(t, 4), k[:50]) for t, k in top_b[:4]]} on {card}")
    # the order-4 design (both sections second order): the parallel engine,
    # auto's choice on CUDA, against the iir_sos kernel, in turns
    eng = {"parallel": [], "pallas": []}
    for e in ("parallel", "pallas", "pallas", "parallel"):
        eng[e].append(iir_step_ms(4, e)[::2])
    for e, runs in eng.items():
        print(f"  Path B order 4, engine {e}: "
              f"{statistics.median(r[0] for r in runs):.4f} ms/step "
              f"(runs {[round(r[0], 4) for r in runs]}), device "
              f"{[r[1] for r in runs]} ms per step by torch.profiler")
    _, cpu = run_iir_path("cpu", 5, IIR_CPU_BLOCK_LEN, CPU_STEPS)
    _, gpu = run_iir_path("cuda", 5, IIR_CPU_BLOCK_LEN, CPU_STEPS)
    check(cpu.shape == gpu.shape, f"Path B cpu vs gpu shapes {cpu.shape} {gpu.shape}")
    err = rms_err(gpu, cpu)
    print(f"  Path B cpu (scan engine) vs gpu (iir_sos), block_len 2^12: max|Δ| "
          f"{err:.3e}·RMS (tol {SCIPY_RTOL}: direct form against the cascade)")
    check(err <= SCIPY_RTOL, f"Path B cpu vs gpu: {err}")

    # 9. the fused FIR→demod entry point at Path A's shapes
    print(f"[9 fused front end] fir_quad_demod_fused, 4 chunks of 2^22")
    ck.reset_launch_counts()
    outs, inputs = fused_front_end(dev, WBFM_BLOCK_LEN, 4)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    print(f"  launches {counts}")
    check(counts["fir_demod"] == 4 and counts["fir_banded"] == 0,
          f"fused front end launches {counts}")
    for k in KERNELS:
        results[k]["launches"] += counts[k]
    y = torch.cat(outs)
    check(y.shape == (4 * WBFM_BLOCK_LEN,) and bool(torch.isfinite(y).all()),
          f"fused front end output {tuple(y.shape)}")
    dev_c = float((y[WBFM_SKIP:] - WBFM_CONST).abs().max())
    print(f"  demod max|Δ| from {WBFM_CONST:.8f} after {WBFM_SKIP} samples = "
          f"{dev_c:.3e} (tol {WBFM_ATOL})")
    check(dev_c <= WBFM_ATOL, f"fused front end deviates {dev_c}")
    prev = torch.ones((), dtype=torch.complex64, device=dev)
    taps = wbfm_channel_taps()
    err = 0.0
    for xc, got in zip(inputs, outs):
        want = ck.fir_demod_ref(xc, taps, 1, prev, WBFM_GAIN)
        err = max(err, float((got - want).abs().max()))
        prev = ck.fir_banded_ref(xc[126:], xc[:126], taps)[-1]
    print(f"  against FIR then demod (plain), chunk by chunk: max|Δ| {err:.3e} "
          f"(tol {tol_d:.3e})")
    check(err <= tol_d, f"fused front end against the composition: {err}")
    del outs, inputs, y

    # 10. the full scheduler on the existing paths: pipelined async delivery
    # and batched super-steps against the synchronous unbatched run
    from gnuradio4_tpu_torch.core.profiler import Profiler
    settings = {"sync": dict(pipeline_depth=1),
                "async": dict(pipeline_depth=2, async_delivery=True),
                "async+batch4": dict(pipeline_depth=2, async_delivery=True,
                                     batch_steps=4)}
    paths = [path_b]
    print("[10 scheduler] chain at 2^23 and Path A at 2^22 under "
          f"{list(settings)}")
    for absorb in (True, False):
        label = "absorbed" if absorb else "derotated"
        ref = None
        for name, kw in settings.items():
            ck.reset_launch_counts()
            out = run_chain("cuda", BLOCK_LEN, STEPS, absorb, **kw)
            counts = ck.launch_counts()
            want_nco = 0 if absorb else STEPS
            check(counts["fir_banded"] == 2 * STEPS and counts["nco_mix"] == want_nco,
                  f"chain {label} {name}: launches {counts}, expected fir_banded "
                  f"{2 * STEPS}, nco_mix {want_nco}")
            for k in KERNELS:
                results[k]["launches"] += counts[k]
            if ref is None:
                check_chain_outputs(*out, BLOCK_LEN, STEPS, f"chain {label} {name}")
                ref = out
            else:
                same = all(np.array_equal(a, b) for a, b in zip(out, ref))
                print(f"  chain {label} {name}: launches {counts}; sinks bitwise "
                      f"equal to sync: {same}")
                check(same, f"chain {label} {name}: sinks differ from the sync run")
        del ref, out
    ref = None
    for name, kw in settings.items():
        ck.reset_launch_counts()
        _, audio = run_wbfm("cuda", WBFM_BLOCK_LEN, WBFM_STEPS, **kw)
        counts = ck.launch_counts()
        check(counts["fir_banded"] == 2 * WBFM_STEPS and counts["nco_mix"] == 0,
              f"Path A {name}: launches {counts}")
        for k in KERNELS:
            results[k]["launches"] += counts[k]
        if ref is None:
            check_wbfm_audio(audio, WBFM_IN_LEN // 5, WBFM_STEPS, f"Path A {name}")
            ref = audio
        else:
            same = np.array_equal(audio, ref)
            print(f"  Path A {name}: launches {counts}; audio bitwise equal to "
                  f"sync: {same}")
            check(same, f"Path A {name}: audio differs from the sync run")
    del ref, audio
    for label, build, bl, fs, n_in in (
            ("chain absorbed", lambda: build_chain("null")[0], BLOCK_LEN, FS, BLOCK_LEN),
            ("chain derotated", lambda: build_chain("null")[0], BLOCK_LEN, FS, BLOCK_LEN),
            ("Path A", lambda: build_wbfm("null")[0], WBFM_BLOCK_LEN, QUAD_RATE,
             WBFM_IN_LEN)):
        for name, kw in settings.items():
            if label == "chain derotated":
                os.environ["GR4TPU_NO_ROTATION_ABSORB"] = "1"
            try:
                sched = gt.Scheduler(build(), block_len=bl, sample_rate=fs,
                                     device="cuda", profiler=Profiler(), **kw)
                sched.init()
            finally:
                os.environ.pop("GR4TPU_NO_ROTATION_ABSORB", None)
            sched.fsm.transition_to(gt.State.RUNNING)
            for _ in range(2):
                sched._pump_once()
            torch.cuda.synchronize()
            ms, windows, host_ms, split = drive_windows(sched, 20)
            finish(sched)
            msps = n_in / (ms * 1e-3) / 1e6
            print(f"  {label} {name}: {msps:.2f} Msps, {ms:.4f} ms/step (median of "
                  f"5 windows of 20 steps, CUDA events; (events ms, wall ms) "
                  f"{fmt_windows(windows)}); host {host_ms:.4f} ms/step in the "
                  f"pump ({fmt_split(split)})")
            paths.append({"name": f"{label} {name}", "msps": msps, "ms_per_step": ms,
                          "host_ms_per_step": host_ms})
            del sched

    # 11. Path C: suite config 5 at full size
    from gnuradio4_tpu_torch.ops import noise
    from gnuradio4_tpu_torch.ops.channelizer import branch_fir_macs
    from gnuradio4_tpu_torch.ops.demod import quadrature_demod
    print(f"[11 config 5] block_len 2^21, batch_steps {C5_BATCH}, 256 channels")
    k_gpu, k_cpu = noise.key(SEED, dev), noise.key(SEED)
    for _ in range(2):
        k_gpu, k_cpu = noise.split(k_gpu)[0], noise.split(k_cpu)[0]
    check(torch.equal(k_gpu.cpu(), k_cpu), "threefry: split keys differ")
    bits_same = torch.equal(noise.random_bits(k_gpu, (2, C5_BLOCK_LEN)).cpu(),
                            noise.random_bits(k_cpu, (2, C5_BLOCK_LEN)))
    z_gpu, k2_gpu = noise.complex_gaussian(k_gpu, (C5_BLOCK_LEN,))
    z_cpu, k2_cpu = noise.complex_gaussian(k_cpu, (C5_BLOCK_LEN,))
    zg = torch.view_as_real(z_gpu).cpu().numpy()
    zc = torch.view_as_real(z_cpu).numpy()
    noise_err = float(np.max(np.abs(zg - zc) / np.maximum(1.0, np.abs(zc))))
    print(f"  threefry after two chained splits: keys equal, random bits "
          f"[2, 2^21] equal on card and CPU: {bits_same}; complex_gaussian "
          f"[2^21] max|Δ|/max(1,|x|) {noise_err:.3e} (tol {NOISE_RTOL}); next "
          f"keys equal: {torch.equal(k2_gpu.cpu(), k2_cpu)}")
    check(bits_same and torch.equal(k2_gpu.cpu(), k2_cpu), "threefry bits differ")
    check(noise_err <= NOISE_RTOL, f"complex_gaussian card vs CPU {noise_err}")
    del z_cpu, zc, zg

    g, snk = build_config5("TagSink")
    config5_scheduler(g, "cuda").run_and_wait(4 * C5_BATCH)
    torch.cuda.synchronize()
    n_out = 4 * C5_BATCH * C5_BLOCK_LEN // C5_CHANNELS
    y = snk.data()
    check(y.shape == (C5_CHANNELS, n_out), f"config 5 sink shape {y.shape}")
    check(bool(np.all(np.isfinite(y)) and np.all(np.abs(y) <= np.pi + 1e-6)),
          "config 5: demod output not finite or outside [-π, π]")
    got = [(int(t.index), dict(t.map)) for t in snk.tags]
    want = [(i * (C5_TAG_PERIOD // C5_CHANNELS),
             {"trigger_time": float(i * C5_TAG_PERIOD / C5_FS)}) for i in range(64)]
    print(f"  tags: {len(got)} at the TagSink over 4 super-steps (expected 64 at "
          f"i·4096); first {got[:2]}, last {got[-1:]}")
    check(got == want, f"config 5 tags differ from the expected 64: {got[:4]}...")
    del y, snk, g
    runs = []
    for device in ("cpu", "cuda"):
        g, snk = build_config5("TagSink")
        config5_scheduler(g, device, C5_CPU_BLOCK_LEN, 2).run_and_wait(6)
        runs.append((snk.data(), [(int(t.index), t.map) for t in snk.tags]))
    c5_err = wrapped_err(runs[1][0], runs[0][0])
    print(f"  cpu vs card at block_len 2^16, batch_steps 2, 3 super-steps: demod "
          f"max|Δ| {c5_err:.3e} rad, wrapped (tol {C5_ATOL}); tags equal: "
          f"{runs[0][1] == runs[1][1]} ({len(runs[0][1])})")
    check(runs[0][0].shape == runs[1][0].shape and c5_err <= C5_ATOL
          and runs[0][1] == runs[1][1], "config 5 card vs CPU")
    del runs
    g, _ = build_config5("NullSink")
    sched = config5_scheduler(g, "cuda")
    sched.profiler = Profiler()
    sched.init()
    sched.fsm.transition_to(gt.State.RUNNING)
    sched._pump_once()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, windows, host_ms, split = drive_windows(sched, 4 * C5_BATCH)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    dev_ms, top = profile_device(sched._pump_once)
    finish(sched)
    del sched
    msps = C5_BLOCK_LEN / (ms * 1e-3) / 1e6
    print(f"  Path C: {msps:.2f} Msps, {ms:.4f} ms per logical step (median of 5 "
          f"windows of 4 super-steps, CUDA events; (events ms, wall ms) "
          f"{fmt_windows(windows)}); pump wall {host_ms:.4f} ms/step "
          f"({fmt_split(split)}; includes waits in a full CUDA launch queue); "
          f"peak device memory {peak_gib:.3f} GiB")
    if dev_ms is None:
        print("  torch.profiler: no device activity recorded (not measured)")
    else:
        dev_step = dev_ms / C5_BATCH
        print(f"  torch.profiler, one super-step: device busy {dev_step:.4f} ms per "
              f"logical step, {dev_step / ms:.1%} of the step; top kernels (ms per "
              f"super-step) {[(round(t, 4), k) for t, k in top]}")
    paths.append({"name": "Path C config 5", "msps": msps, "ms_per_step": ms,
                  "host_ms_per_step": host_ms})
    rows = C5_BLOCK_LEN // C5_CHANNELS
    xc = torch.randn(rows + 7, C5_CHANNELS, dtype=torch.complex64, device=dev,
                     generator=gen)
    hp = torch.randn(8, C5_CHANNELS, device=dev, generator=gen)
    v = branch_fir_macs(xc, hp, rows)
    yc = torch.randn(C5_CHANNELS, rows, dtype=torch.complex64, device=dev,
                     generator=gen)
    last = torch.ones(C5_CHANNELS, dtype=torch.complex64, device=dev)
    op_ms = {"threefry complex_gaussian [2^21]":
             cuda_ms(lambda: noise.complex_gaussian(k_gpu, (C5_BLOCK_LEN,))),
             "branch FIR [8199, 256] x 8 taps": cuda_ms(lambda: branch_fir_macs(xc, hp, rows)),
             "FFT [8192, 256] along 256": cuda_ms(lambda: torch.fft.fft(v, dim=-1)),
             "corner turn [8192, 256] -> [256, 8192]": cuda_ms(lambda: v.t().contiguous()),
             "demod [256, 8192]": cuda_ms(lambda: quadrature_demod(yc, last, gain=1.0))}
    print("  per-op device ms at Path C's shapes (CUDA events, median of 10): "
          + "; ".join(f"{k} {t:.4f}" for k, t in op_ms.items()))
    del xc, hp, v, yc

    # 12. Path D: suite config 6, the scheduler-overhead cascade
    print(f"[12 config 6] 40-block cascade, block_len 2^16, {C6_STEPS} steps")
    g, snk = build_config6("CountingSink", C6_STEPS * C6_BLOCK_LEN)
    gt.Scheduler(g, block_len=C6_BLOCK_LEN, sample_rate=C5_FS, device="cuda",
                 pipeline_depth=2, async_delivery=True).run_and_wait()
    print(f"  CountingSink count {snk.count} (expected {C6_STEPS * C6_BLOCK_LEN})")
    check(snk.count == C6_STEPS * C6_BLOCK_LEN, "config 6 count")
    g, snk = build_config6("VectorSink", 8 * C6_BLOCK_LEN)
    gt.Scheduler(g, block_len=C6_BLOCK_LEN, sample_rate=C5_FS, device="cuda",
                 pipeline_depth=2, async_delivery=True).run_and_wait()
    d = snk.data()
    same = d.shape == (8 * C6_BLOCK_LEN,) and np.array_equal(
        d, np.arange(8 * C6_BLOCK_LEN, dtype=np.float32))
    print(f"  data through ×2/÷2 ×20 equal to the source ramp: {same}")
    check(same, "config 6 data changed through the cascade")
    for name, kw in (("sync", dict(pipeline_depth=1)),
                     ("async", dict(pipeline_depth=2, async_delivery=True))):
        g, _ = build_config6("CountingSink")
        sched = gt.Scheduler(g, block_len=C6_BLOCK_LEN, sample_rate=C5_FS,
                             device="cuda", profiler=Profiler(), **kw)
        sched.init()
        sched.fsm.transition_to(gt.State.RUNNING)
        for _ in range(5):
            sched._pump_once()
        torch.cuda.synchronize()
        ms, windows, host_ms, split = drive_windows(sched, C6_STEPS, windows=3)
        finish(sched)
        del sched
        msps = C6_BLOCK_LEN / (ms * 1e-3) / 1e6
        print(f"  Path D {name}: {msps:.2f} Msps, {ms:.4f} ms/step (median of 3 "
              f"windows of {C6_STEPS} steps, CUDA events; (events ms, wall ms) "
              f"{fmt_windows(windows)}); host {host_ms:.4f} ms/step in the pump "
              f"({fmt_split(split)})")
        paths.append({"name": f"Path D config 6 {name}", "msps": msps,
                      "ms_per_step": ms, "host_ms_per_step": host_ms})

    paths += suite_phases(dev, gen, results)
    yaml_phases(dev, card, phase45, paths)
    loop_phases(dev, paths)
    modem_phases(dev, paths, results)
    carrier_phases(dev, paths, results)
    acquisition_phases(dev, card, paths, results)
    fec_flow_phases(dev, card, paths, results)
    gnss_coding_phases(dev, card, paths, results)
    host_core_phases(dev, card, phase45, chain_msps, paths, results)
    io_phases(dev, card, phase45, paths, results)
    mesh_derotated = mesh_phases(dev, card, phase45, chain_msps, paths,
                                 results)
    multihost_phases(dev, card, phase45[1], mesh_derotated, paths, results)
    del phase45, mesh_derotated

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound", "library_ms")
    kernels = [{"name": name, "route": "cuda", **meta,
                **{key: results[name][key] for key in keys},
                **{key: results[name][key] for key in ("library_note", "timed_shapes")
                   if key in results[name]}}
               for name, meta in KERNELS.items()]
    print(card)
    print(json.dumps({"paths": paths}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--multihost-worker"]:
            sys.exit(multihost_worker(int(sys.argv[2]), int(sys.argv[3]),
                                      sys.argv[4], sys.argv[5]))
        sys.exit(main())
    except SmokeFailure as e:
        # on stdout too: a record that keeps only stdout keeps the cause
        for stream in (sys.stdout, sys.stderr):
            print(f"chip_smoke: FAILED: {e}", file=stream, flush=True)
        sys.exit(1)
    except Exception:
        traceback.print_exc(file=sys.stdout)
        raise
