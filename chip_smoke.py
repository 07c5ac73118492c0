#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (gnuradio4_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero and prints no
result line:

1. device: the card's name, and ``nvidia-smi``'s name and power limit;
2. build: compile the hand-written kernels from ``gnuradio4_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version, on the card, at the headline
   chain's shapes (T = 2^23), a ragged length and multi-channel input, with
   median times from CUDA events;
4. the headline chain (ComplexToneSource → FreqXlatingFir(127) → {FFT(4096) ;
   QuadratureDemod → FirFilter(63, ÷8)}) through ``Graph`` → ``Scheduler`` at
   block_len 2^23 for 4 steps with rotation absorption (the default): tone peak
   and demod constant checked, kernel launches counted, Msps timed;
5. the same chain with absorption off (GR4TPU_NO_ROTATION_ABSORB=1), which runs
   the NCO mixer kernel; its sinks must match phase 4;
6. the chain at block_len 2^16 on the CPU (plain versions) against the card.

The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

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
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of one call of ``fn`` (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        marks.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def kernel_vs_plain_ms(kernel, plain) -> tuple[float, float]:
    """Median ms of the kernel and of its plain version, measured in turns
    (plain, kernel, kernel, plain) so drift on the card hits both alike."""
    p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
    return statistics.median((k1, k2)), statistics.median((p1, p2))


def build_chain(sinks: str):
    """The headline chain of bench.py, built in the port. ``sinks``: 'vector'
    (host capture) or 'null' (count only, no device→host copy)."""
    import numpy as np
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks.basic import ComplexToneSource
    from gnuradio4_tpu_torch.blocks.filter import FirFilter, FreqXlatingFir
    from gnuradio4_tpu_torch.blocks.fourier import FFT
    from gnuradio4_tpu_torch.blocks.sdr import QuadratureDemod
    from gnuradio4_tpu_torch.blocks.testing import NullSink, VectorSink
    from gnuradio4_tpu_torch.ops import filter_design as fd

    g = gt.Graph()
    src = ComplexToneSource(frequency=1e6)
    taps = fd.design_fir("lowpass", 127, sample_rate=FS, f_low=2e6)
    fir = FreqXlatingFir(taps=taps.astype(np.float32), center_freq=3e6,
                         sample_rate_in=FS, decim=1)
    fft = FFT(fft_size=4096, window="Hann", output="magnitude", calibrate=False)
    dem = QuadratureDemod(gain=1.0)
    audio = FirFilter(taps=fd.design_fir("lowpass", 63, sample_rate=FS,
                                         f_low=1e6).astype(np.float32), decim=8)
    sink = VectorSink if sinks == "vector" else NullSink
    s1, s2 = sink(name="spec"), sink(name="audio")
    g.connect_chain(src, fir, fft, s1)
    g.connect(fir, dem)
    g.connect_chain(dem, audio, s2)
    return g, fir, s1, s2


def run_chain(device: str, block_len: int, steps: int, absorb: bool):
    import gnuradio4_tpu_torch as gt
    if absorb:
        os.environ.pop("GR4TPU_NO_ROTATION_ABSORB", None)
    else:
        os.environ["GR4TPU_NO_ROTATION_ABSORB"] = "1"
    try:
        g, fir, s1, s2 = build_chain("vector")
        sched = gt.Scheduler(g, block_len=block_len, sample_rate=FS, device=device)
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
    torch.backends.cudnn.allow_tf32 = False
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
        print(f"  fir_banded {label}: max|Δ| {err:.3e} (tol {FIR_ATOL})"
              + (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms"
                 if timed else ""))
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
            row["ms"], row["plain_ms"] = kernel_vs_plain_ms(
                lambda: ck.nco_mix(x, phase0, dphi),
                lambda: ck.nco_mix_ref(x, phase0, dphi))
            main_nco = row
        print(f"  nco_mix {label}: max|Δ| {err:.3e} (tol {NCO_ATOL})"
              + (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms"
                 if "ms" in row else ""))
        check(err <= NCO_ATOL, f"nco_mix {label}: max|Δ| {err} > {NCO_ATOL}")
        results["nco_mix"]["max_abs_err"] = max(results["nco_mix"]["max_abs_err"], err)
    results["fir_banded"].update(ms=main_fir["ms"], plain_ms=main_fir["plain_ms"])
    results["nco_mix"].update(ms=main_nco["ms"], plain_ms=main_nco["plain_ms"])

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

    kernels = [{"name": name, "route": "cuda", **meta,
                "launches": results[name]["launches"],
                "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
               for name, meta in KERNELS.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
