#!/usr/bin/env python3
"""Time the port's CUDA kernels of this tree against those of another checkout,
on one card, in one process.

    python3 kernel_ab.py OTHER_ROOT            # kernels, this tree vs OTHER_ROOT
    python3 kernel_ab.py --steps [ROOT]        # device ms per step of the paths

The first form builds this tree's kernels (``cuda_kernels.build``) and
``OTHER_ROOT/gnuradio4_tpu_torch/csrc/*.cu`` with the same ``nvcc`` flags (into
``OTHER_ROOT/gnuradio4_tpu_torch/_build/``), prints both builds' ``-Xptxas
-v`` registers per kernel, loads both through their plain C interfaces and,
on the same inputs, times ``fir_banded`` at ``chip_smoke.py``'s timed shapes,
``fir_demod`` at its three (c64 x f32 and c64 x c64 taps at decim 1, c64 x
f32 at decim 4) and ``iir_sos`` at Path B's (C 16, T 2^20), one channel of it
and a short stream (C 16, T 4096), in turns (other, this, this, other) with
``chip_smoke.cuda_ms``, each row with its bound and the share of it reached.
``fir_banded`` also runs at fm_monitor's channel filter (K 963, ÷40, T
52,428,800), the RDS channel filter's shape and the RTL receiver's ÷50 audio
FIR. It checks ``fir_banded`` against the plain version and bitwise against
the other's wherever both run it with the same phase groups (the
``groups`` out-parameter of ``gr4_fir_banded``);
``fir_demod`` bitwise against the other's at decim 1 (one plane: the taps
summed in the same order as the direct-form loop it replaced) and, at
every shape, against ``fir_demod_ref`` within ``DEMOD_ATOL``·gain with the
differences wrapped into (−π, π]; ``iir_sos`` (whose chunked scan rounds
differently from the parent's serial loop) against scipy's float64
``sosfilt``. ``one_pole`` has no counterpart in OTHER: it runs at
fm_monitor's and fm_allband's de-emphasis shapes against this tree's torch
path (``one_pole_rows``). It prints one JSON line per shape and exits
non-zero if any check fails. OTHER's ``gr4_iir_sos`` may have either C interface: the serial
kernel's or the chunked scan's.

The second form imports ``chip_smoke`` and the package from ROOT (default: this
tree) and prints, for one step of the headline chain (2^23, rotation
absorbed), Path A (2^22) and Path B (2^20), the device milliseconds from
``torch.profiler`` with the kernels that took the most, the milliseconds per
step by CUDA events and the device-busy share (the first over the second).
Run it in both trees in turns (other, this, this, other) to compare.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path


def steps(root: Path) -> None:
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck
    ck.build()
    for label, build, bl, fs in (
            ("chain absorbed 2^23", lambda: cs.build_chain("null")[0], cs.BLOCK_LEN, cs.FS),
            ("Path A 2^22", lambda: cs.build_wbfm("null")[0], cs.WBFM_BLOCK_LEN,
             cs.QUAD_RATE),
            ("Path B 2^20", lambda: cs.build_iir_path(5, "null")[0], cs.IIR_BLOCK_LEN,
             cs.IIR_FS)):
        sched = gt.Scheduler(build(), block_len=bl, sample_rate=fs, device="cuda")
        for _ in range(3):
            sched.step_once()
        torch.cuda.synchronize()
        dev_ms = []
        for _ in range(3):
            ms, top = cs.profile_device(sched.step_once)
            dev_ms.append(ms)
        step_ms, windows = cs.events_ms_per_step(sched.step_once, 10)
        print(json.dumps({"root": str(root), "path": label,
                          "device_ms_per_step": statistics.median(dev_ms),
                          "runs": dev_ms, "events_ms_per_step": step_ms,
                          "device_busy": statistics.median(dev_ms) / step_ms,
                          "windows": [[round(a, 4), round(b, 4)] for a, b in windows],
                          "top": [[round(t, 4), k[:60]] for t, k in top[:4]]}))


def registers(log: str) -> dict[str, int]:
    """Registers per kernel from an ``nvcc -Xptxas -v`` log (mangled names)."""
    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
            entry = None
    return regs


def build_other(other: Path, ck) -> tuple[ctypes.CDLL, str]:
    """OTHER's csrc/*.cu compiled with this tree's flags, one nvcc per source:
    the library and the compilers' output."""
    out = other / "gnuradio4_tpu_torch" / "_build"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = ck._nvcc()
    srcs = sorted((other / "gnuradio4_tpu_torch" / "csrc").glob("*.cu"))
    objs = [out / f"ab_{s.stem}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *ck.NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs = ""
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {other}:\n{log}")
        logs += log
    so = out / "libab_other.so"
    r = subprocess.run([nvcc, *ck.NVCC_FLAGS[:2], "-shared", "-o", str(so),
                        *map(str, objs)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"linking failed for {other}:\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.gr4_fir_banded.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.gr4_fir_demod.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    if hasattr(lib, "gr4_iir_sos_chunk"):
        ck.set_iir_sos_argtypes(lib)
    else:                                   # the serial kernel's interface
        lib.gr4_iir_sos.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    return lib, logs


def kernels(other: Path) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np
    import torch
    import chip_smoke as cs
    from gnuradio4_tpu_torch.ops import cuda_kernels as ck
    from gnuradio4_tpu_torch.ops import filter_design as fd
    from gnuradio4_tpu_torch.ops.fir import freq_xlating_taps
    from gnuradio4_tpu_torch.ops.cuda_kernels import device_constant, sos_carry_table
    from gnuradio4_tpu_torch.ops.iir import sos_coefficients

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0]
    built = ck.build()
    this, (that, that_log) = built.lib, build_other(other, ck)
    for name, log in (("this", built.log), ("other", that_log)):
        print(json.dumps({"registers": name, "kernels": registers(log), "card": card}))
    stream = lambda: torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    bad = 0

    def in_turns(run_that, run_this) -> tuple[float, float]:
        t = [cs.cuda_ms(run_that), cs.cuda_ms(run_this), cs.cuda_ms(run_this),
             cs.cuda_ms(run_that)]
        return statistics.median(t[1:3]), statistics.median((t[0], t[3]))

    fs = cs.FS
    xl = freq_xlating_taps(fd.design_fir("lowpass", 127, sample_rate=fs, f_low=2e6), 3e6, fs)
    lp127 = fd.design_fir("lowpass", 127, sample_rate=fs, f_low=2e6).astype(np.float32)
    lp63 = fd.design_fir("lowpass", 63, sample_rate=fs, f_low=1e6).astype(np.float32)
    audio = fd.design_fir("lowpass", 127, sample_rate=cs.QUAD_RATE, f_low=15e3
                          ).astype(np.float32)
    # fm_monitor's channel filter (20 MS/s, 100 kHz, +3.1 MHz, ÷40), the RDS
    # channel filter's shape and the RTL receiver's ÷50 audio FIR
    fm = freq_xlating_taps(fd.design_fir("lowpass", 963, sample_rate=20e6, f_low=100e3),
                           3.1e6, 20e6)
    rds = fd.design_fir("lowpass", 241, sample_rate=1.2e6, f_low=2.4e3).astype(np.float32)
    rtl = fd.design_fir("lowpass", 127, sample_rate=1.2e6, f_low=12e3).astype(np.float32)
    for label, n, dt, taps, decim in (
            ("c64 x c64 taps K=127 decim 1 T=2^23", cs.BLOCK_LEN, torch.complex64, xl, 1),
            ("c64 x f32 taps K=127 decim 1 T=2^23", cs.BLOCK_LEN, torch.complex64, lp127, 1),
            ("c64 x f32 taps K=127 decim 1 T=2^22", cs.SUITE_BLOCK_LEN, torch.complex64, lp127, 1),
            ("f32 x f32 taps K=63 decim 8 T=2^23", cs.BLOCK_LEN, torch.float32, lp63, 8),
            ("f32 x f32 taps K=127 decim 5 T=4194305", cs.WBFM_IN_LEN, torch.float32, audio, 5),
            ("c64 x c64 taps K=963 decim 40 T=52428800 (fm_monitor)", 52428800,
             torch.complex64, fm, 40),
            ("c64 x f32 taps K=241 decim 24 T=65568 (RDS)", 65568, torch.complex64, rds, 24),
            ("f32 x f32 taps K=127 decim 50 T=262150 (RTL audio)", 262150, torch.float32,
             rtl, 50)):
        k = len(taps)
        x = torch.randn(n, dtype=dt, device=dev, generator=gen)
        hist = torch.randn(k - 1, dtype=dt, device=dev, generator=gen)
        h = torch.from_numpy(np.ascontiguousarray(taps)).to(dev)
        ref = ck.fir_banded_ref(x, hist, h, decim)
        ys = {name: torch.empty_like(ref) for name in ("this", "that")}
        groups = {}

        def call(lib, name):
            g = ctypes.c_int(0)
            assert lib.gr4_fir_banded(x.data_ptr(), hist.data_ptr(), h.data_ptr(),
                                      ys[name].data_ptr(), 1, n, k, decim,
                                      int(x.is_complex()), int(h.is_complex()),
                                      stream(), ctypes.byref(g)) == 0
            groups[name] = g.value
        call(this, "this")
        call(that, "that")
        torch.cuda.synchronize()
        err = {name: float((y - ref).abs().max()) for name, y in ys.items()}
        same = torch.equal(ys["this"], ys["that"])
        ms, other_ms = in_turns(lambda: call(that, "that"), lambda: call(this, "this"))
        b_ms, b_by = cs.bound_ms(*cs.fir_work((n,), x.is_complex(), h.is_complex(), k, decim))
        # a shape both trees run on the same loop is bitwise equal; one whose
        # phase groups differ sums in another order: the plain version's bound
        bad += max(err.values()) > cs.FIR_ATOL or (
            groups["this"] == groups["that"] and not same)
        print(json.dumps({"kernel": "fir_banded", "case": label, "ms": ms,
                          "other_ms": other_ms, "bound_ms": b_ms, "bound_by": b_by,
                          "share_of_bound": b_ms / ms, "other_share": b_ms / other_ms,
                          "max_abs_err": err["this"], "other_max_abs_err": err["that"],
                          "bitwise_equal": same, "phase_groups": groups["this"],
                          "other_phase_groups": groups["that"], "card": card}))
        del x, hist, ref, ys

    chan = fd.design_fir("lowpass", 127, sample_rate=cs.QUAD_RATE, f_low=80e3
                         ).astype(np.float32)
    gain = cs.WBFM_GAIN
    tol_d = cs.DEMOD_ATOL * gain

    def wrapped(a, b) -> float:
        d = (a - b) / gain
        return float(torch.remainder(d + math.pi, 2 * math.pi).sub(math.pi).abs().max()) * gain

    for label, taps, decim, n in (
            ("c64 x f32 taps K=127 decim 1 T=2^22 (Path A)", chan, 1, cs.WBFM_BLOCK_LEN),
            ("c64 x c64 taps K=127 decim 1 T=2^23",
             freq_xlating_taps(chan, 60e3, cs.QUAD_RATE), 1, 1 << 23),
            ("c64 x f32 taps K=127 decim 4 T=2^22", chan, 4, 1 << 22)):
        k = len(taps)
        xc = torch.polar(torch.ones(n + k - 1, device=dev),
                         torch.randn(n + k - 1, device=dev, generator=gen).cumsum(0) * 0.1)
        prev = torch.ones((), dtype=torch.complex64, device=dev)
        h = torch.from_numpy(np.ascontiguousarray(taps)).to(dev)
        ys = {name: torch.empty(n // decim, device=dev) for name in ("this", "that")}

        def call(lib, name):
            assert lib.gr4_fir_demod(xc.data_ptr(), h.data_ptr(), prev.data_ptr(),
                                     ys[name].data_ptr(), 1, n, k, decim,
                                     int(h.is_complex()), float(gain), stream()) == 0
        call(this, "this")
        call(that, "that")
        ref = ck.fir_demod_ref(xc, h, decim, prev, gain)
        torch.cuda.synchronize()
        same = torch.equal(ys["this"], ys["that"])
        err = {name: wrapped(y, ref) for name, y in ys.items()}
        ms, other_ms = in_turns(lambda: call(that, "that"), lambda: call(this, "this"))
        b_ms, b_by = cs.bound_ms(*cs.demod_work((n,), h.is_complex(), k, decim))
        # decim 1: one plane, the taps in the direct form's order
        bad += (decim == 1 and not same) or max(err.values()) > tol_d
        print(json.dumps({"kernel": "fir_demod", "case": label, "ms": ms,
                          "other_ms": other_ms, "bound_ms": b_ms, "bound_by": b_by,
                          "share_of_bound": b_ms / ms, "other_share": b_ms / other_ms,
                          "bitwise_equal": same, "wrapped_err": err["this"],
                          "other_wrapped_err": err["that"], "tol": tol_d, "card": card}))
        del xc, ys, ref

    from scipy import signal
    sos = cs.iir_design(5).sos
    co = sos_coefficients(sos)
    for label, c, n in (("C=16 T=2^20 S=3 (Path B)", cs.IIR_CHANNELS, cs.IIR_BLOCK_LEN),
                        ("C=1 T=2^20 S=3", 1, cs.IIR_BLOCK_LEN),
                        ("C=16 T=4096 S=3", cs.IIR_CHANNELS, cs.IIR_CPU_BLOCK_LEN)):
        x = torch.randn(c, n, device=dev, generator=gen)
        s0 = torch.zeros(c, 3, 2, device=dev)
        ys = {name: (torch.empty_like(x), torch.empty_like(s0)) for name in ("this", "that")}
        bufs = {lib: (device_constant(sos_carry_table(co), dev),
                      torch.empty(lib.gr4_iir_sos_work_size(c, n, 3), device=dev))
                for lib in (this, that) if hasattr(lib, "gr4_iir_sos_chunk")}

        def call(lib, name):
            y, st = ys[name]
            args = (x.data_ptr(), y.data_ptr(), s0.data_ptr(), st.data_ptr(), co.ctypes.data)
            if lib in bufs:
                args += (bufs[lib][0].data_ptr(), bufs[lib][1].data_ptr())
            assert lib.gr4_iir_sos(*args, c, n, 3, stream()) == 0
        call(this, "this")
        call(that, "that")
        torch.cuda.synchronize()
        want = signal.sosfilt(sos, x.cpu().numpy().astype(np.float64), axis=-1)
        err = {name: cs.rms_err(y.cpu().numpy().astype(np.float64), want)
               for name, (y, _) in ys.items()}
        ms, other_ms = in_turns(lambda: call(that, "that"), lambda: call(this, "this"))
        b_ms, b_by = cs.iir_bound_ms(c, n, 3)
        bad += max(err.values()) > cs.SCIPY_RTOL
        print(json.dumps({"kernel": "iir_sos", "case": label, "ms": ms,
                          "other_ms": other_ms, "bound_ms": b_ms, "bound_by": b_by,
                          "share_of_bound": b_ms / ms, "other_share": b_ms / other_ms,
                          "float64_rms_err": err["this"],
                          "other_float64_rms_err": err["that"], "card": card}))
    bad += one_pole_rows(cs, ck, card)
    return 1 if bad else 0


def one_pole_rows(cs, ck, card: str) -> int:
    """``one_pole`` with FmDeemphasis's coefficients (75 µs at 50 kHz, the
    K/A epilogue) at fm_monitor's [131072] and fm_allband's [100, 131072],
    against this tree's torch path on the card (ops/iir.py
    ``_one_pole_blocked`` and the epilogue, the parent's route), in turns;
    both against a float64 loop. Returns the number of failed checks."""
    import numpy as np
    import torch
    from scipy import signal
    from portbench.yardstick import bound_ms
    from gnuradio4_tpu_torch.ops import iir
    from gnuradio4_tpu_torch.ops.demod import fm_deemphasis_coeffs
    dev = torch.device("cuda")
    b, a = fm_deemphasis_coeffs(50e3, 75e-6)
    p, k, amp = -a[1] / a[0], b[1] / a[1], b[0] / a[0] - b[1] / a[1]
    kf, af = iir._f32(k), iir._f32(amp)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    bad = 0
    for label, shape in (("f32 [131072] (fm_monitor)", (131072,)),
                         ("f32 [100, 131072] (fm_allband)", (100, 131072))):
        x = torch.randn(shape, device=dev, generator=gen)
        u0 = torch.randn(shape[:-1], device=dev, generator=gen)
        kernel = lambda: ck.one_pole(x, p, u0, kf, af)

        def torch_path():
            u, last = iir._one_pole_blocked(x, complex(p), u0)
            return kf * x + af * u, last
        y, _ = kernel()
        y_t, _ = torch_path()
        pf = float(np.float32(p))
        zi = (pf * u0.cpu().numpy().astype(np.float64))[..., None]
        x64 = x.cpu().numpy().astype(np.float64)
        u64, _ = signal.lfilter([1.0], [1.0, -pf], x64, axis=-1, zi=zi)
        want = k * x64 + amp * u64
        scale = float(np.abs(want).max())
        err = float(np.abs(y.cpu().numpy() - want).max()) / scale
        err_t = float(np.abs(y_t.cpu().numpy() - want).max()) / scale
        t = [cs.cuda_ms(torch_path), cs.cuda_ms(kernel), cs.cuda_ms(kernel),
             cs.cuda_ms(torch_path)]
        ms, torch_ms = statistics.median(t[1:3]), statistics.median((t[0], t[3]))
        n = x.numel()
        b_ms, b_by = bound_ms(5.0 * n, 8.0 * n + 8.0 * u0.numel())
        bad += err > 1e-5
        print(json.dumps({"kernel": "one_pole", "case": label, "ms": ms,
                          "torch_path_ms": torch_ms, "bound_ms": b_ms, "bound_by": b_by,
                          "share_of_bound": b_ms / ms, "torch_path_share": b_ms / torch_ms,
                          "float64_err": err, "torch_path_float64_err": err_t,
                          "card": card}))
    return bad


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--steps"]:
        steps(Path(args[1] if len(args) > 1 else Path(__file__).resolve().parent).resolve())
        sys.exit(0)
    if len(args) != 1:
        sys.exit(__doc__)
    sys.exit(kernels(Path(args[0]).resolve()))
