"""The benchmark's frozen yardstick: the card's peaks, the least time of a
piece of work, and the work of the FIR forms.

``PEAK_*``, :func:`bound_ms` and :func:`fir_work` are copies of the
functions of the same names in the repository's ``chip_smoke.py``, taken so
that a later change there cannot move the benchmark. Each configuration's
least-work function (``configs/<config>.py`` ``least_work``) counts in the
units these take.
"""

from __future__ import annotations

# one H100 SXM at its 700 W limit (NVIDIA's data sheet): float32 outside the
# tensor cores, and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for this work: the larger of the
    operations over the FP32 peak and the bytes over the HBM rate, and which
    of the two it is."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
