"""Filter taps the benchmark designs itself, in NumPy, and hands to both the
program (as block settings) and the plain reference.

Windowed-sinc low-pass prototypes, rounded to float32 once: the program and
the reference read the same float32 values.
"""

from __future__ import annotations

import numpy as np

# the stop-band attenuation, in dB, that GNU Radio's fft::window assigns a
# window when firdes sizes a filter from its transition width
WINDOW_ATTENUATION_DB = {"hamming": 53.0}


def lowpass(ntaps: int, cutoff_hz: float, sample_rate: float,
            window: str = "hamming") -> np.ndarray:
    """``ntaps`` taps of a low-pass at ``cutoff_hz``: the ideal response
    ``2·fc·sinc(2·fc·n)`` around the centre, times the (Hamming) window,
    scaled to sum 1, as float32."""
    if window.lower() != "hamming":
        raise ValueError(f"unknown window {window!r}")
    fc = cutoff_hz / sample_rate
    n = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    h = 2.0 * fc * np.sinc(2.0 * fc * n) * np.hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


def firdes_ntaps(sample_rate: float, transition_hz: float,
                 window: str = "hamming") -> int:
    """The tap count GNU Radio's ``firdes::compute_ntaps`` gives: the
    window's attenuation · fs / (22 · transition), truncated, made odd."""
    a = WINDOW_ATTENUATION_DB[window.lower()]
    n = int(a * sample_rate / (22.0 * transition_hz))
    return n if n & 1 else n + 1


def firdes_lowpass(gain: float, sample_rate: float, cutoff_hz: float,
                   transition_hz: float, window: str = "hamming") -> np.ndarray:
    """GNU Radio's ``firdes.low_pass(gain, fs, cutoff, transition, window)``:
    ``firdes_ntaps`` taps of ``sin(n·ω0)/(n·π)`` times the window, scaled to
    ``gain`` at DC, as float32."""
    ntaps = firdes_ntaps(sample_rate, transition_hz, window)
    return lowpass(ntaps, cutoff_hz, sample_rate, window) * np.float32(gain)
