"""CW (Morse code) model family — on-off-keyed tone telegraphy.

PARIS timing: dot = 1 unit, dash = 3, intra-character gap = 1, letter gap =
3, word gap = 7; a unit is ``1.2 / wpm`` seconds. Keying edges are raised-
cosine shaped (~5 ms) to bound the occupied bandwidth, as real keyers do.

Device/host split (the family pattern, blocks/rtty.py): synthesis is a
vectorized keying envelope times a tone; the receiver is the
:class:`CwDecoder` sink — magnitude envelope, adaptive threshold, run-length
classification with the unit time estimated from the mark-length histogram
(so the decoder locks to any WPM without being told), gap framing to
letters/words.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting

MORSE = {
    "A": ".-", "B": "-...", "C": "-.-.", "D": "-..", "E": ".", "F": "..-.",
    "G": "--.", "H": "....", "I": "..", "J": ".---", "K": "-.-", "L": ".-..",
    "M": "--", "N": "-.", "O": "---", "P": ".--.", "Q": "--.-", "R": ".-.",
    "S": "...", "T": "-", "U": "..-", "V": "...-", "W": ".--", "X": "-..-",
    "Y": "-.--", "Z": "--..",
    "0": "-----", "1": ".----", "2": "..---", "3": "...--", "4": "....-",
    "5": ".....", "6": "-....", "7": "--...", "8": "---..", "9": "----.",
    ".": ".-.-.-", ",": "--..--", "?": "..--..", "/": "-..-.", "=": "-...-",
    "+": ".-.-.", "-": "-....-", "@": ".--.-.",
}
_INV = {v: k for k, v in MORSE.items()}


def morse_encode(text: str) -> str:
    """Text → dot/dash string with ' ' letter gaps and ' / ' word gaps."""
    words = []
    for w in text.upper().split():
        words.append(" ".join(MORSE[c] for c in w if c in MORSE))
    return " / ".join(words)


def keying_envelope(text: str, fs: float, wpm: float = 20.0,
                    edge_s: float = 0.005) -> np.ndarray:
    """On/off keying envelope (0..1) with raised-cosine edges."""
    unit = 1.2 / wpm
    un = int(round(unit * fs))
    marks: list[tuple[int, int]] = []          # (start, length) in samples
    pos = un * 2                               # brief lead-in silence
    for sym in morse_encode(text):
        if sym == ".":
            marks.append((pos, un))
            pos += 2 * un                      # element + intra gap
        elif sym == "-":
            marks.append((pos, 3 * un))
            pos += 4 * un
        elif sym == " ":
            pos += 2 * un                      # 1 (already) + 2 = letter gap 3
        elif sym == "/":
            pos += 2 * un                      # with both ' ' → word gap 7
    env = np.zeros(pos + 2 * un)
    for s, ln in marks:
        env[s:s + ln] = 1.0
    en = max(2, int(round(edge_s * fs)))
    ramp = 0.5 * (1.0 - np.cos(np.pi * np.arange(en) / en))
    kernel = np.concatenate([ramp, [1.0], ramp[::-1]])
    kernel /= kernel.sum()
    return np.convolve(env, kernel, mode="same")


def cw_modulate(text: str, *, fs: float = 48000.0, wpm: float = 20.0,
                freq: float = 600.0, amplitude: float = 0.8) -> np.ndarray:
    env = keying_envelope(text, fs, wpm)
    t = np.arange(len(env))
    return (amplitude * env * np.sin(2 * np.pi * freq / fs * t)
            ).astype(np.float32)


def decode_envelope(env: np.ndarray, fs: float) -> str:
    """Run-length Morse decode with self-estimated unit time."""
    if not len(env) or env.max() <= 0:
        return ""
    on = env > 0.5 * float(np.median(env[env > 0.1 * env.max()])) \
        if (env > 0.1 * env.max()).any() else env > 0.5 * env.max()
    edges = np.flatnonzero(np.diff(on.astype(np.int8)))
    if on[0]:
        edges = np.concatenate([[0], edges + 1])
    else:
        edges = edges + 1
    bounds = np.concatenate([edges, [len(on)]])
    runs = []                                   # (is_mark, length)
    prev = bounds[0]
    state = bool(on[prev]) if prev < len(on) else False
    for b in bounds[1:]:
        runs.append((state, int(b - prev)))
        prev = b
        state = not state
    marks = np.array([ln for m, ln in runs if m], float)
    if not len(marks):
        return ""
    # glitch filter: noise chops runs into fragments far shorter than any
    # element — absorb them into the preceding run, then fuse same-state
    # neighbours and re-measure
    glitch = 0.25 * float(np.median(marks))
    merged: list[list] = []
    for m, ln in runs:
        if merged and (ln < glitch or merged[-1][0] == m):
            merged[-1][1] += ln
        else:
            merged.append([m, ln])
    runs = [(bool(m), int(ln)) for m, ln in merged]
    marks = np.array([ln for m, ln in runs if m], float)
    # unit estimate: dots cluster at 1u, dashes at 3u — the mark histogram
    # is bimodal, so the mean of the lower cluster is the unit
    thr = (marks.min() + marks.max()) / 2.0
    lo = marks[marks <= thr]
    unit = float(np.mean(lo)) if len(lo) else float(np.mean(marks))
    out: list[str] = []
    sym = ""
    for is_mark, ln in runs:
        u = ln / unit
        if is_mark:
            sym += "." if u < 2.0 else "-"
        else:
            if u >= 5.0:                        # word gap (7u)
                if sym:
                    out.append(_INV.get(sym, "�"))
                    sym = ""
                out.append(" ")
            elif u >= 2.0:                      # letter gap (3u)
                if sym:
                    out.append(_INV.get(sym, "�"))
                    sym = ""
    if sym:
        out.append(_INV.get(sym, "�"))
    return "".join(out).strip()


@register_block("CwSource")
class CwSource(SourceBlock):
    """Keys a text message as a CW tone (test stimulus / TX)."""

    OUT = (Port("out", dtype="float32"),)
    FEED = True
    sample_rate = Setting(default=48000.0, kind="static")
    wpm = Setting(default=20.0, kind="static")
    frequency = Setting(default=600.0, kind="static")

    def __init__(self, text: str = "", name=None, **settings):
        super().__init__(name=name, **settings)
        self._wave = cw_modulate(
            text, fs=float(self.settings.get("sample_rate")),
            wpm=float(self.settings.get("wpm")),
            freq=float(self.settings.get("frequency")))

    def host_feed(self, n, abs_index):
        if abs_index >= len(self._wave):
            return None
        chunk = self._wave[abs_index:abs_index + n]
        return {"out": chunk}, len(chunk)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("CwDecoder")
class CwDecoder(SinkBlock):
    """CW receiver sink for an audio (or magnitude) stream: rectified +
    ~5 ms-smoothed envelope, run-length classification with self-estimated
    unit time (any WPM), letter/word gap framing. ``text`` holds the rolling
    decode."""

    IN = (Port("in", dtype="float32"),)
    sample_rate = Setting(default=48000.0, kind="static")
    max_buffer_s = Setting(default=60.0, kind="static",
                           description="history bound for a continuous "
                                       "stream: once exceeded, decoded text "
                                       "is archived and the buffer flushes "
                                       "at the next key-up silence")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.float32)
        self._pending = 0
        self._done = ""
        self.text = ""

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        x = np.asarray(arrays["in"][..., :n_valid], np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, x])
        self._pending += n_valid
        fs = float(self.settings.get("sample_rate"))
        if self._pending >= int(fs):
            self._pending = 0
            self._decode()

    def stop(self):
        self._decode()

    def _decode(self) -> None:
        fs = float(self.settings.get("sample_rate"))
        if len(self._buf) < 0.2 * fs:
            return
        k = max(1, int(round(0.005 * fs)))
        env = np.convolve(np.abs(self._buf), np.full(k, 1.0 / k),
                          mode="same")
        txt = decode_envelope(env, fs)
        cap = int(float(self.settings.get("max_buffer_s")) * fs)
        if len(self._buf) > cap:
            # flush at key-up (last 0.5 s quiet) so no element straddles the
            # cut; past 2×cap flush unconditionally (≤1 letter at risk)
            tail = env[-int(0.5 * fs):]
            quiet = (not len(tail)
                     or float(tail.max()) < 0.1 * float(env.max()))
            if quiet or len(self._buf) > 2 * cap:
                self._done += txt + " "
                txt = ""
                self._buf = np.zeros(0, np.float32)
        self.text = (self._done + txt).strip()
