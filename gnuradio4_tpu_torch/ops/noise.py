"""Noise generation on the device: threefry2x32, bit for bit with the JAX
package's ``jax.random`` (threefry2x32, partitionable layout).

The JAX package draws noise from ``jax.random`` (``ops/noise.py:16-39,
121-128`` there); this module reproduces that stream so a noise-fed graph can
be held against the JAX package sample by sample. torch has no wrapping uint32
arithmetic on the CPU, so every uint32 word is carried in int64 and masked
with ``& 0xFFFFFFFF`` (as ``ops/signal.py`` does for NCO phases).

- a key is a ``[2]`` int64 tensor (the two uint32 words of a JAX key's
  ``key_data``), kept on the graph's device;
- ``split`` and ``random_bits`` hash the iota of the requested shape (its
  flat index, as hi/lo uint32 words) with the key, as jax 0.9's partitionable
  threefry does; 32-bit draws are ``bits1 ^ bits2``;
- the plain uniform draw (``_uniform``) puts 23 random mantissa bits under
  the exponent of 1.0 and scales ``[0, 1)`` onto ``[minval, maxval)``
  (``uniform`` is the JAX package's ``noise.uniform``: a split, then that
  draw on ``[low, high)``); ``normal`` is
  ``√2·erfinv(u)`` with u uniform on ``(nextafter(−1, 0), 1)``.

The bits are exact. The floats go through float32 multiplies and adds in the
same order as there, and through torch's ``erfinv`` where XLA uses its own
float32 polynomial: normal draws may differ from the JAX package's by a few
ulp. The hash is ~160 full-size int64 passes of torch ops per draw; a
hand-written kernel is a later performance item.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
# float32 nextafter(-1, 0): normal's lower bound keeps erfinv finite
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011; jax's
    ``_threefry2x32_lowering``). Words are int64 tensors in ``[0, 2³²)``;
    ``k1``/``k2`` broadcast against ``x1``/``x2``. Returns two new tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1.add_(x2).bitwise_and_(MASK32)
            rot = x2 << r
            x2.bitwise_right_shift_(32 - r).bitwise_or_(rot)
            x2.bitwise_and_(MASK32).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x2.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK32)
    return x1, x2


def _hash_iota(key: torch.Tensor, shape: tuple[int, ...]
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry of the flat index of every element of ``shape``: counts hi
    (0 below 2³² elements) and lo words, as jax's ``iota_2x32_shape``."""
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 1 << 32:
        raise ValueError(f"random draw of {n} elements exceeds 2^32")
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    hi = torch.zeros_like(lo)
    return threefry2x32(key[0], key[1], hi, lo)


def key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """The key of ``jax.random.key(np.uint32(seed))``: words ``[0, seed]``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[num, 2]`` int64 keys on key's device."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits`` at uint32), as int64."""
    b1, b2 = _hash_iota(key, shape)
    return b1.bitwise_xor_(b2)


def _uniform(key: torch.Tensor, shape: tuple[int, ...], minval=0.0,
             maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    # 23 mantissa bits under the exponent of 1.0: a float in [1, 2)
    f = (bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
         .to(torch.int32).view(torch.float32)) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(f * span + lo, lo)


def normal(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    u = _uniform(key, shape, _NORMAL_LO, 1.0)
    return torch.erfinv(u).mul_(_SQRT2_F32)


# -- the JAX package's ops/noise.py surface ------------------------------------

def noise_init_state(seed: int, device: torch.device | str = "cpu"
                     ) -> torch.Tensor:
    return key(seed, device)


def gaussian(key: torch.Tensor, shape: tuple[int, ...], *, std=1.0, mean=0.0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    keys = split(key)
    x = normal(keys[1], shape) * float(np.float32(std)) + float(np.float32(mean))
    return x, keys[0]


def uniform(key: torch.Tensor, shape: tuple[int, ...], *, low=-1.0,
            high=1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """A split, then a uniform draw on ``[low, high)``."""
    keys = split(key)
    return _uniform(keys[1], shape, low, high), keys[0]


def complex_gaussian(key: torch.Tensor, shape: tuple[int, ...], *, std=1.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Circularly-symmetric complex Gaussian with total power std² (std/√2 per
    rail): one normal draw of ``(2, *shape)``, rails re and im."""
    keys = split(key)
    scale = float(np.float32(std) / np.float32(np.sqrt(2.0)))
    ri = normal(keys[1], (2, *shape)).mul_(scale)
    return torch.complex(ri[0], ri[1]), keys[0]


def triangular(key: torch.Tensor, shape: tuple[int, ...], *, half_range=1.0,
               mean=0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Irwin-Hall(2) triangular noise on [mean−half_range, mean+half_range)."""
    keys = split(key)
    u = _uniform(keys[1], (2, *shape))
    return ((u[0] + u[1] - 1.0) * float(np.float32(half_range))
            + float(np.float32(mean))), keys[0]


# -- host-side Xoshiro256++ (≈ reference algorithm/rng/Xoshiro256pp.hpp) -------
#
# The device-side noise above is threefry (the JAX package's jax.random
# stream). This host engine, copied from the JAX package's ops/noise.py, exists
# for bit-exact stimulus parity with the reference: xoshiro256++ is the public Blackman/Vigna algorithm
# (prng.di.unimi.it), seeded via SplitMix64 exactly like the reference, so a
# test vector generated there reproduces here to the bit.

_U64 = np.uint64


def _splitmix64(state: int) -> tuple[int, int]:
    state = (state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return state, z ^ (z >> 31)


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & 0xFFFFFFFFFFFFFFFF


class Xoshiro256pp:
    """xoshiro256++ PRNG, SplitMix64-seeded (host-side; bit-compatible with the
    reference's gr::rng::Xoshiro256pp — known-answer vectors pinned in tests).

    Draws are python-int uint64; ``uniform01``/``uniformM11`` follow the
    reference's mantissa-shift conversions (>>11 · 2^-53 for float64,
    >>40 · 2^-24 for float32); ``triangularM11`` is the Irwin-Hall(2)
    semi-Gaussian on [-1, 1).
    """

    def __init__(self, seed: int = 0):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        sm = seed & 0xFFFFFFFFFFFFFFFF
        s = []
        for _ in range(4):
            sm, v = _splitmix64(sm)
            s.append(v)
        self._s = s

    def __call__(self) -> int:
        s0, s1, s2, s3 = self._s
        result = (_rotl((s0 + s3) & 0xFFFFFFFFFFFFFFFF, 23) + s0) \
            & 0xFFFFFFFFFFFFFFFF
        t = (s1 << 17) & 0xFFFFFFFFFFFFFFFF
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t
        s3 = _rotl(s3, 45)
        self._s = [s0, s1, s2, s3]
        return result

    def uniform01(self, dtype=np.float64) -> float:
        raw = self()
        if np.dtype(dtype) == np.float32:
            return float((raw >> 40) * 2.0 ** -24)
        return float((raw >> 11) * 2.0 ** -53)

    def uniformM11(self, dtype=np.float64) -> float:
        return 2.0 * self.uniform01(dtype) - 1.0

    def triangularM11(self, dtype=np.float64) -> float:
        return self.uniform01(dtype) + self.uniform01(dtype) - 1.0

    def array(self, n: int, *, kind: str = "uniform01",
              dtype=np.float64) -> np.ndarray:
        fn = {"raw": self.__call__, "uniform01": lambda: self.uniform01(dtype),
              "uniformM11": lambda: self.uniformM11(dtype),
              "triangularM11": lambda: self.triangularM11(dtype)}[kind]
        out = [fn() for _ in range(n)]
        return np.asarray(out, _U64 if kind == "raw" else dtype)


class GaussianNoise:
    """Marsaglia-polar N(0,1) over :class:`Xoshiro256pp` — bit-compatible with
    the reference's gr::rng::GaussianNoise (algorithm/rng/GaussianNoise.hpp):
    rejection pairs cache the spare variate; ``complex_sample`` uses Option B
    (nI, nQ ~ N(0, 1/2), E[|n|²] = 1); ``fill_complex`` draws a fresh polar
    pair per sample (no spare, offset applied to the real rail only)."""

    def __init__(self, rng: Xoshiro256pp):
        self._rng = rng
        self._spare = 0.0
        self._has_spare = False

    def reset(self) -> None:
        self._has_spare = False

    def __call__(self, dtype=np.float64) -> float:
        if self._has_spare:
            self._has_spare = False
            return self._spare
        u, v = self._polar_pair(dtype)
        self._spare = v
        self._has_spare = True
        return u

    def _polar_pair(self, dtype=np.float64) -> tuple[float, float]:
        while True:
            u = self._rng.uniformM11(dtype)
            v = self._rng.uniformM11(dtype)
            s = u * u + v * v
            if 0.0 < s < 1.0:
                break
        factor = float(np.sqrt(-2.0 * np.log(s) / s))
        return u * factor, v * factor

    def complex_sample(self, dtype=np.float64) -> complex:
        scale = 1.0 / float(np.sqrt(2.0))
        return complex(self(dtype) * scale, self(dtype) * scale)

    def fill(self, n: int, *, amplitude=1.0, offset=0.0,
             dtype=np.float64) -> np.ndarray:
        # the reference's bulk fill starts from a cleared spare (local
        # hasSpare=false, GaussianNoise.hpp:60) and writes the end state back
        self._has_spare = False
        return np.asarray([amplitude * self(dtype) + offset for _ in range(n)],
                          dtype)

    def fill_complex(self, n: int, *, amplitude=1.0, offset=0.0,
                     dtype=np.float64) -> np.ndarray:
        scaled = amplitude / float(np.sqrt(2.0))
        out = np.empty(n, np.complex128 if np.dtype(dtype) == np.float64
                       else np.complex64)
        for i in range(n):
            g1, g2 = self._polar_pair(dtype)
            out[i] = complex(scaled * g1 + offset, scaled * g2)
        self._has_spare = False
        return out


class NoiseGenerator:
    """Uniform/Triangular/Gaussian noise stream, output = A·noise + O —
    host-side mirror of the reference's gr::rng::NoiseGenerator
    (algorithm/rng/NoiseGenerator.hpp): same Xoshiro draws, same complex
    conventions (independent rails for uniform/triangular; Gaussian Option B;
    offset on the real rail only). Device streams use the threefry functions
    above instead — this engine exists for bit-exact stimulus parity."""

    TYPES = ("uniform", "triangular", "gaussian")

    def __init__(self, noise_type: str = "uniform", *, amplitude=1.0,
                 offset=0.0, seed: int = 0):
        self.configure(noise_type, amplitude=amplitude, offset=offset,
                       seed=seed)

    def configure(self, noise_type: str, *, amplitude=1.0, offset=0.0,
                  seed: int = 0) -> None:
        if noise_type not in self.TYPES:
            raise ValueError(f"noise_type {noise_type!r} not in {self.TYPES}")
        self.noise_type = noise_type
        self.amplitude = float(amplitude)
        self.offset = float(offset)
        self._rng = Xoshiro256pp(seed)
        self._gauss = GaussianNoise(self._rng)

    def reset(self, seed: int = 0) -> None:
        self._rng.seed(seed)
        self._gauss.reset()

    def _raw(self, dtype=np.float64) -> float:
        if self.noise_type == "uniform":
            return self._rng.uniformM11(dtype)
        if self.noise_type == "triangular":
            return self._rng.triangularM11(dtype)
        return self._gauss(dtype)

    def sample(self, dtype=np.float64) -> float:
        return self.amplitude * self._raw(dtype) + self.offset

    def complex_sample(self, dtype=np.float64) -> complex:
        if self.noise_type == "gaussian":
            raw = self._gauss.complex_sample(dtype)
            return complex(self.amplitude * raw.real + self.offset,
                           self.amplitude * raw.imag)
        return complex(self.amplitude * self._raw(dtype) + self.offset,
                       self.amplitude * self._raw(dtype))

    def fill(self, n: int, dtype=np.float64) -> np.ndarray:
        if self.noise_type == "gaussian":
            return self._gauss.fill(n, amplitude=self.amplitude,
                                    offset=self.offset, dtype=dtype)
        return np.asarray([self.sample(dtype) for _ in range(n)], dtype)

    def fill_complex(self, n: int, dtype=np.float64) -> np.ndarray:
        if self.noise_type == "gaussian":
            return self._gauss.fill_complex(n, amplitude=self.amplitude,
                                            offset=self.offset, dtype=dtype)
        return np.asarray([self.complex_sample(dtype) for _ in range(n)],
                          np.complex128 if np.dtype(dtype) == np.float64
                          else np.complex64)
