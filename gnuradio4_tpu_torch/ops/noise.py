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
- ``uniform`` puts 23 random mantissa bits under the exponent of 1.0 and
  scales ``[0, 1)`` onto ``[minval, maxval)``; ``normal`` is
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


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval=0.0,
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
    u = uniform(key, shape, _NORMAL_LO, 1.0)
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


def uniform_noise(key: torch.Tensor, shape: tuple[int, ...], *, low=-1.0,
                  high=1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``noise.uniform`` (a split, then a uniform draw on
    ``[low, high)``); named apart from the plain :func:`uniform` draw."""
    keys = split(key)
    return uniform(keys[1], shape, low, high), keys[0]


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
    u = uniform(keys[1], (2, *shape))
    return ((u[0] + u[1] - 1.0) * float(np.float32(half_range))
            + float(np.float32(mean))), keys[0]
