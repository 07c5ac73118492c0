"""Carry block states and params between the JAX package and this one.

In this system the "weights" are block settings (taps, frequencies): both
packages build the same graph from the same settings and registry names. What a
running graph adds is its carried state (FIR history, NCO phases, the demod's
last sample). These helpers take the JAX package's states or gathered params as
NumPy (``np.asarray`` of each leaf) and return the port's, so a stream started
in one package can continue in the other; :func:`states_to_numpy` gives this
package's states back in the JAX package's dtypes.

The two packages number their blocks independently, so the block keys differ;
``names`` maps the JAX package's ``unique_name`` keys onto this package's
(default: keep the keys).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _state_leaf(v: Any, device: torch.device | str):
    if v is None:
        return None
    if isinstance(v, Mapping):
        return {k: _state_leaf(x, device) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        # tuple states (CvsdEncoder/CvsdDecoder's (est, delta, run))
        return type(v)(_state_leaf(x, device) for x in v)
    a = np.asarray(v)
    if a.dtype == np.uint32:
        if a.ndim == 0:
            # NCO phases and step counters: int64 host scalars holding the
            # uint32 value
            return torch.from_numpy(a.astype(np.int64))
        # PRNG keys (``jax.random.key_data``): int64 words on the device
        return torch.from_numpy(a.astype(np.int64)).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def states_from_numpy(tree: Mapping[str, Any], device: torch.device | str,
                      names: Mapping[str, str] | None = None) -> dict[str, Any]:
    """JAX block states (``CompiledGraph.init_states()`` or the states after a
    step, leaves as NumPy; a PRNG key leaf as its ``jax.random.key_data``) →
    this package's states on ``device``. 0-d uint32 leaves (NCO phases and
    counters: SignalGenerator, FreqXlatingFir and IQDemodulator's ``phase``,
    Rotator's state) become int64 host scalars; uint32 arrays (the noise key)
    int64 device tensors; float32 and complex64 histories (FIR, PFB rows,
    RationalResampler's polyphase history, SyncBlock's per-port histories,
    the uncertain FIR's two planes) keep their dtype, as do the bool and int32
    leaves (SchmittTrigger's and StreamFilter's state, TriggerGate's carry),
    which the blocks read as host numbers wherever they lie. Tuples stay
    tuples: CVSD's ``(est, delta, run)`` arrive as float32, float32 and int32
    0-d tensors on ``device``."""
    names = names or {}
    return {names.get(k, k): _state_leaf(v, device) for k, v in tree.items()}


def _numpy_leaf(v: Any):
    if v is None:
        return None
    if isinstance(v, Mapping):
        return {k: _numpy_leaf(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_numpy_leaf(x) for x in v)
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    # int64 leaves hold the JAX package's uint32 words (phases, counters,
    # threefry keys), as checkpoints write them
    return a.astype(np.uint32) if a.dtype == np.int64 else a


def states_to_numpy(tree: Mapping[str, Any],
                    names: Mapping[str, str] | None = None) -> dict[str, Any]:
    """This package's block states → NumPy leaves in the JAX package's dtypes
    (the inverse of :func:`states_from_numpy`): int64 leaves become uint32,
    every other leaf keeps its dtype, tuples stay tuples. A threefry key
    comes back as its uint32 words (``jax.random.wrap_key_data`` makes the
    JAX package's key of them). ``names`` maps this package's keys onto the
    JAX package's."""
    names = names or {}
    return {names.get(k, k): _numpy_leaf(v) for k, v in tree.items()}


def params_from_numpy(tree: Mapping[str, Mapping[str, Any]],
                      names: Mapping[str, str] | None = None
                      ) -> dict[str, dict[str, np.ndarray]]:
    """JAX gathered params (leaves as NumPy) → this package's params. Params are
    host values in both packages; ``_dphi`` and ``_phase0_u32`` stay numpy
    uint32."""
    names = names or {}
    return {names.get(k, k): {p: np.array(v, copy=True) for p, v in d.items()}
            for k, d in tree.items()}
