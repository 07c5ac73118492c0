"""Checkpoint / resume, in the JAX package's layout.

Reference persistence = settings (`storeDefaults`, SettingsCtx presets) + full
flowgraph YAML round-trip (SURVEY §5 checkpoint/resume); streaming data is not
checkpointed. Both packages add a **state snapshot**: the carried block states
(FIR tails, NCO phases, PRNG keys) are saved and restored, so a streaming run
resumes bit-exactly mid-stream — in either package.

Layout of a checkpoint directory (the JAX package's ``core/checkpoint.py``):
    graph.yaml    flowgraph + settings (+ contexts) — load_grc-compatible
    states.npz    per-block state leaves, keyed ``block.name`` + the leaf's
                  path as JAX spells it (``chan['hist']``; a bare tensor state
                  is keyed by the block name alone)
    meta.json     scheduler counters (step, abs in/out, finished sources, rates)

This package carries uint32 values (NCO phases, the threefry key's words) in
int64 tensors; they are stored as uint32, as the JAX package stores them, and
come back as int64 on the fresh state's device. A checkpoint loads wherever
each block's state tree has the same leaves with the same shapes and dtypes;
any difference raises a :class:`GrError` naming the block and the key.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from .errors import GrError
from .scheduler import Scheduler
from .yaml_io import load_grc, save_grc

_U32 = 1 << 32


def _leaves(state: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in JAX's ``tree_flatten_with_path`` spelling: dict
    keys sorted and written ``['key']``, sequence items ``[i]``; None holds no
    leaf."""
    if state is None:
        return
    if isinstance(state, dict):
        for k in sorted(state):
            yield from _leaves(state[k], f"{path}[{k!r}]")
    elif isinstance(state, (list, tuple)):
        for i, x in enumerate(state):
            yield from _leaves(x, f"{path}[{i}]")
    else:
        yield path, state


def _to_host(key: str, leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        a = leaf.detach().cpu().numpy()
    else:
        a = np.asarray(leaf)
    if a.dtype == np.int64:
        if a.size and (a.min() < 0 or a.max() >= _U32):
            raise GrError(f"checkpoint: state leaf {key!r} holds values outside "
                          f"uint32; it has no counterpart in the JAX package")
        a = a.astype(np.uint32)
    return a


def _from_host(key: str, saved: np.ndarray, fresh: Any) -> Any:
    want = fresh.detach().cpu().numpy() if isinstance(fresh, torch.Tensor) \
        else np.asarray(fresh)
    if saved.shape != want.shape:
        raise GrError(f"state shape mismatch for {key!r}: {saved.shape} vs "
                      f"{want.shape}")
    if want.dtype == np.int64:
        if saved.dtype.kind not in "ui":
            raise GrError(f"state dtype mismatch for {key!r}: {saved.dtype} "
                          f"vs an integer (uint32) leaf")
        value = saved.astype(np.int64)
    elif saved.dtype != want.dtype:
        raise GrError(f"state dtype mismatch for {key!r}: {saved.dtype} vs "
                      f"{want.dtype}")
    else:
        value = saved
    if isinstance(fresh, torch.Tensor):
        return torch.from_numpy(np.array(value, copy=True)).to(fresh.device)
    return type(fresh)(value) if np.ndim(value) == 0 else value


def _restore(state: Any, path: str, blob: dict[str, np.ndarray]) -> Any:
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: _restore(v, f"{path}[{k!r}]", blob) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_restore(x, f"{path}[{i}]", blob)
                           for i, x in enumerate(state))
    if path not in blob:
        raise GrError(f"checkpoint missing state leaf {path!r}")
    return _from_host(path, blob[path], state)


def save_checkpoint(sched: Scheduler, path: str | Path) -> Path:
    """Snapshot a (paused or running) scheduler to ``path`` (a directory).

    Takes the scheduler's step-boundary lock so states and counters are
    captured atomically between steps."""
    with sched.step_lock:
        return _save_checkpoint_locked(sched, path)


def _save_checkpoint_locked(sched: Scheduler, path: str | Path) -> Path:
    if sched.compiled is None:
        raise GrError("scheduler not initialised; nothing to checkpoint")
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    names = [b.name for b in sched.compiled.order]
    if len(set(names)) != len(names):
        raise GrError(f"checkpoint requires unique block names; duplicates in "
                      f"{sorted(names)}")
    (p / "graph.yaml").write_text(
        save_grc(sched.graph, sample_rate=sched.sample_rate,
                 block_len=sched.block_len))
    name_of = {b.unique_name: b.name for b in sched.compiled.order}
    arrays: dict[str, np.ndarray] = {}
    for uname, state in sched._states.items():
        bname = name_of.get(uname, uname)
        for leaf_path, leaf in _leaves(state):
            key = bname + leaf_path
            arrays[key] = _to_host(key, leaf)
    np.savez(p / "states.npz", **arrays)
    meta = {
        "step": sched._step,
        "abs_in": {name_of[k]: v for k, v in sched._abs_in.items()
                   if k in name_of},
        "abs_out": {name_of[k]: v for k, v in sched._abs_out.items()
                    if k in name_of},
        "finished_sources": [name_of[k] for k in sched._finished_sources
                             if k in name_of],
        "eos_announced": [name_of[k] for k in sched._eos_announced
                          if k in name_of],
        "sample_rate": sched.sample_rate,
        "block_len": sched.block_len,
    }
    (p / "meta.json").write_text(json.dumps(meta, indent=1))
    return p


def load_checkpoint(path: str | Path, **scheduler_kwargs) -> Scheduler:
    """Rebuild a scheduler from a checkpoint (written by either package);
    states and counters are restored so the next step continues exactly where
    the snapshot left off. ``scheduler_kwargs`` go to :class:`Scheduler`
    (``device="cpu"`` to run on the CPU)."""
    p = Path(path)
    meta = json.loads((p / "meta.json").read_text())
    graph = load_grc((p / "graph.yaml").read_text())
    kw = dict(scheduler_kwargs)
    kw.setdefault("sample_rate", meta["sample_rate"])
    kw.setdefault("block_len", meta["block_len"])
    sched = Scheduler(graph, **kw)
    sched.init()
    with np.load(p / "states.npz") as npz:
        blob = {k: npz[k] for k in npz.files}
    name_of = {b.unique_name: b.name for b in sched.compiled.order}
    uname_of = {v: k for k, v in name_of.items()}
    for uname, state in sched._states.items():
        bname = name_of.get(uname, uname)
        own = {k: v for k, v in blob.items()
               if k == bname or k.startswith(bname + "[")}
        expected = {bname + leaf_path for leaf_path, _ in _leaves(state)}
        extra = sorted(set(own) - expected)
        if extra:
            raise GrError(f"checkpoint: block {bname!r} has state leaf "
                          f"{extra[0]!r}, which this package's state of the "
                          f"block does not have")
        try:
            sched._states[uname] = _restore(state, bname, own)
        except GrError as e:
            raise GrError(f"checkpoint: block {bname!r}: {e.args[0]}") from e
    sched._step = int(meta["step"])
    sched._abs_in = {uname_of[n]: int(v) for n, v in meta["abs_in"].items()}
    sched._abs_out = {uname_of[n]: int(v) for n, v in meta["abs_out"].items()}
    sched._finished_sources = {uname_of[n] for n in meta["finished_sources"]}
    sched._eos_announced = {uname_of[n] for n in meta["eos_announced"]}
    return sched
