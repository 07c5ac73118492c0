"""Multi-process time sharding in the port: two ``torch.distributed``
processes (Gloo, CPU) build a global mesh of 4 CPU shards each and run
sp-sharded graphs through the Scheduler (tests/torch_multihost_worker.py);
each process's sink slices are held against NumPy (the FIR chain, within
1e-5, as tests/multihost_worker.py holds the JAX package's), the JAX
package's single-process run (within 1e-5) and the port's single-process
run over ``[cpu] * 8`` (bitwise: the same shards run the same ops). The
collectives across the process boundary are held bitwise to their
single-process list forms. A dead peer surfaces a ``GrError`` on the
survivor within 90 s (tests/torch_multihost_failure_worker.py); an
unreachable coordinator raises; a process-spanning mesh other than exactly
``sp`` is refused."""

import importlib.util
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.parallel import collectives as col
from gnuradio4_tpu_torch.parallel import halo, multihost
from gnuradio4_tpu_torch.parallel.mesh import Mesh, make_mesh

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_multihost_worker.py")
FAILURE_WORKER = Path(__file__).with_name("torch_multihost_failure_worker.py")
NPROC = 2
ATOL = 1e-5
CPU = torch.device("cpu")

_spec = importlib.util.spec_from_file_location("torch_multihost_worker",
                                               WORKER)
wk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(wk)

torch.set_num_threads(2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(script: Path, *extra: str, timeout: float) -> list:
    """Start NPROC workers, wait for each within ``timeout`` s (killing all
    on a hang) and return ``[(returncode, output), ...]``."""
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, str(script), str(i),
                               str(NPROC), port, *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=str(ROOT))
             for i in range(NPROC)]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=timeout)[0], p.returncode))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{script.name} workers timed out:\n"
                    + "\n".join(o for o, _ in outs))
    return [(rc, out) for out, rc in outs]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each process's saved results of one two-process run."""
    out_dir = tmp_path_factory.mktemp("multihost")
    for i, (rc, out) in enumerate(_spawn(WORKER, str(out_dir), timeout=50)):
        assert rc == 0 and f"[{i}] OK" in out, (
            f"worker {i} failed (rc={rc}):\n{out[-3000:]}")
    return [dict(np.load(out_dir / f"rank{i}.npz")) for i in range(NPROC)]


@pytest.fixture(scope="module")
def single():
    """The port's single-process run of every graph over ``[cpu] * 8``."""
    mesh = make_mesh((NPROC * wk.LOCAL_SHARDS,), ("sp",),
                     devices=[CPU] * NPROC * wk.LOCAL_SHARDS)
    return {name: wk.run_graph(gt, name, mesh) for name in wk.GRAPHS}


def _slice(data: np.ndarray, steps: int, pid: int) -> np.ndarray:
    """Process ``pid``'s part of a single-process sink's data: its time
    slice of every step's output."""
    per = data.reshape(steps, -1)
    w = per.shape[1] // NPROC
    return per[:, pid * w:(pid + 1) * w].reshape(-1)


def test_collectives_cross_the_process_boundary(ranks):
    n = NPROC * wk.LOCAL_SHARDS
    small, wide = wk.collective_inputs(n)
    xs = [torch.from_numpy(a) for a in small]
    ws = [torch.from_numpy(a) for a in wide]
    edge = torch.full((3, 3), -1.0)
    want = {
        "ppermute": col.ppermute(xs, [(i, (i + 1) % n) for i in range(n)]),
        "ppermute_partial": col.ppermute(xs, [(i, i + 1)
                                              for i in range(n - 1)]),
        "all_gather": col.all_gather(xs),
        "psum": col.psum(xs),
        "pmean": col.pmean(xs),
        "all_to_all": col.all_to_all(ws, 1, 2),
        "halo_left": halo.halo_left(xs, 3, edge),
        "split": xs,
    }
    tail = halo.last_shard_tail(xs, 3).numpy()
    for pid, got in enumerate(ranks):
        mine = slice(pid * wk.LOCAL_SHARDS, (pid + 1) * wk.LOCAL_SHARDS)
        for k, v in want.items():
            w = np.stack([t.numpy() for t in v])[mine]
            np.testing.assert_array_equal(got[f"col_{k}"], w, err_msg=k)
        np.testing.assert_array_equal(got["col_last_shard_tail"][0], tail)


@pytest.mark.parametrize("name", ["fir", "fir_batched"])
def test_fir_chain_slices(ranks, single, name):
    """tests/multihost_worker.py's chain: each slice within 1e-5 of the
    NumPy convolution, and bitwise the single-process run's."""
    steps = wk.GRAPHS[name][3]
    ref = np.convolve(wk.fir_input(), wk.fir_taps())[:wk.N_FIR]
    for pid, got in enumerate(ranks):
        local = got[f"{name}_0"]
        want = _slice(ref.astype(np.float32), steps, pid)
        assert local.shape == want.shape == (wk.N_FIR // NPROC,)
        np.testing.assert_allclose(local, want, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(local,
                                      _slice(single[name][0], steps, pid))


@pytest.mark.parametrize("name", ["headline", "headline_derotated", "island",
                                  "loop"])
def test_graphs_against_the_jax_package(ranks, single, name):
    """The headline chain (absorbed and derotated), a gather island and a
    feedback loop group: each process's slices within 1e-5 of the JAX
    package's single-process run, and bitwise the port's over [cpu] * 8."""
    steps = wk.GRAPHS[name][3]
    ref = wk.run_graph(gr, name, None)
    for pid, got in enumerate(ranks):
        for i, (j, s) in enumerate(zip(ref, single[name])):
            local = got[f"{name}_{i}"]
            want = _slice(np.asarray(j), steps, pid)
            assert local.shape == want.shape and local.shape[0] > 0
            np.testing.assert_allclose(local, want, rtol=0, atol=ATOL)
            np.testing.assert_array_equal(local, _slice(s, steps, pid))


def test_dead_peer_surfaces_a_grerror():
    """Process 1 exits 17 after 3 steps; process 0 gets a GrError within
    90 s (its watchdog or the collective), never a hang."""
    (rc0, out0), (rc1, out1) = _spawn(FAILURE_WORKER, timeout=100)
    assert rc1 == 17, f"victim rc={rc1}:\n{out1[-3000:]}"
    assert rc0 == 0 and "GOT-ERROR" in out0, f"survivor rc={rc0}:\n{out0[-3000:]}"


def test_watchdog_names_the_process():
    """The watchdog's "error" action, under a mesh spanning processes,
    names this process and calls the stall a collective timeout (the JAX
    package's message); here a block that stalls stands in for a
    collective that waits on a dead peer."""
    from gnuradio4_tpu_torch.core.block import Block, Port

    class Stall(Block):
        IN = (Port("in"),)
        OUT = (Port("out"),)

        def apply(self, state, ins, ctx):
            time.sleep(1.0)
            return state, {"out": ins["in"]}

    g = gt.Graph()
    g.connect_chain(g.emplace("VectorSource", data=np.zeros(64, np.float32)),
                    g.add(Stall()), g.emplace("VectorSink"))
    mesh = Mesh(np.asarray([CPU] * 4, dtype=object), ("sp",),
                process_index=0, process_count=2)
    s = gt.Scheduler(g, block_len=64, mesh=mesh, pipeline_depth=1,
                     watchdog_timeout=0.3, watchdog_action="error")
    s.start()
    with pytest.raises(GrError, match=r"collective timeout.*process 0 of 2"):
        s.wait_done(timeout=30)
    s._runner.join(30)
    assert not s._runner.is_alive()


def test_unreachable_coordinator_raises():
    """No process serves the coordinator: GrError within the timeout (the
    JAX package returns False instead)."""
    with pytest.raises(GrError, match="not reachable from process 1 of 2"):
        multihost.init_distributed(f"127.0.0.1:{_free_port()}", 2, 1,
                                   device="cpu", timeout=2.0)
    assert multihost.backend() is None and multihost.process_count() == 1


def test_single_process_defaults(monkeypatch):
    """Nothing given: a no-op; the global mesh is this process's."""
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_distributed() is False
    mesh = multihost.global_mesh(("sp",), [CPU] * 4)
    assert mesh.process_count == 1 and mesh.shape == {"sp": 4}
    assert multihost.is_coordinator()
    parts = multihost.feed_global(np.arange(8.0), mesh)
    assert [p.tolist() for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    np.testing.assert_array_equal(multihost.drain_local(parts), np.arange(8.0))


def test_the_default_device_is_the_card(monkeypatch):
    """Without ``device=`` a process joins with its card; with no card the
    default raises instead of choosing the CPU (and Gloo) silently."""
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(GrError, match='pass device="cpu"'):
        multihost.init_distributed(f"127.0.0.1:{_free_port()}", 2, 1,
                                   timeout=2.0)
    with pytest.raises(GrError, match='pass device="cpu"'):
        multihost.global_mesh(("sp",))
    assert multihost.backend() is None and multihost.process_count() == 1
    assert multihost.global_mesh(("sp",), [CPU] * 2).shape == {"sp": 2}


def test_backend_follows_the_devices():
    assert multihost.choose_backend(["a|cuda:0", "a|cuda:1"]) == "nccl"
    assert multihost.choose_backend(["a|cuda:0", "b|cuda:0"]) == "nccl"
    assert multihost.choose_backend(["a|cuda:0", "a|cuda:0"]) == "gloo"
    assert multihost.choose_backend(["a|cpu", "a|cpu"]) == "gloo"
    assert multihost.choose_backend(["a|cuda:0", "a|cpu"]) == "gloo"


def test_a_process_spanning_mesh_must_be_exactly_sp():
    """A mesh with a dp axis spanning processes is refused, as the JAX
    package refuses it."""
    g = gt.Graph()
    g.connect(g.emplace("VectorSource", data=np.zeros(64, np.float32)),
              g.emplace("VectorSink"))
    mesh = Mesh(np.asarray([[CPU] * 2] * 2, dtype=object), ("dp", "sp"),
                process_index=0, process_count=2)
    with pytest.raises(GrError, match="exactly the 'sp'"):
        gt.Scheduler(g, block_len=16, mesh=mesh)
    ok = Mesh(np.asarray([CPU] * 4, dtype=object), ("sp",), process_index=1,
              process_count=2)
    axis = ok.shard_axis("sp")
    assert (axis.size, axis.local_size, axis.first, axis.rank) == (4, 2, 2, 1)
    assert ok.home == CPU and "process 1 of 2" in repr(ok)
    with pytest.raises(GrError, match="runs in one process"):
        from gnuradio4_tpu_torch.parallel.sharded_rx import (
            ShardedRxConfig, build_sharded_rx)
        build_sharded_rx(mesh, ShardedRxConfig())
