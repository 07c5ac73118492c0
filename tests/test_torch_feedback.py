"""Feedback loop groups in the port against the JAX package, on the CPU:
every case of ``tests/test_feedback.py`` (its ``sp``-mesh case runs in
``tests/test_torch_mesh_scheduler.py``), the loop under every way the port's scheduler
runs a step, the back-edge state through checkpoints that cross packages,
and ``examples/agc_loop.yaml`` through ``run_grc`` and the CLI.

Tolerance: ``ATOL`` = 1e-5, ``tests/test_feedback.py``'s own bound (XLA
fuses the scan body; the port runs it op by op). The graph AGC against the
port's own ``Agc`` block is held to the same bound. The YAML flow's Gaussian
NoiseSource differs between the packages within 1e-5 of max(1, |x|), so that
case adds ``rtol`` = 1e-5.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.core.errors import GrError as JGrError
from gnuradio4_tpu_torch.core.errors import GrError as TGrError

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-5


def _sched(pkg, g, **kw):
    if pkg is gt:
        kw.setdefault("device", "cpu")
    return pkg.Scheduler(g, **kw)


def _agc_loop_graph(pkg, x, rate, delay):
    """AGC as a graph CYCLE: y = x·g; g' = clip(g + rate·(1 − |y|)) fed back
    into the multiplier (and the updater itself) with ``delay`` samples lag."""
    g = pkg.Graph()
    src = g.emplace("VectorSource", data=x)
    mul = g.emplace("Multiply", n_inputs=2)
    upd = g.emplace("ExpressionDISO",
                    expression=f"clip(y + {rate}*(1.0 - abs(x)), 1e-6, 65536.0)")
    snk = pkg.global_registry.create("VectorSink")
    g.connect(src, mul["in0"])
    g.connect(mul, upd["x"])
    g.connect(upd["out"], mul["in1"], feedback=True, delay=delay, fb_init=1.0)
    g.connect(upd["out"], upd["y"], feedback=True, delay=delay, fb_init=1.0)
    g.connect(mul, snk)
    return g, snk


def _x(seed=3, n=4096):
    rng = np.random.default_rng(seed)
    return (0.25 * rng.standard_normal(n)).astype(np.float32)


def _agc_block(pkg, x, **kw):
    g = pkg.Graph()
    src = g.emplace("VectorSource", data=x)
    agc = g.emplace("Agc", reference=1.0, rate=1e-2)
    snk = pkg.global_registry.create("VectorSink")
    g.connect_chain(src, agc, snk)
    _sched(pkg, g, block_len=1024, pipeline_depth=1, **kw).run_and_wait()
    return snk.data()


@pytest.mark.parametrize("seed", [3, 4])
def test_agc_block_agrees(seed):
    x = _x(seed)
    np.testing.assert_allclose(_agc_block(gt, x), _agc_block(gr, x),
                               atol=ATOL)


def test_agc_block_on_channels():
    x = np.stack([_x(5, 512), 3.0 * _x(6, 512)])
    out = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("VectorSource", data=x)
        agc = g.emplace("Agc", reference=0.5, rate=5e-2)
        snk = pkg.global_registry.create("VectorSink")
        g.connect_chain(src, agc, snk)
        _sched(pkg, g, block_len=128, pipeline_depth=1).run_and_wait()
        out.append(snk.data())
    assert out[1].shape == out[0].shape == x.shape
    np.testing.assert_allclose(out[1], out[0], atol=ATOL)


def test_agc_graph_loop_matches_monolithic_block():
    """Per-sample (delay=1) graph loop: the JAX package's run, the port's
    run and the port's Agc block agree, across steps (the back-edge state
    persists), and the loop converges."""
    x = _x()
    g1, s1 = _agc_loop_graph(gr, x, 0.01, delay=1)
    _sched(gr, g1, block_len=1024, pipeline_depth=1).run_and_wait()
    g2, s2 = _agc_loop_graph(gt, x, 0.01, delay=1)
    sched = _sched(gt, g2, block_len=1024, pipeline_depth=1)
    sched.run_and_wait()
    np.testing.assert_allclose(s2.data(), s1.data(), atol=ATOL)
    np.testing.assert_allclose(s2.data(), _agc_block(gt, x), atol=ATOL)
    assert 0.8 < np.mean(np.abs(s2.data()[-512:])) < 1.2
    assert len(sched.compiled.loop_groups) == 1
    assert sched._states["__fb__0"]["v0"].shape == (1,)


@pytest.mark.parametrize("mode", ["step_once", "pipelined", "async",
                                  "batch_steps"])
def test_loop_under_every_step_mode(mode):
    x = _x(7)
    g1, s1 = _agc_loop_graph(gr, x, 0.01, delay=4)
    _sched(gr, g1, block_len=512, pipeline_depth=1).run_and_wait()
    g2, s2 = _agc_loop_graph(gt, x, 0.01, delay=4)
    kw = {"step_once": {"pipeline_depth": 1},
          "pipelined": {"pipeline_depth": 2},
          "async": {"pipeline_depth": 2, "async_delivery": True},
          "batch_steps": {"batch_steps": 2}}[mode]
    sched = _sched(gt, g2, block_len=512, **kw)
    if mode == "step_once":
        sched.init()
        for _ in range(8):
            sched.step_once()
    else:
        sched.run_and_wait()
    np.testing.assert_allclose(s2.data(), s1.data(), atol=ATOL)


@pytest.mark.parametrize("delay", [64, 256, 1024])
def test_chunked_feedback_converges(delay):
    """delay=64 sub-chunk feedback: a block-update control loop."""
    x = _x(4)
    outs = []
    for pkg in (gr, gt):
        g, snk = _agc_loop_graph(pkg, x, 0.5, delay=delay)
        _sched(pkg, g, block_len=1024, pipeline_depth=1).run_and_wait()
        outs.append(snk.data())
    np.testing.assert_allclose(outs[1], outs[0], atol=ATOL)
    if delay == 64:
        assert 0.8 < np.mean(np.abs(outs[1][-512:])) < 1.2


def test_plain_cycle_still_rejected():
    def build(pkg):
        g = pkg.Graph()
        a = g.emplace("MultiplyConst", value=0.5)
        b = g.emplace("AddConst", value=1.0)
        g.connect(a, b)
        g.connect(b, a)   # no feedback=True → hard error
        g.topological_order()
    with pytest.raises(JGrError, match="feedback=True"):
        build(gr)
    with pytest.raises(TGrError, match="feedback=True"):
        build(gt)


def _compile(pkg, g, block_len):
    if pkg is gt:
        return gt.compile_graph(g, block_len=block_len, device="cpu")
    return gr.compile_graph(g, block_len=block_len)


def test_feedback_without_forward_path_rejected():
    def build(pkg):
        g = pkg.Graph()
        src = g.emplace("ConstantSource", n_samples=64)
        a = g.emplace("MultiplyConst", value=1.0)
        snk = pkg.global_registry.create("NullSink")
        g.connect_chain(src, a, snk)
        srcb = g.emplace("ConstantSource", n_samples=64)
        b = g.emplace("Multiply", n_inputs=2)
        snkb = pkg.global_registry.create("NullSink")
        g.connect(srcb, b["in0"])
        g.connect(b, snkb)
        # a and b are in disjoint branches: the back-edge a→b closes no cycle
        g.connect(a, b["in1"], feedback=True)
        _compile(pkg, g, 64)
    with pytest.raises(JGrError, match="forward path"):
        build(gr)
    with pytest.raises(TGrError, match="forward path"):
        build(gt)


def test_rate_changing_loop_member_rejected():
    def build(pkg):
        g = pkg.Graph()
        src = g.emplace("ConstantSource", n_samples=256)
        mul = g.emplace("Multiply", n_inputs=2)
        dec = g.emplace("Decimator", decim=2)
        snk = pkg.global_registry.create("NullSink")
        g.connect(src, mul["in0"])
        g.connect(mul, dec)
        g.connect(dec, mul["in1"], feedback=True)
        g.connect(dec, snk)
        _compile(pkg, g, 256)
    with pytest.raises(JGrError, match="rate-1"):
        build(gr)
    with pytest.raises(TGrError, match="rate-1"):
        build(gt)


def _two_edge_loop(pkg, d1, d2, n=256):
    g = pkg.Graph()
    src = g.emplace("ConstantSource", n_samples=n)
    mul = g.emplace("Multiply", n_inputs=2)
    upd = g.emplace("ExpressionDISO", expression="0.5 * x + 0.5 * y")
    snk = pkg.global_registry.create("NullSink")
    g.connect(src, mul["in0"])
    g.connect(mul, upd["x"])
    g.connect(upd["out"], mul["in1"], feedback=True, delay=d1, fb_init=1.0)
    g.connect(upd["out"], upd["y"], feedback=True, delay=d2, fb_init=1.0)
    g.connect(mul, snk)
    return g


@pytest.mark.parametrize("d1,d2,block_len,match", [
    (1, 2, 256, "share a delay"),
    (3, 3, 256, "must divide"),
    (7, 7, 256, "must divide"),
])
def test_delay_rejections_agree(d1, d2, block_len, match):
    def build(pkg):
        names = [b.name for b in _compile(
            pkg, _two_edge_loop(pkg, d1, d2), block_len).order]
        return names
    with pytest.raises(JGrError) as ej:
        build(gr)
    with pytest.raises(TGrError) as et:
        build(gt)
    assert match in ej.value.args[0] and match in et.value.args[0]
    assert et.value.args[0].split(";")[0] == ej.value.args[0].split(";")[0]


def test_host_tap_member_rejected():
    def build(pkg):
        g = pkg.Graph()
        src = g.emplace("ConstantSource", n_samples=256)
        mul = g.emplace("Multiply", n_inputs=2)
        tap = g.emplace("MultiplyConst", value=0.5)
        tap.HOST_TAP = True
        snk = pkg.global_registry.create("NullSink")
        g.connect(src, mul["in0"])
        g.connect(mul, tap)
        g.connect(tap, mul["in1"], feedback=True)
        g.connect(mul, snk)
        _compile(pkg, g, 256)
    with pytest.raises(JGrError, match="sink/host-fed"):
        build(gr)
    with pytest.raises(TGrError, match="sink/host-fed"):
        build(gt)


def test_mesh_raises():
    """A loop graph under ``mesh=`` (its gather island is held to the
    unsharded run in tests/test_torch_mesh_scheduler.py) raises for what is
    not a mesh, and for a ``device`` that is not the mesh's first."""
    from gnuradio4_tpu_torch.parallel.mesh import make_mesh
    g, _ = _agc_loop_graph(gt, _x(), 0.01, delay=1)
    with pytest.raises(TGrError, match="mesh"):
        gt.Scheduler(g, block_len=1024, mesh=object(), device="cpu")
    mesh = make_mesh((8,), ("sp",), devices=[torch.device("cpu")] * 8)
    with pytest.raises(TGrError, match="conflicts with the mesh"):
        gt.Scheduler(g, block_len=1024, mesh=mesh, device="meta")


def _ck_graph(pkg):
    g = pkg.Graph()
    src = g.emplace("NoiseSource", seed=7, n_samples=2048)
    src.name = "noise"
    att = g.emplace("MultiplyConst", value=0.25)
    att.name = "att"
    mul = g.emplace("Multiply", n_inputs=2)
    mul.name = "vga"
    upd = g.emplace(
        "ExpressionDISO",
        expression="clip(y + 0.01*(1.0 - abs(x)), 1e-6, 65536.0)")
    upd.name = "loopfilter"
    snk = pkg.global_registry.create("VectorSink")
    snk.name = "cap"
    g.connect_chain(src, att)
    g.connect(att, mul["in0"])
    g.connect(mul, upd["x"])
    g.connect(upd["out"], mul["in1"], feedback=True, delay=1, fb_init=1.0)
    g.connect(upd["out"], upd["y"], feedback=True, delay=1, fb_init=1.0)
    g.connect(mul, snk)
    return g, snk


def _first_half(pkg, path):
    g, snk = _ck_graph(pkg)
    sched = _sched(pkg, g, block_len=512, pipeline_depth=1)
    sched.init()
    for _ in range(2):
        sched._pump_once()
    sched._drain()
    first = snk.data()
    ck = pkg.save_checkpoint(sched, path) if pkg is gt else \
        __import__("gnuradio4_tpu.core.checkpoint", fromlist=["x"]
                   ).save_checkpoint(sched, path)
    sched.request_stop()
    return first, ck


def _resume(pkg, ck):
    if pkg is gt:
        resumed = gt.load_checkpoint(ck, pipeline_depth=1, device="cpu")
    else:
        from gnuradio4_tpu.core.checkpoint import load_checkpoint
        resumed = load_checkpoint(ck, pipeline_depth=1)
    snk = [b for b in resumed.compiled.order if b.name == "cap"][0]
    while resumed._pump_once():
        pass
    resumed._drain()
    return snk.data()


@pytest.mark.parametrize("save_pkg,load_pkg", [(gt, gt), (gr, gt), (gt, gr)],
                         ids=["port-port", "jax-port", "port-jax"])
def test_checkpoint_preserves_backedge(tmp_path, save_pkg, load_pkg):
    """The __fb__ state round-trips through save/load_checkpoint, within and
    across packages, against an uninterrupted JAX run."""
    g_ref, snk_ref = _ck_graph(gr)
    _sched(gr, g_ref, block_len=512, pipeline_depth=1).run_and_wait()
    ref = snk_ref.data()
    first, ck = _first_half(save_pkg, tmp_path / "fb")
    with np.load(ck / "states.npz") as npz:
        assert "__fb__0['v0']" in npz.files
    joined = np.concatenate([first, _resume(load_pkg, ck)])
    assert joined.shape == ref.shape
    np.testing.assert_allclose(joined, ref, atol=ATOL)


def test_sourceless_oscillator_self_loop():
    """A self-contained loop with NO external stream input (feedback
    oscillator). Each delay-chunk increments by 1 (x+1 around the loop)."""
    outs = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        osc = g.emplace("ExpressionSISO", expression="x + 1.0")
        head = g.emplace("HeadBlock", n_samples=512)
        snk = pkg.global_registry.create("VectorSink")
        g.connect(osc["out"], osc["in"], feedback=True, delay=64, fb_init=0.0)
        g.connect(osc, head)
        g.connect(head, snk)
        _sched(pkg, g, block_len=256, pipeline_depth=1).run_and_wait()
        outs.append(snk.data())
    expect = np.repeat(np.arange(1, 9, dtype=np.float32), 64)
    np.testing.assert_array_equal(outs[1], expect)
    np.testing.assert_array_equal(outs[1], outs[0])


def test_two_disjoint_loops():
    """Two independent feedback groups in one graph lower separately."""
    x = np.ones(1024, np.float32)
    res = []
    for pkg in (gr, gt):
        def loop(g, src, rate):
            mul = g.emplace("Multiply", n_inputs=2)
            upd = g.emplace("ExpressionDISO",
                            expression=f"clip(y + {rate}*(1.0 - abs(x)), "
                                       f"1e-6, 1e4)")
            g.connect(src, mul["in0"])
            g.connect(mul, upd["x"])
            g.connect(upd["out"], mul["in1"], feedback=True, fb_init=1.0)
            g.connect(upd["out"], upd["y"], feedback=True, fb_init=1.0)
            return mul

        g = pkg.Graph()
        s1 = g.add(pkg.global_registry.create("VectorSource", data=0.5 * x))
        s2 = g.add(pkg.global_registry.create("VectorSource", data=0.25 * x))
        m1, m2 = loop(g, s1, 0.05), loop(g, s2, 0.1)
        k1 = pkg.global_registry.create("VectorSink")
        k2 = pkg.global_registry.create("VectorSink")
        g.connect(m1, k1)
        g.connect(m2, k2)
        sched = _sched(pkg, g, block_len=512, pipeline_depth=1)
        sched.run_and_wait()
        assert len(sched.compiled.loop_groups) == 2
        assert 0.8 < abs(k1.data()[-1]) < 1.2
        assert 0.8 < abs(k2.data()[-1]) < 1.2
        res.append((k1.data(), k2.data()))
    for a, b in zip(*res):
        np.testing.assert_allclose(b, a, atol=ATOL)


def test_loop_with_downstream_and_internal_chain():
    """A loop of three members (Multiply → MultiplyConst → ExpressionDISO)
    whose inner output also feeds a block after the loop: the compiler
    orders the group among plain blocks and joins only the outputs that
    leave it."""
    x = _x(9, 2048)
    outs = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("VectorSource", data=x)
        mul = g.emplace("Multiply", n_inputs=2)
        k = g.emplace("MultiplyConst", value=2.0)
        upd = g.emplace("ExpressionDISO",
                        expression="clip(y + 0.02*(1.0 - abs(x)), 1e-6, 1e3)")
        post = g.emplace("AddConst", value=1.0)
        s1 = pkg.global_registry.create("VectorSink")
        s2 = pkg.global_registry.create("VectorSink")
        g.connect(src, mul["in0"])
        g.connect(mul, k)
        g.connect(k, upd["x"])
        g.connect(upd["out"], mul["in1"], feedback=True, delay=2, fb_init=1.0)
        g.connect(upd["out"], upd["y"], feedback=True, delay=2, fb_init=1.0)
        g.connect(k, post)
        g.connect(post, s1)
        g.connect(upd, s2)
        _sched(pkg, g, block_len=512, pipeline_depth=1).run_and_wait()
        outs.append((s1.data(), s2.data()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, atol=ATOL)


def _agc_yaml():
    return (ROOT / "examples" / "agc_loop.yaml").read_text()


def _named(sched, name):
    return [b for b in sched.compiled.order if b.name == name][0]


def test_agc_loop_yaml_through_run_grc():
    sj = gr.run_grc(_agc_yaml(), n_steps=2)
    st = gt.run_grc(_agc_yaml(), n_steps=2,
                    scheduler_kwargs={"device": "cpu"})
    yj, yt = _named(sj, "audio").data(), _named(st, "audio").data()
    assert yt.shape == yj.shape == (2 * 4096,)
    # the flow's NoiseSource is Gaussian: its samples differ within 1e-5 of
    # max(1, |x|) (torch's erfinv against XLA's; tests/test_torch_checkpoint)
    # and the loop's gain (~20 here) scales that, so the bound is relative
    np.testing.assert_allclose(yt, yj, rtol=ATOL, atol=ATOL)
    assert 0.8 < np.mean(np.abs(yt[-512:])) < 1.2


def test_agc_loop_yaml_through_the_cli():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "gnuradio4_tpu_torch", "run",
                        "--cpu", "--steps", "1", "examples/agc_loop.yaml"],
                       capture_output=True, text=True, timeout=600,
                       cwd=str(ROOT), env=env)
    assert r.returncode == 0, r.stderr
    assert "steps=1" in r.stderr and "device=cpu" in r.stderr
