"""``gnuradio4_tpu_torch.parallel`` against the JAX package's ``parallel/`` on
the CPU: the mesh and its factorisation, each list collective against a
NumPy model, the halo functions (``halo_left``, ``fir_timeshard`` over one
and two steps, ``quadrature_demod_timeshard``, ``nco_shard_apply`` across a
2^32 phase wrap), ``build_sharded_rx`` at (2, 4) and (1, 8) over two steps,
``StagePipeline`` and ``acquire_all(mesh=)``.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py); the
port's meshes repeat the CPU device (``[cpu] * n``). Tolerances, per case:
bitwise where both sides run the same arithmetic per sample (data movement,
NCO phases, the demod); ``FIR_ATOL`` = 1e-5 where a FIR sums K products (the
port's plain FIR is a tiled matmul whose tile follows the stream's length,
the JAX package's CPU FIR a convolution); ``RX_ATOL`` = 1e-4 for the
sharded receiver (FFT and atan2 of two libraries); detections exactly.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as JP

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.ops import gnss as jgnss
from gnuradio4_tpu.ops.fir import fir_apply as j_fir_apply
from gnuradio4_tpu.parallel import halo as jhalo
from gnuradio4_tpu.parallel import mesh as jmesh
from gnuradio4_tpu.parallel.pipeline import StagePipeline as JStagePipeline
from gnuradio4_tpu.parallel.sharded_rx import (
    ShardedRxConfig as JShardedRxConfig, build_sharded_rx as j_build_rx)
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.ops import gnss as tgnss
from gnuradio4_tpu_torch.ops.fir import fir_apply
from gnuradio4_tpu_torch.parallel import collectives as col
from gnuradio4_tpu_torch.parallel import halo
from gnuradio4_tpu_torch.parallel.mesh import (Mesh, PartitionSpec,
                                               make_mesh, mesh_axes,
                                               shard_over)
from gnuradio4_tpu_torch.parallel.pipeline import StagePipeline
from gnuradio4_tpu_torch.parallel.sharded_rx import (ShardedRxConfig,
                                                     build_sharded_rx)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
FIR_ATOL = 1e-5
RX_ATOL = 1e-4


@pytest.fixture(scope="module")
def jdevs():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    return devs


def _jsharded(f, n, in_specs, out_specs, jdevs, *args):
    mesh = JMesh(np.asarray(jdevs[:n]), ("sp",))
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))(*args)


# -- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("axes", [("dp", "sp"), ("sp",), ("dp", "sp", "chan")])
def test_make_mesh_factorisation(jdevs, n, axes):
    """The default shape of ``n`` devices equals the JAX package's."""
    jm = jmesh.make_mesh(axes=axes, devices=jdevs[:n])
    tm = make_mesh(axes=axes, devices=[CPU] * n)
    assert tm.shape == dict(jm.shape)
    assert list(tm.shape) == list(jm.shape)
    assert mesh_axes(tm) == jmesh.mesh_axes(jm) == tuple(axes)
    assert tm.size == n and tm.home == CPU


def test_make_mesh_refusals(jdevs):
    with pytest.raises(ValueError, match="devices"):
        jmesh.make_mesh((3,), ("sp",), devices=jdevs[:4])
    with pytest.raises(ValueError, match="devices"):
        make_mesh((3,), ("sp",), devices=[CPU] * 4)
    with pytest.raises(GrError, match="axis names"):
        Mesh(np.asarray([CPU] * 4, dtype=object), ("dp", "sp"))


def test_make_mesh_default_devices():
    """``devices=None`` is every visible CUDA device; with none it raises."""
    if torch.cuda.is_available():
        mesh = make_mesh(axes=("sp",))
        assert mesh.size == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in mesh.devices.flat)
    else:
        with pytest.raises(GrError, match="no CUDA device"):
            make_mesh(axes=("sp",))


def test_mesh_axis_devices_and_specs():
    devs = [torch.device("meta"), CPU] * 4
    mesh = make_mesh((4, 2), ("sp", "chan"), devices=devs)
    assert mesh.shape == {"sp": 4, "chan": 2}
    assert mesh.axis_devices("sp") == [torch.device("meta")] * 4
    assert mesh.axis_devices("chan") == [torch.device("meta"), CPU]
    assert mesh.home == torch.device("meta")
    s = shard_over(mesh, "chan", None)
    assert s.spec == PartitionSpec("chan", None) and s.mesh is mesh
    assert tuple(s.spec) == tuple(JP("chan", None))


def test_named_sharding_split_gather_roundtrip():
    """A [B, T] tensor over (dp 2, sp 4): block (d, s) is rows d·B/2… and
    samples s·T/4…; gather inverts split; a spec that names one axis
    replicates over the other."""
    mesh = make_mesh((2, 4), ("dp", "sp"), devices=[CPU] * 8)
    x = torch.arange(4 * 32, dtype=torch.float32).reshape(4, 32)
    grid = shard_over(mesh, "dp", "sp").split(x)
    assert grid.shape == (2, 4)
    for d in range(2):
        for s in range(4):
            assert torch.equal(grid[d, s], x[2 * d:2 * d + 2, 8 * s:8 * s + 8])
    assert torch.equal(shard_over(mesh, "dp", "sp").gather(grid), x)
    rep = shard_over(mesh, "dp", None)
    g2 = rep.split(x)
    assert torch.equal(g2[1, 3], x[2:4]) and torch.equal(g2[1, 0], x[2:4])
    assert torch.equal(rep.gather(g2), x)
    with pytest.raises(GrError, match="does not split"):
        shard_over(mesh, None, "sp").split(torch.zeros(3, 30))


# -- the collectives against a NumPy model -------------------------------------

def _shards(rng, n, shape=(3, 8), dtype=np.float32):
    arrs = [rng.standard_normal(shape).astype(dtype) for _ in range(n)]
    return arrs, [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_collectives_against_numpy(n):
    rng = np.random.default_rng(n)
    arrs, xs = _shards(rng, n)
    # ppermute: a ring shift right, shard 0 receives the last shard's value
    perm = [(i, (i + 1) % n) for i in range(n)]
    got = col.ppermute(xs, perm)
    for i in range(n):
        np.testing.assert_array_equal(got[i].numpy(), arrs[(i - 1) % n])
    # a partial permutation leaves receivers without a sender at zero
    got = col.ppermute(xs, [(i, i + 1) for i in range(n - 1)])
    np.testing.assert_array_equal(got[0].numpy(), np.zeros_like(arrs[0]))
    # all_gather (tiled on the last axis), psum, pmean
    full = np.concatenate(arrs, axis=-1)
    for g in col.all_gather(xs):
        np.testing.assert_array_equal(g.numpy(), full)
    total = arrs[0].copy()
    for a in arrs[1:]:
        total = total + a
    for s, m in zip(col.psum(xs), col.pmean(xs)):
        np.testing.assert_array_equal(s.numpy(), total)
        np.testing.assert_array_equal(m.numpy(), total / np.float32(n))
    # split / gather
    axis = col.ShardAxis("sp", (CPU,) * n)
    parts = col.split(torch.from_numpy(full), axis)
    for p, a in zip(parts, arrs):
        np.testing.assert_array_equal(p.numpy(), a)
    np.testing.assert_array_equal(col.gather(parts, CPU).numpy(), full)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_all_to_all_against_numpy(n):
    """Tiled all-to-all: shard j receives part j (along split_dim) of every
    shard, joined along concat_dim in shard order."""
    rng = np.random.default_rng(10 + n)
    arrs, xs = _shards(rng, n, shape=(2, 4 * n, 6))
    got = col.all_to_all(xs, 1, 2)
    w = 4
    for j in range(n):
        want = np.concatenate([a[:, j * w:(j + 1) * w] for a in arrs], axis=2)
        np.testing.assert_array_equal(got[j].numpy(), want)
    if n > 1:
        with pytest.raises(GrError, match="does not split"):
            col.all_to_all([torch.zeros(2, 3, 6)] * n, 1, 2)


def test_all_to_all_matches_jax(jdevs):
    """The same corner turn as the JAX package's ``lax.all_to_all``."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 4 * 6)).astype(np.float32)
    want = _jsharded(
        lambda v: jax.lax.all_to_all(v, "sp", split_axis=1, concat_axis=2,
                                     tiled=True),
        4, (JP(None, None, "sp"),), JP(None, "sp", None), jdevs,
        jnp.asarray(x))
    xs = [torch.from_numpy(p) for p in np.split(x, 4, axis=2)]
    got = torch.cat(col.all_to_all(xs, 1, 2), dim=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- halo functions --------------------------------------------------------------

def test_halo_left_moves_neighbor_tail(jdevs):
    x = np.arange(16.0, dtype=np.float32)
    edge = np.asarray([-2.0, -1.0], np.float32)
    want = np.asarray(_jsharded(
        lambda xl, e: jhalo.halo_left(xl, 2, "sp", e), 4, (JP("sp"), JP()),
        JP("sp"), jdevs, jnp.asarray(x), jnp.asarray(edge))).reshape(4, 2)
    got = halo.halo_left(list(torch.from_numpy(x).chunk(4)), 2,
                         torch.from_numpy(edge))
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)
    np.testing.assert_array_equal(want[1], [2, 3])
    np.testing.assert_array_equal(want[3], [10, 11])
    # no edge state: shard 0 gets zeros; n = 0 gives empty halos
    got = halo.halo_left(list(torch.from_numpy(x).chunk(4)), 2)
    np.testing.assert_array_equal(got[0].numpy(), [0.0, 0.0])
    assert [h.shape[-1] for h in halo.halo_left(
        list(torch.from_numpy(x).chunk(4)), 0)] == [0] * 4


def test_halo_left_refuses_a_halo_longer_than_the_shard():
    """A halo longer than a shard would come back short: halo_left raises,
    for every caller alike."""
    xs = list(torch.arange(16.0).chunk(4))
    with pytest.raises(GrError, match="local shard length 4 < halo 5"):
        halo.halo_left(xs, 5)
    with pytest.raises(GrError, match="local shard length 4 < halo 5"):
        halo.fir_timeshard(xs, np.ones(6, np.float32))
    assert [h.shape[-1] for h in halo.halo_left(xs, 4)] == [4] * 4


def test_last_shard_tail():
    xs = list(torch.arange(24.0).reshape(2, 12).chunk(3, dim=-1))
    tail = halo.last_shard_tail(xs, 3)
    np.testing.assert_array_equal(tail.numpy(), [[9, 10, 11], [21, 22, 23]])
    assert tail.data_ptr() != xs[-1].data_ptr()      # a copy, not a view


def test_fir_timeshard_equals_single_device(jdevs):
    rng = np.random.default_rng(7)
    taps = rng.standard_normal(17).astype(np.float32)
    x = rng.standard_normal(1024).astype(np.float32)
    y_one, _ = fir_apply(torch.from_numpy(x), taps, torch.zeros(16))
    y_j, tail_j = _jsharded(
        lambda xl, e: jhalo.fir_timeshard(xl, jnp.asarray(taps), "sp", e),
        8, (JP("sp"), JP()), (JP("sp"), JP()), jdevs, jnp.asarray(x),
        jnp.zeros(16, jnp.float32))
    ys, tail = halo.fir_timeshard(list(torch.from_numpy(x).chunk(8)), taps,
                                  torch.zeros(16))
    y = torch.cat(ys).numpy()
    np.testing.assert_allclose(y, y_one.numpy(), atol=FIR_ATOL)
    np.testing.assert_allclose(y, np.asarray(y_j), atol=FIR_ATOL)
    np.testing.assert_array_equal(tail.numpy(), x[-16:])
    np.testing.assert_array_equal(tail.numpy(), np.asarray(tail_j))


@pytest.mark.parametrize("decim", [1, 4])
def test_fir_timeshard_streaming_continuity(jdevs, decim):
    """Two sharded steps == one long single-device run (edge state carry),
    in both packages."""
    rng = np.random.default_rng(3)
    taps = rng.standard_normal(9).astype(np.float32)
    x = rng.standard_normal(512).astype(np.float32)
    y_ref, _ = j_fir_apply(jnp.asarray(x), jnp.asarray(taps),
                           jnp.zeros(8, jnp.float32), decim=decim)
    y_one, _ = fir_apply(torch.from_numpy(x), taps, torch.zeros(8),
                         decim=decim)
    edge, outs = torch.zeros(8), []
    for half in x.reshape(2, 256):
        ys, edge = halo.fir_timeshard(list(torch.from_numpy(half).chunk(4)),
                                      taps, edge, decim=decim)
        outs.append(torch.cat(ys).numpy())
    got = np.concatenate(outs)
    np.testing.assert_allclose(got, y_one.numpy(), atol=FIR_ATOL)
    np.testing.assert_allclose(got, np.asarray(y_ref), atol=FIR_ATOL)
    np.testing.assert_array_equal(edge.numpy(), x[-8:])


def test_fir_timeshard_complex_channels():
    """[C, T] complex streams over 8 shards against one call."""
    rng = np.random.default_rng(9)
    taps = rng.standard_normal(33).astype(np.float32)
    x = (rng.standard_normal((3, 2048))
         + 1j * rng.standard_normal((3, 2048))).astype(np.complex64)
    xt = torch.from_numpy(x)
    y_one, st = fir_apply(xt, taps, torch.zeros(3, 32, dtype=torch.complex64))
    ys, tail = halo.fir_timeshard(list(xt.chunk(8, dim=-1)), taps)
    np.testing.assert_allclose(torch.cat(ys, -1).numpy(), y_one.numpy(),
                               atol=FIR_ATOL)
    np.testing.assert_array_equal(tail.numpy(), st.numpy())


def test_quadrature_demod_timeshard(jdevs):
    """The 1-sample halo gives each shard its left neighbour's last sample;
    bitwise equal to one call and to the JAX package's sharded demod."""
    from gnuradio4_tpu_torch.ops.demod import quadrature_demod
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 1024))
         + 1j * rng.standard_normal((2, 1024))).astype(np.complex64)
    last = (rng.standard_normal(2) + 1j * rng.standard_normal(2)
            ).astype(np.complex64)
    xt = torch.from_numpy(x)
    y_one, l_one = quadrature_demod(xt, torch.from_numpy(last), gain=0.5)
    ys, l_sh = halo.quadrature_demod_timeshard(
        list(xt.chunk(8, dim=-1)), torch.from_numpy(last), gain=0.5)
    np.testing.assert_array_equal(torch.cat(ys, -1).numpy(), y_one.numpy())
    np.testing.assert_array_equal(l_sh.numpy(), x[:, -1])
    y_j, l_j = _jsharded(
        lambda xl, e: jhalo.quadrature_demod_timeshard(xl, "sp", e, gain=0.5),
        8, (JP(None, "sp"), JP()), (JP(None, "sp"), JP()), jdevs,
        jnp.asarray(x), jnp.asarray(last))
    np.testing.assert_allclose(torch.cat(ys, -1).numpy(), np.asarray(y_j),
                               atol=1e-6)
    np.testing.assert_array_equal(l_sh.numpy(), np.asarray(l_j))


def test_nco_shard_apply_across_phase_wrap():
    """A Rotator whose phase starts just below 2^32: each shard's offset
    phase wraps mod 2^32 exactly, so the shards equal one call bit for bit
    and the global phase advances by T·dphi mod 2^32."""
    from gnuradio4_tpu_torch.blocks.basic import phase_state
    from gnuradio4_tpu_torch.blocks.math import Rotator
    rng = np.random.default_rng(12)
    n, sp = 4096, 8
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    rot = Rotator(frequency_shift=1234.5, sample_rate=48000.0)
    ctx = gt.BlockCtx(in_len={"in": n}, out_len={"out": n},
                      sample_rate=48000.0, params={})
    ctx.params = rot.prepare_params(rot.settings.dynamic_params())
    start = (1 << 32) - 3 * int(ctx.params["_dphi"]) - 5
    st1, o1 = rot.apply(phase_state(start), {"in": torch.from_numpy(x)}, ctx)
    axis = col.ShardAxis("sp", (CPU,) * sp)
    lctx = [gt.BlockCtx(in_len={"in": n // sp}, out_len={"out": n // sp},
                        sample_rate=48000.0, params=ctx.params)] * sp
    ins = [{"in": p} for p in torch.from_numpy(x).chunk(sp)]
    st8, o8 = halo.nco_shard_apply(rot, phase_state(start), ins, lctx, axis,
                                   int(ctx.params["_dphi"]), n // sp)
    np.testing.assert_array_equal(torch.cat([o["out"] for o in o8]).numpy(),
                                  o1["out"].numpy())
    assert int(st8) == int(st1) == (start + n * int(ctx.params["_dphi"])) \
        % (1 << 32)
    # and Rotator.apply_sp (the compiler's entry) is the same call
    st_sp, o_sp = rot.apply_sp(phase_state(start), ins, ctx, lctx, axis)
    assert int(st_sp) == int(st1)
    np.testing.assert_array_equal(
        torch.cat([o["out"] for o in o_sp]).numpy(), o1["out"].numpy())


# -- the sharded wideband receiver -------------------------------------------------

def _rx_input(cfg, steps, kind, noise=0.0):
    """tests/test_parallel.py's tones; ``noise`` adds seeded complex noise
    so that every channel carries energy (a silent channel's demod is the
    angle of rounding error, which no two FFTs share)."""
    t = np.arange(steps * cfg.block_len)
    if kind == "two_tones":
        x = np.stack([np.exp(2j * np.pi * (3.0 / 16.0 + 0.001) * t),
                      np.exp(2j * np.pi * (5.0 / 16.0) * t)])
    else:
        x = np.exp(2j * np.pi * (2.0 / 8.0 + 0.002) * t)[None]
    rng = np.random.default_rng(21)
    x = x + noise * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def _run_jax_rx(jdevs, shape, cfg_kw, x, steps):
    mesh = jmesh.make_mesh(shape=shape, axes=("dp", "sp"),
                           devices=jdevs[:shape[0] * shape[1]])
    cfg = JShardedRxConfig(**cfg_kw)
    step, init_state, x_sharding = j_build_rx(mesh, cfg)
    state, outs, powers = init_state(), [], []
    for k in range(steps):
        xk = x[:, k * cfg.block_len:(k + 1) * cfg.block_len]
        state, audio, power = step(state, jax.device_put(jnp.asarray(xk),
                                                         x_sharding))
        outs.append(np.asarray(audio))
        powers.append(float(power))
    return np.concatenate(outs, axis=-1), powers


def _run_port_rx(shape, cfg_kw, x, steps, split=False):
    mesh = make_mesh(shape=shape, axes=("dp", "sp"),
                     devices=[CPU] * (shape[0] * shape[1]))
    cfg = ShardedRxConfig(**cfg_kw)
    step, init_state, x_sharding = build_sharded_rx(mesh, cfg)
    state, outs, powers = init_state(), [], []
    for k in range(steps):
        xk = torch.from_numpy(x[:, k * cfg.block_len:(k + 1) * cfg.block_len])
        state, audio, power = step(state, x_sharding.split(xk) if split
                                   else xk)
        outs.append(audio.numpy())
        powers.append(float(power))
    return np.concatenate(outs, axis=-1), powers, state


RX_CASES = {
    (2, 4): (dict(n_channels=16, taps_per_phase=4, audio_decim=2,
                  audio_ntaps=16, batch=2, block_len=4096), "two_tones"),
    (1, 8): (dict(n_channels=8, taps_per_phase=4, audio_decim=1,
                  audio_ntaps=8, batch=1, block_len=4096), "one_tone"),
}


@pytest.mark.parametrize("shape", list(RX_CASES))
def test_sharded_rx_against_jax_and_unsharded(jdevs, shape):
    """Two steps of the sharded receiver on the tones plus noise: the port's
    mesh against the JAX package's mesh and against the port on a (1, 1)
    mesh (RX_ATOL); on the tones alone, the demodulated offset constant as
    tests/test_parallel.py checks it."""
    cfg_kw, kind = RX_CASES[shape]
    cfg = ShardedRxConfig(**cfg_kw)
    x = _rx_input(cfg, 2, kind, noise=0.3)
    got, p_got, state = _run_port_rx(shape, cfg_kw, x, 2, split=True)
    want, p_want = _run_jax_rx(jdevs, shape, cfg_kw, x, 2)
    one, p_one, _ = _run_port_rx((1, 1), cfg_kw, x, 2)
    m = cfg_kw["n_channels"]
    assert got.shape == want.shape == (cfg_kw["batch"], m,
                                       2 * 4096 // m // cfg_kw["audio_decim"])
    np.testing.assert_allclose(got, want, atol=RX_ATOL)
    np.testing.assert_allclose(got, one, atol=RX_ATOL)
    np.testing.assert_allclose(p_got, p_want, rtol=1e-4)
    np.testing.assert_allclose(p_got, p_one, rtol=1e-5)
    assert state["pfb"].shape == (cfg_kw["batch"], m,
                                  cfg_kw["taps_per_phase"] - 1)
    got, _, _ = _run_port_rx(shape, cfg_kw, _rx_input(cfg, 2, kind), 2)
    if kind == "two_tones":
        np.testing.assert_allclose(got[0, 3, 32:2048 // 16].mean(),
                                   2 * np.pi * 0.001 * 16, rtol=0.2)
        np.testing.assert_allclose(got[1, 5, 32:].mean(), 0.0, atol=1e-3)
    else:
        # no glitch at the seam between the two steps
        seam = got[0, 2, 4096 // 8 - 16: 4096 // 8 + 16]
        np.testing.assert_allclose(seam, 2 * np.pi * 0.002 * 8, rtol=0.05)


def test_sharded_rx_refusals():
    mesh = make_mesh((2, 4), ("dp", "sp"), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="n_channels"):
        build_sharded_rx(mesh, ShardedRxConfig(n_channels=6))
    with pytest.raises(ValueError, match="batch"):
        build_sharded_rx(mesh, ShardedRxConfig(batch=3))
    with pytest.raises(ValueError, match="block_len"):
        build_sharded_rx(mesh, ShardedRxConfig(block_len=1000))
    with pytest.raises(GrError, match="'dp' and 'sp'"):
        build_sharded_rx(make_mesh((8,), ("sp",), devices=[CPU] * 8),
                         ShardedRxConfig())


# -- pipeline stages ------------------------------------------------------------------

def _stage(pkg, *blocks, name):
    g = pkg.Graph(name=name)
    for b in blocks:
        g.add(b)
    for a, b in zip(blocks, blocks[1:]):
        g.connect(a, b)
    g.export_in("in", blocks[0], "in")
    g.export_out("out", blocks[-1], "out")
    return g


def _three_stages(pkg):
    from importlib import import_module
    m = import_module(f"{pkg.__name__}.blocks.math")
    return [_stage(pkg, m.MultiplyConst(value=2.0), name="x2"),
            _stage(pkg, m.AddConst(value=10.0), name="+10"),
            _stage(pkg, m.MultiplyConst(value=0.5), name="half")]


def test_three_stage_pipeline_matches_fused(jdevs):
    """Three stages on three (repeated) devices: the JAX package's values,
    bitwise; each stage on its own position's device."""
    pipe = StagePipeline(_three_stages(gt), block_len=256,
                         boundary_dtype=np.float32, devices=[CPU] * 3)
    jpipe = JStagePipeline(_three_stages(gr), block_len=256,
                           boundary_dtype=np.float32, devices=jdevs[:3])
    assert pipe.latency == jpipe.latency == 2
    assert [st.device for st in pipe.stages] == [CPU] * 3
    for i in range(5):
        block = np.full(256, float(i), np.float32)
        out = pipe.push(block)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jpipe.push(block)))
        np.testing.assert_allclose(out.numpy(), (i * 2.0 + 10.0) * 0.5)
    assert [o.shape for o in pipe.run([np.zeros(256, np.float32)] * 2)] \
        == [(256,)] * 2
    with pytest.raises(GrError, match="need 3 devices"):
        StagePipeline(_three_stages(gt), block_len=256, devices=[CPU] * 2)
    with pytest.raises(GrError, match="expects an input block"):
        pipe.push(None)


def test_stage_devices_and_tensor_input():
    """Stages sit on their own device positions; a tensor input moves to the
    first stage's device; the output lives on the last stage's device."""
    from gnuradio4_tpu_torch.blocks.math import MultiplyConst
    s1 = _stage(gt, MultiplyConst(value=1.0), name="a")
    s2 = _stage(gt, MultiplyConst(value=1.0), name="b")
    pipe = StagePipeline([s1, s2], block_len=128, boundary_dtype=np.float32,
                         devices=["cpu", "cpu"])
    out = pipe.push(torch.ones(128))
    assert out.device == pipe.stages[1].device == CPU
    np.testing.assert_array_equal(out.numpy(), np.ones(128, np.float32))


def _domain_graph(pkg, domain):
    g = pkg.Graph()
    src = g.emplace("SignalGenerator", frequency=1000.0, n_samples=16384)
    fir = g.emplace("BasicFilter", filter_type="lowpass", f_low=2000.0,
                    ntaps=63, sample_rate_design=48000.0)
    mul = g.emplace("MultiplyConst", value=3.0)
    g.connect(src, fir)
    if domain is None:
        snk = pkg.global_registry.create("VectorSink")
        g.connect_chain(fir, mul, snk)
        return g, snk
    g.connect(fir, mul, domain=domain)
    return g, None


def test_from_graph_domain_stage_cuts(jdevs):
    """A ``gpu:cuda:1`` edge cuts the port's graph into two stages (the JAX
    package's ``tpu:xla:1``); the output equals the JAX package's pipeline
    and the port's fused graph."""
    pipe = StagePipeline.from_graph(_domain_graph(gt, "gpu:cuda:1")[0],
                                    block_len=4096, sample_rate=48000.0,
                                    devices=[CPU] * 2)
    assert len(pipe.stages) == 2
    outs = np.concatenate([pipe.push().numpy() for _ in range(4)])
    jpipe = JStagePipeline.from_graph(_domain_graph(gr, "tpu:xla:1")[0],
                                      block_len=4096, sample_rate=48000.0,
                                      devices=jdevs[:2])
    jouts = np.concatenate([np.asarray(jpipe.push()) for _ in range(4)])
    g, snk = _domain_graph(gt, None)
    gt.Scheduler(g, block_len=4096, sample_rate=48000.0,
                 device="cpu").run_and_wait()
    np.testing.assert_allclose(outs, snk.data(), atol=1e-6)
    np.testing.assert_allclose(outs, jouts, atol=FIR_ATOL)


def test_from_graph_refuses_skipped_stages():
    g = gt.Graph()
    src = g.emplace("SignalGenerator", frequency=1000.0)
    a = g.emplace("MultiplyConst", value=1.0)
    g.connect(src, a, domain="gpu:cuda:2")
    with pytest.raises(GrError, match="skips from stage 0 to 2"):
        StagePipeline.from_graph(g, block_len=64, devices=[CPU] * 3)


# -- the sky search over a mesh ------------------------------------------------------

@pytest.mark.parametrize("n", [8, 3])
def test_acquire_all_sharded_equals_unsharded(jdevs, n):
    """The PRN axis split over n shards (3 splits 32 PRNs unevenly) finds the
    same satellites, code phases and Doppler bins as the port's plain search
    and the JAX package's sharded one; the metrics within 1e-5."""
    fs = 2.046e6
    sig = jgnss.synthesize(
        [(7, 1800.0, 300), (22, -3250.0, 1501), (31, 4100.0, 888)],
        fs=fs, n_ms=4, noise_std=2.0, rng=np.random.default_rng(1))
    mesh = make_mesh((n,), axes=("ep",), devices=[CPU] * n)
    got = tgnss.acquire_all(sig, fs=fs, mesh=mesh)
    plain = tgnss.acquire_all(sig, fs=fs, device="cpu")
    jm = jmesh.make_mesh((8,), axes=("ep",), devices=jdevs[:8])
    want = jgnss.acquire_all(sig, fs=fs, mesh=jm)

    def key(ds):
        return [(d["prn"], d["code_phase"], d["doppler"]) for d in ds]
    assert [(d["prn"], d["code_phase"]) for d in got] == \
        [(7, 300), (22, 1501), (31, 888)]
    assert key(got) == key(plain) == key(want)
    np.testing.assert_allclose([d["metric"] for d in got],
                               [d["metric"] for d in plain], rtol=1e-5)


# -- import guard --------------------------------------------------------------

def test_parallel_imports_no_jax():
    """``import gnuradio4_tpu_torch, gnuradio4_tpu_torch.parallel`` (and every
    module of it) loads neither JAX nor the JAX package."""
    code = ("import sys; import gnuradio4_tpu_torch, gnuradio4_tpu_torch.parallel; "
            "import gnuradio4_tpu_torch.parallel.sharded_rx, "
            "gnuradio4_tpu_torch.parallel.pipeline, "
            "gnuradio4_tpu_torch.parallel.dryrun; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'gnuradio4_tpu' or m.startswith('gnuradio4_tpu.')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
