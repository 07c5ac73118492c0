"""The port's threefry noise and PFB channelizer against the JAX package, on
the CPU: random bits equal to ``jax.random``'s for the same key, the four
noise draws of ``ops/noise.py`` and the NoiseSource block, ``pfb_analyze`` /
``pfb_synthesize`` and the two PFB blocks, and suite config 5 end to end —
tagged noise → PFBChannelizer(256) → QuadratureDemod — in both packages,
including a stream handed from JAX to the port mid-run.

Tolerances: bits, keys and tag lists exact. Uniform floats within 1 ulp (the
JAX package's CPU build contracts ``u·span + lo`` into an FMA). Normal draws
within 1e-5·max(1, |x|): torch's erfinv against XLA's float32 polynomial
(≤ 6e-6 measured). PFB outputs within 1e-5 of the output scale (f32 sums,
two FFT implementations). Demod angles within 1e-3 rad, wrapped."""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.ops import channelizer as jch
from gnuradio4_tpu.ops import noise as jnoise
from gnuradio4_tpu_torch.interop import params_from_numpy, states_from_numpy
from gnuradio4_tpu_torch.ops import channelizer as tch
from gnuradio4_tpu_torch.ops import noise as tnoise

torch.set_num_threads(2)

NORMAL_RTOL = 1e-5
PFB_RTOL = 1e-5
DEMOD_ATOL = 1e-3


def _jkey(seed):
    return jax.random.key(np.uint32(seed))


def _kd(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _assert_normal_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if np.iscomplexobj(want):
        got, want = got.view(np.float32), want.view(np.float32)
    err = np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)))
    assert err <= NORMAL_RTOL, err


def _wrapped_err(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.max(np.abs((d + np.pi) % (2 * np.pi) - np.pi)))


# -- threefry ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1234, 2**32 - 1])
def test_keys_and_chained_splits_match_jax(seed):
    kj, kt = _jkey(seed), tnoise.key(seed)
    np.testing.assert_array_equal(kt.numpy(), _kd(kj))
    for num in (2, 3, 5):
        kj_all, kt_all = jax.random.split(kj, num), tnoise.split(kt, num)
        np.testing.assert_array_equal(kt_all.numpy(), _kd(kj_all))
        kj, kt = kj_all[-1], kt_all[-1]


@pytest.mark.parametrize("shape", [(7,), (3, 1000), (2, 2, 65), (1 << 16,)])
def test_random_bits_match_jax(shape):
    kj = jax.random.split(_jkey(42))[1]
    kt = tnoise.split(tnoise.key(42))[1]
    want = np.asarray(jax.random.bits(kj, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(tnoise.random_bits(kt, shape).numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 3.0), (-0.5, 2.0)])
def test_uniform_matches_jax(lo, hi):
    want = np.asarray(jax.random.uniform(_jkey(7), (50000,), minval=lo, maxval=hi))
    got = tnoise._uniform(tnoise.key(7), (50000,), lo, hi).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), np.abs(lo)).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp)
    assert got.min() >= lo and got.max() < hi


@pytest.mark.parametrize("low,high", [(-1.0, 1.0), (0.25, 4.0)])
def test_uniform_in_the_jax_packages_form(low, high):
    """``uniform(key, shape, *, low, high) -> (x, key)``, called as the JAX
    package's ``ops/noise.uniform`` is: the same next key and the same draw
    (within one ulp of the range)."""
    yj, kj = jnoise.uniform(_jkey(5), (3, 4000), low=low, high=high)
    yt, kt = tnoise.uniform(tnoise.key(5), (3, 4000), low=low, high=high)
    np.testing.assert_array_equal(kt.numpy(), _kd(kj))
    ulp = np.spacing(np.float32(max(abs(low), abs(high))))
    assert np.max(np.abs(yt.numpy() - np.asarray(yj))) <= ulp


def test_normal_matches_jax():
    want = np.asarray(jax.random.normal(_jkey(3), (1 << 18,)))
    _assert_normal_close(tnoise.normal(tnoise.key(3), (1 << 18,)), want)


@pytest.mark.parametrize("kind", ["gaussian", "uniform", "complex_gaussian",
                                  "triangular"])
@pytest.mark.parametrize("shape", [(4096,), (2, 3000)])
def test_noise_draws_match_jax(kind, shape):
    """The JAX package's ops/noise.py draws against the port's: same values
    within the stated tolerance, same next key."""
    kw = {"gaussian": dict(std=2.0, mean=0.5), "uniform": dict(low=-1.0, high=3.0),
          "complex_gaussian": dict(std=1.5), "triangular": dict(half_range=1.5,
                                                                 mean=0.1)}[kind]
    jf = getattr(jnoise, kind)
    tf = getattr(tnoise, kind)
    yj, kj = jf(_jkey(11), shape, **{k: jnp.float32(v) for k, v in kw.items()})
    yt, kt = tf(tnoise.key(11), shape, **kw)
    np.testing.assert_array_equal(kt.numpy(), _kd(kj))
    if kind in ("uniform", "triangular"):
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6)
    else:
        _assert_normal_close(yt, yj)


@pytest.mark.parametrize("noise,channels", [("gaussian", 0), ("uniform", 2),
                                            ("triangular", 0),
                                            ("complex_gaussian", 3)])
def test_noise_source_block_matches_jax(noise, channels):
    """NoiseSource through both schedulers, with EOS after n_samples (a
    partial last step) and the key carried across steps."""
    out = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("NoiseSource", noise=noise, channels=channels, seed=5,
                        std=0.7, mean=0.2, n_samples=5000)
        snk = g.emplace("VectorSink")
        g.connect(src, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=2048, **kw).run_and_wait()
        out.append(np.asarray(snk.data()))
    assert out[1].shape == out[0].shape and out[1].shape[-1] == 5000
    if noise in ("uniform", "triangular"):
        np.testing.assert_allclose(out[1], out[0], atol=1e-6)
    else:
        _assert_normal_close(out[1], out[0])


# -- PFB channelizer -------------------------------------------------------------

@pytest.mark.parametrize("m,p", [(4, 6), (8, 8), (256, 8)])
def test_pfb_taps_and_centers_match_jax(m, p):
    np.testing.assert_array_equal(tch.design_pfb_taps(m, p), jch.design_pfb_taps(m, p))
    np.testing.assert_array_equal(tch.channel_center_freqs(m, 1e6),
                                  jch.channel_center_freqs(m, 1e6))


def _cx(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.mark.parametrize("m,p,n", [(4, 6, 1024), (8, 8, 4096), (256, 8, 1 << 14)])
def test_pfb_analyze_and_synthesize_match_jax(rng, m, p, n):
    """Three chunks with the branch history carried, analysis then synthesis."""
    taps = jch.design_pfb_taps(m, p)
    sj = jch.pfb_init_state(m, p)
    st = tch.pfb_init_state(m, p)
    sj2, st2 = jch.pfb_init_state(m, p), tch.pfb_init_state(m, p)
    for _ in range(3):
        x = _cx(rng, n)
        yj, sj = jch.pfb_analyze(jnp.asarray(x), jnp.asarray(taps), sj)
        yt, st = tch.pfb_analyze(torch.from_numpy(x), taps, st)
        a, b = np.asarray(yj), yt.numpy()
        assert b.shape == a.shape == (m, n // m) and b.dtype == a.dtype
        np.testing.assert_allclose(b, a, atol=PFB_RTOL * np.max(np.abs(a)))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-7)
        zj, sj2 = jch.pfb_synthesize(yj, jnp.asarray(taps), sj2)
        zt, st2 = tch.pfb_synthesize(torch.from_numpy(a.copy()), taps, st2)
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj),
                                   atol=PFB_RTOL * np.max(np.abs(np.asarray(zj))))


def test_tone_lands_in_its_channel():
    m, fs, n = 8, 8000.0, 4096
    x = np.exp(2j * np.pi * 3000.0 * np.arange(n) / fs).astype(np.complex64)
    y, _ = tch.pfb_analyze(torch.from_numpy(x), tch.design_pfb_taps(m, 8),
                           tch.pfb_init_state(m, 8))
    power = np.mean(np.abs(y.numpy()[:, 32:]) ** 2, axis=-1)
    assert np.argmax(power) == 3
    assert 10 * np.log10(power[3] / np.max(np.delete(power, 3))) > 40.0


@pytest.mark.parametrize("block", ["PFBChannelizer", "PFBSynthesizer"])
def test_pfb_blocks_match_jax(rng, block):
    m = 16
    x = _cx(rng, 4, 8192) if block == "PFBSynthesizer" else _cx(rng, 3 * 8192)
    out = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.add(pkg.global_registry._factories["VectorSource"](x))
        blk = g.emplace(block, n_channels=4 if block == "PFBSynthesizer" else m,
                        taps_per_phase=6)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, blk, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=4096, **kw).run_and_wait()
        out.append(np.asarray(snk.data()))
    assert out[1].shape == out[0].shape and out[1].dtype == out[0].dtype
    np.testing.assert_allclose(out[1], out[0], atol=PFB_RTOL * np.max(np.abs(out[0])))


# -- suite config 5 end to end ----------------------------------------------------

TAG_PERIOD = 1 << 12


def _config5(pkg, sink="VectorSink", noise_source=None):
    """bench_suite.py:226-251 with TAG_PERIOD cut to 2^12, so tags fall in
    every sub-step at block_len 2^14."""
    basic = import_module(pkg.__name__ + ".blocks.basic")

    class TaggedNoise(basic.NoiseSource):
        def emit_tags(self, ctx):
            n = next(iter(ctx.out_len.values()), 0)
            lo, hi = ctx.abs_index, ctx.abs_index + n
            first = -(-lo // TAG_PERIOD) * TAG_PERIOD
            return [pkg.Tag(i - lo, {"trigger_time": float(i / 1e9)})
                    for i in range(first, hi, TAG_PERIOD)]

    g = pkg.Graph()
    src = g.add((noise_source or TaggedNoise)(noise="complex_gaussian"))
    chan = g.emplace("PFBChannelizer", n_channels=256, taps_per_phase=8)
    dem = g.emplace("QuadratureDemod", gain=1.0)
    snk = g.emplace(sink)
    g.connect_chain(src, chan, dem, snk)
    return g, snk


def test_config5_end_to_end_matches_jax():
    """Config 5 under Scheduler(pipeline_depth=2, async_delivery=True,
    batch_steps=2) at block_len 2^14 for 3 super-steps in both packages:
    demod within 1e-3 rad, tags equal (4 per sub-step, at i·16 after ÷256)."""
    out = []
    for pkg in (gr, gt):
        g, snk = _config5(pkg, "TagSink")
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=1 << 14, sample_rate=1e9, pipeline_depth=2,
                      async_delivery=True, batch_steps=2, **kw).run_and_wait(6)
        out.append((np.asarray(snk.data()),
                    [(int(t.index), dict(t.map)) for t in snk.tags]))
    (yj, tj), (yt, tt) = out
    assert yt.shape == yj.shape == (256, 6 * (1 << 14) // 256)
    assert _wrapped_err(yt, yj) <= DEMOD_ATOL
    assert tt == tj == [(i * TAG_PERIOD // 256, {"trigger_time": i * TAG_PERIOD / 1e9})
                        for i in range(6 * (1 << 14) // TAG_PERIOD)]


def test_config5_continues_from_jax_states():
    """One JAX step, then the noise key (``jax.random.key_data``), the PFB
    history [P−1, M] and the demod's carried samples go across with
    ``interop.states_from_numpy``; two more steps in the port equal two more
    in JAX."""
    bl = 1 << 14
    gj, _ = _config5(gr, "NullSink", gr.global_registry._factories["NoiseSource"])
    gp, _ = _config5(gt, "NullSink", gt.global_registry._factories["NoiseSource"])
    cj = gr.compile_graph(gj, block_len=bl, sample_rate=1e9)
    ct = gt.compile_graph(gp, block_len=bl, sample_rate=1e9, device="cpu")
    names = {bj.unique_name: bt.unique_name for bj, bt in zip(cj.order, ct.order)}
    st_j = cj.init_states()
    st_j, _ = cj.step(st_j, cj.gather_params(), {})

    def host(tree):
        return {k: (np.asarray(jax.random.key_data(v))
                    if isinstance(v, jax.Array) and jnp.issubdtype(v.dtype, jax.dtypes.prng_key)
                    else jax.tree_util.tree_map(np.asarray, v))
                for k, v in tree.items()}

    st_t = states_from_numpy(host(st_j), "cpu", names)
    noise_u = ct.order[0].unique_name
    assert st_t[noise_u].dtype == torch.int64 and st_t[noise_u].shape == (2,)
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray, cj.gather_params()),
                                 names)
    for _ in range(2):
        st_j, out_j = cj.step(st_j, cj.gather_params(), {})
        st_t, out_t = ct.step(st_t, params_t)
        (uj, vj), = out_j.items()
        assert _wrapped_err(out_t[names[uj]]["in"].numpy(), np.asarray(vj["in"])) \
            <= DEMOD_ATOL
    # the key exactly; the PFB rows [P-1, M] and the demod's carried sample
    # per channel [256] within the stated tolerances
    noise_j, pfb_j, dem_j = (b.unique_name for b in cj.order[:3])
    np.testing.assert_array_equal(st_t[noise_u].numpy(), _kd(st_j[noise_j]))
    hist_j, hist_t = np.asarray(st_j[pfb_j]), st_t[names[pfb_j]].numpy()
    assert hist_t.shape == hist_j.shape == (7, 256)
    _assert_normal_close(hist_t, hist_j)
    last_j, last_t = np.asarray(st_j[dem_j]), st_t[names[dem_j]].numpy()
    assert last_t.shape == last_j.shape == (256,) and last_t.dtype == np.complex64
    np.testing.assert_allclose(last_t, last_j, atol=PFB_RTOL * np.max(np.abs(last_j)))
