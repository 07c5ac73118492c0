"""The oversampled PFB channelizer of the port (``PFBChannelizer``'s
``oversample_rate``; ``ops/channelizer.py`` ``pfb_analyze_oversampled``) on
the CPU: against the bank's dense definition, at O = 1 bit for bit with the
critically sampled bank, in steps of any multiple of the hop, time-sharded,
its refusals, its YAML round trip and the order in which it takes its
taps."""

import numpy as np
import pytest
import torch

import gnuradio4_tpu_torch as gt
from gnuradio4_tpu_torch.blocks.channelizer import PFBChannelizer
from gnuradio4_tpu_torch.blocks.testing import VectorSink, VectorSource
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.ops import channelizer as ch
from gnuradio4_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

# float32 branch FIRs and FFT against a float64 sum: relative to the largest
# channel value
RTOL = 2e-6


def _signal(n, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _taps(m, p, seed=6):
    return np.random.default_rng(seed).standard_normal(m * p).astype(np.float32)


def dense(x, h, m, o, p):
    """``y[n, m] = Σ_{j<P, p<M} h[jM + p]·x[i]·e^{−j2π·m·i/M}``, ``i = (n+1)·D
    − M − jM + p``, D = M/O, x zero before the stream: [M, frames], float64."""
    d = round(m / o)
    x = x.astype(np.complex128)
    n_frames = len(x) // d
    k = np.arange(m)
    y = np.zeros((m, n_frames), np.complex128)
    for n in range(n_frames):
        for j in range(p):
            i = (n + 1) * d - m - j * m + np.arange(m)
            ok = i >= 0
            terms = h[j * m: (j + 1) * m][ok] * x[i[ok]]
            y[:, n] += np.exp(-2j * np.pi * np.outer(k, i[ok]) / m) @ terms
    return y


def _run(x, block_len, *, mesh=None, **settings):
    g = gt.Graph()
    src = VectorSource(x)
    pfb = PFBChannelizer(**settings)
    snk = VectorSink()
    g.connect_chain(src, pfb, snk)
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    s = gt.Scheduler(g, block_len=block_len, **kw)
    s.run_and_wait()
    return np.asarray(snk.data()), s


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("m,o", [(8, 1), (8, 2), (8, 4), (12, 1), (12, 2),
                                 (12, 4), (12, 1.5)])
def test_the_bank_follows_its_dense_definition(m, o, p):
    """Through the Scheduler, four steps chained, against the definition
    summed in float64 over the whole stream (O 1.5: a hop of 8 at M 12,
    which GNU Radio allows too)."""
    d = round(m / o)
    block = 16 * d * m
    x = _signal(4 * block)
    h = _taps(m, p)
    y, _ = _run(x, block, n_channels=m, taps_per_phase=p, oversample_rate=o,
                taps=tuple(float(v) for v in h))
    ref = dense(x, h.astype(np.float64), m, o, p)
    assert y.shape == ref.shape == (m, 4 * block // d)
    np.testing.assert_allclose(y, ref, rtol=0, atol=RTOL * np.abs(ref).max())


def test_o1_is_bitwise_the_critically_sampled_bank():
    m, p, block = 16, 6, 4096
    x = _signal(3 * block)
    y, _ = _run(x, block, n_channels=m, taps_per_phase=p, oversample_rate=1)
    h = ch.design_pfb_taps(m, p).astype(np.float32)
    st = ch.pfb_init_state(m, p)
    parts = []
    for k in range(3):
        out, st = ch.pfb_analyze(torch.from_numpy(x[k * block:(k + 1) * block]),
                                 torch.from_numpy(h), st)
        parts.append(out.numpy())
    np.testing.assert_array_equal(y, np.concatenate(parts, axis=-1))


@pytest.mark.parametrize("o", [1, 2, 4])
def test_steps_of_any_multiple_of_the_hop_chain_to_one_call(o):
    """At O = 1 through ``pfb_analyze`` and its row state [P−1, M]."""
    m, p = 12, 4
    d = m // o
    x = torch.from_numpy(_signal(40 * d))
    h = torch.from_numpy(_taps(m, p))
    if o == 1:
        init, step = (lambda: ch.pfb_init_state(m, p)), \
            (lambda xs, st: ch.pfb_analyze(xs, h, st))
    else:
        init, step = (lambda: ch.pfb_os_init_state(m, p, d)), \
            (lambda xs, st: ch.pfb_analyze_oversampled(xs, h, st, m, d))
    whole, _ = step(x, init())
    st, parts, at = init(), [], 0
    for frames in (3, 5, 1, 7, 2, 9, 13):
        y, st = step(x[at:at + frames * d], st)
        parts.append(y)
        at += frames * d
    assert at == x.shape[0]
    chained = torch.cat(parts, dim=-1)
    if o == 1:
        assert st.shape == (p - 1, m)
        torch.testing.assert_close(st, x[-(p - 1) * m:].reshape(p - 1, m),
                                   rtol=0, atol=0)
    else:
        assert int(st["frame"]) == 40 % ch.shift_period(m, d)
    torch.testing.assert_close(chained, whole, rtol=0,
                               atol=RTOL * float(whole.abs().max()))


@pytest.mark.parametrize("o", [1, 2])
def test_the_time_sharded_bank_equals_the_unsharded_one(o):
    """Scheduler(mesh=) over 4 time shards: the halo lowering with each
    shard's frame index from its global position."""
    m, p = 16, 4
    block = 4 * 1024
    x = _signal(3 * block)
    kw = dict(n_channels=m, taps_per_phase=p, oversample_rate=o)
    whole, _ = _run(x, block, **kw)
    mesh = make_mesh((4,), ("sp",), devices=[torch.device("cpu")] * 4)
    sharded, s = _run(x, block, mesh=mesh, **kw)
    assert s.compiled.sp_plan[next(k for k in s.compiled.sp_plan
                                   if k.startswith("PFBChannelizer"))] == "halo"
    assert next(v for k, v in s.compiled.sp_halos.items()
                if k.startswith("PFBChannelizer")) == p * m - m // o
    np.testing.assert_allclose(sharded, whole, rtol=0,
                               atol=RTOL * np.abs(whole).max())


@pytest.mark.parametrize("m,o", [(10, 3), (10, 4), (8, 16), (12, 5)])
def test_a_hop_that_is_not_whole_is_refused(m, o):
    with pytest.raises(GrError, match="oversample_rate"):
        PFBChannelizer(n_channels=m, taps_per_phase=4, oversample_rate=o)


def test_oversample_rate_survives_yaml():
    m, block = 8, 2048
    x = _signal(2 * block)
    g = gt.Graph()
    pfb = PFBChannelizer(name="pfb", n_channels=m, taps_per_phase=4,
                         oversample_rate=4)
    g.connect_chain(VectorSource(x, name="src"), pfb, VectorSink(name="snk"))
    text = gt.save_grc(g)
    g2 = gt.load_grc(text)
    blocks = {b.name: b for b in g2.blocks}
    assert blocks["pfb"].settings.get("oversample_rate") == 4
    assert blocks["pfb"].ratio == 1 / 2 and blocks["pfb"].alignment == 2
    assert gt.save_grc(g2) == text
    # the loaded block runs the same bank
    want, _ = _run(x, block, n_channels=m, taps_per_phase=4, oversample_rate=4)
    g3 = gt.Graph()
    snk = VectorSink()
    g3.connect_chain(VectorSource(x), blocks["pfb"], snk)
    gt.Scheduler(g3, block_len=block, device="cpu").run_and_wait()
    np.testing.assert_array_equal(np.asarray(snk.data()), want)


@pytest.mark.parametrize("o", [1, 2])
def test_a_channel_is_the_prototype_with_each_block_reversed(o):
    """The bank gives branch p the samples x[nM + p] with the taps h[jM + p],
    the other way round from GNU Radio's ``pfb_channelizer_ccf``. A prototype
    handed over with each block of M taps reversed makes every channel the
    prototype's own filter: a tone f off a channel's centre comes out at
    |H(f)|. Handed over in GNU Radio's order, each block acts mirrored in
    time and the response is another."""
    m, p, k = 8, 6, 3
    h = ch.design_pfb_taps(m, p).astype(np.float64)
    reversed_blocks = h.reshape(p, m)[:, ::-1].reshape(-1)
    n = 256 * m
    for f in (0.0, 0.2 / m, -0.35 / m, 0.45 / m):
        x = np.exp(2j * np.pi * (k / m + f) * np.arange(n)).astype(np.complex64)
        want = abs(np.sum(h * np.exp(-2j * np.pi * f * np.arange(m * p))))
        got = {}
        for name, taps in (("reversed", reversed_blocks), ("as designed", h)):
            y, _ = _run(x, n, n_channels=m, taps_per_phase=p, oversample_rate=o,
                        taps=tuple(float(v) for v in taps))
            got[name] = np.abs(y[k, 2 * p * o:])
        np.testing.assert_allclose(got["reversed"], want, rtol=1e-5, atol=0)
        if f:
            assert np.abs(got["as designed"] - want).max() > 0.01 * want
