"""The port's LDPC code construction, both min-sum decoder forms and the two
LDPC blocks against the JAX package and ``decode_np``, on the CPU.

Tolerances: H, G and codewords exact (the same host NumPy). Hard bits and
syndrome flags exact at 2 dB and 4 dB: the decoders run the same schedule in
float32; a message sum taken in another order moves a posterior by ~1e-6, which
flips a hard bit only at a posterior within that of zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.ops import ldpc as jl
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.ops import ldpc as tl

torch.set_num_threads(2)


@pytest.mark.parametrize("n,m,wc,seed", [(96, 48, 3, 2), (256, 128, 3, 0),
                                         (120, 40, 4, 5)])
def test_make_ldpc_and_encode_match_jax(n, m, wc, seed):
    hj, gj = jl.make_ldpc(n, m, wc=wc, seed=seed)
    ht, g_t = tl.make_ldpc(n, m, wc=wc, seed=seed)
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(g_t, gj)
    u = np.random.default_rng(seed).integers(0, 2, (9, gj.shape[0]))
    np.testing.assert_array_equal(tl.encode(g_t, u), jl.encode(gj, u))
    with pytest.raises(GrError):
        tl.make_ldpc(10, 10)


def _channel(snr_db, n_frames, seed, n=256, m=128):
    """BPSK over AWGN at ``snr_db`` Eb/N0 (rate k/n), as tests/test_ldpc.py
    makes it: (H, k, u, c, llr)."""
    H, G = tl.make_ldpc(n, m, wc=3, seed=1)
    k = G.shape[0]
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (n_frames, k)).astype(np.uint8)
    c = tl.encode(G, u)
    sigma = np.sqrt(1.0 / (2 * 10 ** (snr_db / 10) * k / n))
    y = 1.0 - 2.0 * c + sigma * rng.standard_normal(c.shape)
    return H, k, u, c, (2 * y / sigma ** 2).astype(np.float32)


@pytest.mark.parametrize("snr_db", [2.0, 4.0])
@pytest.mark.parametrize("form", ["segment", "dense"])
def test_decoders_match_jax_and_decode_np(form, snr_db):
    H, k, u, c, llr = _channel(snr_db, 24, seed=int(snr_db))
    fn = tl.min_sum_decode if form == "segment" else tl.min_sum_decode_dense
    bits, ok = fn(tl.LdpcGraph(H), torch.from_numpy(llr), 25)
    assert bits.dtype == torch.uint8 and ok.dtype == torch.bool
    jfn = jl.min_sum_decode if form == "segment" else jl.min_sum_decode_dense
    bj, okj = jfn(jl.LdpcGraph(H), jnp.asarray(llr), 25)
    bn, okn = tl.decode_np(H, llr, 25)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(bits.numpy(), bn)
    np.testing.assert_array_equal(ok.numpy(), okn)
    if snr_db == 4.0:          # past the waterfall: every frame corrects
        assert ok.all() and np.array_equal(bits.numpy()[:, :k], u)
    else:                      # before it: some frames fail their syndrome
        assert not ok.all()


def test_decode_np_matches_jax_copy():
    H, _, _, _, llr = _channel(3.0, 6, seed=7, n=96, m=48)
    for a, b in zip(tl.decode_np(H, llr, 12), jl.decode_np(H, llr, 12)):
        np.testing.assert_array_equal(a, b)


def test_decode_takes_the_segment_form_on_the_cpu():
    H, _, _, _, llr = _channel(2.0, 4, seed=3)
    g = tl.LdpcGraph(H)
    x = torch.from_numpy(llr)
    for a, b in zip(tl.decode(g, x, 10), tl.min_sum_decode(g, x, 10)):
        assert torch.equal(a, b)
    once, again = g.on("cpu"), g.on(torch.device("cpu"))     # uploaded once
    assert all(once[k] is again[k] for k in once)
    with pytest.raises(GrError, match="n_iters"):
        tl.decode(g, x, 0)


def test_garbage_flags_bad_syndrome():
    H, _ = tl.make_ldpc(96, 48, seed=1)
    llr = np.random.default_rng(3).standard_normal((4, 96)).astype(np.float32)
    for fn in (tl.min_sum_decode, tl.min_sum_decode_dense):
        _, ok = fn(tl.LdpcGraph(H), torch.from_numpy(llr), 10)
        assert not ok.all()


def _llr_stream(n_frames, seed, sigma=0.6):
    """Encoded BPSK LLRs of the code (256, 128, seed 0), as
    bench_suite.py:290-297 makes config 7's input."""
    H, G = tl.make_ldpc(256, 128, wc=3, seed=0)
    k = G.shape[0]
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, n_frames * k).astype(np.uint8)
    c = tl.encode(G, u.reshape(-1, k)).reshape(-1)
    y = 1.0 - 2.0 * c + sigma * rng.standard_normal(len(c))
    return u.astype(np.float32), (2 * y / sigma ** 2).astype(np.float32)


def test_decoder_block_through_both_schedulers():
    """Config 7's shape at 8 frames: VectorSource → LdpcDecoder → VectorSink
    under Scheduler(pipeline_depth=2, async_delivery=True) in both packages."""
    u, llr = _llr_stream(8, seed=1)
    out = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("VectorSource", device_resident=True)
        src.data = llr
        dec = g.emplace("LdpcDecoder", n=256, m=128, seed=0)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, dec, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=512, sample_rate=1e6, pipeline_depth=2,
                      async_delivery=True, **kw).run_and_wait()
        out.append(np.asarray(snk.data()))
    np.testing.assert_array_equal(out[1], out[0])
    np.testing.assert_array_equal(out[1], u)


def test_encoder_decoder_chain_through_scheduler():
    """bits → LdpcEncoder → {0,1} → ±8 LLR → LdpcDecoder → bits in the port."""
    u, _ = _llr_stream(4, seed=2)
    g = gt.Graph()
    src = g.emplace("VectorSource")
    src.data = u
    enc = g.emplace("LdpcEncoder", n=256, m=128, seed=0)
    scale = g.emplace("MultiplyConst", value=-16.0)
    off = g.emplace("AddConst", value=8.0)
    dec = g.emplace("LdpcDecoder", n=256, m=128, seed=0)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, enc, scale, off, dec, snk)
    gt.Scheduler(g, block_len=256, sample_rate=1e6, device="cpu").run_and_wait()
    np.testing.assert_array_equal(snk.data(), u)
    assert enc.alignment == enc.k and dec.alignment == 256
    assert float(enc.ratio) * float(dec.ratio) == 1.0


def test_encoder_block_matches_jax():
    u, _ = _llr_stream(3, seed=4)
    out = []
    for pkg in (gr, gt):
        blk = pkg.global_registry.create("LdpcEncoder", n=256, m=128, seed=0)
        to = jnp.asarray if pkg is gr else torch.from_numpy
        out.append(np.asarray(blk.apply(None, {"in": to(u)}, None)[1]["out"]))
    np.testing.assert_array_equal(out[1], out[0])
