"""The algebra of the ``iir_sos`` kernel's chunked state-space scan, on the CPU.

The kernel (csrc/iir_sos.cu) runs only on the card. Its host matrices
(``sos_step_matrix``, ``sos_chunk_transition``, ``sos_chunk_powers``) and a
plain PyTorch version of its algorithm (``sos_chunked_ref``: zero-state
chunks, the carry with the host's powers of Φ, the rerun) live in
ops/iir.py; here they are held against L steps of the plain loop and against
the JAX package's Pallas kernel in interpret mode, on the same NumPy-seeded
inputs.

Tolerances are relative to the output's RMS. The chunked scan is the serial
loop's algebra, so where the design forgets its state within a chunk the two
agree to SEQ_RTOL. A narrow-band design amplifies f32 rounding: there the
plain loop itself sits ~4e-4 of the RMS from float64, and the chunked scan is
held to at most twice the plain loop's own error against float64.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gnuradio4_tpu.ops.pallas_kernels import iir_sos_pallas

from gnuradio4_tpu_torch.ops import cuda_kernels as ck
from gnuradio4_tpu_torch.ops import filter_design as tfd
from gnuradio4_tpu_torch.ops import iir as tiir

torch.set_num_threads(2)

# f32 recursions in the same update order: a few ulps of the signal
SEQ_RTOL = 1e-5
# Φ (f32) against L float64 steps of the loop, relative to max|Φ|: one f32
# rounding of each entry
PHI_RTOL = 1e-6
# chunk lengths that leave a partial last chunk at every T below; at L = 9 the
# carry matters even for designs that forget their state within 96 samples
L = 96
L_SHORT = 9


def _rms_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if want.size == 0:
        return 0.0
    scale = max(float(np.sqrt(np.mean(want ** 2))), 1e-3)
    return float(np.max(np.abs(got - want))) / scale


def _design(kind: str) -> np.ndarray:
    if kind == "bw5":
        return tfd.design_iir("butterworth", "lowpass", 5, sample_rate=48e3,
                              f_low=15e3).sos
    if kind == "bw4_2k":           # poles near 1: f32 rounding amplified
        return tfd.design_iir("butterworth", "lowpass", 4, sample_rate=48e3,
                              f_low=2e3).sos
    if kind == "narrow":           # Butterworth 5 at 200 Hz: poles near 1
        return tfd.design_iir("butterworth", "lowpass", 5, sample_rate=48e3,
                              f_low=200.0).sos
    if kind == "cheby2":
        return tfd.design_iir("chebyshev1", "lowpass", 2, sample_rate=50.0,
                              f_low=5.0).sos
    if kind == "bw33":             # 17 sections, two groups; high-Q poles
        return tfd.design_iir("butterworth", "lowpass", 33, sample_rate=48e3,
                              f_low=6e3).sos
    raise ValueError(kind)


def _pallas(x, sos, s0):
    y, s = jax.jit(lambda v, s: iir_sos_pallas(v, sos, s, interpret=True))(
        jnp.asarray(x), jnp.asarray(s0))
    return np.asarray(y), np.asarray(s)


def _inputs(rng, ch, t, n_sec, state_scale=0.1):
    shape = (t,) if ch == 0 else (ch, t)
    x = rng.standard_normal(shape).astype(np.float32)
    s0 = (state_scale * rng.standard_normal((*shape[:-1], n_sec, 2))
          ).astype(np.float32)
    return x, s0


# -- the host matrices -------------------------------------------------------------

@pytest.mark.parametrize("kind,chunk", [("bw5", 128), ("bw4_2k", 100),
                                        ("narrow", 128), ("cheby2", 37),
                                        ("bw33", 64)])
def test_chunk_transition_is_chunk_steps_of_the_plain_loop(kind, chunk):
    """Φ = A^L equals ``chunk`` steps of the plain loop (in float64, with the
    same f32-rounded coefficients) from each unit state, within one f32
    rounding of its entries."""
    sos = _design(kind)
    co = tiir.sos_coefficients(sos)
    n = 2 * co.shape[0]
    phi = tiir.sos_chunk_transition(co, chunk)
    assert phi.shape == (n, n) and phi.dtype == np.float32
    unit = torch.eye(n, dtype=torch.float64).reshape(n, n // 2, 2)
    _, end = tiir.sos_apply(torch.zeros(n, chunk, dtype=torch.float64), sos, unit)
    steps = end.reshape(n, n).T.numpy()       # column i: from unit state e_i
    scale = max(float(np.abs(steps).max()), 1e-30)
    assert float(np.abs(phi - steps).max()) <= PHI_RTOL * scale


@pytest.mark.parametrize("kind", ["bw5", "narrow", "bw33"])
def test_chunk_powers_are_repeated_squares(kind):
    """sos_chunk_powers[j] is Φ^(2^j) (float64 squarings, rounded once),
    read-only and cached per coefficient set."""
    co = tiir.sos_coefficients(_design(kind))
    pw = tiir.sos_chunk_powers(co, 128)
    assert pw.shape == (tiir.SOS_CARRY_LEVELS, 2 * co.shape[0], 2 * co.shape[0])
    assert not pw.flags.writeable and tiir.sos_chunk_powers(co, 128) is pw
    np.testing.assert_array_equal(pw[0], tiir.sos_chunk_transition(co, 128))
    phi64 = np.linalg.matrix_power(tiir.sos_step_matrix(co), 128)
    for j in (1, 3, 5):
        want = np.linalg.matrix_power(phi64, 2 ** j)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(pw[j] - want).max()) <= PHI_RTOL * scale


def test_carry_table_holds_each_group_in_order():
    """The kernel's ``phi`` argument: per group of 16 sections, its powers."""
    co = tiir.sos_coefficients(_design("bw33"))
    table = ck.sos_carry_table(co)
    g0 = tiir.sos_chunk_powers(co[:16]).ravel()
    g1 = tiir.sos_chunk_powers(co[16:]).ravel()
    assert table.shape == (g0.size + g1.size,) and not table.flags.writeable
    np.testing.assert_array_equal(table, np.concatenate([g0, g1]))


# -- the chunked algorithm against the JAX package's kernel --------------------------

@pytest.mark.parametrize("chunk", [L, L_SHORT])
@pytest.mark.parametrize("t", [777, 4096, 5000, 50])
@pytest.mark.parametrize("ch", [0, 4])
@pytest.mark.parametrize("kind", ["bw5", "cheby2"])
def test_chunked_ref_matches_pallas(rng, kind, ch, t, chunk):
    """Zero-state chunks (a partial last chunk at every T; T = 50 is shorter
    than L = 96), the carry, the rerun: y and the state against the Pallas
    kernel in interpret mode."""
    sos = _design(kind)
    x, s0 = _inputs(rng, ch, t, sos.shape[0])
    yj, sj = _pallas(x, sos, s0)
    yt, st = tiir.sos_chunked_ref(torch.from_numpy(x), sos, torch.from_numpy(s0),
                                  chunk)
    assert yt.shape == yj.shape and st.shape == sj.shape
    assert _rms_err(yt.numpy(), yj) <= SEQ_RTOL
    assert _rms_err(st.numpy(), sj) <= SEQ_RTOL


@pytest.mark.parametrize("chunk", [128, L_SHORT])
def test_chunked_ref_17_sections_two_groups_matches_pallas(rng, chunk):
    """17 Chebyshev sections: two groups, the second filtering the first's
    output, at T 1000, with the kernel's own L = 128 and with L = 9."""
    sos = np.tile(_design("cheby2"), (17, 1))
    x, s0 = _inputs(rng, 2, 1000, sos.shape[0])
    yj, sj = _pallas(x, sos, s0)
    yt, st = tiir.sos_chunked_ref(torch.from_numpy(x), sos, torch.from_numpy(s0),
                                  chunk)
    assert _rms_err(yt.numpy(), yj) <= SEQ_RTOL
    assert _rms_err(st.numpy(), sj) <= SEQ_RTOL


def test_chunked_ref_two_calls_with_the_state_carried(rng):
    """A stream cut into two calls with the state carried agrees with one call
    and with the Pallas kernel within SEQ_RTOL (the chunk grid starts at each
    call's first sample, so the rounding differs)."""
    sos = _design("cheby2")
    x, s0 = _inputs(rng, 4, 3000, sos.shape[0])
    one, st_one = tiir.sos_chunked_ref(torch.from_numpy(x), sos,
                                       torch.from_numpy(s0), L_SHORT)
    y1, st = tiir.sos_chunked_ref(torch.from_numpy(x[:, :1234]), sos,
                                  torch.from_numpy(s0), L_SHORT)
    y2, st = tiir.sos_chunked_ref(torch.from_numpy(x[:, 1234:]), sos, st, L_SHORT)
    two = torch.cat([y1, y2], -1).numpy()
    yj, sj = _pallas(x, sos, s0)
    assert _rms_err(two, one.numpy()) <= SEQ_RTOL
    assert _rms_err(st.numpy(), st_one.numpy()) <= SEQ_RTOL
    assert _rms_err(two, yj) <= SEQ_RTOL and _rms_err(st.numpy(), sj) <= SEQ_RTOL


@pytest.mark.parametrize("kind,ch,t,chunk", [("narrow", 2, 1 << 15, 128),
                                             ("bw4_2k", 4, 5000, L),
                                             ("bw4_2k", 0, 4096, L_SHORT),
                                             ("bw33", 2, 1000, L_SHORT)])
def test_chunked_ref_within_twice_the_plain_loop_against_float64(rng, kind, ch,
                                                                 t, chunk):
    """Designs whose poles sit near the unit circle, where the carry matters
    most and f32 rounding is amplified: Butterworth 5 at 200 Hz of 48 kHz (the
    plain loop ~4e-4 of the RMS from float64), Butterworth 4 at 2 kHz
    (~1e-5) and Butterworth 33 (17 sections, two groups). Against scipy's float64 sosfilt, the chunked scan's error is at
    most twice the Pallas kernel's (the plain loop's), and the two f32 results
    differ by at most the sum of their errors."""
    signal = pytest.importorskip("scipy.signal")
    sos = _design(kind)
    x, s0 = _inputs(rng, ch, t, sos.shape[0], state_scale=0.0)
    yj, _ = _pallas(x, sos, s0)
    yt, _ = tiir.sos_chunked_ref(torch.from_numpy(x), sos, torch.from_numpy(s0),
                                 chunk)
    want = signal.sosfilt(sos, x.astype(np.float64), axis=-1)
    err, err_plain = _rms_err(yt.numpy(), want), _rms_err(yj, want)
    print(f"{kind}: against float64, chunked {err:.3e}, plain loop {err_plain:.3e}")
    assert err <= 2 * err_plain
    assert _rms_err(yt.numpy(), yj) <= err + err_plain


@pytest.mark.parametrize("shape", [(0, 300), (3, 0), (0,)])
def test_chunked_ref_empty_streams(shape):
    """No channels or no samples: y is empty and the state passes through."""
    sos = _design("bw5")
    x = torch.zeros(shape)
    s0 = torch.randn(*shape[:-1], sos.shape[0], 2, generator=torch.Generator().manual_seed(3))
    y, st = tiir.sos_chunked_ref(x, sos, s0)
    assert y.shape == x.shape
    torch.testing.assert_close(st, s0, rtol=0, atol=0)
