"""The precision ladder of the matmul FIR and FFT (the JAX package's
``ops/fir.py`` ``_banded_dot`` / ``_fir_matmul_int8`` and ``ops/fft.py``
``_cx_dot``).

The TPU runs its float32 matmuls as bf16 passes; the rungs name the pass
count. On the card each rung keeps that pass structure, with bf16
tensor-core operands and float32 results (no process-wide TF32 flag is
touched):

- ``highest``: full float32 (the plain ``torch.matmul``, TF32 refused by
  ``check_f32_matmul``);
- ``high``: bf16×3, ``hi·hi + hi·lo + lo·hi`` with ``lo = x − hi``;
- ``default`` and ``bf16``: one bf16 pass;
- ``int8``: int8 × int8 → int32 through ``torch._int_mm``.

On the CPU the rungs give the JAX package's CPU results: ``default`` and
``high`` are exact float32 (XLA's CPU backend has no reduced passes),
``bf16`` is bf16-rounded operands with float32 accumulation, ``int8`` is
exact integer accumulation. :func:`rung_dot` alone decides which of the two
a product takes; :func:`card_dot` is the card's formulation on any device
(on the CPU an emulation: products of the bf16 operands are exact in
float32, the sums are float32).
"""

from __future__ import annotations

import torch

from ..core.errors import GrError

RUNGS = ("default", "high", "highest", "bf16")


def check_f32_matmul(site: str) -> None:
    """The plain FIR's banded products and the blocked one-pole's Toeplitz
    product (ops/iir.py) are float32 or complex64 matmuls; TF32 would keep ~3
    decimal digits. Refuse to run under any setting that allows it."""
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise GrError(f"{site}: float32 matmuls must run in full float32 "
                      f"(torch.get_float32_matmul_precision() == 'highest' and "
                      f"torch.backends.cuda.matmul.allow_tf32 False); got "
                      f"{torch.get_float32_matmul_precision()!r}, allow_tf32="
                      f"{torch.backends.cuda.matmul.allow_tf32}")


def bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[m, k] @ [k, n] with both operands rounded to bf16 and a float32
    result. On CUDA one tensor-core pass (``torch.mm(..., out_dtype=
    torch.float32)``; a torch without it raises rather than running the rung
    at another precision); on the CPU the float32 product of the rounded
    operands."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if not a.is_cuda:
        return a16.to(torch.float32) @ b16.to(torch.float32)
    try:
        return torch.mm(a16, b16, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError) as e:
        raise GrError(f"bf16 precision rung: this torch ({torch.__version__}) "
                      f"cannot multiply bf16 operands into a float32 result "
                      f"on the card (torch.mm(out_dtype=torch.float32)): "
                      f"{type(e).__name__}: {e}") from e


def card_dot(a: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """``a`` [..., j] float32 @ ``w`` [j, i] float32 → [..., i] float32 in
    the card's formulation of the rung ``mode``: ``highest`` full float32,
    ``high`` three bf16 passes, ``default``/``bf16`` one (:func:`bf16_mm`)."""
    if mode == "highest":
        check_f32_matmul("precision rung 'highest'")
        return a @ w
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if mode == "high":
        a_hi = a2.to(torch.bfloat16).to(torch.float32)
        w_hi = w.to(torch.bfloat16).to(torch.float32)
        y = (bf16_mm(a_hi, w_hi) + bf16_mm(a_hi, w - w_hi)
             + bf16_mm(a2 - a_hi, w_hi))
    else:
        y = bf16_mm(a2, w)
    return y.reshape(*lead, w.shape[-1])


def rung_dot(a: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """``a`` [..., j] float32 @ ``w`` [j, i] float32 → [..., i] float32 at the
    rung ``mode``: :func:`card_dot` on a CUDA tensor; on the CPU the JAX
    package's CPU results (``default``/``high`` exact float32, ``bf16`` the
    rounded operands with float32 sums)."""
    if mode not in RUNGS:
        raise GrError(f"unknown precision rung {mode!r}; known: {RUNGS}")
    if not a.is_cuda and mode in ("default", "high"):
        mode = "highest"
    return card_dot(a, w, mode)


def quant_rows(frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 quantization, in the JAX package's float32 ops:
    scale = max(max|row| / 127, 1e-20), q = round(row / scale) (half to
    even). Returns (int8 q, float32 scale [..., 1])."""
    row_max = torch.amax(torch.abs(frames), dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, which moves scales by an ulp and flips roundings
    row_scale = torch.clamp(row_max / torch.full_like(row_max, 127.0),
                            min=1e-20)
    return torch.round(frames / row_scale).to(torch.int8), row_scale


def int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 [m, k] @ int8 [k, n] → exact int32. On CUDA ``torch._int_mm``,
    which wants m > 16 and k, n multiples of 8: the operands are padded with
    zero rows and columns, which adds nothing to the sums. On the CPU an
    int32 matmul."""
    if not a.is_cuda:
        return a.to(torch.int32) @ w.to(torch.int32)
    m, k = a.shape
    n = w.shape[1]
    pm, pk, pn = max(0, 17 - m), (-k) % 8, (-n) % 8
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        w = torch.nn.functional.pad(w, (0, pn, 0, pk))
    try:
        y = torch._int_mm(a.contiguous(), w.contiguous())
    except (AttributeError, RuntimeError) as e:
        raise GrError(f"int8 precision rung: torch._int_mm failed on the "
                      f"card: {type(e).__name__}: {e}") from e
    return y[:m, :n]
