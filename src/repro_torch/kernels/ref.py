"""Plain PyTorch versions of the CUDA kernels (``repro.kernels.ref``).

They define the exact semantics the kernels reproduce. ``ops`` runs them
for tensors on the CPU; ``chip_smoke.py`` holds each kernel against them
on the card, bit for bit. Nothing on the main path calls them when a card
is present.

Arithmetic follows the JAX oracles operation by operation: Python-float
scalars become float32 (``1 - beta`` is folded in double first, as JAX
folds the constant), and every product and sum is rounded on its own,
never fused. As XLA does, each float32 / bf16 operand and each result of
arithmetic is flushed to a zero of its sign when it is subnormal
(``sign_compress.flush_subnormals``; the kernels get the same from
``-ftz=true``); the comparisons read subnormals as zeros through
``sign_compress.nonneg`` / ``sign_ternary``.
"""
from __future__ import annotations

import torch

from repro_torch.core import sign_compress as sc


def momentum_constants(beta: float, dtype: torch.dtype) -> tuple[float, float]:
    """(beta, 1 - beta) as the reference computes ``beta * m + (1 - beta) *
    g`` for momentum of `dtype`: 1 - beta folded in double, both rounded to
    float32 and, for bf16 momentum, on to bf16 (JAX's weakly typed Python
    constants take the array's type: 0.9 -> 0.8984375)."""
    consts = torch.tensor([beta, 1.0 - beta], dtype=torch.float32)
    return tuple(consts.to(dtype).tolist())


def momentum_sign_pack(g: torch.Tensor, m: torch.Tensor, beta: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """SIGNUM worker-side hot loop: m' = beta*m + (1-beta)*g in m's dtype;
    packed = pack(m' >= 0). g/m (..., 32*w). Returns (m', packed).

    float32 m: each product and the sum rounded to float32. bf16 m: g
    rounded to bf16, the constants too (:func:`momentum_constants`), each
    product and the sum rounded to bf16 on its own, as JAX rounds a bf16
    expression (one rounding of the float32 expression differs from it on
    about a third of the elements)."""
    b, c = momentum_constants(beta, m.dtype)
    f = sc.flush_subnormals
    if m.dtype == torch.float32:
        m_new = f(f(b * f(m)) + f(c * f(g.to(m.dtype))))
    else:
        # each bf16 operation in float32 (exact for the bf16 operands),
        # flushed, then rounded to bf16: a product that is subnormal in
        # float32 is 0, even where its bf16 rounding would reach 2^-126
        def bf16(x):
            return x.to(torch.bfloat16).float()
        gb = bf16(g.float())
        m_new = f(bf16(f(b * f(m.float()))) + bf16(f(c * f(gb)))).to(m.dtype)
    return m_new, sc.pack_signs(m_new)


def bitpack(x: torch.Tensor) -> torch.Tensor:
    """(rows, 32*w) real -> (rows, w) words; bit j of word k is
    ``x[., 32k + j] >= 0`` (a subnormal reads as a zero)."""
    return sc.pack_signs(x)


def bitunpack(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(rows, w) words -> (rows, 32*w) of ±1 in `dtype`."""
    return sc.unpack_signs(packed, dtype)


def fused_majority(x: torch.Tensor) -> torch.Tensor:
    """(M, n) real, n % 32 == 0 -> (n // 32,) packed majority: the
    composed sign + pack + popcount the fused kernel does in one pass."""
    return sc.packed_majority(sc.pack_signs(x))


def majority(packed: torch.Tensor) -> torch.Tensor:
    """(M, w) packed -> (w,) packed majority (ties -> +1)."""
    return sc.packed_majority(packed)


def ternary_pack(x: torch.Tensor) -> torch.Tensor:
    """(rows, 16*w) int8 symbols or f32/bf16 values -> (rows, w) words of
    2-bit fields: +1 -> 0b01, -1 -> 0b11, 0 -> 0b00 (codec
    ``ternary2bit``). An int8 symbol s is stored as ``s & 3``; a real value
    as its ``sign_ternary`` (+0.0, -0.0 and subnormals abstain)."""
    return sc.pack_ternary(x if x.dtype == torch.int8 else sc.sign_ternary(x))


def ternary_unpack(packed: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """(rows, w) words -> (rows, 16*w) of {-1, 0, +1} in `dtype`."""
    return sc.unpack_ternary(packed, dtype)


def ternary_majority(packed: torch.Tensor, ties: str = "zero"
                     ) -> torch.Tensor:
    """(M, w) packed ternary -> (w,) packed ternary majority (sign of the
    symbol sum: abstentions abstain; ties -> 0, or with ``ties="plus_one"``
    ``sign_binary`` of the sum: ties and all-abstain -> +1)."""
    return sc.ternary_majority(packed, ties)


def apply_vote(p: torch.Tensor, votes_packed: torch.Tensor, eta: float,
               weight_decay: float) -> torch.Tensor:
    """x <- x - eta*(unpack(vote) + lambda*x) in float32, cast back;
    p (..., 32*w), votes_packed (..., w)."""
    return _update(p, sc.unpack_signs(votes_packed, torch.float32), eta,
                   weight_decay)


def _update(p: torch.Tensor, v: torch.Tensor, eta: float,
            weight_decay: float) -> torch.Tensor:
    """p - eta*(v + lambda*p) in float32, each operand and result flushed,
    cast back to p's dtype."""
    f = sc.flush_subnormals
    # the scalars are float32 operands too (the kernel takes them as such)
    eta, weight_decay = (float(f(torch.tensor(s, dtype=torch.float32)))
                         for s in (eta, weight_decay))
    p32 = f(p.to(torch.float32))
    return f(p32 - f(eta * f(v + f(weight_decay * p32)))).to(p.dtype)


def apply_ternary_vote(p: torch.Tensor, votes_packed: torch.Tensor,
                       eta: float, weight_decay: float) -> torch.Tensor:
    """``apply_vote`` with a 2-bit ternary vote: x <- x - eta*(v +
    lambda*x), v in {-1, 0, +1}; p (..., 16*w), votes_packed (..., w)."""
    return _update(p, sc.unpack_ternary(votes_packed, torch.float32), eta,
                   weight_decay)
