"""Sign extraction and 1-bit packing (plain PyTorch; ``repro.core.sign_compress``).

Two sign conventions coexist (DESIGN.md §5): ``sign_ternary`` (0 -> 0,
the count wires' abstention) and ``sign_binary`` (``x >= 0 -> +1``, the
1-bit wire). Besides them: zero-padding to the pack width, pack/unpack and
the bit-sliced majority, and the ``ternary2bit`` codec's 2-bit format
(``pack_ternary`` / ``unpack_ternary`` / ``ternary_majority``).

Packing is 32 signs per word, little-endian within the word: bit j of word
k is ``x[32k + j] >= 0``. Words are carried as **int32 bit patterns**
(PyTorch has no shifts on uint32 tensors on the CPU); bit 31 is the sign
bit, and every right shift is masked with ``& 1`` so the arithmetic shift
never leaks. View them as ``np.uint32`` only at the numpy boundary.

The 2-bit format packs 16 ternary symbols per word, little-endian, in
two's-complement fields: +1 -> ``0b01``, -1 -> ``0b11``, 0 (abstain) ->
``0b00``. Field 15 sits in bits 30-31, so its right shift is masked with
``& 3`` like every other.

Subnormals. The JAX package reads a float32 or bf16 subnormal operand of
arithmetic or of a comparison as a zero of its own sign, and flushes a
subnormal result of arithmetic to a zero of its sign: XLA does so on the
CPU, and a TPU has no subnormals at all. Conversions and stores keep the
bits (float32 ``1e-39`` cast to bf16 stays subnormal). So ``sign_ternary``
of a subnormal is 0 and ``sign_binary`` of a negative one is +1, and every
plain version and codec op that computes with floats flushes through
:func:`flush_subnormals` (the CUDA kernels are built with ``-ftz=true``).
float16 and float64 keep their subnormals, as XLA's float32 arithmetic
sees them (a float16 subnormal is a normal float32).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

PACK = 32
#: ternary symbols per word (2 bits each; codec ``ternary2bit``)
PACK2 = 16
WORD_DTYPE = torch.int32
#: float types whose subnormals the JAX package reads and writes as zeros
FLUSHED = (torch.float32, torch.bfloat16)


def flush_subnormals(x: torch.Tensor, out: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """`x` with every float32 / bf16 subnormal replaced by a zero of its own
    sign (``x * 0``; every other value times 1, exactly); other dtypes pass
    through. `out` (may be `x`, for an in-place flush) receives the
    result when given."""
    if x.dtype not in FLUSHED:
        return x if out is None else out.copy_(x)
    return torch.mul(x, x.abs() >= torch.finfo(x.dtype).tiny, out=out)


def sign_ternary(x: torch.Tensor, out: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The sign as int8: 0, -0.0 and (float32 / bf16) a subnormal -> 0, an
    abstention. `out` (int8, x's shape) receives it when given."""
    if x.dtype not in FLUSHED:
        s = torch.sign(x).to(torch.int8)
        return s if out is None else out.copy_(s)
    tiny = torch.finfo(x.dtype).tiny
    # (x >= tiny) - (x <= -tiny), the two masks read as int8 in place
    pos = (torch.ge(x, tiny) if out is None
           else torch.ge(x, tiny, out=out.view(torch.bool)))
    return pos.view(torch.int8).sub_(torch.le(x, -tiny).view(torch.int8))


def sign_binary(x: torch.Tensor) -> torch.Tensor:
    """``x >= 0 -> +1`` else ``-1``, as int8 (ties go to +1; a float32 /
    bf16 subnormal reads as a zero of its sign, so it goes to +1 too)."""
    return torch.where(nonneg(x), 1, -1).to(torch.int8)


def nonneg(x: torch.Tensor) -> torch.Tensor:
    """``x >= 0`` with a float32 / bf16 subnormal read as a zero (so -1e-39
    counts as >= 0): the 1-bit wire's bit."""
    if x.dtype in FLUSHED:
        return x > -torch.finfo(x.dtype).tiny
    return x >= 0


def pad_to_pack(flat: torch.Tensor, multiple: int = PACK
                ) -> Tuple[torch.Tensor, int]:
    """Zero-pad a 1-D tensor to a multiple; returns (padded, original_len).

    Zero padding packs as +1 bits (sign(0) = +1)."""
    return pad_last(flat, multiple)


def pad_last(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad the LAST dim to a multiple; returns (padded, original_n).

    The one padding helper of the vote wires (``repro.core.vote_api``
    ``pad_last``): every row is padded on its own."""
    n = x.shape[-1]
    rem = (-n) % multiple
    if rem:
        x = F.pad(x, (0, rem))
    return x, n


def words_for(n: int) -> int:
    """Packed words holding n signs."""
    return -(-n // PACK)


def ternary_words_for(n: int) -> int:
    """2-bit packed words holding n ternary symbols."""
    return -(-n // PACK2)


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """x (..., n) real, n % 32 == 0 -> int32 words (..., n // 32); bit j of
    word k is :func:`nonneg` of ``x[..., 32k + j]``."""
    if x.shape[-1] % PACK != 0:
        raise ValueError(
            f"pack_signs needs last dim % {PACK} == 0, got shape "
            f"{tuple(x.shape)}; pad with pad_to_pack first")
    bits = nonneg(x).reshape(x.shape[:-1] + (x.shape[-1] // PACK, PACK))
    acc = torch.zeros(bits.shape[:-1], dtype=WORD_DTYPE, device=x.device)
    for j in range(PACK):   # one strided pass per bit: no (.., w, 32) int temp
        acc |= bits[..., j].to(WORD_DTYPE) << j
    return acc


def unpack_signs(packed: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """int32 words (..., w) -> (..., 32 * w) of ±1 in `dtype`."""
    shifts = torch.arange(PACK, dtype=WORD_DTYPE, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    signs = torch.where(bits == 1, 1, -1).to(dtype)
    return signs.reshape(packed.shape[:-1] + (packed.shape[-1] * PACK,))


def packed_majority(packed: torch.Tensor) -> torch.Tensor:
    """(M, w) packed votes -> (w,) packed majority.

    Bit-sliced: for each bit position count set bits across the M voters;
    the majority bit is ``2 * count >= M`` (ties -> +1, as sign_binary)."""
    m = packed.shape[0]
    acc = torch.zeros(packed.shape[1:], dtype=WORD_DTYPE,
                      device=packed.device)
    for j in range(PACK):
        count = ((packed >> j) & 1).sum(dim=0)
        acc |= (2 * count >= m).to(WORD_DTYPE) << j
    return acc


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word population count of int32 bit patterns (SWAR), as int32.

    The shifts are masked after the arithmetic shift, and the final
    multiply works in int64 so bit 31 never overflows."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def pack_ternary(s: torch.Tensor) -> torch.Tensor:
    """s (..., n) integer symbols, n % 16 == 0 -> int32 words (..., n // 16).

    Field j of word k holds ``s[..., 16k + j] & 3``: 2-bit two's
    complement for {-1, 0, +1} (``0b10`` is never produced from them)."""
    if s.shape[-1] % PACK2 != 0:
        raise ValueError(
            f"pack_ternary needs last dim % {PACK2} == 0, got shape "
            f"{tuple(s.shape)}; pad with pad_last first")
    sym = s.to(WORD_DTYPE) & 0x3
    fields = sym.reshape(s.shape[:-1] + (s.shape[-1] // PACK2, PACK2))
    acc = torch.zeros(fields.shape[:-1], dtype=WORD_DTYPE, device=s.device)
    for j in range(PACK2):   # one strided pass per field
        acc |= fields[..., j] << (2 * j)
    return acc


def unpack_ternary(packed: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """int32 words (..., w) -> (..., 16 * w) of {-1, 0, +1} in `dtype`:
    ``0b01`` -> +1, ``0b11`` -> -1, anything else (``0b10`` too) -> 0."""
    shifts = torch.arange(PACK2, dtype=WORD_DTYPE, device=packed.device) * 2
    fields = (packed[..., None] >> shifts) & 0x3
    signs = (fields == 1).to(dtype) - (fields == 3).to(dtype)
    return signs.reshape(packed.shape[:-1] + (packed.shape[-1] * PACK2,))


def ternary_majority(packed: torch.Tensor, ties: str = "zero"
                     ) -> torch.Tensor:
    """(M, w) packed ternary votes -> (w,) packed ternary majority: per
    field, the sign of the symbol sum over the M voters, so abstentions
    abstain and ties give 0; with ``ties="plus_one"``, ``sign_binary`` of
    the sum (ties and all-abstain +1: the ``hierarchical`` wire's count
    rule). Field-sliced, so no (M, 16w) tensor is made."""
    acc = torch.zeros(packed.shape[1:], dtype=WORD_DTYPE,
                      device=packed.device)
    for j in range(PACK2):
        f = (packed >> (2 * j)) & 0x3
        count = (f == 1).sum(dim=0) - (f == 3).sum(dim=0)
        sym = (torch.sign(count).to(WORD_DTYPE) if ties == "zero"
               else torch.where(count >= 0, 1, -1).to(WORD_DTYPE))
        acc |= sym.bitwise_and_(0x3) << (2 * j)
    return acc
