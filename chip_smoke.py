#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any disagreement:

1. the card's name and power limit, as ``nvidia-smi`` prints them;
2. every CUDA kernel, built from ``src/repro_torch/kernels/csrc`` on
   first use, against its plain PyTorch version on the same CUDA tensors:
   n in {1, 31, 33, 32785, 100000, 620,756,992} (the last is the glm4-9b
   unembedding), M in {1, 4, 7, 33} voters (fused_majority; bitpack
   takes 1, 4 and 7 rows), bf16 and float32 (and int8 for the sign
   kernels, whose payloads carry planted zeros and -0.0); at the
   unembedding n a stack above 24 GB (M = 33 in float32 and bf16) is left
   out. The ternary wire's kernels take the same sizes (and n = 17, and a
   row that starts off a 16-byte boundary): ternary_pack on 1, 4 and 7 rows
   of int8 / f32 / bf16 (4 rows at the unembedding n), ternary_majority
   with both tie rules (ties 0, and ties +1: hierarchical's) over M in
   VOTERS on words with planted 0b10 fields and ties, ternary_unpack to
   int8, float32 and bf16, and the ternary apply in f32 and bf16;
   momentum_sign_pack
   also without its words (the ternary2bit and ef_sign encode), and
   bitunpack of a whole (4, w) unembedding word stack to int8 (2,483,027,968
   signs, past 2^31, as weighted_vote's decode unpacks it). Both applies
   (1-bit and ternary, f32 and bf16) also run at those sizes and n in
   {32, 64, 95, 1024, 2047} on views that start 0, 1 and 3 elements past
   a 16-byte boundary, in place and into a separate out one element
   further along (the kernel's 16-byte path and its element path), with
   the elements around each view held unchanged and planted 0b10 fields
   in the ternary words. The three tallies (majority, ternary_majority
   with ties 0 and with ties +1) also take every M from 1 to 17 and M in {31, 32, 33, 63, 64, 65, 255, 256,
   257, 1000} at n in {33, 100000, 131072}, words of each remainder mod 4,
   planted all-ones, all-zero, tied and (2-bit) 0b10 columns, and a stack
   and an out that start off a 16-byte boundary. momentum_sign_pack with
   bf16 momentum (the preset's instantiation) takes g float32 and bf16 at
   every n of SIZES, beta in {0.9, 0.99, 0.5 + 2^-9 + 2^-31}, planted +0.0
   and -0.0 in g and m, a new m' with the words and m' in place with and
   without them (m' compared bit for bit, -0.0 apart from +0.0). All four
   momentum_sign_pack instantiations (g float32 / bf16 x m float32 / bf16)
   also run at the applies' sizes on g and m views 0, 1 and 3 elements past
   a 16-byte boundary (and g and m apart), in place and into an m_out one
   element further along, with and without the words, m carrying +0.0,
   -0.0 and a NaN (a NaN m' equals any NaN; bit 0). bitpack also reads
   strided views, all three dtypes: windows of a (7, 8256) and a (7, 8261)
   buffer (rows on and off 16-byte boundaries) at 1, 4 and 7 rows, from
   columns 0, 32 and 1, of every length 4096 + r, r < 32, and a window of a
   (4, 620,756,992) buffer whose last row starts past 2^31 bytes. The float
   payloads of every float-reading kernel carry planted float32 / bf16
   subnormals (SUBNORMALS), the momenta SUBNORMAL_MOMENTA beside g = 0
   (beta * m a subnormal operand or result), the applies subnormal
   parameters and eta = 0 (p - 0 flushes them): the kernels, built with
   -ftz=true, must read and write them as zeros as the plain versions do.
   Packed words, signs, momentum and parameters must be bit-equal. Before
   the checks, every float32 compare and operation (FSETP, FMUL, FADD,
   FFMA) in the five libraries' SASS (cuobjdump -sass) must carry .FTZ.
   ef_sign's float32 mean|t| over ten 2^26-element chunks must be within
   1e-5 of a float64 sum;
3. the training path: Algorithm 1 on glm4-9b at every published width,
   cut to 2 layers (1,649,439,744 parameters), M = 4 voters, global batch
   8, seq 512, for 5 steps through ``make_train_step`` ->
   ``materialize_state`` -> ``step_fn``, with random weights from a seeded
   CUDA generator. Every loss must be finite, every step must launch each
   kernel exactly as often as the step has leaves (momentum_sign_pack M
   times as often), and step 0's update of the unembedding leaf must be
   bit-equal to the plain versions recomputed from saved copies of its
   parameters and gradients (the momentum starts at zero);
4. the vote path: every leaf's trained (M, n) momentum voted through
   ``VirtualBackend(device="cuda").execute(VoteRequest(form="stacked"))``
   on four wires (fused allgather_1bit, staged allgather_1bit, psum_int8,
   hierarchical). Each wire must launch its kernels exactly once per leaf,
   report 1 bit (1-bit wire) or 8 bits (count wires) per coordinate, and
   vote the unembedding leaf bit-equal to its plain versions; fused and
   staged 1-bit votes must be equal on every leaf. The same momentum is
   then voted with codec ternary2bit on allgather_1bit (ternary_pack +
   ternary_majority + ternary_unpack, once per leaf, 2 bits per
   coordinate) and on psum_int8 (no kernel; its votes bit-equal to
   sign1bit's psum_int8 votes on every leaf). One more vote per wire runs
   under torch.profiler. Then the quickstart's 5 x 8 vote;
4b. the plan votes: the same momentum as one (M, n_params) int8 sign
   buffer (6.6 GB; each voter's row written leaf by leaf with
   ``vote_plan.write_signs``, as the trainer's plan path writes it),
   voted through ``VoteRequest(plan=build_plan(..., bucket_bytes=1<<24))``
   synchronously and with overlap=True on staged allgather_1bit (13
   buckets: exactly 13 bitpack / majority / bitunpack), psum_int8 and
   hierarchical (13 buckets), ternary2bit on allgather_1bit (25 buckets,
   25 ternary_pack / ternary_majority / ternary_unpack) and weighted_vote
   (13 buckets, its flip-rate state): each overlap result bit-equal to its
   sync twin, the stateless wires' votes bit-equal to phase 4's leaf-wise
   votes of each leaf, CUDA-event ms and the peak above the resident
   buffers printed; the per-bucket copies that remain (the 25 ternary and
   the 13 fused_majority buckets; bitpack reads a 1-bit bucket in place)
   timed alone; then
   ``plan_vote_stacked`` at 1<<24 and 1<<20 (197 buckets): exactly one
   fused_majority and one bitunpack per bucket, bit-equal to the staged
   plan;
5. the codec paths: the same training setup with codec ternary2bit,
   ef_sign and weighted_vote on allgather_1bit, 5 steps each from fresh
   state (the previous run's freed first): finite losses, each step's
   launches exactly the codec's per-leaf count, step 0's update of
   ``layers.attn_wq`` (``layers.mlp_w_down`` for ef_sign, whose mean|t|
   then spans two chunks) and its momentum, and ef_sign's residual,
   bit-equal to the plain versions recomputed from saved copies (ef_sign's
   mean|t| within 1e-5 of a float64 sum),
   ternary2bit's untouched embedding coordinates held still, the peak
   memory printed, and one more step of each under torch.profiler;
6. the preset path: the reference's configured glm4-9b training,
   ``make_train_step(cfg, default_train_config("glm4-9b", cell), 4)`` from
   ``configs/presets.py``: bf16 per-worker momentum on psum_int8 (the
   trainer's 2-bit count wire), 8 microbatches a voter, remat="full", lr
   1e-4, beta 0.9, at every published width, depth cut 40 -> 2 as in phase
   3. Its cell is seq 512 and global batch 32: train_4k's seq 4096 waits
   for query chunking at S > 1024 (ROADMAP.md Queue 1 item 11) and its
   batch of 256 is cut for time. Five steps from fresh state: finite
   losses, each step's launches exactly momentum_sign_pack (the bf16-m
   instantiation, no words) and ternary_pack M times per leaf,
   ternary_majority and apply_ternary_vote once; step 0 of
   ``layers.attn_wq`` (its bf16 momentum rows and its update) bit-equal to
   the plain versions recomputed from saved copies; the peak memory; one
   more step under torch.profiler;
7. each kernel timed at the unembedding shape (median of CUDA-event-timed
   launches after warm-up) beside its plain version and its bound;
   momentum_sign_pack with bf16 momentum as a row of its own, each beside
   ``m.add_(g, alpha=0.1)`` of its dtypes (the stream yardstick); bitpack of
   the (4, n) float32, bf16 and (its own row) int8 stack, each also read one
   element off each row's 16-byte boundary (the element path); beside
   ternary_pack of a float32 row, its bf16 row (the preset's); beside the
   applies, a bf16 copy of the same n elements (the stream yardstick) and
   apply_vote on float32 parameters; beside the tallies, their times at
   M = 32, 64 and 128 voters, at M = 255 on half of the n and at M = 1000
   on an eighth of it;
8. the trainer's plan path (run after phase 7, its launches added to the
   kernels line): phase 3's training through a VotePlan of 1<<24 bytes
   (``OptimizerConfig.bucket_bytes``), 5 steps from fresh state with
   exact launches per step (momentum_sign_pack without words, per bucket
   bitpack / majority / bitunpack, per leaf ternary_pack and
   apply_ternary_vote of the int8 vote), its losses equal to phase 3's
   bit for bit, a profiled step (its PyTorch copy launches counted); again
   with overlap=True (the same
   losses); a codec map (the embedding on ternary2bit) for 2 steps with
   finite losses and exact launches per group; delayed_vote for 2 steps,
   step 0 leaving every parameter as it was and step 1 applying exactly
   the int8 vote banked at step 0 (recomputed with the plain versions);
   the peak memory of each run.
9. signSGD (beta = 0, ``signsgd_vote``): phase 3's cell with momentum 0,
   3 steps on allgather_1bit (each voter's bf16 gradient rows through
   bitpack, majority, apply_vote) and 3 on psum_int8 (ternary_pack of the
   bf16 rows, ternary_majority, apply_ternary_vote), each from fresh
   state: exact launches per step, finite losses, step 0 of the
   unembedding bit-equal to the plain versions recomputed from saved
   copies;
10. the qwen1.5-32b Mode B preset at every published width (d_model
   5120, 40 heads of 40 kv heads, head_dim 128, d_ff 27392, vocab
   152064, untied, qkv bias), depth cut 64 -> 2 (2,608,389,120
   parameters): ``make_train_step(cfg, dataclasses.replace(
   default_train_config("qwen1.5-32b", cell), fsdp=False), 4)`` with
   phase 6's cell (seq 512, batch 32): signsgd_vote, one global float32
   momentum at beta 0.9 on hierarchical, 8 microbatches, nested remat;
   fsdp is cut (with a mesh its fused ZeRO backward votes inside the
   reduce-scatter). Five steps, then 2 each on psum_int8 and
   allgather_1bit, each from fresh state: exact launches per step (per
   leaf the tally, the vote unpacked to bf16, the momentum kernel, the
   ternary pack of u and the ternary apply), finite losses, the peak
   memory under 80 GB; on hierarchical step 0 of layers.attn_wq (its
   momentum and parameters) bit-equal to the plain versions recomputed
   from saved copies and its vote bit-equal to the vote API's
   hierarchical vote of the same gradients, and one profiled step;
11. the dense baselines: phase 3's cell with kind sgd, sgdm and adam, 3
   steps each from fresh state: no kernel launch, finite losses, the
   median step and the peak memory, the unembedding's mean gradient at
   step 0 within the bf16 rounding bound of a float64 sum of the four
   voters' gradients (bit-equal to the port's bf16 sum for sgdm), and
   float32 sqrt on the card the nearest float32 (Adam's root).

Phase 7 also times ternary_majority with ties +1 (its own row),
ternary_unpack to bf16 and bitpack of the bf16 stack (its own row, whose
launches are phases 9's and 10's).

It prints one JSON line per step and per wire, a ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
N_UNEMBED = 151_552 * 4096  # elements of glm4-9b's unembedding leaf
SIZES = (1, 31, 33, 32_785, 100_000, N_UNEMBED)
VOTERS = (1, 4, 7, 33)
#: the apply kernels' placement checks: sizes (below, at and past one
#: warp's 1024-element segment), and views that start this many elements
#: past a 16-byte boundary (0: on it)
APPLY_SIZES = SIZES + (32, 64, 95, 1024, 2047)
APPLY_OFFSETS = (0, 1, 3)
#: the tallies' checks: every plane count of the bit-sliced counter (P = 1
#: to 8, M < 256) and the instantiation for any M, at these lengths in
#: elements (2, 3125 and 4096 words on the 1-bit wire, 3, 6250 and 8192 on
#: the 2-bit one: the last a multiple of 4, so every M also takes the
#: 16-byte path); word counts of each remainder mod 4 (the 16-byte path and
#: the word path) at TALLY_WORD_VOTERS; views off a 16-byte boundary at
#: TALLY_VIEW_VOTERS
TALLY_VOTERS = tuple(range(1, 18)) + (31, 32, 33, 63, 64, 65, 255, 256, 257,
                                      1000)
TALLY_SIZES = (33, 100_000, 131_072)
TALLY_WORDS = (4, 5, 6, 7, 1024, 1025, 1026, 1027)
TALLY_WORD_VOTERS = (1, 4, 7, 32, 65)
TALLY_VIEW_VOTERS = (4, 7, 33, 100)
#: the tallies' extra timings, (voters, the unembedding's n cut by): M =
#: 32, 64 and 128 at the unembedding, M = 255 (the largest with a plane
#: count of its own) on half of it, and M = 1000 (the kernel for any M) on
#: an eighth of it
TALLY_TIMED = ((32, 1), (64, 1), (128, 1), (255, 2), (1000, 8))
M_MAIN, GLOBAL_BATCH, SEQ, STEPS, LR, BETA = 4, 8, 512, 5, 1e-3, 0.9
#: planted in the float payloads of phase 2: float32 subnormals (the
#: largest, 1e-39, and the smallest, 1.4e-45) of both signs, which the
#: kernels (built with -ftz=true) and the plain versions read as zeros
SUBNORMALS = (1e-39, -1e-39, 1.4e-45, -1.4e-45)
#: momenta planted beside g = 0: subnormal ones (an operand flushed), and
#: normal ones whose product with beta underflows (a result flushed)
SUBNORMAL_MOMENTA = (1e-38, -1e-38, 1.2e-38, -1.2e-38)
#: the apply checks' (eta, weight decay); eta = 0 leaves p - 0, which
#: flushes a subnormal p
APPLY_RATES = ((1e-3, 0.0), (1e-2, 0.1), (0.0, 0.0))
#: beta of the bf16-momentum checks: the last one's float32 value lies half
#: way between two bf16 values and rounds to even (0.5)
BF16_BETAS = (0.9, 0.99, 0.5 + 2 ** -9 + 2 ** -31)
#: the preset path (phase 6): the glm4-9b preset's shape cell, cut from
#: train_4k's seq 4096 and batch 256 (see the docstring)
PRESET_SEQ, PRESET_BATCH = 512, 32
#: the preset path's leaf whose step 0 is recomputed from saved copies
PRESET_LEAF = "layers.attn_wq"
PACK_ROWS = (1, 4, 7)
STACK_CAP_BYTES = 24e9      # largest (M, n) stack phase 2 builds
#: largest (rows, n) int32 temporary of ternary_pack's plain version
TERNARY_CAP_BYTES = 12e9
#: the codec paths of phase 5, and the leaf whose step 0 each recomputes:
#: ef_sign's is above one SCALE_CHUNK per voter (112,197,632 elements), so
#: its mean|t| is summed in more than one chunk
CHECK_LEAF = {"ternary2bit": "layers.attn_wq",
              "ef_sign": "layers.mlp_w_down",
              "weighted_vote": "layers.attn_wq"}
#: relative error allowed of the float32 mean|t| against a float64 sum
SCALE_RTOL = 1e-5
SOURCE = "src/repro_torch/kernels/csrc/"
#: the vote path's wires: (label, use_kernels, strategy, codec, launches
#: per leaf, wire bits per coordinate)
VOTE_WIRES = (
    ("fused_allgather_1bit", True, "allgather_1bit", "sign1bit",
     {"fused_majority": 1, "bitunpack": 1}, 1.0),
    ("staged_allgather_1bit", False, "allgather_1bit", "sign1bit",
     {"bitpack": 1, "majority": 1, "bitunpack": 1}, 1.0),
    ("psum_int8", False, "psum_int8", "sign1bit", {}, 8.0),
    ("hierarchical", False, "hierarchical", "sign1bit",
     {"bitpack": 1, "bitunpack": 1}, 8.0),
    ("ternary_allgather_1bit", False, "allgather_1bit", "ternary2bit",
     {"ternary_pack": 1, "ternary_majority": 1, "ternary_unpack": 1}, 2.0),
    ("ternary_psum_int8", False, "psum_int8", "ternary2bit", {}, 8.0),
)


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def max_abs_err(a, b) -> float:
    import torch
    if a.dtype in (torch.int32, torch.int64):
        return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def require_equal(what: str, got, want) -> float:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got, want):
        raise AssertionError(
            f"{what}: kernel disagrees with its plain version (max abs "
            f"err {max_abs_err(got, want) if got.shape == want.shape else 'shape'})")
    return max_abs_err(got, want)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def plant_subnormals(x, start: int = 1, step: int = 13):
    """Plant SUBNORMALS in every `step`-th element of the last dim of the
    float tensor `x` from `start` (float32 1e-39 cast to bf16 stays a
    bf16 subnormal; 1.4e-45 becomes a zero there)."""
    for i, v in enumerate(SUBNORMALS):
        x[..., start + i::step * len(SUBNORMALS)] = v
    return x


def signed_payload(torch, gen, shape, dtype, dev):
    """Random values of `dtype` with planted zeros, -0.0 and subnormals
    (bit +1: a subnormal reads as a zero)."""
    if dtype == torch.int8:
        x = torch.randint(-128, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        x[..., ::7] = 0
        return x
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    x[..., ::7] = 0.0
    x[..., 3::7] = -0.0
    return plant_subnormals(x)


def plant_momenta(g, m):
    """Plant subnormals in g (a float32 or bf16 operand read as a zero),
    and SUBNORMAL_MOMENTA in m with g = 0 beside them (beta * m a subnormal
    operand or result, flushed: m' = +0.0, bit +1)."""
    plant_subnormals(g, start=2, step=17)
    k = len(SUBNORMAL_MOMENTA)
    for i, v in enumerate(SUBNORMAL_MOMENTA):
        m[5 + i::11 * k] = v
        g[5 + i::11 * k] = 0.0


def check_sign_kernels(torch, ops, ref, sc, dev, err) -> int:
    """fused_majority, bitpack and bitunpack against their plain versions;
    updates `err`, returns the number of checks."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    n_checks = 0
    for n in SIZES:
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            rows = max(r for r in VOTERS + PACK_ROWS
                       if r * n * dtype.itemsize <= STACK_CAP_BYTES)
            x = signed_payload(torch, gen, (rows, n), dtype, dev)
            for m in VOTERS:
                if m > rows:
                    continue
                err["fused_majority"] = max(err["fused_majority"],
                                            require_equal(
                    f"fused_majority n={n} M={m} {dtype}",
                    ops.fused_majority(x[:m]),
                    ref.fused_majority(sc.pad_last(x[:m], sc.PACK)[0])))
                n_checks += 1
            for r in PACK_ROWS:
                err["bitpack"] = max(err["bitpack"], require_equal(
                    f"bitpack n={n} rows={r} {dtype}", ops.bitpack(x[:r]),
                    ref.bitpack(sc.pad_last(x[:r], sc.PACK)[0])))
                n_checks += 1
            del x
            words = torch.randint(-2 ** 31, 2 ** 31, (sc.words_for(n),),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)
            err["bitunpack"] = max(err["bitunpack"], require_equal(
                f"bitunpack n={n} {dtype}", ops.bitunpack(words, n, dtype),
                ref.bitunpack(words[None], dtype)[0, :n]))
            n_checks += 1
            del words
        torch.cuda.synchronize()
    n_checks += check_stacked_unpack(torch, ops, ref, sc, dev, gen, err)
    return n_checks + check_bitpack_strided(torch, ops, ref, sc, dev, gen, err)


def check_stacked_unpack(torch, ops, ref, sc, dev, gen, err) -> int:
    """weighted_vote's decode unpacks a leaf's whole (M, w) word stack with
    one bitunpack: at the unembedding that is M_MAIN * 32 * w =
    2,483,027,968 int8 signs, past 2^31. Held against the plain version
    a slab of words at a time (the plain version's int64 temporaries of
    the whole stack would take ~30 GB)."""
    words = torch.randint(-2 ** 31, 2 ** 31,
                          (M_MAIN * sc.words_for(N_UNEMBED),), generator=gen,
                          device=dev, dtype=torch.int32)
    n = words.numel() * sc.PACK
    got = ops.bitunpack(words, n, torch.int8)
    slab = 1 << 24
    for w0 in range(0, words.numel(), slab):
        part = words[w0:w0 + slab]
        err["bitunpack"] = max(err["bitunpack"], require_equal(
            f"bitunpack n={n} int8 words {w0}..{w0 + part.numel()}",
            got[w0 * sc.PACK:(w0 + part.numel()) * sc.PACK],
            ref.bitunpack(part[None], torch.int8)[0]))
    del words, got
    torch.cuda.synchronize()
    log({"phase": "stacked_bitunpack", "n": n, "voters": M_MAIN,
         "ok": True})
    return 1


#: bitpack's strided checks: windows of a (rows, width) buffer, its rows
#: `width` elements apart (the first width keeps every row on a 16-byte
#: boundary in every dtype, the second drifts off it); windows starting at
#: column 0, 32 (a bucket's ALIGN) and 1 (off 16 bytes), STRIDE_LENGTHS
#: long (each remainder mod 32, past the 2048 elements of an int8 unit)
STRIDE_WIDTHS = (8256, 8261)
STRIDE_STARTS = (0, 32, 1)
STRIDE_LENGTHS = tuple(4096 + r for r in range(32))


def check_bitpack_strided(torch, ops, ref, sc, dev, gen, err) -> int:
    """bitpack on strided views (each row contiguous, the rows a buffer's
    width apart, as the plan's buckets are), float32 / bf16 / int8, rows in
    PACK_ROWS, every window of STRIDE_WIDTHS x STRIDE_STARTS x
    STRIDE_LENGTHS, and a window of a (4, N_UNEMBED) buffer whose last row
    starts past 2^31 bytes: bit-equal to the plain version of the zero-padded
    contiguous window. Updates `err`, returns the number of checks."""
    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for width in STRIDE_WIDTHS:
            buf = signed_payload(torch, gen, (max(PACK_ROWS), width), dtype,
                                 dev)
            for rows in PACK_ROWS:
                for c0 in STRIDE_STARTS:
                    for n in STRIDE_LENGTHS:
                        x = buf[:rows, c0:c0 + n]
                        err["bitpack"] = max(err["bitpack"], require_equal(
                            f"bitpack {dtype} rows={rows} width={width} "
                            f"window {c0}..{c0 + n}", ops.bitpack(x),
                            ref.bitpack(sc.pad_last(x.contiguous(),
                                                    sc.PACK)[0])))
                        n_checks += 1
            del buf
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        buf = signed_payload(torch, gen, (M_MAIN, N_UNEMBED), dtype, dev)
        c0 = N_UNEMBED // 2 + 32
        x = buf[:, c0:N_UNEMBED - 7]
        if ((M_MAIN - 1) * N_UNEMBED + c0) * dtype.itemsize < 2 ** 31:
            raise AssertionError("the window's last row is below 2^31 bytes")
        err["bitpack"] = max(err["bitpack"], require_equal(
            f"bitpack {dtype} ({M_MAIN}, {N_UNEMBED}) window "
            f"{c0}..{N_UNEMBED - 7}", ops.bitpack(x),
            ref.bitpack(sc.pad_last(x.contiguous(), sc.PACK)[0])))
        n_checks += 1
        del buf, x
        torch.cuda.synchronize()
    return n_checks


def check_scale(torch, what: str, t, got) -> float:
    """ef_sign's float32 mean|t| `got` against a float64 sum of |t|, within
    SCALE_RTOL; returns the relative error."""
    want = float(t.double().abs().sum()) / t.numel()
    rel = abs(float(got) - want) / want
    if not rel <= SCALE_RTOL:
        raise AssertionError(f"{what}: mean|t| {float(got)!r} against "
                             f"{want!r} in float64 (rel err {rel})")
    return rel


def check_apply_placement(torch, ops, ref, sc, dev, gen, err,
                          ternary: bool) -> int:
    """apply_vote (apply_ternary_vote with `ternary`) on views that start
    APPLY_OFFSETS elements past a 16-byte boundary, in place (eta 1e-3, no
    weight decay) and into a separate out that starts one element further
    along (eta 1e-2, wd 0.1): bit-equal to the plain version, and the
    elements around each view untouched. Misaligned views and the ragged
    tail take the kernel's element path, the rest its 16-byte path; both
    are held to the same check. The ternary words carry planted 0b10
    fields. Updates `err`, returns the number of checks."""
    name = "apply_ternary_vote" if ternary else "apply_vote"
    kernel, plain = getattr(ops, name), getattr(ref, name)
    pack = sc.PACK2 if ternary else sc.PACK
    n_checks = 0
    for n in APPLY_SIZES:
        words = torch.randint(-2 ** 31, 2 ** 31, (-(-n // pack),),
                              generator=gen, device=dev, dtype=torch.int32)
        if ternary:
            words[::5] = -0x55555556            # 0b10 in every field
        for dtype in (torch.float32, torch.bfloat16):
            for off in APPLY_OFFSETS:
                buf = torch.randn(off + n + 5, generator=gen,
                                  device=dev).to(dtype)
                p, before = buf[off:off + n], buf.clone()
                for in_place in (True, False):
                    eta, wd = (1e-3, 0.0) if in_place else (1e-2, 0.1)
                    want = plain(sc.pad_to_pack(p, pack)[0], words, eta,
                                 wd)[:n]
                    if in_place:
                        whole, o = buf, off
                    else:
                        o = (off + 1) % 4
                        whole = torch.zeros(o + n + 5, dtype=dtype,
                                            device=dev)
                    guard = whole.clone()
                    got = kernel(p, words, eta, wd, out=whole[o:o + n])
                    what = (f"{name} n={n} {dtype} offset={off} "
                            + ("in place" if in_place else f"out offset={o}"))
                    err[name] = max(err[name], require_equal(what, got, want))
                    require_equal(f"{what}: elements around the view",
                                  torch.cat([whole[:o], whole[o + n:]]),
                                  torch.cat([guard[:o], guard[o + n:]]))
                    if in_place:    # restore p for the separate-out check
                        buf.copy_(before)
                    n_checks += 1
                del buf, p, before, want, whole, guard, got
        del words
        torch.cuda.synchronize()
    return n_checks


def ternary_payload(torch, gen, shape, dtype, dev):
    """ternary_pack inputs: int8 of any value (only the low two bits are
    packed) with {-1, 0, +1} symbols in the first half and planted zeros;
    f32 / bf16 values with planted +0.0 and -0.0 (both abstain)."""
    if dtype == torch.int8:
        x = torch.randint(-128, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        half = shape[-1] // 2
        x[..., :half] = torch.randint(-1, 2, shape[:-1] + (half,),
                                      generator=gen, device=dev,
                                      dtype=torch.int8)
        x[..., ::7] = 0
        return x
    return signed_payload(torch, gen, shape, dtype, dev)


def check_ternary_kernels(torch, ops, ref, sc, dev, err) -> int:
    """ternary_pack, ternary_majority, ternary_unpack and the ternary apply
    against their plain versions; updates `err`, returns the number of
    checks."""
    gen = torch.Generator(device=dev).manual_seed(2468)
    n_checks = 0
    for n in SIZES + (17,):
        w = sc.ternary_words_for(n)
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            rows = max(r for r in PACK_ROWS if r * n * 4 <= TERNARY_CAP_BYTES)
            x = ternary_payload(torch, gen, (rows, n), dtype, dev)
            for r in PACK_ROWS:
                if r > rows:
                    continue
                err["ternary_pack"] = max(err["ternary_pack"], require_equal(
                    f"ternary_pack n={n} rows={r} {dtype}",
                    ops.ternary_pack(x[:r]),
                    ref.ternary_pack(sc.pad_last(x[:r], sc.PACK2)[0])))
                n_checks += 1
            if n > 1:   # a row that starts one element off alignment
                row = x[0, 1:].view(1, -1)
                err["ternary_pack"] = max(err["ternary_pack"], require_equal(
                    f"ternary_pack n={n - 1} unaligned {dtype}",
                    ops.ternary_pack(row),
                    ref.ternary_pack(sc.pad_last(row, sc.PACK2)[0])))
                n_checks += 1
            del x
        for m in VOTERS:
            packed = torch.randint(-2 ** 31, 2 ** 31, (m, w), generator=gen,
                                   device=dev, dtype=torch.int32)
            packed[:, 0] = 0x55555555              # +1 in every field
            packed[m // 2:, 0] = -1                # -1: ties for even M
            packed[: (m + 1) // 2, -1] = -0x55555556   # 0b10 everywhere
            err["ternary_majority"] = max(err["ternary_majority"],
                                          require_equal(
                f"ternary_majority n={n} M={m}", ops.ternary_majority(packed),
                ref.ternary_majority(packed)))
            err["ternary_majority_plus_one"] = max(
                err["ternary_majority_plus_one"], require_equal(
                    f"ternary_majority_plus_one n={n} M={m}",
                    ops.ternary_majority(packed, ties="plus_one"),
                    ref.ternary_majority(packed, "plus_one")))
            n_checks += 2
            del packed
        words = torch.randint(-2 ** 31, 2 ** 31, (w,), generator=gen,
                              device=dev, dtype=torch.int32)
        err["ternary_unpack"] = max(err["ternary_unpack"], require_equal(
            f"ternary_unpack n={n}", ops.ternary_unpack(words, n),
            ref.ternary_unpack(words[None])[0, :n]))
        # the float outputs (Mode B's momentum takes the bf16 vote), bit for
        # bit: a 0 is +0.0 in both
        for dtype, bits in ((torch.float32, torch.int32),
                            (torch.bfloat16, torch.int16)):
            require_equal(f"ternary_unpack n={n} {dtype}",
                          ops.ternary_unpack(words, n, dtype).view(bits),
                          ref.ternary_unpack(words[None], dtype)[0, :n]
                          .contiguous().view(bits))
        n_checks += 3
        for dtype in (torch.float32, torch.bfloat16):
            p = plant_subnormals(
                torch.randn(n, generator=gen, device=dev).to(dtype))
            for eta, wd in APPLY_RATES:
                err["apply_ternary_vote"] = max(
                    err["apply_ternary_vote"], require_equal(
                        f"apply_ternary_vote n={n} {dtype} eta={eta} wd={wd}",
                        ops.apply_ternary_vote(p, words, eta, wd),
                        ref.apply_ternary_vote(sc.pad_to_pack(p, sc.PACK2)[0],
                                               words, eta, wd)[:n]))
                n_checks += 1
            del p
        del words
        torch.cuda.synchronize()
    return n_checks + check_apply_placement(torch, ops, ref, sc, dev, gen,
                                            err, ternary=True)


#: the three tallies: (name, elements per word, a word of +1 votes in
#: every bit or field, a word of -1 votes, the 2-bit wire's unused 0b10
#: pattern); ternary_majority_plus_one is ternary_majority(ties="plus_one")
TALLIES = (("majority", 32, -1, 0, None),
           ("ternary_majority", 16, 0x55555555, -1, -0x55555556),
           ("ternary_majority_plus_one", 16, 0x55555555, -1, -0x55555556))


def tally_fns(ops, ref, name):
    """(kernel wrapper, plain version) of tally `name` of TALLIES."""
    if name == "ternary_majority_plus_one":
        return (lambda p, out=None: ops.ternary_majority(
                    p, ties="plus_one", out=out),
                lambda p: ref.ternary_majority(p, "plus_one"))
    return getattr(ops, name), getattr(ref, name)


def planted_words(torch, gen, m, w, dev, plus, minus, unused):
    """(m, w) random int32 words with planted columns, where w has room:
    column 0 all ones (on the 2-bit wire, all -1), column 1 all zeros (all
    abstaining), column 2 an exact tie at even M (the first M // 2 rows
    `plus`, the next M // 2 `minus`, an odd M's last row 0) and, on the
    2-bit wire, column 3 the unused 0b10 in every other row and 0 in the
    rest, which counts nothing."""
    words = torch.randint(-2 ** 31, 2 ** 31, (m, w), generator=gen,
                          device=dev, dtype=torch.int32)
    half = m // 2
    cols = [[-1] * m, [0] * m, [plus] * half + [minus] * half + [0] * (m % 2)]
    if unused is not None:
        cols.append(([unused, 0] * m)[:m])
    for j, col in enumerate(cols[:w]):
        words[:, j] = torch.tensor(col, dtype=torch.int32, device=dev)
    return words


def check_tallies(torch, ops, ref, sc, dev, err) -> int:
    """majority and ternary_majority against their plain versions, bit for
    bit: every M of TALLY_VOTERS at TALLY_SIZES, w of each remainder mod 4,
    and a (M, w) stack and an out that start off a 16-byte boundary (the
    elements around the out view held unchanged). Updates `err`, returns the
    number of checks."""
    gen = torch.Generator(device=dev).manual_seed(1357)
    n_checks = 0
    for name, per_word, plus, minus, unused in TALLIES:
        kernel, plain = tally_fns(ops, ref, name)

        def check(what, packed, out=None):
            got = kernel(packed) if out is None else kernel(packed, out=out)
            err[name] = max(err[name], require_equal(
                f"{name} {what}", got, plain(packed)))

        cases = [(m, -(-n // per_word)) for n in TALLY_SIZES
                 for m in TALLY_VOTERS]
        cases += [(m, w) for w in TALLY_WORDS for m in TALLY_WORD_VOTERS]
        for m, w in cases:
            check(f"M={m} w={w}", planted_words(torch, gen, m, w, dev, plus,
                                                minus, unused))
            n_checks += 1
        for m in TALLY_VIEW_VOTERS:
            for w in (1024, 1027):
                words = planted_words(torch, gen, m, w, dev, plus, minus,
                                      unused)
                buf = torch.zeros(m * w + 2, dtype=torch.int32, device=dev)
                packed = buf[1:1 + m * w].view(m, w)
                packed.copy_(words)
                check(f"M={m} w={w} stack 4 B off a 16-byte boundary",
                      packed)
                whole = torch.full((w + 2,), 0x5A5A5A5A, dtype=torch.int32,
                                   device=dev)
                guard = whole.clone()
                check(f"M={m} w={w} out=buf[1:]", words,
                      out=whole[1:1 + w])
                require_equal(f"{name} M={m} w={w}: words around out",
                              whole[[0, -1]], guard[[0, -1]])
                n_checks += 2
                del words, buf, packed, whole, guard
        torch.cuda.synchronize()
    return n_checks


def check_momentum_bf16(torch, ops, ref, sc, dev, err) -> int:
    """momentum_sign_pack with bf16 momentum (the preset path's
    instantiation) against its plain version, bit for bit: g float32 and
    bf16, every n of SIZES, every beta of BF16_BETAS, planted +0.0 / -0.0
    in g and m (m' = +0.0 or -0.0, bit +1), into a new m' with the words,
    then in place (m_out = m) with and without them. Updates `err` under
    "momentum_sign_pack_bf16m"; returns the number of checks."""
    gen = torch.Generator(device=dev).manual_seed(8642)
    name = "momentum_sign_pack_bf16m"
    n_checks = 0
    for n in SIZES:
        for gdtype in (torch.float32, torch.bfloat16):
            g = torch.randn(n, generator=gen, device=dev).to(gdtype)
            m0 = (torch.randn(n, generator=gen, device=dev) * 0.3).to(
                torch.bfloat16)
            g[::7], m0[::7] = 0.0, 0.0
            g[3::7], m0[3::7] = -0.0, -0.0
            g[5::11], m0[5::11] = -0.0, 0.0
            plant_momenta(g, m0)
            for beta in BF16_BETAS:
                m_r, p_r = ref.momentum_sign_pack(
                    sc.pad_to_pack(g)[0], sc.pad_to_pack(m0)[0], beta)
                m_r = m_r[:n]
                what = f"{name} n={n} g {gdtype} beta={beta!r}"
                m_k, p_k = ops.momentum_sign_pack(g, m0, beta)
                e = max(require_equal(f"{what} m'", m_k.view(torch.int16),
                                      m_r.view(torch.int16)),
                        require_equal(f"{what} words", p_k, p_r))
                for pack in (True, False):
                    m = m0.clone()
                    _, p_in = ops.momentum_sign_pack(g, m, beta, m_out=m,
                                                     pack=pack)
                    e = max(e, require_equal(
                        f"{what} in place pack={pack} m'",
                        m.view(torch.int16), m_r.view(torch.int16)))
                    if pack:
                        e = max(e, require_equal(
                            f"{what} in place words", p_in, p_r))
                    elif p_in is not None:
                        raise AssertionError(f"{what}: pack=False gave words")
                    del m, p_in
                err[name] = max(err[name], e)
                n_checks += 3
                del m_r, p_r, m_k, p_k
            del g, m0
        torch.cuda.synchronize()
    return n_checks


#: momentum_sign_pack's placement checks: (g, m) offsets in elements past a
#: 16-byte boundary (each of APPLY_OFFSETS, and g and m apart); m_out is m
#: itself (in place) or a view (m's offset + 1) % 4 past a boundary
MSP_PLACEMENTS = tuple((o, o) for o in APPLY_OFFSETS) + ((1, 0), (0, 3))
#: the four instantiations: (g dtype, m dtype) by name, and the name under
#: which phase 2 reports them
MSP_DTYPES = (("float32", "float32", "momentum_sign_pack"),
              ("bfloat16", "float32", "momentum_sign_pack"),
              ("float32", "bfloat16", "momentum_sign_pack_bf16m"),
              ("bfloat16", "bfloat16", "momentum_sign_pack_bf16m"))


def require_bits_equal(torch, what: str, got, want) -> float:
    """`got` bit-equal to `want` (float32 / bf16 compared as bit patterns,
    so -0.0 differs from +0.0), a NaN equal to any NaN: neither the kernel
    nor the plain version specifies a NaN's payload."""
    both_nan = torch.isnan(got) & torch.isnan(want)
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{what}: NaN where the plain version has none")
    return require_equal(what, got.masked_fill(both_nan, 0).view(
        bits[got.dtype]), want.masked_fill(both_nan, 0).view(bits[got.dtype]))


def check_momentum_placement(torch, ops, ref, sc, dev, err) -> int:
    """momentum_sign_pack, all four instantiations (g float32 / bf16 x m
    float32 / bf16), at APPLY_SIZES (below, at and past one 1024-element
    segment), with g and m views at MSP_PLACEMENTS, in place (m_out = m)
    and into a separate m_out one element further along, with and without
    the words (the 16-byte path and the element path). m carries planted
    +0.0, -0.0, a NaN (m' NaN, bit 0) and SUBNORMAL_MOMENTA, g subnormals.
    m' bit-equal to the plain version (a NaN to a NaN), the words bit-equal,
    the elements around every view unchanged. Updates `err`; returns the
    number of checks."""
    gen = torch.Generator(device=dev).manual_seed(9753)
    n_checks = 0
    for n in APPLY_SIZES:
        w = sc.words_for(n)
        for gname, mname, name in MSP_DTYPES:
            gdt, mdt = getattr(torch, gname), getattr(torch, mname)
            g0 = torch.randn(n, generator=gen, device=dev).to(gdt)
            m0 = torch.randn(n, generator=gen, device=dev).to(mdt)
            g0[::7], m0[::7] = 0.0, 0.0
            m0[3::7] = -0.0
            m0[4::97] = float("nan")
            plant_momenta(g0, m0)
            m_r, p_r = ref.momentum_sign_pack(sc.pad_to_pack(g0)[0],
                                              sc.pad_to_pack(m0)[0], BETA)
            m_r = m_r[:n]
            e = 0.0
            for g_off, m_off in MSP_PLACEMENTS:
                gbuf = torch.zeros(g_off + n + 5, dtype=gdt, device=dev)
                gbuf[g_off:g_off + n] = g0
                g = gbuf[g_off:g_off + n]
                mbuf = torch.full((m_off + n + 5,), 7.0, dtype=mdt,
                                  device=dev)
                for in_place in (True, False):
                    o = m_off if in_place else (m_off + 1) % 4
                    obuf = mbuf if in_place else torch.full(
                        (o + n + 5,), 7.0, dtype=mdt, device=dev)
                    for pack in (True, False):
                        mbuf[m_off:m_off + n] = m0
                        m = mbuf[m_off:m_off + n]
                        m_out = obuf[o:o + n]
                        guard = obuf.clone()
                        what = (f"{name} n={n} g {gname}+{g_off} m "
                                f"{mname}+{m_off} "
                                + ("in place" if in_place
                                   else f"m_out+{o}") + f" pack={pack}")
                        _, words = ops.momentum_sign_pack(
                            g, m, BETA, m_out=m_out, pack=pack)
                        e = max(e, require_bits_equal(torch, f"{what} m'",
                                                      m_out, m_r))
                        if pack:
                            e = max(e, require_equal(f"{what} words", words,
                                                     p_r))
                        elif words is not None:
                            raise AssertionError(f"{what}: words written")
                        require_equal(f"{what}: elements around m_out",
                                      torch.cat([obuf[:o], obuf[o + n:]]),
                                      torch.cat([guard[:o], guard[o + n:]]))
                        require_equal(f"{what}: g", gbuf[g_off:g_off + n],
                                      g0)
                        n_checks += 1
                        del words, guard
                    del obuf
                del gbuf, g, mbuf, m, m_out
            err[name] = max(err[name], e)
            del g0, m0, m_r, p_r
        torch.cuda.synchronize()
    return n_checks


def check_kernels(torch, ops, ref, sc, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1234)
    err = {name: 0.0 for name in ops.launch_counts()}
    err["momentum_sign_pack_bf16m"] = 0.0
    n_checks = 0
    for n in SIZES:
        w = sc.words_for(n)
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(n, generator=gen, device=dev).to(dtype)
            m = torch.randn(n, generator=gen, device=dev)
            g[::7], m[::7] = 0.0, 0.0          # m' = 0 -> bit +1
            m[3::7], g[3::7] = -0.0, -0.0      # m' = -0 -> bit +1
            plant_momenta(g, m)
            m_k, p_k = ops.momentum_sign_pack(g, m, BETA)
            m_r, p_r = ref.momentum_sign_pack(sc.pad_to_pack(g)[0],
                                              sc.pad_to_pack(m)[0], BETA)
            e = max(require_equal(f"momentum_sign_pack m' n={n} {dtype}",
                                  m_k, m_r[:n]),
                    require_equal(f"momentum_sign_pack words n={n} {dtype}",
                                  p_k, p_r))
            # the ternary2bit / ef_sign encode: m' only, no words
            m_np, none = ops.momentum_sign_pack(g, m, BETA, pack=False)
            if none is not None:
                raise AssertionError("pack=False gave words")
            e = max(e, require_equal(
                f"momentum_sign_pack pack=False m' n={n} {dtype}", m_np,
                m_r[:n]))
            n_checks += 1
            err["momentum_sign_pack"] = max(err["momentum_sign_pack"], e)
            del g, m, m_k, p_k, m_r, p_r, m_np
            p = plant_subnormals(
                torch.randn(n, generator=gen, device=dev).to(dtype))
            votes = torch.randint(-2 ** 31, 2 ** 31, (w,), generator=gen,
                                  device=dev, dtype=torch.int32)
            for eta, wd in APPLY_RATES:
                got = ops.apply_vote(p, votes, eta, wd)
                want = ref.apply_vote(sc.pad_to_pack(p)[0], votes, eta,
                                      wd)[:n]
                err["apply_vote"] = max(err["apply_vote"], require_equal(
                    f"apply_vote n={n} {dtype} eta={eta} wd={wd}", got,
                    want))
                del got, want
            del p, votes
            n_checks += 1 + len(APPLY_RATES)
        for m_voters in VOTERS:
            packed = torch.randint(-2 ** 31, 2 ** 31, (m_voters, w),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
            err["majority"] = max(err["majority"], require_equal(
                f"majority n={n} M={m_voters}", ops.majority(packed),
                ref.majority(packed)))
            del packed
            n_checks += 1
        torch.cuda.synchronize()
    n_checks += check_apply_placement(torch, ops, ref, sc, dev, gen, err,
                                      ternary=False)
    n_checks += check_sign_kernels(torch, ops, ref, sc, dev, err)
    n_checks += check_ternary_kernels(torch, ops, ref, sc, dev, err)
    n_checks += check_tallies(torch, ops, ref, sc, dev, err)
    n_checks += check_momentum_bf16(torch, ops, ref, sc, dev, err)
    n_checks += check_momentum_placement(torch, ops, ref, sc, dev, err)
    # ef_sign's mean|t| summed over ten SCALE_CHUNKs (torch ops, no kernel)
    from repro_torch.core.codecs import ef_sign
    t = torch.randn(N_UNEMBED, generator=gen, device=dev)
    rel = check_scale(torch, f"scale_of n={N_UNEMBED}", t, ef_sign.scale_of(t))
    del t
    log({"phase": "kernels_vs_plain", "checks": n_checks, "max_abs_err": err,
         "scale_of_rel_err": rel})
    return err


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------


def leaf_grads(torch, M, cfg, params, tokens, per, leaf="unembed.table"):
    """Each voter's gradient of `leaf` at `params`, by plain autograd."""
    out = []
    for r in range(M_MAIN):
        leaves = dict(params)
        leaves[leaf] = params[leaf].detach().requires_grad_()
        loss, _ = M.loss_fn(cfg, leaves,
                            {"tokens": tokens[r * per:(r + 1) * per]})
        out.append(torch.autograd.grad(loss, [leaves[leaf]])[0])
    return out


def train_config(codec: str):
    from repro_torch.configs.base import (OptimizerConfig, TrainConfig,
                                          VoteStrategy)
    return TrainConfig(global_batch=GLOBAL_BATCH, seq_len=SEQ,
                       optimizer=OptimizerConfig(
                           kind="signum_vote", learning_rate=LR,
                           momentum=BETA,
                           vote_strategy=VoteStrategy.ALLGATHER_1BIT,
                           codec=codec))


def step_launches(codec: str, n_leaves: int) -> dict:
    """The kernel launches one step of `codec` makes (M_MAIN voters)."""
    per_voter = M_MAIN * n_leaves
    return {
        "sign1bit": {"momentum_sign_pack": per_voter, "majority": n_leaves,
                     "apply_vote": n_leaves},
        "ternary2bit": {"momentum_sign_pack": per_voter,
                        "ternary_pack": per_voter,
                        "ternary_majority": n_leaves,
                        "apply_ternary_vote": n_leaves},
        "ef_sign": {"momentum_sign_pack": per_voter, "bitpack": per_voter,
                    "majority": n_leaves, "apply_vote": n_leaves,
                    "bitunpack": n_leaves},
        "weighted_vote": {"momentum_sign_pack": per_voter,
                          "bitunpack": n_leaves, "bitpack": n_leaves,
                          "apply_vote": n_leaves},
    }[codec]


def run_train_path(torch, cfg, dev, codec: str, leaf: str,
                   vote_after: bool = False) -> dict:
    """One training path (phase 3 for sign1bit, phase 5 for the other
    codecs): 5 full-width steps from fresh state with exact launches per
    step, a bit-exact step 0 of `leaf`, the peak memory and a profiled
    step; then, with `vote_after`, the vote path (phase 4) and the plan
    votes (phase 4b) on the trained momentum. Returns the launches of the
    path and its losses."""
    from repro_torch.core import signum
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    tcfg = train_config(codec)
    n_params = cfg.param_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
    params, opt_state = TS.materialize_state(
        cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
    pipe = SyntheticLMPipeline(cfg, GLOBAL_BATCH, SEQ, seed=0)
    per = GLOBAL_BATCH // M_MAIN
    want = step_launches(codec, len(params))
    log({"phase": "train_path", "codec": art.codec, "arch": cfg.name,
         "num_layers": cfg.num_layers, "d_model": cfg.d_model,
         "vocab": cfg.vocab_size, "params": n_params, "voters": M_MAIN,
         "global_batch": GLOBAL_BATCH, "seq": SEQ,
         "state": sorted(opt_state), "resident_before_bytes": resident})

    ops.reset_launch_counts()
    seen = ops.launch_counts()
    step_ms, losses = [], []
    for step in range(STEPS):
        tokens = torch.as_tensor(pipe.global_batch_at(step)["tokens"],
                                 device=dev)
        if step == 0:   # saved copies for the bit-exact check of step 0
            p0 = params[leaf].clone()
            g0 = leaf_grads(torch, M, cfg, params, tokens, per, leaf)
            e0 = params["embed.table"].clone() if codec == "ternary2bit" \
                else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, met = art.step_fn(params, opt_state,
                                             {"tokens": tokens}, step)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss = float(met["loss"])
        counts = ops.launch_counts()
        per_step = {k: counts[k] - seen[k] for k in counts
                    if counts[k] != seen[k]}
        seen = counts
        line = {"codec": codec, "step": step, "loss": loss, "ms": ms,
                "launches": per_step}
        if "codec" in opt_state:
            line["flip_ema"] = opt_state["codec"]["flip_ema"].tolist()
        log(line)
        if not math.isfinite(loss):
            raise AssertionError(f"{codec} step {step}: loss {loss}")
        if per_step != want:
            raise AssertionError(f"{codec} step {step}: launches {per_step}, "
                                 f"expected {want}")
        step_ms.append(ms)
        losses.append(loss)
        if step == 0:
            check_codec_step0(torch, signum, tcfg, codec, leaf, p0, g0,
                              params, opt_state)
            if e0 is not None:   # untouched embedding rows abstain
                held = int((params["embed.table"] == e0).sum())
                log({"phase": "ternary_step0_embed_held_still",
                     "coords": held, "of": e0.numel()})
                if held == 0:
                    raise AssertionError("ternary2bit moved every embedding "
                                         "coordinate at step 0")
            del p0, g0, e0
    launches = ops.launch_counts()   # read just after the training path
    peak = torch.cuda.max_memory_allocated()
    if "codec" in opt_state:
        ema = opt_state["codec"]["flip_ema"]
        if not (torch.isfinite(ema).all() and (ema >= 0).all()
                and (ema <= 1).all()):
            raise AssertionError(f"flip_ema out of range: {ema.tolist()}")
    # step 0 carries the warm-up (cuBLAS handles, first launches)
    median = statistics.median(step_ms[1:])
    log({"phase": "train_path_done", "codec": codec, "losses": losses,
         "step_ms_median_1_4": median, "max_memory_allocated_bytes": peak,
         "max_memory_allocated_GiB": peak / 2 ** 30})
    for k, v in want.items():
        if launches[k] != STEPS * v:
            raise AssertionError(f"{codec} {k}: {launches[k]} launches over "
                                 f"the run, expected {STEPS * v}")
    profile_step(torch, art, params, opt_state, pipe, dev, n_params, median,
                 codec)
    if vote_after:
        for k, v in run_vote_path(torch, opt_state["momentum"], dev).items():
            launches[k] += v
        for k, v in run_plan_votes(torch, opt_state["momentum"],
                                   dev).items():
            launches[k] += v
    del params, opt_state, art
    torch.cuda.empty_cache()
    return launches, losses


def plain_votes(torch, ref, sc, label, x):
    """(n,) int8 votes of the stacked (M, n) payload `x` on wire `label`,
    composed from the plain versions (``kernels/ref.py``) and torch ops."""
    m, n = x.shape
    if label == "ternary_allgather_1bit":
        words = ref.ternary_majority(ref.ternary_pack(
            sc.pad_last(sc.sign_ternary(x), sc.PACK2)[0]))
        return ref.ternary_unpack(words[None])[0, :n]
    if label == "fused_allgather_1bit":
        words = ref.fused_majority(sc.pad_last(x, sc.PACK)[0])
        return ref.bitunpack(words[None], torch.int8)[0, :n]
    signs = sc.sign_ternary(x)
    if label == "staged_allgather_1bit":
        words = ref.majority(ref.bitpack(sc.pad_last(signs, sc.PACK)[0]))
        return ref.bitunpack(words[None], torch.int8)[0, :n]
    if label in ("psum_int8", "ternary_psum_int8"):
        return torch.sign(signs.sum(dim=0)).to(torch.int8)
    shards = sc.sign_binary(sc.pad_last(signs, sc.PACK * m)[0].sum(dim=0)
                            .view(m, -1))
    words = ref.bitpack(shards).view(1, -1)
    return ref.bitunpack(words, torch.int8)[0, :n]


def run_vote_path(torch, momentum, dev) -> dict:
    """Vote every leaf's trained (M, n) momentum on each wire of
    VOTE_WIRES through the vote API; returns the launches of the sign
    kernels summed over the wires."""
    from repro_torch.configs.base import VoteStrategy
    from repro_torch.core import sign_compress as sc
    from repro_torch.core import vote_api as va
    from repro_torch.kernels import ops, ref

    payloads = {k: v.view(v.shape[0], -1) for k, v in momentum.items()}
    n_leaves = len(payloads)
    n_total = sum(p.shape[1] for p in payloads.values())
    big = max(payloads, key=lambda k: payloads[k].numel())
    totals = {k: 0 for wire in VOTE_WIRES for k in wire[4]}
    fused_votes = psum_votes = None
    for label, use_kernels, strategy, codec, per_leaf, bits in VOTE_WIRES:
        backend = va.VirtualBackend(use_kernels=use_kernels, device=dev)
        requests = {k: va.VoteRequest(payload=p, form="stacked",
                                      strategy=VoteStrategy(strategy),
                                      codec=codec)
                    for k, p in payloads.items()}
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ops.reset_launch_counts()
        start.record()
        votes, wires = {}, {}
        for k, req in requests.items():
            out = backend.execute(req)
            votes[k], wires[k] = out.votes, out.wire
        end.record()
        end.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated()
        want = {k: v * n_leaves for k, v in per_leaf.items()}
        if launches != want:
            raise AssertionError(f"vote {label}: launches {launches}, "
                                 f"expected {want}")
        for k, v in launches.items():
            totals[k] += v
        for k, wire in wires.items():
            n = payloads[k].shape[1]
            if (wire.payload_bytes != n * bits / 8.0
                    or wire.n_voters != M_MAIN or wire.n_messages != 1
                    or wire.strategy.value != strategy):
                raise AssertionError(f"vote {label} leaf {k}: {wire}")
            if votes[k].shape != (n,) or votes[k].dtype != torch.int8:
                raise AssertionError(f"vote {label} leaf {k}: votes "
                                     f"{votes[k].dtype} {votes[k].shape}")
        require_equal(f"vote {label} {big} against the plain versions",
                      votes[big], plain_votes(torch, ref, sc, label,
                                              payloads[big]))
        if label == "fused_allgather_1bit":
            fused_votes = votes
        elif label == "staged_allgather_1bit":
            for k in payloads:
                require_equal(f"fused and staged 1-bit votes of {k}",
                              votes[k], fused_votes[k])
            fused_votes = None
        elif label == "psum_int8":
            psum_votes = votes
        elif label == "ternary_psum_int8":
            # ternary symbols are the counts psum_int8 already sums
            for k in payloads:
                require_equal(f"ternary2bit and sign1bit psum votes of {k}",
                              votes[k], psum_votes[k])
            psum_votes = None
        plus = sum(int((v == 1).sum()) for v in votes.values())
        zero = sum(int((v == 0).sum()) for v in votes.values())
        log({"phase": "vote", "wire": label, "use_kernels": use_kernels,
             "strategy": strategy, "codec": codec, "leaves": n_leaves,
             "coords": n_total,
             "voters": M_MAIN, "ms": ms, "launches": launches,
             "payload_bytes": sum(w.payload_bytes for w in wires.values()),
             "votes_plus": plus, "votes_zero": zero,
             "votes_minus": n_total - plus - zero,
             "max_memory_allocated_bytes": peak,
             "above_resident_bytes": peak - resident})
        del votes, wires, out
        profile_vote(torch, label, backend, requests)
        del requests
    for k, v in totals.items():
        if not v:
            raise AssertionError(f"the vote path never launched {k}")
    quickstart_vote(torch, va, VoteStrategy, dev)
    return totals


def profile_vote(torch, label, backend, requests) -> None:
    """One more whole-model vote on wire `label` under torch.profiler:
    device time by kernel, for the breakdown of the vote's time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for req in requests.values():
            backend.execute(req)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key[:120])
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    log({"phase": "vote_profile", "wire": label,
         "device_busy_ms": sum(ms for ms, _, _ in kernels),
         "top_kernels": [{"ms": ms, "count": c, "name": k}
                         for ms, c, k in kernels[:6]]})


def quickstart_vote(torch, va, VoteStrategy, dev) -> None:
    """examples/quickstart.py's 5 x 8 vote, on the card, on both paths."""
    import numpy as np
    g = np.random.default_rng(0).normal(size=(5, 8))
    want = np.where(2 * (g >= 0).sum(axis=0) >= 5, 1, -1)
    req = va.VoteRequest(payload=g, form="stacked",
                         strategy=VoteStrategy.ALLGATHER_1BIT)
    for use_kernels in (False, True):
        out = va.VirtualBackend(use_kernels=use_kernels,
                                device=dev).execute(req)
        got = out.votes.cpu().numpy()
        log({"phase": "quickstart_vote", "use_kernels": use_kernels,
             "worker_signs": np.sign(g).astype(int).tolist(),
             "majority_vote": got.tolist(),
             "wire_bytes_per_replica": out.wire.payload_bytes,
             "messages": out.wire.n_messages,
             "strategy": out.wire.strategy.value})
        if out.votes.device.type != dev.type or not (got == want).all():
            raise AssertionError(f"quickstart vote {got.tolist()} on "
                                 f"{out.votes.device}, expected "
                                 f"{want.tolist()}")


KERNEL_GROUPS = (("momentum_sign_pack", ("momentum_sign_pack_kernel",)),
                 ("ternary_pack", ("ternary_pack_kernel",)),
                 ("ternary_unpack", ("ternary_unpack_kernel",)),
                 ("ternary_majority_plus_one", ("PluralityPlusOne",)),
                 ("ternary_majority", ("TernaryLanes",)),
                 ("apply_ternary_vote", ("TernaryVote>",)),
                 ("majority", ("SignLanes",)),
                 ("apply_vote", ("SignVote>",)),
                 ("bitpack", ("bitpack_kernel",)),
                 ("bitunpack", ("bitunpack_kernel",)),
                 ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "cublas")),
                 ("elementwise", ("elementwise_kernel", "fillfunctor")),
                 ("reduce_softmax", ("reduce_kernel", "softmax",
                                     "logsumexp")))


#: the profiled steps' launches of PyTorch's copy kernels, by codec
COPY_LAUNCHES = {}


def profile_step(torch, art, params, opt_state, pipe, dev, n_params,
                 unprofiled_ms: float, codec: str) -> None:
    """One more step under torch.profiler: device time by kernel group, the
    device's idle share of an unprofiled step (the median of steps 1..4;
    the profiler's own host cost stretches the profiled step's wall time),
    the step's kernels' time beside their per-step bounds over all
    parameters, and its copy kernels. The plan step must launch no more
    copy kernels than phase 3's leaf-wise step: bitpack reads the plan's
    1-bit buckets in place."""
    from torch.profiler import ProfilerActivity, profile
    tokens = torch.as_tensor(pipe.global_batch_at(STEPS)["tokens"],
                             device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        art.step_fn(params, opt_state, {"tokens": tokens}, STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    kernels = []
    # PyTorch's copy kernels (.contiguous(), casts, slice writes), by name
    direct_copies = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        kernels.append((ms, e.count, e.key[:120]))
        if "direct_copy" in e.key:
            direct_copies.append({"ms": ms, "count": e.count,
                                  "name": e.key[:160]})
        low = e.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k.lower() in low for k in keys)), "other")
        groups[group] += ms
    busy = sum(groups.values())
    n = n_params
    m = M_MAIN
    per_step_bytes = {   # over all leaves, M voters, bf16 params
        "sign1bit": {"momentum_sign_pack": m * n * 10.125,
                     "majority": (m + 1) * n / 8, "apply_vote": n * 4.125},
        # m' alone (no sign words); then one f32 momentum row read, 2 bits
        # written, per voter
        "ternary2bit": {"momentum_sign_pack": m * n * 10,
                        "ternary_pack": m * n * 4.25,
                        "ternary_majority": (m + 1) * n / 4,
                        "apply_ternary_vote": n * 4.25},
        # m' alone; bitpack reads each voter's f32 t; bitunpack writes the
        # f32 vote
        "ef_sign": {"momentum_sign_pack": m * n * 10,
                    "bitpack": m * n * 4.125, "majority": (m + 1) * n / 8,
                    "apply_vote": n * 4.125, "bitunpack": n * 4.125},
        # bitunpack writes the (M, n) int8 signs; bitpack reads the int8
        # vote
        "weighted_vote": {"momentum_sign_pack": m * n * 10.125,
                          "bitunpack": m * n * 1.125,
                          "bitpack": n * 1.125, "apply_vote": n * 4.125},
        # the preset: bf16 g, m read, m' written, no words; ternary_pack
        # reads each voter's bf16 m' row and writes 2 bits
        # the plan path: m' alone; per bucket bitpack reads the (M, len)
        # int8 signs, bitunpack writes the int8 vote; per leaf ternary_pack
        # reads the int8 vote
        "plan": {"momentum_sign_pack": m * n * 10,
                 "bitpack": m * n * 1.125, "majority": (m + 1) * n / 8,
                 "bitunpack": n * 1.125, "ternary_pack": n * 1.25,
                 "apply_ternary_vote": n * 4.25},
        "preset": {"momentum_sign_pack": m * n * 6,
                   "ternary_pack": m * n * 2.25,
                   "ternary_majority": (m + 1) * n / 4,
                   "apply_ternary_vote": n * 4.25},
        # Mode B on hierarchical: ternary_pack reads each voter's bf16
        # gradient row and u's float32 row, 2 bits out each; the tally; the
        # vote unpacked to bf16; the momentum kernel reads the bf16 vote and
        # the float32 u, writes u (no words); the ternary apply
        "mode_b": {"ternary_pack": m * n * 2.25 + n * 4.25,
                   "ternary_majority_plus_one": (m + 1) * n / 4,
                   "ternary_unpack": n * 2.25,
                   "momentum_sign_pack": n * 10,
                   "apply_ternary_vote": n * 4.25},
    }[codec]
    per_step_bound = {k: b / HBM_BYTES_PER_S * 1e3
                      for k, b in per_step_bytes.items()}
    COPY_LAUNCHES[codec] = sum(c["count"] for c in direct_copies)
    log({"phase": "profiled_step", "codec": codec, "profiled_wall_ms": wall_ms,
         "unprofiled_step_ms": unprofiled_ms, "device_busy_ms": busy,
         "device_idle_share": (1 - busy / unprofiled_ms) if busy else None,
         "device_ms_by_group": groups,
         "kernel_ms_per_step": {k: groups[k] for k in per_step_bound},
         "kernel_bound_ms_per_step": per_step_bound,
         "direct_copy_launches": COPY_LAUNCHES[codec],
         "direct_copy_kernels": sorted(direct_copies, key=lambda c: -c["ms"]),
         "top_kernels": [{"ms": ms, "count": c, "name": k} for ms, c, k
                         in sorted(kernels, reverse=True)[:12]]})
    if codec == "plan" and COPY_LAUNCHES["plan"] > COPY_LAUNCHES["sign1bit"]:
        raise AssertionError(
            f"the plan step launched {COPY_LAUNCHES['plan']} copy kernels, "
            f"the leaf-wise step {COPY_LAUNCHES['sign1bit']}: a bucket was "
            "copied")


def check_codec_step0(torch, signum, tcfg, codec, leaf, p0, g0, params,
                      opt_state) -> None:
    """Step 0 of `leaf` under `codec`, recomputed from the saved parameters
    and gradients with the plain versions (momentum and ef_sign's residual
    start at zero): momentum, ef_sign's residual and the parameters
    bit-equal."""
    from repro_torch.core.codecs import ef_sign, weighted
    from repro_torch.kernels import ref
    eta = signum.lr_at(tcfg.optimizer, 0)
    wd = tcfg.optimizer.weight_decay
    n = p0.numel()
    m1 = opt_state["momentum"][leaf].view(M_MAIN, -1)
    inputs, words, rel = [], [], 0.0
    for r in range(M_MAIN):
        g = g0[r].reshape(1, -1)
        m_ref, bits = ref.momentum_sign_pack(
            g, torch.zeros(g.shape, dtype=torch.float32, device=g.device),
            BETA)
        require_equal(f"{codec} step 0 momentum of voter {r}",
                      m1[r].view(1, -1), m_ref)
        if codec == "ef_sign":
            t = torch.zeros_like(m_ref) + m_ref     # e + m', e = 0
            inputs.append(t)
            words.append(ref.bitpack(t)[0])
        elif codec == "ternary2bit":
            words.append(ref.ternary_pack(m_ref)[0])
        else:
            words.append(bits[0])
    words = torch.stack(words)
    p = p0.view(1, -1)
    if codec == "ternary2bit":
        p_ref = ref.apply_ternary_vote(p, ref.ternary_majority(words)[None],
                                       eta, wd)
    else:
        votes = ref.majority(words)
        if codec == "weighted_vote":
            stacked = ref.bitunpack(words, torch.int8)[:, :n]
            w = weighted.reliability_weights(
                opt_state["codec"]["flip_ema"].new_zeros(M_MAIN))
            vote, _ = weighted.decode_leaf_fixed(stacked, w)
            # the zero prior's equal weights decode the plain majority
            require_equal("weighted_vote step 0 vote against the majority",
                          ref.bitpack(vote.view(1, -1))[0], votes)
        p_ref = ref.apply_vote(p, votes[None], eta, wd)
        if codec == "ef_sign":
            # the residual bit for bit with the program's mean|t|, which is
            # itself held to a float64 sum of |t|
            vote = ref.bitunpack(votes[None], torch.float32)[0, :n]
            e1 = opt_state["error"][leaf].view(M_MAIN, -1)
            for r, t in enumerate(inputs):
                scale = ef_sign.scale_of(t)
                rel = max(rel, check_scale(
                    torch, f"ef_sign step 0 mean|t| of voter {r}", t, scale))
                require_equal(f"ef_sign step 0 residual of voter {r}", e1[r],
                              t[0] - scale * vote)
    require_equal(f"{codec} step 0 parameters", params[leaf].view(1, -1),
                  p_ref)
    line = {"phase": "step0_bit_equal", "codec": codec, "leaf": leaf,
            "coords": n, "ok": True}
    if codec == "ef_sign":
        line["scale_rel_err"] = rel
    log(line)


# ---------------------------------------------------------------------------
# phase 6: the glm4-9b preset's train step
# ---------------------------------------------------------------------------


def preset_launches(n_leaves: int) -> dict:
    """The kernel launches one step of the preset makes (M_MAIN voters, the
    count wire: bf16-m momentum_sign_pack without words, then ternary_pack
    of each voter's m' row; one tally and one apply per leaf)."""
    per_voter = M_MAIN * n_leaves
    return {"momentum_sign_pack": per_voter, "ternary_pack": per_voter,
            "ternary_majority": n_leaves, "apply_ternary_vote": n_leaves}


def preset_leaf_grads(torch, M, cfg, tcfg, params, tokens, leaf):
    """Each voter's accumulated gradient of `leaf`, by plain autograd per
    microbatch (each block checkpointed as the preset has it), summed in a
    bf16 accumulator from zeros and divided by the microbatch count, as the
    reference's acc_body scan does."""
    per = tokens.shape[0] // M_MAIN
    micro = tcfg.microbatches
    rows = per // micro
    out = []
    for r in range(M_MAIN):
        acc = torch.zeros_like(params[leaf], dtype=torch.bfloat16)
        for i in range(micro):
            leaves = dict(params)
            leaves[leaf] = params[leaf].detach().requires_grad_()
            start = r * per + i * rows
            loss, _ = M.loss_fn(cfg, leaves,
                                {"tokens": tokens[start:start + rows]},
                                remat=tcfg.remat)
            acc.add_(torch.autograd.grad(loss, [leaves[leaf]])[0].to(
                torch.bfloat16))
        out.append(acc.div_(micro))
    return out


def run_preset_path(torch, cfg, dev) -> dict:
    """Phase 6: the reference's configured glm4-9b training,
    ``make_train_step(cfg, default_train_config("glm4-9b", cell), 4)``, at
    every published width, depth cut to 2 layers, cell (seq 512, batch 32):
    bf16 per-worker momentum on psum_int8, 8 microbatches, remat="full",
    lr 1e-4, beta 0.9. Five steps from fresh state with exact launches per
    step, step 0 of PRESET_LEAF (its bf16 momentum rows and its update)
    bit-equal to the plain versions recomputed from saved copies, the peak
    memory and a profiled step. Returns the launches of the path."""
    from repro_torch.configs.base import ShapeCell, VoteStrategy
    from repro_torch.configs.presets import default_train_config
    from repro_torch.core import signum
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    cell = ShapeCell("train_smoke", PRESET_SEQ, PRESET_BATCH, "train")
    tcfg = default_train_config("glm4-9b", cell)
    opt = tcfg.optimizer
    if (opt.momentum_dtype, opt.vote_strategy, tcfg.microbatches,
            tcfg.remat) != ("bfloat16", VoteStrategy.PSUM_INT8, 8, "full"):
        raise AssertionError(f"not the glm4-9b preset: {tcfg}")
    n_params = cfg.param_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
    params, opt_state = TS.materialize_state(
        cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
    if any(m.dtype != torch.bfloat16 for m in opt_state["momentum"].values()):
        raise AssertionError("the preset's momentum is not bf16")
    pipe = SyntheticLMPipeline(cfg, tcfg.global_batch, tcfg.seq_len, seed=0)
    want = preset_launches(len(params))
    log({"phase": "preset_path", "arch": cfg.name,
         "num_layers": cfg.num_layers, "d_model": cfg.d_model,
         "vocab": cfg.vocab_size, "params": n_params, "voters": M_MAIN,
         "global_batch": tcfg.global_batch, "seq": tcfg.seq_len,
         "microbatches": tcfg.microbatches, "remat": tcfg.remat,
         "momentum_dtype": opt.momentum_dtype,
         "vote_strategy": art.vote_strategy.value, "lr": opt.learning_rate,
         "beta": opt.momentum, "state": sorted(opt_state),
         "resident_before_bytes": resident})

    ops.reset_launch_counts()
    seen = ops.launch_counts()
    step_ms, losses = [], []
    for step in range(STEPS):
        tokens = torch.as_tensor(pipe.global_batch_at(step)["tokens"],
                                 device=dev)
        if step == 0:   # saved copies for the bit-exact check of step 0
            p0 = params[PRESET_LEAF].clone()
            g0 = preset_leaf_grads(torch, M, cfg, tcfg, params, tokens,
                                   PRESET_LEAF)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, met = art.step_fn(params, opt_state,
                                             {"tokens": tokens}, step)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss = float(met["loss"])
        counts = ops.launch_counts()
        per_step = {k: counts[k] - seen[k] for k in counts
                    if counts[k] != seen[k]}
        seen = counts
        log({"preset": "glm4-9b", "step": step, "loss": loss, "ms": ms,
             "launches": per_step})
        if not math.isfinite(loss):
            raise AssertionError(f"preset step {step}: loss {loss}")
        if per_step != want:
            raise AssertionError(f"preset step {step}: launches {per_step}, "
                                 f"expected {want}")
        step_ms.append(ms)
        losses.append(loss)
        if step == 0:
            eta = signum.lr_at(opt, 0)
            mom = opt_state["momentum"][PRESET_LEAF].view(M_MAIN, -1)
            words = []
            for r in range(M_MAIN):
                g = g0[r].reshape(1, -1)
                m_ref, _ = ref.momentum_sign_pack(
                    g, torch.zeros_like(g), opt.momentum)
                require_equal(f"preset step 0 momentum of voter {r}",
                              mom[r].view(1, -1).view(torch.int16),
                              m_ref.view(torch.int16))
                words.append(ref.ternary_pack(m_ref)[0])
            p_ref = ref.apply_ternary_vote(
                p0.view(1, -1), ref.ternary_majority(torch.stack(words))[None],
                eta, opt.weight_decay)
            require_equal("preset step 0 parameters",
                          params[PRESET_LEAF].view(1, -1), p_ref)
            log({"phase": "step0_bit_equal", "codec": "preset",
                 "leaf": PRESET_LEAF, "coords": p0.numel(), "ok": True})
            del p0, g0, mom, words, p_ref
    launches = ops.launch_counts()   # read just after the preset path
    peak = torch.cuda.max_memory_allocated()
    median = statistics.median(step_ms[1:])
    log({"phase": "preset_path_done", "losses": losses,
         "step_ms_median_1_4": median, "max_memory_allocated_bytes": peak,
         "max_memory_allocated_GiB": peak / 2 ** 30})
    for k, v in want.items():
        if launches[k] != STEPS * v:
            raise AssertionError(f"preset {k}: {launches[k]} launches over "
                                 f"the run, expected {STEPS * v}")
    profile_step(torch, art, params, opt_state, pipe, dev, n_params, median,
                 "preset")
    del params, opt_state, art
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items() if v}


# ---------------------------------------------------------------------------
# the -ftz=true build: flushed float32 operations in the kernels' SASS
# ---------------------------------------------------------------------------

#: float32 SASS operations that must carry .FTZ (compares and arithmetic)
FTZ_OPS = ("FSETP", "FMUL", "FADD", "FFMA")


def check_ftz(build) -> None:
    """Each built library's float32 compares and arithmetic in its SASS
    (``cuobjdump -sass``) carry .FTZ: a subnormal operand reads as a zero
    and a subnormal result is flushed, as in the reference."""
    from pathlib import Path
    tool = str(Path(build.nvcc_path()).parent / "cuobjdump")
    counts = {}
    for name in build.SIGNATURES:
        sass = subprocess.run([tool, "-sass", str(build._target(name))],
                              check=True, capture_output=True,
                              text=True).stdout
        ops_seen = {op: [0, 0] for op in FTZ_OPS}
        bad, function = [], ""
        for line in sass.splitlines():
            if "Function :" in line:
                function = line.split("Function :")[1].strip()
            for op in FTZ_OPS:
                if f" {op}." in line or f" {op} " in line:
                    ops_seen[op][".FTZ" in line] += 1
                    if ".FTZ" not in line:
                        bad.append(f"{function}: {line.strip()}")
        counts[name] = {op: {"ftz": c[1], "not_ftz": c[0]}
                        for op, c in ops_seen.items() if any(c)}
        if bad:
            raise AssertionError(f"{name}: float32 SASS operations without "
                                 ".FTZ:\n" + "\n".join(bad[:12]))
    log({"phase": "ftz_sass", "ops": counts})


# ---------------------------------------------------------------------------
# phase 4b: the trained momentum voted through a VotePlan
# ---------------------------------------------------------------------------

#: the plan phases' bucket sizes: 13 buckets of the 1-bit (25 of the 2-bit)
#: wire at PLAN_BUCKET_BYTES, 197 at PLAN_SMALL_BUCKET_BYTES, over the
#: 1,649,439,744 coordinates of the cut glm4-9b
PLAN_BUCKET_BYTES, PLAN_SMALL_BUCKET_BYTES = 1 << 24, 1 << 20
FULL_PARAMS = 1_649_439_744
#: (bucket bytes, codec bits per coordinate) -> buckets at FULL_PARAMS
PLAN_BUCKETS = {(PLAN_BUCKET_BYTES, 1.0): 13, (PLAN_BUCKET_BYTES, 2.0): 25,
                (PLAN_SMALL_BUCKET_BYTES, 1.0): 197}
#: phase 4b's wires: (label, strategy, codec, the phase-4 wire whose
#: leaf-wise votes the plan's must equal, or None for a stateful codec)
PLAN_WIRES = (
    ("plan_staged_allgather_1bit", "allgather_1bit", "sign1bit",
     "staged_allgather_1bit"),
    ("plan_psum_int8", "psum_int8", "sign1bit", "psum_int8"),
    ("plan_hierarchical", "hierarchical", "sign1bit", "hierarchical"),
    ("plan_ternary_allgather_1bit", "allgather_1bit", "ternary2bit",
     "ternary_allgather_1bit"),
    ("plan_weighted_vote", "allgather_1bit", "weighted_vote", None),
)


def bucket_launches(bucket) -> dict:
    """The kernel launches of one bucket of the plan walk."""
    strategy = bucket.strategy.value
    if bucket.codec == "ternary2bit" and strategy == "allgather_1bit":
        return {"ternary_pack": 1, "ternary_majority": 1,
                "ternary_unpack": 1}
    if bucket.codec == "weighted_vote":
        return {"bitpack": 1, "bitunpack": 1}
    return {"allgather_1bit": {"bitpack": 1, "majority": 1, "bitunpack": 1},
            "hierarchical": {"bitpack": 1, "bitunpack": 1},
            "psum_int8": {}}[strategy]


def plan_launches(plan) -> dict:
    want = {}
    for b in plan.buckets:
        for k, v in bucket_launches(b).items():
            want[k] = want.get(k, 0) + v
    return want


def check_bucket_count(plan, n_total: int, bucket_bytes: int) -> None:
    bits = {"ternary2bit": 2.0}.get(plan.groups[0].codec, 1.0)
    want = PLAN_BUCKETS.get((bucket_bytes, bits))
    if n_total == FULL_PARAMS and want is not None \
            and plan.n_buckets != want:
        raise AssertionError(f"{plan.n_buckets} buckets, expected {want}")


def timed(torch, fn):
    """(fn(), CUDA-event ms, launches, peak above the memory resident
    before) of one call, the launch counts set to 0 just before it."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ops.reset_launch_counts()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    return (out, start.elapsed_time(end), launches,
            torch.cuda.max_memory_allocated() - resident)


def run_plan_votes(torch, momentum, dev) -> dict:
    """Phase 4b: the trained (M, n) momentum of every leaf flattened into
    one (M, n_params) int8 sign buffer (each voter's row written leaf by
    leaf, as the trainer's plan path writes it) and voted through the vote
    API with a VotePlan of PLAN_BUCKET_BYTES on each of PLAN_WIRES,
    synchronous and overlapped: exact launches per bucket, overlap
    bit-equal to sync, the stateless wires bit-equal to phase 4's
    leaf-wise votes of the same momentum; then plan_vote_stacked at both
    bucket sizes, one fused_majority and one bitunpack per bucket,
    bit-equal to the staged plan. Returns the launches of the phase."""
    from repro_torch.configs.base import VoteStrategy
    from repro_torch.core import vote_api as va
    from repro_torch.core import vote_plan as vp

    shapes = {k: tuple(v.shape[1:]) for k, v in momentum.items()}
    layout = vp.build_plan(shapes, bucket_bytes=PLAN_BUCKET_BYTES,
                           strategy=VoteStrategy.ALLGATHER_1BIT)
    n_total = layout.n_params
    torch.cuda.synchronize()
    signs = torch.empty((M_MAIN, n_total), dtype=torch.int8, device=dev)
    for r in range(M_MAIN):
        for slot in layout.leaves:
            vp.write_signs(slot, momentum[slot.name][r], signs[r])
    def copy_buckets(plan):
        for b in plan.buckets:
            signs[:, b.start:b.start + b.length].contiguous()

    # the per-bucket copies that remain (a bucket's columns are strided):
    # ternary_pack's buckets and fused_majority's (plan_vote_stacked);
    # bitpack reads a 1-bit bucket in place
    ternary = vp.build_plan(shapes, bucket_bytes=PLAN_BUCKET_BYTES,
                            strategy=VoteStrategy.ALLGATHER_1BIT,
                            default_codec="ternary2bit", data_size=M_MAIN)
    _, ternary_ms, _, _ = timed(torch, lambda: copy_buckets(ternary))
    _, fused_ms, _, _ = timed(torch, lambda: copy_buckets(layout))
    copy_bound, _ = bound(2 * M_MAIN * n_total, 0)
    log({"phase": "plan_bucket_copy", "ternary_buckets": ternary.n_buckets,
         "ternary_ms": ternary_ms, "fused_majority_buckets": layout.n_buckets,
         "fused_majority_ms": fused_ms, "bound_ms_each": copy_bound})
    backend = va.VirtualBackend(device=dev)
    totals, staged = {}, None
    for label, strategy, codec, leafwise in PLAN_WIRES:
        plan = vp.build_plan(shapes, bucket_bytes=PLAN_BUCKET_BYTES,
                             strategy=VoteStrategy(strategy),
                             default_codec=codec, data_size=M_MAIN)
        if plan.leaves != layout.leaves:
            raise AssertionError(f"{label}: the plan's layout moved")
        check_bucket_count(plan, n_total, PLAN_BUCKET_BYTES)
        want = plan_launches(plan)
        state = plan.init_server_state(M_MAIN, dev) or None
        outs = {}
        for overlap in (False, True):
            req = va.VoteRequest(payload=signs, form="stacked", plan=plan,
                                 server_state=state, overlap=overlap)
            out, ms, launches, above = timed(torch,
                                             lambda: backend.execute(req))
            if launches != want:
                raise AssertionError(f"{label} overlap={overlap}: launches "
                                     f"{launches}, expected {want}")
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            wire = out.wire
            if (wire.n_messages != plan.n_buckets or wire.n_voters != M_MAIN
                    or wire.strategy.value != strategy):
                raise AssertionError(f"{label}: {wire}")
            outs[overlap] = out
            line = {"phase": "plan_vote", "wire": label, "codec": codec,
                    "strategy": strategy, "overlap": overlap,
                    "buckets": plan.n_buckets, "coords": n_total, "ms": ms,
                    "launches": launches,
                    "payload_bytes": wire.payload_bytes,
                    "above_resident_bytes": above}
            if "flip_ema" in out.server_state:
                line["flip_ema"] = out.server_state["flip_ema"].tolist()
            log(line)
        require_equal(f"{label}: overlap against sync votes",
                      outs[True].votes, outs[False].votes)
        for k in outs[False].server_state:
            require_equal(f"{label}: overlap against sync {k}",
                          outs[True].server_state[k],
                          outs[False].server_state[k])
        if leafwise is not None:
            _, _, ls, lc, _, _ = next(w for w in VOTE_WIRES
                                      if w[0] == leafwise)
            for slot in plan.leaves:
                want_votes = backend.execute(va.VoteRequest(
                    payload=momentum[slot.name].view(M_MAIN, -1),
                    form="stacked", strategy=VoteStrategy(ls),
                    codec=lc)).votes
                require_equal(f"{label} against the leaf-wise {leafwise} "
                              f"votes of {slot.name}",
                              outs[False].votes[slot.offset:slot.offset
                                                + slot.length], want_votes)
        else:
            ema = outs[False].server_state["flip_ema"]
            if not (torch.isfinite(ema).all() and (ema >= 0).all()
                    and (ema <= 1).all()):
                raise AssertionError(f"{label}: flip_ema {ema.tolist()}")
        if label == "plan_staged_allgather_1bit":
            staged = outs[False].votes
        del outs
    for bucket_bytes in (PLAN_BUCKET_BYTES, PLAN_SMALL_BUCKET_BYTES):
        plan = vp.build_plan(shapes, bucket_bytes=bucket_bytes,
                             strategy=VoteStrategy.ALLGATHER_1BIT)
        check_bucket_count(plan, n_total, bucket_bytes)
        votes, ms, launches, above = timed(
            torch, lambda: vp.plan_vote_stacked(plan, signs))
        want = {"fused_majority": plan.n_buckets,
                "bitunpack": plan.n_buckets}
        if launches != want:
            raise AssertionError(f"plan_vote_stacked {bucket_bytes}: "
                                 f"launches {launches}, expected {want}")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        require_equal(f"plan_vote_stacked {bucket_bytes} against the staged "
                      "plan", votes, staged)
        log({"phase": "plan_vote_stacked", "bucket_bytes": bucket_bytes,
             "buckets": plan.n_buckets, "ms": ms, "launches": launches,
             "above_resident_bytes": above})
        del votes
    del signs, staged
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phase 8: the trainer's plan path
# ---------------------------------------------------------------------------

#: phase 8's runs: (label, optimizer options beside bucket_bytes, steps)
PLAN_RUNS = (
    ("plan", {}, STEPS),
    ("plan_overlap", {"overlap": True}, STEPS),
    ("plan_codec_map", {"codec_map": (("embed*", "ternary2bit"),)}, 2),
    ("plan_delayed", {"delayed_vote": True}, 2),
)


def plan_step_launches(plan, n_leaves: int) -> dict:
    """One plan step's launches: momentum_sign_pack without words per
    voter and leaf, the walk's per bucket, and per leaf the int8 vote's
    ternary_pack and apply_ternary_vote."""
    want = plan_launches(plan)
    want["momentum_sign_pack"] = M_MAIN * n_leaves
    for k in ("ternary_pack", "apply_ternary_vote"):
        want[k] = want.get(k, 0) + n_leaves
    return want


def run_plan_train_path(torch, cfg, dev, phase3_losses) -> dict:
    """Phase 8: phase 3's training (sign1bit on allgather_1bit) through a
    VotePlan of PLAN_BUCKET_BYTES, 5 steps from fresh state: exact launches
    per step, losses equal to phase 3's bit for bit; again with
    overlap=True; a codec map (the embedding on ternary2bit) for 2 steps
    with finite losses; delayed_vote for 2 steps, step 0 leaving every
    parameter as it was and step 1 applying exactly the int8 vote banked at
    step 0 (the plain versions recompute it). Peak memory per run and one
    profiled plan step. Returns the launches of the phase."""
    from repro_torch.core import signum
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.core import sign_compress as sc
    from repro_torch.train import train_step as TS

    totals = {}
    for label, opts, steps in PLAN_RUNS:
        base = train_config("sign1bit")
        tcfg = dataclasses.replace(base, optimizer=dataclasses.replace(
            base.optimizer, bucket_bytes=PLAN_BUCKET_BYTES, **opts))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
        params, opt_state = TS.materialize_state(
            cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
        pipe = SyntheticLMPipeline(cfg, GLOBAL_BATCH, SEQ, seed=0)
        want = plan_step_launches(art.plan, len(params))
        log({"phase": "plan_train_path", "run": label,
             "groups": [(g.codec, g.strategy.value, len(g.buckets))
                        for g in art.plan.groups],
             "vote_strategy": (art.vote_strategy.value
                               if art.vote_strategy else None),
             "state": sorted(opt_state), "launches_per_step": want})
        ops.reset_launch_counts()
        seen = ops.launch_counts()
        losses, step_ms, banked = [], [], None
        for step in range(steps):
            tokens = torch.as_tensor(pipe.global_batch_at(step)["tokens"],
                                     device=dev)
            if label == "plan_delayed":
                before = {k: p.clone() for k, p in params.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, met = art.step_fn(params, opt_state,
                                                 {"tokens": tokens}, step)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = ops.launch_counts()
            per_step = {k: counts[k] - seen[k] for k in counts
                        if counts[k] != seen[k]}
            seen = counts
            loss = float(met["loss"])
            log({"plan_run": label, "step": step, "loss": loss, "ms": ms,
                 "launches": per_step})
            if per_step != want:
                raise AssertionError(f"{label} step {step}: launches "
                                     f"{per_step}, expected {want}")
            if not math.isfinite(loss):
                raise AssertionError(f"{label} step {step}: loss {loss}")
            losses.append(loss)
            step_ms.append(ms)
            if label == "plan_delayed":
                check_delayed_step(torch, ref, sc, signum, tcfg, step,
                                   before, params, opt_state, banked)
                banked = {k: v.clone()
                          for k, v in opt_state["delayed"].items()}
                del before
        launches = ops.launch_counts()   # read just after the run
        peak = torch.cuda.max_memory_allocated()
        if label in ("plan", "plan_overlap") and losses != phase3_losses:
            raise AssertionError(f"{label}: losses {losses} differ from the "
                                 f"leaf-wise phase 3's {phase3_losses}")
        median = statistics.median(step_ms[1:])
        log({"phase": "plan_train_path_done", "run": label,
             "losses": losses, "equal_to_phase3": losses == phase3_losses[
                 :len(losses)],
             "step_ms": step_ms, "step_ms_median_1_on": median,
             "max_memory_allocated_bytes": peak,
             "max_memory_allocated_GiB": peak / 2 ** 30})
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        if label == "plan":
            profile_step(torch, art, params, opt_state, pipe, dev,
                         cfg.param_count(), median, "plan")
        del params, opt_state, art, banked
        torch.cuda.empty_cache()
    return totals


def check_delayed_step(torch, ref, sc, signum, tcfg, step, before, params,
                       opt_state, banked) -> None:
    """delayed_vote: step 0 leaves every parameter bit-equal to its value
    before it (weight decay 0); step 1 applies exactly the int8 vote
    banked at step 0 (the plain ternary pack and apply, recomputed)."""
    eta = signum.lr_at(tcfg.optimizer, step)
    for k, p in params.items():
        if step == 0:
            require_equal(f"delayed step 0 {k}: parameters held", p,
                          before[k])
            continue
        flat = before[k].view(1, -1)
        words = ref.ternary_pack(sc.pad_last(banked[k].view(1, -1),
                                             sc.PACK2)[0])
        want = ref.apply_ternary_vote(sc.pad_to_pack(flat, sc.PACK2)[0],
                                      words, eta,
                                      tcfg.optimizer.weight_decay)
        require_equal(f"delayed step 1 {k}: the vote banked at step 0",
                      p.view(1, -1), want[:, :flat.shape[1]])
        del words, want
    log({"phase": "delayed_vote_check", "step": step, "ok": True})


# ---------------------------------------------------------------------------
# phase 9: signSGD (beta = 0) on the 1-bit and the count wire
# ---------------------------------------------------------------------------

#: phase 9's runs: (vote strategy, steps)
BETA0_RUNS = (("allgather_1bit", 3), ("psum_int8", 3))
#: the leaf whose step 0 phases 9 and 11 recompute from saved copies
UNEMBED = "unembed.table"


def beta0_launches(strategy: str, n_leaves: int) -> dict:
    """One beta = 0 step's launches: each voter's bf16 gradient row packed
    (bitpack on the 1-bit wire, ternary_pack on the count wire), one tally
    and one apply per leaf; no momentum kernel."""
    per_voter = M_MAIN * n_leaves
    if strategy == "allgather_1bit":
        return {"bitpack": per_voter, "majority": n_leaves,
                "apply_vote": n_leaves}
    return {"ternary_pack": per_voter, "ternary_majority": n_leaves,
            "apply_ternary_vote": n_leaves}


def run_steps(torch, label, art, params, opt_state, pipe, steps, want,
              leaf, on_step0=None) -> tuple:
    """`steps` steps of `art` from fresh state with exact launches per step
    (the counts reset just before the first, read just after the last) and
    finite losses. `on_step0(tokens)` runs before step 0 to save copies (by
    autograd alone: it launches no kernel of the port); after step 0 the
    parameters and optimizer state of `leaf` are cloned. Returns (launches
    of the run, losses, step ms, (on_step0's result, the leaf's parameters
    after step 0, its state after step 0))."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    seen = ops.launch_counts()
    saved, losses, step_ms = None, [], []
    for step in range(steps):
        tokens = torch.as_tensor(pipe.global_batch_at(step)["tokens"],
                                 device=art.device)
        if step == 0 and on_step0 is not None:
            saved = on_step0(tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, met = art.step_fn(params, opt_state,
                                             {"tokens": tokens}, step)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        per_step = {k: counts[k] - seen[k] for k in counts
                    if counts[k] != seen[k]}
        seen = counts
        loss = float(met["loss"])
        log({"run": label, "step": step, "loss": loss, "ms": ms,
             "launches": per_step})
        if not math.isfinite(loss):
            raise AssertionError(f"{label} step {step}: loss {loss}")
        if per_step != want:
            raise AssertionError(f"{label} step {step}: launches {per_step},"
                                 f" expected {want}")
        losses.append(loss)
        step_ms.append(ms)
        if step == 0:
            saved = (saved, params[leaf].clone(),
                     {k: v[leaf].clone() for k, v in opt_state.items()
                      if isinstance(v, dict) and leaf in v})
    return ops.launch_counts(), losses, step_ms, saved


def run_signsgd_path(torch, cfg, dev) -> dict:
    """Phase 9: signSGD (beta = 0) at phase 3's size on allgather_1bit and
    psum_int8, 3 steps each from fresh state: exact launches per step (each
    voter's bf16 gradient row through bitpack or ternary_pack, one tally and
    one apply per leaf), finite losses, and step 0 of the unembedding
    bit-equal to the plain versions recomputed from saved copies of its
    parameters and gradients. Returns the launches (bf16 bitpack counted
    apart as "bitpack_bf16")."""
    from repro_torch.configs.base import VoteStrategy
    from repro_torch.core import signum
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import ref
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    totals = {}
    for strategy, steps in BETA0_RUNS:
        label = f"signsgd_{strategy}"
        base = train_config("sign1bit")
        tcfg = dataclasses.replace(base, optimizer=dataclasses.replace(
            base.optimizer, kind="signsgd_vote", momentum=0.0,
            vote_strategy=VoteStrategy(strategy)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
        params, opt_state = TS.materialize_state(
            cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
        pipe = SyntheticLMPipeline(cfg, GLOBAL_BATCH, SEQ, seed=0)
        per = GLOBAL_BATCH // M_MAIN
        want = beta0_launches(strategy, len(params))
        log({"phase": "signsgd_path", "strategy": strategy,
             "state": sorted(opt_state), "launches_per_step": want})

        def save(tokens):
            return (params[UNEMBED].clone(),
                    leaf_grads(torch, M, cfg, params, tokens, per, UNEMBED))
        launches, losses, step_ms, saved = run_steps(
            torch, label, art, params, opt_state, pipe, steps, want, UNEMBED,
            save)
        peak = torch.cuda.max_memory_allocated()
        (p0, g0), p1, _ = saved
        if g0[0].dtype != torch.bfloat16:
            raise AssertionError(f"{label}: gradients {g0[0].dtype}")
        eta = signum.lr_at(tcfg.optimizer, 0)
        wd = tcfg.optimizer.weight_decay
        rows = [g.reshape(1, -1) for g in g0]
        if strategy == "allgather_1bit":
            words = torch.stack([ref.bitpack(r)[0] for r in rows])
            p_ref = ref.apply_vote(p0.view(1, -1), ref.majority(words)[None],
                                   eta, wd)
        else:
            words = torch.stack([ref.ternary_pack(r)[0] for r in rows])
            p_ref = ref.apply_ternary_vote(
                p0.view(1, -1), ref.ternary_majority(words)[None], eta, wd)
        require_equal(f"{label} step 0 of {UNEMBED}", p1.view(1, -1), p_ref)
        log({"phase": "step0_bit_equal", "run": label, "leaf": UNEMBED,
             "coords": p0.numel(), "ok": True})
        del p0, g0, p1, rows, words, p_ref, saved
        log({"phase": "signsgd_path_done", "strategy": strategy,
             "losses": losses, "step_ms": step_ms,
             "step_ms_median_1_on": statistics.median(step_ms[1:]),
             "max_memory_allocated_bytes": peak})
        for k, v in launches.items():
            if v:
                key = ("bitpack_bf16" if k == "bitpack" else k)
                totals[key] = totals.get(key, 0) + v
        del params, opt_state, art
        torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phase 10: the qwen1.5-32b Mode B preset at full width
# ---------------------------------------------------------------------------

#: phase 10's runs: (vote strategy, steps); the first is the preset's own
MODE_B_RUNS = (("hierarchical", STEPS), ("psum_int8", 2),
               ("allgather_1bit", 2))
#: the Mode B preset's leaf whose step 0 is recomputed from saved copies
MODE_B_LEAF = "layers.attn_wq"


def mode_b_launches(strategy: str, n_leaves: int) -> dict:
    """One Mode B step's launches (beta > 0): each voter's bf16 gradient
    row packed (bitpack or ternary_pack); per leaf the tally, the vote
    unpacked to bf16, the momentum kernel (no words), ternary_pack of u
    and apply_ternary_vote."""
    per_voter = M_MAIN * n_leaves
    if strategy == "allgather_1bit":
        want = {"bitpack": per_voter, "majority": n_leaves,
                "bitunpack": n_leaves, "ternary_pack": n_leaves}
    else:
        tally = ("ternary_majority_plus_one" if strategy == "hierarchical"
                 else "ternary_majority")
        want = {"ternary_pack": per_voter + n_leaves, tally: n_leaves,
                "ternary_unpack": n_leaves}
    return {**want, "momentum_sign_pack": n_leaves,
            "apply_ternary_vote": n_leaves}


def run_mode_b_path(torch, dev) -> dict:
    """Phase 10: the reference's qwen1.5-32b training configuration,
    ``make_train_step(cfg, dataclasses.replace(default_train_config(
    "qwen1.5-32b", cell), fsdp=False), 4)`` at every published width,
    depth cut 64 -> 2, cell (seq 512, batch 32): signsgd_vote, one global
    float32 momentum at beta 0.9, hierarchical, 8 microbatches, nested
    remat. Five steps on hierarchical, then 2 each on psum_int8 and
    allgather_1bit, each from fresh state: exact launches, finite losses;
    on hierarchical step 0 of MODE_B_LEAF (its momentum and parameters)
    bit-equal to the plain versions recomputed from saved copies, and its
    vote bit-equal to the port's VirtualBackend hierarchical vote of the
    same gradients; the median step, the peak memory and one profiled
    step. Returns the launches (bf16 bitpack counted apart)."""
    from repro_torch.configs.base import (MomentumMode, ShapeCell,
                                          VoteStrategy, get_config)
    from repro_torch.configs.presets import default_train_config
    from repro_torch.core import sign_compress as sc
    from repro_torch.core import signum
    from repro_torch.core import vote_api as va
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import ref
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(get_config("qwen1.5-32b"), num_layers=2)
    cell = ShapeCell("train_smoke", PRESET_SEQ, PRESET_BATCH, "train")
    preset = default_train_config("qwen1.5-32b", cell)
    opt = preset.optimizer
    if (opt.kind, opt.momentum_mode, opt.vote_strategy, opt.momentum,
            opt.momentum_dtype, preset.microbatches, preset.remat,
            preset.fsdp) != ("signsgd_vote", MomentumMode.GLOBAL,
                             VoteStrategy.HIERARCHICAL, 0.9, "float32", 8,
                             "nested", True):
        raise AssertionError(f"not the qwen1.5-32b Mode B preset: {preset}")
    n_params = cfg.param_count()
    totals = {}
    for strategy, steps in MODE_B_RUNS:
        label = f"mode_b_{strategy}"
        # fsdp is cut: with a mesh its fused ZeRO backward votes inside the
        # reduce-scatter, which waits for the multi-process wire
        tcfg = dataclasses.replace(preset, fsdp=False,
                                   optimizer=dataclasses.replace(
                                       opt, vote_strategy=VoteStrategy(
                                           strategy)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
        params, opt_state = TS.materialize_state(
            cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
        if any(u.shape != params[k].shape or u.dtype != torch.float32
               for k, u in opt_state["momentum"].items()):
            raise AssertionError("Mode B's momentum is not one leaf-shaped "
                                 "float32 tensor per leaf")
        pipe = SyntheticLMPipeline(cfg, tcfg.global_batch, tcfg.seq_len,
                                   seed=0)
        want = mode_b_launches(strategy, len(params))
        log({"phase": "mode_b_path", "arch": cfg.name, "strategy": strategy,
             "num_layers": cfg.num_layers, "d_model": cfg.d_model,
             "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
             "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": n_params,
             "voters": M_MAIN, "global_batch": tcfg.global_batch,
             "seq": tcfg.seq_len, "microbatches": tcfg.microbatches,
             "remat": tcfg.remat, "fsdp": "cut: True -> False",
             "kind": opt.kind, "momentum_mode": opt.momentum_mode.value,
             "beta": opt.momentum, "lr": opt.learning_rate,
             "state": sorted(opt_state), "launches_per_step": want,
             "resident_before_bytes": resident})
        check = strategy == "hierarchical"

        def save(tokens):
            if not check:
                return None
            return (params[MODE_B_LEAF].clone(),
                    preset_leaf_grads(torch, M, cfg, tcfg, params, tokens,
                                      MODE_B_LEAF))
        launches, losses, step_ms, saved = run_steps(
            torch, label, art, params, opt_state, pipe, steps, want,
            MODE_B_LEAF, save)
        peak = torch.cuda.max_memory_allocated()
        median = statistics.median(step_ms[1:])
        log({"phase": "mode_b_path_done", "strategy": strategy,
             "losses": losses, "step_ms": step_ms,
             "step_ms_median_1_on": median,
             "max_memory_allocated_bytes": peak,
             "max_memory_allocated_GiB": peak / 2 ** 30})
        if peak >= 80e9:
            raise AssertionError(f"{label}: peak {peak} B")
        for k, v in launches.items():
            if v:
                key = ("bitpack_bf16" if k == "bitpack" else k)
                totals[key] = totals.get(key, 0) + v
        if check:
            profile_step(torch, art, params, opt_state, pipe, dev, n_params,
                         median, "mode_b")
            (p0, g0), p1, s1 = saved
            eta = signum.lr_at(tcfg.optimizer, 0)
            wd = tcfg.optimizer.weight_decay
            words = torch.stack([ref.ternary_pack(g.reshape(1, -1))[0]
                                 for g in g0])
            vote = ref.ternary_unpack(ref.ternary_majority(
                words, "plus_one")[None], torch.bfloat16)[0, :p0.numel()]
            u_ref, _ = ref.momentum_sign_pack(
                vote.view(1, -1), torch.zeros((1, p0.numel()),
                                              dtype=torch.float32,
                                              device=dev), opt.momentum)
            require_equal(f"{label} step 0 momentum of {MODE_B_LEAF}",
                          s1["momentum"].view(1, -1).view(torch.int32),
                          u_ref.view(torch.int32))
            p_ref = ref.apply_ternary_vote(p0.view(1, -1),
                                           ref.ternary_pack(u_ref), eta, wd)
            require_equal(f"{label} step 0 of {MODE_B_LEAF}",
                          p1.view(1, -1), p_ref)
            # the trainer's vote (at step 0 u = (1 - beta) * vote) against
            # the vote API's hierarchical wire on the same gradients
            api = va.VirtualBackend(device=dev).execute(va.VoteRequest(
                payload=torch.stack([g.reshape(-1) for g in g0]),
                form="stacked", strategy=VoteStrategy.HIERARCHICAL))
            require_equal(f"{label} step 0 vote against the vote API",
                          sc.sign_ternary(s1["momentum"].view(-1)),
                          api.votes)
            log({"phase": "step0_bit_equal", "run": label,
                 "leaf": MODE_B_LEAF, "coords": p0.numel(),
                 "vote_api_equal": True, "ok": True})
            del p0, g0, p1, s1, words, vote, u_ref, p_ref, api
        del params, opt_state, art, saved
        torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phase 11: the dense baselines
# ---------------------------------------------------------------------------

DENSE_KINDS = ("sgd", "sgdm", "adam")
DENSE_STEPS = 3


def mean_bound(g64):
    """The rounding bound of a bf16 sum of the (M, ...) gradients in any
    order, then divided by M (exact: a power of two): M - 1 roundings of
    partial sums, each at most bf16's unit roundoff 2^-8 times a partial
    sum, itself at most sum|g|; 2 % on top for the second-order terms."""
    m = g64.shape[0]
    return 1.02 * (m - 1) * 2.0 ** -8 * g64.abs().sum(0) / m


def check_sqrt(torch, dev) -> None:
    """PyTorch's float32 sqrt on the card against the float64 root rounded
    to float32, bit for bit, on 2^24 values from 0 to 1000 (Adam's root
    must be the nearest float32, as XLA's is; on the CPU PyTorch's is not,
    so the port's CPU path rounds the float64 root)."""
    x = torch.rand(1 << 24, generator=torch.Generator(device=dev)
                   .manual_seed(5), device=dev) * 1e3
    require_equal("float32 sqrt on the card is the nearest float32",
                  x.sqrt().view(torch.int32),
                  x.double().sqrt().float().view(torch.int32))
    log({"phase": "sqrt_nearest", "values": x.numel(), "ok": True})


def run_dense_path(torch, cfg, dev) -> None:
    """Phase 11: the dense baselines (sgd, sgdm, adam; the voters' mean
    gradient, a float32 update) at phase 3's size, 3 steps each from fresh
    state: no kernel launch, finite losses, the median step and the peak
    memory; for sgdm and adam the mean gradient of the unembedding at step
    0 (sgdm's m is the mean itself, adam's (1 - beta1) times it) within
    :func:`mean_bound` of a float64 sum of the four voters' gradients, and
    (sgdm) bit-equal to the bf16 sum in the port's order. Also
    PyTorch's float32 sqrt on the card against the float64 root rounded
    (the Adam update relies on it rounding to nearest)."""
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    check_sqrt(torch, dev)
    for kind in DENSE_KINDS:
        label = f"dense_{kind}"
        base = train_config("sign1bit")
        tcfg = dataclasses.replace(base, optimizer=dataclasses.replace(
            base.optimizer, kind=kind))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
        params, opt_state = TS.materialize_state(
            cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
        pipe = SyntheticLMPipeline(cfg, GLOBAL_BATCH, SEQ, seed=0)
        per = GLOBAL_BATCH // M_MAIN
        log({"phase": "dense_path", "kind": kind, "state": sorted(opt_state),
             "beta1": tcfg.optimizer.momentum, "lr": tcfg.optimizer
             .learning_rate})

        def save(tokens):
            return leaf_grads(torch, M, cfg, params, tokens, per, UNEMBED)
        _, losses, step_ms, saved = run_steps(
            torch, label, art, params, opt_state, pipe, DENSE_STEPS, {},
            UNEMBED, save)
        peak = torch.cuda.max_memory_allocated()
        del params, opt_state, art
        torch.cuda.empty_cache()
        g0, _, s1 = saved
        line = {"phase": "dense_path_done", "kind": kind, "losses": losses,
                "step_ms": step_ms,
                "step_ms_median_1_on": statistics.median(step_ms[1:]),
                "max_memory_allocated_bytes": peak,
                "max_memory_allocated_GiB": peak / 2 ** 30}
        if kind != "sgd":
            line.update(check_dense_mean(torch, kind, tcfg, g0, s1["m"]))
        log(line)
        del saved, g0, s1
        torch.cuda.empty_cache()


#: elements of the unembedding checked at a time in float64 (2 GB a chunk)
MEAN_CHUNK = 1 << 26


def check_dense_mean(torch, kind, tcfg, g0, m1) -> dict:
    """Step 0's mean gradient of the unembedding in the dense state `m1`
    (sgdm: m = the mean; adam: m = (1 - beta1) * mean, one more float32
    rounding) against a float64 sum of the voters' saved gradients `g0`,
    within :func:`mean_bound`; for sgdm also bit-equal to the bf16 sum in
    the port's order. Chunked, so the float64 copies stay at 2 GB."""
    total = g0[0].clone()
    for g in g0[1:]:
        total.add_(g)
    mean = total.div_(M_MAIN).float().view(-1)
    del total
    m1 = m1.view(-1)
    if kind == "sgdm":   # m = 0.9 * 0 + mean: the mean itself
        require_equal(f"dense_{kind} step 0 mean of {UNEMBED}", m1, mean)
    scale = 1.0 if kind == "sgdm" else 1 - tcfg.optimizer.momentum
    worst = slack_max = 0.0
    for start in range(0, mean.numel(), MEAN_CHUNK):
        part = slice(start, start + MEAN_CHUNK)
        g64 = torch.stack([g.view(-1)[part].double() for g in g0])
        want = g64.sum(0) / M_MAIN
        slack = mean_bound(g64)
        if kind == "adam":   # m / (1 - beta1): two float32 roundings
            slack += want.abs() * 2.0 ** -22
        err = (m1[part].double() / scale - want).abs()
        if (err > slack).any():
            raise AssertionError(
                f"dense_{kind}: mean gradient off a float64 sum by "
                f"{float(err.max())} (bound {float(slack.max())})")
        worst = max(worst, float(err.max()))
        slack_max = max(slack_max, float(slack.max()))
        del g64, want, slack, err
    return {"mean_grad_max_abs_err_vs_f64": worst,
            "mean_grad_bound_max": slack_max}


# ---------------------------------------------------------------------------
# phase 7: timing at the unembedding shape
# ---------------------------------------------------------------------------


def median_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, ops_done: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_done / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tally_at_more_voters(torch, kernel, gen, dev, n, per_word, ops_per_vote
                         ) -> list:
    """A tally's ms at TALLY_TIMED voters, each beside its bound: M + 1
    words moved per output word, `ops_per_vote` operations per voter and
    element."""
    rows = []
    for m, cut in TALLY_TIMED:
        n_m = n // cut
        w = -(-n_m // per_word)
        packed = torch.randint(-2 ** 31, 2 ** 31, (m, w), generator=gen,
                               device=dev, dtype=torch.int32)
        out = torch.empty(w, dtype=torch.int32, device=dev)
        b, by = bound((m + 1) * w * 4, ops_per_vote * m * n_m)
        rows.append({"voters": m, "n": n_m, "ms": median_ms(
            torch, lambda: kernel(packed, out=out), reps=25),
            "bound_ms": b, "bound_by": by})
        del packed, out
    return rows


def time_kernels(torch, ops, ref, sc, dev, launches, errs) -> list:
    gen = torch.Generator(device=dev).manual_seed(99)
    n, w = N_UNEMBED, sc.words_for(N_UNEMBED)
    rows = []

    def row(name, replaces, ms, plain, bytes_moved, ops_done, source,
            **extra):
        b, by = bound(bytes_moved, ops_done)
        # library_ms: no single PyTorch call computes any of these functions.
        # excess_ms, launches x (ms - bound_ms): the order in which the
        # kernels' time above their bounds costs the main path most
        rows.append({"name": name, "route": "cuda", "source": SOURCE + source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "max_diff": errs[name],
                     "ms": ms, "plain_ms": plain, "bound_ms": b,
                     "bound_by": by, "library_ms": None,
                     "excess_ms": launches[name] * (ms - b),
                     **{"shape": {"n": n, "voters": M_MAIN}, **extra}})

    def pack_stack(x):
        """ms of bitpack of the (rows, n) stack x, and of the same stack
        read one element past each row's start (off a 16-byte boundary:
        the element path)."""
        off = x.as_strided((x.shape[0], n - 1), (n, 1), 1)
        return (median_ms(torch, lambda: ops.bitpack(x), reps=25),
                median_ms(torch, lambda: ops.bitpack(off), reps=25))

    g = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    m = torch.randn(n, generator=gen, device=dev)
    words = torch.empty(w, dtype=torch.int32, device=dev)
    ms = median_ms(torch, lambda: ops.momentum_sign_pack(
        g, m, BETA, m_out=m, packed_out=words), reps=25)
    plain = median_ms(torch, lambda: ref.momentum_sign_pack(
        g.view(1, -1), m.view(1, -1), BETA), reps=5, warmup=1)
    # the ternary2bit / ef_sign encode: m' written, no words
    nopack_ms = median_ms(torch, lambda: ops.momentum_sign_pack(
        g, m, BETA, m_out=m, pack=False), reps=25)
    nopack_b, _ = bound(n * (2 + 4 + 4), 3 * n)
    # the stream yardstick: m += c * g moves the same bytes as m' without
    # the words (another function, so not library_ms)
    stream_ms = median_ms(torch, lambda: m.add_(g, alpha=1 - BETA), reps=25)
    # g bf16 read, m read and written, one bit out; 2 mul + 1 add
    row("momentum_sign_pack", "src/repro/kernels/signum_update.py:46", ms,
        plain, n * (2 + 4 + 4) + w * 4, 3 * n, "signum_update.cu",
        nopack_ms=nopack_ms, nopack_bound_ms=nopack_b, stream_ms=stream_ms,
        stream_bound_ms=nopack_b)
    del m
    # bf16 momentum (the preset path's instantiation): g bf16 read, m bf16
    # read and written, one bit out; 2 mul + 1 add and 3 roundings to bf16
    mb = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    ms = median_ms(torch, lambda: ops.momentum_sign_pack(
        g, mb, BETA, m_out=mb, packed_out=words), reps=25)
    plain = median_ms(torch, lambda: ref.momentum_sign_pack(
        g.view(1, -1), mb.view(1, -1), BETA), reps=5, warmup=1)
    # the count wire's encode: m' written, no words
    nopack_ms = median_ms(torch, lambda: ops.momentum_sign_pack(
        g, mb, BETA, m_out=mb, pack=False), reps=25)
    nopack_b, _ = bound(n * (2 + 2 + 2), 6 * n)
    stream_ms = median_ms(torch, lambda: mb.add_(g, alpha=1 - BETA),
                          reps=25)
    row("momentum_sign_pack_bf16m", "src/repro/kernels/signum_update.py:46",
        ms, plain, n * (2 + 2 + 2) + w * 4, 6 * n, "signum_update.cu",
        nopack_ms=nopack_ms, nopack_bound_ms=nopack_b, stream_ms=stream_ms,
        stream_bound_ms=nopack_b,
        shape={"n": n, "g": "bfloat16", "m": "bfloat16"})
    del g, mb, words

    packed = torch.randint(-2 ** 31, 2 ** 31, (M_MAIN, w), generator=gen,
                           device=dev, dtype=torch.int32)
    out = torch.empty(w, dtype=torch.int32, device=dev)
    ms = median_ms(torch, lambda: ops.majority(packed, out=out), reps=25)
    plain = median_ms(torch, lambda: ref.majority(packed), reps=5, warmup=1)
    del packed
    # M words read and one written per output word; an add per voter and bit
    row("majority", "src/repro/kernels/vote.py:37", ms, plain,
        (M_MAIN + 1) * w * 4, M_MAIN * n, "vote.cu",
        more_voters=tally_at_more_voters(torch, ops.majority, gen, dev, n,
                                         sc.PACK, 1))
    del out

    p = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    votes = torch.randint(-2 ** 31, 2 ** 31, (w,), generator=gen, device=dev,
                          dtype=torch.int32)
    ms = median_ms(torch, lambda: ops.apply_vote(p, votes, LR, 0.0, out=p),
                   reps=25)
    plain = median_ms(torch, lambda: ref.apply_vote(
        p.view(1, -1), votes[None], LR, 0.0), reps=5, warmup=1)
    # the stream yardstick: a bf16 copy of n elements moves 4 of apply's
    # 4.125 B per element (another function, so not library_ms)
    dst = torch.empty_like(p)
    stream_ms = median_ms(torch, lambda: dst.copy_(p), reps=25)
    stream_b, _ = bound(n * (2 + 2), 0)
    del p, dst
    p32 = torch.randn(n, generator=gen, device=dev)
    f32_ms = median_ms(torch, lambda: ops.apply_vote(p32, votes, LR, 0.0,
                                                     out=p32), reps=25)
    f32_b, _ = bound(n * (4 + 4) + w * 4, 4 * n)
    del p32
    # p bf16 read and written, one vote bit; mul, add, mul, sub
    row("apply_vote", "src/repro/kernels/signum_update.py:79", ms, plain,
        n * (2 + 2) + w * 4, 4 * n, "signum_update.cu", stream_ms=stream_ms,
        stream_bound_ms=stream_b, f32_ms=f32_ms, f32_bound_ms=f32_b)
    del votes

    x = torch.randn((M_MAIN, n), generator=gen, device=dev)
    ms = median_ms(torch, lambda: ops.fused_majority(x), reps=25)
    plain = median_ms(torch, lambda: ref.fused_majority(x), reps=5,
                      warmup=1)
    # the f32 stack read once, one word per 32 columns; a comparison and
    # an add per element
    row("fused_majority", "src/repro/kernels/fused_vote.py:52", ms, plain,
        M_MAIN * n * 4 + w * 4, 2 * M_MAIN * n, "fused_vote.cu")
    ms, elem_ms = pack_stack(x)
    plain = median_ms(torch, lambda: ref.bitpack(x), reps=5, warmup=1)
    del x
    # bf16 and int8 stacks: each read once, each row's words written; a
    # comparison per element
    bf16 = signed_payload(torch, gen, (M_MAIN, n), torch.bfloat16, dev)
    bf16_ms, bf16_elem_ms = pack_stack(bf16)
    bf16_plain = median_ms(torch, lambda: ref.bitpack(bf16), reps=5,
                           warmup=1)
    del bf16
    signs = signed_payload(torch, gen, (M_MAIN, n), torch.int8, dev)
    i8_ms, i8_elem_ms = pack_stack(signs)
    i8_plain = median_ms(torch, lambda: ref.bitpack(signs), reps=5,
                         warmup=1)
    del signs
    # the f32 stack read once, each row's words written; a comparison per
    # element. elem_ms: the element path (the first design), on the stack
    # read one element off each row's 16-byte boundary.
    row("bitpack", "src/repro/kernels/bitpack.py:47", ms, plain,
        M_MAIN * n * 4 + M_MAIN * w * 4, M_MAIN * n, "bitpack.cu",
        elem_ms=elem_ms, bf16_stack_ms=bf16_ms,
        bf16_stack_bound_ms=bound(M_MAIN * (n * 2 + w * 4), 0)[0],
        bf16_elem_ms=bf16_elem_ms)
    # the int8 signs of every staged 1-bit vote and plan bucket
    row("bitpack_i8", "src/repro/kernels/bitpack.py:47", i8_ms, i8_plain,
        M_MAIN * (n + w * 4), M_MAIN * n, "bitpack.cu", elem_ms=i8_elem_ms,
        shape={"n": n, "rows": M_MAIN, "dtype": "int8"})
    # the bf16 gradient rows of signSGD and Mode B on the 1-bit wire
    row("bitpack_bf16", "src/repro/kernels/bitpack.py:47", bf16_ms,
        bf16_plain, M_MAIN * (n * 2 + w * 4), M_MAIN * n, "bitpack.cu",
        elem_ms=bf16_elem_ms,
        shape={"n": n, "rows": M_MAIN, "dtype": "bfloat16"})
    words = torch.randint(-2 ** 31, 2 ** 31, (w,), generator=gen,
                          device=dev, dtype=torch.int32)
    ms = median_ms(torch, lambda: ops.bitunpack(words, n, torch.int8),
                   reps=25)
    plain = median_ms(torch, lambda: ref.bitunpack(words[None], torch.int8),
                      reps=5, warmup=1)
    # one bit read and one int8 sign written per element; a select each
    row("bitunpack", "src/repro/kernels/bitpack.py:64", ms, plain,
        w * 4 + n, n, "bitpack.cu")
    del words

    w2 = sc.ternary_words_for(n)
    signs = ternary_payload(torch, gen, (M_MAIN, n), torch.int8, dev)
    stack_ms = median_ms(torch, lambda: ops.ternary_pack(signs), reps=25)
    stack_b, _ = bound(M_MAIN * (n + w2 * 4), M_MAIN * n)
    del signs
    m_row = torch.randn((1, n), generator=gen, device=dev)
    out = torch.empty((1, w2), dtype=torch.int32, device=dev)
    ms = median_ms(torch, lambda: ops.ternary_pack(m_row, out=out), reps=25)
    plain = median_ms(torch, lambda: ref.ternary_pack(m_row), reps=5,
                      warmup=1)
    # the preset's count wire packs a bf16 m' row: 2 B read, 2 bits written
    b_row = m_row.to(torch.bfloat16)
    bf16_row_ms = median_ms(torch, lambda: ops.ternary_pack(b_row, out=out),
                            reps=25)
    bf16_row_b, _ = bound(n * 2 + w2 * 4, 2 * n)
    # the trainer's use: one f32 momentum row read, 2 bits written; a
    # compare and a shift per element. The vote API's (4, n) int8 wire
    # signs ride along as stack_*, the preset's bf16 row as bf16_row_*.
    row("ternary_pack", "src/repro/kernels/ternary_pack.py:61", ms, plain,
        n * 4 + w2 * 4, 2 * n, "ternary_pack.cu", stack_ms=stack_ms,
        stack_bound_ms=stack_b, stack_shape={"rows": M_MAIN,
                                             "dtype": "int8"},
        bf16_row_ms=bf16_row_ms, bf16_row_bound_ms=bf16_row_b)
    del m_row, b_row, out
    packed = torch.randint(-2 ** 31, 2 ** 31, (M_MAIN, w2), generator=gen,
                           device=dev, dtype=torch.int32)
    out = torch.empty(w2, dtype=torch.int32, device=dev)
    ms = median_ms(torch, lambda: ops.ternary_majority(packed, out=out),
                   reps=25)
    plain = median_ms(torch, lambda: ref.ternary_majority(packed), reps=5,
                      warmup=1)
    del packed
    # M words read and one written per 16 fields; two compares and an add
    # per voter and field
    row("ternary_majority", "src/repro/kernels/ternary_pack.py:79", ms,
        plain, (M_MAIN + 1) * w2 * 4, 3 * M_MAIN * n, "vote.cu",
        more_voters=tally_at_more_voters(torch, ops.ternary_majority, gen,
                                         dev, n, sc.PACK2, 3))
    # the hierarchical wire's tally (ties +1): the same words and counting,
    # another finisher
    packed = torch.randint(-2 ** 31, 2 ** 31, (M_MAIN, w2), generator=gen,
                           device=dev, dtype=torch.int32)
    plus = torch.empty(w2, dtype=torch.int32, device=dev)
    ms = median_ms(torch, lambda: ops.ternary_majority(
        packed, ties="plus_one", out=plus), reps=25)
    plain = median_ms(torch, lambda: ref.ternary_majority(packed, "plus_one"),
                      reps=5, warmup=1)
    del packed, plus
    row("ternary_majority_plus_one", "src/repro/kernels/ternary_pack.py:79",
        ms, plain, (M_MAIN + 1) * w2 * 4, 3 * M_MAIN * n, "vote.cu",
        ties="plus_one: hierarchical's sign_binary of the count "
        "(src/repro/core/vote_engine.py:255-315, jnp)")
    ms = median_ms(torch, lambda: ops.ternary_unpack(out, n), reps=25)
    plain = median_ms(torch, lambda: ref.ternary_unpack(out[None]), reps=5,
                      warmup=1)
    # Mode B's vote unpacked to bf16 (2 B a symbol), and ef_sign's on the
    # 2-bit wires to float32 (4 B)
    bf16_ms = median_ms(torch, lambda: ops.ternary_unpack(
        out, n, torch.bfloat16), reps=25)
    f32_ms = median_ms(torch, lambda: ops.ternary_unpack(
        out, n, torch.float32), reps=25)
    # 2 bits read and one int8 symbol written per element; a select each
    row("ternary_unpack", "src/repro/kernels/ops.py:155 (jnp, no "
        "pallas_call)", ms, plain, w2 * 4 + n, n, "ternary_pack.cu",
        bf16_ms=bf16_ms, bf16_bound_ms=bound(w2 * 4 + 2 * n, n)[0],
        f32_ms=f32_ms, f32_bound_ms=bound(w2 * 4 + 4 * n, n)[0])
    p = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    ms = median_ms(torch, lambda: ops.apply_ternary_vote(p, out, LR, 0.0,
                                                         out=p), reps=25)
    plain = median_ms(torch, lambda: ref.apply_ternary_vote(
        p.view(1, -1), out[None], LR, 0.0), reps=5, warmup=1)
    dst = torch.empty_like(p)
    stream_ms = median_ms(torch, lambda: dst.copy_(p), reps=25)
    del p, dst
    # p bf16 read and written, 2 vote bits; mul, add, mul, sub
    row("apply_ternary_vote", "src/repro/core/signum.py:232 (jnp apply, no "
        "pallas_call)", ms, plain, n * (2 + 2) + w2 * 4, 4 * n,
        "signum_update.cu", stream_ms=stream_ms, stream_bound_ms=stream_b)
    return rows


def main() -> int:
    # Phases 3-5 free and re-allocate tens of GB in blocks of many sizes;
    # expandable segments keep the cached memory from fragmenting so the
    # plain versions' large temporaries still find room (set before the
    # first CUDA allocation, which reads it).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    import repro_torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import sign_compress as sc
    from repro_torch.kernels import build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    log(smi)
    dev = repro_torch.resolve_device()
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0],
         "device": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    build.library("vote")
    log({"phase": "build", "seconds": time.perf_counter() - t0})
    for name, out in build.BUILD_LOG.items():
        for line in out.splitlines():
            if any(k in line for k in ("Function properties", "registers",
                                       "spill")):
                log(f"ptxas {name}: {line.strip()}")

    check_ftz(build)
    errs = check_kernels(torch, ops, ref, sc, dev)
    # every published width of glm4-9b; depth cut to 2 layers
    cfg = dataclasses.replace(get_config("glm4-9b"), num_layers=2)
    launches, sign1bit_losses = run_train_path(
        torch, cfg, dev, "sign1bit", "unembed.table", vote_after=True)
    ef_sign_packs = 0
    for codec, leaf in CHECK_LEAF.items():
        for k, v in run_train_path(torch, cfg, dev, codec, leaf)[0].items():
            launches[k] += v
            if codec == "ef_sign" and k == "bitpack":
                ef_sign_packs = v
    # every momentum_sign_pack launch of the preset path is the bf16-m one
    preset = run_preset_path(torch, cfg, dev)
    launches["momentum_sign_pack_bf16m"] = preset.pop("momentum_sign_pack")
    for k, v in preset.items():
        launches[k] += v
    for k, v in run_plan_train_path(torch, cfg, dev,
                                    sign1bit_losses).items():
        launches[k] += v
    # phases 9 and 10 count their bitpack launches, of bf16 gradient rows,
    # as "bitpack_bf16"
    launches["bitpack_bf16"] = 0
    for path in (run_signsgd_path(torch, cfg, dev),
                 run_mode_b_path(torch, dev)):
        for k, v in path.items():
            launches[k] += v
    run_dense_path(torch, cfg, dev)
    # ef_sign's encode packs its float32 t; every other bitpack of the main
    # path packs int8 signs (staged votes, plan buckets, weighted_vote's vote)
    launches["bitpack_i8"] = launches["bitpack"] - ef_sign_packs
    launches["bitpack"] = ef_sign_packs
    errs["bitpack_i8"] = errs["bitpack"]   # the max over every dtype's check
    errs["bitpack_bf16"] = errs["bitpack"]
    rows = time_kernels(torch, ops, ref, sc, dev, launches, errs)
    never = [r["name"] for r in rows if not r["launches"]]
    if never:
        raise AssertionError(f"the main path never launched {never}")
    log({"phase": "done", "seconds": time.perf_counter() - t_start})
    log({"kernels": rows})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
