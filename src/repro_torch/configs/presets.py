"""Per-arch training presets (``repro.configs.presets``; DESIGN.md §3/§5):
the optimizer mode, momentum dtype, vote strategy, microbatching, remat and
FSDP the reference trains each arch with.

Mode A (paper-faithful per-worker momentum) wherever the momentum fits a
chip; Mode B (vote-on-sign + global momentum, fused ZeRO backward) for the
three archs whose per-replica momentum exceeds HBM. Plain Python, the same
values as the reference's; the port's trainer runs every one of them
(FSDP through the fused ZeRO backward, ``train.train_step``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import (ByzantineConfig, MomentumMode,
                                      OptimizerConfig, ShapeCell, TrainConfig,
                                      VoteStrategy)

#: archs that need the scalable Mode-B + ZeRO-3 path
MODE_B_ARCHS = ("qwen1.5-32b", "deepseek-67b", "qwen3-moe-235b-a22b")
#: Mode-A archs whose fp32 per-worker momentum is tight -> bf16 momentum
BF16_MOMENTUM_ARCHS = ("gemma3-12b", "pixtral-12b", "glm4-9b",
                       "qwen2-moe-a2.7b")
#: per-arch grad-accumulation for Mode A train cells (activation memory);
#: every other arch takes 8
MICROBATCHES = {"whisper-tiny": 8, "zamba2-1.2b": 4, "mamba2-2.7b": 4,
                "qwen2-moe-a2.7b": 8, "qwen3-moe-235b-a22b": 4}


def default_optimizer(arch: str, *, kind: str = "signum_vote",
                      vote_strategy: Optional[VoteStrategy] = None
                      ) -> OptimizerConfig:
    if kind in ("sgd", "sgdm", "adam"):
        return OptimizerConfig(kind=kind, learning_rate=1e-4, momentum=0.9)
    if arch in MODE_B_ARCHS:
        return OptimizerConfig(
            kind="signsgd_vote",
            momentum_mode=MomentumMode.GLOBAL,
            vote_strategy=vote_strategy or VoteStrategy.HIERARCHICAL,
            learning_rate=1e-4, momentum=0.9)
    mom_dtype = ("bfloat16" if arch in BF16_MOMENTUM_ARCHS else "float32")
    return OptimizerConfig(
        kind="signum_vote",
        momentum_mode=MomentumMode.PER_WORKER,
        vote_strategy=vote_strategy or VoteStrategy.PSUM_INT8,
        momentum_dtype=mom_dtype,
        learning_rate=1e-4, momentum=0.9)


def default_train_config(arch: str, cell: ShapeCell, *,
                         kind: str = "signum_vote",
                         vote_strategy: Optional[VoteStrategy] = None,
                         byzantine: Optional[ByzantineConfig] = None
                         ) -> TrainConfig:
    """The train config of `arch` on shape `cell`: Mode A archs accumulate
    gradients over microbatches to bound activation memory and remat every
    block ("full"); Mode B archs take sqrt-remat over layer groups
    ("nested") and FSDP."""
    opt = default_optimizer(arch, kind=kind, vote_strategy=vote_strategy)
    return TrainConfig(
        global_batch=cell.global_batch,
        seq_len=cell.seq_len,
        microbatches=MICROBATCHES.get(arch, 8),
        remat="nested" if arch in MODE_B_ARCHS else "full",
        fsdp=arch in MODE_B_ARCHS,
        optimizer=opt,
        byzantine=byzantine or ByzantineConfig(),
    )
