"""gemma3-12b — dense transformer, 5:1 local:global sliding-window pattern.

[hf:google/gemma-3-1b-pt family; unverified]  48L d_model=3840 16H
(GQA kv=8) d_ff=15360 vocab=262144; sliding window 1024, 128k context.
"""
from repro_torch.configs.base import SKIP_LONG, ArchFamily, ModelConfig, register


@register("gemma3-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        family=ArchFamily.DENSE,
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        d_ff=15360,
        vocab_size=262_144,
        head_dim=256,
        sliding_window=1024,
        local_to_global=5,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        # global layers are full attention -> long_500k skipped per brief
        skip_shapes=(SKIP_LONG,),
    )
