"""deepseek-67b — llama-arch dense transformer, GQA kv=8.

[arXiv:2401.02954; hf]  95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400.
"""
from repro_torch.configs.base import SKIP_LONG, ArchFamily, ModelConfig, register


@register("deepseek-67b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        family=ArchFamily.DENSE,
        num_layers=95,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22016,
        vocab_size=102_400,
        head_dim=128,
        tie_embeddings=False,
        act_seq_shard=True,
        skip_shapes=(SKIP_LONG,),
    )
