"""qwen1.5-32b — dense transformer with QKV bias.

[hf:Qwen/Qwen1.5-0.5B family; hf]  64L d_model=5120 40H (GQA kv=40,
i.e. MHA) d_ff=27392 vocab=152064.

``act_seq_shard`` is a sharding constraint on the activations and nothing
else in the reference (``repro.models.transformer``); the port, on one
device, carries it and does nothing with it. ``kv_cache_dtype`` is for
serving only.
"""
from repro_torch.configs.base import SKIP_LONG, ArchFamily, ModelConfig, register


@register("qwen1.5-32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family=ArchFamily.DENSE,
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152_064,
        head_dim=128,
        qkv_bias=True,
        tie_embeddings=False,
        act_seq_shard=True,
        kv_cache_dtype="int8",  # MHA cache at 32k x 128 needs 5.5TB bf16
        skip_shapes=(SKIP_LONG,),
    )
