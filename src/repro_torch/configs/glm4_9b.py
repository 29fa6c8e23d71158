"""glm4-9b — dense transformer, RoPE, aggressive GQA (kv=2).

[hf:THUDM/glm-4-9b; hf]  40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552.
"""
from repro_torch.configs.base import SKIP_LONG, ArchFamily, ModelConfig, register


@register("glm4-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family=ArchFamily.DENSE,
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=151_552,
        head_dim=128,
        qkv_bias=True,  # glm4 uses qkv bias (add_qkv_bias=True)
        tie_embeddings=False,
        skip_shapes=(SKIP_LONG,),
    )
