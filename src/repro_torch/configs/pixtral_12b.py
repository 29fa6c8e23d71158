"""pixtral-12b — VLM: mistral-nemo decoder backbone; ViT frontend stubbed.

[hf:mistralai/Pixtral-12B-2409; unverified]  40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072.  ``input_specs()`` provides precomputed patch
embeddings for the image prefix (embed_frontend_stub); text tokens embed
normally.
"""
from repro_torch.configs.base import SKIP_LONG, ArchFamily, ModelConfig, register


@register("pixtral-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family=ArchFamily.VLM,
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=131_072,
        head_dim=128,
        embed_frontend_stub=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        skip_shapes=(SKIP_LONG,),
    )
