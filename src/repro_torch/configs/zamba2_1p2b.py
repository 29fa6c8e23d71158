"""zamba2-1.2b — hybrid Mamba2 backbone + weight-shared attention block.

[arXiv:2411.15242; hf]  38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64.

Simplification vs the HF checkpoint (noted in DESIGN.md): the shared block
here consumes the residual stream directly (the released model concatenates
the original embedding and applies a LoRA per invocation); the backbone,
sharing pattern and shape budget match.
"""
from repro_torch.configs.base import ArchFamily, ModelConfig, SSMConfig, register


@register("zamba2-1.2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family=ArchFamily.HYBRID,
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32_000,
        head_dim=64,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=256),
        shared_attn_every=6,   # 6 shared-attn invocations over 38 mamba layers
        tie_embeddings=True,
    )
