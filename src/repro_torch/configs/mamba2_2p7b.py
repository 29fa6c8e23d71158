"""mamba2-2.7b — pure SSD (state-space duality) backbone, attention-free.

[arXiv:2405.21060; unverified]  64L d_model=2560 d_ff=0 vocab=50280,
ssm_state=128, head_dim=64 (80 heads at expand=2).
"""
from repro_torch.configs.base import ArchFamily, ModelConfig, SSMConfig, register


@register("mamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family=ArchFamily.SSM,
        num_layers=64,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50_280,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256),
        tie_embeddings=True,
    )
