"""qwen2-moe-a2.7b — MoE with 4 shared + 60 routed experts, top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (GQA kv=16)
expert d_ff=1408 vocab=151936; shared-expert branch 5632 (=4x1408) with a
learned sigmoid gate.
"""
from repro_torch.configs.base import SKIP_LONG, ArchFamily, ModelConfig, MoEConfig, register


@register("qwen2-moe-a2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family=ArchFamily.MOE,
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=0,
        vocab_size=151_936,
        head_dim=128,
        qkv_bias=True,
        moe=MoEConfig(
            num_experts=60,
            num_shared_experts=4,
            top_k=4,
            expert_d_ff=1408,
            shared_d_ff=5632,
        ),
        tie_embeddings=False,
        skip_shapes=(SKIP_LONG,),
    )
