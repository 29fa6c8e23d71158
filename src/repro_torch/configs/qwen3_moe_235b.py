"""qwen3-moe-235b-a22b — MoE with 128 routed experts, top-8, no shared.

[hf:Qwen/Qwen3-30B-A3B family; hf]  94L d_model=4096 64H (GQA kv=4)
expert d_ff=1536 vocab=151936.
"""
from repro_torch.configs.base import SKIP_LONG, ArchFamily, ModelConfig, MoEConfig, register


@register("qwen3-moe-235b-a22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family=ArchFamily.MOE,
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=151_936,
        head_dim=128,
        moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=1536),
        tie_embeddings=False,
        act_seq_shard=True,
        skip_shapes=(SKIP_LONG,),
    )
