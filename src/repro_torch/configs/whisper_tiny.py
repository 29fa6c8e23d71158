"""whisper-tiny — encoder-decoder transformer; conv frontend stubbed.

[arXiv:2212.04356; unverified]  4L (enc) + 4L (dec) d_model=384 6H (kv=6)
d_ff=1536 vocab=51865.  ``input_specs()`` provides precomputed mel-frame
embeddings in place of the 2x conv1d stem (embed_frontend_stub).
"""
from repro_torch.configs.base import SKIP_LONG, ArchFamily, ModelConfig, register


@register("whisper-tiny")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family=ArchFamily.AUDIO,
        num_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51_865,
        head_dim=64,
        encoder_layers=4,
        max_source_positions=1500,
        embed_frontend_stub=True,
        rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
        tie_embeddings=True,
        skip_shapes=(SKIP_LONG,),
    )
