"""Configuration system of the PyTorch port (a copy of ``repro.configs.base``).

Every assigned architecture is described by a :class:`ModelConfig`; training
and serving behaviour by :class:`TrainConfig` / :class:`ServeConfig`; the
optimizer (the paper's contribution) by :class:`OptimizerConfig`.

Configs are plain frozen dataclasses so they hash, compare and print
cleanly. The port keeps its own copy, field for field, so a config built
for one package means the same run in the other.

Parameters use a *stacked-layer* flat layout: homogeneous per-layer weights
are stored as one tensor with a leading ``num_layers`` axis (e.g.
``layers.attn_wq: (L, d, H*hd)``), the JAX package's layout, so parameters
carry across by name one to one. ``param_shapes()`` is the single source of
truth for init and the parameter counter.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Callable, Dict, Tuple

# ---------------------------------------------------------------------------
# enums
# ---------------------------------------------------------------------------


class ArchFamily(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    AUDIO = "audio"   # encoder-decoder, conv frontend stubbed
    VLM = "vlm"       # decoder backbone, patch frontend stubbed


class VoteStrategy(str, enum.Enum):
    """How the majority vote is realised on the mesh (DESIGN.md §2)."""

    PSUM_INT8 = "psum_int8"            # int8 all-reduce of signs
    ALLGATHER_1BIT = "allgather_1bit"  # paper-faithful wire protocol: packed AG + popcount
    HIERARCHICAL = "hierarchical"      # int8 RS in pod + int8 psum across pods + packed AG
    AUTO = "auto"                      # cheapest of the above per the comm cost model
                                       # (resolved by core.vote_engine.select_strategy)


class MomentumMode(str, enum.Enum):
    """DESIGN.md §3."""

    PER_WORKER = "per_worker"  # Mode A: Algorithm 1 verbatim
    GLOBAL = "global"          # Mode B: vote on sign(g), momentum on the vote


# ---------------------------------------------------------------------------
# model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0          # per-expert hidden size
    shared_d_ff: int = 0          # hidden size of the (merged) shared-expert branch
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 0            # N in SSD
    head_dim: int = 64            # P in SSD
    num_heads: int = 0            # derived d_inner // head_dim if 0
    expand: int = 2               # d_inner = expand * d_model
    chunk_size: int = 256         # SSD chunked-scan block
    conv_width: int = 4

    @property
    def enabled(self) -> bool:
        return self.state_dim > 0

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.num_heads or self.d_inner(d_model) // self.head_dim

    def conv_dim(self, d_model: int) -> int:
        # conv runs over [x, B, C] as in Mamba2
        return self.d_inner(d_model) + 2 * self.state_dim

    def in_proj_dim(self, d_model: int) -> int:
        # fused projection emits [z, x, B, C, dt]
        return 2 * self.d_inner(d_model) + 2 * self.state_dim + self.n_heads(d_model)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: ArchFamily
    num_layers: int
    d_model: int
    num_heads: int                # query heads; 0 for attention-free archs
    num_kv_heads: int             # GQA kv heads
    d_ff: int                     # dense FFN hidden (0 when every FFN is MoE/SSM)
    vocab_size: int
    head_dim: int = 0             # d_model // num_heads if 0
    qkv_bias: bool = False        # qwen1.5 style
    tie_embeddings: bool = True
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # sliding-window pattern (gemma3): `local_to_global` local layers per 1 global
    sliding_window: int = 0
    local_to_global: int = 0
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    # hybrid (zamba2): apply ONE weight-shared attention block after every
    # `shared_attn_every` mamba layers.
    shared_attn_every: int = 0
    # encoder-decoder (whisper): encoder depth (decoder depth = num_layers)
    encoder_layers: int = 0
    max_source_positions: int = 0
    # frontend stub: part of the input arrives as precomputed embeddings
    embed_frontend_stub: bool = False
    # shard the residual stream's sequence dim over 'model' between blocks
    # (sequence-parallel activations; big Mode-B archs enable it so scan
    # residuals stored for backward are 1/16 size)
    act_seq_shard: bool = False
    # KV-cache storage dtype; "int8" enables per-(position,head) symmetric
    # quantization with online-softmax chunked decode (qwen1.5-32b's MHA
    # cache at 32k x 128 exceeds pod HBM in bf16)
    kv_cache_dtype: str = "bfloat16"
    dtype: str = "bfloat16"
    # (shape_name, reason) pairs this arch does not run
    skip_shapes: Tuple[Tuple[str, str], ...] = ()

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == ArchFamily.SSM

    @property
    def num_shared_attn_calls(self) -> int:
        if not self.shared_attn_every:
            return 0
        return self.num_layers // self.shared_attn_every

    def layer_is_local(self, layer_idx: int) -> bool:
        """True if layer `layer_idx` uses sliding-window (local) attention."""
        if not self.sliding_window or not self.local_to_global:
            return False
        return (layer_idx % (self.local_to_global + 1)) != self.local_to_global

    def local_layer_mask(self) -> Tuple[bool, ...]:
        return tuple(self.layer_is_local(i) for i in range(self.num_layers))

    # ----- parameter shapes (stacked-layer layout) -----
    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        c = self
        d, hd, L = c.d_model, c.resolved_head_dim, c.num_layers
        shapes: Dict[str, Tuple[int, ...]] = {}
        shapes["embed.table"] = (c.vocab_size, d)
        if not c.tie_embeddings:
            shapes["unembed.table"] = (c.vocab_size, d)
        shapes["final_norm.scale"] = (d,)

        def attn(prefix: str, n: int, *, bias: bool) -> None:
            lead = (n,) if n else ()
            shapes[f"{prefix}_wq"] = lead + (d, c.num_heads * hd)
            shapes[f"{prefix}_wk"] = lead + (d, c.num_kv_heads * hd)
            shapes[f"{prefix}_wv"] = lead + (d, c.num_kv_heads * hd)
            shapes[f"{prefix}_wo"] = lead + (c.num_heads * hd, d)
            if bias:
                shapes[f"{prefix}_bq"] = lead + (c.num_heads * hd,)
                shapes[f"{prefix}_bk"] = lead + (c.num_kv_heads * hd,)
                shapes[f"{prefix}_bv"] = lead + (c.num_kv_heads * hd,)

        def mlp(prefix: str, n: int, d_ff: int) -> None:
            lead = (n,) if n else ()
            shapes[f"{prefix}_w_gate"] = lead + (d, d_ff)
            shapes[f"{prefix}_w_up"] = lead + (d, d_ff)
            shapes[f"{prefix}_w_down"] = lead + (d_ff, d)

        if c.family in (ArchFamily.SSM, ArchFamily.HYBRID):
            s = c.ssm
            di, nh = s.d_inner(d), s.n_heads(d)
            shapes["layers.norm1_scale"] = (L, d)
            # three separate projections (z | xBC | dt): a fused in_proj
            # splits a TP-sharded dim at non-shard-aligned offsets, forcing
            # a reshard every layer (measured on zamba2 train)
            shapes["layers.mamba_zproj"] = (L, d, di)
            shapes["layers.mamba_xbcproj"] = (L, d, di + 2 * s.state_dim)
            shapes["layers.mamba_dtproj"] = (L, d, nh)
            shapes["layers.mamba_conv_w"] = (L, s.conv_width, s.conv_dim(d))
            shapes["layers.mamba_conv_b"] = (L, s.conv_dim(d))
            shapes["layers.mamba_dt_bias"] = (L, nh)
            shapes["layers.mamba_A_log"] = (L, nh)
            shapes["layers.mamba_D"] = (L, nh)
            shapes["layers.mamba_norm_scale"] = (L, di)
            shapes["layers.mamba_out_proj"] = (L, di, d)
        else:
            shapes["layers.norm1_scale"] = (L, d)
            attn("layers.attn", L, bias=c.qkv_bias)
            shapes["layers.norm2_scale"] = (L, d)
            if c.moe.enabled:
                m = c.moe
                shapes["layers.router_w"] = (L, d, m.num_experts)
                shapes["layers.experts_w_gate"] = (L, m.num_experts, d, m.expert_d_ff)
                shapes["layers.experts_w_up"] = (L, m.num_experts, d, m.expert_d_ff)
                shapes["layers.experts_w_down"] = (L, m.num_experts, m.expert_d_ff, d)
                if m.num_shared_experts:
                    mlp("layers.shared", L, m.shared_d_ff)
                    shapes["layers.shared_gate_w"] = (L, d, 1)
            else:
                mlp("layers.mlp", L, c.d_ff)

        if c.shared_attn_every:  # zamba2 shared block (single weight set)
            shapes["shared_block.norm1_scale"] = (d,)
            attn("shared_block.attn", 0, bias=False)
            shapes["shared_block.norm2_scale"] = (d,)
            mlp("shared_block.mlp", 0, c.d_ff)

        if c.encoder_layers:  # whisper
            Le = c.encoder_layers
            shapes["enc_embed.pos"] = (c.max_source_positions, d)
            shapes["enc_final_norm.scale"] = (d,)
            shapes["encoder.norm1_scale"] = (Le, d)
            attn("encoder.attn", Le, bias=c.qkv_bias)
            shapes["encoder.norm2_scale"] = (Le, d)
            mlp("encoder.mlp", Le, c.d_ff)
            shapes["layers.norm_xattn_scale"] = (L, d)
            attn("layers.xattn", L, bias=c.qkv_bias)

        return shapes

    def param_count(self) -> int:
        return sum(math.prod(s) for s in self.param_shapes().values())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k of routed)."""
        if not self.moe.enabled:
            return self.param_count()
        shapes = self.param_shapes()
        routed = sum(math.prod(s) for k, s in shapes.items() if "experts_" in k)
        active_frac = self.moe.top_k / self.moe.num_experts
        return int(self.param_count() - routed * (1.0 - active_frac))


# ---------------------------------------------------------------------------
# optimizer / byzantine / train / serve configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "signum_vote"     # signum_vote | signsgd_vote | sgd | sgdm | adam
    learning_rate: float = 1e-4   # paper default
    momentum: float = 0.9         # paper default beta
    weight_decay: float = 0.0
    vote_strategy: VoteStrategy = VoteStrategy.PSUM_INT8
    momentum_mode: MomentumMode = MomentumMode.PER_WORKER
    momentum_dtype: str = "float32"
    error_feedback: bool = False  # beyond-paper EF-sign variant
    # gradient codec (DESIGN.md §8): sign1bit | ef_sign | ternary2bit |
    # weighted_vote. "sign1bit" is the paper's wire (bit-identical to the
    # pre-codec path); error_feedback=True is the legacy spelling of
    # codec="ef_sign" and resolves to it.
    codec: str = "sign1bit"
    # VotePlan (DESIGN.md §9): >0 flattens the explicitly-voted leaves
    # into one wire buffer cut into buckets of this many payload bytes
    # (one vote round per bucket); -1 (vote_plan.AUTO_BUCKET_BYTES) lets
    # the AUTO selector price a per-strategy size ladder; 0 keeps the
    # leaf-wise path (the default — flattening forfeits per-leaf 'model'
    # shardings, see core/vote_plan.py).
    bucket_bytes: int = 0
    # per-leaf codec assignment for the plan: ((glob, codec), ...) with
    # first-match-wins; unmatched leaves take `resolved_codec`. E.g.
    # (("embed*", "ternary2bit"), ("*", "sign1bit")). Requires
    # bucket_bytes > 0 (validated below).
    codec_map: Tuple[Tuple[str, str], ...] = ()
    # double-buffered schedule walk (DESIGN.md §11): bucket k's exchange
    # issued while bucket k-1 tallies. Bit-identical to the synchronous
    # walk; needs the bucketed plan (bucket_bytes != 0).
    overlap: bool = False
    # delayed-vote mode (DESIGN.md §11): apply step t's majority at step
    # t+1, hiding the entire vote round behind the next backward pass.
    # One-round int8 vote buffer rides in opt_state beside the momentum;
    # step 0 applies weight decay only. Mode A (per_worker) sign
    # optimizers only.
    delayed_vote: bool = False
    beta2: float = 0.999          # adam baseline
    eps: float = 1e-8
    warmup_steps: int = 0
    total_steps: int = 0          # 0 = constant lr

    def __post_init__(self):
        if self.bucket_bytes < -1:
            raise ValueError(
                f"bucket_bytes must be > 0, 0 (leaf-wise) or -1 (AUTO "
                f"ladder), got {self.bucket_bytes}")
        if self.codec_map and self.bucket_bytes == 0:
            # the map only applies to the VotePlan wire; accepting it
            # with the plan disabled would silently train every leaf on
            # `codec` instead of the mapped codecs
            raise ValueError(
                "codec_map needs bucket_bytes > 0 (or the -1 AUTO "
                "ladder): per-leaf codecs ride the bucketed VotePlan "
                "wire, DESIGN.md §9)")
        if self.overlap and self.bucket_bytes == 0:
            raise ValueError(
                "overlap=True double-buffers the bucketed VotePlan "
                "schedule; set bucket_bytes > 0 (or -1 for the AUTO "
                "ladder) or drop overlap (DESIGN.md §11)")
        if self.delayed_vote:
            if self.kind not in ("signum_vote", "signsgd_vote"):
                raise ValueError(
                    "delayed_vote applies the previous step's majority "
                    f"vote; optimizer kind {self.kind!r} has no vote "
                    "(DESIGN.md §11)")
            if self.momentum_mode != MomentumMode.PER_WORKER:
                raise ValueError(
                    "delayed_vote requires momentum_mode=per_worker "
                    "(Mode A): Mode B's fused ZeRO leaves vote inside "
                    "the backward reduce-scatter, which cannot be "
                    "deferred a step (DESIGN.md §11)")

    @property
    def resolved_codec(self) -> str:
        """The effective codec: explicit `codec`, with the legacy
        ``error_feedback`` flag mapping the default to ``ef_sign``.
        Combining the flag with a codec that carries no residual is a
        config error, never a silent drop of error feedback."""
        if self.error_feedback and self.codec not in ("sign1bit",
                                                      "ef_sign"):
            raise ValueError(
                f"error_feedback=True conflicts with codec="
                f"{self.codec!r}: only ef_sign carries an EF residual "
                "(spell the codec explicitly and drop the legacy flag)")
        if self.codec != "sign1bit":
            return self.codec
        return "ef_sign" if self.error_feedback else "sign1bit"


@dataclasses.dataclass(frozen=True)
class ByzantineConfig:
    """Simulated adversaries, compiled into train_step / the Scenario Lab.

    ``sign_flip`` / ``random`` / ``zero`` are the paper's non-cooperating
    models; ``colluding`` (all adversaries push one shared target
    direction) and ``blind`` (per-step per-coordinate flip probability)
    are the successor-paper models exercised by ``repro.sim``
    (DESIGN.md §7). The adaptive modes (``adaptive_flip`` /
    ``low_margin`` / ``reputation``, DESIGN.md §15) live in
    ``repro.core.attacks`` and additionally consume an observation
    channel threaded as ``VoteRequest.attack_obs``.

    Construct with arguments only through the ``repro.core.attacks``
    factories (``build_config`` / ``coalition_config``) — enforced
    outside ``core/`` by ``scripts/check_api_surface.py``."""

    mode: str = "none"    # byzantine.MODES | attacks.ATTACK_MODES
    num_adversaries: int = 0      # data-parallel replicas acting adversarially
    seed: int = 0
    flip_prob: float = 0.5        # blind mode: P(flip) per coordinate, per step
    target_fraction: float = 0.25  # low_margin: fraction of coords struck
    strike_below: float = 0.1     # reputation: strike while own EMA < this


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    global_batch: int
    seq_len: int
    microbatches: int = 1
    remat: str = "none"           # none | full | dots
    fsdp: bool = False            # ZeRO-3 param sharding over 'data'
    optimizer: OptimizerConfig = OptimizerConfig()
    byzantine: ByzantineConfig = ByzantineConfig()
    loss_dtype: str = "float32"
    seed: int = 0
    # per-step vote diagnostics (agreement/margin) in the metrics dict;
    # costs one extra psum per leaf, so off unless a trace consumer
    # (repro.sim / robustness benchmarks) asks for it
    diagnostics: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int
    context_len: int              # KV length (decode) / prompt length (prefill)
    mode: str = "decode"          # decode | prefill


# ---------------------------------------------------------------------------
# shape cells (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

SKIP_LONG = (
    "long_500k",
    "pure full-attention arch: 500k dense-attention decode is quadratic-history; "
    "per brief, run long_500k only for SSM/hybrid/linear-attn",
)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str) -> Callable[[Callable[[], ModelConfig]], Callable[[], ModelConfig]]:
    def deco(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def _ensure_loaded() -> None:
    if getattr(_ensure_loaded, "_done", False):
        return
    import importlib
    import pkgutil

    import repro_torch.configs as pkg

    for mod in pkgutil.iter_modules(pkg.__path__):
        if mod.name not in ("base", "__init__"):
            importlib.import_module(f"repro_torch.configs.{mod.name}")
    _ensure_loaded._done = True  # type: ignore[attr-defined]


def reduced_config(cfg: ModelConfig, **overrides: Any) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    small: Dict[str, Any] = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=32 if cfg.num_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
    )
    if cfg.moe.enabled:
        small["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=64,
            shared_d_ff=128 if cfg.moe.num_shared_experts else 0,
        )
    if cfg.ssm.enabled:
        small["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, num_heads=0, chunk_size=32
        )
    if cfg.shared_attn_every:
        small["num_layers"] = 4
        small["shared_attn_every"] = 2
    if cfg.encoder_layers:
        small["encoder_layers"] = 2
        small["max_source_positions"] = 64
    if cfg.sliding_window:
        small["sliding_window"] = 16
        small["local_to_global"] = cfg.local_to_global
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
