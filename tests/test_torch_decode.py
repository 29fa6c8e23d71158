"""The port's decode paths (``repro_torch.models``: the caches, prefill and
one-token decode of all ten archs, ``layers.quantize_kv`` and the chunked
online-softmax decode) and its single-device serve-step builders
(``repro_torch.train.serve_step``) against the JAX package on the CPU.

Every arch's ``reduced_config`` in float32; parameters from the
reference's ``init_params``, handed to the port through
``params_from_numpy``; tokens from numpy.

(a) ``decode_step``, S = 16 steps from ``init_cache`` (two rows; whisper's
    cross K / V from both packages' prefill of the same frames): each
    step's logits and, after the last, every cache leaf against the
    reference's, within ``tests/torch_family_common.py``'s float32 bound
    (rtol 1e-4, atol max(1e-6, 2e-5 x the reference's largest
    magnitude)). qwen1.5's reduced config keeps its int8 cache, so that
    case is the int8 decode's.
(b) The port's own teacher-forced decode against its ``forward_logits``,
    rtol / atol 2e-3 (the reference's ``test_decode_matches_forward``;
    qwen1.5 with a float32 cache); one position a row against each row
    decoded alone; the decode's RoPE bit-equal to ``apply_rope``.
(c) ``prefill`` of the decoder-only families (pixtral with its patch
    prefix) and the encoder-decoder against the reference's: logits and
    every cache leaf; the reference's quirks asserted: the SSM and the
    hybrid return a zero cache, whisper zero self-attention caches, a VLM
    prompt without patches its tokens alone.
(d) The int8 cache: ``quantize_kv`` bit-equal to the reference's on
    float32 and bf16 inputs; qwen1.5's int8 decode within the reference
    test's bound (relative 0.15 at max(|logit|, 1)) of its bf16-cache twin.
(e) A cache longer than ``KV_CHUNK``, reached by lowering the port's
    module constant and the reference's module attribute to 16: the
    chunked path taken (counted), against the reference's, gemma3's local
    layers windowed; ``_decode_attention_chunked`` alone against the
    reference's at several positions, windowed and int8; a cache past
    ``KV_CHUNK`` and not a multiple of it refused (the reference leaves
    its last rows unread).
(f) ``make_cache_rehome``: the reference's re-home cases
    (``tests/test_serve_step.py``), ported.
(g) ``input_specs`` shapes and dtypes against the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro.configs import base as jbase  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.train import serve_step as jSS  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.train import serve_step as tSS  # noqa: E402
from torch_family_common import F32_ATOL_REL  # noqa: E402

ARCHS = jbase.list_archs()
S = 16
B = 2


def _cfgs(arch, **over):
    return (dataclasses.replace(jbase.reduced_config(jbase.get_config(arch)),
                                dtype="float32", **over),
            dataclasses.replace(tbase.reduced_config(tbase.get_config(arch)),
                                dtype="float32", **over))


_PARAMS = {}


def _params(arch, seed=0):
    """(reference params, port params) of the float32 reduced arch."""
    key = (arch, seed)
    if key not in _PARAMS:
        jc, _ = _cfgs(arch)
        jp = jM.init_params(jc, jax.random.PRNGKey(seed))
        _PARAMS[key] = (jp, tM.params_from_numpy(
            {k: np.asarray(v) for k, v in jp.items()}, device="cpu"))
    return _PARAMS[key]


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _frames(cfg, t_src=8, seed=2):
    return np.random.default_rng(seed).normal(
        size=(B, t_src, cfg.d_model)).astype(np.float32)


#: an int8 cache's decode multiplies bf16 chunks in both packages, each
#: rounding its products its own way: held to a bf16 rounding of the
#: largest logit (2^-8) and rtol 1e-2 instead of the float32 bound
BF16_ATOL_REL, BF16_RTOL = 2.0 ** -8, 1e-2


def _close(got, want, what, rtol=1e-4, atol_rel=F32_ATOL_REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    atol = max(1e-6, atol_rel * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _close_leaf(got, want, what):
    """A cache leaf: int8 values may differ by one quantization step
    where the float inputs' roundings put them on either side of a half,
    on under 0.1 % of the entries; float leaves within the float32
    bound."""
    if want.dtype == np.int8:
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and np.mean(d) < 1e-3, what
        return
    _close(got, want, what)


def _np(x):
    """A tensor or an array as numpy: int8 kept, floats as float32."""
    if isinstance(x, torch.Tensor):
        return x.numpy() if x.dtype == torch.int8 else x.float().numpy()
    x = jnp.asarray(x)
    return np.asarray(x if x.dtype == jnp.int8 else x.astype(jnp.float32))


def _caches(arch, jc, tc, jp, tp, max_len):
    """Both packages' zero caches; whisper's cross K / V filled by each
    package's prefill of the same frames."""
    jcache = jM.init_cache(jc, B, max_len)
    tcache = tM.init_cache(tc, B, max_len, device="cpu")
    if jc.family == jbase.ArchFamily.AUDIO:
        toks, frames = _tokens(jc, (B, 4)), _frames(jc)
        _, jpc = jM.prefill(jc, jp, {"tokens": jnp.asarray(toks),
                                     "enc_embeds": jnp.asarray(frames)})
        _, tpc = tM.prefill(tc, tp, {"tokens": torch.from_numpy(toks),
                                     "enc_embeds": torch.from_numpy(frames)})
        jcache["xk"], jcache["xv"] = jpc["xk"], jpc["xv"]
        tcache["xk"], tcache["xv"] = tpc["xk"], tpc["xv"]
    return jcache, tcache


# ---------------------------------------------------------------------------
# (a) decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    toks = _tokens(jc, (B, S))
    jcache, tcache = _caches(arch, jc, tc, jp, tp, S)
    assert sorted(tcache) == sorted(jcache)
    for k, v in jcache.items():
        assert tuple(tcache[k].shape) == v.shape, k
        assert str(tcache[k].dtype).split(".")[-1] == str(v.dtype), k
    step = jax.jit(lambda p, t, c, pos: jM.decode_step(jc, p, t, c, pos))
    for t in range(S):
        jl, jcache = step(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                          jnp.int32(t))
        tl, tcache = tM.decode_step(tc, tp, torch.from_numpy(
            toks[:, t:t + 1]), tcache, t)
        _close(tl.numpy(), jl, f"{arch} logits at {t}")
    for k, v in jcache.items():
        _close_leaf(_np(tcache[k]), _np(v), f"{arch} cache {k}")


# ---------------------------------------------------------------------------
# (b) the port's own decode against its forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced decode logits == forward logits at every position
    (whisper: its cross K / V from the prefill of the forward's frames;
    qwen1.5 with a full-precision cache: its int8 one is (d)'s)."""
    _, tc = _cfgs(arch, kv_cache_dtype="bfloat16")
    _, tp = _params(arch)
    toks = torch.from_numpy(_tokens(tc, (1, S)))
    batch = {"tokens": toks}
    cache = tM.init_cache(tc, 1, S, device="cpu")
    if tc.family == tbase.ArchFamily.AUDIO:
        batch["enc_embeds"] = torch.from_numpy(_frames(tc)[:1])
        _, pc = tM.prefill(tc, tp, batch)
        cache["xk"], cache["xv"] = pc["xk"], pc["xv"]
    with torch.no_grad():
        full, _ = tM.forward_logits(tc, tp, batch)
    outs = []
    for t in range(S):
        lg, cache = tM.decode_step(tc, tp, toks[:, t:t + 1], cache, t)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen2-moe-a2.7b",
                                  "zamba2-1.2b", "qwen1.5-32b"])
def test_rows_decode_at_their_own_positions(arch):
    """One position a row (the engine's slots): each row's logits and
    cache lane equal that row decoded alone at its positions (gemma3
    past its window of 16, the MoE routed a row at a time, the hybrid's
    shared-block slot, the int8 cache)."""
    _, tc = _cfgs(arch)
    _, tp = _params(arch)
    toks = torch.from_numpy(_tokens(tc, (B, 24)))
    starts = (0, 5)          # row 1 starts 5 positions later
    cache = tM.init_cache(tc, B, 32, device="cpu")
    solo = [tM.init_cache(tc, 1, 32, device="cpu") for _ in range(B)]
    for t in range(24 - starts[1]):
        pos = torch.tensor([t + s for s in starts])
        tok = torch.stack([toks[b, t + starts[b]] for b in range(B)])[:, None]
        got, cache = tM.decode_step(tc, tp, tok, cache, pos)
        for b in range(B):
            want, solo[b] = tM.decode_step(tc, tp, tok[b:b + 1], solo[b],
                                           int(pos[b]))
            _close(got[b].numpy(), want[0].numpy(), f"{arch} row {b}")
    for b in range(B):
        for k, v in solo[b].items():
            _close_leaf(_np(cache[k][:, b]), _np(v[:, 0]), k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_rope_is_apply_rope(dtype):
    """The decode's RoPE tables (each half repeated to the head's width,
    shared by the layers) give ``apply_rope`` the result of the half-width
    tables bit for bit, and both the half-split form ``x1 c - x2 s``,
    ``x1 s + x2 c`` in float32, the reference's."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((8, 1, 4, 32), generator=g) * 3).to(getattr(torch,
                                                                 dtype))
    pos = torch.tensor([0, 1, 5, 77, 1023, 4095, 100_000, 3])
    cos, sin = tL.rope_cos_sin(pos[:, None], 32, 10_000.0)
    c, s = tL.DecodePositions(pos, 8, "cpu").rope(32, 10_000.0)
    got = tL.apply_rope(x, c, s)
    assert torch.equal(got, tL.apply_rope(x, cos, sin))
    x1, x2 = x.float().chunk(2, dim=-1)
    hc, hs = cos[..., None, :], sin[..., None, :]
    want = torch.cat([x1 * hc - x2 * hs, x1 * hs + x2 * hc], dim=-1)
    assert torch.equal(got, want.to(x.dtype))


# ---------------------------------------------------------------------------
# (c) prefill
# ---------------------------------------------------------------------------

PREFILL_ARCHS = ["glm4-9b", "gemma3-12b", "qwen1.5-32b", "deepseek-67b",
                 "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "pixtral-12b",
                 "whisper-tiny"]


def _prefill_batch(cfg, seq=12):
    batch = {"tokens": _tokens(cfg, (B, seq))}
    if cfg.family == jbase.ArchFamily.VLM:
        batch["patch_embeds"] = np.random.default_rng(3).normal(
            size=(B, 4, cfg.d_model)).astype(np.float32)
    if cfg.family == jbase.ArchFamily.AUDIO:
        batch["enc_embeds"] = _frames(cfg)
    return batch


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_matches_the_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    batch = _prefill_batch(jc)
    jl, jcache = jM.prefill(jc, jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    tl, tcache = tM.prefill(tc, tp, tM.params_from_numpy(batch, "cpu"))
    _close(tl.numpy(), jl, f"{arch} prefill logits")
    assert sorted(tcache) == sorted(jcache)
    for k, v in jcache.items():
        _close_leaf(_np(tcache[k]), _np(v), f"{arch} cache {k}")
    if jc.family == jbase.ArchFamily.AUDIO:   # zero self-attention caches
        assert not tcache["k"].any() and not tcache["v"].any()


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_recurrent_prefill_returns_a_zero_cache(arch):
    """The reference's quirk: prefill is the forward pass, its cache the
    family's zero cache at the prompt's length."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    toks = _tokens(jc, (B, 12))
    jl, jcache = jM.prefill(jc, jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = tM.prefill(tc, tp, {"tokens": torch.from_numpy(toks)})
    _close(tl.numpy(), jl, f"{arch} prefill logits")
    for k, v in jcache.items():
        assert tuple(tcache[k].shape) == v.shape, k
        assert not np.asarray(v).any() and not tcache[k].any(), k


def test_vlm_prefill_without_patches_is_its_tokens_alone():
    _, tc = _cfgs("pixtral-12b")
    _, tp = _params("pixtral-12b")
    toks = torch.from_numpy(_tokens(tc, (B, 12)))
    logits, cache = tM.prefill(tc, tp, {"tokens": toks})
    with torch.no_grad():
        full, _ = tM.forward_logits(tc, tp, {"tokens": toks})
    assert cache["k"].shape[2] == 12
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# (d) the int8 cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_the_references(dtype):
    x = np.random.default_rng(4).normal(size=(3, 5, 2, 32)).astype(
        np.float32) * np.float32(3.0)
    x[0, 0, 0] = 0.0                              # an all-zero row
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    jq, js = jL.quantize_kv(jx)
    tq, ts = tL.quantize_kv(tM.params_from_numpy({"x": np.asarray(jx)},
                                                 "cpu")["x"])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))


def test_int8_cache_close_to_the_bf16_cache():
    """The reference's ``test_int8_kv_cache_decode`` on the port."""
    _, tc = _cfgs("qwen1.5-32b")
    _, tp = _params("qwen1.5-32b")
    toks = torch.from_numpy(_tokens(tc, (1, 8)))
    outs = {}
    for name, kv in (("q", "int8"), ("f", "bfloat16")):
        c = dataclasses.replace(tc, kv_cache_dtype=kv)
        cache = tM.init_cache(c, 1, 8, device="cpu")
        o = []
        for t in range(8):
            lg, cache = tM.decode_step(c, tp, toks[:, t:t + 1], cache, t)
            o.append(lg.numpy())
        outs[name] = np.stack(o, 1)
    denom = np.maximum(np.abs(outs["f"]), 1.0)
    assert np.max(np.abs(outs["q"] - outs["f"]) / denom) < 0.15


# ---------------------------------------------------------------------------
# (e) a cache longer than KV_CHUNK
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen1.5-32b"])
def test_long_cache_takes_the_chunked_path(arch, monkeypatch):
    """KV_CHUNK lowered to 16 in both packages (the reference's through
    its module attribute) and a cache of 48: every layer's decode takes
    the chunked online softmax (three chunks; gemma3's local layers
    windowed at 16, so early chunks fall out of the window)."""
    monkeypatch.setattr(tL, "KV_CHUNK", 16)
    monkeypatch.setattr(jL, "KV_CHUNK", 16)
    calls = []
    chunked = tL._decode_attention_chunked
    monkeypatch.setattr(tL, "_decode_attention_chunked",
                        lambda *a: calls.append(1) or chunked(*a))
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    steps, max_len = 40, 48
    toks = _tokens(jc, (B, steps))
    jcache, tcache = _caches(arch, jc, tc, jp, tp, max_len)
    tol = ({} if tc.kv_cache_dtype != "int8" else
           {"rtol": BF16_RTOL, "atol_rel": BF16_ATOL_REL})
    # a fresh jit: its trace reads the lowered constant
    step = jax.jit(lambda p, t, c, pos: jM.decode_step(jc, p, t, c, pos))
    for t in range(steps):
        jl, jcache = step(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                          jnp.int32(t))
        tl, tcache = tM.decode_step(tc, tp, torch.from_numpy(
            toks[:, t:t + 1]), tcache, t)
        _close(tl.numpy(), jl, f"{arch} logits at {t}", **tol)
    assert len(calls) == steps * tc.num_layers
    for k, v in jcache.items():
        _close_leaf(_np(tcache[k]), _np(v), f"{arch} cache {k}")


@pytest.mark.parametrize("quantized", [False, True])
def test_chunked_decode_refuses_rows_it_would_not_read(quantized,
                                                       monkeypatch):
    """A cache longer than KV_CHUNK and not a multiple of it raises: the
    reference reads ``T // KV_CHUNK`` chunks and silently leaves the last
    rows unattended. A multiple of it, or any length up to it, decodes."""
    monkeypatch.setattr(tL, "KV_CHUNK", 16)
    cfg = _cfgs("glm4-9b", kv_cache_dtype="int8" if quantized else
                "bfloat16")[1]
    params = tM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    for max_len in (12, 16, 32):
        cache = tM.init_cache(cfg, 1, max_len, device="cpu")
        logits, _ = tM.decode_step(cfg, params, tok, cache, max_len - 1)
        assert torch.isfinite(logits).all()
    cache = tM.init_cache(cfg, 1, 40, device="cpu")
    with pytest.raises(ValueError, match="rows 32-39"):
        tM.decode_step(cfg, params, tok, cache, 3)


@pytest.mark.parametrize("pos,window,quantized", [
    (0, None, False), (100, None, False), (191, None, False),
    (150, 40, False), (70, 16, True), (191, None, True)])
def test_chunked_decode_attention_matches_the_reference(pos, window,
                                                        quantized,
                                                        monkeypatch):
    monkeypatch.setattr(tL, "KV_CHUNK", 64)
    monkeypatch.setattr(jL, "KV_CHUNK", 64)
    rng = np.random.default_rng(pos)
    Bq, T, K, G, D = 2, 192, 2, 3, 16
    q = rng.normal(size=(Bq, 1, K, G, D)).astype(np.float32)
    kc = rng.normal(size=(Bq, T, K, D)).astype(np.float32)
    vc = rng.normal(size=(Bq, T, K, D)).astype(np.float32)
    jargs = [jnp.asarray(kc), jnp.asarray(vc), None, None]
    if quantized:
        (kq, ks), (vq, vs) = jL.quantize_kv(jargs[0]), jL.quantize_kv(
            jargs[1])
        jargs = [kq, vq, ks, vs]
    targs = [None if a is None else tM.params_from_numpy(
        {"a": np.asarray(a)}, "cpu")["a"] for a in jargs]
    want = jL._decode_attention_chunked(
        jnp.asarray(q), jargs[0], jargs[1], jnp.int32(pos),
        None if window is None else jnp.int32(window), jargs[2], jargs[3],
        D ** -0.5)
    got = tL._decode_attention_chunked(
        torch.from_numpy(q), targs[0], targs[1], torch.full((Bq,), pos),
        window, targs[2], targs[3], D ** -0.5)
    assert np.isfinite(got.numpy()).all()
    tol = 2e-2 if quantized else 1e-5    # bf16 products on an int8 cache
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# (f) make_cache_rehome: the reference's cases
# ---------------------------------------------------------------------------


def _rehome_setup():
    jc, tc = _cfgs("glm4-9b")
    jp, tp = _params("glm4-9b")
    toks = _tokens(jc, (2, 8))
    return jc, tc, jp, tp, toks


def test_rehome_matches_the_reference_transformer():
    jc, tc, jp, tp, toks = _rehome_setup()
    _, jcache = jM.prefill(jc, jp, {"tokens": jnp.asarray(toks)})
    _, tcache = tM.prefill(tc, tp, {"tokens": torch.from_numpy(toks)})
    want = jSS.make_cache_rehome(jc, 2, 16)(jcache)
    got = tSS.make_cache_rehome(tc, 2, 16)(tcache)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape[2] == 16
        assert not got[k][:, :, 8:].any()
        _close(_np(got[k]), _np(want[k]), k)


def test_rehome_passthrough_recurrent():
    _, tc = _cfgs("mamba2-2.7b")
    cache = tM.init_cache(tc, 2, 8, device="cpu")
    cache = {k: torch.from_numpy(np.random.default_rng(0).normal(
        size=tuple(v.shape)).astype(np.float32)).to(v.dtype)
        for k, v in cache.items()}
    out = tSS.make_cache_rehome(tc, 2, 32)(cache)
    for k in cache:
        assert torch.equal(out[k], cache[k])


def test_rehome_rejects_oversize():
    _, tc = _cfgs("glm4-9b")
    cache = tM.init_cache(tc, 2, 32, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        tSS.make_cache_rehome(tc, 2, 16)(cache)


def test_rehome_rejects_structure_mismatch():
    _, tc = _cfgs("glm4-9b")
    cache = tM.init_cache(tc, 2, 8, device="cpu")
    cache["bogus"] = torch.zeros((1,))
    with pytest.raises(ValueError, match="structure mismatch"):
        tSS.make_cache_rehome(tc, 2, 16)(cache)


def test_rehome_decode_continues_correctly():
    """Decoding from a re-homed cache == decoding token by token through
    a cache made at full length (the reference's test, on the port)."""
    _, tc, _, tp, toks = _rehome_setup()
    toks = torch.from_numpy(toks)
    plen, max_len = 8, 16
    logits, cache = tSS.make_prefill(tc)(tp, {"tokens": toks})
    cache = tSS.make_cache_rehome(tc, 2, max_len)(cache)
    decode = tSS.make_decode_step(tc)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    oc = tM.init_cache(tc, 2, max_len, device="cpu")
    otok = toks[:, :1]
    for i in range(plen):
        olg, oc = decode(tp, otok, oc, i)
        otok = (toks[:, i + 1:i + 2] if i + 1 < plen
                else torch.argmax(olg, dim=-1)[:, None])
    assert torch.equal(otok, tok)
    for i in range(plen, max_len):
        lg, cache = decode(tp, tok, cache, i)
        olg, oc = decode(tp, otok, oc, i)
        tok = torch.argmax(lg, dim=-1)[:, None]
        otok = torch.argmax(olg, dim=-1)[:, None]
        assert torch.equal(tok, otok)


def test_serve_steps_refuse_a_model_axis():
    # every arch serves over a model axis (the MoE, SSM, hybrid and audio
    # archs too, since they left ROADMAP.md Queue 1 item 15)
    from repro_torch.distributed.mesh import ProcessMesh
    from torch_tp_common import assert_serve_builds_and_refusals, fake_world
    _, tc = _cfgs("glm4-9b")
    with fake_world(8):
        assert_serve_builds_and_refusals(ProcessMesh((2, 4),
                                                     ("data", "model")))
        for make in (tSS.make_decode_step, tSS.make_prefill):
            # a mesh without a model axis serves as on one device
            make(tc, mesh=ProcessMesh((2,), ("data",)), **(
                {"max_len": 64} if make is tSS.make_decode_step else {}))


# ---------------------------------------------------------------------------
# (g) input_specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch):
    jc = jbase.get_config(arch)
    tc = tbase.get_config(arch)
    for cell in ("train_4k", "prefill_32k", "decode_32k"):
        want = jM.input_specs(jc, jbase.SHAPES[cell])
        got = tM.input_specs(tc, tbase.SHAPES[cell])
        flat_w = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
            want)[0]}
        assert len(flat_w) == sum(
            len(v) if isinstance(v, dict) else 1 for v in got.values())
        for part, tree in got.items():
            leaves = tree.items() if isinstance(tree, dict) else [
                (None, tree)]
            for k, t in leaves:
                w = want[part] if k is None else want[part][k]
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(w.shape), (cell, part, k)
                assert str(t.dtype).split(".")[-1] == str(w.dtype), (
                    cell, part, k)
