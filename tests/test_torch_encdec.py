"""The port's encoder-decoder (``repro_torch.models.encdec``) and its layers
(bidirectional self-attention, cross-attention, sinusoidal positions)
against the JAX package on the CPU, and whisper-tiny trained through its
preset.

(a) ``sinusoidal_positions``; ``attention(causal=False)`` at S = 32 and 64,
    whole and in query chunks of 16, GQA with 1, 2 and 4 kv heads of 4
    (each S meets both paths); the chunked path also against the port's
    own whole path.
(b) On the reduced whisper (d 128, 4 heads of 32, 2 kv heads, 2 encoder and
    2 decoder layers): one encoder block's bidirectional attention without
    RoPE (``self_attention_block(causal=False, use_rope=False)``), a
    decoder layer's cross-attention (``project_kv_cross`` and
    ``cross_attention_block``, T_src = 24 frames against S = 32 queries),
    ``encoder_forward`` and ``decoder_forward``: outputs and the gradients
    of every input and weight.
(c) The reduced whisper through ``loss_fn`` (the batch's ``enc_embeds``
    from the numpy pipeline, 64 frames) and one step of its preset (Mode
    A, float32 momentum on psum_int8, full remat) at M = 4 against a step
    composed from the JAX package's functions (``test_torch_zoo.py``'s).

Tolerances: (a) float32 within rtol 1e-5 / atol 1e-6 (the zoo's attention
tolerance), the positions within 4 float32 ulps of their angle (each
package's own exp, sin and cos); (b) as ``tests/torch_family_common.py`` states them; (c) at
``test_torch_zoo.py``'s (loss rtol 1e-5, gradients rtol 1e-4 / atol
1e-6, the bf16 loss rtol 2e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

import test_torch_zoo as zoo  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import encdec as jE  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import encdec as tE  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from torch_family_common import compare, pair  # noqa: E402
from torch_train_step_common import numpy_params  # noqa: E402

ARCH = "whisper-tiny"


def _rng(*salt):
    return np.random.default_rng([43, *salt])


def _cfgs(dtype):
    return tuple(dataclasses.replace(pkg.reduced_config(pkg.get_config(
        ARCH)), dtype=dtype) for pkg in (jbase, tbase))


# ---------------------------------------------------------------------------
# (a) positions and bidirectional attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [384, 128])
def test_sinusoidal_positions_match_the_reference(d):
    pos = np.concatenate([np.arange(64), _rng(1).integers(0, 4096, 32)])
    got = tL.sinusoidal_positions(torch.from_numpy(pos), d).numpy()
    want = np.asarray(jL.sinusoidal_positions(jnp.asarray(pos), d))
    assert got.dtype == np.float32 and got.shape == (96, d)
    # each package's own exp makes the frequencies and its own sin / cos
    # takes the angles pos * freq (up to 4096): within 4 float32 ulps of
    # the angle
    half = d // 2
    freq = np.exp(-np.arange(half) * np.log(10_000.0) / (half - 1))
    angle = np.concatenate([pos[:, None] * freq] * 2, axis=-1)
    assert np.all(np.abs(got - want) <= 4 * 2.0 ** -23 * (1 + angle))


ATTENTION_CASES = [(32, 16, 1), (32, 32, 4), (64, 16, 2), (64, 64, 1)]


@pytest.mark.parametrize("seq,q_chunk,kv", ATTENTION_CASES)
def test_bidirectional_attention_matches_the_reference(seq, q_chunk, kv):
    r = _rng(2, seq, kv)
    q = r.normal(size=(2, seq, 4, 8)).astype(np.float32)
    k, v = (r.normal(size=(2, seq, kv, 8)).astype(np.float32)
            for _ in range(2))
    cot = r.normal(size=(2, seq, 4, 8)).astype(np.float32)

    def ref(q, k, v):
        out = jL.attention(q, k, v, causal=False, q_chunk=q_chunk)
        return jnp.sum(out * cot), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    want = [np.asarray(a) for a in (out, *grads)]
    got = zoo._port_attention(q, k, v, cot, causal=False, q_chunk=q_chunk)
    whole = zoo._port_attention(q, k, v, cot, causal=False, q_chunk=seq)
    for name, g, w, u in zip(("out", "dq", "dk", "dv"), got, want, whole):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(g, u, rtol=1e-5, atol=1e-6, err_msg=name)
    # bidirectional: the first query sees the last key
    causal = zoo._port_attention(q, k, v, cot, q_chunk=seq)
    assert not np.allclose(got[0][:, 0], causal[0][:, 0])


# ---------------------------------------------------------------------------
# (b) the blocks and the two stacks on the reduced whisper
# ---------------------------------------------------------------------------


def _params(cfg, dtype, prefix):
    """The numpy draws of `cfg`'s leaves under `prefix` (stripped), as
    (JAX, torch) trees in `dtype`."""
    j, t = {}, {}
    for k, v in numpy_params(cfg, 0).items():
        if k.startswith(prefix):
            j[k[len(prefix):]], t[k[len(prefix):]] = pair(v, dtype)
    return j, t


def _layer0(tree, names):
    return [tree[k][0] for k in names]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_attention_block_matches_the_reference(dtype):
    r = _rng(3)
    x = r.normal(size=(2, 32, 128)).astype(np.float32)
    cot = r.normal(size=(2, 32, 128)).astype(np.float32)

    def case(dt):
        jc, tc = _cfgs(dt)
        jp, tp = _params(jc, dt, "encoder.")
        names = sorted(k for k in tp if k.startswith("attn"))
        jx, tx = pair(x, dt)
        return (lambda x, *w: jL.self_attention_block(
                    dict(zip(names, w)), "attn", x, jc, causal=False,
                    use_rope=False)[0],
                [jx] + _layer0(jp, names),
                lambda x, *w: tL.self_attention_block(
                    dict(zip(names, w)), "attn", x, tc, causal=False,
                    use_rope=False)[0],
                [tx] + [w.detach().requires_grad_()
                        for w in _layer0(tp, names)],
                cot, ["x"] + names)
    compare(case, dtype, "encoder attention")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_the_reference(dtype):
    r = _rng(4)
    x = r.normal(size=(2, 32, 128)).astype(np.float32)
    enc = r.normal(size=(2, 24, 128)).astype(np.float32)
    cot = r.normal(size=(2, 32, 128)).astype(np.float32)

    def cross(L, names, cfg):
        def fn(x, enc, *w):
            p = dict(zip(names, w))
            k, v = L.project_kv_cross(p, "xattn", enc, cfg)
            return L.cross_attention_block(p, "xattn", x, k, v, cfg)
        return fn

    def case(dt):
        jc, tc = _cfgs(dt)
        jp, tp = _params(jc, dt, "layers.")
        names = sorted(k for k in tp if k.startswith("xattn"))
        (jx, tx), (je, te) = pair(x, dt), pair(enc, dt)
        return (cross(jL, names, jc), [jx, je] + _layer0(jp, names),
                cross(tL, names, tc),
                [tx, te] + [w.detach().requires_grad_()
                            for w in _layer0(tp, names)],
                cot, ["x", "enc"] + names)
    compare(case, dtype, "cross attention")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_and_decoder_match_the_reference(dtype):
    """The encoder (learned positions added to the frames) and the decoder
    on its output, as one function of the frames, the token stream and
    every encoder and decoder weight; the decoder under remat "full" in
    the port."""
    r = _rng(5)
    frames = r.normal(size=(2, 24, 128)).astype(np.float32)
    h = r.normal(size=(2, 32, 128)).astype(np.float32)
    cot = r.normal(size=(2, 32, 128)).astype(np.float32)

    def both(E, names, cfg, **kw):
        def fn(frames, h, *w):
            p = dict(zip(names, w))
            return E.decoder_forward(p, h, E.encoder_forward(
                p, frames, cfg, **kw), cfg, **kw)
        return fn

    def case(dt):
        jc, tc = _cfgs(dt)
        jp, tp = _params(jc, dt, "")
        names = sorted(k for k in tp if k.startswith(
            ("encoder.", "layers.", "enc_embed.", "enc_final_norm.")))
        (jf, tf), (jh, th) = pair(frames, dt), pair(h, dt)
        return (both(jE, names, jc), [jf, jh] + [jp[k] for k in names],
                both(tE, names, tc, remat="full"),
                [tf, th] + [tp[k] for k in names],
                cot, ["frames", "h"] + names)
    compare(case, dtype, "encoder-decoder")


# ---------------------------------------------------------------------------
# (c) the arch through loss_fn and one preset step
# ---------------------------------------------------------------------------


def test_arch_loss_and_grads_match_the_reference():
    cfg, tcfg = zoo._cfgs(ARCH)
    params, grad_fn = zoo._reference(ARCH)
    batch = zoo._batch(cfg, zoo.B, zoo.S)
    assert batch["enc_embeds"].shape == (zoo.B, 64, cfg.d_model)
    (jloss, jmet), jgrads = grad_fn(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    got, tgrads = zoo._port_loss_grads(
        tcfg, tM.params_from_numpy(params, device="cpu"), batch,
        remat="full")
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
    assert got["aux"] == 0.0
    assert sorted(tgrads) == sorted(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name], np.asarray(g), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_arch_loss_matches_the_reference_bf16():
    """bf16 parameters and bf16 frames (the dtype the reference's
    make_batch gives them)."""
    jc, tc = _cfgs("bfloat16")
    jparams = {k: jnp.asarray(v).astype(jnp.bfloat16)
               for k, v in zoo._reference(ARCH)[0].items()}
    batch = zoo._batch(jc, zoo.B, zoo.S)
    batch["enc_embeds"] = np.asarray(jnp.asarray(
        batch["enc_embeds"]).astype(jnp.bfloat16))
    jloss, _ = jax.jit(lambda p, b: jM.loss_fn(jc, p, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = tM.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    tb = tM.params_from_numpy(batch, device="cpu")
    assert tb["enc_embeds"].dtype == torch.bfloat16
    with torch.no_grad():
        tloss, _ = tM.loss_fn(tc, tparams, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)


def test_make_batch_carries_the_frames():
    _, tc = _cfgs("bfloat16")
    b = tM.make_batch(tc, 3, 16, torch.Generator().manual_seed(0),
                      device="cpu")
    assert b["tokens"].shape == (3, 16)
    assert b["enc_embeds"].shape == (3, min(tc.max_source_positions, 64),
                                     tc.d_model)
    assert b["enc_embeds"].dtype == torch.bfloat16


def test_preset_step_matches_the_composed_reference():
    jt, tt = zoo._presets(ARCH)
    opt = tt.optimizer
    assert (opt.kind, opt.vote_strategy.value, opt.momentum_dtype,
            tt.remat, tt.fsdp) == ("signum_vote", "psum_int8", "float32",
                                   "full", False)
    zoo.check_preset_step(ARCH)
