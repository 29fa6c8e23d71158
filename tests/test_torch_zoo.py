"""The decoder-only model zoo of the port (gemma3-12b, pixtral-12b,
qwen2-moe-a2.7b, qwen3-moe-235b-a22b, deepseek-67b) against the JAX
package on the CPU. The MoE block alone is ``test_torch_moe.py``'s.

(a) Attention. ``layers.attention`` at S = 32 and 64, ``q_chunk`` 8 and
    16 (so both packages take their chunked paths), window None / 16 / 5,
    each pair of those with each window, GQA with K = 1, 2, 4 kv heads of
    4 cycling so that each K meets each window and each pair; against the
    reference's
    ``attention(..., causal=True, window=, q_chunk=)``: the output and the
    gradients of sum(out * cot) with respect to q, k and v within rtol
    1e-5 / atol 1e-6 in float32; the port's chunked path is held to its
    own unchunked path at the same tolerance.
(b) gemma3's pattern: ``local_layer_mask`` (5 local, 1 global) and a token
    beyond the window leaving a local layer's output unchanged, as
    ``tests/test_models.py:76-104`` holds the reference.
(c) The five archs' ``reduced_config``, float32 parameters drawn with
    numpy by the reference's init rules and carried across with
    ``params_from_numpy`` (bf16: the same cast), batches from the numpy
    pipeline (pixtral's with ``patch_embeds``): loss, ce and aux within
    rtol 1e-5 and every leaf's gradient within rtol 1e-4 / atol 1e-6 in
    float32, the bf16 loss within 2e-2 (``test_torch_model.py``'s
    tolerances). The reduced gemma3 also at S = 2048, where both packages
    take the chunked path (q_chunk 1024) in every layer. And the port's
    remat modes bit-equal to none on those paths.
(d) One step of each arch's preset (``default_train_config`` at M = 4,
    two microbatches of two rows a voter, float32 parameters) against a
    step composed from the JAX package's functions, teacher-forced from
    the same state. Mode A (gemma3, pixtral, qwen2-moe: bf16 momentum on
    psum_int8, full remat): ``torch_train_step_common._check_teacher_
    forced`` as ``test_torch_train_step_m4.py``'s preset step (each
    package's vote the decision of its own momenta on the count wire; the
    two decisions differ only where rounding gave a voter another sign,
    at most 0.1 % of the coordinates; the parameters equal elsewhere).
    Mode B with fsdp (deepseek, qwen3-moe: signsgd_vote, one float32
    momentum, hierarchical, nested remat, the layers' matrices voted in
    the backward as ``test_torch_fsdp.py``'s composed step does): the
    fused leaves the reference's, the loss within rtol 1e-5, the momentum
    within rtol 1e-5 / atol 1e-7 on all but 0.1 % of the coordinates, the
    parameters equal wherever the momentum is.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from torch_train_step_common import (  # noqa: E402
    _check_teacher_forced,
    numpy_params,
)

from repro.configs import base as jbase  # noqa: E402
from repro.configs.presets import default_train_config as jdefault  # noqa: E402
from repro.core import sign_compress as jsc  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.presets import default_train_config as tdefault  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.train import train_step as tTS  # noqa: E402

ZOO = ["gemma3-12b", "pixtral-12b", "qwen2-moe-a2.7b",
       "qwen3-moe-235b-a22b", "deepseek-67b"]
MODE_B = ("qwen3-moe-235b-a22b", "deepseek-67b")
B, S = 2, 32
M4, MICRO = 4, 2
GB = M4 * MICRO * B
MAX_EXCLUDED = 1e-3


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) attention
# ---------------------------------------------------------------------------


def _port_attention(q, k, v, cot, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tL.attention(*ts, **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), ts)
    return [out.detach().numpy()] + [g.numpy() for g in grads]


#: (seq, q_chunk, kv heads, window): every (seq, q_chunk) pair with every
#: window, the kv heads cycling so that each pair and each window meets
#: every K
ATTENTION_CASES = [(seq, q_chunk, (1, 2, 4)[(i + j) % 3], window)
                   for i, (seq, q_chunk) in enumerate(
                       [(32, 8), (32, 16), (64, 8), (64, 16)])
                   for j, window in enumerate([None, 16, 5])]


@pytest.mark.parametrize("seq,q_chunk,kv,window", ATTENTION_CASES)
def test_attention_matches_the_reference(seq, q_chunk, kv, window):
    q, k, v = _x(2, seq, 4, 8), _x(2, seq, kv, 8, seed=1), \
        _x(2, seq, kv, 8, seed=2)
    cot = _x(2, seq, 4, 8, seed=3)

    def ref(q, k, v):
        out = jL.attention(q, k, v, causal=True, window=window,
                           q_chunk=q_chunk)
        return jnp.sum(out * cot), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    want = [np.asarray(a) for a in (out, *grads)]
    got = _port_attention(q, k, v, cot, window=window, q_chunk=q_chunk)
    whole = _port_attention(q, k, v, cot, window=window, q_chunk=seq)
    for name, g, w, u in zip(("out", "dq", "dk", "dv"), got, want, whole):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(g, u, rtol=1e-5, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# (b) gemma3's local / global pattern
# ---------------------------------------------------------------------------


def test_gemma3_local_global_pattern():
    cfg = tbase.get_config("gemma3-12b")
    mask = cfg.local_layer_mask()
    assert mask == jbase.get_config("gemma3-12b").local_layer_mask()
    assert len(mask) == 48 and mask[:6] == (True,) * 5 + (False,)
    assert sum(mask) == 40
    windows = [tT._window_for(cfg, m, 4096) for m in mask[:6]]
    assert windows == [1024] * 5 + [4097]


def test_sliding_window_masks_long_range():
    """A token beyond the window cannot reach a local layer's output."""
    cfg = dataclasses.replace(tbase.reduced_config(tbase.get_config(
        "gemma3-12b")), dtype="float32", num_layers=1, local_to_global=1000)
    params = tM.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    seq = 64
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(1, seq)))
    with torch.no_grad():
        logits1, _ = tM.forward_logits(cfg, params, {"tokens": tokens})
        tokens2 = tokens.clone()
        tokens2[0, 0] = (tokens[0, 0] + 1) % cfg.vocab_size
        logits2, _ = tM.forward_logits(cfg, params, {"tokens": tokens2})
    # the last position is seq - 1 = 63 > window 16 away: unchanged
    assert torch.equal(logits1[0, -1], logits2[0, -1])
    assert not torch.allclose(logits1[0, 1], logits2[0, 1], atol=1e-5)


# ---------------------------------------------------------------------------
# (c) the five archs against the reference
# ---------------------------------------------------------------------------


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jbase.reduced_config(jbase.get_config(arch)),
                                dtype=dtype),
            dataclasses.replace(tbase.reduced_config(tbase.get_config(arch)),
                                dtype=dtype))


def _presets(arch):
    """Each package's preset at the test's size: M4 voters of MICRO
    microbatches of B rows (the presets' 8 or 4 microbatches do not divide
    a voter's rows here)."""
    out = []
    for pkg, default in ((jbase, jdefault), (tbase, tdefault)):
        preset = default(arch, pkg.ShapeCell("test", S, GB, "train"))
        out.append(dataclasses.replace(preset, microbatches=MICRO))
    return out


_REF = {}


def _reference(arch):
    """(the reference's float32 parameters as numpy, its jitted
    value_and_grad of the loss): one of each per arch, shared by (c) and
    (d), whose batches have one shape (remat changes no value, so the
    steps' reference takes none)."""
    if arch not in _REF:
        cfg, _ = _cfgs(arch)
        _REF[arch] = (numpy_params(cfg, 0),
                      jax.jit(jax.value_and_grad(
                          lambda p, b: jM.loss_fn(cfg, p, b), has_aux=True)))
    return _REF[arch]


def _batch(cfg, rows, seq, step=0):
    return SyntheticLMPipeline(cfg, rows, seq, seed=0).global_batch_at(step)


def _port_loss_grads(tcfg, params, batch, remat="none"):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, met = tM.loss_fn(tcfg, leaves, tb, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return ({k: float(v.detach()) for k, v in (("loss", loss), *met.items())},
            {k: g.numpy() for k, g in zip(leaves, grads)})


@pytest.fixture(scope="module", params=ZOO)
def zoo_grads(request):
    arch = request.param
    cfg, tcfg = _cfgs(arch)
    params, grad_fn = _reference(arch)
    batch = _batch(cfg, B, S)
    (jloss, jmet), jgrads = grad_fn(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = {"loss": float(jloss), "ce": float(jmet["ce"]),
            "aux": float(jmet["aux"])}
    tparams = tM.params_from_numpy(params, device="cpu")
    got, tgrads = _port_loss_grads(tcfg, tparams, batch)
    return arch, want, got, {k: np.asarray(v) for k, v in jgrads.items()}, \
        tgrads


def test_arch_loss_and_grads_match_the_reference(zoo_grads):
    arch, want, got, jgrads, tgrads = zoo_grads
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    if arch in ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"):
        assert got["aux"] > 0
    assert sorted(tgrads) == sorted(jgrads)
    for name, g in jgrads.items():
        assert tgrads[name].shape == g.shape, name
        np.testing.assert_allclose(tgrads[name], g, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ZOO)
def test_arch_loss_matches_the_reference_bf16(arch):
    cfg, tcfg = _cfgs(arch, "bfloat16")
    # bf16 parameters: the float32 draws cast, as the reference's init
    # casts its float32 draws
    jparams = {k: jnp.asarray(v).astype(jnp.bfloat16)
               for k, v in _reference(arch)[0].items()}
    batch = _batch(cfg, B, S)
    jloss, _ = jax.jit(lambda p, b: jM.loss_fn(cfg, p, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = tM.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    assert tparams["embed.table"].dtype == torch.bfloat16
    with torch.no_grad():
        tloss, _ = tM.loss_fn(tcfg, tparams, {
            k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)


def test_pixtral_takes_patches_before_the_text():
    cfg, tcfg = _cfgs("pixtral-12b")
    batch = _batch(cfg, B, S)
    assert batch["patch_embeds"].shape == (B, S // 4, cfg.d_model)
    assert batch["tokens"].shape == (B, S - S // 4)
    assert tM._vlm_split(S) == (S // 4, S - S // 4)
    params = tM.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    with torch.no_grad():
        logits, _ = tM.forward_logits(tcfg, params, tb)
        assert logits.shape == (B, S, cfg.vocab_size)
        # the loss is the CE of the text segment's logits alone
        text = logits[:, -tb["tokens"].shape[1]:]
        want = tL.cross_entropy_loss(text[:, :-1], tb["tokens"][:, 1:])
        loss, met = tM.loss_fn(tcfg, params, tb)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    assert float(met["aux"]) == 0.0


def test_gemma3_chunked_model_matches_the_reference():
    """The reduced gemma3 at S = 2048: every layer's attention runs in two
    query chunks of 1024 in both packages."""
    cfg, tcfg = _cfgs("gemma3-12b")
    seq = 2 * tL.Q_CHUNK
    params, _ = _reference("gemma3-12b")
    batch = _batch(cfg, 1, seq)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jM.loss_fn(cfg, p, b), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = tM.params_from_numpy(params, device="cpu")
    got, tgrads = _port_loss_grads(tcfg, tparams, batch)
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name], np.asarray(g), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


_REMAT = {}


@pytest.mark.parametrize("remat", ["full", "nested", "dots"])
def test_remat_modes_are_bit_equal_on_the_zoo_paths(remat, monkeypatch):
    """The reduced qwen2-moe at 4 layers with gemma3's local / global
    pattern, queries chunked by 16 at S = 64: the MoE block's dispatch and
    combine, the sliding window and the chunked attention's checkpoints
    under each remat mode give ce and every gradient of remat "none" bit
    for bit; the aux too, but under "nested", which sums it per group of
    layers and then over the groups, as the reference's does (within
    float32 rounding, rtol 1e-6)."""
    monkeypatch.setattr(tL, "Q_CHUNK", 16)
    cfg = dataclasses.replace(
        tbase.reduced_config(tbase.get_config("qwen2-moe-a2.7b")),
        dtype="float32", num_layers=4, sliding_window=16, local_to_global=3)
    assert cfg.local_layer_mask() == (True, True, True, False)
    params = tM.params_from_numpy(numpy_params(cfg, 0), device="cpu")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 64))}
    if "none" not in _REMAT:
        _REMAT["none"] = _port_loss_grads(cfg, params, batch)
    got = _port_loss_grads(cfg, params, batch, remat=remat)
    want = _REMAT["none"][0]
    assert got[0]["ce"] == want["ce"]
    if remat == "nested":
        for k in ("aux", "loss"):
            np.testing.assert_allclose(got[0][k], want[k], rtol=1e-6)
    else:
        assert got[0] == want
    for k, g in _REMAT["none"][1].items():
        np.testing.assert_array_equal(got[1][k], g, err_msg=k)


# ---------------------------------------------------------------------------
# (d) one preset step of each arch at M = 4
# ---------------------------------------------------------------------------


def _composed_step(arch, cfg, jt, state, batch, fused):
    """One M = 4 step of the arch's preset composed from the JAX
    package's functions: per voter and microbatch the jitted gradient;
    Mode A: each voter's gradients summed in bf16 over the microbatches
    and divided, ``beta * m + (1 - beta) * g`` in the momentum's dtype, the
    count wire's vote (the sign of the summed ternary signs) and ``p - lr
    * vote``; Mode B with fsdp: the fused leaves' sign of the summed signs
    per microbatch, added in bf16 and divided, the other leaves' bf16
    accumulators voted as hierarchical votes them (``sign_binary`` of the
    summed ``sign_ternary``: ties +1), ``u = beta * u + (1 - beta) * vote``
    and ``p - lr * sign(u)``. Returns the new state with "loss"."""
    grad_fn = _reference(arch)[1]
    opt = jt.optimizer
    lr, beta = opt.learning_rate, opt.momentum
    mode_a = opt.momentum_mode == jbase.MomentumMode.PER_WORKER
    dt = jnp.dtype(opt.momentum_dtype)
    params = {k: jnp.asarray(v) for k, v in state["params"].items()}
    per, rows = GB // M4, GB // M4 // MICRO
    grads, losses = [], []
    for r in range(M4):
        grads.append([])
        for i in range(MICRO):
            lo = r * per + i * rows
            mb = {k: jnp.asarray(v[lo:lo + rows]) for k, v in batch.items()}
            (loss, _), g = grad_fn(params, mb)
            losses.append(float(loss))
            grads[r].append(g)

    def signs(x):
        return jsc.sign_ternary(x).astype(jnp.int32)

    @jax.jit
    def update(params, momentum, grads):
        new_m, new_p = {}, {}
        for k, p in params.items():
            if k in fused:      # the vote inside each microbatch's backward
                acc = jnp.zeros(p.shape, jnp.bfloat16)
                for i in range(MICRO):
                    count = sum(signs(grads[r][i][k]) for r in range(M4))
                    acc = acc + jnp.sign(count).astype(jnp.bfloat16)
                vote = acc / MICRO
            else:               # each voter's acc_body accumulator
                own = []
                for r in range(M4):
                    acc = jnp.zeros(p.shape, jnp.bfloat16)
                    for i in range(MICRO):
                        acc = acc + grads[r][i][k].astype(jnp.bfloat16)
                    own.append(acc / MICRO)
                if mode_a:
                    m = jnp.stack([beta * momentum[k][r] + (1 - beta)
                                   * own[r].astype(dt) for r in range(M4)])
                    vote = jnp.sign(jnp.sum(signs(m), axis=0))
                    new_m[k] = m
                    new_p[k] = p - lr * (vote.astype(p.dtype) + 0.0 * p)
                    continue
                vote = jsc.sign_binary(sum(signs(o) for o in own))
            u = beta * momentum[k] + (1 - beta) * vote.astype(jnp.float32)
            new_m[k] = u
            new_p[k] = p - lr * (jnp.sign(u) + 0.0 * p)
        return new_m, new_p

    ms, ps = update(params, state["momentum"], grads)
    return {"loss": float(np.mean(losses)),
            "momentum": {k: np.asarray(v) for k, v in ms.items()},
            "params": {k: np.asarray(v) for k, v in ps.items()}}


def _check_mode_b(ref, got):
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    outside = total = 0
    for k, u in ref["momentum"].items():
        close = np.isclose(got["momentum"][k], u, rtol=1e-5, atol=1e-7)
        outside += int((~close).sum())
        total += close.size
        np.testing.assert_array_equal(got["params"][k][close],
                                      ref["params"][k][close], err_msg=k)
    assert outside <= MAX_EXCLUDED * total, (outside, total)


@pytest.mark.parametrize("arch", ZOO)
def test_preset_step_matches_the_composed_reference(arch):
    check_preset_step(arch)


def check_preset_step(arch):
    """(d) for `arch` (``test_torch_ssm.py`` and ``test_torch_encdec.py``
    hold their archs' presets with it too)."""
    cfg, tcfg = _cfgs(arch)
    jt, tt = _presets(arch)
    mode_b = arch in MODE_B
    assert (tt.fsdp, tt.optimizer.kind) == (
        (True, "signsgd_vote") if mode_b else (False, "signum_vote"))
    art = tTS.make_train_step(tcfg, tt, M4, device="cpu")
    specs = jshd.param_specs(cfg.param_shapes(), fsdp=True,
                             mesh_shape={"data": M4, "model": 1})
    fused = [k for k, s in specs.items() if "data" in tuple(s)]
    assert list(art.fused_leaves) == (fused if mode_b else [])
    params = _reference(arch)[0]
    dt = np.dtype(jnp.dtype(tt.optimizer.momentum_dtype))
    state = {"params": params, "momentum": {
        k: np.zeros(((M4,) if not mode_b else ()) + v.shape, dt)
        for k, v in params.items()}}
    batch = _batch(cfg, GB, S)
    ref = _composed_step(arch, cfg, jt, state, batch,
                         set(fused) if mode_b else set())
    tp = tM.params_from_numpy(state["params"], device="cpu")
    ts = {"count": 0, "momentum": tM.params_from_numpy(state["momentum"],
                                                       device="cpu")}
    tp, ts, met = art.step_fn(tp, ts, batch, 0)
    got = {"loss": float(met["loss"]),
           "params": {k: v.numpy() for k, v in tp.items()},
           "momentum": {k: v.float().numpy()
                        for k, v in ts["momentum"].items()}}
    if mode_b:
        _check_mode_b(ref, got)
    else:
        _check_teacher_forced(state, ref, got, count_wire=True,
                              bf16_rounded=True)
