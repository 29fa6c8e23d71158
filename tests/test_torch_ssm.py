"""The port's Mamba2 / SSD mixer (``repro_torch.models.mamba2``) and the
zamba2 hybrid stack (``repro_torch.models.hybrid``) against the JAX
package on the CPU, and mamba2-2.7b and zamba2-1.2b trained through their
presets.

(a) ``_segsum`` (the -inf above the diagonal written before any ``exp``)
    and ``causal_conv1d``: outputs and input / weight gradients of
    sum(out * cot).
(b) ``mamba2_forward`` on one layer of the reduced mamba2 (d 128, 16
    heads of 16, state 16, chunk 32) at S = 128 (4 chunks of 32) and
    S = 48 (the chunk halves to 16): the output and the gradients of the
    input and of every weight.
(c) ``hybrid_forward`` on the reduced zamba2 (4 layers, the shared block
    after every 2, so twice): the output and the gradients of the input,
    of every layer leaf and of the shared block's leaves (the sum over its
    two calls); the segments of the full zamba2 (38 layers, every 6: six
    calls, the last segment of 2 layers without one).
(d) Each arch's ``reduced_config`` through ``loss_fn``, float32
    parameters drawn with numpy by ``test_torch_zoo.py``'s rules and
    ``mamba_A_log`` / ``mamba_D`` kept float32 in a bf16 model, as the
    reference keeps them.
(e) One step of each arch's preset (Mode A, float32 momentum on
    psum_int8, full remat) at M = 4 against a step composed from the JAX
    package's functions (``test_torch_zoo.py``'s ``_composed_step`` and
    criteria), teacher-forced from the same state.

Tolerances. (a)-(c) as ``tests/torch_family_common.py`` states them:
float32 within rtol 1e-4 / atol max(1e-6, 2e-5 x the largest magnitude);
bf16 no further from the reference's float32 result than the reference's
own bf16 result is, with 25 % and one bf16 rounding of room. (d) and (e)
at ``test_torch_zoo.py``'s tolerances (the loss rtol 1e-5, the bf16 loss
2e-2), the float32 gradients at rtol 1e-4 / atol max(1e-6, 2e-5 x the
leaf's largest gradient), as (a)-(c).
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
from repro.models import hybrid as jH  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import hybrid as tH  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from torch_family_common import F32_ATOL_REL, compare, pair  # noqa: E402
from torch_train_step_common import numpy_params  # noqa: E402

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
#: leaves the reference keeps float32 in a model of any dtype
F32_LEAVES = ("A_log", "mamba_D")


def _rng(*salt):
    return np.random.default_rng([41, *salt])


# ---------------------------------------------------------------------------
# (a) the SSD helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segsum_matches_the_reference(dtype):
    """-inf above the diagonal in both; exp of it, and its gradient
    finite."""
    x = -np.abs(_rng(1).normal(size=(2, 3, 16))).astype(np.float32)
    jx, tx = pair(x, dtype)
    want = np.asarray(jm._segsum(jx).astype(jnp.float32))
    assert np.array_equal(
        np.isneginf(tm._segsum(tx).detach().float().numpy()),
        np.isneginf(want))
    assert np.isneginf(want).sum() == 2 * 3 * 16 * 15 // 2
    cot = _rng(2).normal(size=(2, 3, 16, 16)).astype(np.float32)

    def case(dt):
        j, t = pair(x, dt)
        return (lambda a: jnp.exp(jm._segsum(a)), [j],
                lambda a: torch.exp(tm._segsum(a)), [t], cot, ["x"])
    compare(case, dtype, "segsum")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_the_reference(dtype):
    r = _rng(3)
    args = [r.normal(size=sh).astype(np.float32)
            for sh in ((2, 24, 40), (4, 40), (40,))]
    cot = r.normal(size=(2, 24, 40)).astype(np.float32)

    def case(dt):
        pairs = [pair(a, dt) for a in args]
        return (jm.causal_conv1d, [p[0] for p in pairs], tm.causal_conv1d,
                [p[1] for p in pairs], cot, ["x", "w", "b"])
    compare(case, dtype, "conv")


# ---------------------------------------------------------------------------
# (b) the mixer
# ---------------------------------------------------------------------------


def _cfgs(arch, dtype, **kw):
    return tuple(dataclasses.replace(pkg.reduced_config(pkg.get_config(
        arch)), dtype=dtype, **kw) for pkg in (jbase, tbase))


def _params(cfg, dtype, prefix=""):
    """numpy float32 parameters of `cfg` (``mamba_A_log`` by the
    reference's init, so A lies in [1, 16)), as (JAX, torch) trees in
    `dtype`, the float32 leaves kept float32; `prefix` selects and strips
    the leaves under it."""
    arrays = numpy_params(cfg, 0)
    for k, v in arrays.items():
        if k.endswith("A_log"):
            nh = v.shape[-1]
            arrays[k] = np.broadcast_to(np.log(np.arange(
                1, nh + 1, dtype=np.float32) + 0.5), v.shape).copy()
    j, t = {}, {}
    for k, v in arrays.items():
        if not k.startswith(prefix):
            continue
        j[k[len(prefix):]], t[k[len(prefix):]] = pair(
            v, dtype, keep_f32=k.endswith(F32_LEAVES))
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [128, 48])
def test_mamba2_forward_matches_the_reference(S, dtype):
    r = _rng(4, S)
    x = r.normal(size=(2, S, 128)).astype(np.float32)
    cot = r.normal(size=(2, S, 128)).astype(np.float32)

    def case(dt):
        jc, tc = _cfgs("mamba2-2.7b", dt, num_layers=1)
        assert jc.d_model == 128 and tm.chunk_size(tc, S) == {
            128: 32, 48: 16}[S]
        jp, tp = _params(jc, dt, "layers.")
        names = sorted(k for k in tp if k.startswith("mamba"))
        assert tp["mamba_A_log"].dtype == torch.float32
        jx, tx = pair(x, dt)
        return (lambda x, *w: jm.mamba2_forward(dict(zip(names, w)), x, jc),
                [jx] + [jp[k][0] for k in names],
                lambda x, *w: tm.mamba2_forward(dict(zip(names, w)), x, tc),
                [tx] + [tp[k][0].detach().requires_grad_() for k in names],
                cot, ["x"] + names)
    compare(case, dtype, f"mamba2 {S}")


# ---------------------------------------------------------------------------
# (c) the hybrid stack
# ---------------------------------------------------------------------------


def test_hybrid_segments_as_the_reference():
    full = tbase.get_config("zamba2-1.2b")
    segs = tH._segments(full)
    assert segs == jH._segments(jbase.get_config("zamba2-1.2b"))
    assert sum(shared for *_, shared in segs) == 6
    assert segs[-1] == (36, 38, False)
    _, tc = _cfgs("zamba2-1.2b", "float32")
    assert tH._segments(tc) == [(0, 2, True), (2, 4, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_forward_matches_the_reference(dtype):
    """The stack (remat "full" in the port, none in the reference: remat
    changes no value), the shared block's gradient the sum over its two
    calls."""
    r = _rng(5)
    x = r.normal(size=(2, 32, 128)).astype(np.float32)
    cot = r.normal(size=(2, 32, 128)).astype(np.float32)

    def case(dt):
        jc, tc = _cfgs("zamba2-1.2b", dt)
        assert (tc.num_layers, tc.shared_attn_every, tc.d_model) \
            == (4, 2, 128)
        jp, tp = _params(jc, dt)
        names = sorted(k for k in tp
                       if k.startswith(("layers.", "shared_block.")))
        assert any(n.startswith("shared_block.") for n in names)
        jx, tx = pair(x, dt)
        return (lambda x, *w: jH.hybrid_forward(dict(zip(names, w)), x, jc),
                [jx] + [jp[k] for k in names],
                lambda x, *w: tH.hybrid_forward(dict(zip(names, w)), x, tc,
                                                remat="full"),
                [tx] + [tp[k] for k in names], cot, ["x"] + names)
    compare(case, dtype, "hybrid")


# ---------------------------------------------------------------------------
# (d) the archs through loss_fn, (e) one preset step each
# ---------------------------------------------------------------------------


def test_init_params_keeps_the_ssm_leaves_float32():
    """The bf16 zamba2 (every SSM leaf and the shared block): A_log float32
    log(1 .. nh) + 0.5 for every layer (the reference's values, within one
    float32 ulp: each package's own log), mamba_D float32 ones, dt_bias
    and the conv bias zeros, as the reference's init_params makes them."""
    jc, tc = _cfgs("zamba2-1.2b", "bfloat16")
    tp = tM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    jp = jax.jit(jM.init_params, static_argnums=0)(jc,
                                                   jax.random.PRNGKey(0))
    assert sorted(tp) == sorted(jp)
    for k in ("layers.mamba_A_log", "layers.mamba_D",
              "layers.mamba_dt_bias", "layers.mamba_conv_b"):
        assert str(tp[k].dtype).split(".")[-1] == jp[k].dtype.name, k
        np.testing.assert_allclose(
            tp[k].float().numpy(), np.asarray(jp[k].astype(jnp.float32)),
            rtol=2.0 ** -23, atol=0, err_msg=k)


@pytest.fixture(scope="module", params=ARCHS)
def arch_grads(request):
    arch = request.param
    cfg, tcfg = zoo._cfgs(arch)
    params, grad_fn = zoo._reference(arch)
    batch = zoo._batch(cfg, zoo.B, zoo.S)
    (jloss, jmet), jgrads = grad_fn(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = tM.params_from_numpy(params, device="cpu")
    got, tgrads = zoo._port_loss_grads(tcfg, tparams, batch, remat="full")
    return (float(jloss), got, {k: np.asarray(v) for k, v in jgrads.items()},
            tgrads)


def test_arch_loss_and_grads_match_the_reference(arch_grads):
    jloss, got, jgrads, tgrads = arch_grads
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
    assert got["aux"] == 0.0
    assert sorted(tgrads) == sorted(jgrads)
    for name, g in jgrads.items():
        atol = max(1e-6, F32_ATOL_REL * float(np.abs(g).max()))
        np.testing.assert_allclose(tgrads[name], g, rtol=1e-4, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_loss_matches_the_reference_bf16(arch):
    jc, tc = _cfgs(arch, "bfloat16")
    jp, tp = _params(jc, "bfloat16")
    assert tp["layers.mamba_A_log"].dtype == torch.float32
    assert tp["layers.mamba_zproj"].dtype == torch.bfloat16
    batch = zoo._batch(jc, zoo.B, zoo.S)
    jloss, _ = jax.jit(lambda p, b: jM.loss_fn(jc, p, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tloss, _ = tM.loss_fn(tc, tp, {
            k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_preset_step_matches_the_composed_reference(arch):
    jt, tt = zoo._presets(arch)
    opt = tt.optimizer
    assert (opt.kind, opt.vote_strategy.value, opt.momentum_dtype,
            tt.remat, tt.fsdp) == ("signum_vote", "psum_int8", "float32",
                                   "full", False)
    zoo.check_preset_step(arch)
