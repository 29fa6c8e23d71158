"""Parity of the port's model (``repro_torch.models``) with the JAX
package's, on the reduced glm4-9b. Parameters are drawn by
``repro.models.model.init_params`` and carried across with
``params_from_numpy``; token batches come from the numpy pipeline."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro.configs.base import get_config, reduced_config  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.base import ArchFamily  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import reduced_config as t_reduced  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402

B, S = 2, 64


def _cfgs(dtype):
    cfg = dataclasses.replace(reduced_config(get_config("glm4-9b")),
                              dtype=dtype)
    tcfg = dataclasses.replace(t_reduced(t_get_config("glm4-9b")),
                               dtype=dtype)
    return cfg, tcfg


def _setup(dtype):
    cfg, tcfg = _cfgs(dtype)
    jparams = jM.init_params(cfg, jax.random.PRNGKey(0))
    tokens = SyntheticLMPipeline(cfg, B, S, seed=0).global_batch_at(0)["tokens"]
    tparams = tM.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return cfg, tcfg, jparams, tparams, tokens


@pytest.fixture(scope="module")
def f32_grads():
    cfg, tcfg, jparams, tparams, tokens = _setup("float32")
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jM.loss_fn(cfg, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(jparams)
    leaves = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    tloss, _ = tM.loss_fn(tcfg, leaves, {"tokens": torch.from_numpy(tokens)})
    tgrads = torch.autograd.grad(tloss, list(leaves.values()))
    return (float(jloss), float(tloss.detach()),
            {k: np.asarray(v) for k, v in jgrads.items()},
            {k: g.numpy() for k, g in zip(leaves, tgrads)})


def test_loss_matches_jax_f32(f32_grads):
    jloss, tloss, _, _ = f32_grads
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)


LEAVES = sorted(t_reduced(t_get_config("glm4-9b")).param_shapes())


@pytest.mark.parametrize("name", LEAVES)
def test_grad_leaf_matches_jax_f32(f32_grads, name):
    _, _, jgrads, tgrads = f32_grads
    assert tgrads[name].shape == jgrads[name].shape
    np.testing.assert_allclose(tgrads[name], jgrads[name], rtol=1e-4,
                               atol=1e-6)


def test_loss_matches_jax_bf16():
    """bf16 rounds at different places in the two frameworks (XLA fuses and
    may keep float32 intermediates inside a fusion; PyTorch rounds every
    op's output), so the step-0 loss is held to 2e-2 relative."""
    cfg, tcfg, jparams, tparams, tokens = _setup("bfloat16")
    assert tparams["embed.table"].dtype == torch.bfloat16
    jloss, _ = jM.loss_fn(cfg, jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tloss, _ = tM.loss_fn(tcfg, tparams,
                              {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_rms_norm_matches_jax():
    x, scale = _x(2, 5, 64), _x(64, seed=1)
    got = tL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    want = jL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_rope_matches_jax():
    pos = np.arange(100)
    c, s = tL.rope_cos_sin(torch.from_numpy(pos), 32, 10_000.0)
    jc, js = jL.rope_cos_sin(jnp.asarray(pos), 32, 10_000.0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=2e-5)
    x = _x(2, 100, 4, 32)
    got = tL.apply_rope(torch.from_numpy(x), c, s)
    want = jL.apply_rope(jnp.asarray(x), jc, js)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("heads,kv", [(4, 2), (4, 4), (8, 1)])
def test_attention_matches_jax(heads, kv):
    q, k, v = _x(2, 48, heads, 16), _x(2, 48, kv, 16, seed=1), \
        _x(2, 48, kv, 16, seed=2)
    got = tL.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v))
    want = jL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_swiglu_and_cross_entropy_match_jax():
    x = _x(2, 6, 32)
    p = {"m_w_gate": _x(32, 48, seed=1), "m_w_up": _x(32, 48, seed=2),
         "m_w_down": _x(48, 32, seed=3)}
    got = tL.swiglu_mlp({k: torch.from_numpy(v) for k, v in p.items()}, "m",
                        torch.from_numpy(x))
    want = jL.swiglu_mlp({k: jnp.asarray(v) for k, v in p.items()}, "m",
                         jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    logits = _x(2, 6, 50, seed=4) * 3
    tgt = np.random.default_rng(5).integers(0, 50, size=(2, 6)).astype(
        np.int32)
    np.testing.assert_allclose(
        float(tL.cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(tgt))),
        float(jL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(tgt))),
        rtol=1e-6)


def test_init_params_follows_reference_rules():
    _, tcfg = _cfgs("bfloat16")
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = tM.init_params(tcfg, gen, device="cpu")
    assert list(params) == sorted(tcfg.param_shapes())
    for name, shape in tcfg.param_shapes().items():
        p = params[name]
        assert tuple(p.shape) == shape and p.dtype == torch.bfloat16
        if name.endswith("_scale") or ".scale" in name:
            assert bool((p == 1).all())
        elif name.endswith(("_bq", "_bk", "_bv")):
            assert bool((p == 0).all())
        else:
            fan_in = shape[-2]
            std = float(p.float().std()) * np.sqrt(fan_in)
            assert 0.9 < std < 1.1, (name, std)
    again = tM.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    _, tcfg = _cfgs("float32")
    with pytest.raises(RuntimeError):
        tM.init_params(tcfg, torch.Generator())
    assert resolve_device("cpu") == torch.device("cpu")


def test_other_families_raise():
    _, tcfg = _cfgs("float32")
    ssm = dataclasses.replace(tcfg, family=ArchFamily.SSM)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tM.init_params(ssm, torch.Generator(), device="cpu")
    params = tM.init_params(tcfg, torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tM.forward_logits(ssm, params, {"tokens": torch.zeros(1, 4).int()})
