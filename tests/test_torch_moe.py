"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), on the CPU.

- ``route_topk``: experts equal exactly, weights and aux within rtol 1e-6
  (float32 sums in another order); a planted tie goes to the lower expert
  index, as ``jax.lax.top_k`` puts it.
- ``moe_ffn`` on the reduced qwen2-moe (shared branch) and qwen3-moe
  (pure routed), weights drawn with numpy by the reference's init rules
  and carried across with ``params_from_numpy``: float32 output within rtol 1e-5 and the input's
  and every weight's gradient within rtol 1e-4 (``test_torch_model.py``'s
  tolerances), each with atol 1e-6 times the tensor's largest magnitude
  when that is above 1 (the router's gradient sums terms of ~10 that
  cancel to ~1e-2: float32 sums in another order); bf16, where the two
  frameworks round at different places, within 2e-2 of the largest
  magnitude (at least 1); the aux within rtol 1e-6 in float32, 2e-2 in
  bf16.
- A capacity factor low enough that the reference drops slots: the dropped
  count equal to the reference's own dispatch arithmetic, the output and
  gradients as above.
- ``params_from_numpy`` round-trips every MoE leaf bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from torch_train_step_common import numpy_params  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

MOE_ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
B, S = 2, 16


def _layer(arch, dtype, **moe):
    """The reduced arch's layer-0 MoE weights (reference init) as numpy,
    and its MoE config."""
    cfg = dataclasses.replace(jbase.reduced_config(jbase.get_config(arch)),
                              dtype=dtype)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    params = numpy_params(cfg, 1)
    names = [k for k in params if k.startswith("layers.") and (
        "router" in k or "experts" in k or "shared" in k)]
    layer = {k[len("layers."):]: params[k][0].astype(jnp.dtype(dtype))
             for k in names}
    return cfg, layer


def _x(cfg, dtype, seed=0):
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model))
    return x.astype(np.float32).astype(jnp.dtype(dtype))


def _reference(cfg, layer, x, cot):
    """The reference's output, aux and gradients of sum(out * cot) + aux
    with respect to x and every weight."""
    def f(x, p):
        out, aux = jmoe.moe_ffn(p, x, cfg.moe)
        return jnp.sum(out.astype(jnp.float32) * cot) + aux, (out, aux)
    (_, (out, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()})
    return (np.asarray(out.astype(jnp.float32)), float(aux),
            np.asarray(gx.astype(jnp.float32)),
            {k: np.asarray(v.astype(jnp.float32)) for k, v in gp.items()})


def _port(cfg, layer, x, cot):
    p = {k: v.requires_grad_() for k, v in tM.params_from_numpy(
        layer, device="cpu").items()}
    xt = tM.params_from_numpy({"x": x}, device="cpu")["x"].requires_grad_()
    out, aux = tmoe.moe_ffn(p, xt, cfg.moe)
    total = (out.float() * torch.from_numpy(cot)).sum() + aux
    grads = torch.autograd.grad(total, [xt] + list(p.values()))
    return (out.detach().float().numpy(), float(aux.detach()),
            grads[0].float().numpy(),
            {k: g.float().numpy() for k, g in zip(p, grads[1:])})


def _close(got, want, dtype, what):
    scale = max(float(np.abs(want).max()), 1.0)
    if dtype == "float32":
        rtol = 1e-5 if what == "out" else 1e-4
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale,
                                   err_msg=what)
    else:
        assert float(np.abs(got - want).max()) <= 2e-2 * scale, what


def _compare(cfg, layer, dtype, seed=0):
    x = _x(cfg, dtype, seed)
    cot = np.random.default_rng(seed + 7).normal(size=x.shape).astype(
        np.float32)
    want = _reference(cfg, layer, x, cot)
    got = _port(cfg, layer, x, cot)
    _close(got[0], want[0], dtype, "out")
    # aux: float32 probabilities of the router's logits, which in bf16
    # round where each framework rounds
    np.testing.assert_allclose(got[1], want[1],
                               rtol=1e-6 if dtype == "float32" else 2e-2)
    _close(got[2], want[2], dtype, "x grad")
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        _close(got[3][k], want[3][k], dtype, k)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_route_topk_matches_the_reference(k):
    rng = np.random.default_rng(k)
    logits = rng.normal(size=(64, 8)).astype(np.float32)
    w, e, aux = tmoe.route_topk(torch.from_numpy(logits), k)
    jw, je, jaux = jmoe.route_topk(jnp.asarray(logits), k)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_route_topk_breaks_ties_to_the_lower_index():
    logits = np.zeros((5, 6), np.float32)
    logits[0, [4, 1]] = 3.0            # a tie at the top
    logits[1, [5, 2, 0]] = 1.0         # a three-way tie, k = 2 takes two
    logits[2] = 0.5                    # every expert equal
    logits[3, [3, 2]] = [2.0, 1.0]
    logits[3, [5, 4]] = 1.0            # a tie for the second place
    w, e, _ = tmoe.route_topk(torch.from_numpy(logits), 2)
    _, je, _ = jmoe.route_topk(jnp.asarray(logits), 2)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    assert e[:4].tolist() == [[1, 4], [0, 2], [0, 1], [3, 2]]
    assert torch.equal(w[0], torch.tensor([0.5, 0.5]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_the_reference(arch, dtype):
    cfg, layer = _layer(arch, dtype)
    assert ("shared_w_gate" in layer) == (arch == "qwen2-moe-a2.7b")
    _compare(cfg, layer, dtype)


def _reference_dropped(cfg, layer, x):
    """Slots the reference's dispatch drops, by its own arithmetic
    (``moe.py:66-80``)."""
    T = x.shape[0] * x.shape[1]
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    C = jmoe._capacity(T, E, k, cfg.moe.capacity_factor)
    logits = jnp.asarray(x).reshape(T, -1) @ jnp.asarray(layer["router_w"])
    _, experts, _ = jmoe.route_topk(logits, k)
    flat = experts.reshape(-1)
    sorted_e = flat[jnp.argsort(flat)]
    same = jnp.cumsum(jax.nn.one_hot(sorted_e, E, dtype=jnp.int32), axis=0)
    pos = jnp.take_along_axis(same, sorted_e[:, None], axis=1)[:, 0] - 1
    return int(jnp.sum(pos >= C)), C


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dropped_slots_match_the_reference(arch):
    cfg, layer = _layer(arch, "float32", capacity_factor=0.25)
    x = _x(cfg, "float32", seed=3)
    want, C = _reference_dropped(cfg, layer, x)
    assert want > 0
    T = B * S
    logits = torch.from_numpy(x).reshape(T, -1) @ torch.from_numpy(
        layer["router_w"].copy())
    _, experts, _ = tmoe.route_topk(logits, cfg.moe.top_k)
    plan = tmoe.dispatch_plan(experts, cfg.moe.num_experts, C)
    assert int(plan["dropped"]) == want
    _compare(cfg, layer, "float32", seed=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_numpy_round_trips_the_moe_leaves(arch, dtype):
    cfg = dataclasses.replace(jbase.reduced_config(jbase.get_config(arch)),
                              dtype=dtype)
    params = {k: v.astype(jnp.dtype(dtype))
              for k, v in numpy_params(cfg, 0).items()}
    moe = {"router_w", "experts_w_gate", "experts_w_up", "experts_w_down"}
    if arch == "qwen2-moe-a2.7b":
        moe |= {"shared_w_gate", "shared_w_up", "shared_w_down",
                "shared_gate_w"}
    assert {k[len("layers."):] for k in params} >= moe
    tparams = tM.params_from_numpy(params, device="cpu")
    for k, a in params.items():
        t = tparams[k]
        assert tuple(t.shape) == a.shape and str(t.dtype) == f"torch.{dtype}"
        back = (t.view(torch.int16).numpy().view(a.dtype)
                if dtype == "bfloat16" else t.numpy())
        np.testing.assert_array_equal(back.view(np.uint8),
                                      a.view(np.uint8), err_msg=k)
