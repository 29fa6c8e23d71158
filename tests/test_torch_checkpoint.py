"""Parity tests of the port's checkpoints (``repro_torch.checkpoint``)
against the JAX package's: what one package saves the other restores, in
both directions, bit for bit (bfloat16 through the reference's dtype map,
the step count as int32), the elastic refit of per-worker state, the
checkpoint of a plan-configured trainer's state (the delayed-vote buffer,
the EF residual of the mapped leaves, the flip-rate EMA) under a smaller
and a larger voter set, and the fault-tolerance helpers.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro.checkpoint import checkpoint as jck  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro_torch.checkpoint import checkpoint as tck  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.distributed import fault_tolerance as tft  # noqa: E402
from repro_torch.train import train_step as tTS  # noqa: E402

RNG = np.random.default_rng(0)


def _numpy_state(m=8):
    """A reference-style state: float32 and bfloat16 leaves, int32 count,
    int8 signs, nested dicts."""
    return {
        "count": np.asarray(7, np.int32),
        "momentum": {"w": RNG.normal(size=(m, 4, 3)).astype(np.float32),
                     "b": RNG.normal(size=(m, 5)).astype(ml_dtypes.bfloat16)},
        "delayed": {"w": RNG.integers(-1, 2, (4, 3)).astype(np.int8)},
        "codec": {"flip_ema": RNG.uniform(0, 1, m).astype(np.float32)},
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _as_numpy(t):
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return np.asarray(t)


def _assert_bits_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = _as_numpy(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype, k
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8),
                                      err_msg=k)


def test_reference_saves_port_restores(tmp_path):
    state = _numpy_state()
    params = {"w": RNG.normal(size=(4, 3)).astype(ml_dtypes.bfloat16)}
    jck.save(str(tmp_path), 3, params, state, data_state={"cursor": 5},
             meta={"arch": "x"})
    p, o, data, meta = tck.restore(str(tmp_path), device="cpu")
    _assert_bits_equal(p, params)
    _assert_bits_equal(o, state)
    assert data == {"cursor": 5} and meta["arch"] == "x"
    assert meta["step"] == 3


def test_port_saves_reference_restores(tmp_path):
    state = _numpy_state()
    tstate = {"count": 7,
              "momentum": {"w": torch.from_numpy(state["momentum"]["w"]),
                           "b": torch.from_numpy(
                               state["momentum"]["b"].view(np.int16))
                           .view(torch.bfloat16)},
              "delayed": {"w": torch.from_numpy(state["delayed"]["w"])},
              "codec": {"flip_ema": torch.from_numpy(
                  state["codec"]["flip_ema"])}}
    tck.save(str(tmp_path), 3, {}, tstate)
    _, o, _, _ = jck.restore(str(tmp_path))
    _assert_bits_equal(o, state)
    # the same files as the reference writes them
    jdir = tmp_path / "ref"
    jck.save(str(jdir), 3, {}, state)
    with open(tmp_path / "step_00000003" / "meta.json") as f, \
            open(jdir / "step_00000003" / "meta.json") as g:
        assert json.load(f) == json.load(g)
    z1 = np.load(tmp_path / "step_00000003" / "arrays.npz")
    z2 = np.load(jdir / "step_00000003" / "arrays.npz")
    assert sorted(z1.files) == sorted(z2.files)
    for k in z2.files:
        assert z1[k].dtype == z2[k].dtype, k


@pytest.mark.parametrize("m_new", [3, 8, 11])
def test_refit_on_restore_as_the_reference(tmp_path, m_new):
    state = _numpy_state(8)
    jck.save(str(tmp_path), 1, {}, state)
    like = {"count": (), "momentum": {"w": (m_new, 4, 3), "b": (m_new, 5)},
            "delayed": {"w": (4, 3)}, "codec": {"flip_ema": (m_new,)}}
    jlike = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                         like, is_leaf=lambda s: isinstance(s, tuple))
    _, want, _, _ = jck.restore(str(tmp_path), like_opt=jlike)
    _, got, _, _ = tck.restore(str(tmp_path), like_opt=like, device="cpu")
    _assert_bits_equal(got, want)


def test_refit_helpers_on_arrays_and_tensors():
    a = RNG.normal(size=(5, 3)).astype(np.float32)
    for want in ((2, 3), (5, 3), (7, 3)):
        ref = jck.refit_leading_axis(a, want)
        np.testing.assert_array_equal(tck.refit_leading_axis(a, want), ref)
        np.testing.assert_array_equal(
            tck.refit_leading_axis(torch.from_numpy(a), want).numpy(), ref)
    with pytest.raises(ValueError):
        tck.refit_leading_axis(a, (5, 4))
    tree = {"m": a, "s": {"e": a[:, 0]}}
    want = {"m": (6, 3), "s": {"e": (6,)}}
    _assert_bits_equal(tck.refit_tree_leading_axis(tree, want),
                       jck.refit_tree_leading_axis(tree, want))
    with pytest.raises(ValueError):
        tck.refit_tree_leading_axis(tree, {"m": (6, 3)})


def test_checkpoint_of_a_plan_trainers_state(tmp_path):
    """A plan-configured trainer (ef_sign on the embedding, weighted_vote on
    the rest, delayed_vote) after one step: its state round-trips, and
    restores under 3 and 6 voters by the refit rule (survivors bit-equal,
    joiners at zero), read back by the reference too."""
    from repro_torch.data.pipeline import SyntheticLMPipeline
    cfg = dataclasses.replace(tbase.reduced_config(
        tbase.get_config("glm4-9b")), dtype="float32", d_model=64,
        head_dim=16, d_ff=128, vocab_size=256)
    tcfg = tbase.TrainConfig(
        global_batch=8, seq_len=16, optimizer=tbase.OptimizerConfig(
            kind="signum_vote", learning_rate=1e-2, momentum=0.9,
            vote_strategy=tbase.VoteStrategy.ALLGATHER_1BIT,
            codec="weighted_vote", bucket_bytes=4096, delayed_vote=True,
            codec_map=(("embed*", "ef_sign"),)))
    art = tTS.make_train_step(cfg, tcfg, 4, device="cpu")
    params, state = tTS.materialize_state(cfg, tcfg, art,
                                          torch.Generator().manual_seed(0))
    tokens = SyntheticLMPipeline(cfg, 8, 16, seed=0).global_batch_at(0)
    params, state, _ = art.step_fn(params, state, tokens, 0)
    assert sorted(state) == ["codec", "count", "delayed", "error",
                             "momentum"]
    assert sorted(state["error"]) == ["embed.table"]
    tck.save(str(tmp_path), 1, params, state)
    p, o, _, _ = tck.restore(str(tmp_path), device="cpu")
    _assert_bits_equal(p, {k: _as_numpy(v) for k, v in params.items()})
    _assert_bits_equal(o, {k: ({kk: _as_numpy(vv) for kk, vv in v.items()}
                               if isinstance(v, dict) else np.int32(v))
                           for k, v in state.items()})
    for m_new in (3, 6):
        like = {k: ({kk: ((m_new,) + tuple(vv.shape[1:])
                          if k in ("momentum", "error", "codec")
                          else tuple(vv.shape)) for kk, vv in v.items()}
                    if isinstance(v, dict) else ())
                for k, v in state.items()}
        _, fit, _, _ = tck.restore(str(tmp_path), like_opt=like,
                                   device="cpu")
        keep = min(m_new, 4)
        for key in ("momentum", "error", "codec"):
            for leaf, t in state[key].items():
                assert torch.equal(fit[key][leaf][:keep], t[:keep])
                assert not fit[key][leaf][keep:].any()
        assert torch.equal(fit["delayed"]["layers.attn_wq"],
                           state["delayed"]["layers.attn_wq"])
    _, jo, _, _ = jck.restore(str(tmp_path))
    np.testing.assert_array_equal(jo["codec"]["flip_ema"],
                                  state["codec"]["flip_ema"].numpy())


def test_async_checkpointer_and_latest(tmp_path):
    ck = tck.AsyncCheckpointer(str(tmp_path))
    x = torch.arange(6, dtype=torch.float32)
    ck.save(1, {"x": x}, {"count": 1})
    x.add_(100)                       # the host copy was taken at save()
    ck.save(2, {"x": x}, {"count": 2})
    ck.wait()
    assert os.path.basename(tck.latest_step_dir(str(tmp_path))) == \
        "step_00000002"
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))
    p, o, _, _ = tck.restore(str(tmp_path), device="cpu")
    assert torch.equal(p["x"], x) and int(o["count"]) == 2
    assert tck.latest_step_dir(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "none"), device="cpu")


def test_fault_tolerance_helpers_as_the_reference():
    for shape, axes, survivors in (((16, 16), ("data", "model"), 200),
                                   ((2, 8, 4), ("pod", "data", "model"), 40),
                                   ((8, 2), ("data", "model"), 9)):
        assert dataclasses.asdict(tft.plan_rescale(shape, axes, survivors)) \
            == dataclasses.asdict(jft.plan_rescale(shape, axes, survivors))
        assert tft.plan_rescale(shape, axes, survivors).new_replicas == \
            jft.plan_rescale(shape, axes, survivors).new_replicas
    with pytest.raises(ValueError):
        tft.plan_rescale((4, 8), ("data", "model"), 5)
    s = torch.tensor([[1, -1], [0, 1], [1, 1]], dtype=torch.int8)
    prev = torch.tensor([[-1, -1], [1, 1], [0, 0]], dtype=torch.int8)
    mask = (torch.arange(3) < 2)[:, None]
    want = jft.simulate_stragglers(jnp.asarray(s.numpy()),
                                   jnp.asarray(prev.numpy()),
                                   jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(
        tft.simulate_stragglers(s, prev, mask).numpy(), np.asarray(want))
    fired = []
    with tft.Watchdog(0.01, lambda: fired.append(1)) as w:
        import time
        time.sleep(0.1)
    assert w.fired and fired == [1]
    with tft.Watchdog(10.0) as w:
        pass
    assert not w.fired
