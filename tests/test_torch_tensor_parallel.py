"""Tensor parallelism over a mesh's ``"model"`` axis
(``distributed.tensor_parallel``) against the JAX package on the CPU.

(a) The train step and serving on 8 gloo ranks: one launch of
    ``tests/torch_mesh_harness.py <scratch> tp`` (its check f) holds the
    port's model-axis step on (data 4, model 2), (data 2, model 4) and
    (model 8) meshes (the grouped, repeat and seq attention forms of the
    reduced glm4-9b, float32) to the port's stacked step of the mesh's
    voters, each step from the same joined state: losses within rtol 1e-5,
    momenta and residuals within the families' float32 tolerance (rtol
    1e-4, atol 2e-5 of the leaf's largest; one bf16 ulp with the bf16
    microbatch accumulator), parameters equal within float32 rounding
    except where a vote flipped, every flip at a coordinate where some
    voter's vote input is under 1e-4 of its leaf's largest (counted),
    replicated leaves bit-equal over the model group and each step's
    model-group bytes equal to ``chip_smoke.tp_bytes``; Mode A on the
    four codecs and three wires, Mode B with fsdp and remat, sgd,
    ``delayed_vote``, ``sign_flip`` with the diagnostics, and one run of
    each other dense decoder-only arch (qwen1.5-32b, deepseek-67b,
    gemma3-12b with its windows and tied table, pixtral-12b with a patch
    prefix). Its serving layouts (sequence over (data, model) at batch 1,
    batch over data with the sequence or the heads over model, the sharded
    flash decode at 8192 rows; the five archs) are held to the
    single-device decode within rtol / atol 1e-4 (int8 cache: 2e-2, its
    products in bf16), greedy tokens equal.
(b) Against the reference's own mesh paths: ``tests/torch_tp_reference.py``
    runs in a subprocess on 8 fake XLA devices: ``make_train_step`` on a
    (data 4, model 2) mesh (one Mode A sign1bit step of the reduced
    glm4-9b, float32), and ``decode_step`` under a (data 1, model 4) mesh
    at 4096 cache rows with 2 kv heads, which takes
    ``flash_decode_sharded`` (float32 and int8 caches). The port's (4, 2)
    step from the reference's start state and batch is held to it with
    the criteria of (a); the port's (model 4) prefill and decode to it:
    logits within rtol / atol 1e-4 (int8: 2e-2), greedy tokens equal,
    every layer through the port's sharded flash decode, the cache blocks
    the reference's (float32 within 1e-5; int8 within one step).
(c) One process: the port's ``_flash_decode_local`` against the
    reference's on the same shards (bf16 and int8 caches, a window), and
    the combine against the reference's unsharded
    ``_decode_attention_chunked``; ``cache_leaf_spec`` and
    ``batch_entry`` on every case of ``tests/test_serve_step.py``,
    ``kv_cache_spec``, ``mesh_axis_sizes`` and ``pod_stride`` exactly the
    reference's; every arch builds over a model axis, glm4-9b also with
    each stochastic adversary and with a VotePlan, and an adaptive
    adversary raises the reference's ``ValueError`` at the step's call (a
    world of fake ranks, ``tests/torch_tp_common.py``).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import mesh as jlm  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.train import serve_step as jSS  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.distributed.mesh import ProcessMesh  # noqa: E402
from repro_torch.launch import mesh as tlm  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.train import serve_step as tSS  # noqa: E402
from torch_tp_common import (assert_serve_builds_and_refusals,  # noqa: E402
                             assert_train_builds_and_refusals, fake_world)

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = pathlib.Path(__file__).resolve().parent
#: the criteria of (a), as the harness states them
FLIP_FRACTION, F32_RTOL, F32_ATOL_REL = 1e-4, 1e-4, 2e-5


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    """The reference's run, then the harness's tp check, in one scratch
    directory (the harness reads the reference's start states)."""
    path = tmp_path_factory.mktemp("tp")
    ref = subprocess.run(
        [sys.executable, str(HERE / "torch_tp_reference.py"), str(path)],
        capture_output=True, text=True, timeout=600,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stdout[-4000:] + ref.stderr[-4000:]
    out = subprocess.run(
        [sys.executable, str(HERE / "torch_mesh_harness.py"), str(path),
         "tp"], capture_output=True, text=True, timeout=900, env=_env())
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "OK tp" in out.stdout
    return path


# ---------------------------------------------------------------------------
# (a) the harness
# ---------------------------------------------------------------------------


def test_the_model_axis_step_and_serving_hold_to_the_stacked_twins(scratch):
    import pickle
    with open(scratch / "tp_record.pkl", "rb") as f:
        flips = pickle.load(f)["tp_flips"]
    assert len(flips) == 8
    # every flip was justified by the harness; they stay rare
    for rank in flips:
        assert sum(rank.values()) <= 8, rank


# ---------------------------------------------------------------------------
# (b) the reference's own mesh paths
# ---------------------------------------------------------------------------


def _load(path, prefix):
    with np.load(path) as z:
        return {k[len(prefix):]: z[k] for k in z.files
                if k.startswith(prefix)}


def test_the_4x2_step_holds_to_the_reference_mesh_step(scratch):
    cfg = dataclasses.replace(tbase.reduced_config(tbase.get_config(
        "glm4-9b")), dtype="float32")
    sizes = {"pod": 1, "data": 4, "model": 2}
    specs = tshd.param_specs(cfg.param_shapes(), fsdp=False,
                             mesh_shape=sizes)
    ranks = [scratch / f"tp_step_rank{r}.npz" for r in range(8)]
    params = tshd.join_shards([_load(p, "p/") for p in ranks], specs,
                              sizes=sizes)
    moms = [tshd.join_shards([_load(ranks[2 * v + m], "m/")
                              for m in range(2)], specs,
                             sizes={"model": 2}) for v in range(4)]
    with np.load(scratch / "tp_reference_step.npz") as z:
        ref_loss = float(z["loss"])
        losses = [float(np.load(p)["loss"]) for p in ranks]
    want_p = _load(scratch / "tp_reference_step.npz", "p/")
    want_m = _load(scratch / "tp_reference_step.npz", "m/")
    start = _load(scratch / "tp_reference_start.npz", "p/")
    for loss in losses:
        assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    flips = total = 0
    for k, w in want_p.items():
        m_ref = want_m[k].astype(np.float32)           # (4, *leaf)
        m_got = np.stack([m[k] for m in moms])
        atol = max(1e-6, F32_ATOL_REL * float(np.abs(m_ref).max()))
        np.testing.assert_allclose(m_got, m_ref, rtol=F32_RTOL, atol=atol,
                                   err_msg=k)
        bad = ~np.isclose(params[k], w, rtol=1e-5, atol=1e-6)
        a = np.abs(m_ref)
        near = (a < FLIP_FRACTION * a.max()).any(axis=0)
        assert not (bad & ~near).any(), k
        flips += int(bad.sum())
        total += w.size
        # the step moved the parameters (the vote applied)
        assert not np.array_equal(w, start[k]) or not w.any(), k
    assert flips <= 1e-3 * total, (flips, total)


@pytest.mark.parametrize("suffix", ["", "_int8"])
def test_the_model4_decode_holds_to_the_reference_flash_decode(scratch,
                                                               suffix):
    ref = dict(np.load(scratch / f"tp_decode_ref{suffix}.npz"))
    tol = 1e-4 if not suffix else 2e-2
    ranks = [dict(np.load(scratch / f"tp_decode_rank{r}{suffix}.npz"))
             for r in range(4)]
    n_layers = tbase.reduced_config(tbase.get_config("glm4-9b")).num_layers
    ticks = sorted(k for k in ref if k.startswith("tick"))
    assert len(ticks) == 3
    for got in ranks:
        for key in ["prefill"] + ticks:
            np.testing.assert_allclose(got[key], ref[key], rtol=tol,
                                       atol=tol, err_msg=key)
            np.testing.assert_array_equal(got[key].argmax(-1),
                                          ref[key].argmax(-1))
        assert list(got["paths"]) == [f"flash_sharded={3 * n_layers}"]
    # the cache: the reference's, cut over the sequence (4 ranks)
    for name in [k for k in ref if k.startswith("c/")]:
        full = np.concatenate([r[name] for r in ranks], axis=2)
        np.testing.assert_allclose(full, ref[name], rtol=0,
                                   atol=1e-5 if not suffix else 1.0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (c) one process
# ---------------------------------------------------------------------------


def _cache_pair(rng, T, dtype):
    """(jax, torch) caches and scales of (1, T, 2, 16): bf16 values, or
    int8 values with bf16 scales."""
    k = rng.normal(size=(1, T, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, T, 2, 16)).astype(np.float32)
    if dtype == "bf16":
        kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        return (kj, vj, None, None), tuple(
            torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
                torch.bfloat16) for x in (kj, vj)) + (None, None)
    (kq, ks), (vq, vs) = jL.quantize_kv(jnp.asarray(k)), jL.quantize_kv(
        jnp.asarray(v))
    j = (kq, vq, ks, vs)
    t = (torch.from_numpy(np.asarray(kq)), torch.from_numpy(np.asarray(vq)),
         torch.from_numpy(np.asarray(ks.astype(jnp.float32))).to(
             torch.bfloat16),
         torch.from_numpy(np.asarray(vs.astype(jnp.float32))).to(
             torch.bfloat16))
    return j, t


@pytest.mark.parametrize("window", [None, 3000])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_flash_decode_local_equals_the_reference_on_each_shard(dtype,
                                                                window):
    rng = np.random.default_rng(7)
    T, shards, pos = 4 * 4096, 4, 9000
    (kj, vj, ksj, vsj), (kt, vt, kst, vst) = _cache_pair(rng, T, dtype)
    q = rng.normal(size=(1, 1, 2, 3, 16)).astype(np.float32)
    scale = 16 ** -0.5
    t_loc = T // shards
    for i in range(shards):
        sl = slice(i * t_loc, (i + 1) * t_loc)
        w = jL._flash_decode_local(
            jnp.asarray(q), kj[:, sl], vj[:, sl],
            None if ksj is None else ksj[:, sl],
            None if vsj is None else vsj[:, sl], jnp.int32(pos),
            i * t_loc, None if window is None else jnp.int32(window), scale)
        g = tL._flash_decode_local(
            torch.from_numpy(q), kt[:, sl], vt[:, sl],
            None if kst is None else kst[:, sl],
            None if vst is None else vst[:, sl], pos, i * t_loc, window,
            scale)
        for name, a, b in zip(("m", "num", "den"), g, w):
            b = np.asarray(b)
            np.testing.assert_array_equal(np.isfinite(a.numpy()),
                                          np.isfinite(b), err_msg=name)
            fin = np.isfinite(b)
            # the chunk products run in bf16 in both packages
            np.testing.assert_allclose(a.numpy()[fin], b[fin], rtol=2e-2,
                                       atol=2e-2 * max(1.0, float(np.abs(
                                           b[fin]).max(initial=0))),
                                       err_msg=name)


@pytest.mark.parametrize("shards", [2, 4])
def test_the_combine_equals_the_reference_unsharded_chunked_decode(shards):
    rng = np.random.default_rng(8)
    T, pos = 4 * 4096, 12345
    k = rng.normal(size=(2, T, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, T, 2, 16)).astype(np.float32)
    q = rng.normal(size=(2, 1, 2, 3, 16)).astype(np.float32)
    want = np.asarray(jL._decode_attention_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
        None, None, None, 16 ** -0.5))
    t_loc = T // shards
    parts = [tL._flash_decode_local(
        torch.from_numpy(q), torch.from_numpy(k[:, i * t_loc:(i + 1) *
                                                 t_loc]),
        torch.from_numpy(v[:, i * t_loc:(i + 1) * t_loc]), None, None, pos,
        i * t_loc, None, 16 ** -0.5) for i in range(shards)]
    got = tL.combine_partials(parts).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _serve_cases(fn):
    """Every parametrized case of a test of tests/test_serve_step.py."""
    import test_serve_step
    return getattr(test_serve_step, fn).pytestmark[0].args[1]


@pytest.mark.parametrize("name,shape,sizes,want",
                         _serve_cases("test_cache_leaf_spec"))
def test_cache_leaf_spec_is_the_reference(name, shape, sizes, want):
    got = tSS.cache_leaf_spec(name, shape, sizes)
    assert got == tuple(jSS.cache_leaf_spec(name, shape, sizes)) == tuple(
        want)


@pytest.mark.parametrize("b,sizes,want", _serve_cases("test_batch_entry"))
def test_batch_entry_is_the_reference(b, sizes, want):
    assert tSS.batch_entry(b, sizes) == jSS.batch_entry(b, sizes) == want


def test_kv_cache_spec_is_the_reference():
    for heads in (1, 2, 3, 8, 40):
        for model in (1, 2, 4, 8, 16):
            spec, kind = tshd.kv_cache_spec(heads, model)
            jspec, jkind = jshd.kv_cache_spec(heads, model)
            assert (spec, kind) == (tuple(jspec), jkind)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_are_the_reference(multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    ref = types.SimpleNamespace(axis_names=names,
                                devices=np.empty(shape, dtype=object))
    with fake_world(int(np.prod(shape))):
        mesh = tlm.make_production_mesh(multi_pod=multi_pod)
        assert tlm.mesh_axis_sizes(mesh) == jlm.mesh_axis_sizes(ref)
        assert tlm.pod_stride(mesh) == jlm.pod_stride(ref)
        assert mesh.world == int(np.prod(shape))
    with fake_world(int(np.prod(shape)) // 2):
        with pytest.raises(ValueError, match=str(int(np.prod(shape)))):
            tlm.make_production_mesh(multi_pod=multi_pod)


def test_the_mesh_lays_ranks_out_as_jax_make_mesh():
    with fake_world(16, rank=13):
        mesh = ProcessMesh((2, 2, 4), ("pod", "data", "model"))
        # rank = (p * data + d) * model + m
        assert mesh.coords == {"pod": 1, "data": 1, "model": 1}
        assert mesh.replica_index() == 3
        assert mesh.group_of(("model",))[0] == (12, 13, 14, 15)
        assert mesh.group_of(("data",))[0] == (9, 13)
        assert mesh.group_of(("pod", "data"))[0] == (1, 5, 9, 13)
        assert mesh.group_of(("data", "model"))[0] == tuple(range(8, 16))


@pytest.mark.parametrize("shape,names", [((4, 2), ("data", "model")),
                                         ((2, 4), ("data", "model")),
                                         ((8,), ("model",))])
def test_the_dense_archs_build_over_a_model_axis(shape, names):
    with fake_world(8, rank=3):
        mesh = ProcessMesh(shape, names)
        assert_train_builds_and_refusals(mesh)
        assert_serve_builds_and_refusals(mesh)
        specs = tSS.abstract_serve_inputs(
            tbase.reduced_config(tbase.get_config("glm4-9b")),
            tbase.SHAPES["decode_32k"], mesh, fsdp=False)
        assert specs["params"]["embed.table"].device.type == "meta"
        assert specs["cache_specs"]["k"] == tSS.cache_leaf_spec(
            "k", tuple(specs["cache"]["k"].shape), mesh.axis_sizes)
