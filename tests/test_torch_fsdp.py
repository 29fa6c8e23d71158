"""The fused ZeRO backward (``TrainConfig.fsdp``): the port's sharding rules,
its gather whose backward votes inside the reduce-scatter, and the ZeRO-3
train step, against the JAX package on the CPU.

(a) Sharding. ``distributed.sharding.param_specs`` equal, leaf for leaf,
    to the reference's ``param_specs`` (a ``PartitionSpec`` read as a
    tuple) for every leaf of the seven archs the port runs (glm4-9b,
    qwen1.5-32b, deepseek-67b, gemma3-12b, pixtral-12b, qwen2-moe-a2.7b and
    qwen3-moe-235b-a22b, whose expert leaves are 4-D) at their published
    shapes, fsdp on and off, over a data axis of 4 and of
    3 (which divides no FSDP dim but gemma3's d_model, 3840, so every
    other arch's "data" entries drop); the
    slices of ``shard_tree`` join back to the whole. Tolerance: none.
(b) The gather. One launch of the 8-rank gloo harness
    (``tests/torch_mesh_harness.py ... fsdp``) holds the gather's backward
    on a data-only mesh of 8 and on pod 2 x data 4, along dims 0 and 1, to
    the sign of the summed per-rank signs of the whole gradient (the dense
    form: to their mean), and the mesh trainer under fsdp to the port's
    stacked step bit for bit (losses, each rank's slices of parameters and
    momentum; Mode B with a sign_flip and a random adversary, on pod 2 x
    data 2, remat "dots", a plan with diagnostics, beta 0, qwen3-moe's
    preset (its 4-D expert leaves sliced on d); Mode A at beta
    0 with a random adversary, and with ef_sign, delayed_vote and
    diagnostics; sgd within its mean's rounding bound). Rank 0's slices, with their inputs, are then
    held here to the reference's own identity
    (``tests/distributed_harness.py:93-113``): ``jax.grad`` of each rank's
    loss, the sign of the summed signs (the mean), sliced: votes bit for
    bit, means within float32 rounding (rtol 1e-6).
(c) The train step. The reference's real ``make_train_step(cfg, tcfg,
    mesh)`` with fsdp runs in a subprocess on 4 fake CPU devices (data 4,
    model 1): a narrow MHA qwen1.5-32b in float32 (2 layers, d_model 128,
    4 heads of 4 kv heads, qkv bias) under its Mode B preset (signsgd_vote,
    global float32 momentum, hierarchical, beta 0.9, nested remat) at 2
    microbatches, 2 steps from its own init. A step composed here from the
    JAX package's functions alone (per voter and microbatch ``jax.grad``;
    for the fused leaves ``sign_ternary``, the count over the voters and
    its sign, accumulated in bf16 over the microbatches; for the others
    each voter's bf16 accumulator voted by ``VirtualBackend`` on
    hierarchical; then ``u = beta * u + (1 - beta) * vote`` and the
    update) is held to each real step, teacher-forced from the same state;
    then the port's stacked step (M = 4) is held to the composed one. In
    the same subprocess the reference's qwen3-moe Mode B preset (reduced,
    float32, fsdp: the router and the 4-D expert leaves fused) takes 2
    steps, and the port's stacked step is held to each, teacher-forced.
    The criteria (those of ``_check_teacher_forced``): the loss within rtol
    1e-5; the momentum within float32 rounding (rtol 1e-5, atol 1e-7) on
    every coordinate but those whose vote rounding decided (a voter's
    gradient within rounding of 0 changed a count), at most 0.1 % of
    them; the parameters equal wherever the momentum is.
(d) The rest: the fused leaves are the reference's; M = 1 without a mesh
    ignores fsdp (bit-equal to fsdp=False); remat none / full / nested /
    dots bit-equal under fsdp; the fused adversary's draws are the
    reference's ``evil_signs`` under no step, layer by layer, and do not
    change with the step; Mode A with momentum refuses at
    ``materialize_state`` with the reference's ``DuplicateSpecError``
    message (on data 4 and on pod 2 x data 2); Mode A at beta 0, the
    port's stacked step held to the reference's mesh
    step on data 4 teacher-forced (the loss within rtol 1e-5, the
    parameters equal on all but 0.1 % of the coordinates), and under a
    plan the reference's error, message for message.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro.configs import base as jbase  # noqa: E402
from repro.core import byzantine as jbyz  # noqa: E402
from repro.core import sign_compress as jsc  # noqa: E402
from repro.core import vote_api as jva  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import majority_vote as tmv  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.train import train_step as tTS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HARNESS = ROOT / "tests" / "torch_mesh_harness.py"
GB, SEQ, LR, BETA, MICRO, M4 = 8, 32, 1e-3, 0.9, 2, 4
STEPS = 2
#: coordinates a rounding-decided vote may touch, as a fraction
MAX_EXCLUDED = 1e-3


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


# ---------------------------------------------------------------------------
# (a) sharding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data", [4, 3])
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", [
    "glm4-9b", "qwen1.5-32b", "deepseek-67b", "gemma3-12b", "pixtral-12b",
    "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "mamba2-2.7b", "zamba2-1.2b",
    "whisper-tiny"])
def test_param_specs_equal_the_reference(arch, fsdp, data):
    shapes = jbase.get_config(arch).param_shapes()
    mesh = {"data": data, "model": 1}
    want = jshd.param_specs(shapes, fsdp=fsdp, mesh_shape=mesh)
    got = tshd.param_specs(shapes, fsdp=fsdp, mesh_shape=mesh)
    assert list(got) == list(want)
    for k, spec in want.items():
        assert got[k] == tuple(spec), k
    fused = tshd.fused_dims(got)
    assert set(fused) == {k for k, s in want.items() if "data" in tuple(s)}
    # 3 divides gemma3's d_model (3840) and whisper's (384), no FSDP dim
    # of the others
    assert bool(fused) == (fsdp and (data == 4 or arch in (
        "gemma3-12b", "whisper-tiny")))
    assert all(not k.startswith(("embed", "unembed")) for k in fused)
    # over a model axis too (tensor parallelism): model 2, 4, 8 and 16
    # beside this data size, and the production (pod 2, data 16, model 16)
    # mesh
    meshes = [{"data": data, "model": m} for m in (2, 4, 8, 16)]
    if data == 4:
        meshes.append({"pod": 2, "data": 16, "model": 16})
    for mesh in meshes:
        want = jshd.param_specs(shapes, fsdp=fsdp, mesh_shape=mesh)
        got = tshd.param_specs(shapes, fsdp=fsdp, mesh_shape=mesh)
        assert list(got) == list(want)
        for k, spec in want.items():
            assert got[k] == tuple(spec), (mesh, k)


def test_shards_join_back_and_model_axis_raises():
    rng = np.random.default_rng(0)
    tree = {"layers.attn_wo": rng.normal(size=(2, 8, 12)),
            "embed.table": rng.normal(size=(5, 12))}
    dims = {"layers.attn_wo": 2}
    for make in (np.asarray, torch.from_numpy):
        t = {k: make(v) for k, v in tree.items()}
        parts = [tshd.shard_tree(t, dims, i, 4) for i in range(4)]
        assert tuple(parts[1]["layers.attn_wo"].shape) == (2, 8, 3)
        back = tshd.join_shards(parts, dims)
        for k in tree:
            np.testing.assert_array_equal(np.asarray(back[k]), tree[k])
    # a model axis places leaves: the specs build, the blocks of every dim
    # a spec names join back, and the train step builds for every arch,
    # with the stochastic adversaries and a VotePlan too (an adaptive
    # adversary raises the reference's ValueError at the step's call)
    assert tshd.param_specs({"a": (4,)}, fsdp=True,
                            mesh_shape={"data": 2, "model": 2}) == {
        "a": (None,)}
    specs = {"layers.attn_wo": (None, "model", "data"),
             "embed.table": (None, "model")}
    sizes = {"data": 2, "model": 2}
    for make in (np.asarray, torch.from_numpy):
        t = {k: make(v) for k, v in tree.items()}
        parts = [tshd.shard_tree(t, specs, coords={"data": d, "model": m},
                                 sizes=sizes)
                 for d in range(2) for m in range(2)]
        assert tuple(parts[3]["layers.attn_wo"].shape) == (2, 4, 6)
        back = tshd.join_shards(parts, specs, sizes=sizes)
        for k in tree:
            np.testing.assert_array_equal(np.asarray(back[k]), tree[k])
    from repro_torch.distributed.mesh import ProcessMesh
    from torch_tp_common import assert_train_builds_and_refusals, fake_world
    with fake_world(8, rank=5):
        assert_train_builds_and_refusals(ProcessMesh((4, 2),
                                                     ("data", "model")))


# ---------------------------------------------------------------------------
# (b) the gather and the mesh trainer, on the 8-rank harness
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    scratch = tmp_path_factory.mktemp("fsdp_mesh")
    out = subprocess.run(
        [sys.executable, str(HARNESS), str(scratch), "fsdp"],
        capture_output=True, text=True, timeout=600, env=_env())
    record = None
    path = scratch / "fsdp_record.pkl"
    if path.exists():
        with open(path, "rb") as f:
            record = pickle.load(f)
    return out.returncode, out.stdout, out.stderr, record


def test_mesh_fsdp_equals_the_stacked_step(harness):
    rc, stdout, stderr, record = harness
    assert rc == 0 and "OK fsdp " in stdout, (
        f"harness exit {rc}\n{stdout[-3000:]}\n{stderr[-6000:]}")
    assert set(record["fsdp_trainer"]) == {
        "mode_b_flip", "mode_b_pod_random", "mode_b_dots",
        "mode_b_plan_diag", "signsgd_beta0", "mode_a_beta0_random",
        "mode_a_beta0_ef_delayed_diag", "mode_b_qwen3_moe"}
    diag = record["fsdp_trainer"]["mode_b_plan_diag"][0]
    assert np.isfinite(diag["vote_margin"])


@pytest.mark.parametrize("vote", [True, False], ids=["vote", "mean"])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("mesh", ["data8", "pod2x4"])
def test_fused_gather_is_the_reference_identity(harness, mesh, dim, vote):
    rc, stdout, stderr, record = harness
    assert rc == 0, f"harness exit {rc}\n{stderr[-6000:]}"
    (entry,) = [e for e in record["fsdp"] if e["mesh"] == mesh
                and e["dim"] == dim and e["vote"] == vote
                and e["rank"] == 0]
    w = jnp.asarray(record["fsdp_inputs"]["w"])
    xs = record["fsdp_inputs"]["xs"]
    grads = [np.asarray(jax.grad(lambda v, x=x: jnp.sum((x @ v) ** 2))(w))
             for x in xs]     # 8 voters: every rank of either mesh
    data = 8 if mesh == "data8" else 4
    size = w.shape[dim] // data
    part = [slice(None)] * 2
    d = entry["data_index"]
    part[dim] = slice(d * size, (d + 1) * size)
    part = tuple(part)
    if vote:
        want = np.sign(sum(np.sign(g) for g in grads))[part]
        np.testing.assert_array_equal(entry["got"], want)
    else:
        want = (sum(grads) / len(grads))[part]
        np.testing.assert_allclose(entry["got"], want, rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# (c) the train step against the reference's mesh step
# ---------------------------------------------------------------------------

_REFERENCE_MESH = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.compat import AxisType
from repro.configs import base as B
from repro.configs.presets import default_train_config
from repro.data.pipeline import SyntheticLMPipeline
from repro.train import train_step as TS
GB, SEQ, LR, MICRO, STEPS = {GB}, {SEQ}, {LR}, {MICRO}, {STEPS}
cfg = dataclasses.replace(B.reduced_config(B.get_config("qwen1.5-32b"),
                                           num_kv_heads=4), dtype="float32")
preset = default_train_config("qwen1.5-32b", B.ShapeCell("t", SEQ, GB,
                                                         "train"))
tcfg = dataclasses.replace(preset, microbatches=MICRO,
                           optimizer=dataclasses.replace(
                               preset.optimizer, learning_rate=LR))
mesh = compat.make_mesh((4, 1), ("data", "model"),
                        axis_types=(AxisType.Auto,) * 2)
art = TS.make_train_step(cfg, tcfg, mesh=mesh)
params, opt = TS.materialize_state(cfg, tcfg, art, jax.random.PRNGKey(0),
                                   mesh)
pipe = SyntheticLMPipeline(cfg, GB, SEQ, seed=0)
out = {{"fused": list(art.fused_leaves), "states": [], "losses": [],
        "batches": []}}
def snap(params, opt):
    return {{"params": {{k: np.asarray(v) for k, v in params.items()}},
            "momentum": {{k: np.asarray(v)
                         for k, v in opt["momentum"].items()}}}}
for step in range(STEPS):
    out["states"].append(snap(params, opt))
    tokens = pipe.global_batch_at(step)["tokens"]
    out["batches"].append(tokens)
    batch = {{"tokens": jax.device_put(tokens, NamedSharding(mesh,
                                                            P("data")))}}
    params, opt, met = art.step_fn(params, opt, batch, jnp.int32(step))
    out["losses"].append(float(met["loss"]))
out["states"].append(snap(params, opt))
# Mode A (per-worker momentum, beta 0.9) under fsdp, on data 4 and on
# pod 2 x data 2: where does the reference refuse?
out["mode_a"] = {{}}
mode_a = dataclasses.replace(tcfg, optimizer=B.OptimizerConfig(
    kind="signum_vote", momentum=0.9, learning_rate=LR))
for name, shape, axes in (("data4", (4, 1), ("data", "model")),
                          ("pod2x2", (2, 2, 1), ("pod", "data", "model"))):
    m = compat.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(
        shape))
    a = TS.make_train_step(cfg, mode_a, mesh=m)
    try:
        TS.materialize_state(cfg, mode_a, a, jax.random.PRNGKey(0), m)
        out["mode_a"][name] = None
    except Exception as e:
        out["mode_a"][name] = (type(e).__name__, str(e))
# Mode A at beta 0 (signSGD) under fsdp on data 4: the steps from its own
# init; then under a plan, where the step raises
beta0 = dataclasses.replace(tcfg, optimizer=B.OptimizerConfig(
    kind="signsgd_vote", momentum=0.0, learning_rate=LR,
    vote_strategy=B.VoteStrategy.HIERARCHICAL))
out["beta0"] = {{"states": [], "losses": []}}
a = TS.make_train_step(cfg, beta0, mesh=mesh)
p, o = TS.materialize_state(cfg, beta0, a, jax.random.PRNGKey(1), mesh)
for step in range(STEPS):
    out["beta0"]["states"].append({{k: np.asarray(v) for k, v in p.items()}})
    batch = {{"tokens": jax.device_put(out["batches"][step],
                                      NamedSharding(mesh, P("data")))}}
    p, o, met = a.step_fn(p, o, batch, jnp.int32(step))
    out["beta0"]["losses"].append(float(met["loss"]))
out["beta0"]["states"].append({{k: np.asarray(v) for k, v in p.items()}})
planned = dataclasses.replace(beta0, optimizer=dataclasses.replace(
    beta0.optimizer, bucket_bytes=4096))
a = TS.make_train_step(cfg, planned, mesh=mesh)
p, o = TS.materialize_state(cfg, planned, a, jax.random.PRNGKey(1), mesh)
try:
    a.step_fn(p, o, batch, jnp.int32(0))
    out["beta0_plan"] = None
except Exception as e:
    out["beta0_plan"] = (type(e).__name__, str(e))
# qwen3-moe's Mode B preset under fsdp (its expert leaves 4-D, sliced over
# data on d), float32, from its own init, on the same batches
moe_cfg = dataclasses.replace(B.reduced_config(B.get_config(
    "qwen3-moe-235b-a22b")), dtype="float32")
moe_preset = default_train_config("qwen3-moe-235b-a22b", B.ShapeCell(
    "t", SEQ, GB, "train"))
moe_tcfg = dataclasses.replace(moe_preset, microbatches=MICRO,
                               optimizer=dataclasses.replace(
                                   moe_preset.optimizer, learning_rate=LR))
a = TS.make_train_step(moe_cfg, moe_tcfg, mesh=mesh)
p, o = TS.materialize_state(moe_cfg, moe_tcfg, a, jax.random.PRNGKey(2),
                            mesh)
out["moe"] = {{"fused": list(a.fused_leaves), "states": [], "losses": []}}
for step in range(STEPS):
    out["moe"]["states"].append(snap(p, o))
    batch = {{"tokens": jax.device_put(out["batches"][step],
                                      NamedSharding(mesh, P("data")))}}
    p, o, met = a.step_fn(p, o, batch, jnp.int32(step))
    out["moe"]["losses"].append(float(met["loss"]))
out["moe"]["states"].append(snap(p, o))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
print("reference mesh ok")
"""


@pytest.fixture(scope="module")
def reference_mesh(tmp_path_factory):
    """The reference's real fsdp mesh step (subprocess, 4 CPU devices):
    its fused leaves, states, losses and batches, and where Mode A under
    fsdp refuses."""
    path = tmp_path_factory.mktemp("fsdp_ref") / "ref.pkl"
    code = _REFERENCE_MESH.format(GB=GB, SEQ=SEQ, LR=LR, MICRO=MICRO,
                                  STEPS=STEPS)
    env = {**_env(), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code, str(path)],
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-6000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _configs():
    """The reference's and the port's model config (narrow MHA qwen1.5-32b,
    float32) and the Mode B preset at the test's size, fsdp on."""
    from repro.configs.presets import default_train_config as jdefault
    from repro_torch.configs.presets import default_train_config as tdefault
    out = []
    for pkg, default in ((jbase, jdefault), (tbase, tdefault)):
        cfg = dataclasses.replace(pkg.reduced_config(
            pkg.get_config("qwen1.5-32b"), num_kv_heads=4), dtype="float32")
        preset = default("qwen1.5-32b", pkg.ShapeCell("t", SEQ, GB, "train"))
        assert preset.fsdp and preset.remat == "nested"
        out.append((cfg, dataclasses.replace(
            preset, microbatches=MICRO, optimizer=dataclasses.replace(
                preset.optimizer, learning_rate=LR))))
    return out


_GRAD = {}


def _composed_step(state, tokens, fused):
    """One M = 4 step of the Mode B preset under fsdp, composed from the
    JAX package's functions (see the module doc): the new state (numpy)
    and the loss."""
    (cfg, tcfg), _ = _configs()
    if "fn" not in _GRAD:
        _GRAD["fn"] = jax.jit(jax.value_and_grad(
            lambda p, t: jM.loss_fn(cfg, p, {"tokens": t}), has_aux=True))
    grad_fn = _GRAD["fn"]
    params = {k: jnp.asarray(v) for k, v in state["params"].items()}
    per, rows = GB // M4, GB // M4 // MICRO
    acc = {k: jnp.zeros(v.shape, jnp.bfloat16) for k, v in params.items()
           if k in fused}
    own = [{k: jnp.zeros(v.shape, jnp.bfloat16) for k, v in params.items()
            if k not in fused} for _ in range(M4)]
    losses = [[] for _ in range(M4)]
    for i in range(MICRO):
        count = {k: jnp.zeros(acc[k].shape, jnp.int32) for k in acc}
        for r in range(M4):
            lo = r * per + i * rows
            (loss, _), g = grad_fn(params, jnp.asarray(tokens[lo:lo + rows]))
            losses[r].append(float(loss))
            for k, v in g.items():
                if k in fused:
                    count[k] = count[k] + jsc.sign_ternary(v).astype(
                        jnp.int32)
                else:
                    own[r][k] = own[r][k] + v.astype(jnp.bfloat16)
        for k in acc:
            vote = jnp.sign(count[k]).astype(params[k].dtype)
            acc[k] = acc[k] + vote.astype(jnp.bfloat16)
    votes = {k: v / MICRO for k, v in acc.items()}
    raw = sorted(own[0])
    stacked = jnp.stack([jnp.concatenate(
        [(o[k] / MICRO).reshape(-1) for k in raw]) for o in own])
    flat = jva.VirtualBackend().execute(jva.VoteRequest(
        payload=stacked, form="stacked",
        strategy=jbase.VoteStrategy.HIERARCHICAL)).votes
    start = 0
    for k in raw:
        n = params[k].size
        votes[k] = flat[start:start + n].reshape(params[k].shape)
        start += n
    new = {"params": {}, "momentum": {}}
    for k, p in params.items():
        u = BETA * jnp.asarray(state["momentum"][k]) + (1 - BETA) * \
            votes[k].astype(jnp.float32)
        new["momentum"][k] = np.asarray(u)
        p32 = p.astype(jnp.float32)
        new["params"][k] = np.asarray(
            (p32 - LR * (jnp.sign(u) + 0.0 * p32)).astype(p.dtype))
    new["loss"] = float(np.mean([np.mean(x) for x in losses]))
    return new


def _check_step(ref, got):
    """The teacher-forced criteria of the module doc."""
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    outside = total = 0
    for k, u in ref["momentum"].items():
        close = np.isclose(got["momentum"][k], u, rtol=1e-5, atol=1e-7)
        outside += int((~close).sum())
        total += close.size
        np.testing.assert_array_equal(got["params"][k][close],
                                      ref["params"][k][close], err_msg=k)
    assert outside <= MAX_EXCLUDED * total, (outside, total)


@pytest.fixture(scope="module")
def composed(reference_mesh):
    fused = set(reference_mesh["fused"])
    return [_composed_step(reference_mesh["states"][t],
                           reference_mesh["batches"][t], fused)
            for t in range(STEPS)]


def test_fused_leaves_are_the_reference(reference_mesh):
    _, (cfg, tcfg) = _configs()
    art = tTS.make_train_step(cfg, tcfg, M4, device="cpu")
    assert list(art.fused_leaves) == reference_mesh["fused"]
    assert set(art.fused_leaves) == {
        f"layers.{k}" for k in ("attn_wq", "attn_wk", "attn_wv", "attn_wo",
                                "mlp_w_gate", "mlp_w_up", "mlp_w_down")}


@pytest.mark.parametrize("step", range(STEPS))
def test_composed_step_equals_the_reference_mesh_step(reference_mesh,
                                                      composed, step):
    ref = {"loss": reference_mesh["losses"][step],
           **reference_mesh["states"][step + 1]}
    _check_step(ref, composed[step])


@pytest.mark.parametrize("step", range(STEPS))
def test_port_stacked_step_meets_the_composed_step(reference_mesh, composed,
                                                   step):
    _, (cfg, tcfg) = _configs()
    state = reference_mesh["states"][step]
    art = tTS.make_train_step(cfg, tcfg, M4, device="cpu")
    params = tM.params_from_numpy(state["params"], device="cpu")
    opt = {"count": step,
           "momentum": tM.params_from_numpy(state["momentum"],
                                            device="cpu")}
    params, opt, met = art.step_fn(params, opt, {
        "tokens": reference_mesh["batches"][step]}, step)
    got = {"loss": float(met["loss"]),
           "params": {k: v.numpy() for k, v in params.items()},
           "momentum": {k: v.numpy() for k, v in opt["momentum"].items()}}
    _check_step(composed[step], got)


def _moe_configs():
    """The port's reduced qwen3-moe in float32 and its Mode B preset at the
    test's size (fsdp on, nested remat, 2 microbatches, lr LR)."""
    from repro_torch.configs.presets import default_train_config
    cfg = dataclasses.replace(tbase.reduced_config(tbase.get_config(
        "qwen3-moe-235b-a22b")), dtype="float32")
    preset = default_train_config("qwen3-moe-235b-a22b", tbase.ShapeCell(
        "t", SEQ, GB, "train"))
    return cfg, dataclasses.replace(
        preset, microbatches=MICRO, optimizer=dataclasses.replace(
            preset.optimizer, learning_rate=LR))


@pytest.mark.parametrize("step", range(STEPS))
def test_qwen3_moe_stacked_step_meets_the_reference_mesh_step(
        reference_mesh, step):
    """qwen3-moe's Mode B preset with fsdp: the port's stacked step (M = 4)
    teacher-forced from the reference's real mesh step's state (data 4)
    meets its next state by ``_check_step``'s criteria. Its fused leaves
    are the reference's, the 4-D expert leaves among them."""
    moe = reference_mesh["moe"]
    cfg, tcfg = _moe_configs()
    art = tTS.make_train_step(cfg, tcfg, M4, device="cpu")
    assert list(art.fused_leaves) == moe["fused"]
    assert {"layers.router_w", "layers.experts_w_gate",
            "layers.experts_w_up", "layers.experts_w_down"} <= set(
                art.fused_leaves)
    assert art.fused_dims["layers.experts_w_gate"] == 2
    assert art.fused_dims["layers.experts_w_down"] == 3
    state = moe["states"][step]
    params = tM.params_from_numpy(state["params"], device="cpu")
    opt = {"count": step,
           "momentum": tM.params_from_numpy(state["momentum"],
                                            device="cpu")}
    params, opt, met = art.step_fn(params, opt, {
        "tokens": reference_mesh["batches"][step]}, step)
    got = {"loss": float(met["loss"]),
           "params": {k: v.numpy() for k, v in params.items()},
           "momentum": {k: v.numpy() for k, v in opt["momentum"].items()}}
    _check_step({"loss": moe["losses"][step], **moe["states"][step + 1]},
                got)


@pytest.mark.parametrize("mesh", ["data4", "pod2x2"])
def test_mode_a_under_fsdp_refuses_as_the_reference(reference_mesh, mesh):
    """The reference's Mode A (momentum 0.9) under fsdp refuses at
    ``materialize_state``; the port raises the same error type with the
    same message at the same call (the stacked step on data 4; on pod 2 x
    data 2 the spec check the mesh step runs)."""
    name, msg = reference_mesh["mode_a"][mesh]
    assert name == tshd.DuplicateSpecError.__name__
    _, (cfg, tcfg) = _configs()
    mode_a = dataclasses.replace(tcfg, optimizer=tbase.OptimizerConfig(
        kind="signum_vote", momentum=0.9, learning_rate=LR))
    art = tTS.make_train_step(cfg, mode_a, M4, device="cpu")
    if mesh == "data4":
        with pytest.raises(tshd.DuplicateSpecError) as got:
            tTS.materialize_state(cfg, mode_a, art,
                                  torch.Generator().manual_seed(0))
    else:
        with pytest.raises(tshd.DuplicateSpecError) as got:
            for k in art.fused_dims:
                tshd.check_spec((("pod", "data"),)
                                + tuple(art.param_specs[k]))
    assert str(got.value) == msg


# ---------------------------------------------------------------------------
# (d) the rest
# ---------------------------------------------------------------------------


def _run(cfg, tcfg, n_voters, steps=STEPS):
    from repro_torch.data.pipeline import SyntheticLMPipeline
    art = tTS.make_train_step(cfg, tcfg, n_voters, device="cpu")
    params, state = tTS.materialize_state(cfg, tcfg, art,
                                          torch.Generator().manual_seed(0))
    pipe = SyntheticLMPipeline(cfg, GB, SEQ, seed=0)
    losses = []
    for step in range(steps):
        params, state, met = art.step_fn(params, state, {
            "tokens": pipe.global_batch_at(step)["tokens"]}, step)
        losses.append(float(met["loss"]))
    return losses, params, state


def _equal(a, b):
    assert a[0] == b[0]
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    for k in a[2]["momentum"]:
        assert torch.equal(a[2]["momentum"][k], b[2]["momentum"][k]), k


_NONE = {}


@pytest.mark.parametrize("remat", ["none", "full", "nested", "dots"])
def test_remat_modes_are_bit_equal_under_fsdp(remat):
    _, (cfg, tcfg) = _configs()
    if "none" not in _NONE:
        _NONE["none"] = _run(cfg, dataclasses.replace(tcfg, remat="none"),
                             M4)
    _equal(_run(cfg, dataclasses.replace(tcfg, remat=remat), M4),
           _NONE["none"])


def test_one_voter_ignores_fsdp_as_the_reference():
    _, (cfg, tcfg) = _configs()
    art = tTS.make_train_step(cfg, tcfg, 1, device="cpu")
    assert art.fused_leaves == ()
    _equal(_run(cfg, tcfg, 1), _run(cfg, dataclasses.replace(
        tcfg, fsdp=False), 1))


def _beta0(tcfg, **opt):
    """Mode A at beta 0 (signSGD) on hierarchical, as the reference's run
    of it."""
    return dataclasses.replace(tcfg, optimizer=tbase.OptimizerConfig(
        kind="signsgd_vote", momentum=0.0, learning_rate=LR,
        vote_strategy=tbase.VoteStrategy.HIERARCHICAL, **opt))


def test_mode_a_at_beta_zero_under_fsdp_raises(reference_mesh):
    """Mode A at beta 0 under fsdp no longer raises: the port's stacked
    step (M = 4) votes the fused leaves' accumulated votes a second time,
    voter r sending its slice r, and meets the reference's mesh step on
    data 4, teacher-forced from its state at each step: the loss within
    rtol 1e-5, the parameters equal on all but MAX_EXCLUDED of the
    coordinates (a vote that rounding decided, which the second vote
    carries into every slice)."""
    _, (cfg, tcfg) = _configs()
    beta0 = _beta0(tcfg)
    art = tTS.make_train_step(cfg, beta0, M4, device="cpu")
    assert art.fused_leaves == tuple(reference_mesh["fused"])
    ref = reference_mesh["beta0"]
    for step in range(STEPS):
        params = tM.params_from_numpy(ref["states"][step], device="cpu")
        params, _, met = art.step_fn(params, {"count": step}, {
            "tokens": reference_mesh["batches"][step]}, step)
        np.testing.assert_allclose(float(met["loss"]), ref["losses"][step],
                                   rtol=1e-5)
        differ = total = 0
        for k, want in ref["states"][step + 1].items():
            differ += int((params[k].numpy() != want).sum())
            total += want.size
        assert differ <= MAX_EXCLUDED * total, (step, differ, total)


def test_mode_a_at_beta_zero_under_a_plan_raises_as_the_reference(
        reference_mesh):
    """Under a plan (built on the whole parameters' shapes) the
    reference's step raises at the first fused leaf's slice; the port's
    step raises the same error with the same message."""
    name, msg = reference_mesh["beta0_plan"]
    assert name == "ValueError"
    _, (cfg, tcfg) = _configs()
    planned = _beta0(tcfg, bucket_bytes=4096)
    art = tTS.make_train_step(cfg, planned, M4, device="cpu")
    params, state = tTS.materialize_state(cfg, planned, art,
                                          torch.Generator().manual_seed(0))
    with pytest.raises(ValueError) as got:
        art.step_fn(params, state, {
            "tokens": reference_mesh["batches"][0]}, 0)
    assert str(got.value) == msg


@pytest.mark.parametrize("mode", ["random", "colluding", "blind"])
def test_fused_adversary_draws_are_the_reference_under_no_step(mode):
    """The fused backward's adversary (voter 1 of 2 adversaries) on a
    stacked leaf of 2 layers: each layer drawn as the reference's
    ``evil_signs(..., step=None)`` of that layer alone, the same bits for
    both layers (as the reference's per-layer gathers draw them) and in
    every step and microbatch (no step is folded in)."""
    rng = np.random.default_rng(3)
    g = rng.normal(size=(2, 6, 41)).astype(np.float32)
    g[0, 0, :5] = 0.0
    g[1] = g[0]
    cfg = dict(mode=mode, num_adversaries=2, flip_prob=0.3, seed=7)
    got = tmv.fused_signs(torch.from_numpy(g), tbase.ByzantineConfig(**cfg),
                          1, rows=2)
    again = tmv.fused_signs(torch.from_numpy(g), tbase.ByzantineConfig(
        **cfg), 1, rows=2)
    assert torch.equal(got, again)
    jcfg = jbase.ByzantineConfig(**cfg)
    for layer in range(2):
        want = jbyz.evil_signs(jsc.sign_ternary(jnp.asarray(g[layer])), jcfg,
                               jnp.int32(1), step=None)
        np.testing.assert_array_equal(got[layer].numpy(), np.asarray(want))
    assert torch.equal(got[0], got[1])
    honest = tmv.fused_signs(torch.from_numpy(g), tbase.ByzantineConfig(
        **cfg), 2, rows=2)
    np.testing.assert_array_equal(honest.numpy(), np.sign(g))
