"""The model axis for the MoE, SSM, hybrid and encoder-decoder archs
(``distributed.tensor_parallel``) against the port's stacked step and the
JAX package's own mesh paths, on the CPU.

(a) One launch of ``tests/torch_mesh_harness.py <scratch> tp_families``
    (8 gloo ranks) holds, on the reduced configs in float32, each run's 2
    steps to the port's stacked step of the mesh's voters from the same
    joined state, with ``check_tp``'s criteria (losses within rtol 1e-5;
    momenta within the families' float32 tolerance, one bf16 ulp with the
    bf16 microbatch accumulator; parameters equal within float32 rounding
    except where a vote flipped, each flip at a coordinate where some
    voter's vote input is under 1e-4 of its leaf's largest; replicated
    leaves, ``router_w`` and ``shared_gate_w`` among them, bit-equal over
    the model group; each step's model-group bytes ``chip_smoke.tp_bytes``'s)
    and counts the tokens whose routing differs from the twin's, each
    required at a near tie (top-k margin under 1e-5): qwen2-moe's EP at
    model 2 and 4 and M2 at model 8 (the shared branch), qwen3-moe's Mode B
    fsdp preset (4-D fused expert leaves with both axes) and its M2,
    mamba2 and zamba2 (the SSD heads-sharded; zamba2's shared block in its
    output-sharded layout), whisper's grouped / repeat / seq forms and a
    whole 515-row vocabulary; Mode A sign1bit and each arch's preset wire.
    One decode of 4 ticks an arch is held to the single-device steps
    (logits within rtol / atol 1e-4, greedy tokens equal, each tick's
    bytes ``chip_smoke.tp_tick_bytes``'s, the decode paths the layout's).
    A reduced qwen3-moe Mode B fsdp state and a reduced mamba2 Mode A state
    are checkpointed on (data 2, model 2): the files equal the stacked
    save of the joined state, restored they are the blocks bit for bit on
    that mesh and resume with the uninterrupted run's next step bit for
    bit, and restored on (data 4, model 1), (data 1, model 4) and stacked
    they join back to the files' arrays.
(b) ``tests/torch_tp_reference.py <scratch> families`` (8 fake XLA
    devices, run beside (a)) takes the reference's (data 4, model 2)
    Mode A step of the reduced qwen2-moe, mamba2 and whisper and its
    (data 1, model 4) ``decode_step`` of the reduced zamba2 (whisper's is
    left out for the file's time; (a) holds its decode);
    the harness's ``tp_families_ref`` check runs the port's from the same
    start; the steps are held to them with (a)'s criteria, the decodes
    within rtol / atol 1e-4 with greedy tokens equal.
(c) The layout table: for every arch's published and reduced config at
    model 2, 4, 8 and 16 and on the (2, 16, 16) mesh, the attention form,
    the MoE form, whether the SSD is heads-sharded and whether the
    vocabulary is whole; the port builds each case on a world of fake
    ranks, and the published rows are ``distributed.tensor_parallel``'s
    docstring table.
"""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.distributed import tensor_parallel as tpar  # noqa: E402
from repro_torch.distributed.mesh import ProcessMesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import _attn_form  # noqa: E402
from torch_tp_common import ALL, fake_world  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = pathlib.Path(__file__).resolve().parent
#: the criteria of (a), as the harness states them
FLIP_FRACTION, F32_RTOL, F32_ATOL_REL = 1e-4, 1e-4, 2e-5
FAMILY_STEPS = ("qwen2-moe-a2.7b", "mamba2-2.7b", "whisper-tiny")
FAMILY_DECODES = ("zamba2-1.2b",)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    """The reference's families run beside the harness's tp_families
    check, then the harness's tp_families_ref check from the reference's
    start states, in one scratch directory."""
    path = tmp_path_factory.mktemp("tpf")
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "torch_tp_reference.py"), str(path),
         "families"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=8",
            JAX_PLATFORMS="cpu"))
    try:
        out = subprocess.run(
            [sys.executable, str(HERE / "torch_mesh_harness.py"), str(path),
             "tp_families"], capture_output=True, text=True, timeout=900,
            env=_env())
        ref_out, ref_err = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "OK tp_families" in out.stdout
    assert ref.returncode == 0, ref_out[-4000:] + ref_err[-4000:]
    port = subprocess.run(
        [sys.executable, str(HERE / "torch_mesh_harness.py"), str(path),
         "tp_families_ref"], capture_output=True, text=True, timeout=600,
        env=_env())
    assert port.returncode == 0, port.stdout[-4000:] + port.stderr[-4000:]
    return path


# ---------------------------------------------------------------------------
# (a) the harness
# ---------------------------------------------------------------------------


def test_the_families_hold_to_their_stacked_twins(scratch):
    with open(scratch / "tp_families_record.pkl", "rb") as f:
        every = pickle.load(f)["tp_families"]
    assert len(every) == 8
    for rank in every:
        assert len(rank["flips"]) == 14
        # every flip was justified by the harness; they stay rare
        for label, n in rank["flips"].items():
            assert n <= 8, (label, n)
        # routing differs from the twin's only at near ties, if at all
        assert sum(rank["routes"].values()) <= 2, rank["routes"]


def test_m2_at_model_8_hands_the_model_group_the_layouts_count(
        scratch, monkeypatch):
    """qwen2-moe's M2 form (its reduced 4 experts over a model axis of 8:
    every expert's d_ff columns a rank) on the harness's 8 gloo ranks:
    each step's measured model-group bytes are ``chip_smoke.tp_bytes``'s
    count of the layout, whose MoE term does not depend on the form (the
    card's 19h holds its 8 ranks to the same count at published width)."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(HERE))
    import chip_smoke
    import torch_mesh_harness as H
    with open(scratch / "tp_families_record.pkl", "rb") as f:
        every = pickle.load(f)["tp_families"]
    label, _, arch, opt, extra, over = next(
        c for c in H._tpf_cfgs() if c[0] == "moe_m2_seq")
    cfg = dataclasses.replace(tbase.reduced_config(tbase.get_config(arch)),
                              dtype="float32", **over)
    tcfg = tbase.TrainConfig(global_batch=H.TP_GB, seq_len=H.TP_SEQ,
                             optimizer=opt, **extra)
    assert tmoe.moe_form(cfg.moe, 8) == "M2"
    # the harness sums by blocks at every size, as the card's large sums
    from repro_torch.distributed import mesh as pm
    monkeypatch.setattr(pm, "A2A_MIN_BYTES", 0)
    with fake_world(8):
        want = chip_smoke.tp_bytes(cfg, tcfg, ProcessMesh((8,), ("model",)),
                                   H.TP_FRAMES)
    assert want > 0
    for rank in every:
        assert rank["model_bytes"][label] == [want] * H.STEPS


@pytest.mark.parametrize("label", ["qwen3_mode_b_fsdp", "mamba2_mode_a"])
def test_the_checkpoint_files_are_the_stacked_runs(scratch, label):
    # the harness saved the mesh run's state and the stacked save of the
    # same state joined; the files hold the same arrays, bits and dtypes
    root = scratch / f"tpf_ck_{label}"
    steps = [sorted((root / kind).glob("step_*"))[-1]
             for kind in ("mesh", "stacked")]
    with np.load(steps[0] / "arrays.npz") as a, \
            np.load(steps[1] / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # the per-voter state is stacked: one row a voter of the 2
        if label == "mamba2_mode_a":
            assert a["opt/momentum/layers.mamba_A_log"].shape[0] == 2
    for step in steps:
        assert (step / "meta.json").read_text() == (
            steps[0] / "meta.json").read_text()


# ---------------------------------------------------------------------------
# (b) the reference's own mesh paths
# ---------------------------------------------------------------------------


def _load(path, prefix):
    with np.load(path) as z:
        return {k[len(prefix):]: z[k] for k in z.files
                if k.startswith(prefix)}


def _family_cfg(arch):
    cfg = dataclasses.replace(tbase.reduced_config(tbase.get_config(arch)),
                              dtype="float32")
    if cfg.moe.enabled:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    return cfg


@pytest.mark.parametrize("arch", FAMILY_STEPS)
def test_the_4x2_step_holds_to_the_reference_mesh_step(scratch, arch):
    cfg = _family_cfg(arch)
    sizes = {"pod": 1, "data": 4, "model": 2}
    specs = tshd.param_specs(cfg.param_shapes(), fsdp=False,
                             mesh_shape=sizes)
    ranks = [scratch / f"tpf_step_{arch}_rank{r}.npz" for r in range(8)]
    params = tshd.join_shards([_load(p, "p/") for p in ranks], specs,
                              sizes=sizes)
    moms = [tshd.join_shards([_load(ranks[2 * v + m], "m/")
                              for m in range(2)], specs,
                             sizes={"model": 2}) for v in range(4)]
    with np.load(scratch / f"tpf_ref_{arch}_step.npz") as z:
        ref_loss = float(z["loss"])
    losses = [float(np.load(p)["loss"]) for p in ranks]
    want_p = _load(scratch / f"tpf_ref_{arch}_step.npz", "p/")
    want_m = _load(scratch / f"tpf_ref_{arch}_step.npz", "m/")
    start = _load(scratch / f"tpf_ref_{arch}_start.npz", "p/")
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


@pytest.mark.parametrize("arch", FAMILY_DECODES)
def test_the_model4_decode_holds_to_the_reference_decode(scratch, arch):
    ref = dict(np.load(scratch / f"tpf_dec_{arch}_ref.npz"))
    ticks = sorted(k for k in ref if k.startswith("tick"))
    assert len(ticks) == 3
    for r in range(4):
        got = dict(np.load(scratch / f"tpf_dec_{arch}_rank{r}.npz"))
        for key in ["prefill"] + ticks:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4,
                                       atol=1e-4, err_msg=key)
            np.testing.assert_array_equal(got[key].argmax(-1),
                                          ref[key].argmax(-1))


# ---------------------------------------------------------------------------
# (c) the layout table
# ---------------------------------------------------------------------------

#: (label, shape, axis names) of the meshes the table covers
LAYOUT_MESHES = (("model2", (2,), ("model",)), ("model4", (4,), ("model",)),
                 ("model8", (8,), ("model",)),
                 ("model16", (16,), ("model",)),
                 ("pod2_data16_model16", (2, 16, 16),
                  ("pod", "data", "model")))


def layout(cfg, m: int) -> dict:
    """The parts of `cfg` over a model axis of `m`: the attention form
    ("whole" for zamba2's shared block, whose leaves the stacked rules lay
    out), the MoE form, whether the SSD is heads-sharded, whether the
    vocabulary stays whole."""
    out = {}
    fam = cfg.family
    if fam == tbase.ArchFamily.HYBRID:
        out["attn"] = "whole"
    elif cfg.num_heads:
        out["attn"] = _attn_form(cfg.num_heads, cfg.num_kv_heads, m)
    if cfg.moe.enabled:
        out["moe"] = tmoe.moe_form(cfg.moe, m)
    if cfg.ssm.enabled:
        out["ssd"] = ("heads" if cfg.ssm.n_heads(cfg.d_model) % m == 0
                      else "whole")
    out["vocab"] = "whole" if cfg.vocab_size % m else "sharded"
    return out


def _configs(arch):
    full = tbase.get_config(arch)
    return (("published", full), ("reduced", tbase.reduced_config(full)))


@pytest.mark.parametrize("mesh_label,shape,names", LAYOUT_MESHES)
@pytest.mark.parametrize("variant", ["published", "reduced"])
@pytest.mark.parametrize("arch", ALL)
def test_every_layout_builds(arch, variant, mesh_label, shape, names):
    from repro_torch.train import serve_step as SS
    from repro_torch.train import train_step as TS
    cfg = dict(_configs(arch))[variant]
    m = shape[-1]
    parts = layout(cfg, m)
    # the port runs every part: the MoE in EP or M2, the SSD heads-sharded
    assert parts.get("moe", "EP") in ("EP", "M2"), parts
    assert parts.get("ssd", "heads") == "heads", parts
    world = int(np.prod(shape))
    tcfg = tbase.TrainConfig(global_batch=world // m * 2, seq_len=64,
                             optimizer=tbase.OptimizerConfig(
                                 kind="signum_vote", learning_rate=1e-3,
                                 momentum=0.9, vote_strategy=tbase.
                                 VoteStrategy.ALLGATHER_1BIT))
    with fake_world(world, rank=world - 1):
        mesh = ProcessMesh(shape, names)
        art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
        assert art.mesh_sizes["model"] == m
        # the leaves the layout keeps whole are the vocabulary tables (when
        # the axis does not divide it) and what the rules never shard
        for k, spec in art.param_specs.items():
            if tshd.model_tagged(k, len(spec)) and "model" not in spec:
                assert k in ("embed.table", "unembed.table"), k
                assert parts["vocab"] == "whole"
        assert callable(SS.make_decode_step(cfg, mesh=mesh, max_len=4096))
        assert callable(SS.make_prefill(cfg, mesh=mesh))
        assert callable(SS.make_prefill_sharded(
            cfg, mesh, fsdp=True, global_batch=world // m * 2))
        assert callable(SS.make_cache_rehome(cfg, world // m * 2, 4096,
                                             mesh=mesh))


def _docstring_table():
    """{(arch, part): [form at model 2, 4, 8, 16]} of
    ``distributed.tensor_parallel``'s table."""
    lines = tpar.__doc__.split("\n")
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("arch (published)"))
    rows = {}
    for ln in lines[start + 2:]:
        if ln.startswith("="):
            break
        cells = ln.split()
        rows[(cells[0], cells[1])] = cells[2:]
    return rows


def test_the_docstring_table_is_the_layout():
    table = _docstring_table()
    got = {}
    for arch in ALL:
        cfg = tbase.get_config(arch)
        for m in (2, 4, 8, 16):
            for part, form in layout(cfg, m).items():
                if part == "vocab" and arch not in ("mamba2-2.7b",
                                                    "whisper-tiny"):
                    continue
                if part == "ssd" and arch != "mamba2-2.7b" and \
                        arch != "zamba2-1.2b":
                    continue
                got.setdefault((arch, part), []).append(form)
    assert got == table
