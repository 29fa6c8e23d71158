"""The port's training launcher (``python -m repro_torch.launch.train``) and
the recorder's launcher helpers, on the CPU (``--device cpu``).

* ``build`` gives the reference's ``build`` (``repro.launch.train``)
  field for field, for several flag sets;
* a run killed right after a checkpoint and started again on the same
  directory resumes after the saved step: its losses from there on (the
  trace's step rows) and its final checkpoint equal those of a run never
  stopped, bit for bit;
* the trace (``--trace``) holds one ``train.step`` span and one step row
  per step, read back by both packages' ``read_trace``;
* ``--serve-dir`` publishes the parameters every ``--serve-every`` steps
  and after the last, and a ``serve.CheckpointWatcher`` surfaces each
  publication once; an unknown arch raises the registry's ``KeyError``;
  every family trains through the launcher; ``python -m
  repro_torch.launch.train`` runs;
* whisper's float32 frames (ROADMAP.md Queue 3, F1): the reference's
  numpy pipeline hands float32 ``enc_embeds``, on which the reference's
  step raises its ``TypeError``; the port trains on the same batch, its
  step bit-equal to its step on the bf16-cast batch and equal to the
  reference's step on that batch wherever the two packages' momenta have
  one sign (bf16 gradients, each package rounding in its own order:
  the signs differ on under 2 % of any leaf's coordinates, 0.93 %
  measured), the losses within the bf16 loss tolerance (2e-2).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline as JPipe  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.obs import recorder as jrec  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMPipeline as TPipe  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.obs import recorder as trec  # noqa: E402
from repro_torch.serve import CheckpointWatcher, like_tree  # noqa: E402
from repro_torch.train import train_step as tTS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--device", "cpu", "--arch", "glm4-9b", "--reduced", "--batch", "4",
        "--seq", "32", "--log-every", "1"]


def _plain(x):
    """A config as plain Python, enums by value."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return getattr(x, "value", x)


@pytest.mark.parametrize("kw", [
    dict(arch="glm4-9b", reduced=True, batch=8, seq=128,
         opt_kind="signum_vote", lr=1e-3, momentum=0.9, microbatches=1,
         byz_mode="none", byz_n=0),
    dict(arch="qwen1.5-32b", reduced=False, batch=32, seq=512,
         opt_kind="sgd", lr=1e-2, momentum=0.0, microbatches=4,
         byz_mode="sign_flip", byz_n=1),
    dict(arch="glm4-9b", reduced=False, batch=8, seq=128,
         opt_kind="signsgd_vote", lr=1e-3, momentum=0.0, microbatches=2,
         byz_mode="random", byz_n=0),
    dict(arch="mamba2-2.7b", reduced=True, batch=8, seq=128,
         opt_kind="signum_vote", lr=1e-3, momentum=0.9, microbatches=2,
         byz_mode="none", byz_n=0),
    dict(arch="zamba2-1.2b", reduced=False, batch=16, seq=256,
         opt_kind="signum_vote", lr=1e-4, momentum=0.9, microbatches=4,
         byz_mode="none", byz_n=0),
    dict(arch="whisper-tiny", reduced=True, batch=8, seq=64,
         opt_kind="adam", lr=1e-3, momentum=0.9, microbatches=1,
         byz_mode="sign_flip", byz_n=1),
], ids=["reduced", "qwen_sgd_byzantine", "signsgd", "mamba2", "zamba2",
        "whisper"])
def test_build_equals_the_reference(kw):
    jcfg, jtcfg = jlaunch.build(**kw)
    tcfg_, ttcfg = tlaunch.build(**kw)
    assert _plain(tcfg_) == _plain(jcfg)
    assert _plain(ttcfg) == _plain(jtcfg)


def _losses(trace):
    rows = trace_rows(trace)
    return {r["step"]: r["loss"] for r in rows if r["kind"] == "step"}


def trace_rows(path):
    rows = trec.read_trace(str(path))
    assert rows == jrec.read_trace(str(path))
    return rows


class _Killed(Exception):
    pass


def test_killed_run_resumes_as_if_never_stopped(tmp_path, monkeypatch):
    steps = ["--steps", "4", "--ckpt-every", "2"]
    whole = tmp_path / "whole"
    assert tlaunch.main(BASE + steps + ["--ckpt-dir", str(whole / "ck"),
                                        "--trace", str(tmp_path / "a")]) == 0

    class KilledAfterSave(tckpt.AsyncCheckpointer):
        def save(self, *args, **kwargs):
            super().save(*args, **kwargs)
            self.wait()
            raise _Killed   # the process dies right after the save

    cut = tmp_path / "cut" / "ck"
    monkeypatch.setattr(tlaunch, "AsyncCheckpointer", KilledAfterSave)
    with pytest.raises(_Killed):
        tlaunch.main(BASE + steps + ["--ckpt-dir", str(cut)])
    monkeypatch.undo()
    assert os.path.basename(tckpt.latest_step_dir(str(cut))) == \
        "step_00000001"
    assert tlaunch.main(BASE + steps + ["--ckpt-dir", str(cut), "--trace",
                                        str(tmp_path / "b")]) == 0
    a, b = _losses(tmp_path / "a"), _losses(tmp_path / "b")
    assert sorted(a) == [0, 1, 2, 3] and sorted(b) == [2, 3]
    assert all(b[s] == a[s] for s in b)
    got = tckpt.restore(str(cut), device="cpu")
    want = tckpt.restore(str(whole / "ck"), device="cpu")
    for part in (0, 1):
        flat_got, flat_want = tckpt._flatten(got[part]), tckpt._flatten(
            want[part])
        assert sorted(flat_got) == sorted(flat_want)
        for k, v in flat_want.items():
            assert torch.equal(flat_got[k], v), k
    assert got[2] == want[2] == {"step": 4}


def test_trace_holds_the_step_spans(tmp_path, capsys):
    path = tmp_path / "t.jsonl"
    assert tlaunch.main(BASE + ["--steps", "3", "--opt", "signsgd_vote",
                                "--momentum", "0", "--trace",
                                str(path)]) == 0
    rows = trace_rows(path)
    spans = [r for r in rows if r["kind"] == "span"
             and r["name"] == "train.step"]
    assert [s["attrs"]["step"] for s in spans] == [0, 1, 2]
    steps = [r for r in rows if r["kind"] == "step"]
    assert [r["step"] for r in steps] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["opt"] == "signsgd_vote"
               for r in steps)
    assert rows[-1]["kind"] == "counters"
    out = capsys.readouterr().out
    assert "step     2" in out and "# wrote trace" in out


def test_bench_json_is_the_reference_schema(tmp_path):
    rows = [("a_ms", 1.5, "x"), {"name": "b", "value": 2}]
    trec.emit_bench_json(rows, str(tmp_path / "t.json"))
    jrec.emit_bench_json(rows, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b",
                                  "whisper-tiny"])
def test_serve_dir_and_unported_arch_raise(tmp_path, arch, capsys):
    """--serve-dir publishes every --serve-every steps and after the last
    (5 steps, every 2: steps 1, 3 and 4), each surfaced once by a watcher
    polling between the launcher's steps, the last equal to the trained
    parameters of the run's final checkpoint; an unknown arch raises the
    registry's KeyError, as in the reference; the SSM, hybrid and
    encoder-decoder families train through the launcher (the reduced
    config, two steps, finite losses)."""
    serve = tmp_path / "serve"
    watcher = CheckpointWatcher(str(serve), device="cpu")
    seen = []

    class Polled(tckpt.AsyncCheckpointer):
        def save(self, step, *args, **kwargs):
            seen.append(watcher.poll())        # between the steps
            super().save(step, *args, **kwargs)

    tlaunch_main = tlaunch.main
    mp = pytest.MonkeyPatch()
    mp.setattr(tlaunch, "AsyncCheckpointer", Polled)
    try:
        assert tlaunch_main(BASE + ["--steps", "5", "--serve-dir", str(serve),
                                    "--serve-every", "2", "--ckpt-dir",
                                    str(tmp_path / "ck"),
                                    "--ckpt-every", "1"]) == 0
    finally:
        mp.undo()
    seen.append(watcher.poll())
    got = [(u.version, u.step) for u in seen if u is not None]
    assert got == [(1, 1), (2, 3), (3, 4)]
    assert watcher.poll() is None
    final = seen[-1].params
    want = tckpt.restore(str(tmp_path / "ck"), device="cpu")[0]
    assert sorted(final) == sorted(want)
    for k, v in want.items():
        assert torch.equal(final[k], v), k
    assert all(t.device.type == "meta" for t in like_tree(final).values())
    with pytest.raises(KeyError, match="unknown arch"):
        tlaunch.main(["--device", "cpu", "--arch", "mamba3-9b", "--steps",
                      "1"])
    capsys.readouterr()
    assert tlaunch.main(["--device", "cpu", "--arch", arch, "--reduced",
                         "--batch", "4", "--seq", "32", "--steps", "2",
                         "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_whisper_float32_frames_train_where_the_reference_raises():
    kw = dict(arch="whisper-tiny", reduced=True, batch=2, seq=16,
              opt_kind="signum_vote", lr=1e-3, momentum=0.9, microbatches=1,
              byz_mode="none", byz_n=0)
    jcfg, jtcfg = jlaunch.build(**kw)
    tcfg, ttcfg = tlaunch.build(**kw)
    jart = jTS.make_train_step(jcfg, jtcfg, mesh=None)
    jp, jo = jTS.materialize_state(jcfg, jtcfg, jart, jax.random.PRNGKey(0))
    params = {k: np.asarray(v) for k, v in jp.items()}
    batch = next(JPipe(jcfg, 2, 16, seed=0))
    tbatch = next(TPipe(tcfg, 2, 16, seed=0))
    assert batch["enc_embeds"].dtype == tbatch["enc_embeds"].dtype \
        == np.float32
    for k in batch:
        np.testing.assert_array_equal(tbatch[k], batch[k])
    with pytest.raises(TypeError, match="carry"):
        jart.step_fn(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()},
                     jnp.int32(0))
    jb16 = {k: jnp.asarray(v) for k, v in batch.items()}
    jb16["enc_embeds"] = jb16["enc_embeds"].astype(jnp.bfloat16)
    jp1, jo1, jmet = jart.step_fn(jp, jo, jb16, jnp.int32(0))

    tart = tTS.make_train_step(tcfg, ttcfg, device="cpu")
    runs = []
    bf16 = tM.params_from_numpy({"f": np.asarray(jb16["enc_embeds"])},
                                "cpu")["f"]
    for frames in (tbatch["enc_embeds"], bf16):
        _, to = tTS.materialize_state(tcfg, ttcfg, tart,
                                      torch.Generator().manual_seed(0))
        runs.append(tart.step_fn(tM.params_from_numpy(params, "cpu"), to,
                                 {**tbatch, "enc_embeds": frames}, 0))
    (tp1, to1, tmet), (tp16, _, tmet16) = runs
    assert float(tmet["loss"]) == float(tmet16["loss"])
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=2e-2)
    for k in jp1:
        assert torch.equal(tp1[k], tp16[k]), k
        jm = np.asarray(jo1["momentum"][k])
        tm = to1["momentum"][k].float().numpy().reshape(jm.shape)
        same = (np.sign(jm) == np.sign(tm)).reshape(jp1[k].shape)
        assert 1 - same.mean() < 0.02, k
        got = tp1[k].float().numpy()
        want = np.asarray(jnp.asarray(jp1[k]).astype(jnp.float32))
        np.testing.assert_array_equal(got[same], want[same], err_msg=k)


def test_module_entry_point_runs(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train"] + BASE
        + ["--steps", "2", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "step     1" in out.stdout and out.stdout.rstrip().endswith(
        "done.")
    assert tckpt.latest_step_dir(str(tmp_path / "ck")).endswith(
        "step_00000001")
