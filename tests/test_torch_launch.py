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
* ``--serve-dir`` raises, naming its ROADMAP.md item, and an unknown arch
  the registry's ``KeyError``; every family trains through the launcher;
  ``python -m repro_torch.launch.train`` runs.
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

from repro.launch import train as jlaunch  # noqa: E402
from repro.obs import recorder as jrec  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.obs import recorder as trec  # noqa: E402

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
    """--serve-dir still names its ROADMAP.md item; every arch of the
    reference has a config now, so only an unknown one raises (the
    registry's KeyError, as in the reference); the three archs of the
    SSM, hybrid and encoder-decoder families train through the launcher
    (the reduced config, two steps, finite losses)."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        tlaunch.main(BASE + ["--steps", "1", "--serve-dir", str(tmp_path)])
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
