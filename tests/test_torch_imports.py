"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``) imports ``jax``, ``jaxlib`` or the JAX package
``repro``, and the package imports without ``triton`` and without
``nvcc`` (the CUDA kernels are built at their first launch, never at
import)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + [
    "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]


def test_port_has_the_slice_modules():
    names = {f for f in FILES}
    for mod in ("configs/base.py", "configs/glm4_9b.py",
                "core/sign_compress.py", "core/signum.py", "kernels/ref.py",
                "kernels/build.py", "kernels/ops.py", "data/pipeline.py",
                "models/layers.py", "models/transformer.py",
                "models/model.py", "train/train_step.py",
                "core/codecs/__init__.py", "core/codecs/base.py",
                "core/codecs/sign1bit.py", "core/codecs/ef_sign.py",
                "core/codecs/ternary.py", "core/codecs/weighted.py",
                "core/vote_engine.py", "core/vote_api.py",
                "core/vote_plan.py", "core/prng.py", "core/byzantine.py",
                "core/attacks/__init__.py", "core/attacks/schedule.py",
                "core/attacks/engine.py", "core/attacks/breaking_point.py",
                "core/population.py", "core/theory.py",
                "distributed/fault_tolerance.py", "distributed/mesh.py",
                "distributed/sharding.py", "launch/__init__.py",
                "launch/train.py",
                "checkpoint/checkpoint.py", "obs/__init__.py",
                "obs/recorder.py", "sim/__init__.py", "sim/scenario.py",
                "sim/virtual_mesh.py", "sim/runner.py"):
        assert f"src/repro_torch/{mod}" in names
    assert sorted(p.name for p in (PORT / "kernels" / "csrc").glob("*.cu")) \
        == ["bitpack.cu", "byzantine.cu", "fused_vote.cu",
            "signum_update.cu", "ternary_pack.cu", "vote.cu"]


def test_every_csrc_source_has_signatures():
    """build.SIGNATURES names one library per source, so the first launch
    builds every kernel file and loads every entry point."""
    from repro_torch.kernels import build
    assert sorted(f"{name}.cu" for name in build.SIGNATURES) == sorted(
        p.name for p in (PORT / "kernels" / "csrc").glob("*.cu"))


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_or_reference_imports(rel):
    bad = sorted(set(_imported_roots(ROOT / rel)) & FORBIDDEN)
    assert not bad, f"{rel} imports {bad}"


_PROBE = """
import importlib, pkgutil, shutil, sys
sys.modules["triton"] = None          # importing triton now fails
assert shutil.which("nvcc") is None
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import numpy as np
from repro_torch.configs.base import VoteStrategy
from repro_torch.core import vote_api as va
for use_kernels in (True, False):
    out = va.VirtualBackend(use_kernels=use_kernels, device="cpu").execute(
        va.VoteRequest(payload=-np.ones((3, 40)), form="stacked",
                       strategy=VoteStrategy.ALLGATHER_1BIT))
    assert out.votes.tolist() == [-1] * 40
out = va.VirtualBackend(device="cpu").execute(va.VoteRequest(
    payload=np.zeros((3, 40)), form="stacked", codec="ternary2bit",
    strategy=VoteStrategy.ALLGATHER_1BIT))
assert out.votes.tolist() == [0] * 40
from repro_torch.kernels import build
assert build._LIBS == {}, build._LIBS
assert "jax" not in sys.modules and "repro" not in sys.modules
try:
    build.nvcc_path()
except RuntimeError as e:
    assert "nvcc" in str(e)
else:
    raise AssertionError("nvcc_path found an nvcc")
print("lazy ok")
"""


def test_package_imports_without_triton_or_nvcc(tmp_path):
    env = {**os.environ, "PATH": os.path.dirname(sys.executable),
           "CUDA_HOME": str(tmp_path), "CUDA_PATH": str(tmp_path),
           "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "lazy ok" in out.stdout
