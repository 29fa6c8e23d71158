"""Build and load the CUDA kernels in ``csrc/`` (plain C interface + ctypes).

At the first launch on a CUDA tensor, :func:`library` compiles every
``csrc/*.cu`` with its own ``nvcc`` process, all started together, into
``build/repro_torch_kernels/`` at the root of the checkout (a directory
that ``.gitignore`` lists), and loads each shared library with ``ctypes``.
Each library's file name carries a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

A failed build raises ``RuntimeError`` with the compiler's output; there is
no fallback. Nothing happens at import, so the package imports on a
machine with neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: ``-ftz=true``: every float32 operation and comparison reads a subnormal
#: operand as a zero of its sign and flushes a subnormal result to one, as
#: XLA does on the CPU (and a TPU, which has no subnormals); without it the
#: kernels would vote the sign of a subnormal momentum where the reference
#: abstains or votes +1
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-ftz=true", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
#: C signatures of the entry points, by source file
SIGNATURES = {
    "signum_update": {
        # g float32 / bf16 with float32 momentum, then with bf16 momentum
        **{f"momentum_sign_pack_{g}{m}": (_P, _P, _P, _P, _I64, _F, _F, _P)
           for g in ("f32", "bf16") for m in ("", "_mbf16")},
        "apply_vote_f32": (_P, _P, _P, _I64, _F, _F, _P),
        "apply_vote_bf16": (_P, _P, _P, _I64, _F, _F, _P),
        "apply_ternary_vote_f32": (_P, _P, _P, _I64, _F, _F, _P),
        "apply_ternary_vote_bf16": (_P, _P, _P, _I64, _F, _F, _P),
    },
    "vote": {
        "majority_packed": (_P, _P, _I, _I64, _P),
        "ternary_majority": (_P, _P, _I, _I64, _P),
        "ternary_majority_plus_one": (_P, _P, _I, _I64, _P),
    },
    "bitpack": {
        # x, out, rows, n, the row stride of x in elements, stream
        **{f"bitpack_{t}": (_P, _P, _I64, _I64, _I64, _P)
           for t in ("f32", "bf16", "i8")},
        **{f"bitunpack_{t}": (_P, _P, _I64, _P)
           for t in ("f32", "bf16", "i8")},
    },
    "fused_vote": {
        f"fused_majority_{t}": (_P, _P, _I, _I64, _P)
        for t in ("f32", "bf16", "i8")
    },
    "ternary_pack": {
        **{f"ternary_pack_{t}": (_P, _P, _I64, _I64, _P)
           for t in ("f32", "bf16", "i8")},
        **{f"ternary_unpack_{t}": (_P, _P, _I64, _P)
           for t in ("f32", "bf16", "i8")},
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas resource lines (registers, spills) of the last build, by source
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda; "
            "the CUDA kernels cannot be built")
    return str(path)


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _build_all(names) -> None:
    """Compile the missing libraries, one nvcc per source, in parallel."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(name))
    if failures:
        raise RuntimeError("nvcc failed to build " + "\n".join(failures))


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``; builds all
    sources on the first call."""
    if name not in _LIBS:
        _build_all(SIGNATURES)
        for lib_name, fns in SIGNATURES.items():
            if lib_name in _LIBS:
                continue
            lib = ctypes.CDLL(str(_target(lib_name)))
            for fn, argtypes in fns.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[lib_name] = lib
    return _LIBS[name]


def check(status: int, fn: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: cudaError "
                           f"{status}")
