"""Atomic, async checkpointing with elastic refit (``repro.checkpoint``),
on the reference's on-disk layout, so either package restores what the
other saved:

    <dir>/step_<k>/
        meta.json          (step, the dtype map, caller metadata)
        arrays.npz         (flat params/... and opt/... arrays)
        data_state.json    (pipeline cursor)
    <dir>/LATEST           (atomic pointer file)

* atomicity — a save writes ``step_<k>.tmp`` and renames it; the LATEST
  pointer is replaced with ``os.replace``;
* dtypes — npz has no bfloat16, so a bf16 tensor is stored as its uint16
  bits and ``meta.json``'s ``"dtypes"`` names it ``"bfloat16"``, as the
  reference records its ml_dtypes arrays; a Python int (the optimizer's
  step ``"count"``) is stored as int32, the reference's count dtype;
* elastic refit — per-worker state with a leading voter axis (Mode A
  momentum, the EF residual, the weighted vote's (M,) flip-rate EMA) is
  truncated or zero-padded along axis 0 when the voter count changes
  (:func:`refit_leading_axis`); joiners start at zero.

:func:`restore` gives torch tensors on `device` (``"cuda"`` unless told
otherwise), 0-d ones for scalars. :class:`AsyncCheckpointer` copies the
tensors to the host at once and writes on a worker thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _to_host(v: Any) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf -> (numpy array npz stores, the true dtype's name if the
    array holds another dtype's bits)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    if isinstance(v, (bool, np.bool_)):
        return np.asarray(v), None
    if isinstance(v, int):
        return np.asarray(v, np.int32), None
    return np.asarray(v), None


def _from_host(a: np.ndarray, dtype: Optional[str],
               device: torch.device) -> torch.Tensor:
    if dtype is None:
        return torch.from_numpy(np.array(a)).to(device)
    if dtype != "bfloat16":
        raise NotImplementedError(
            f"checkpoint dtype {dtype!r}: the port restores bfloat16 and "
            "numpy's own dtypes")
    bits = torch.from_numpy(np.array(a).view(np.int16))
    return bits.view(torch.bfloat16).to(device)


def save(ckpt_dir: str, step: int, params: Any, opt_state: Any,
         data_state: Optional[Dict] = None, meta: Optional[Dict] = None
         ) -> str:
    """Blocking atomic save of nested dicts of tensors (or numpy arrays,
    or Python scalars). Returns the final step directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat, dtypes = {}, {}
    for prefix, tree in (("params/", params), ("opt/", opt_state)):
        for k, v in _flatten(tree).items():
            flat[prefix + k], dt = _to_host(v)
            if dt is not None:
                dtypes[prefix + k] = dt
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "dtypes": dtypes, **(meta or {})}, f)
    with open(os.path.join(tmp, "data_state.json"), "w") as f:
        json.dump(data_state or {}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step_dir(ckpt_dir: str) -> Optional[str]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(ckpt_dir, name)
    return path if os.path.isdir(path) else None


def refit_leading_axis(saved, want_shape: Tuple[int, ...]):
    """Elastic reshard of per-worker state (a tensor or a numpy array):
    truncate or zero-pad axis 0 to `want_shape`; any other change of shape
    raises. The Scenario Lab applies the same rule at its elastic
    events."""
    want_shape = tuple(want_shape)
    if tuple(saved.shape) == want_shape:
        return saved
    if tuple(saved.shape[1:]) == want_shape[1:]:
        n_want, n_have = want_shape[0], saved.shape[0]
        if n_want <= n_have:
            return saved[:n_want]
        pad_shape = (n_want - n_have,) + tuple(saved.shape[1:])
        if isinstance(saved, torch.Tensor):
            return torch.cat([saved, saved.new_zeros(pad_shape)])
        return np.concatenate([saved, np.zeros(pad_shape, saved.dtype)])
    raise ValueError(
        f"cannot reshard saved {tuple(saved.shape)} -> wanted {want_shape}")


def refit_tree_leading_axis(saved_tree: Any, want_shapes: Any) -> Any:
    """:func:`refit_leading_axis` over a nested dict of per-worker state;
    `want_shapes` mirrors its structure with target shapes at the
    leaves."""
    if isinstance(saved_tree, dict):
        missing = set(saved_tree) ^ set(want_shapes)
        if missing:
            raise ValueError(
                f"refit tree structure mismatch on keys {sorted(missing)}")
        return {k: refit_tree_leading_axis(v, want_shapes[k])
                for k, v in saved_tree.items()}
    if not hasattr(saved_tree, "shape"):
        saved_tree = np.asarray(saved_tree)
    return refit_leading_axis(saved_tree, tuple(want_shapes))


def _shape_of(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, (bool, int, float)):   # a Python scalar (a count)
        return ()
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def restore(ckpt_dir: str, like_params: Any = None, like_opt: Any = None,
            device: DeviceLike = None) -> Tuple[Any, Any, Dict, Dict]:
    """(params, opt_state, data_state, meta) of the LATEST step, the arrays
    as tensors on `device`. `like_*`: trees whose leaves have a ``.shape``
    (tensors, arrays) or are shape tuples: a saved array whose leading axis
    differs from its like leaf's is refit (:func:`refit_leading_axis`)."""
    dev = resolve_device(device)
    path = latest_step_dir(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as z:
        host = {k: z[k] for k in z.files}

    def tree(prefix: str, like: Any) -> Any:
        flat = {k[len(prefix):]: v for k, v in host.items()
                if k.startswith(prefix)}
        if like is not None:
            for key, leaf in _flatten(like).items():
                if key in flat:
                    flat[key] = refit_leading_axis(flat[key],
                                                   _shape_of(leaf))
        return _unflatten({k: _from_host(v, dtypes.get(prefix + k), dev)
                           for k, v in flat.items()})

    params = tree("params/", like_params)
    opt = tree("opt/", like_opt)
    with open(os.path.join(path, "data_state.json")) as f:
        data_state = json.load(f)
    return params, opt, data_state, meta


class AsyncCheckpointer:
    """Copy to the host at once, write on a daemon thread; at most one save
    outstanding (a newer save waits for the previous one, keeping the
    LATEST pointer monotonic)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, params: Any, opt_state: Any,
             data_state: Optional[Dict] = None,
             meta: Optional[Dict] = None) -> None:
        self.wait()

        def snapshot(t):
            # the host copy happens NOW, so training may go on mutating
            return {k: snapshot(v) for k, v in t.items()} \
                if isinstance(t, dict) else (
                    t.detach().to("cpu", copy=True)
                    if isinstance(t, torch.Tensor) else t)
        params_h, opt_h = snapshot(params), snapshot(opt_state)

        def work():
            try:
                save(self.ckpt_dir, step, params_h, opt_h, data_state, meta)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


__all__ = ["AsyncCheckpointer", "latest_step_dir", "refit_leading_axis",
           "refit_tree_leading_axis", "restore", "save"]
