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
  (:func:`refit_leading_axis`); joiners start at zero;
* a mesh run (``mesh=`` and the step's ``art=``, its
  ``train.train_step.StepArtifacts``) — arrays are saved unsharded, as
  the reference gathers each sharded array to the host: every rank's
  blocks are joined over the mesh (``distributed.sharding.join_shards``:
  ``"model"`` dims, and ``"data"`` dims of fsdp leaves), the per-worker
  state stacked in replica order, and the mesh's first rank writes them.
  The files equal, array for array, what the stacked run of the same M
  writes for the same state. ``restore(..., mesh=, art=)`` refits the
  per-worker rows to the mesh's voters and cuts each rank's block
  (``distributed.sharding.shard_tree``), so a checkpoint restores under
  any mesh and stacked.

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
from repro_torch.distributed import sharding as shd

#: the optimizer-state keys with one row per voter when stacked (Mode A's
#: momentum, ``StepArtifacts.per_worker``; the EF residual): a mesh rank
#: holds its voter's row, without the leading axis
_VOTER_ROWS = ("momentum", "error")

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


def _voter_rows(key: str, art) -> bool:
    """Whether the flat opt-state `key` ("momentum/<leaf>") is per-voter
    state a mesh rank holds one row of."""
    group = key.split("/", 1)[0]
    return group in _VOTER_ROWS and (group != "momentum" or art.per_worker)


def _spec(key: str, art):
    return art.param_specs.get(key.split("/")[-1])


def _gather_to_writer(obj, mesh) -> Optional[list]:
    """`obj` of every rank of `mesh` on the mesh's first rank, in rank
    order (row-major over pod, data, model), and None on the others:
    gathered over each pod's (data, model) ranks to the pod's first, then
    over those to the first pod's."""
    import torch.distributed as dist
    ranks, group = mesh.group_of(("data", "model"))
    every = [obj] if group is None else (
        [None] * len(ranks) if mesh.rank == ranks[0] else None)
    if group is not None:
        dist.gather_object(obj, every, dst=ranks[0], group=group)
    if mesh.pod == 1 or every is None:
        return every
    ranks, group = mesh.group_of(("pod",))
    pods = [None] * len(ranks) if mesh.rank == ranks[0] else None
    dist.gather_object(every, pods, dst=ranks[0], group=group)
    return None if pods is None else [o for pod in pods for o in pod]


def _wait_for_writer(mesh) -> None:
    """Return on every rank of `mesh` once its first rank has got here: a
    barrier over each pod's (data, model) ranks, then over the pods."""
    import torch.distributed as dist
    for names in (("data", "model"), ("pod",)):
        group = mesh.group_of(names)[1]
        if group is not None:
            dist.barrier(group=group)


def join_state(params: Any, opt_state: Any, mesh, art
               ) -> Tuple[Optional[Any], Optional[Any]]:
    """Every rank of `mesh`'s blocks of (params, opt_state) joined, on the
    mesh's first rank, into the stacked run's unsharded arrays on the
    host: each leaf over the mesh by its spec (``art.param_specs`` and
    ``art.mesh_sizes``), the per-voter state (:data:`_VOTER_ROWS`) over
    each voter's model ranks and stacked in replica order; the rest (the
    count, the weighted vote's EMA) is that rank's own. A collective of
    the mesh; the other ranks get (None, None)."""
    def host(t):
        return t.detach().to("cpu", copy=True) if isinstance(
            t, torch.Tensor) else t
    flat_p = {k: host(v) for k, v in _flatten(params).items()}
    flat_o = {k: host(v) for k, v in _flatten(opt_state).items()}
    every = _gather_to_writer((flat_p, flat_o), mesh)
    if every is None:
        return None, None
    sizes, m = art.mesh_sizes, mesh.model

    def join(trees, key, spec, over):
        return shd.join_shards([{key: t[key]} for t in trees], {key: spec},
                               sizes=over)[key]
    out_p = {k: join([e[0] for e in every], k, _spec(k, art), sizes)
             if _spec(k, art) is not None else v for k, v in flat_p.items()}
    out_o = {}
    for k, v in flat_o.items():
        spec = _spec(k, art)
        trees = [e[1] for e in every]
        if spec is None or not isinstance(v, torch.Tensor):
            out_o[k] = v
        elif _voter_rows(k, art):
            out_o[k] = torch.stack([
                join(trees[r * m:(r + 1) * m], k, spec, {"model": m})
                for r in range(mesh.size)])
        else:
            out_o[k] = join(trees, k, spec, sizes)
    return _unflatten(out_p), _unflatten(out_o)


def save(ckpt_dir: str, step: int, params: Any, opt_state: Any,
         data_state: Optional[Dict] = None, meta: Optional[Dict] = None,
         *, mesh=None, art=None) -> str:
    """Blocking atomic save of nested dicts of tensors (or numpy arrays,
    or Python scalars). Returns the final step directory. Over `mesh`
    (every rank calls it, with the step's `art`) the blocks are joined
    (:func:`join_state`), the mesh's first rank writes and every rank
    returns once the files are in place."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if mesh is not None:
        params, opt_state = join_state(params, opt_state, mesh, art)
        if params is not None:
            save(ckpt_dir, step, params, opt_state, data_state, meta)
        _wait_for_writer(mesh)
        return final
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


def _mesh_block(key: str, a: np.ndarray, mesh, art) -> np.ndarray:
    """The block of the saved unsharded array `a` (flat opt-state or
    param `key`) a rank of `mesh` holds: its voter's row of per-voter
    state (refit to the mesh's voters first), each leaf cut by its
    spec."""
    group = key.split("/", 1)[0]
    if group == "codec" and a.ndim == 1:   # (M,) per voter, whole
        return refit_leading_axis(a, (mesh.size,))
    spec = _spec(key, art)
    if spec is None:
        return a
    if _voter_rows(key, art):
        a = refit_leading_axis(a, (mesh.size,) + a.shape[1:])[
            mesh.replica_index()]
    return np.ascontiguousarray(shd.shard_leaf(a, spec, mesh.coords,
                                               art.mesh_sizes))


def restore(ckpt_dir: str, like_params: Any = None, like_opt: Any = None,
            device: DeviceLike = None, *, mesh=None, art=None
            ) -> Tuple[Any, Any, Dict, Dict]:
    """(params, opt_state, data_state, meta) of the LATEST step, the arrays
    as tensors on `device`. `like_*`: trees whose leaves have a ``.shape``
    (tensors, arrays) or are shape tuples: a saved array whose leading axis
    differs from its like leaf's is refit (:func:`refit_leading_axis`).
    Over `mesh` (with the step's `art`; `like_*` unused) each array is the
    rank's block (:func:`_mesh_block`)."""
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
        if mesh is not None:
            flat = {k: _mesh_block(k, v, mesh, art) for k, v in flat.items()}
        elif like is not None:
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
             meta: Optional[Dict] = None, *, mesh=None, art=None) -> None:
        """Over `mesh` (every rank calls it, with the step's `art`) the
        blocks are joined now (:func:`join_state`, a collective) and the
        mesh's first rank writes them on its thread; the others write
        nothing (wait on the writer before restoring elsewhere)."""
        self.wait()
        if mesh is not None:
            params, opt_state = join_state(params, opt_state, mesh, art)
            if params is None:
                return

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


__all__ = ["AsyncCheckpointer", "join_state", "latest_step_dir",
           "refit_leading_axis", "refit_tree_leading_axis", "restore",
           "save"]
