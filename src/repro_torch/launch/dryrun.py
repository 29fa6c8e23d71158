"""Dry run: every (arch x shape x mesh) cell's step on the "meta" device
(``repro.launch.dryrun``).

For each cell this initialises a ``torch.distributed`` world of 256 or
512 fake ranks (PyTorch's ``fake`` backend: no collective moves data),
builds the production mesh (16, 16) or (2, 16, 16) and one rank's
parameter blocks and state as "meta" tensors (shapes, no memory), runs the
step once (a train cell: one step of the cell's batch through
``train_step.abstract_state``; a prefill cell: ``make_prefill_sharded``; a
decode cell: ``make_decode_step``) and records what that rank would do:

  * ``flops_per_chip``: the FLOPs ``torch.utils.flop_counter.
    FlopCounterMode`` would count over the step (its formulas, in the
    meter's one dispatch mode), every microbatch, layer and recompute;
  * ``hbm_bytes_per_chip``: the bytes every PyTorch operation reads and
    writes (views excluded), plus each kernel's own (``kernels.ops``
    under ``traffic``, its PyTorch operations not counted). Eager PyTorch
    does not fuse, so this is the step's traffic before any cache;
  * ``memory``: the reference's five keys, from the storages alive on the
    step's device during the step: ``argument_bytes`` the rank's
    parameters, state and batch block, ``output_bytes`` and
    ``alias_bytes`` what the step returns and how much of it is updated in
    place, ``temp_bytes`` the peak above them, ``peak_bytes_per_chip``;
    ``fits`` holds the peak against one H100's memory;
  * ``collectives``: ``launch.hlo_stats.summarize`` of every collective
    the step issues (recorded by ``ProcessMesh._run``, not run), with
    ``wire_bytes``, the bytes this rank hands the vote axes and the model
    group (``ProcessMesh.stats`` / ``model_stats``);
  * ``launches``: ``kernels.ops.launch_counts()`` of the step;
  * the config fingerprint (params, active params, mode, fsdp,
    microbatches, remat, the resolved vote strategy), ``trace_s``, the
    rank and its coordinates, ``n_chips``.

By symmetry one rank stands for all (``--rank`` picks it, default 0). No
card is needed: the numbers are counted on "meta", not measured.

Usage:
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all                  # every cell
  python -m repro_torch.launch.dryrun --all --multi-pod      # 512 ranks
  python -m repro_torch.launch.dryrun --arch X --shape Y --opt sgdm
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Iterator, Mapping, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import (SHAPES, ShapeCell, VoteStrategy,
                                      get_config, list_archs)
from repro_torch.configs.presets import MODE_B_ARCHS, default_train_config
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import make_production_mesh, pod_stride
from repro_torch.models import model as M
from repro_torch.train import serve_step as SS, train_step as TS

#: one H100 80GB's device memory, as sold (chip_smoke.py phase 20c holds it
#: against the card's own ``total_memory``)
H100_MEMORY_BYTES = 80 * 10 ** 9

_IMPLICIT = torch._C.DispatchKey.CompositeImplicitAutograd

#: in-place operations that overwrite their first argument without
#: reading it
_OVERWRITE = ("copy_", "zero_", "fill_")


def skip_reason(arch: str, shape: str) -> Optional[str]:
    cfg = get_config(arch)
    for name, reason in cfg.skip_shapes:
        if name == shape:
            return reason
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: list) -> list:
    """The tensors of `x` (a tensor, or lists and tuples of them and
    other values), appended to `out`."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    return out


class StepMeter(TorchDispatchMode):
    """One dispatch mode over a step: counts its FLOPs as
    ``FlopCounterMode`` does (the same decompositions, the same formulas
    of ``torch.utils.flop_counter.flop_registry``), the bytes every
    PyTorch operation reads and writes (views and the operations inside a
    kernel wrapper excluded; an operation that overwrites its first
    argument does not read it) and the storages alive on `device`, from
    the arguments given to :meth:`argument` on."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = torch.device(device)
        self.flops = 0
        self.bytes = 0
        self.traffic: Optional[ops.Traffic] = None
        self.live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak = 0
        self.arguments: Dict[int, int] = {}
        self._refs: Dict[int, Any] = {}
        #: {operator: whether it has a CompositeImplicitAutograd kernel}
        self._decomposes: Dict[Any, bool] = {}

    def _track(self, t: torch.Tensor, weight: Optional[int] = None) -> int:
        if t.device != self.device:
            return -1
        st = t.untyped_storage()
        key = st._cdata
        if key not in self.live:
            n = st.nbytes() if weight is None else weight
            self.live[key] = n
            self.live_bytes += n
            if self.live_bytes > self.peak:
                self.peak = self.live_bytes
            self._refs[key] = weakref.ref(st, functools.partial(self._free,
                                                                key))
        return key

    def _free(self, key: int, _ref=None) -> None:
        self.live_bytes -= self.live.pop(key, 0)
        self._refs.pop(key, None)

    def argument(self, t: torch.Tensor, weight: Optional[int] = None
                 ) -> None:
        """Count `t`'s storage as an argument of the step (weighing
        `weight` bytes when given: a batch's global tensor whose rows the
        rank holds a block of)."""
        key = self._track(t, weight)
        if key >= 0:
            self.arguments[key] = self.live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        can = self._decomposes.get(func)
        if can is None:
            can = self._decomposes[func] = (
                func is not torch.ops.prim.device.default
                and (_IMPLICIT in func.py_kernels
                     or torch._C._dispatch_has_kernel_for_dispatch_key(
                         func.name(), _IMPLICIT)))
        if can:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = _tensors(out, [])
        if not func.is_view and (self.traffic is None
                                 or not self.traffic.depth):
            name = func.__name__.split(".")[0]
            if not name.startswith(("empty", "new_empty")):
                ins = _tensors(list(args) + list(kwargs.values()), [])
                if name in _OVERWRITE:
                    ins = ins[1:]
                self.bytes += (sum(_nbytes(a) for a in ins)
                               + sum(_nbytes(o) for o in outs))
        for o in outs:
            self._track(o)
        return out


def measure(fn: Callable[[], Any], arguments, device,
            weights: Optional[Mapping[int, int]] = None,
            mesh=None) -> Dict[str, Any]:
    """Run `fn()` once on `device` and count it (see the module doc):
    `arguments` are the tensors the step is handed (the storages it starts
    with; `weights` {id(tensor): bytes} weighs a batch's block), `mesh` the
    ``ProcessMesh`` whose wire statistics and collectives it reads. Returns
    the record's counted keys."""
    weights = weights or {}
    meter = StepMeter(device)
    if mesh is not None:
        mesh.reset_stats()
    ops.reset_launch_counts()
    stride = pod_stride(mesh) if mesh is not None else 0
    t0 = time.perf_counter()
    with hlo_stats.record_collectives(stride) as colls, \
            ops.traffic() as traffic, meter:
        meter.traffic = traffic
        for t in tree_leaves(arguments):
            if isinstance(t, torch.Tensor):
                meter.argument(t, weights.get(id(t)))
        result = fn()
        outs = {meter._track(t) for t in tree_leaves(result)
                if isinstance(t, torch.Tensor)}
    trace_s = time.perf_counter() - t0
    outs.discard(-1)
    arg = sum(meter.arguments.values())
    out_bytes = sum(meter.live[k] for k in outs)
    alias = sum(meter.arguments[k] for k in outs if k in meter.arguments)
    new = out_bytes - alias
    peak = meter.peak
    rec = {
        "trace_s": trace_s,
        "flops_per_chip": float(meter.flops),
        "hbm_bytes_per_chip": float(meter.bytes + traffic.bytes),
        "memory": {
            "argument_bytes": arg,
            "output_bytes": out_bytes,
            "temp_bytes": peak - arg - new,
            "alias_bytes": alias,
            "peak_bytes_per_chip": peak,
        },
        "collectives": hlo_stats.summarize(colls),
        "launches": ops.launch_counts(),
        "fits": peak <= H100_MEMORY_BYTES,
    }
    if mesh is not None:
        rec["wire_bytes"] = {"vote": mesh.stats.bytes,
                             "model": mesh.model_stats.bytes}
    return rec


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0) -> Iterator[None]:
    """A ``torch.distributed`` world of `world` ranks on PyTorch's ``fake``
    backend, this process rank `rank`; the port's cached process groups
    are dropped on entry and exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed import mesh as pm
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    pm._GROUPS.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        pm._GROUPS.clear()
        dist.destroy_process_group()


def _blocks(tree: Mapping[str, torch.Tensor], specs: Mapping, mesh
            ) -> Dict[str, torch.Tensor]:
    """The rank's block of each leaf of `tree` under `specs`, each its own
    "meta" storage."""
    return {k: v.clone() for k, v in shd.shard_tree(
        tree, specs, coords=mesh.coords, sizes=mesh.axis_sizes).items()}


def _batch_weights(batch: Mapping[str, torch.Tensor], mesh
                   ) -> Dict[int, int]:
    """{id(leaf): bytes of the rank's rows} of a global batch whose rows
    split over the vote axes (the reference's batch spec)."""
    out = {}
    for v in batch.values():
        entry = SS.batch_entry(v.shape[0], mesh.axis_sizes)
        (_, count), = shd.spec_block((entry,), mesh.coords, mesh.axis_sizes)
        out[id(v)] = _nbytes(v) // count
    return out


def train_record(cfg, tcfg, *, mesh=None, n_voters: int = 1
                 ) -> Dict[str, Any]:
    """One train step of `cfg` under `tcfg` on "meta" (`n_voters` stacked,
    or this rank's voter of `mesh`), counted by :func:`measure`, with the
    resolved ``vote_strategy`` ("per_bucket" for a plan whose codec groups
    resolve differently)."""
    art = TS.make_train_step(cfg, tcfg, n_voters, device="meta", mesh=mesh)
    params, state = TS.abstract_state(cfg, tcfg, art, mesh)
    cell = ShapeCell("dryrun", tcfg.seq_len, tcfg.global_batch, "train")
    batch = M.input_specs(cfg, cell)["batch"]
    rec = {"vote_strategy": (art.vote_strategy.value
                             if art.vote_strategy is not None
                             else "per_bucket")}
    rec.update(measure(lambda: art.step_fn(params, state, batch, 0),
                       (params, state, batch), "meta",
                       None if mesh is None else _batch_weights(batch, mesh),
                       mesh))
    return rec


def analytic_train_flops(cfg, global_batch: int, seq: int,
                         remat: bool = True) -> float:
    """The reference's analytic FLOPs of one train step
    (``benchmarks/roofline.py``: matmuls over the active parameters and
    the attention's products, the forward times 4 with remat, 3 without),
    for the ratio the dry run's ``flops_per_chip`` is read against."""
    tokens = global_batch * seq
    fwd = 2.0 * cfg.active_param_count() * tokens
    hhd = cfg.num_heads * cfg.resolved_head_dim
    layers = (0 if cfg.family.value == "ssm" else cfg.num_shared_attn_calls
              if cfg.family.value == "hybrid" else cfg.num_layers)
    if hhd:
        for i in range(layers):
            s_eff = seq
            if cfg.sliding_window and cfg.layer_is_local(i):
                s_eff = min(seq, cfg.sliding_window)
            fwd += 2.0 * global_batch * seq * s_eff * hhd
    return fwd * (4.0 if remat else 3.0)


def fingerprint(arch: str, shape: str, *, opt_kind: str = "signum_vote",
                vote_strategy: Optional[str] = None) -> Dict[str, Any]:
    """A cell's config keys, computed without running it: ``params``,
    ``active_params`` and, for a train cell, ``mode``, ``fsdp``,
    ``microbatches`` and ``remat`` (a serve cell: ``fsdp``)."""
    cfg, cell = get_config(arch), SHAPES[shape]
    rec: Dict[str, Any] = {"params": cfg.param_count(),
                           "active_params": cfg.active_param_count()}
    if cell.kind == "train":
        vs = VoteStrategy(vote_strategy) if vote_strategy else None
        tcfg = default_train_config(arch, cell, kind=opt_kind,
                                    vote_strategy=vs)
        rec.update(mode=tcfg.optimizer.momentum_mode.value, fsdp=tcfg.fsdp,
                   microbatches=tcfg.microbatches, remat=tcfg.remat)
    else:
        rec["fsdp"] = arch in MODE_B_ARCHS
    return rec


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             opt_kind: str = "signum_vote",
             vote_strategy: Optional[str] = None,
             rank: int = 0) -> Dict[str, Any]:
    """Build and run one cell's step on "meta" as rank `rank` of a fake
    world; returns the stats record."""
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "opt": opt_kind, "status": "ok",
    }
    reason = skip_reason(arch, shape)
    if reason:
        record.update(status="skip", reason=reason)
        return record
    cfg, cell = get_config(arch), SHAPES[shape]
    record.update(fingerprint(arch, shape, opt_kind=opt_kind,
                              vote_strategy=vote_strategy))
    n_chips = 512 if multi_pod else 256
    with fake_world(n_chips, rank):
        mesh = make_production_mesh(multi_pod=multi_pod)
        if cell.kind == "train":
            vs = VoteStrategy(vote_strategy) if vote_strategy else None
            tcfg = default_train_config(arch, cell, kind=opt_kind,
                                        vote_strategy=vs)
            stats = train_record(cfg, tcfg, mesh=mesh)
        else:
            fsdp = record["fsdp"]
            inputs = SS.abstract_serve_inputs(cfg, cell, mesh, fsdp=fsdp)
            params = _blocks(inputs.pop("params"), inputs["param_specs"],
                             mesh)
            if cell.kind == "prefill":
                fn = SS.make_prefill_sharded(
                    cfg, mesh, fsdp=fsdp, global_batch=cell.global_batch)
                batch = inputs["batch"]
                stats = measure(lambda: fn(params, batch), (params, batch),
                                "meta", _batch_weights(batch, mesh), mesh)
            else:
                fn = SS.make_decode_step(cfg, mesh=mesh,
                                         max_len=cell.seq_len, fsdp=fsdp)
                cache = _blocks(inputs.pop("cache"), inputs["cache_specs"],
                                mesh)
                tokens, pos = inputs["tokens"], inputs["pos"]
                stats = measure(lambda: fn(params, tokens, cache, pos),
                                (params, tokens, cache, pos), "meta",
                                _batch_weights({"tokens": tokens}, mesh),
                                mesh)
                del cache
            del params
        record.update(stats)
        record["rank"] = rank
        record["coords"] = dict(mesh.coords)
        record["n_chips"] = n_chips
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt", default="signum_vote")
    ap.add_argument("--vote-strategy", default=None)
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank a record describes (one stands for all)")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in list_archs() for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    with open(args.out, "a") as f:
        for arch, shape in cells:
            print(f"=== {arch} x {shape} ({mesh_name}) ===", flush=True)
            try:
                rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                               opt_kind=args.opt,
                               vote_strategy=args.vote_strategy,
                               rank=args.rank)
            except Exception as e:  # record failures; the sweep goes on
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "opt": args.opt, "status": "error",
                       "error": f"{type(e).__name__}: {e}"}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            if rec["status"] == "ok":
                mem = rec["memory"]["peak_bytes_per_chip"] / 2 ** 30
                print(f"  ok: {rec['flops_per_chip']:.3e} flops/chip, "
                      f"peak {mem:.2f} GiB/chip (fits {rec['fits']}), "
                      f"{rec['collectives']['n_collectives']} collectives, "
                      f"trace {rec['trace_s']:.1f}s", flush=True)
            else:
                print(f"  {rec['status']}: "
                      f"{rec.get('reason', rec.get('error'))}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
