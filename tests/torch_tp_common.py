"""Shared by the port's tests of the model axis (not collected itself): a
world of many ranks inside one test process, and the build checks of the
converted refusal tests.

:func:`fake_world` initialises ``torch.distributed`` with PyTorch's
``fake`` backend (its test helper ``FakeProcessGroup``): every rank
number exists, ``new_group`` works and no collective moves data. It lets
one process *build* a ``ProcessMesh`` of 8 or 512 ranks and the steps
over it (which issue no collective until they are called), so the tests
can assert what builds and what raises; what the steps compute is held on
real gloo ranks by ``tests/torch_mesh_harness.py``'s ``tp`` check.
"""
import contextlib
import dataclasses

import pytest
import torch
import torch.distributed as dist

#: the dense decoder-only archs
DENSE = ("glm4-9b", "qwen1.5-32b", "deepseek-67b", "gemma3-12b",
         "pixtral-12b")
#: the MoE, SSM, hybrid and encoder-decoder archs, which the eighteenth
#: slice brought over a model axis
DEFERRED = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
            "zamba2-1.2b", "whisper-tiny")
#: every arch, each of which runs over a model axis
ALL = DENSE + DEFERRED
#: the reference's refusal of an adaptive adversary on the trainer's vote
#: (its tree-form ``VoteRequest``), raised when the step is called
ADAPTIVE_REFUSAL = "has no such observation channel"


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A ``torch.distributed`` world of `world` fake ranks, this process
    rank `rank`; the port's cached process groups are dropped on entry and
    exit, so no fake group outlives it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed import mesh as pm
    if dist.is_initialized():
        pytest.skip("a process group is already initialised")
    pm._GROUPS.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        pm._GROUPS.clear()
        dist.destroy_process_group()


def reduced(arch: str, **kw):
    from repro_torch.configs import base
    return dataclasses.replace(base.reduced_config(base.get_config(arch)),
                               dtype="float32", **kw)


def train_config(**opt):
    from repro_torch.configs import base
    train = {k: opt.pop(k) for k in ("byzantine",) if k in opt}
    o = dict(kind="signum_vote", learning_rate=1e-3, momentum=0.9,
             vote_strategy=base.VoteStrategy.ALLGATHER_1BIT)
    o.update(opt)
    return base.TrainConfig(global_batch=8, seq_len=16,
                            optimizer=base.OptimizerConfig(**o), **train)


def assert_train_builds_and_refusals(mesh):
    """Over `mesh` (a model axis > 1): every arch's train step builds and
    materialises its blocks; so does glm4-9b's with a stochastic adversary
    (each a LeafShare with its cut dim) and with a VotePlan (this rank's
    windows of the global plan); an adaptive adversary builds and raises
    the reference's ``ValueError`` when the step is called, as without a
    model axis."""
    from repro_torch.configs import base
    from repro_torch.train import train_step as TS
    for arch in ALL:
        cfg = reduced(arch)
        art = TS.make_train_step(cfg, train_config(), device="cpu",
                                 mesh=mesh)
        params, _ = TS.materialize_state(cfg, train_config(), art,
                                         torch.Generator().manual_seed(0))
        for k, p in params.items():
            want = list(cfg.param_shapes()[k])
            for i, e in enumerate(art.param_specs[k]):
                if e == "model":
                    want[i] //= mesh.model
            assert tuple(p.shape) == tuple(want), (arch, k)
    cfg = reduced("glm4-9b")
    for mode in ("random", "colluding", "blind"):
        tcfg = train_config(byzantine=base.ByzantineConfig(
            mode=mode, num_adversaries=1))
        art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
        TS.materialize_state(cfg, tcfg, art, torch.Generator().manual_seed(0))
    tcfg = train_config(byzantine=base.ByzantineConfig(
        mode="adaptive_flip", num_adversaries=1))
    art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
    params, state = TS.materialize_state(cfg, tcfg, art,
                                         torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=ADAPTIVE_REFUSAL):
        art.step_fn(params, state, {"tokens": torch.zeros(
            (8, 16), dtype=torch.int64)}, 0)
    tcfg = train_config(bucket_bytes=4096)
    art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
    params, _ = TS.materialize_state(cfg, tcfg, art,
                                     torch.Generator().manual_seed(0))
    shard = art.optimizer.shard
    assert art.plan.n_params == cfg.param_count()
    assert shard.plan.n_params == sum(p.numel() for p in params.values())
    assert all(b.length for b in shard.plan.buckets)


def assert_serve_builds_and_refusals(mesh):
    """Over `mesh`: every arch's decode, prefill, sharded prefill (with and
    without fsdp) and re-home build (no serve step refuses a model axis
    any more: item 15's rest is on the vote side)."""
    from repro_torch.train import serve_step as SS
    for arch in ALL:
        cfg = reduced(arch)
        assert callable(SS.make_decode_step(cfg, mesh=mesh, max_len=64))
        assert callable(SS.make_prefill(cfg, mesh=mesh))
        for fsdp in (False, True):
            assert callable(SS.make_prefill_sharded(cfg, mesh, fsdp=fsdp,
                                                    global_batch=8))
        assert callable(SS.make_cache_rehome(cfg, 8, 64, mesh=mesh))
