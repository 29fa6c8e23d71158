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
#: the MoE, SSM, hybrid and encoder-decoder archs, which ROADMAP.md Queue 1
#: item 15 deferred until they ran over a model axis too
DEFERRED = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
            "zamba2-1.2b", "whisper-tiny")
#: every arch, each of which runs over a model axis
ALL = DENSE + DEFERRED
ITEM_15 = "Queue 1 item 15"


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
    materialises its blocks; a stochastic and an adaptive adversary and a
    VotePlan raise naming item 15."""
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
    for mode in ("random", "colluding", "blind", "adaptive_flip"):
        byz = base.ByzantineConfig(mode=mode, num_adversaries=1)
        with pytest.raises(NotImplementedError, match=ITEM_15):
            TS.make_train_step(cfg, train_config(byzantine=byz),
                               device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match=ITEM_15):
        TS.make_train_step(cfg, train_config(bucket_bytes=4096),
                           device="cpu", mesh=mesh)


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
