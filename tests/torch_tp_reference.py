"""The reference's own model-axis paths on 8 fake CPU devices, run in a
subprocess by ``tests/test_torch_tensor_parallel.py`` (not collected
itself):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        PYTHONPATH=src python tests/torch_tp_reference.py <scratch dir>

1. ``make_train_step(cfg, tcfg, mesh)`` on a (data 4, model 2) mesh: one
   Mode A ``sign1bit`` step (allgather_1bit, beta 0.9) of the reduced
   glm4-9b in float32 from ``materialize_state`` and a batch of its own.
   Writes the start parameters and the batch to ``tp_reference_start.npz``
   (the port's harness steps from them) and the loss, parameters and each
   voter's momentum to ``tp_reference_step.npz``.
2. ``decode_step`` under a (data 1, model 4) mesh of the first 4 devices:
   the reduced glm4-9b (2 kv heads: the cache is sequence-sharded) in
   float32, a prompt prefilled and re-homed into a 4096-row cache (so
   ``_should_flash_decode`` sends each layer to ``flash_decode_sharded``),
   then 3 teacher-forced ticks, for a float32 and an int8 cache. Writes
   the inputs to ``tp_decode_start[_int8].npz`` and the prefill's and each
   tick's logits to ``tp_decode_ref[_int8].npz``.

With a second argument ``families`` (``tests/test_torch_tp_families.py``)
it runs the MoE, SSM, hybrid and encoder-decoder archs instead:

3. The same (data 4, model 2) Mode A step of the reduced qwen2-moe (the
   experts in the EP form, the shared branch), mamba2 and whisper (64
   frames a row), each with its capacity factor E / k where it routes,
   writing ``tpf_ref_<arch>_start.npz`` and ``tpf_ref_<arch>_step.npz``.
4. ``decode_step`` under a (data 1, model 4) mesh of the first 4 devices
   for the reduced zamba2 in float32: the prompt prefilled and re-homed
   into a 64-row cache, then 3 teacher-forced ticks; writes
   ``tpf_dec_<arch>_start.npz`` and ``tpf_dec_<arch>_ref.npz``. (Whisper's,
   last in the list, is left out for the test file's time: the port's
   whisper decode over a model axis, its cross cache sequence-sharded,
   is held to the port's single-device decode by the harness.)

With a second argument ``adversary`` (``tests/test_torch_tp_adversary.py``)
it runs the vote side of the model axis instead:

5. The same (data 4, model 2) Mode A step of the reduced glm4-9b with one
   adversary of four: ``random`` leaf-wise on ``allgather_1bit``, and
   ``blind`` (flip_prob 0.9) under a VotePlan of ``TPA_BUCKET_BYTES`` with
   ``overlap``; writes ``tpa_ref_<case>_start.npz`` and
   ``tpa_ref_<case>_step.npz``.
6. An ``adaptive_flip`` adversary there: which call raises (the build,
   ``materialize_state`` or the step) and with what, into
   ``tpa_ref_adaptive.json``.

Prints ``OK <seconds>``.
"""
import dataclasses
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import compat
from repro.compat import AxisType
from repro.configs.base import (ByzantineConfig, OptimizerConfig,
                                TrainConfig, VoteStrategy, get_config,
                                reduced_config)
from repro.models import layers as L
from repro.models import model as M
from repro.train import serve_step as SS
from repro.train import train_step as TS

#: the step's global batch, sequence, learning rate and beta (the port's
#: harness reads the same constants)
GB, SEQ, LR, BETA = 8, 64, 1e-3, 0.9
#: the decode: prompt rows and length, the cache's rows, the ticks
DEC_B, DEC_S, DEC_T, DEC_TICKS = 2, 12, 4096, 3


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def train_step(scratch):
    mesh = compat.make_mesh((4, 2), ("data", "model"),
                            axis_types=(AxisType.Auto,) * 2)
    cfg = dataclasses.replace(reduced_config(get_config("glm4-9b")),
                              dtype="float32")
    tcfg = TrainConfig(global_batch=GB, seq_len=SEQ, optimizer=OptimizerConfig(
        kind="signum_vote", learning_rate=LR, momentum=BETA,
        vote_strategy=VoteStrategy.ALLGATHER_1BIT))
    art = TS.make_train_step(cfg, tcfg, mesh=mesh)
    params, opt = TS.materialize_state(cfg, tcfg, art, jax.random.PRNGKey(0),
                                       mesh)
    batch = M.make_batch(cfg, GB, SEQ, jax.random.PRNGKey(1))
    start = _np(params)
    placed = jax.tree.map(lambda a: jax.device_put(
        np.asarray(a), NamedSharding(mesh, P("data"))), batch)
    new, state, met = art.step_fn(params, opt, placed, jnp.int32(0))
    np.savez(os.path.join(scratch, "tp_reference_start.npz"),
             tokens=np.asarray(batch["tokens"]),
             **{"p/" + k: v for k, v in start.items()})
    np.savez(os.path.join(scratch, "tp_reference_step.npz"),
             loss=np.float64(met["loss"]),
             **{"p/" + k: v for k, v in _np(new).items()},
             **{"m/" + k: v for k, v in _np(state["momentum"]).items()})


def decode(scratch, kv_dtype: str, suffix: str):
    cfg = dataclasses.replace(reduced_config(get_config("glm4-9b")),
                              dtype="float32", kv_cache_dtype=kv_dtype)
    params = M.init_params(cfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (DEC_B, DEC_S)).astype(np.int32)
    ticks = rng.integers(0, cfg.vocab_size, (DEC_TICKS, DEC_B)).astype(
        np.int32)
    logits, cache = SS.make_prefill(cfg)(params, {"tokens": jnp.asarray(
        prompt)})
    cache = SS.make_cache_rehome(cfg, DEC_B, DEC_T)(cache)
    mesh = compat.make_mesh((1, 4), ("data", "model"),
                            axis_types=(AxisType.Auto,) * 2,
                            devices=jax.devices()[:4])
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    assert L.KV_CHUNK <= DEC_T and cfg.num_kv_heads % 4
    out = {"prefill": np.asarray(logits)}
    taken = []
    sharded = L.flash_decode_sharded

    def counted(*a, **kw):   # traced once a layer: the gate's choice
        taken.append(1)
        return sharded(*a, **kw)
    L.flash_decode_sharded = counted
    with compat.set_mesh(mesh):
        cache = {k: jax.device_put(v, NamedSharding(
            mesh, SS.cache_leaf_spec(k, v.shape, sizes)))
            for k, v in cache.items()}
        step = SS.make_decode_step(cfg)
        for i in range(DEC_TICKS):
            lg, cache = step(params, jnp.asarray(ticks[i])[:, None], cache,
                             jnp.int32(DEC_S + i))
            out[f"tick{i}"] = np.asarray(lg)
    L.flash_decode_sharded = sharded
    assert taken, "the reference's decode never took flash_decode_sharded"
    np.savez(os.path.join(scratch, f"tp_decode_start{suffix}.npz"),
             prompt=prompt, ticks=ticks, max_len=np.int64(DEC_T),
             kv_dtype=np.str_(kv_dtype),
             **{"p/" + k: v for k, v in _np(params).items()})
    np.savez(os.path.join(scratch, f"tp_decode_ref{suffix}.npz"), **out,
             **{"c/" + k: np.asarray(v, np.float32)
                for k, v in cache.items()})


#: the families' reference runs (the port's harness reads the same)
FAMILY_STEPS = ("qwen2-moe-a2.7b", "mamba2-2.7b", "whisper-tiny")
FAMILY_DECODES = ("zamba2-1.2b",)
FDEC_B, FDEC_S, FDEC_T = 2, 12, 64


def family_cfg(arch: str):
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="float32")
    if cfg.moe.enabled:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    return cfg


def family_step(scratch, arch: str):
    mesh = compat.make_mesh((4, 2), ("data", "model"),
                            axis_types=(AxisType.Auto,) * 2)
    cfg = family_cfg(arch)
    tcfg = TrainConfig(global_batch=GB, seq_len=SEQ, optimizer=OptimizerConfig(
        kind="signum_vote", learning_rate=LR, momentum=BETA,
        vote_strategy=VoteStrategy.ALLGATHER_1BIT))
    art = TS.make_train_step(cfg, tcfg, mesh=mesh)
    params, opt = TS.materialize_state(cfg, tcfg, art, jax.random.PRNGKey(0),
                                       mesh)
    batch = M.make_batch(cfg, GB, SEQ, jax.random.PRNGKey(1))
    start = _np(params)
    placed = jax.tree.map(lambda a: jax.device_put(
        np.asarray(a), NamedSharding(mesh, P("data"))), batch)
    new, state, met = art.step_fn(params, opt, placed, jnp.int32(0))
    np.savez(os.path.join(scratch, f"tpf_ref_{arch}_start.npz"),
             **{"b/" + k: np.asarray(v, np.float32 if k != "tokens"
                                     else np.int64) for k, v in
                batch.items()},
             **{"p/" + k: v for k, v in start.items()})
    np.savez(os.path.join(scratch, f"tpf_ref_{arch}_step.npz"),
             loss=np.float64(met["loss"]),
             **{"p/" + k: v for k, v in _np(new).items()},
             **{"m/" + k: v for k, v in _np(state["momentum"]).items()})


def family_decode(scratch, arch: str):
    cfg = family_cfg(arch)
    params = M.init_params(cfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (
        FDEC_B, FDEC_S)).astype(np.int32)}
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.normal(size=(
            FDEC_B, cfg.max_source_positions, cfg.d_model)).astype(
                np.float32)
    ticks = rng.integers(0, cfg.vocab_size, (DEC_TICKS, FDEC_B)).astype(
        np.int32)
    logits, cache = SS.make_prefill(cfg)(params, {k: jnp.asarray(v) for k, v
                                                  in batch.items()})
    cache = SS.make_cache_rehome(cfg, FDEC_B, FDEC_T)(cache)
    mesh = compat.make_mesh((1, 4), ("data", "model"),
                            axis_types=(AxisType.Auto,) * 2,
                            devices=jax.devices()[:4])
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = {"prefill": np.asarray(logits)}
    with compat.set_mesh(mesh):
        cache = {k: jax.device_put(v, NamedSharding(
            mesh, SS.cache_leaf_spec(k, v.shape, sizes)))
            for k, v in cache.items()}
        step = SS.make_decode_step(cfg)
        for i in range(DEC_TICKS):
            lg, cache = step(params, jnp.asarray(ticks[i])[:, None], cache,
                             jnp.int32(FDEC_S + i))
            out[f"tick{i}"] = np.asarray(lg)
    np.savez(os.path.join(scratch, f"tpf_dec_{arch}_start.npz"),
             ticks=ticks, **{"b/" + k: v for k, v in batch.items()},
             **{"p/" + k: v for k, v in _np(params).items()})
    np.savez(os.path.join(scratch, f"tpf_dec_{arch}_ref.npz"), **out)


#: the adversary cases (the port's harness reads the same): (label, plan
#: options, adversary)
TPA_BUCKET_BYTES = 4096
TPA_CASES = (
    ("random", {}, ByzantineConfig(mode="random", num_adversaries=1,
                                   seed=3)),
    ("plan_blind", {"bucket_bytes": TPA_BUCKET_BYTES, "overlap": True},
     ByzantineConfig(mode="blind", num_adversaries=1, seed=3,
                     flip_prob=0.9)),
)


def tpa_config(opt_kw, byz):
    cfg = dataclasses.replace(reduced_config(get_config("glm4-9b")),
                              dtype="float32")
    tcfg = TrainConfig(global_batch=GB, seq_len=SEQ, optimizer=OptimizerConfig(
        kind="signum_vote", learning_rate=LR, momentum=BETA,
        vote_strategy=VoteStrategy.ALLGATHER_1BIT, **opt_kw), byzantine=byz)
    return cfg, tcfg


def adversary_step(scratch, label, opt_kw, byz):
    mesh = compat.make_mesh((4, 2), ("data", "model"),
                            axis_types=(AxisType.Auto,) * 2)
    cfg, tcfg = tpa_config(opt_kw, byz)
    art = TS.make_train_step(cfg, tcfg, mesh=mesh)
    params, opt = TS.materialize_state(cfg, tcfg, art, jax.random.PRNGKey(0),
                                       mesh)
    batch = M.make_batch(cfg, GB, SEQ, jax.random.PRNGKey(1))
    start = _np(params)
    placed = jax.tree.map(lambda a: jax.device_put(
        np.asarray(a), NamedSharding(mesh, P("data"))), batch)
    new, state, met = art.step_fn(params, opt, placed, jnp.int32(0))
    np.savez(os.path.join(scratch, f"tpa_ref_{label}_start.npz"),
             tokens=np.asarray(batch["tokens"]),
             **{"p/" + k: v for k, v in start.items()})
    np.savez(os.path.join(scratch, f"tpa_ref_{label}_step.npz"),
             loss=np.float64(met["loss"]),
             **{"p/" + k: v for k, v in _np(new).items()},
             **{"m/" + k: v for k, v in _np(state["momentum"]).items()})


def adaptive_refusal(scratch):
    """The call at which an adaptive adversary is refused on the (4, 2)
    mesh, and the exception's type and message."""
    import json
    mesh = compat.make_mesh((4, 2), ("data", "model"),
                            axis_types=(AxisType.Auto,) * 2)
    cfg, tcfg = tpa_config({}, ByzantineConfig(mode="adaptive_flip",
                                               num_adversaries=1))
    out = {"call": None}
    try:
        call = "make_train_step"
        art = TS.make_train_step(cfg, tcfg, mesh=mesh)
        call = "materialize_state"
        params, opt = TS.materialize_state(cfg, tcfg, art,
                                           jax.random.PRNGKey(0), mesh)
        call = "step_fn"
        batch = M.make_batch(cfg, GB, SEQ, jax.random.PRNGKey(1))
        art.step_fn(params, opt, batch, jnp.int32(0))
    except Exception as e:  # noqa: BLE001 - the refusal is what we record
        out = {"call": call, "type": type(e).__name__, "message": str(e)}
    with open(os.path.join(scratch, "tpa_ref_adaptive.json"), "w") as f:
        json.dump(out, f)


def main(argv) -> int:
    scratch = os.path.abspath(argv[1] if len(argv) > 1 else ".")
    t0 = time.perf_counter()
    assert len(jax.devices()) == 8, jax.devices()
    if argv[2:] == ["adversary"]:
        for label, opt_kw, byz in TPA_CASES:
            adversary_step(scratch, label, opt_kw, byz)
            print(f"  step {label} {time.perf_counter() - t0:.1f}",
                  flush=True)
        adaptive_refusal(scratch)
        print(f"OK {time.perf_counter() - t0:.1f}", flush=True)
        return 0
    if argv[2:] == ["families"]:
        for arch in FAMILY_STEPS:
            family_step(scratch, arch)
            print(f"  step {arch} {time.perf_counter() - t0:.1f}",
                  flush=True)
        for arch in FAMILY_DECODES:
            family_decode(scratch, arch)
            print(f"  decode {arch} {time.perf_counter() - t0:.1f}",
                  flush=True)
        print(f"OK {time.perf_counter() - t0:.1f}", flush=True)
        return 0
    train_step(scratch)
    decode(scratch, "bfloat16", "")
    decode(scratch, "int8", "_int8")
    print(f"OK {time.perf_counter() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
