"""The decode step's ZeRO-3 hook for every family (``models.model.
decode_step(..., hook=)``, the function the reference's decode computes
under FSDP parameter shardings), in one process on the CPU.

Every arch's ``reduced_config`` in float32 with the port's own seeded
parameters and a seeded random cache: two ticks through an identity hook
that records its calls are bit-equal, in logits and in every cache leaf,
to the same ticks without a hook (which ``tests/test_torch_decode.py``
holds to the reference's ``decode_step``), and the hook sees the top-level
leaves once a tick and each decoder layer's leaves as that layer runs, the
encoder's never. Over a real (data 2, model 2) FSDP layout the decode and
the sharded prefill of four families are held bit for bit to the plain
layout's by ``tests/torch_mesh_harness.py``'s ``check_decode_fsdp``
(``tests/test_torch_dryrun.py``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.base import ArchFamily  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402

ARCHS = tbase.list_archs()
B, T = 2, 12


def _random_cache(cfg):
    gen = torch.Generator().manual_seed(3)
    out = {}
    for k, v in tM.init_cache(cfg, B, T, device="cpu").items():
        if v.dtype == torch.int8:
            out[k] = torch.randint(-127, 128, v.shape, generator=gen,
                                   dtype=torch.int8)
        else:
            out[k] = torch.randn(v.shape, generator=gen).to(v.dtype)
    return out


class IdentityHook:
    """``hook(tree, scope)`` that returns `tree` and records each call's
    scope and leaf names."""

    def __init__(self):
        self.calls = []

    def __call__(self, tree, scope):
        self.calls.append((scope, tuple(sorted(tree))))
        return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_through_an_identity_hook_is_the_plain_decode(arch):
    cfg = dataclasses.replace(tbase.reduced_config(tbase.get_config(arch)),
                              dtype="float32")
    params = tM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, B, 1),
                           generator=torch.Generator().manual_seed(1))
    got = {}
    hook = IdentityHook()
    for h in (None, hook):
        cache = _random_cache(cfg)
        logits = []
        for i in range(2):
            lg, cache = tM.decode_step(cfg, params, tokens[i], cache, 3 + i,
                                       hook=h)
            logits.append(lg)
        got[h is None] = (logits, cache)
    for a, b in zip(got[False][0], got[True][0]):
        assert torch.equal(a, b)
    for k, v in got[True][1].items():
        assert torch.equal(got[False][1][k], v), k
    # the top-level leaves once a tick, then each decoder layer's
    top = tuple(sorted(k for k in params
                       if not k.startswith(("layers.", "encoder."))))
    layer = tuple(sorted(k.split(".", 1)[1] for k in params
                         if k.startswith("layers.")))
    want = ([("top", top)] + [("layers", layer)] * cfg.num_layers) * 2
    assert hook.calls == want
    if cfg.family == ArchFamily.HYBRID:
        assert any(k.startswith("shared_block.") for k in top)
