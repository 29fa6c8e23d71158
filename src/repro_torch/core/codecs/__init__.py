"""Gradient codecs (``repro.core.codecs``; DESIGN.md §8).

    from repro_torch.core import codecs
    codec = codecs.get_codec("sign1bit")

Only ``sign1bit``, the paper's raw-sign majority, is ported. The other
codecs of the reference (``ef_sign``, ``ternary2bit``, ``weighted_vote``)
raise ``NotImplementedError`` naming ROADMAP.md Queue 1 item 8; any other
name raises ``ValueError``, as the reference does.
"""
from repro_torch.core.codecs.base import GradientCodec
from repro_torch.core.codecs.sign1bit import Sign1BitCodec

CODECS = {c.name: c for c in (Sign1BitCodec(),)}
#: the reference's other codecs, still to port
NOT_PORTED = ("ef_sign", "ternary2bit", "weighted_vote")


def get_codec(name: str) -> GradientCodec:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"codec {name!r} is not ported yet (ROADMAP.md Queue 1 item 8); "
            "the port runs codec 'sign1bit'")
    if name not in CODECS:
        raise ValueError(f"unknown codec {name!r}; have "
                         f"{sorted((*CODECS, *NOT_PORTED))}")
    return CODECS[name]


__all__ = ["CODECS", "GradientCodec", "Sign1BitCodec", "get_codec"]
