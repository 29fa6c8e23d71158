"""Gradient codecs (``repro.core.codecs``; DESIGN.md §8).

    from repro_torch.core import codecs
    codec = codecs.get_codec("ef_sign")

| codec            | encode                       | decode                      | state  |
|------------------|------------------------------|-----------------------------|--------|
| ``sign1bit``     | raw signs (the paper)        | unweighted majority         | none   |
| ``ef_sign``      | signs of value + EF residual | unweighted majority         | worker |
| ``ternary2bit``  | ternary symbols, 2-bit pack  | sign of symbol sum (ties→0) | none   |
| ``weighted_vote``| raw signs                    | Chair–Varshney weighted     | server |
"""
from repro_torch.core.codecs.base import GradientCodec
from repro_torch.core.codecs.ef_sign import EFSignCodec
from repro_torch.core.codecs.sign1bit import Sign1BitCodec
from repro_torch.core.codecs.ternary import TERNARY_WIRE, Ternary2BitCodec
from repro_torch.core.codecs.weighted import (WeightedVoteCodec,
                                              decode_stacked,
                                              reliability_weights)

CODECS = {c.name: c for c in (Sign1BitCodec(), EFSignCodec(),
                              Ternary2BitCodec(), WeightedVoteCodec())}

DEFAULT_CODEC = "sign1bit"


def get_codec(name: str) -> GradientCodec:
    if name not in CODECS:
        raise ValueError(f"unknown codec {name!r}; have {sorted(CODECS)}")
    return CODECS[name]


def list_codecs():
    return tuple(sorted(CODECS))


__all__ = [
    "CODECS", "DEFAULT_CODEC", "EFSignCodec", "GradientCodec",
    "Sign1BitCodec", "TERNARY_WIRE", "Ternary2BitCodec",
    "WeightedVoteCodec", "decode_stacked", "get_codec", "list_codecs",
    "reliability_weights",
]
