"""Continuous-batching serve engine + hot checkpoint swap
(``repro.serve``; DESIGN.md §14).

The serving counterpart of the training stack: a fixed decode-slot pool
under one decode step (``engine``), deterministic splitmix64-keyed Poisson
traffic (``traffic``), and the trainer->server parameter handoff over
atomic checkpoints (``swap``).
"""
from repro_torch.serve.engine import (RequestRecord, ServeConfig,
                                      ServeEngine, ServeReport)
from repro_torch.serve.swap import (CheckpointEmitter, CheckpointWatcher,
                                    ParamUpdate, like_tree)
from repro_torch.serve.traffic import Request, poisson_requests

__all__ = [
    "CheckpointEmitter", "CheckpointWatcher", "ParamUpdate", "Request",
    "RequestRecord", "ServeConfig", "ServeEngine", "ServeReport",
    "like_tree", "poisson_requests",
]
