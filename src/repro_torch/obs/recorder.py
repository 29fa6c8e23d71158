"""The telemetry layer's three primitives (``repro.obs.recorder``;
DESIGN.md §13), in the reference's JSONL schema, so a trace of the port
reads back with either package's ``read_trace``.

* **Counters** — one process-global :class:`CounterRegistry` of exact
  integers: the vote API's ``vote.requests`` / ``vote.wire.bytes`` /
  ``vote.wire.messages``, the plan walk's ``plan.buckets`` and the
  streamed engine's ``population.*`` (``core.population``). Always on:
  incrementing an int in a dict is cheaper than any gate. (The port's
  kernel launches are counted by ``kernels.ops.launch_counts()``.)
* **Spans** — host-side ``perf_counter`` timing with nesting, emitted by
  a :class:`TraceRecorder`. The default recorder is a :class:`Recorder`
  no-op whose ``span()`` returns one module-level singleton (no
  allocation). A span times the host: around work on a CUDA device it
  measures the launches' enqueue unless the caller synchronizes inside
  it — the rows say so via the ``host_side`` meta field.
* **Step records** — one structured row per training/scenario step
  unifying the ``WireReport`` and ``StepTrace`` fields (resolved
  strategy, payload bytes, compression vs f32, margin, flip-vs-oracle,
  per-phase seconds), written to the same JSONL sink.

Every JSONL row carries ``{"v": SCHEMA_VERSION, "kind": ...}``;
:func:`read_trace` validates the version so downstream tooling
(`scripts/trace_report.py`) fails loudly on schema drift instead of
misreading rows.

The port runs eagerly, so every increment fires once per call.

The bench and launcher helpers (``emit_bench_json``, ``add_trace_arg``,
``activate_trace``, ``finish_trace``) are the reference's. Not ported:
``install_compile_watch`` (it counts XLA compilations, which the port has
none of; ``activate_trace`` installs nothing else).
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, IO, Iterator, List, Optional

#: bump on any breaking change to the JSONL row shapes below
SCHEMA_VERSION = 1

#: the row kinds a schema-1 trace may contain
ROW_KINDS = ("meta", "span", "event", "step", "counters")


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


class CounterRegistry:
    """Exact-integer counters under dotted names (``vote.wire.bytes``,
    ``kernel.launches.fused_majority``, ...). Three write verbs:
    monotonic :meth:`inc`, last-value :meth:`set` (gauges like the
    streamed engine's most-recent-run accounting), and high-water
    :meth:`record_max`. All values are plain Python ints — arbitrary
    precision, no float drift, cheap enough to leave always-on."""

    __slots__ = ("_c",)

    def __init__(self) -> None:
        self._c: Dict[str, int] = {}

    def inc(self, name: str, delta: int = 1) -> None:
        self._c[name] = self._c.get(name, 0) + int(delta)

    def set(self, name: str, value: int) -> None:
        self._c[name] = int(value)

    def record_max(self, name: str, value: int) -> None:
        v = int(value)
        if v > self._c.get(name, 0):
            self._c[name] = v

    def get(self, name: str, default: int = 0) -> int:
        return self._c.get(name, default)

    def snapshot(self, prefix: str = "") -> Dict[str, int]:
        """A detached copy (optionally of one dotted namespace)."""
        if not prefix:
            return dict(self._c)
        return {k: v for k, v in self._c.items() if k.startswith(prefix)}

    def delta_since(self, before: Dict[str, int],
                    prefix: str = "") -> Dict[str, int]:
        """Nonzero changes vs an earlier :meth:`snapshot`."""
        out = {}
        for k, v in self.snapshot(prefix).items():
            d = v - before.get(k, 0)
            if d:
                out[k] = d
        return out

    def reset(self, prefix: str = "") -> None:
        if not prefix:
            self._c.clear()
            return
        for k in [k for k in self._c if k.startswith(prefix)]:
            del self._c[k]


#: THE process-global registry (always on; see module docstring)
COUNTERS = CounterRegistry()


# ---------------------------------------------------------------------------
# spans / recorders
# ---------------------------------------------------------------------------


class _NoopSpan:
    """The disabled span: one module-level singleton, allocation-free on
    the hot path (``rec.span("name")`` with no attrs allocates nothing)."""

    __slots__ = ()
    dur_s = 0.0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class Recorder:
    """The default no-op recorder. ``enabled`` is False, ``span()``
    returns the singleton no-op context manager, ``step``/``event`` do
    nothing. Hot paths gate attr computation on ``rec.enabled`` so the
    disabled cost is one attribute read."""

    enabled: bool = False

    def span(self, name: str, **attrs) -> Any:
        return _NOOP_SPAN

    def event(self, name: str, **attrs) -> None:
        pass

    def step(self, **fields) -> None:
        pass

    def close(self) -> None:
        pass


class _Span:
    """A live span: ``perf_counter`` on enter/exit, row written on exit
    with nesting depth + parent seq from the recorder's span stack."""

    __slots__ = ("_rec", "name", "attrs", "seq", "depth", "parent",
                 "_t0", "dur_s")

    def __init__(self, rec: "TraceRecorder", name: str,
                 attrs: Dict[str, Any]):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self.seq = -1
        self.depth = 0
        self.parent = -1
        self._t0 = 0.0
        self.dur_s = 0.0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        rec = self._rec
        self.seq = rec._next_seq()
        self.depth = len(rec._stack)
        self.parent = rec._stack[-1].seq if rec._stack else -1
        rec._stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self.dur_s = t1 - self._t0
        rec = self._rec
        if rec._stack and rec._stack[-1] is self:
            rec._stack.pop()
        else:                       # mis-nested exit: recover, don't lie
            rec._stack = [s for s in rec._stack if s is not self]
        row = {"v": SCHEMA_VERSION, "kind": "span", "seq": self.seq,
               "parent": self.parent, "depth": self.depth,
               "name": self.name, "t0_s": self._t0 - rec._origin,
               "dur_s": self.dur_s}
        if self.attrs:
            row["attrs"] = self.attrs
        rec._write(row)
        return False


class TraceRecorder(Recorder):
    """JSONL sink: a ``meta`` header row, then ``span``/``event``/
    ``step`` rows as they happen, then a final ``counters`` snapshot on
    :meth:`close`. All timing is host-side ``perf_counter`` relative to
    the recorder's origin; nothing here touches a tensor, so a drill's
    digest is bit-identical with tracing on.
    """

    enabled = True

    def __init__(self, path_or_file, meta: Optional[Dict[str, Any]] = None):
        if hasattr(path_or_file, "write"):
            self._f: IO[str] = path_or_file
            self._own = False
            self.path = getattr(path_or_file, "name", "<stream>")
        else:
            self._f = open(path_or_file, "w")
            self._own = True
            self.path = str(path_or_file)
        self._stack: List[_Span] = []
        self._seq = 0
        self._closed = False
        self._origin = time.perf_counter()
        head = {"v": SCHEMA_VERSION, "kind": "meta",
                "schema": SCHEMA_VERSION, "unix_time": time.time(),
                "host_side": True}
        if meta:
            head.update(meta)
        self._write(head)

    # -- plumbing --

    def _next_seq(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    def _write(self, row: Dict[str, Any]) -> None:
        if self._closed:
            return
        self._f.write(json.dumps(row, default=_jsonable) + "\n")

    # -- the three primitives --

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        row = {"v": SCHEMA_VERSION, "kind": "event", "seq": self._next_seq(),
               "name": name,
               "t0_s": time.perf_counter() - self._origin}
        if attrs:
            row["attrs"] = attrs
        self._write(row)

    def step(self, **fields) -> None:
        self._write({"v": SCHEMA_VERSION, "kind": "step",
                     "seq": self._next_seq(), **fields})

    def counters(self, registry: CounterRegistry = None) -> None:
        reg = registry if registry is not None else COUNTERS
        self._write({"v": SCHEMA_VERSION, "kind": "counters",
                     "values": reg.snapshot()})

    def close(self) -> None:
        if self._closed:
            return
        self.counters()
        self._closed = True
        if self._own:
            self._f.close()
        else:
            self._f.flush()


def _jsonable(x):
    """Last-resort JSON coercion for attr values (enums, 0-d tensors)."""
    for attr in ("value", "item"):
        v = getattr(x, attr, None)
        if v is not None:
            try:
                return v() if callable(v) else v
            except Exception:
                pass
    return str(x)


def read_trace(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL trace, validating the schema version of every row
    (fails loudly on drift — the versioned-schema contract)."""
    rows = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if row.get("v") != SCHEMA_VERSION:
                raise ValueError(
                    f"{path}:{lineno}: trace row schema v={row.get('v')!r}"
                    f", this reader understands v={SCHEMA_VERSION}")
            if row.get("kind") not in ROW_KINDS:
                raise ValueError(
                    f"{path}:{lineno}: unknown row kind "
                    f"{row.get('kind')!r}; have {ROW_KINDS}")
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the active recorder (module global + context-manager scoping)
# ---------------------------------------------------------------------------

_NOOP = Recorder()
_ACTIVE: Recorder = _NOOP


def get_recorder() -> Recorder:
    """The active recorder (the no-op singleton unless one was set)."""
    return _ACTIVE


def set_recorder(rec: Optional[Recorder]) -> Recorder:
    """Install `rec` as the active recorder (None -> the no-op);
    returns the previous one so callers can restore it."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = rec if rec is not None else _NOOP
    return prev


@contextlib.contextmanager
def recording(rec: Recorder) -> Iterator[Recorder]:
    """Scope `rec` as the active recorder; restores the previous one on
    exit (the recorder is NOT closed — callers own its lifetime)."""
    prev = set_recorder(rec)
    try:
        yield rec
    finally:
        set_recorder(prev)


# ---------------------------------------------------------------------------
# shared helpers for the bench scripts and the launcher
# ---------------------------------------------------------------------------


def emit_bench_json(rows, path: str) -> None:
    """The bench JSON writer: ``{"rows": [{"name", "value", "derived"}]}``,
    the schema ``scripts/perf_gate.py`` gates, from ``(name, value,
    derived)`` tuples or dicts of those keys."""
    out = []
    for r in rows:
        if isinstance(r, dict):
            out.append({"name": r["name"], "value": r["value"],
                        "derived": r.get("derived", "")})
        else:
            name, value, derived = r
            out.append({"name": name, "value": value, "derived": derived})
    with open(path, "w") as f:
        json.dump({"rows": out}, f, indent=1)


def add_trace_arg(ap) -> None:
    """Attach the shared ``--trace FILE`` option to an argparser."""
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="write an obs JSONL trace of this run "
                         "(render with scripts/trace_report.py)")


def activate_trace(args) -> Optional[TraceRecorder]:
    """Honour a parsed ``--trace`` flag: install a :class:`TraceRecorder`
    as the active recorder and return it, or None. The caller closes it
    (:func:`finish_trace`)."""
    path = getattr(args, "trace", None)
    if not path:
        return None
    rec = TraceRecorder(path)
    set_recorder(rec)
    return rec


def finish_trace(rec: Optional[TraceRecorder]) -> None:
    """Close an :func:`activate_trace` recorder (it writes the final
    counters snapshot) and restore the no-op."""
    if rec is None:
        return
    set_recorder(None)
    rec.close()
    print(f"# wrote trace {rec.path}", flush=True)


__all__ = [
    "COUNTERS", "CounterRegistry", "ROW_KINDS", "Recorder", "SCHEMA_VERSION",
    "TraceRecorder", "activate_trace", "add_trace_arg", "emit_bench_json",
    "finish_trace", "get_recorder", "read_trace", "recording",
    "set_recorder",
]
