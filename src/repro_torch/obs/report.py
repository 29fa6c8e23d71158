"""Aggregate an obs JSONL trace into the human report
(``repro.obs.report``; the same sections, numbers and text).

    python -m repro_torch.obs.report TRACE.jsonl [--json]

Sections:

* ``per-phase time`` — span durations grouped by name (count / total /
  mean / share of root-level span time).
* ``overlap pipeline`` — per ``plan.schedule`` walk: issue-vs-complete
  occupancy of the walk's wall time (the double-buffered schedule's
  utilization; the gap column is walk time in neither stage).
* ``measured vs predicted exchange`` — per bucket: the summed
  issue + complete span time against the α–β link model's prediction
  carried on the issue span (``pred_s``, ``distributed.comm_model``).
* ``steps / wire`` — per-step payload bytes vs the float32 baseline,
  against the paper's ideal 1/32 ratio, plus margin / flip / loss
  summaries.
* ``counters`` — the final exact-integer registry snapshot.

Every timing in a trace is a host-side ``perf_counter`` span. The port
launches its CUDA work asynchronously, so a span around a launch times the
launch, not the card's work; the measured exchange of one card is no
link's time. The report's header says the spans are host-side, in the
reference's words, so that the two packages render one trace alike.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List

from repro_torch.obs.recorder import SCHEMA_VERSION, read_trace

#: the paper's headline compression target (1 bit vs fp32)
IDEAL_RATIO = 1.0 / 32.0

SECTIONS = ("trace meta", "per-phase time", "overlap pipeline",
            "measured vs predicted exchange", "steps / wire", "counters")


def _spans(rows):
    return [r for r in rows if r["kind"] == "span"]


def _fmt_s(t: float) -> str:
    if t >= 1.0:
        return f"{t:9.3f} s "
    if t >= 1e-3:
        return f"{t * 1e3:9.3f} ms"
    return f"{t * 1e6:9.1f} us"


def phase_table(rows) -> List[Dict[str, Any]]:
    """Span durations grouped by name, descending total."""
    agg: Dict[str, List[float]] = defaultdict(list)
    for s in _spans(rows):
        agg[s["name"]].append(float(s["dur_s"]))
    # the share denominator is ROOT-level span time only — nested spans
    # would be double-counted against their parents
    root_total = sum(float(s["dur_s"]) for s in _spans(rows)
                     if s.get("depth", 0) == 0) or 1.0
    out = []
    for name, ds in sorted(agg.items(), key=lambda kv: -sum(kv[1])):
        out.append({"phase": name, "count": len(ds), "total_s": sum(ds),
                    "mean_s": sum(ds) / len(ds),
                    "share": sum(ds) / root_total})
    return out


def schedule_table(rows) -> List[Dict[str, Any]]:
    """One row per ``plan.schedule`` walk: occupancy of issue/complete
    child spans inside the walk's wall time."""
    spans = _spans(rows)
    walks = [s for s in spans if s["name"] == "plan.schedule"]
    by_parent: Dict[int, List[dict]] = defaultdict(list)
    for s in spans:
        by_parent[s.get("parent", -1)].append(s)
    out = []
    for w in walks:
        kids = by_parent.get(w["seq"], [])
        t_issue = sum(k["dur_s"] for k in kids if k["name"] == "plan.issue")
        t_comp = sum(k["dur_s"] for k in kids
                     if k["name"] == "plan.complete")
        wall = float(w["dur_s"]) or 1e-12
        out.append({
            "seq": w["seq"],
            "n_buckets": w.get("attrs", {}).get("n_buckets", len(kids)),
            "overlap": bool(w.get("attrs", {}).get("overlap", False)),
            "wall_s": float(w["dur_s"]),
            "issue_s": t_issue, "complete_s": t_comp,
            "issue_occ": t_issue / wall, "complete_occ": t_comp / wall,
            "gap": max(0.0, 1.0 - (t_issue + t_comp) / wall),
        })
    return out


def bucket_table(rows) -> List[Dict[str, Any]]:
    """Per bucket index: measured issue+complete span time vs the α–β
    prediction (``pred_s`` attr on the issue span), averaged over every
    schedule walk in the trace."""
    issue: Dict[int, List[float]] = defaultdict(list)
    comp: Dict[int, List[float]] = defaultdict(list)
    pred: Dict[int, List[float]] = defaultdict(list)
    label: Dict[int, str] = {}
    for s in _spans(rows):
        a = s.get("attrs", {})
        if s["name"] == "plan.issue" and "bucket" in a:
            k = int(a["bucket"])
            issue[k].append(float(s["dur_s"]))
            if "pred_s" in a:
                pred[k].append(float(a["pred_s"]))
            label.setdefault(
                k, f"{a.get('codec', '?')}/{a.get('strategy', '?')}"
                   f"[{a.get('length', '?')}]")
        elif s["name"] == "plan.complete" and "bucket" in a:
            comp[int(a["bucket"])].append(float(s["dur_s"]))
    out = []
    for k in sorted(issue):
        n_walks = len(issue[k])                  # one issue per walk
        measured = (sum(issue[k]) + sum(comp.get(k, []))) / n_walks
        p = (sum(pred[k]) / len(pred[k])) if pred.get(k) else None
        out.append({"bucket": k, "label": label.get(k, "?"),
                    "measured_s": measured, "predicted_s": p,
                    "ratio": (measured / p) if p else None})
    return out


def step_table(rows) -> Dict[str, Any]:
    """Aggregates over the step records (only rows carrying wire fields
    enter the wire averages; trainer records without them still count
    toward n_steps/loss)."""
    steps = [r for r in rows if r["kind"] == "step"]
    wired = [r for r in steps if r.get("payload_bytes") is not None
             and r.get("n_coords")]
    out: Dict[str, Any] = {"n_steps": len(steps), "rows": steps}
    if steps and steps[-1].get("loss") is not None:
        losses = [r["loss"] for r in steps if r.get("loss") is not None]
        out["first_loss"], out["final_loss"] = losses[0], losses[-1]
    if wired:
        pay = [float(r["payload_bytes"]) for r in wired]
        f32 = [4.0 * float(r["n_coords"]) for r in wired]
        out["mean_payload_bytes"] = sum(pay) / len(pay)
        out["mean_ratio_vs_f32"] = sum(p / f for p, f in zip(pay, f32)) \
            / len(pay)
        out["ideal_ratio"] = IDEAL_RATIO
        margins = [r["margin"] for r in wired if r.get("margin") is not None]
        if margins:
            out["mean_margin"] = sum(margins) / len(margins)
        flips = [r["flip_fraction"] for r in wired
                 if r.get("flip_fraction") is not None]
        if flips:
            out["mean_flip_fraction"] = sum(flips) / len(flips)
    return out


def summarize(path: str) -> Dict[str, Any]:
    """The full machine-readable aggregate (the ``--json`` output)."""
    rows = read_trace(path)
    meta = next((r for r in rows if r["kind"] == "meta"), {})
    counters = {}
    for r in rows:
        if r["kind"] == "counters":
            counters = r["values"]       # last snapshot wins
    events = [r for r in rows if r["kind"] == "event"]
    return {"schema": SCHEMA_VERSION, "meta": meta,
            "phases": phase_table(rows),
            "schedules": schedule_table(rows),
            "buckets": bucket_table(rows),
            "steps": step_table(rows),
            "counters": counters,
            "n_events": len(events)}


def render(path: str) -> str:
    """The human report (stable ``== section ==`` headings — the CI
    obs-smoke stage asserts every section renders)."""
    s = summarize(path)
    L: List[str] = []

    L.append("== trace meta ==")
    meta = s["meta"]
    L.append(f"  schema v{meta.get('schema', '?')}   "
             f"host-side perf_counter timings "
             f"(spans around jitted code measure trace/dispatch)")
    for k in sorted(set(meta) - {"v", "kind", "schema", "host_side"}):
        L.append(f"  {k}: {meta[k]}")

    L.append("")
    L.append("== per-phase time ==")
    L.append(f"  {'phase':<22s} {'count':>6s} {'total':>12s} "
             f"{'mean':>12s} {'share':>7s}")
    for p in s["phases"]:
        L.append(f"  {p['phase']:<22s} {p['count']:>6d} "
                 f"{_fmt_s(p['total_s']):>12s} {_fmt_s(p['mean_s']):>12s} "
                 f"{p['share'] * 100:6.1f}%")
    if not s["phases"]:
        L.append("  (no spans)")

    L.append("")
    L.append("== overlap pipeline ==")
    scheds = s["schedules"]
    if scheds:
        L.append(f"  {'walk':>5s} {'buckets':>8s} {'overlap':>8s} "
                 f"{'wall':>12s} {'issue occ':>10s} {'complete occ':>13s} "
                 f"{'gap':>7s}")
        for w in scheds:
            L.append(f"  {w['seq']:>5d} {w['n_buckets']:>8d} "
                     f"{str(w['overlap']):>8s} {_fmt_s(w['wall_s']):>12s} "
                     f"{w['issue_occ'] * 100:9.1f}% "
                     f"{w['complete_occ'] * 100:12.1f}% "
                     f"{w['gap'] * 100:6.1f}%")
    else:
        L.append("  (no plan.schedule walks in this trace)")

    L.append("")
    L.append("== measured vs predicted exchange ==")
    buckets = s["buckets"]
    if buckets:
        L.append(f"  {'bucket':>7s} {'wire':<32s} {'measured':>12s} "
                 f"{'alpha-beta pred':>16s} {'meas/pred':>10s}")
        for b in buckets:
            pred = (_fmt_s(b['predicted_s'])
                    if b['predicted_s'] is not None else "-")
            ratio = (f"{b['ratio']:.2f}x" if b['ratio'] is not None
                     else "-")
            L.append(f"  {b['bucket']:>7d} {b['label']:<32s} "
                     f"{_fmt_s(b['measured_s']):>12s} {pred:>16s} "
                     f"{ratio:>10s}")
        L.append("  (measured = host-side span time per walk; predicted ="
                 " comm_model collective_time per bucket message)")
    else:
        L.append("  (no bucketed walks in this trace)")

    L.append("")
    L.append("== steps / wire ==")
    st = s["steps"]
    L.append(f"  steps recorded: {st['n_steps']}")
    if "mean_payload_bytes" in st:
        ratio = st["mean_ratio_vs_f32"]
        L.append(f"  mean payload/replica: {st['mean_payload_bytes']:.1f} B"
                 f"  ratio vs f32: {ratio:.5f}"
                 f"  (paper ideal 1/32 = {st['ideal_ratio']:.5f}, "
                 f"{ratio / st['ideal_ratio']:.2f}x ideal)")
    if "mean_margin" in st:
        L.append(f"  mean vote margin: {st['mean_margin']:.4f}")
    if "mean_flip_fraction" in st:
        L.append(f"  mean flip-vs-oracle: {st['mean_flip_fraction']:.4f}")
    if "first_loss" in st:
        L.append(f"  loss: {st['first_loss']:.6g} -> "
                 f"{st['final_loss']:.6g}")

    L.append("")
    L.append("== counters ==")
    if s["counters"]:
        for k in sorted(s["counters"]):
            L.append(f"  {k:<40s} {s['counters'][k]:>14d}")
    else:
        L.append("  (no counters snapshot — recorder not closed?)")
    return "\n".join(L)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Aggregate an obs JSONL trace into a report "
                    "(DESIGN.md §13)")
    ap.add_argument("trace", help="JSONL trace written by "
                                  "obs.TraceRecorder (e.g. via --trace)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable aggregate instead")
    args = ap.parse_args(argv)
    if args.json:
        print(json.dumps(summarize(args.trace), indent=1, default=str))
    else:
        print(render(args.trace))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
