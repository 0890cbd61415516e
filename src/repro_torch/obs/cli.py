"""Run-forensics CLI over per-process span journals: the twin of
``repro/obs/cli.py``, printing the same text from the same journals.

    python -m repro_torch.obs timeline  <dir>   # merged, ordered timeline
    python -m repro_torch.obs summary   <dir>   # per-phase durations
    python -m repro_torch.obs prom      <dir>   # Prometheus exposition
    python -m repro_torch.obs forensics <dir> [--plan plan.json] [--last N]
    python -m repro_torch.obs gantt     <dir>   # plain-text Gantt

``<dir>`` is an observability directory (``*.jsonl`` journals) or a
workdir containing one under ``obs/``. All commands are pure readers —
they never touch the run's own files.

``forensics`` reconstructs, for every process attempt, the spans still
OPEN at the end of its journal (the phase a dead worker was in when it
died) and its last N records; with ``--plan`` it additionally attributes
every fault of a chaos ``FaultPlan`` to the journal record of its firing
(kind, process, boundary, enclosing phase) and exits non-zero if any
injected fault left no trace.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from .journal import journal_files, merge_journals, read_journal
from .registry import MetricsRegistry

__all__ = ["main", "resolve_obs_dir", "phase_summary", "forensics_report",
           "render_gantt", "build_exposition"]


def resolve_obs_dir(path: str) -> str:
    """Accept either an obs dir itself or a workdir containing ``obs/``."""
    if os.path.isdir(path) and journal_files(path):
        return path
    sub = os.path.join(path, "obs")
    if os.path.isdir(sub) and journal_files(sub):
        return sub
    raise SystemExit(f"{path}: no journals found (looked for *.jsonl in it "
                     f"and in {sub})")


def _fmt_fields(rec: dict, skip=("ts", "mono", "proc", "pid", "attempt",
                                 "kind", "name", "phase", "sid")) -> str:
    return " ".join(f"{k}={rec[k]}" for k in rec if k not in skip)


def _percentile(vals: List[float], p: float) -> float:
    vals = sorted(vals)
    if not vals:
        return 0.0
    i = min(len(vals) - 1, max(0, int(round(p / 100.0 * (len(vals) - 1)))))
    return vals[i]


# ---------------------------------------------------------------------------
# timeline
# ---------------------------------------------------------------------------
def render_timeline(obs_dir: str, limit: Optional[int] = None) -> str:
    records = merge_journals(obs_dir)
    if not records:
        return "(empty timeline)\n"
    t0 = records[0].get("ts", 0.0)
    lines = []
    for rec in records[-limit:] if limit else records:
        who = f"{rec.get('proc', '?')}.a{rec.get('attempt', 0)}"
        phase = f" [{rec['phase']}]" if "phase" in rec else ""
        dur = f" dur={rec['dur_s']:.4f}s" if "dur_s" in rec else ""
        lines.append(f"+{rec.get('ts', t0) - t0:9.3f}s  {who:<18} "
                     f"{rec.get('kind', '?'):<10} {rec.get('name', '?')}"
                     f"{phase}{dur}  {_fmt_fields(rec)}".rstrip())
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# per-phase summaries
# ---------------------------------------------------------------------------
def phase_summary(records: List[dict]) -> Dict[Tuple[str, str], dict]:
    """(phase, name) -> {count, total_s, mean_s, p50_s, p99_s} over closed
    spans, plus event counts under a ``count``-only entry."""
    durs: Dict[Tuple[str, str], List[float]] = {}
    events: Dict[Tuple[str, str], int] = {}
    for rec in records:
        key = (rec.get("phase", "-"), rec.get("name", "?"))
        if rec.get("kind") == "span":
            durs.setdefault(key, []).append(float(rec.get("dur_s", 0.0)))
        elif rec.get("kind") == "event":
            events[key] = events.get(key, 0) + 1
    out: Dict[Tuple[str, str], dict] = {}
    for key, vals in durs.items():
        out[key] = {"count": len(vals), "total_s": sum(vals),
                    "mean_s": sum(vals) / len(vals),
                    "p50_s": _percentile(vals, 50),
                    "p99_s": _percentile(vals, 99)}
    for key, n in events.items():
        out.setdefault(key, {"count": 0})["events"] = n
    return out


def render_summary(obs_dir: str) -> str:
    summary = phase_summary(merge_journals(obs_dir))
    if not summary:
        return "(no records)\n"
    head = (f"{'phase':<12} {'name':<22} {'spans':>6} {'total_s':>9} "
            f"{'mean_s':>9} {'p50_s':>9} {'p99_s':>9} {'events':>7}")
    lines = [head, "-" * len(head)]
    for (phase, name), s in sorted(summary.items()):
        if s.get("count"):
            lines.append(
                f"{phase:<12} {name:<22} {s['count']:>6} "
                f"{s['total_s']:>9.4f} {s['mean_s']:>9.5f} "
                f"{s['p50_s']:>9.5f} {s['p99_s']:>9.5f} "
                f"{s.get('events', ''):>7}")
        else:
            lines.append(f"{phase:<12} {name:<22} {'':>6} {'':>9} {'':>9} "
                         f"{'':>9} {'':>9} {s.get('events', 0):>7}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# prometheus exposition
# ---------------------------------------------------------------------------
def build_exposition(obs_dir: str) -> MetricsRegistry:
    """One registry for the whole run: every ``metrics.*.json`` registry
    dump merged, plus journal-derived metrics (span-duration histograms
    and event counters) so a run with no dumps still exposes its trace."""
    reg = MetricsRegistry()
    for name in sorted(os.listdir(obs_dir)):
        if name.startswith("metrics.") and name.endswith(".json"):
            try:
                with open(os.path.join(obs_dir, name)) as f:
                    reg.merge_snapshot(json.load(f))
            except (OSError, ValueError):
                continue
    for rec in merge_journals(obs_dir):
        if rec.get("kind") == "span":
            reg.histogram(
                f"span_{rec.get('name', '?')}_seconds").observe(
                    float(rec.get("dur_s", 0.0)))
        elif rec.get("kind") == "event":
            reg.counter(f"event_{rec.get('name', '?')}_total").inc()
    return reg


# ---------------------------------------------------------------------------
# forensics
# ---------------------------------------------------------------------------
def _file_forensics(path: str) -> dict:
    """Per-journal reconstruction: chronological records, the span stack,
    spans still open at EOF, and chaos firings with their enclosing
    phase."""
    records = read_journal(path)
    open_spans: Dict[int, dict] = {}
    order: List[int] = []
    firings: List[dict] = []
    for rec in records:
        kind = rec.get("kind")
        if kind == "span_start" and "sid" in rec:
            open_spans[rec["sid"]] = rec
            order.append(rec["sid"])
        elif kind == "span" and rec.get("sid") in open_spans:
            del open_spans[rec["sid"]]
            order = [s for s in order if s in open_spans]
        elif kind == "event" and rec.get("name") == "chaos_fired":
            encl = open_spans.get(order[-1]) if order else None
            firings.append({
                "rec": rec,
                "in_span": None if encl is None else encl.get("name"),
                "in_phase": None if encl is None else encl.get("phase"),
            })
    return {"records": records,
            "open": [open_spans[s] for s in order],
            "firings": firings}


def forensics_report(obs_dir: str, *, last: int = 10,
                     proc: Optional[str] = None,
                     plan_path: Optional[str] = None) -> Tuple[str, bool]:
    """(report text, ok). ``ok`` is False when a ``--plan`` fault has no
    attributable firing in any journal."""
    lines: List[str] = []
    all_firings: List[dict] = []
    files = journal_files(obs_dir)
    if proc:
        files = [f for f in files if f[1] == proc]
    for path, fproc, attempt in files:
        fx = _file_forensics(path)
        all_firings.extend(dict(f, proc=fproc, attempt=attempt)
                           for f in fx["firings"])
        records = fx["records"]
        if not records:
            lines.append(f"== {fproc}.a{attempt}: empty journal ==")
            continue
        t0 = records[0].get("ts", 0.0)
        if fx["open"]:
            state = "died during " + " > ".join(
                f"{s.get('name')}[{s.get('phase', '-')}]"
                for s in fx["open"])
        else:
            state = "no open spans at end of journal"
        lines.append(f"== {fproc}.a{attempt} — {state} ==")
        for rec in records[-last:]:
            phase = f" [{rec['phase']}]" if "phase" in rec else ""
            dur = f" dur={rec['dur_s']:.4f}s" if "dur_s" in rec else ""
            lines.append(f"  +{rec.get('ts', t0) - t0:8.3f}s "
                         f"{rec.get('kind', '?'):<10} "
                         f"{rec.get('name', '?')}{phase}{dur}  "
                         f"{_fmt_fields(rec)}".rstrip())
    ok = True
    if plan_path is not None:
        with open(plan_path) as f:
            plan = json.load(f)
        faults = plan.get("faults", [])
        lines.append("")
        lines.append(f"fault attribution ({len(faults)} planned):")
        for idx, fault in enumerate(faults):
            hits = [f for f in all_firings
                    if f["rec"].get("fault") == idx]
            tgt = ",".join(f"{k}={fault[k]}" for k in ("shard", "worker")
                           if k in fault)
            if not hits:
                ok = False
                lines.append(f"  fault #{idx} {fault.get('kind')}({tgt}) "
                             f"-> NO TRACE (unattributed)")
                continue
            for h in hits[:3]:
                rec = h["rec"]
                where = (f"{h['in_span']}/{h['in_phase']}"
                         if h["in_span"] else "top-level")
                lines.append(
                    f"  fault #{idx} {fault.get('kind')}({tgt}) -> "
                    f"{h['proc']}.a{h['attempt']} "
                    f"boundary={rec.get('boundary', rec.get('step', '?'))} "
                    f"during {where}")
            if len(hits) > 3:
                lines.append(f"    ... {len(hits) - 3} more firings")
        n_hit = sum(1 for i in range(len(faults))
                    if any(f["rec"].get("fault") == i for f in all_firings))
        lines.append(f"  {n_hit}/{len(faults)} plan faults attributed")
    return "\n".join(lines) + "\n", ok


# ---------------------------------------------------------------------------
# plain-text gantt
# ---------------------------------------------------------------------------
def render_gantt(obs_dir: str, width: int = 64) -> str:
    """One row per process attempt over the merged wall-clock range:
    ``█`` = inside a span, ``·`` = alive (records exist), ``X`` = a chaos
    fault fired in that column. Straggler shards and steals read directly
    off the row lengths."""
    files = journal_files(obs_dir)
    rows = []
    t_min, t_max = float("inf"), float("-inf")
    for path, proc, attempt in files:
        records = read_journal(path)
        if not records:
            continue
        ts = [r.get("ts", 0.0) for r in records]
        t_min, t_max = min(t_min, min(ts)), max(t_max, max(ts))
        spans, chaos = [], []
        open_at: Dict[int, float] = {}
        for rec in records:
            kind = rec.get("kind")
            if kind == "span_start" and "sid" in rec:
                open_at[rec["sid"]] = rec.get("ts", 0.0)
            elif kind == "span":
                end = rec.get("ts", 0.0)
                start = open_at.pop(rec.get("sid"), end
                                    - float(rec.get("dur_s", 0.0)))
                spans.append((start, end))
            elif kind == "event" and rec.get("name") == "chaos_fired":
                chaos.append(rec.get("ts", 0.0))
        # spans never closed run to the journal's end (death mid-span)
        spans.extend((t, max(ts)) for t in open_at.values())
        rows.append((f"{proc}.a{attempt}", min(ts), max(ts), spans, chaos))
    if not rows:
        return "(no journals)\n"
    scale = (t_max - t_min) or 1.0

    def col(t: float) -> int:
        return min(width - 1, max(0, int((t - t_min) / scale * width)))

    label_w = max(len(r[0]) for r in rows) + 2
    out = [f"{'':<{label_w}}|{'-' * width}| {scale:.2f}s total"]
    for name, lo, hi, spans, chaos in rows:
        cells = [" "] * width
        for c in range(col(lo), col(hi) + 1):
            cells[c] = "·"
        for s, e in spans:
            for c in range(col(s), col(e) + 1):
                cells[c] = "█"
        for t in chaos:
            cells[col(t)] = "X"
        out.append(f"{name:<{label_w}}|{''.join(cells)}|")
    out.append(f"{'':<{label_w}} █ span   · alive   X chaos fault fired")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("timeline", "summary", "prom", "gantt"):
        p = sub.add_parser(name)
        p.add_argument("dir", help="obs dir (or a workdir containing obs/)")
        if name == "timeline":
            p.add_argument("--last", type=int, default=None,
                           help="only the last N records")
        if name == "gantt":
            p.add_argument("--width", type=int, default=64)
    pf = sub.add_parser("forensics")
    pf.add_argument("dir")
    pf.add_argument("--last", type=int, default=10,
                    help="records of each journal tail to show")
    pf.add_argument("--proc", default=None,
                    help="only this process's journals")
    pf.add_argument("--plan", default=None,
                    help="chaos plan JSON: attribute every fault, exit 1 "
                         "if any left no trace")
    args = ap.parse_args(argv)
    obs_dir = resolve_obs_dir(args.dir)
    if args.cmd == "timeline":
        sys.stdout.write(render_timeline(obs_dir, limit=args.last))
    elif args.cmd == "summary":
        sys.stdout.write(render_summary(obs_dir))
    elif args.cmd == "prom":
        sys.stdout.write(build_exposition(obs_dir).to_prom())
    elif args.cmd == "gantt":
        sys.stdout.write(render_gantt(obs_dir, width=args.width))
    elif args.cmd == "forensics":
        text, ok = forensics_report(obs_dir, last=args.last, proc=args.proc,
                                    plan_path=args.plan)
        sys.stdout.write(text)
        return 0 if ok else 1
    return 0
