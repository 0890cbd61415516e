"""Crash-safe, append-only JSONL span/event journal.

The port's copy of ``repro/obs/journal.py``: it writes the same record
format and names, so one reader serves journals of both packages
(``read_journal``, and ``merge_journals`` for a directory of them). One journal is one process
attempt: a ``<proc>.a<attempt>.jsonl`` file under an observability
directory, so a relaunched process opens a new file instead of clobbering
its predecessor's. Every record is one JSON object on one line, written
with a single ``os.write`` to an ``O_APPEND`` descriptor: concurrent
writers (the async checkpoint thread) interleave whole lines, and a kill
tears at most the last line, which ``read_journal`` skips.

Record keys: ``ts`` (wall clock), ``mono`` (monotonic clock), ``proc``,
``pid``, ``attempt``, ``kind`` ("event" | "span_start" | "span"), ``name``,
``phase``, then the caller's fields (a field named like one of the first
seven is written as ``f_<name>``). A span is two records sharing a ``sid``:
``span_start`` at entry and ``span`` with ``dur_s`` and ``ok`` at exit; a
process that dies inside a span leaves its ``span_start`` without a match.

The journal only appends lines on the host, so it never changes what the
device computes, and the disabled journal (``Journal.noop()``) costs one
attribute check per call site. A journal opened with ``registry=`` (an
``obs.registry.MetricsRegistry``) also observes every closed span's
duration into that registry's ``span_<name>_seconds`` histogram, as the
reference's does.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Journal", "Span", "read_journal", "merge_journals",
           "journal_files", "ENV_DIR", "ENV_OBS"]

ENV_DIR = "REPRO_OBS_DIR"   # where journals go (overrides <workdir>/obs)
ENV_OBS = "REPRO_OBS"       # "0"/"off" disables journaling entirely
_FILE_RE = re.compile(r"^(?P<proc>.+)\.a(?P<attempt>\d+)\.jsonl$")
_RESERVED = frozenset({"ts", "mono", "proc", "pid", "attempt", "kind",
                       "name"})


def _coerce(v):
    """Encoder hook for values json cannot encode: numpy and torch scalars
    and small arrays."""
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return str(v)


_ENCODER = json.JSONEncoder(separators=(",", ":"), default=_coerce)


class Span:
    """An open span; ``end()`` (or leaving the ``with`` block) writes the
    closing record once."""

    __slots__ = ("_j", "name", "phase", "sid", "_t0", "_fields", "_done")

    def __init__(self, journal: "Journal", name: str, phase: Optional[str],
                 sid: int, fields: Dict[str, Any]):
        self._j = journal
        self.name = name
        self.phase = phase
        self.sid = sid
        self._fields = fields
        self._done = False
        self._t0 = time.monotonic()

    def add(self, **fields) -> "Span":
        """Attach fields to the closing record (a result computed
        mid-span)."""
        self._fields.update(fields)
        return self

    def end(self, ok: bool = True, **fields) -> None:
        if self._done:
            return
        self._done = True
        self._fields.update(fields)
        self._j._write("span", self.name, self.phase, sid=self.sid,
                       dur_s=round(time.monotonic() - self._t0, 6),
                       ok=bool(ok), **self._fields)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end(ok=exc_type is None)
        return False


class _NoopSpan:
    __slots__ = ()

    def add(self, **fields):
        return self

    def end(self, ok=True, **fields):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NOOP_SPAN = _NoopSpan()


class Journal:
    """Append-only JSONL writer for one process attempt."""

    def __init__(self, path: Optional[str], proc: str, attempt: int = 0,
                 *, registry=None, **static):
        self.path = path
        self.proc = proc
        self.attempt = int(attempt)
        self.registry = registry
        self.enabled = path is not None
        self._static = {k: v for k, v in static.items() if v is not None}
        self._pid = os.getpid()
        self._sid = 0
        self._fd = None
        if self.enabled:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                               0o644)

    @classmethod
    def noop(cls) -> "Journal":
        return cls(None, proc="noop")

    @classmethod
    def open(cls, obs_dir: str, proc: str, *, attempt: Optional[int] = None,
             registry=None, **static) -> "Journal":
        """Open the next attempt-scoped journal for ``proc`` in ``obs_dir``
        (``attempt=None`` takes one past the highest found there)."""
        os.makedirs(obs_dir, exist_ok=True)
        if attempt is None:
            prev = [-1]
            for name in os.listdir(obs_dir):
                m = _FILE_RE.match(name)
                if m and m.group("proc") == proc:
                    prev.append(int(m.group("attempt")))
            attempt = max(prev) + 1
        path = os.path.join(obs_dir, f"{proc}.a{int(attempt)}.jsonl")
        return cls(path, proc, attempt, registry=registry, **static)

    def _write(self, kind: str, name: str, phase: Optional[str], /,
               **fields) -> None:
        if not self.enabled:
            return
        rec = {"ts": round(time.time(), 6),
               "mono": round(time.monotonic(), 6),
               "proc": self.proc, "pid": self._pid,
               "attempt": self.attempt, "kind": kind, "name": name}
        if phase is not None:
            rec["phase"] = phase
        rec.update(self._static)
        for k, v in fields.items():
            if v is not None:
                rec["f_" + k if k in _RESERVED else k] = v
        try:
            os.write(self._fd, (_ENCODER.encode(rec) + "\n").encode())
        except (OSError, TypeError, ValueError):
            pass                                 # observability never raises
        if kind == "span" and self.registry is not None:
            self.registry.histogram(
                f"span_{name}_seconds").observe(fields.get("dur_s", 0.0))

    def event(self, name: str, phase: Optional[str] = None, /,
              **fields) -> None:
        self._write("event", name, phase, **fields)

    def begin(self, name: str, phase: Optional[str] = None, /, **fields):
        """Write ``span_start`` now; the returned span's ``end()`` writes
        the closing ``span`` record with ``dur_s``."""
        if not self.enabled:
            return _NOOP_SPAN
        self._sid += 1
        self._write("span_start", name, phase, sid=self._sid, **fields)
        return Span(self, name, phase, self._sid, dict(fields))

    def span(self, name: str, phase: Optional[str] = None, /, **fields):
        """Context-manager form of ``begin``."""
        return self.begin(name, phase, **fields)

    def close(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
            self.enabled = False


def read_journal(path: str) -> List[dict]:
    """Every decodable record of one journal file, in write order; a torn
    or undecodable line is skipped."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return []
    out: List[dict] = []
    for line in data.split(b"\n"):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except (ValueError, UnicodeDecodeError):
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def journal_files(obs_dir: str) -> List[Tuple[str, str, int]]:
    """(path, proc, attempt) for every journal in ``obs_dir``, sorted by
    (proc, attempt)."""
    out = []
    try:
        names = os.listdir(obs_dir)
    except OSError:
        return out
    for name in names:
        m = _FILE_RE.match(name)
        if m:
            out.append((os.path.join(obs_dir, name), m.group("proc"),
                        int(m.group("attempt"))))
    return sorted(out, key=lambda t: (t[1], t[2]))


def merge_journals(obs_dir: str) -> List[dict]:
    """Every record of every per-process journal in ``obs_dir``, merged
    into ONE timeline ordered by wall clock (stable: ties keep per-file
    write order, which monotonic stamps preserve within a process)."""
    records: List[dict] = []
    for path, proc, attempt in journal_files(obs_dir):
        for i, rec in enumerate(read_journal(path)):
            rec.setdefault("proc", proc)
            rec.setdefault("attempt", attempt)
            rec["_order"] = i
            records.append(rec)
    records.sort(key=lambda r: (r.get("ts", 0.0), r.get("proc", ""),
                                r["_order"]))
    for rec in records:
        rec.pop("_order", None)
    return records
