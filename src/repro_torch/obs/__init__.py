"""Out-of-band observability: the span/event journal and the metrics
registry.

The port's copy of ``repro/obs/__init__.py``. Host-side file appends
only, so device math gives the same bits with tracing on or off:

* ``journal``: crash-safe append-only JSONL span/event journals, one per
  process attempt, with a torn-tail-tolerant reader;
* ``registry``: counters, gauges and bucketed histograms with p50/p99 and
  a Prometheus-style exposition, dumped in the reference's format;
* ``cli`` (``python -m repro_torch.obs``): timeline, summary, exposition,
  forensics and gantt over a directory of journals.

Long-lived components (the serving loop) call ``install(workdir, proc)``
once at startup: it opens an attempt-scoped journal under
``obs_dir_for(workdir)`` (default ``<workdir>/obs``; ``REPRO_OBS_DIR``
overrides it, ``REPRO_OBS=0`` turns everything off) and a fresh process
registry that the journal feeds span durations into. Library seams (the
runtime's chunk driver, the checkpoint manager, the chaos hooks) fetch the
current journal with ``get_journal()``: a no-op unless something installed
or set one.
"""
from __future__ import annotations

import os
from typing import Optional

from .journal import (ENV_DIR, ENV_OBS, Journal, Span, merge_journals,
                      read_journal)
from .registry import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Journal", "Span", "read_journal", "merge_journals", "Counter", "Gauge",
           "Histogram", "MetricsRegistry", "get_journal", "set_journal",
           "metrics", "install", "obs_dir_for", "ENV_DIR", "ENV_OBS"]

_journal: Journal = Journal.noop()
_registry: MetricsRegistry = MetricsRegistry()


def get_journal() -> Journal:
    """The process journal (a disabled no-op unless one was installed)."""
    return _journal


def set_journal(journal: Journal) -> Journal:
    global _journal
    _journal = journal
    return journal


def metrics() -> MetricsRegistry:
    """The process metrics registry (always usable; reset by ``install``)."""
    return _registry


def obs_dir_for(workdir: str) -> Optional[str]:
    """Where a component rooted at ``workdir`` journals: None when
    ``REPRO_OBS`` is 0/off/false, else ``REPRO_OBS_DIR`` or
    ``<workdir>/obs``."""
    if os.environ.get(ENV_OBS, "").lower() in ("0", "off", "false"):
        return None
    return os.environ.get(ENV_DIR) or os.path.join(workdir, "obs")


def install(workdir: str, proc: str, **static) -> Journal:
    """Open (and make current) an attempt-scoped journal for this process
    and a fresh metrics registry wired into it (span durations feed
    ``span_<name>_seconds``). Returns the journal: a disabled no-op when
    observability is off."""
    global _registry
    _registry = MetricsRegistry()
    obs_dir = obs_dir_for(workdir)
    if obs_dir is None:
        return set_journal(Journal.noop())
    return set_journal(Journal.open(obs_dir, proc, registry=_registry,
                                    **static))
