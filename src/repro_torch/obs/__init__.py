"""Out-of-band tracing: the process's span/event journal.

``get_journal()`` is what the runtime's chunk driver and the checkpoint
manager write to: a disabled no-op unless a caller ``set_journal``s an open
one (``Journal.open(obs_dir, proc)``). The metrics registry and the CLI of
``repro/obs`` come with the streaming slice of the port.
"""
from __future__ import annotations

from .journal import Journal, Span, read_journal

__all__ = ["Journal", "Span", "read_journal", "get_journal", "set_journal"]

_journal: Journal = Journal.noop()


def get_journal() -> Journal:
    """The process journal (a disabled no-op unless one was set)."""
    return _journal


def set_journal(journal: Journal) -> Journal:
    global _journal
    _journal = journal
    return journal
