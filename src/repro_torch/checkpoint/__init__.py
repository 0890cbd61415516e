"""Checkpoints of run state (the twin of ``repro/checkpoint``)."""
