"""Always-fresh subspace serving: a long-lived, self-healing PSA service.

* ``drift``: spectrum-drift detection on the ingestor's tracked Ritz state;
* ``query``: the batched project / reconstruct query path (deadlines, a
  bounded admission queue, explicit shedding, p50/p99 accounting);
* ``service``: the tick loop (ingest -> drift -> warm re-solve, chunked and
  crash-resumable -> quality gate -> atomic swap -> queries -> checkpoint),
  the supervisor (heartbeat watchdog, relaunch with backoff) and the
  seeded chaos smoke scenario.

The twin of ``repro/serving``; run ``python -m repro_torch.serving.service
--smoke --device cpu`` for the smoke scenario on the CPU.
"""
