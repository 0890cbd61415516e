"""Long-running runs: chunked, checkpointed resume (``resume``); streaming
ingest (``ingest``); the sweep fleet (``launcher``, ``worker``, ``fleet``:
sharded sweeps over supervised worker processes with leases and
heartbeats); seeded fault injection for the fleet and the serving loop
(``chaos``)."""
