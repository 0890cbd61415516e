"""Long-running runs: chunked, checkpointed resume (``resume``); streaming
ingest (``ingest``); the serving loop's fault injection (``chaos``) and its
topology specs (``launcher``)."""
