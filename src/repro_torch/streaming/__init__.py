"""Long-running runs: chunked, checkpointed resume (``resume``)."""
