"""Management: logging, metrics, resource monitoring, web telemetry and
profiling (counterpart of ``p2pfl_tpu/management/``; checkpointing and the
node journal come with queue A item 11)."""
