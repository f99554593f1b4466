"""Management: profiling (counterpart of ``p2pfl_tpu/management/``; its
logger, monitors and checkpointing come later in the port)."""
