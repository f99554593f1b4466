"""Management: logging, metrics, resource monitoring, web telemetry,
profiling and checkpointing (counterpart of ``p2pfl_tpu/management/``)."""

__all__ = [
    "FLCheckpointer",
    "NodeJournal",
    "attach_node_checkpointing",
    "attach_node_journal",
]


def __getattr__(name: str):
    # Lazy, as in the JAX package: the logger / Node / CLI import paths do not
    # load the checkpoint module.
    if name in __all__:
        from p2pfl_tpu_torch.management import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
