"""Command pattern: message names dispatched to handlers (the port's copy of
``p2pfl_tpu/comm/commands/``; the command implementations come with the
``Node``).

Parity with the reference's command set (SURVEY.md §2.3 "Commands (10)"
— p2pfl/communication/commands/): message commands (beat, start_learning,
stop_learning, model_initialized, vote_train_set, models_aggregated,
models_ready, metrics) and weights commands (init_model, partial_model,
full_model).
"""

from p2pfl_tpu_torch.comm.commands.command import Command, CommandDispatcher  # noqa: F401
