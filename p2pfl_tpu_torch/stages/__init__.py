"""Learning workflow: a stage machine over federated rounds (the port's copy of
``p2pfl_tpu/stages/``)."""

from p2pfl_tpu_torch.stages.stage import Stage, check_early_stop  # noqa: F401
from p2pfl_tpu_torch.stages.workflow import LearningWorkflow  # noqa: F401
