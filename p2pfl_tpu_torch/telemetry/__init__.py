"""Federation telemetry plane of the port (framework-free copies of the JAX
package's ``telemetry/``): the process-wide metrics registry and its
exposition, distributed round tracing whose ids ride the PFLT frames, the
mergeable sketches and the health digests built on them, the fleet
observatory, the flight recorder, evidence bundles and their diagnosis, the
critical-path analysis over the span DAG, and the trajectory ledger both
execution backends emit.

The one piece that touches tensors is
:func:`~p2pfl_tpu_torch.telemetry.sketches.device_bucket_stats`, the device
observatory's on-device bucket statistics, written in torch.
"""

from p2pfl_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
)
from p2pfl_tpu_torch.telemetry.tracing import TRACER, Tracer  # noqa: F401
from p2pfl_tpu_torch.telemetry.critical_path import (  # noqa: F401
    CriticalPathAnalyzer,
)
from p2pfl_tpu_torch.telemetry.sketches import (  # noqa: F401
    DistinctEstimator,
    QuantileSketch,
    SKETCHES,
)
from p2pfl_tpu_torch.telemetry.ledger import (  # noqa: F401
    LEDGERS,
    TrajectoryLedger,
    canonical_params_hash,
)

__all__ = [
    "Counter",
    "CriticalPathAnalyzer",
    "DistinctEstimator",
    "Gauge",
    "Histogram",
    "LEDGERS",
    "MetricsRegistry",
    "QuantileSketch",
    "REGISTRY",
    "SKETCHES",
    "TRACER",
    "Tracer",
    "TrajectoryLedger",
    "canonical_params_hash",
]
