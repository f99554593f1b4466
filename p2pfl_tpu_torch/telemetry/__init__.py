"""Federation telemetry plane of the port (framework-free copies of the JAX
package's ``telemetry/``): the process-wide metrics registry, the PFLT
frames' trace-context slot, and the trajectory ledger both execution
backends emit.

The tracer, sketches, digests, observatory, flight recorder and
critical-path analysis are not ported yet.
"""

from p2pfl_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
)
