"""Training-side plumbing of the port.  Only the fault-tolerance pieces
that the durable session engine takes (``ft``) are ported so far."""
from repro_torch.train.ft import PreemptionGuard, StepTelemetry

__all__ = ["PreemptionGuard", "StepTelemetry"]
