"""Observability utilities: structured step logs, phase timers, NaN guards."""

from gmpnp.utils.logging import StepLogger
from gmpnp.utils.profiling import PhaseTimer, trace_profile

__all__ = ["StepLogger", "PhaseTimer", "trace_profile"]
