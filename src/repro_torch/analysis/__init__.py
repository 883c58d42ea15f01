"""Runtime invariant checks for the port's engine and queue layer (a copy
of the reference package's ``analysis/invariants.py``)."""
from repro_torch.analysis.invariants import (InvariantViolation,
                                             check_block_manager, check_engine,
                                             check_queue_layer,
                                             invariants_enabled)

__all__ = [
    "InvariantViolation",
    "check_block_manager",
    "check_engine",
    "check_queue_layer",
    "invariants_enabled",
]
