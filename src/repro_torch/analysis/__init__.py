"""Runtime invariant checks for the port's engine and queue layer (a copy
of the reference package's ``analysis/invariants.py``), and ``lint``, the
port's static analysis (the reference's qlint with torch's host syncs:
``python -m repro_torch.analysis.lint``)."""
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
