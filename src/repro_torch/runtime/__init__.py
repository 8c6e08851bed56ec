"""repro_torch.runtime: fault tolerance of the control loops.

Twin of ``repro/runtime/``, so far its ``fault`` module: ``StepGuard``
(bounded step retries with a restore hook) and the ``Heartbeat`` and
``StragglerMonitor`` EWMAs, which ``fabric.FabricManager`` reads.
``runtime/elastic.py`` comes with training (ROADMAP A.6).
"""
from repro_torch.runtime.fault import (RETRIABLE_STEP_ERRORS,  # noqa: F401
                                       Heartbeat, StepFailure, StepGuard,
                                       StragglerMonitor)

__all__ = ["StepGuard", "StepFailure", "StragglerMonitor", "Heartbeat",
           "RETRIABLE_STEP_ERRORS"]
