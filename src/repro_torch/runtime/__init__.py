"""repro_torch.runtime: fault tolerance of the control loops.

Twin of ``repro/runtime/``: ``fault`` (``StepGuard``, bounded step
retries with a restore hook, which ``launch/train.py`` drives, and the
``Heartbeat`` and ``StragglerMonitor`` EWMAs, which the training loop
and ``fabric.FabricManager`` read) and ``elastic`` (``plan_resize``).
"""
from repro_torch.runtime.fault import (RETRIABLE_STEP_ERRORS,  # noqa: F401
                                       Heartbeat, StepFailure, StepGuard,
                                       StragglerMonitor)
from repro_torch.runtime.elastic import (ResizePlan,  # noqa: F401
                                         largest_pow2_leq, plan_resize)

__all__ = ["StepGuard", "StepFailure", "StragglerMonitor", "Heartbeat",
           "RETRIABLE_STEP_ERRORS", "ResizePlan", "largest_pow2_leq",
           "plan_resize"]
