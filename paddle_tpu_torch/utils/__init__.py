"""The pieces of ``paddle_tpu/utils`` the port needs: the fault-injection
layer (:mod:`.faults`, copied), the stall watchdog and the finite check
(:mod:`.watchdog`), and the profiler on ``torch.profiler``
(:mod:`.profiler`).
"""
from paddle_tpu_torch.utils.faults import (FAULTS,  # noqa: F401
                                           FaultRegistry, InjectedCrash,
                                           InjectedFault, fault_point,
                                           fault_value)
from paddle_tpu_torch.utils.profiler import (Profiler,  # noqa: F401
                                             StepTimer, device_memory_stats,
                                             dump_cost_analysis,
                                             record_event)
from paddle_tpu_torch.utils.watchdog import (StallWatchdog,  # noqa: F401
                                             WatchdogTrip, check_finite)
