"""The pieces of ``paddle_tpu/utils`` the port needs: the fault-injection
layer (:mod:`.faults`, copied), the stall watchdog and the finite check
(:mod:`.watchdog`), and the profiler on ``torch.profiler``
(:mod:`.profiler`).
"""
