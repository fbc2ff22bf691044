"""The JAX-free pieces of ``paddle_tpu/utils`` the port needs, copied:
the fault-injection layer (:mod:`.faults`).
"""
