"""The single-device part of ``paddle_tpu/distributed``: the MoE stack
(:mod:`.moe`). Meshes, tensor/pipeline/expert parallelism and the
collectives are queued (ROADMAP.md queue 1 item 7).
"""
