"""Hand-written CUDA kernels for Hopper, one module per Pallas kernel
file of the JAX package. Each wrapper launches its kernel on CUDA
tensors (or raises), runs its plain PyTorch version on CPU tensors, and
counts its launches in ``<wrapper>.launches``.

Importing this package builds nothing: sources compile at first launch
(:mod:`paddle_tpu_torch.ops.cuda._build`).
"""
from paddle_tpu_torch.ops.cuda import (flash_attention, norms,  # noqa: F401
                                       paged_attention)


SERVE_KERNELS = ("rms_norm", "flash_fwd", "paged_chunk", "paged_decode")
TRAIN_KERNELS = ("rms_norm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def kernels() -> dict:
    """{name: the function that counts its launches} of every kernel of
    the port: the serving path's, then the train step's backward."""
    return {
        "rms_norm": norms.rms_norm,
        "flash_fwd": flash_attention.flash_attention,
        "paged_chunk": paged_attention.paged_chunk_attention,
        "paged_decode": paged_attention.paged_decode_attention,
        "flash_bwd_dq": flash_attention.flash_bwd_dq,
        "flash_bwd_dkv": flash_attention.flash_bwd_dkv,
    }


def reset_launches():
    for fn in kernels().values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in kernels().items()}
