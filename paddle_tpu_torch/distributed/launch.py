"""Multi-process launcher — counterpart of
``paddle_tpu/distributed/launch.py`` (ref: ``python -m
paddle.distributed.launch``)::

    python -m paddle_tpu_torch.distributed.launch [--device cpu] train.py ...

One process per card: a launcher (``torchrun --nproc-per-node N``, or one
command per rank) starts the processes and this entry point joins them
into one process group (NCCL on the card, gloo with ``--device cpu``),
binds each to its card (``LOCAL_RANK``) and runs the script.

Env contract, the reference's: ``COORDINATOR_ADDRESS`` (host:port of
process 0, or a ``file://`` path shared by the processes),
``NUM_PROCESSES``, ``PROCESS_ID``; or torchrun's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``. With neither
set there is one process and nothing to join (a no-op, as the reference's
single host). Where the env names a world, a failed rendezvous raises: a
rank never trains alone in silence.
"""
from __future__ import annotations

import os
import runpy
import sys


def initialize_cluster(device=None):
    """Join the process group the env describes (idempotent); returns
    True when a group is up."""
    from paddle_tpu_torch.distributed import init_parallel_env
    return init_parallel_env(device=device)


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    device = None
    if argv[:1] == ["--device"]:
        device, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__)
        return 1
    initialize_cluster(device)
    script, *rest = argv
    sys.argv = [script] + rest
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
    runpy.run_path(script, run_name="__main__")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
