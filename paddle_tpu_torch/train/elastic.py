"""Elastic / fault-tolerant training — counterpart of
``paddle_tpu/train/elastic.py`` (ref ``paddle.distributed.fleet.elastic``
and the Fleet controller's restart loop).

Elasticity here means: checkpoint continuously, detect failure (an
exception, a stall, a NaN storm), restore the LATEST checkpoint into a
FRESH trainer and continue — bounded restarts with backoff. Host logic
over the eager step, on the port's :class:`StallWatchdog` and FLIGHT.

Under a mesh every rank runs the runner with the same ``make_trainer``;
the checkpoint's saves and restores are collective, and a save that
fails on its writing rank fails on every rank, so the ranks restart
together. A failure that only one rank sees leaves the others waiting in
the step's next collective.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from paddle_tpu_torch.observability import METRICS, instant as _trace_instant
from paddle_tpu_torch.observability.flight import FLIGHT
from paddle_tpu_torch.utils.watchdog import StallWatchdog, WatchdogTrip

__all__ = ["ElasticRunner", "run_elastic"]

_RESTARTS = METRICS.counter(
    "elastic_restarts_total", "elastic restarts taken after a failure")
_GIVEUPS = METRICS.counter(
    "elastic_giveups_total", "elastic runs abandoned at the restart cap")


class ElasticRunner:
    def __init__(self, make_trainer: Callable[[], "Trainer"],
                 max_restarts: int = 3, backoff_s: float = 5.0,
                 stall_timeout_s: Optional[float] = None):
        self.make_trainer = make_trainer
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.stall_timeout_s = stall_timeout_s
        self.restarts = 0
        self.failures: list[str] = []

    def run(self, data_fn: Callable[[], object], eval_fn=None):
        """``data_fn`` returns a FRESH data iterator per (re)start; the
        trainer's resume fast-forwards it by the restored step count."""
        while True:
            dog = None
            try:
                # resume inside the restart net: restore already falls back
                # past corrupt checkpoints, and a wholly unrestorable state
                # still gets bounded retries
                trainer = self.make_trainer().resume()
                trainer.args.resume_reskip = True
                if self.stall_timeout_s and not trainer.args.ckpt_every:
                    import warnings
                    warnings.warn(
                        "ElasticRunner: stall_timeout_s is set but "
                        "ckpt_every=0 — a stall restart would lose ALL "
                        "progress. Set TrainerArgs(ckpt_every=N) so recovery "
                        "has checkpoints.")
                if self.stall_timeout_s:
                    # no emergency save on a trip: the hung step's state is
                    # not safe to read from the watchdog thread; recovery
                    # comes from the periodic ckpt_every saves
                    dog = StallWatchdog(self.stall_timeout_s).start()
                    trainer.watchdog = dog
                return trainer.fit(data_fn(), eval_fn=eval_fn)
            except (WatchdogTrip, FloatingPointError, RuntimeError) as e:
                self.failures.append(f"{type(e).__name__}: {e}")
                self.restarts += 1
                _RESTARTS.inc()
                _trace_instant("elastic.restart", restart=self.restarts,
                               cause=type(e).__name__)
                FLIGHT.record("elastic.restart", restart=self.restarts,
                              cause=type(e).__name__)
                if self.restarts > self.max_restarts:
                    _GIVEUPS.inc()
                    FLIGHT.record("elastic.giveup", restarts=self.restarts,
                                  cause=type(e).__name__)
                    FLIGHT.dump(reason="elastic.giveup")
                    raise RuntimeError(
                        f"elastic: gave up after {self.max_restarts} "
                        f"restarts; failures={self.failures}") from e
                time.sleep(self.backoff_s)
            finally:
                if dog is not None:
                    dog.stop()


def run_elastic(make_trainer, data_fn, max_restarts=3, backoff_s=5.0,
                stall_timeout_s=None, eval_fn=None):
    return ElasticRunner(make_trainer, max_restarts, backoff_s,
                         stall_timeout_s).run(data_fn, eval_fn=eval_fn)
