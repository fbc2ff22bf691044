"""Failure detection — counterpart of ``paddle_tpu/utils/watchdog.py``
(ref: Fleet elastic / ``paddle.distributed.fleet`` fault-tolerance hooks).

Two detectors:
  * NaN/inf sentinel — the Trainer skips poisoned updates on the device
    (see ``train/trainer.py``, ``nan_guard``) and raises
    :class:`WatchdogTrip` after N bad steps.
  * Stall watchdog — a host thread that trips if the step callback hasn't
    been poked within ``timeout_s`` (a hung step or collective), running
    an emergency callback before the main thread raises at its next
    :meth:`StallWatchdog.poke`.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from paddle_tpu_torch.observability.flight import FLIGHT


class WatchdogTrip(RuntimeError):
    pass


class StallWatchdog:
    def __init__(self, timeout_s: float = 600.0,
                 on_trip: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.on_trip = on_trip
        self._last_poke = time.monotonic()
        self._tripped = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, name="pt-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def poke(self):
        self._last_poke = time.monotonic()
        if self._tripped.is_set():
            raise WatchdogTrip(
                f"no progress for > {self.timeout_s}s (stalled step detected)")

    def _run(self):
        while not self._stop.wait(min(self.timeout_s / 4, 30.0)):
            if time.monotonic() - self._last_poke > self.timeout_s:
                self._tripped.set()
                # the trip is detected on THIS thread: record and dump here
                # so a hung main thread still leaves its flight file behind
                try:
                    FLIGHT.record("watchdog.trip", timeout_s=self.timeout_s)
                    FLIGHT.dump(reason="watchdog.trip")
                except Exception:
                    pass
                if self.on_trip:
                    try:
                        self.on_trip()
                    except Exception:
                        pass
                return

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    @property
    def tripped(self) -> bool:
        return self._tripped.is_set()


def _float_leaves(tree):
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from (t for t in tree.state_dict().values()
                    if t.is_floating_point())
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _float_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _float_leaves(v)


def check_finite(tree) -> bool:
    """Whether every float tensor of ``tree`` (a tensor, a module, or
    dicts / lists of them) is finite: one device reduction per device and
    ONE host read for the whole tree, not one per leaf."""
    flags = {}
    for t in _float_leaves(tree):
        ok = torch.isfinite(t).all()
        prev = flags.get(t.device)
        flags[t.device] = ok if prev is None else prev & ok
    if not flags:
        return True
    return bool(torch.stack([f.cpu() for f in flags.values()]).all())
