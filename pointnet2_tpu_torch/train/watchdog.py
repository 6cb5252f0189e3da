"""Stall watchdog: turn a training process that stopped making progress
into an exit the supervisor retries.

The port's copy of pointnet2_tpu/train/watchdog.py:36-84. A daemon thread
checks a heartbeat that the train and eval loops beat between steps; if no
beat lands within ``timeout_s`` it logs the stall and exits the process
with :data:`EXIT_STALLED` (75, EX_TEMPFAIL). The trainer checkpoints every
N epochs and resumes exactly, so a supervisor (``cli.supervise``) restarts
the same command and the run goes on from its last checkpoint.

``os._exit`` (not ``sys.exit``): the main thread may be stuck in a native
call (a wedged device, a hung kernel), where an exception raised from the
watchdog thread would never reach it. ``timeout_s`` must exceed the slowest
stretch without a beat: the kernels' first build and a CUDA graph's capture
come before the first one. ``beat()`` costs one ``time.monotonic`` store.
"""

from __future__ import annotations

import os
import threading
import time

EXIT_STALLED = 75  # EX_TEMPFAIL: retryable, resume from the checkpoint

DEFAULT_TIMEOUT_S = 900.0


class Watchdog:
    def __init__(self, timeout_s: float = DEFAULT_TIMEOUT_S,
                 log_fn=print, label: str = "train",
                 _exit_fn=None):
        self.timeout_s = float(timeout_s)
        self._log = log_fn
        self._label = label
        self._exit = _exit_fn if _exit_fn is not None else os._exit
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"watchdog-{label}", daemon=True)
        self._thread.start()

    def beat(self) -> None:
        self._last = time.monotonic()

    def close(self) -> None:
        """Stop the thread and wait for it: a thread still waiting when the
        interpreter exits can abort the process (measured: exit 134 after a
        cli.train run with steps_per_call=2 on the CPU)."""
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _run(self) -> None:
        poll = max(1.0, min(10.0, self.timeout_s / 10.0))
        while not self._stop.wait(poll):
            idle = time.monotonic() - self._last
            if idle > self.timeout_s:
                try:
                    self._log(
                        f"WATCHDOG: no {self._label} progress for "
                        f"{idle:.0f}s (> {self.timeout_s:.0f}s); exiting "
                        f"{EXIT_STALLED} for a checkpoint resume")
                except Exception:
                    pass
                self._exit(EXIT_STALLED)
                return  # test stubs don't exit
