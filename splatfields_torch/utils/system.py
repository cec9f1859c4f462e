"""Filesystem helpers and the training watchdog (counterpart of
``splatfields_tpu/utils/system.py``).

The JAX module also holds ``enable_persistent_compile_cache`` and
``probe_backend``: a persistent XLA compile cache and a bounded probe of
the TPU backend. PyTorch runs eagerly on a local card, with no compile
cache and no remote backend to probe, so they have no counterpart here.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time


def mkdir_p(path: str):
    os.makedirs(path, exist_ok=True)


def search_for_max_iteration(folder: str):
    """The largest N of the ``iteration_N`` entries in ``folder``, or None
    (reference ``utils/system_utils.py:28-30``)."""
    if not os.path.isdir(folder):
        return None
    saved = [int(f.split("_")[-1]) for f in os.listdir(folder)
             if f.startswith("iteration_")]
    return max(saved) if saved else None


class StallWatchdog:
    """Exit the process with ``EXIT_CODE`` when the training loop stops
    making progress.

    A device call that hangs (a kernel that never returns, a wedged
    device) cannot be interrupted from Python, so recovery means leaving
    the process with a distinctive code and letting a supervisor restart
    it with ``--resume``, as ``scripts/train_supervised.sh`` does (the
    checkpoints make that lossless up to the last save). ``beat()`` is
    called once a loop iteration; a daemon thread checks every ``poll_s``
    seconds and, when no beat came for ``timeout_min`` minutes, prints one
    JSON line and calls ``exit_fn``. ``clock`` and ``exit_fn`` are
    injectable for tests.
    """

    EXIT_CODE = 114  # distinctive: supervisors restart with --resume

    def __init__(self, timeout_min: float, clock=None, exit_fn=None,
                 poll_s: float = 10.0):
        self._clock = clock or time.monotonic
        self._exit = exit_fn or (lambda: os._exit(self.EXIT_CODE))
        self._timeout_s = timeout_min * 60.0
        self._poll_s = poll_s
        self._last = self._clock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="StallWatchdog")

    def start(self):
        self._thread.start()
        return self

    def beat(self):
        self._last = self._clock()

    def stop(self):
        """Stop the thread and wait for it."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()

    def _run(self):
        while not self._stop.wait(self._poll_s):
            idle = self._clock() - self._last
            if idle > self._timeout_s:
                print(json.dumps({
                    "error": "training_stalled",
                    "environmental": True,
                    "idle_s": round(idle, 1),
                    # word for word the JAX package's line, which
                    # supervisors may match
                    "detail": "no training-loop progress; likely a hung "
                              "relay call (device dispatch or remote "
                              "compile). Restart with --resume.",
                }), flush=True)
                sys.stdout.flush()
                self._exit()
                return
