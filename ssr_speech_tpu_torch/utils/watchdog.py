"""Deadlock/stall watchdog (the port's own copy of
``ssr_speech_tpu/utils/watchdog.py``; nothing in it is JAX-specific).

Capability parity with the reference ``DeadlockDetect``
(``audiocraft/audiocraft/utils/deadlock.py:18-58``): a watchdog thread is fed
stage beacons from the training loop (solvers/base.py:538-554); if no beacon
arrives within the timeout it dumps all python thread stacks and kills the
process so the job scheduler can restart it. Useful on multi-device jobs
where a wedged collective otherwise hangs forever.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import queue
import signal
import sys
import threading
from typing import Optional

logger = logging.getLogger(__name__)


class DeadlockDetect:
    """``update(stage)`` feeds the beacon; ``update(stage, next_timeout=T)``
    additionally grants the NEXT gap a longer allowance — XLA programs
    compile lazily per bucket shape (minutes on first contact), so loops
    beacon ``update("dispatch", next_timeout=grace)`` right before a call
    that may legitimately compile, and plain ``update("step")`` after."""

    def __init__(self, use: bool = False, timeout: float = 600.0):
        self.use = use
        self.timeout = timeout
        self._queue: "queue.Queue[tuple]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None

    def update(self, stage: str, next_timeout: Optional[float] = None):
        if self.use:
            self._queue.put((stage, next_timeout))

    def __enter__(self):
        if self.use:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self.use:
            self._queue.put(("exit", None))

    def _loop(self):
        timeout = self.timeout
        while True:
            try:
                stage, nxt = self._queue.get(timeout=timeout)
            except queue.Empty:
                logger.error(
                    "deadlock detected: no beacon for %.0fs, dumping stacks "
                    "and aborting", timeout,
                )
                faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
                os.kill(os.getpid(), signal.SIGKILL)
            else:
                if stage == "exit":
                    return
                timeout = nxt if nxt is not None else self.timeout
