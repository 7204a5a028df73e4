"""Phase wall-clock profiler (port of rtjax.utils.profiler).

Prints ``<name>... done. (X ms)`` around a phase, the text of rtjax's
profiler, so that logs of the two packages compare line for line.  The
time is the host's clock: a phase that queues work on the card ends with
a host read (or ``torch.cuda.synchronize()``) inside it to count that
work.
"""

from __future__ import annotations

import contextlib
import time

from .log import logger


class Profiler:
    def __init__(self, verbose: bool = True):
        self.verbose = verbose
        self.records: dict[str, float] = {}
        self._name: str | None = None
        self._start = 0.0

    def start(self, name: str) -> None:
        if self._name is not None:
            raise RuntimeError("profiler phases cannot nest")
        self._name = name
        logger.debug("%s...", name)
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._name is None:
            raise RuntimeError("profiler not started")
        ms = (time.perf_counter() - self._start) * 1e3
        self.records[self._name] = self.records.get(self._name, 0.0) + ms
        if self.verbose:
            logger.info("%s... done. (%.0f ms)", self._name, ms)
        self._name = None
        return ms

    @contextlib.contextmanager
    def phase(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop()


# module-level default
profiler = Profiler()
