"""Wall-clock-adaptive image-logging throttle.

Own copy of ``denoising_diffusion_deep_fake_tpu/utils/logging_scheduler.py``
(the reference's ``d3f/helpers/logging_scheduler.py``): log every 10 s during
the first minute of training, every minute until 15 min, every 10 min until
2 h, hourly after; the decision is keyed on the global step changing.
``log_this_step`` starts False, and the clock is injectable for tests.
"""

from __future__ import annotations

import time
from typing import Callable

_SECONDS = 1.0
_MINUTES = 60.0
_HOURS = 3600.0


class LoggingScheduler:
    def __init__(self, clock: Callable[[], float] = time.time):
        self._clock = clock
        self._start_time = clock()
        self._last_log_time = self._start_time
        self._last_step: int | None = None
        self._log_this_step = False

    def interval_for_elapsed(self, elapsed_since_start: float) -> float:
        if elapsed_since_start < 1 * _MINUTES:
            return 10 * _SECONDS
        if elapsed_since_start < 15 * _MINUTES:
            return 1 * _MINUTES
        if elapsed_since_start < 2 * _HOURS:
            return 10 * _MINUTES
        return 1 * _HOURS

    def update_with_step_number(self, global_step: int) -> None:
        if global_step == self._last_step:
            return
        self._last_step = global_step
        now = self._clock()
        interval = self.interval_for_elapsed(now - self._start_time)
        if now - self._last_log_time > interval:
            self._last_log_time = now
            self._log_this_step = True
        else:
            self._log_this_step = False

    def should_we_log_this_step(self) -> bool:
        return self._log_this_step
