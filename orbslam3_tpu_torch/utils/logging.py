"""Structured, throttled pipeline logging.

Copy of orbslam3_tpu/utils/logging.py: stdlib logging under the
"orbslam3_tpu_torch" namespace, level from ORBSLAM3_TPU_LOG (default
WARNING so library users aren't spammed; set INFO/DEBUG to watch a run).

Log emission must not force a device sync: everything logged here is
host-side state (counters, values a service round has already read), never
a fresh read of a device tensor.
"""
from __future__ import annotations

import logging
import os

_CONFIGURED = False


def get_logger(name: str = "orbslam3_tpu_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        level = os.environ.get("ORBSLAM3_TPU_LOG", "WARNING").upper()
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s",
                              "%H:%M:%S")
        )
        root = logging.getLogger("orbslam3_tpu_torch")
        root.addHandler(h)
        root.setLevel(getattr(logging, level, logging.WARNING))
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(name)


class Throttle:
    """Emit at most once per `every` calls."""

    def __init__(self, every: int = 100):
        self.every = every
        self.n = 0

    def ready(self) -> bool:
        self.n += 1
        return (self.n - 1) % self.every == 0
