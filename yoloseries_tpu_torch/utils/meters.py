"""Windowed meters; the part of ``yoloseries_tpu/utils/meters.py`` the
Trainer uses."""

from __future__ import annotations

from collections import defaultdict, deque

__all__ = ["AverageMeter", "MeterBuffer"]


class AverageMeter:
    def __init__(self, window: int = 50):
        self._window = deque(maxlen=window)

    def update(self, value):
        self._window.append(float(value))

    @property
    def latest(self):
        return self._window[-1] if self._window else 0.0

    @property
    def avg(self):
        return sum(self._window) / max(len(self._window), 1)


class MeterBuffer(defaultdict):
    def __init__(self, window: int = 50):
        super().__init__(lambda: AverageMeter(window))

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self[k].update(v)
