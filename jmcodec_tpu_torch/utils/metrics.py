"""Logging, counters and stage timers of the host side.

A logger with one level from the JMX_LOG environment variable, process-wide
named counters (frames decoded on the device, corrupt pictures dropped,
...), per-stage wall timers and a device trace context. A stage that
launches device work measures the host's issue of it, not the device's
time: launches are asynchronous, so a device figure needs
torch.cuda.synchronize() around it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

_level = os.environ.get("JMX_LOG", "WARNING").upper()
logger = logging.getLogger("jmcodec_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
logger.setLevel(getattr(logging, _level, logging.WARNING))


class Counters:
    """Process-wide named counters (frames, bytes, collective bytes, ...)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c: Dict[str, float] = defaultdict(float)

    def add(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._c[name] += value

    def get(self, name: str) -> float:
        return self._c.get(name, 0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._c)

    def report(self) -> str:
        return " ".join(f"{k}={v:g}" for k, v in sorted(self.snapshot().items()))


counters = Counters()


class StageTimers:
    """Accumulating per-stage wall timers (host_parse, device_recon, d2h,
    ...). device_recon times the host's issue of the launches, which are
    asynchronous; d2h includes the wait for the device to finish."""

    def __init__(self):
        self._t: Dict[str, float] = defaultdict(float)
        self._n: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._t[name] += dt
            self._n[name] += 1

    def report(self) -> str:
        parts = []
        for k in sorted(self._t):
            n = max(1, self._n[k])
            parts.append(f"{k}: {self._t[k]*1000:.1f}ms/{self._n[k]}x "
                         f"({self._t[k]/n*1000:.2f}ms avg)")
        return " | ".join(parts)

    def snapshot(self) -> Dict[str, float]:
        """Accumulated seconds per stage (for before/after diffs in
        benches: the session fps numbers become attributable)."""
        return dict(self._t)


timers = StageTimers()


@contextlib.contextmanager
def device_trace(out_dir: Optional[str] = None) -> Iterator[None]:
    """torch.profiler around the block, its Chrome trace written to
    out_dir (or JMX_TRACE) as trace.json: host and, where there is a card,
    CUDA activity (every kernel launch by name). A no-op when neither is
    set, as jmcodec_tpu's device_trace."""
    out = out_dir or os.environ.get("JMX_TRACE")
    if not out:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
