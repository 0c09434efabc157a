"""What the host did while a window ran, for the line of standard error
that says why a host-paced cell's runs spread: the main thread's CPU
seconds, the machine's stolen seconds (``/proc/stat``, every core), the
process's involuntary context switches, Python's garbage collections and
their seconds, and the cores' mean clock as ``/proc/cpuinfo`` gives it.
It reads its own process's entries only; a number that cannot be read is
left out."""

from __future__ import annotations

import gc
import os
import resource
import time


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


class HostWatch:
    def __init__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, 0.0
        gc.callbacks.append(self._gc)

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def close(self) -> None:
        gc.callbacks.remove(self._gc)

    def snapshot(self) -> dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        out = {"thread_cpu_s": time.thread_time(), "nivcsw": ru.ru_nivcsw,
               "gc_n": self.gc_n, "gc_s": self.gc_s}
        stat = _read("/proc/stat")
        if stat:
            out["steal_s"] = int(stat.split()[8]) / os.sysconf("SC_CLK_TCK")
        return out


def delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a if k in b}


def clock_mhz() -> float | None:
    """The cores' mean clock, MHz, as ``/proc/cpuinfo`` gives it."""
    info = _read("/proc/cpuinfo")
    mhz = [float(line.split(":")[1]) for line in (info or "").splitlines()
           if line.startswith("cpu MHz")]
    return sum(mhz) / len(mhz) if mhz else None
