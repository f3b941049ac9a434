"""A traced slice of the window (`--trace 1`): the device's timeline from
`torch.profiler` (CUPTI) and, beside it, what the server's threads were
doing on the host, sampled from their Python stacks.

Only a slice is profiled, a steady stretch inside the window: the
profiler has been seen to drop kernel events late in a long profile. The
slice's clock is the harness's `time.perf_counter`; the profiler's is
tied to it by a marker recorded at the slice's start.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from collections import Counter
from dataclasses import dataclass, field

#: what the device's timeline counts as an operation running
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the package whose frames name what the host is doing
PORT = "serenedb_tpu_torch"
#: a thread whose innermost frame is in one of these is waiting for work
_WAITING = ("threading.py", "queue.py", "selectors.py",
            os.sep + "asyncio" + os.sep, os.sep + "concurrent" + os.sep)
_MARK = "portbench.slice_start"


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


class HostSampler(threading.Thread):
    """Samples, every `period` seconds, the innermost frame of the program
    on each of the process's other threads."""

    def __init__(self, period: float = 0.002):
        super().__init__(name="portbench-sampler", daemon=True)
        self.period = period
        self.samples: list = []        # (t, [label, ...])
        self._halt = threading.Event()

    @staticmethod
    def label(frame) -> str | None:
        """The innermost frame of the program on a busy thread's stack;
        None for a thread waiting for work or outside the program."""
        if any(w in frame.f_code.co_filename for w in _WAITING):
            return None
        while frame is not None:
            path = frame.f_code.co_filename
            at = path.rfind(PORT + os.sep)
            if at >= 0:
                return f"{path[at:]}:{frame.f_code.co_name}"
            frame = frame.f_back
        return None

    def run(self) -> None:
        me, main = threading.get_ident(), threading.main_thread().ident
        while not self._halt.is_set():
            t = time.perf_counter()
            labels = []
            for ident, frame in sys._current_frames().items():
                if ident in (me, main):
                    continue
                lab = self.label(frame)
                if lab is not None:
                    labels.append(lab)
            self.samples.append((t, labels))
            self._halt.wait(self.period)

    def stop(self) -> None:
        self._halt.set()
        self.join()


@dataclass
class Slice:
    start: float
    end: float
    device: list = field(default_factory=list)   # (start, end, name, cat)
    samples: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self, cats=DEVICE_CATS) -> float:
        return _length(_union((s, e) for s, e, _, c in self.device
                              if c in cats))

    def kernel_s(self) -> float:
        return self.busy_s(("kernel",))

    def device_ops(self, top: int = 10) -> list:
        by = Counter()
        for s, e, name, _ in self.device:
            by[name] += e - s
        return [[n, v] for n, v in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """Device-idle seconds by what the host's threads were doing: a
        sample inside an idle stretch gives its period to the program
        frames it saw, shared evenly ("no program frame" when none)."""
        busy = _union((s, e) for s, e, _, c in self.device
                      if c in DEVICE_CATS)
        by = Counter()
        j = 0
        for k, (t, labels) in enumerate(self.samples):
            nxt = self.samples[k + 1][0] if k + 1 < len(self.samples) \
                else self.end
            if not (self.start <= t < self.end):
                continue
            while j < len(busy) and busy[j][1] <= t:
                j += 1
            if j < len(busy) and busy[j][0] <= t:
                continue
            dt = min(nxt, self.end) - t
            if not labels:
                by["no program frame"] += dt
            for lab in labels:
                by[lab] += dt / len(labels)
        return [[n, v] for n, v in by.most_common(top)]


def warm_profiler(device) -> None:
    """A first, empty profile, so that CUPTI's start-up lands in
    set-up and not in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def profile_slice(start_at: float, length: float, device) -> Slice:
    """Profile the device from `start_at` for `length` seconds (host
    clock: time.perf_counter) while sampling the host's threads."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    now = time.perf_counter()
    if now < start_at:
        time.sleep(start_at - now)
    sampler = HostSampler()
    sampler.start()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(_MARK):
            t_mark = time.perf_counter()
        time.sleep(max(0.0, t_mark + length - time.perf_counter()))
        t_end = time.perf_counter()
    sampler.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    mark = [e for e in events if e.get("name") == _MARK]
    if not mark:
        raise RuntimeError("the profiler's trace lost the slice's marker")
    offset = t_mark - float(mark[0]["ts"]) / 1e6
    sl = Slice(t_mark, t_end, samples=sampler.samples)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"]) / 1e6 + offset
        t = s + float(e.get("dur", 0)) / 1e6
        s, t = max(s, t_mark), min(t, t_end)
        if t > s:
            sl.device.append((s, t, e.get("name", "?"), e["cat"]))
    return sl
