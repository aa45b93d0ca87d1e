"""A thread that samples what the main thread is running, every few milliseconds.

Each sample is ``(time.perf_counter(), label)``; the label is the innermost
frame of the program (``infercnvpy_tpu_torch/...``) as ``path:function``,
else the innermost frame.  The trace run uses the samples to say what the
host was doing while the device sat idle (``tracefile.idle_by_host``).
"""

from __future__ import annotations

import sys
import threading
import time

PROGRAM_DIR = "infercnvpy_tpu_torch/"


def label(frame) -> str:
    innermost = None
    while frame is not None:
        path = frame.f_code.co_filename.replace("\\", "/")
        if innermost is None:
            innermost = f"{path.rsplit('/', 1)[-1]}:{frame.f_code.co_name}"
        if PROGRAM_DIR in path:
            return f"{path.split(PROGRAM_DIR, 1)[1]}:{frame.f_code.co_name}"
        frame = frame.f_back
    return innermost or "?"


class Sampler:
    def __init__(self, period_s: float = 0.002):
        self.period_s = period_s
        self.samples: list = []
        self._target = threading.main_thread().ident
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="cnvbench-sampler", daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            frame = sys._current_frames().get(self._target)
            if frame is not None:
                self.samples.append((time.perf_counter(), label(frame)))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        return False
