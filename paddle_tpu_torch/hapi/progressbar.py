"""Terminal progress bar for hapi — counterpart of
``paddle_tpu/hapi/progressbar.py``, printing the same text."""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, num=None, width=30, verbose=1, start=True,
                 file=sys.stdout):
        self._num = num
        self._width = width
        self._verbose = verbose
        self.file = file
        self._last_len = 0
        self._start = time.time() if start else None

    def start(self):
        self._start = time.time()

    def update(self, current_num, values=None):
        values = values or []
        msg = f"step {current_num}"
        if self._num:
            msg += f"/{self._num}"
        if self._start is not None and current_num:
            per = (time.time() - self._start) / current_num
            unit = "s/step" if per >= 1 else "ms/step"
            msg += f" - {per if per >= 1 else per * 1e3:.0f}{unit}"
        for k, v in values:
            if isinstance(v, (list, tuple)):
                body = " ".join(f"{x:.4f}" for x in v)
            elif isinstance(v, float):
                body = f"{v:.4f}"
            else:
                body = str(v)
            msg += f" - {k}: {body}"
        if self._verbose == 1:
            pad = max(self._last_len - len(msg), 0)
            self.file.write("\r" + msg + " " * pad)
            if self._num and current_num >= self._num:
                self.file.write("\n")
            self._last_len = len(msg)
        elif self._verbose == 2:
            self.file.write(msg + "\n")
        self.file.flush()
