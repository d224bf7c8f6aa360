"""Windowed metric meters.

Counterpart of `dig_tpu/utils/metric_logger.py`.  Parity target:
`SmoothedValue` / `MetricLogger` (reference: utils/utils.py:30-282):
windowed median/avg meters, a global average, and a `log_every` iterator
printing throughput/ETA.  `synchronize_between_processes` sums count and
total over the data-parallel ranks (:51-62), so a global average is the
whole global batch's.
"""

from __future__ import annotations

import datetime
import sys
import time
from collections import defaultdict, deque

from dig_tpu_torch.parallel.dist import all_reduce_floats


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.window_size = window_size
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Sum count and total over the ranks (a collective: every rank calls
        it; alone, nothing changes)."""
        self.count, self.total = all_reduce_floats([self.count, self.total])
        self.count = int(self.count)

    @property
    def median(self):
        if not self.deque:
            return 0.0
        s = sorted(self.deque)
        return s[len(s) // 2]

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()

    def log_every(self, iterable, print_freq: int, header: str = "", total=None):
        if total is None:
            try:
                total = len(iterable)
            except TypeError:
                total = 0
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                eta = int(iter_time.global_avg * (total - i)) if total else 0
                print(
                    self.delimiter.join(
                        [
                            f"{header} [{i}/{total}]",
                            f"eta: {datetime.timedelta(seconds=eta)}",
                            str(self),
                            f"time: {iter_time}",
                            f"data: {data_time}",
                        ]
                    )
                )
                sys.stdout.flush()
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))} "
              f"({elapsed / max(i, 1):.4f} s / it)")
