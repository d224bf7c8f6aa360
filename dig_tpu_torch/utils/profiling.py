"""A trace of a window of training steps, over `torch.profiler`.

Counterpart of `dig_tpu/utils/profiling.py::StepTraceWindow`, which wraps
`jax.profiler`: ``--profile_steps n`` traces steps [start, start + n)
(``--profile_start_step``, past the first steps' warm-up) into a Chrome
trace, ``{log_dir}/trace.json``, with the card's kernels when the run is
on CUDA.  `close()` is idempotent and registered with `atexit`, so a run
that ends inside the window (the last step, a NaN exit, preemption) still
writes its trace.
"""

from __future__ import annotations

import atexit
import os


class StepTraceWindow:
    """Call `tick()` once a training step; the trace opens when the step
    count reaches `start` and closes `n` steps later."""

    def __init__(self, log_dir: str, n: int, start: int = 10):
        self.log_dir = log_dir
        self.start = start
        self.stop_at = start + n
        self.enabled = n > 0
        self.step = 0
        self.prof = None
        if self.enabled:
            atexit.register(self.close)

    @property
    def path(self) -> str:
        return os.path.join(self.log_dir, "trace.json")

    def tick(self):
        if not self.enabled:
            return
        if self.step == self.start:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.start()
        self.step += 1
        if self.prof is not None and self.step >= self.stop_at:
            self.close()

    def close(self):
        """Stop an open trace and write it; nothing when none is open."""
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        prof.export_chrome_trace(self.path)
        print(f"[profile] trace of steps [{self.start}, {min(self.step, self.stop_at)}) "
              f"written to {self.path}")
