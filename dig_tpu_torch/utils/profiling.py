"""Traces over `torch.profiler`.

* `StepTraceWindow`, counterpart of `dig_tpu/utils/profiling.py::StepTraceWindow`,
  which wraps `jax.profiler`: ``--profile_steps n`` traces steps
  [start, start + n) (``--profile_start_step``, past the first steps'
  warm-up) into a Chrome trace, ``{log_dir}/trace.json``, with the card's
  kernels when the run is on CUDA.  `close()` is idempotent and registered
  with `atexit`, so a run that ends inside the window (the last step, a NaN
  exit, preemption) still writes its trace.
* `profile_fn`: the card's time over one call, by kernel, and its busy
  time (the union of its kernels' intervals) beside the host's wall time:
  what `bench_torch.py`'s ``breakdown_ms`` and `chip_smoke.py`'s
  ``[profile ...]`` lines read.
"""

from __future__ import annotations

import atexit
import os
import time

PROFILE_TRIES = 3  # profiler sessions a profiled call may take (see profile_fn)


def busy_ms(intervals) -> float:
    """The length of the union of [start, end) intervals (us), in ms."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total / 1e3


def profile_fn(fn, n_top: int = 10):
    """One call of `fn` on the card under `torch.profiler` (CUPTI), ended
    by a synchronise.  Returns ([(kernel name, ms summed over its
    launches)] of the `n_top` longest, the device's busy ms: the union of
    its kernels' intervals, the host's wall ms).  The optimizer's
    ``Optimizer.*`` ranges, which the trace mirrors onto the device's
    timeline, are annotations, not kernels, and are left out.  A session
    that records no device event at all is taken again, up to
    `PROFILE_TRIES` sessions: on an NVIDIA H100 one session in a whole run of
    `chip_smoke.py` has come back without any (a fault of the tracer, not
    of the call, which runs its kernels either way); `RuntimeError` when
    every session does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and e.time_range.end > e.time_range.start
                   and not e.name.startswith("Optimizer.")]
        if kernels:
            break
    else:
        raise RuntimeError(f"the profiler saw no device time in {PROFILE_TRIES} sessions")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda r: -r[1])[:n_top]
    return top, busy_ms((e.time_range.start, e.time_range.end) for e in kernels), wall_ms


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
