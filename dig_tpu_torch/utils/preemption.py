"""Preemption-safe training: latch SIGTERM / SIGINT, checkpoint at the next
step boundary, exit clean.

Counterpart of `dig_tpu/utils/preemption.py`.  A preempted
job (spot capacity, a scheduler's eviction) gets SIGTERM and a grace
window; the trainers poll the guard at each step boundary, save a
checkpoint there and exit 0, and auto-resume continues from it.  The
handler only sets a flag, so a step is never interrupted half-way and the
saved state is consistent.  A second signal while the flush runs restores
the previous handler and re-raises, so a stuck save cannot outlive the
grace window.

    guard = PreemptionGuard.install()
    for it, ...:
        ...
        if guard.sync_should_stop(step=it, every=STOP_POLL_STEPS):
            guard.checkpoint_and_exit(output_dir, lambda: save_checkpoint(...), where)
    guard.uninstall()

Across data-parallel ranks the signal may reach only some of them, so the
decision is a collective (`sync_should_stop`): every rank stops at the same
step boundary, and the checkpoint is written once, by rank 0.
"""

from __future__ import annotations

import signal
import sys

from dig_tpu_torch.parallel.dist import all_reduce_floats, is_distributed

# steps between the ranks' stop polls: a poll reads a value back from the
# card, so each one waits for the queued steps; the latency of a stop is at
# most this many steps (as the JAX CLIs' every=25)
STOP_POLL_STEPS = 25


class PreemptionGuard:
    """Latches termination signals into a flag the training loop polls."""

    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._stop = False
        self._prev = {}

    @property
    def should_stop(self) -> bool:
        """This process's own flag."""
        return self._stop

    def sync_should_stop(self, step: int = 0, every: int = 1) -> bool:
        """The stop decision at a step boundary: True iff any rank caught a
        signal.  With a process group it is a collective (an all-reduce MAX
        of the flags) that every rank runs at the same steps: those with
        ``step % every == 0``; on the others it returns False.  The schedule
        never depends on the local flag: a rank polling off it would leave
        the others waiting in a collective (`dig_tpu/utils/preemption.py:47-75`).
        Alone, the local flag at every step."""
        if not is_distributed():
            return self._stop
        if every > 1 and step % every:
            return False
        return all_reduce_floats([float(self._stop)], op="max")[0] > 0

    @staticmethod
    def checkpoint_and_exit(output_dir: str, save, where: str):
        """`save()` a checkpoint and exit 0; without an output directory
        there is nowhere to save, so exit 143, so that a wrapping script
        does not take a cut run for a finished one."""
        if output_dir:
            save()
            print(f"[preemption] checkpointed at {where}; exiting")
            sys.exit(0)
        print(f"[preemption] no output_dir to checkpoint to ({where}); exiting 143")
        sys.exit(143)

    def _handler(self, signum, frame):
        if self._stop:
            signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
            signal.raise_signal(signum)
            return
        self._stop = True
        sys.stderr.write(f"[preemption] caught {signal.Signals(signum).name}; will checkpoint "
                         f"at the next step boundary (send again to force-quit)\n")
        sys.stderr.flush()

    @classmethod
    def install(cls) -> "PreemptionGuard":
        """Install on the main thread; returns the guard.  Where a signal
        cannot be installed (another thread) the guard never fires."""
        guard = cls()
        for sig in cls._SIGNALS:
            try:
                guard._prev[sig] = signal.signal(sig, guard._handler)
            except (ValueError, OSError):
                pass
        return guard

    def uninstall(self):
        """Put the previous handlers back."""
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev = {}
