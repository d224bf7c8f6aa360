"""Preemption-safe training: latch SIGTERM / SIGINT, checkpoint at the next
step boundary, exit clean.

Counterpart of `dig_tpu/utils/preemption.py` on one process.  A preempted
job (spot capacity, a scheduler's eviction) gets SIGTERM and a grace
window; the trainers poll the guard at each step boundary, save a
checkpoint there and exit 0, and auto-resume continues from it.  The
handler only sets a flag, so a step is never interrupted half-way and the
saved state is consistent.  A second signal while the flush runs restores
the previous handler and re-raises, so a stuck save cannot outlive the
grace window.

    guard = PreemptionGuard.install()
    for ...:
        ...
        if guard.should_stop:
            guard.checkpoint_and_exit(output_dir, lambda: save_checkpoint(...), where)
    guard.uninstall()
"""

from __future__ import annotations

import signal
import sys


class PreemptionGuard:
    """Latches termination signals into a flag the training loop polls."""

    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._stop = False
        self._prev = {}

    @property
    def should_stop(self) -> bool:
        """The stop decision at a step boundary.  One process holds the
        whole run, so it is the local flag (the JAX package's decision is a
        collective across hosts)."""
        return self._stop

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
