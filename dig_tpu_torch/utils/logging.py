"""Logging sinks: stdout tee, JSONL epoch log, TensorBoard scalars.

Counterpart of `dig_tpu/utils/logging.py`.  Parity targets: stdout tee
`Logger` to ``screen.txt`` (reference: utils/logging.py:28-67), per-epoch
JSON-lines ``log.txt`` (run_mae_pretraining_moco.py:445-449),
`TensorboardLogger` (utils/utils.py:285-306), and process-0-only printing
(utils/utils.py:319-331), here `stdout_on_main_process_only`, a scope
rather than a builtins.print monkey-patch, so that an in-process `main`
leaves print as it found it.

Under data-parallel training only rank 0 writes ``log.txt`` and
TensorBoard scalars (`parallel.dist.is_main_process`).

Deviation from the JAX package: `ScreenTee` can be taken down again
(`close`), which puts back the stream it replaced and closes its file.  The JAX CLI installs its tee for the life of the
process; the port's `main` is also called in process (tests, chip_smoke.py),
whose own output must reach the real stdout afterwards."""

from __future__ import annotations

import contextlib
import json
import os
import sys

from dig_tpu_torch.parallel.dist import is_main_process


@contextlib.contextmanager
def stdout_on_main_process_only():
    """Within the block, stdout is discarded on every data-parallel rank but
    rank 0 (the reference's `setup_for_distributed`, scoped); stderr stays."""
    if is_main_process():
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


class ScreenTee:
    """Tee stdout to ``{output_dir}/screen.txt`` between `install` and `close`."""

    def __init__(self, output_dir: str, filename: str = "screen.txt"):
        os.makedirs(output_dir, exist_ok=True)
        self.terminal = sys.stdout
        self.file = open(os.path.join(output_dir, filename), "a", buffering=1)

    def install(self):
        sys.stdout = self
        return self

    def write(self, message):
        self.terminal.write(message)
        self.file.write(message)

    def flush(self):
        self.terminal.flush()
        self.file.flush()

    def close(self):
        """Put back the stream `install` replaced and close the file."""
        if sys.stdout is self:
            sys.stdout = self.terminal
        self.file.close()


class JsonlLogger:
    def __init__(self, output_dir: str, filename: str = "log.txt"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)

    def write(self, **stats):
        if not is_main_process():
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(stats) + "\n")


class TensorboardLogger:
    """Thin TF summary writer; no-ops if tensorflow is unavailable."""

    def __init__(self, log_dir: str):
        self.step = 0
        self._writer = self._tf = None
        if not is_main_process():  # only rank 0 writes (and creates) event files
            return
        try:
            import tensorflow as tf

            self._writer = tf.summary.create_file_writer(log_dir)
            self._tf = tf
        except Exception:
            self._writer = None
            self._tf = None

    def set_step(self, step=None):
        self.step = step if step is not None else self.step + 1

    def update(self, head: str = "scalar", step=None, **kwargs):
        if self._writer is None or not is_main_process():
            return
        with self._writer.as_default():
            for k, v in kwargs.items():
                if v is None:
                    continue
                self._tf.summary.scalar(
                    f"{head}/{k}", float(v), step=step if step is not None else self.step
                )

    def flush(self):
        if self._writer is not None:
            self._writer.flush()
