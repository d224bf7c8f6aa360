"""One thread a library for the port's test modules.

Every `tests/test_torch_port_*.py` that runs on the CPU holds its whole
module, its module-scoped fixtures included (the CLI runs, the reference
steps), to one intra-op thread of torch (GNU OpenMP) and one of the
OpenBLAS that numpy and OpenCV link:

    @pytest.fixture(scope="module", autouse=True)
    def _one_thread():
        with one_thread():
            yield

`ROADMAP.md`'s Tier-1 command runs the suite in 6 xdist workers on 8
cores.  Left at their defaults, these libraries start a thread a core in
every worker, and OpenMP's and OpenBLAS's threads spin while they wait for
work, so the workers took turns at the cores: the whole run took 2.4 times
as long as with this fixture (`README.md`, "Tests").  The
previous counts are put back when the module ends, so the tests of other
modules run as they would without it.  The rank subprocesses of
`_torch_port_ranks.py` get `OMP_NUM_THREADS=1` for the same reason."""

import contextlib

import threadpoolctl
import torch


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpoolctl.threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(n)
