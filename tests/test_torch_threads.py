"""One torch thread in each process that runs the port's tests.

The suite runs in six xdist workers on a box of eight cores, beside the
gloo ranks and trainers the tests spawn. torch's default intra-op pool
(a thread a core) in every worker oversubscribes the box, and each tiny
op's parallel region then waits on threads the scheduler has parked: a
spec-decode test that takes 0.4 s alone took 89 s beside the other
workers. Every port test module imports this one, so the cap holds in
any worker that collects one, and in a file run alone; the processes
the tests spawn get ``OMP_NUM_THREADS=1`` in their env.
"""

import pytest

torch = pytest.importorskip("torch")

THREADS = 1
torch.set_num_threads(THREADS)


def test_port_tests_run_one_torch_thread():
    assert torch.get_num_threads() == THREADS
