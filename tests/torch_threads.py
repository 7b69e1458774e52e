"""One torch thread per test process for the port's CPU tests.

When the suite runs in several processes at once (pytest-xdist's ``-n``),
each process would start one torch intra-op thread per core, and their
threads then contend for the same cores: a smoke-size test of the port ran
about five times slower among six such processes than with one thread
each. The port's test modules import this fixture, which runs each module
with one torch thread and restores the count after it:

    from torch_threads import one_torch_thread  # noqa: F401

It changes no test's inputs, sizes or tolerances."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
