"""The port's test files' shared autouse fixture: a test module takes it
with `from test_torch_threads import _few_threads  # noqa: F401`."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    workers on the machine's cores, and small ops on oversubscribed
    threads run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_few_threads_holds_two_threads():
    assert torch.get_num_threads() == 2
