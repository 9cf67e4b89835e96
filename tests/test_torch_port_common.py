"""What every port test file shares: one torch thread per test process.

The tier-1 run puts several pytest workers on the host's cores at once. At
torch's default of one intra-op thread per core, their OpenMP pools
oversubscribe the cores and the small ops of these tests wait on each
other: six workers made a 10-step guided trajectory at num_features 32
take about 170 s of torch time instead of under one. Each port test file
imports `one_torch_thread`, an autouse fixture that runs its tests on one
thread and restores the count afterwards."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_port_tests_run_on_one_torch_thread():
    assert torch.get_num_threads() == 1
