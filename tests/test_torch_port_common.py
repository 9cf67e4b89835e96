"""What the port test files share: one torch thread per test process,
and, for the files that build the JAX package's text preprocessors, no
`transformers`.

The tier-1 run puts several pytest workers on the host's cores at once. At
torch's default of one intra-op thread per core, their OpenMP pools
oversubscribe the cores and the small ops of these tests wait on each
other: six workers made a 10-step guided trajectory at num_features 32
take about 170 s of torch time instead of under one. Each port test file
imports `one_torch_thread`, an autouse fixture that runs its tests on one
thread and restores the count afterwards. It holds numpy's and scipy's
OpenBLAS pools (threadpoolctl) to one thread as well: their spinning
threads, one per core in each worker, made the moving-MNIST-256 resize
(numpy matmuls) take 37-40 s of a tier-1 run against 1.8 s alone.

The JAX package's CLIP tokenizer and embedder (`xdiffusion_tpu.layers.clip`)
import `transformers` to look for pretrained weights, and take their hash
or BPE fallback on any failure. No weights are in the repository, so the
look always fails, but the import alone costs a test process some 12 s.
A file that imports the autouse `no_transformers` makes the import fail at
once for its tests (sys.modules["transformers"] = None), so the JAX side
takes the same fallback without it."""

import sys

import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):  # numpy's and scipy's BLAS pools too
        yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def no_transformers():
    saved = sys.modules.get("transformers", False)
    sys.modules["transformers"] = None
    yield
    if saved is False:
        del sys.modules["transformers"]
    else:
        sys.modules["transformers"] = saved


def test_port_tests_run_on_one_torch_thread():
    assert torch.get_num_threads() == 1
