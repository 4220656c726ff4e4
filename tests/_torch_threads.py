"""One torch intra-op thread for the port's test modules.

The port's tests run many small torch operations (the kernels' plain
versions and emulations step by step, the trainers on small batches).
Under the test command's six workers on a shared host, torch's intra-op
threads of every worker spin against each other: one emulated LSTM
forward at L = 301 (tests/test_torch_port_lstm_fwd_tc.py) took 61 s with
eight threads and 0.45 s with one on a loaded host. A module that imports
`one_torch_thread` runs its tests on one thread and restores the count
after its last test.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
