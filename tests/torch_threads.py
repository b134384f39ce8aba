"""One intra-op thread for a test module's torch work (not collected).

The smoke models are tiny: torch's default of one thread per core only
contends with the other test workers and the gloo ranks the tests start
(the adaptive-batch launcher run took 45 s at 8 threads and 3 s at 1 on
an 8-core host). A module that imports :func:`one_thread` runs its
tests at one thread and restores the count after its last test; its
spawned ranks set their own counts (``launch.mesh.spawn``).
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)
