"""An autouse fixture for the port's test modules that make many small
eager torch calls (engines, generation loops): the module's tests run on
one intra-op thread. On a loaded machine (the suite's workers beside the
multi-process worlds) a pool of many threads makes such calls several
times slower than one thread does: on an 8-core CPU host beside ten busy
processes, ``test_torch_speculative_api.py``'s sampling loop took 196
against 17 ms a call and ``test_torch_spec.py`` 148 against 81 s.
Import it into a test module:
``from tests._torch_threads import one_torch_thread  # noqa: F401``.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
