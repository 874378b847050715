"""The cross-thread guard of the port's ``strategy_compiler._swapped``
(mirrors ``tests/test_swap_guard.py`` on the reference's
``static.functional._swapped_state``): same-thread nesting restores
LIFO; a second thread swapping the same parameter slot raises, and the
registry is clean afterwards. The prefetch and snapshot threads of
``distributed/elastic.py`` make a second thread reachable."""
import threading

import torch

from paddle_tpu_torch.distributed.strategy_compiler import _swapped


def _layer():
    return torch.nn.Linear(2, 2, bias=False)


def test_same_thread_nesting_lifo():
    lin = _layer()
    w0 = lin.weight
    with _swapped(lin, {"weight": torch.ones(2, 2)}):
        with _swapped(lin, {"weight": torch.full((2, 2), 2.0)}):
            assert float(lin.weight[0, 0]) == 2.0
        assert float(lin.weight[0, 0]) == 1.0
    assert lin.weight is w0
    assert (id(lin), "weight") not in _swapped._owner


def test_cross_thread_swap_raises():
    lin = _layer()
    err = []
    with _swapped(lin, {"weight": torch.ones(2, 2)}):
        def other():
            try:
                with _swapped(lin, {"weight": torch.zeros(2, 2)}):
                    pass
            except RuntimeError as e:
                err.append(str(e))

        th = threading.Thread(target=other)
        th.start()
        th.join()
        assert float(lin.weight[0, 0]) == 1.0     # untouched by the other
    assert err and "another thread" in err[0]
    # the registry is clean and a fresh swap from any thread works
    assert (id(lin), "weight") not in _swapped._owner
    th = threading.Thread(target=lambda: _swapped(
        lin, {"weight": torch.ones(2, 2)}).__enter__().__exit__())
    th.start()
    th.join()
    assert (id(lin), "weight") not in _swapped._owner
