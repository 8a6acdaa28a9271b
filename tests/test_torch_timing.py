"""utils/timing.time_op: it times on the card unless the caller asks for
the CPU, as the package's other entry points do, and raises where no
CUDA device exists instead of timing the enqueue on the host clock."""

import pytest

torch = pytest.importorskip("torch")

from bmsparse_tpu_torch.utils.timing import time_op


def test_time_op_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        time_op(calls.append, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        time_op(calls.append, 1, device="cuda:0")
    assert not calls


def test_time_op_on_the_cpu_when_asked():
    calls = []
    t, out = time_op(lambda x: calls.append(x) or x * 2, 21, warmup=2,
                     iters=5, device="cpu")
    assert out == 42 and len(calls) == 7
    assert isinstance(t, float) and t >= 0.0
