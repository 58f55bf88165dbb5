"""The port's synthetic image stream and input pipeline give the JAX
reference's batches byte for byte."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data.synthetic import make_stream as j_make_stream  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data.synthetic import make_stream as t_make_stream  # noqa: E402

from torch_port_helpers import to_np  # noqa: E402


@pytest.mark.parametrize("arch,smoke,batch,workers", [
    ("resnet18", True, 16, 4), ("resnet18", False, 32, 2)])
def test_superbatches_are_byte_identical(arch, smoke, batch, workers):
    shape = ShapeConfig("t", "train", 32, batch)
    js = j_make_stream(get_config(arch, smoke=smoke), shape, workers)
    ts = t_make_stream(t_get_config(arch, smoke=smoke), shape, workers,
                       device="cpu")
    jit = jpipe.superbatches(jpipe.batches(js), 3)
    tit = tpipe.prefetch(tpipe.superbatches(tpipe.batches(ts), 3))
    for _ in range(2):
        j, t = next(jit), next(tit)
        assert set(t) == set(j) == {"images", "labels"}
        for k in j:
            a, b = np.asarray(j[k]), to_np(t[k])
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), k


def test_stream_tensors_go_to_the_requested_device():
    shape = ShapeConfig("t", "train", 32, 8)
    s = t_make_stream(t_get_config("resnet18", smoke=True), shape, 2,
                      device="cpu")
    b = s.batch_at(5)
    assert b["images"].shape == (2, 4, 16, 16, 3)
    assert b["images"].dtype == torch.float32
    assert b["labels"].dtype == torch.int32
    with pytest.raises(NotImplementedError):
        t_make_stream(t_get_config("resnet18").replace(family="dense"),
                      shape, 2)


def test_prefetch_thread_stops_when_closed():
    """Closing the prefetch generator (as ``train`` does when it returns)
    ends its thread, which otherwise would hold its queued batches on the
    device for the life of the process."""
    import threading
    shape = ShapeConfig("t", "train", 32, 8)
    s = t_make_stream(t_get_config("resnet18", smoke=True), shape, 2,
                      device="cpu")
    before = threading.active_count()
    it = tpipe.prefetch(tpipe.superbatches(tpipe.batches(s), 2))
    first = next(it)
    assert threading.active_count() == before + 1
    it.close()
    assert threading.active_count() == before
    assert first["images"].shape == (2, 2, 4, 16, 16, 3)
