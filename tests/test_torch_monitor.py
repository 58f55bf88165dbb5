"""The port's monitor (``repro_torch.dist.monitor``): kernel-build counts,
the timed probe and the call counters, on the CPU (no build happens
here: the CPU takes every kernel's plain version)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (ConsensusSpec, HsadmmConfig,  # noqa: E402
                                 ShapeConfig, get_config)
from repro_torch.data.pipeline import batches, superbatches  # noqa: E402
from repro_torch.data.synthetic import make_stream  # noqa: E402
from repro_torch.dist import monitor  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train.engine import Engine  # noqa: E402


def test_compile_count_reads_build_deltas(monkeypatch):
    with monitor.compile_count() as outer:
        monkeypatch.setattr(_build, "_started", _build._started + 2)
        with monitor.compile_count() as inner:
            monkeypatch.setattr(_build, "_started", _build._started + 1)
    assert (outer.compiles, inner.compiles) == (3, 1)


def test_build_start_counts_one_nvcc(monkeypatch, tmp_path):
    """``_build._start`` counts the nvcc it starts, and nothing for a
    library that already exists."""
    started = []

    class Proc:
        def __init__(self, cmd, **kw):
            started.append(cmd)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    with monitor.compile_count() as stats:
        job = _build._start("wire")
        _build._target("compact").write_bytes(b"")
        assert _build._start("compact") is None
    assert job is not None and len(started) == 1 and stats.compiles == 1


@pytest.fixture(scope="module")
def smoke_round():
    hp = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=2,
                      wire_inter="compact+q8")
    shape = ShapeConfig("tiny", "train", 32, 8)
    eng = Engine(build(get_config("resnet18", smoke=True).replace(hsadmm=hp)),
                 shape, consensus=ConsensusSpec((2, 2), 1), device="cpu")
    it = superbatches(batches(make_stream(eng.cfg, shape, eng.workers,
                                          device="cpu")), 2)
    return eng, eng.init_state_fn()(0), it


def test_compile_count_reads_zero_over_cpu_rounds(smoke_round):
    eng, state, it = smoke_round
    fn, counter = monitor.counting(eng.round_step_fn(frozen=False), "round")
    eta = torch.tensor(1e-2)
    with monitor.compile_count() as stats:
        for _ in range(2):
            state, m = fn(state, next(it), eta)
    assert stats.compiles == 0
    assert counter.calls == 2 and counter.by_label == {"round": 2}
    assert torch.isfinite(m.losses).all()


def test_probe_seconds_times_cpu_calls():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": [x * 2]}
    sec, builds = monitor.probe_seconds(fn, torch.ones(4), reps=5, warmup=2)
    assert len(calls) == 7 and sec >= 0.0 and builds == 0


def test_call_counter_shares_one_count_across_labels():
    c = monitor.CallCounter()
    f = c.wrap(lambda x: x + 1, "f")
    g = c.wrap(lambda x: x * 2)
    assert f(g(f(1))) == 5
    assert c.calls == 3 and c.by_label == {"f": 2}
