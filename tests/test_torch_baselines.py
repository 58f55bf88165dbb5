"""The port's baseline trainers (``repro_torch.train.baselines``: dense
DDP, Top-K with error feedback, any codec) and ``superbatch_chunks``
against the JAX package, on resnet18 smoke from the JAX init, and the
byte accounting at full width.  Their card cases are in
``test_torch_baselines_cuda.py``, which imports no JAX."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import comm as jcomm  # noqa: E402
from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data.synthetic import make_stream as j_make_stream  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.train import baselines as jbase  # noqa: E402

from repro_torch import comm as tcomm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data.synthetic import make_stream as t_make_stream  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.train import baselines as tbase  # noqa: E402

from torch_port_helpers import assert_tree_close, jax_reference, to_np  # noqa: E402

SHAPE = ShapeConfig("tiny", "train", 32, 16)
ETA = 3e-3


@pytest.mark.parametrize("e,steps", [(3, 7), (8, 16), (4, 2), (5, 0)])
def test_superbatch_chunks_equal_reference(e, steps):
    """Chunks of ``e`` covering exactly ``steps``, at most one shorter
    tail, byte-identical to the reference's."""
    shape = ShapeConfig("t", "train", 32, 8)
    js = j_make_stream(get_config("resnet18", smoke=True), shape, 2)
    ts = t_make_stream(t_get_config("resnet18", smoke=True), shape, 2,
                       device="cpu")
    jc = list(jpipe.superbatch_chunks(jpipe.batches(js), e, steps))
    tc = list(tpipe.superbatch_chunks(tpipe.batches(ts), e, steps))
    assert [n for n, _ in tc] == [n for n, _ in jc]
    assert sum(n for n, _ in tc) == steps
    assert len({n for n, _ in tc}) <= 2
    for (n, t), (_, j) in zip(tc, jc):
        assert set(t) == set(j) == {"images", "labels"}
        for k in j:
            a, b = np.asarray(j[k]), to_np(t[k])
            assert a.shape[0] == n and a.dtype == b.dtype
            assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("spec,dtype,expected", [
    ("dense", "float32", 44_695_848), ("topk:0.01", "float32", 14_300_544),
    ("q8", "float32", 11_300_186), ("compact+topk:0.05", "float32", None),
    ("topk:0.01", "bfloat16", None)])
def test_step_wire_bytes_full_width_equal_reference(spec, dtype, expected):
    """Full-width resnet18 at W = 16: bytes a step equal the reference's
    (x W for the AllGather top-k; bf16 top-k entries count 2 + 4 bytes)."""
    shapes = t_build(t_get_config("resnet18")).shapes
    tparams = {k: torch.empty(s, dtype=getattr(torch, dtype), device="meta")
               for k, s in shapes.items()}
    jparams = {k: jax.ShapeDtypeStruct(s, dtype) for k, s in shapes.items()}
    t = tbase.step_wire_bytes(tcomm.get_codec(spec), tparams, 16)
    assert t == jbase.step_wire_bytes(jcomm.get_codec(spec), jparams, 16)
    if expected is not None:
        assert t == expected


TRAINERS = {
    "ddp": ("ddp_train", {}),
    "topk": ("topk_train", {"rate": 0.05}),
    "q8": ("codec_train", {"codec": "q8"}),
}


@pytest.fixture(scope="module")
def baseline_runs():
    """Each trainer in both packages: resnet18 smoke, W = 2, 16 steps in
    rounds of 8, from the same (JAX-drawn) init."""
    jb = j_build(get_config("resnet18", smoke=True))
    p0 = jax.device_get(jb.init(jax.random.PRNGKey(0)))
    tb = dataclasses.replace(
        t_build(t_get_config("resnet18", smoke=True)),
        init=lambda gen, device: convert.params_from_jax(p0, device))
    out = {}
    for name, (fn, kw) in TRAINERS.items():
        with jax_reference(ieee_quantize=True):
            jp, jrep = getattr(jbase, fn)(jb, 2, SHAPE, steps=16, eta=ETA,
                                          round_steps=8, **kw)
        tp, trep = getattr(tbase, fn)(tb, 2, SHAPE, steps=16, eta=ETA,
                                      round_steps=8, device="cpu", **kw)
        out[name] = (jax.device_get(jp), jrep, tp, trep)
    return out


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_matches_reference(baseline_runs, name):
    jp, jrep, tp, trep = baseline_runs[name]
    assert len(trep.losses) == len(trep.wall_times) == 16
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-3)
    assert trep.comm_bytes_internode == jrep.comm_bytes_internode
    assert all(w > 0 for w in trep.wall_times)
    assert_tree_close(tp, jp, rtol=1e-3, atol=1e-5)


def test_baselines_run_and_learn(baseline_runs):
    """The mirror of ``test_system.py::test_baselines_run_and_learn`` on
    resnet18 smoke (the port has no tinyllama yet)."""
    rep_d, rep_t = baseline_runs["ddp"][3], baseline_runs["topk"][3]
    assert rep_d.losses[-1] < rep_d.losses[0]
    assert rep_t.losses[-1] < rep_t.losses[0]
    # Top-K moves less than dense per step at 5% (values+indices, x workers)
    assert rep_t.comm_bytes_internode[0] < rep_d.comm_bytes_internode[0]
    assert rep_d.comm_bytes_internode[0] == 79_976
    assert rep_t.comm_bytes_internode[0] == 15_920


def test_trainers_log_and_keep_the_keyword_surfaces():
    """``log`` gets a line every 20 steps; the tail round is shorter."""
    import inspect
    for fn in ("codec_train", "ddp_train", "topk_train"):
        ref = set(inspect.signature(getattr(jbase, fn)).parameters)
        port = set(inspect.signature(getattr(tbase, fn)).parameters)
        assert port - ref == {"device"}, fn
        assert ref <= port, fn
    lines = []
    bundle = t_build(t_get_config("resnet18", smoke=True))
    _, rep = tbase.ddp_train(bundle, 2, SHAPE, steps=21, round_steps=8,
                             log=lines.append, device="cpu")
    assert len(rep.losses) == 21 and len(lines) == 1
    assert lines[0].startswith("[ddp] step=")
    walls = rep.wall_times   # each step's share of its round: 8, 8, 5
    assert all(len(set(walls[a:b])) == 1
               for a, b in ((0, 8), (8, 16), (16, 21)))
