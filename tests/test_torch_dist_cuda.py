"""The port's distributed-runtime slice on the card: checkpoints of CUDA
state, resume through ``train`` on the card, and the class-partitioned
consensus with the hand kernels.  Every case carries the ``cuda`` marker
and skips where there is no card; the file imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_dist_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (ConsensusSpec, HsadmmConfig,  # noqa: E402
                                 ShapeConfig, get_config)
from repro_torch.data.pipeline import batches, superbatches  # noqa: E402
from repro_torch.data.synthetic import make_stream  # noqa: E402
from repro_torch.dist import checkpoint as ckpt  # noqa: E402
from repro_torch.dist import ft, monitor  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train.engine import Engine  # noqa: E402
from repro_torch.train.loop import RunConfig, train  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPE = ShapeConfig("s", "train", 16, 16)
LEVELS = ConsensusSpec((2, 2), 1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _flushed():
    yield
    ckpt.flush()


def _engine(dev, wire, **kw):
    hp = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=2, t_freeze=2,
                      reconfig_patience=1, wire_inter=wire)
    return Engine(build(get_config("resnet18", smoke=True)
                        .replace(hsadmm=hp)), SHAPE, consensus=LEVELS,
                  device=dev, **kw)


def _leaves(tree, prefix=""):
    return ckpt._flatten(tree, prefix)


def test_background_save_of_card_state_restores_on_the_card(dev, tmp_path):
    """The snapshot of a CUDA state is taken at the call: a state changed
    right after ``save`` returns leaves the checkpoint as it was, and the
    restore lands on the template's device with its dtypes."""
    st = _engine(dev, "compact+q8").init_state_fn()(0)
    want = {p: t.clone() for p, t in _leaves(st).items()}
    ckpt.save(str(tmp_path), st, {"step": 1}, background=True)
    for t in _leaves(st).values():
        if t.is_floating_point():
            t.add_(1.0)
    ckpt.flush()
    back, _ = ckpt.restore(ckpt.latest(str(tmp_path)), st)
    for p, t in _leaves(back).items():
        assert t.device.type == "cuda" and t.dtype == want[p].dtype, p
        assert torch.equal(t, want[p]), p


@pytest.mark.parametrize("wire,reconfig", [("compact+q8", False),
                                           ("compact+q4", True)])
def test_resume_on_the_card_is_bit_equal_twice(dev, tmp_path, wire,
                                               reconfig):
    """4 rounds saving every 2, then two resumes to 6 rounds from the same
    checkpoint: equal bits, and the saved state is the returned one."""
    run = dict(shape=SHAPE, eta=1e-2, log=None, reconfig=reconfig,
               ckpt_dir=str(tmp_path))
    st, rep = train(_engine(dev, wire),
                    RunConfig(outer_iters=4, ckpt_every=2, ckpt_keep=1,
                              **run))
    back, meta = ckpt.restore(ckpt.latest(str(tmp_path)), st)
    assert meta["reconfigured"] == reconfig
    for p, t in _leaves(back).items():
        assert torch.equal(t, _leaves(st)[p]), p
    runs = [train(_engine(dev, wire),
                  RunConfig(outer_iters=6, ckpt_every=0, **run))
            for _ in range(2)]
    (a, ra), (b, rb) = runs
    assert ra.losses == rb.losses and len(ra.losses) == 2
    assert ra.executables == (["reconfigured"] * 2 if reconfig
                              else ["dynamic", "frozen"])
    for p, t in _leaves(a).items():
        assert torch.equal(t, _leaves(b)[p]), p


@pytest.mark.parametrize("wire", ["compact+q8", "compact+q4"])
def test_all_ones_class_weights_are_bit_equal_on_the_card(dev, wire):
    """The class partition with all-ones weights gives the unscoped
    round's bits through the hand kernels; q4 launches its table once per
    lead class."""
    eng = _engine(dev, wire)
    sb = next(superbatches(batches(make_stream(eng.cfg, SHAPE, 4,
                                               device=dev)), 2))
    eta = torch.tensor(1e-2, device=dev)
    out = []
    for e in (eng, eng.with_class_weights(True)):
        ops.reset_launch_counts()
        with monitor.compile_count() as builds:
            st, m = e.round_step_fn(frozen=False)(e.init_state_fn()(0), sb,
                                                  eta)
            torch.cuda.synchronize()
        out.append((st, m, ops.launch_counts()))
        assert builds.compiles == 0
    (a, ma, ca), (b, mb, cb) = out
    assert torch.equal(ma.losses, mb.losses)
    for g in ("theta", "u", "mom"):
        for key in a[g]:
            assert torch.equal(a[g][key], b[g][key]), (g, key)
    assert ca["quantize_rows"] == cb["quantize_rows"]
    if wire == "compact+q4":
        from repro_torch.core.consensus import lead_classes
        lead = lead_classes(eng.bundle.plan)
        classes = {lead.get(key) for key in eng.bundle.shapes}
        assert ca["quantize_pack_q4"] == 1
        assert cb["quantize_pack_q4"] == len(classes)


def test_policy_run_on_the_card_writes_every_rounds_weights(dev):
    pol = ft.compose(ft.fail_window({1: (1, 3)}), ft.class_scoped(
        {"cnn:mid0": ft.straggler_decay({2: 0.25}, halflife=2)}))
    seen = []

    def record(k, state):
        seen.append((state["weights"].cpu(),
                     state["class_weights"]["cnn:mid0"].cpu()))
    _, rep = train(_engine(dev, "compact+q8"),
                   RunConfig(outer_iters=4, shape=SHAPE, eta=1e-2, log=None,
                             ft_policy=pol, eval_fn=record))
    assert all(torch.isfinite(torch.tensor(rep.losses)))
    for k, (w, cw) in enumerate(seen):
        assert torch.equal(w, torch.from_numpy(pol(k, 4)))
        assert torch.equal(cw, torch.from_numpy(
            pol.class_weights(k, 4)["cnn:mid0"]))
