"""Overlapped rounds (``HsadmmConfig.staleness=1``) in the port, against
the JAX package and against the port's own sequential round:

* ``round_step_overlapped`` against the JAX one over one input state left
  by a sequential round, for a dense, a compact+q8 and a topk:0.01
  inter-node wire at levels (2, 2);
* the port's overlapped round is its ``consensus_step`` over the input
  state plus E ``local_step``s from that same state, bit for bit;
* four overlapped rounds track four sequential ones (the reference's
  bounded-staleness tolerances) on the chip, pod and flat hierarchies,
  and ``flush_pipeline`` drains the pending consensus;
* ``train`` at ``staleness=1`` against the JAX ``train``, with and without
  physical reconfiguration, and an overlapped run resumed from its save.

resnet-smoke throughout; the JAX side quantizes with IEEE division of the
scale, as the port does (``torch_port_helpers``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ConsensusSpec, HsadmmConfig, ShapeConfig, get_config  # noqa: E402
from repro.core import hsadmm as jhs  # noqa: E402
from repro.data.synthetic import make_stream as j_make_stream  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.train.engine import Engine as JEngine  # noqa: E402
from repro.train.loop import RunConfig as JRunConfig  # noqa: E402
from repro.train.loop import train as j_train  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ShapeConfig as TShapeConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import hsadmm as ths  # noqa: E402
from repro_torch.data.pipeline import batches, superbatches  # noqa: E402
from repro_torch.data.synthetic import make_stream  # noqa: E402
from repro_torch.dist import checkpoint as ckpt  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.train.engine import Engine  # noqa: E402
from repro_torch.train.loop import RunConfig, train  # noqa: E402

from torch_port_helpers import assert_tree_close, jax_reference, to_np  # noqa: E402
from test_torch_hsadmm import ATOL, RTOL, _assert_state  # noqa: E402

HP = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=2, t_freeze=2,
                  reconfig_patience=1)
LEVELS = ConsensusSpec(levels=(2, 2), compact_from_level=1)
HIERARCHIES = {
    "chip": ConsensusSpec(levels=(2, 2), compact_from_level=1),
    "pod": ConsensusSpec(levels=(2, 2), compact_from_level=0,
                         granularity="pod"),
    "flat": ConsensusSpec(levels=(4,), compact_from_level=1,
                          granularity="flat"),
}
WIRES = ["dense", "compact+q8", "topk:0.01"]
SHAPE = ShapeConfig("tiny", "train", 32, 16)
T_SHAPE = TShapeConfig("tiny", "train", 32, 16)
ETA = 1e-2


@pytest.fixture(autouse=True)
def _flushed():
    yield
    ckpt.flush()


def _hp(wire, **kw):
    return dataclasses.replace(HP, wire_inter=wire, **kw)


def _specs(wire):
    hp = _hp(wire)
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=hp))
    tb = t_build(t_get_config("resnet18", smoke=True).replace(hsadmm=hp))
    jspec = jhs.EngineSpec(plan=jb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(jb.stack_map))
    tspec = ths.EngineSpec(plan=tb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(tb.stack_map))
    return jb, tb, jspec, tspec


def _superbatches(jb, n):
    """The first ``n`` (E, W, ...) superbatches of the stream, as numpy."""
    stream = j_make_stream(jb.cfg, SHAPE, LEVELS.num_workers)
    E = HP.local_steps
    return [{k: np.stack([np.asarray(stream.batch_at(i * E + s)[k])
                          for s in range(E)]) for k in ("images", "labels")}
            for i in range(n)]


def _torch(sb):
    return {k: torch.from_numpy(v) for k, v in sb.items()}


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def overlapped():
    """{wire: (input state, superbatch, JAX overlapped state, metrics)}:
    the input state is the JAX init after one sequential round; the
    overlapped round reads the next superbatch."""
    out = {}
    for wire in WIRES:
        jb, _, jspec, _ = _specs(wire)
        sb0, sb1 = _superbatches(jb, 2)
        with jax_reference(ieee_quantize=True):
            st = jhs.init_state(jb.init(jax.random.PRNGKey(0)), jspec)
            st, _ = jax.jit(lambda s, b: jhs.round_step(
                s, b, jb.train_loss, jspec, jnp.float32(ETA)))(st, _jnp(sb0))
            st = jax.device_get(st)
            jst, jm = jax.jit(lambda s, b: jhs.round_step_overlapped(
                s, b, jb.train_loss, jspec, jnp.float32(ETA)))(
                    _jnp(st), _jnp(sb1))
        out[wire] = (st, sb1, jax.device_get(jst), jax.device_get(jm))
    return out


@pytest.mark.parametrize("wire", WIRES)
def test_round_step_overlapped_matches_reference(overlapped, wire):
    st, sb, jst, jm = overlapped[wire]
    _, tb, _, tspec = _specs(wire)
    tst, tm = ths.round_step_overlapped(convert.state_from_jax(st, "cpu"),
                                        _torch(sb), tb.train_loss, tspec, ETA)
    _assert_state(tst, jst)
    assert_tree_close(tst["mom"], jst["mom"], RTOL, ATOL)
    assert ("wire" in tst) == ("wire" in jst) == wire.startswith("topk")
    for k, w in enumerate(jst.get("wire", [])):
        if w:
            assert_tree_close(tst["wire"][k], w, RTOL, ATOL)
    np.testing.assert_allclose(to_np(tm.losses), np.asarray(jm.losses),
                               rtol=RTOL)
    np.testing.assert_allclose(float(tm.r_primal), float(jm.r_primal),
                               rtol=1e-4)


@pytest.mark.parametrize("wire", ["dense", "topk:0.01"])
def test_overlapped_round_is_consensus_plus_local_steps(overlapped, wire):
    """Every consensus-owned entry of the overlapped round's state is the
    port's ``consensus_step`` over the input state, and theta and mom are
    E ``local_step``s from that same state, bit for bit."""
    st, sb, _, _ = overlapped[wire]
    _, tb, _, tspec = _specs(wire)
    state = convert.state_from_jax(st, "cpu")
    sbt = _torch(sb)
    out, _ = ths.round_step_overlapped(state, sbt, tb.train_loss, tspec, ETA)
    cst, _ = tcons.consensus_step(state, tspec, frozen=False, detail=False)
    assert set(out) == set(cst)
    flat_o, flat_c = ckpt._flatten(out), ckpt._flatten(cst)
    owned = [p for p in flat_c if not p.startswith(("theta/", "mom/"))]
    assert any(p.startswith("wire/") for p in owned) == (wire != "dense")
    for p in owned:
        assert torch.equal(flat_o[p], flat_c[p]), p
    scan = state
    for e in range(HP.local_steps):
        scan, _ = ths.local_step(scan, {k: v[e] for k, v in sbt.items()},
                                 tb.train_loss, tspec, ETA)
    for grp in ("theta", "mom"):
        for key, x in scan[grp].items():
            assert torch.equal(out[grp][key], x), (grp, key)


def _t_engine(hier="chip", wire=None, staleness=0, device="cpu", p0=None):
    hp = _hp(wire, staleness=staleness)
    tb = t_build(t_get_config("resnet18", smoke=True).replace(hsadmm=hp))
    if p0 is not None:
        tb = dataclasses.replace(
            tb, init=lambda gen, device: convert.params_from_jax(p0, device))
    return Engine(tb, T_SHAPE, consensus=HIERARCHIES[hier], device=device)


@pytest.mark.parametrize("hier,wire", [
    ("chip", "dense"), ("chip", "topk:0.01"),
    ("pod", "compact+q8"), ("flat", "dense"),
])
def test_staleness1_bounded_divergence(hier, wire):
    """Four overlapped rounds and a flush track four sequential rounds
    (the reference's ``test_overlap.py`` tolerances): round 1 is
    bit-equal (both read the same z0), the losses stay within rtol 5e-2 /
    atol 1e-2 and theta within a relative l2 of 5e-2; the flush advances
    k past the pending consensus and has no losses."""
    eng = _t_engine(hier, wire)
    ovl = eng.with_staleness(1)
    assert ovl.cfg.hsadmm.staleness == 1
    it = superbatches(batches(make_stream(eng.cfg, T_SHAPE, eng.workers,
                                          device="cpu")), HP.local_steps)
    sbs = [next(it) for _ in range(4)]
    eta = torch.tensor(3e-3)
    runs = {}
    for name, e in (("seq", eng), ("ovl", ovl)):
        st = e.init_state_fn()(0)
        fn = e.round_step_fn(frozen=False)
        losses = []
        for sb in sbs:
            st, m = fn(st, sb, eta)
            losses.append(to_np(m.losses))
        runs[name] = st, np.stack(losses)
    (s_seq, l_seq), (s_ovl, l_ovl) = runs["seq"], runs["ovl"]
    assert int(s_seq["k"]) == int(s_ovl["k"]) == 4
    s_ovl, m_flush = ovl.flush_pipeline_fn(frozen=False)(s_ovl)
    assert int(s_ovl["k"]) == 5
    assert m_flush.losses.numel() == 0
    np.testing.assert_array_equal(l_ovl[0], l_seq[0])
    np.testing.assert_allclose(l_ovl, l_seq, rtol=5e-2, atol=1e-2)
    for key, x in s_seq["theta"].items():
        x, y = to_np(x).astype(np.float64), to_np(s_ovl["theta"][key])
        d = np.linalg.norm((x - y).ravel())
        assert d <= 5e-2 * (np.linalg.norm(x.ravel()) + 1e-6), key


def _p0():
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=HP))
    return jax.device_get(jb.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("wire,kw", [
    ("compact+q8", {}),
    ("compact+q4", {"reconfig": True}),
])
def test_train_staleness1_matches_reference(wire, kw):
    """``train`` at ``staleness=1`` (the engine rebuilt through
    ``with_staleness``) against the JAX ``train``: 5 rounds, frozen from
    round 2; with ``reconfig=True`` both flush the pipeline and migrate
    onto the budget-B model before round 3."""
    hp = _hp(wire)
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=hp))
    with jax_reference(ieee_quantize=True):
        jst, jrep = j_train(JEngine(jb, make_host_mesh(), SHAPE,
                                    consensus=LEVELS),
                            JRunConfig(outer_iters=5, shape=SHAPE, eta=ETA,
                                       staleness=1, log=None, **kw))
    jst = jax.device_get(jst)
    tst, trep = train(_t_engine(wire=wire, p0=_p0()),
                      RunConfig(outer_iters=5, shape=T_SHAPE, eta=ETA,
                                staleness=1, log=None, **kw))
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-3)
    assert trep.frozen_at == jrep.frozen_at == 2
    assert trep.reconfigured_at == jrep.reconfigured_at \
        == (3 if kw else None)
    assert trep.executables == jrep.executables
    assert trep.comm_bytes_internode == jrep.comm_bytes_internode
    assert trep.comm_bytes_dense_equiv == jrep.comm_bytes_dense_equiv
    assert trep.final_engine.cfg.hsadmm.staleness == 1
    # 5 overlapped rounds, plus the flush before a reconfiguration
    assert int(tst["k"]) == int(jst["k"]) == 5 + bool(kw)
    for rule, m in jst["masks"].items():
        np.testing.assert_array_equal(to_np(tst["masks"][rule]["idx"]),
                                      np.asarray(m["idx"]), err_msg=rule)


def test_overlapped_resume_continues_the_pipeline(tmp_path):
    """An overlapped run saved at round 2 holds its state as it is (one
    theta pending), and ``train`` resumed from it to round 4 is bit-equal
    to the run that goes on from the state in memory.  As in the
    reference, the resumed run reads the stream from its first batch and
    is dynamic until the schedule freezes it again, so that run is the
    round functions over those batches (dynamic, then frozen)."""
    eng = _t_engine(wire="compact+q8", staleness=1)
    d = str(tmp_path / "ovl")
    st2, rep2 = train(eng, RunConfig(outer_iters=2, shape=T_SHAPE, eta=ETA,
                                     ckpt_dir=d, ckpt_every=2, log=None))
    back, meta = ckpt.restore(ckpt.latest(d), st2)
    assert meta["step"] == 2
    for p, x in ckpt._flatten(st2).items():
        assert torch.equal(ckpt._flatten(back)[p], x), p
    st4, rep4 = train(eng, RunConfig(outer_iters=4, shape=T_SHAPE, eta=ETA,
                                     ckpt_dir=d, ckpt_every=0, log=None))
    assert rep4.executables == ["dynamic", "frozen"]
    it = superbatches(batches(make_stream(eng.cfg, T_SHAPE, eng.workers,
                                          device="cpu")), HP.local_steps)
    eta = torch.tensor(ETA)
    state, losses = st2, []
    for frozen in (False, True):
        state, m = eng.round_step_fn(frozen=frozen)(state, next(it), eta)
        losses.append(float(m.losses[-1]))
    assert rep4.losses == losses
    flat4 = ckpt._flatten(st4)
    for p, x in ckpt._flatten(state).items():
        assert torch.equal(flat4[p], x), p
