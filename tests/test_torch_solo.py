"""The single-worker solo mode in the port (one worker at pod granularity:
no consensus variables; each round's "consensus" projects theta onto
masks scored on theta itself), against the JAX package:

* ``consensus_step`` on the inputs of ``test_hsadmm.py::
  test_solo_mode_projects_theta``;
* four resnet-smoke rounds of the port's ``train`` against the JAX
  ``round_step`` (outside a mesh: the JAX ``Engine`` cannot run a solo
  CNN round on this host, ROADMAP §3 fault L);
* a solo run through physical reconfiguration, its bytes (none) and its
  masks, and the overlapped round, which in solo mode is the sequential
  one;
* solo states through ``convert`` and through checkpoints both ways.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ConsensusSpec, HsadmmConfig, ShapeConfig, get_config  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import hsadmm as jhs  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.data.synthetic import make_stream as j_make_stream  # noqa: E402
from repro.dist import checkpoint as jckpt  # noqa: E402
from repro.models import build as j_build  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ShapeConfig as TShapeConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import hsadmm as ths  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.dist import checkpoint as ckpt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.train.engine import Engine  # noqa: E402
from repro_torch.train.loop import RunConfig, round_comm_bytes, train  # noqa: E402

from torch_port_helpers import jax_reference, np_flat, perturbed, to_np  # noqa: E402

RTOL = 1e-5
SOLO = ConsensusSpec(levels=(1,), compact_from_level=0, granularity="pod")
HP = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=2, t_freeze=2,
                  reconfig_patience=1)
SHAPE = ShapeConfig("tiny", "train", 32, 16)
T_SHAPE = TShapeConfig("tiny", "train", 32, 16)
ETA = 1e-2


@pytest.fixture(autouse=True)
def _flushed():
    yield
    ckpt.flush()


def test_solo_consensus_step_matches_reference():
    """The reference test's inputs: one stacked two-layer FFN rule, 8 of
    16 groups kept.  Masks equal, theta at rtol 1e-5, zero residuals."""
    key = jax.random.PRNGKey(5)
    params0 = {"blocks": {"w_in": jax.random.normal(key, (2, 4, 16)),
                          "w_out": jax.random.normal(key, (2, 16, 4))}}

    def plan(m):
        return m.SparsityPlan((m.GroupRule(
            "ffn", (m.LeafAxis("blocks/w_in", 2),
                    m.LeafAxis("blocks/w_out", 1)),
            groups=16, keep=8, stack_ndims=1),))
    jspec = jhs.EngineSpec(plan=plan(jsp), consensus=SOLO, hp=HsadmmConfig(),
                           use_momentum=True)
    tspec = ths.EngineSpec(plan=plan(tsp), consensus=SOLO, hp=HsadmmConfig(),
                           use_momentum=True)
    assert jspec.solo and tspec.solo
    jst = jhs.init_state(params0, jspec)
    tst = ths.init_state(convert.params_from_jax(
        jax.device_get(params0), "cpu"), tspec)
    assert sorted(tst) == sorted(jst) == ["k", "masks", "mom", "theta",
                                          "weights"]
    j2, jinfo = jcons.consensus_step(jst, jspec, frozen=False)
    t2, tinfo = tcons.consensus_step(tst, tspec, frozen=False)
    for f in ("idx", "mask", "valid"):
        np.testing.assert_array_equal(to_np(t2["masks"]["ffn"][f]),
                                      np.asarray(j2["masks"]["ffn"][f]))
    for key, v in np_flat(j2["theta"]).items():
        np.testing.assert_allclose(to_np(t2["theta"][key]), v, rtol=RTOL)
    m = to_np(t2["masks"]["ffn"]["mask"])
    assert float(m.sum(-1)[0]) == 8
    w = to_np(t2["theta"]["blocks/w_in"])[0]
    assert (np.abs(w).sum(1) > 0).sum() == 2 * 8
    assert int(t2["k"]) == int(j2["k"]) == 1
    assert float(tinfo["r_primal"]) == float(tinfo["s_dual"]) == 0.0
    assert float(jinfo["r_primal"]) == 0.0


def _p0():
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=HP))
    return jb, jax.device_get(jb.init(jax.random.PRNGKey(0)))


def _t_engine(p0=None, **hp):
    tb = t_build(t_get_config("resnet18", smoke=True)
                 .replace(hsadmm=dataclasses.replace(HP, **hp)))
    if p0 is not None:
        tb = dataclasses.replace(
            tb, init=lambda gen, device: convert.params_from_jax(p0, device))
    return Engine(tb, T_SHAPE, consensus=SOLO, device="cpu")


def test_solo_train_matches_reference():
    """Four resnet-smoke rounds (two dynamic, two frozen): the port's
    ``train`` against the JAX ``round_step`` on the same superbatches,
    losses at rtol 1e-3 (``test_train_matches_reference``), mask indices
    equal after every round, theta at rtol 1e-3."""
    jb, p0 = _p0()
    jspec = jhs.EngineSpec(plan=jb.plan, consensus=SOLO, hp=HP,
                           stack_map=tuple(jb.stack_map))
    stream = j_make_stream(jb.cfg, SHAPE, 1)
    E = HP.local_steps
    masks, jlosses = [], []
    with jax_reference():
        step = jax.jit(lambda s, b, f: jhs.round_step(
            s, b, jb.train_loss, jspec, jnp.float32(ETA), frozen=f),
            static_argnums=2)
        st = jhs.init_state(jax.tree.map(jnp.asarray, p0), jspec)
        for r, frozen in enumerate((False, False, True, True)):
            sb = {k: jnp.stack([jnp.asarray(stream.batch_at(r * E + s)[k])
                                for s in range(E)])
                  for k in ("images", "labels")}
            st, m = step(st, sb, frozen)
            jlosses.append(float(m.losses[-1]))
            masks.append(jax.device_get(st["masks"]))
    jst = jax.device_get(st)

    tmasks = []
    tst, rep = train(_t_engine(p0), RunConfig(
        outer_iters=4, shape=T_SHAPE, eta=ETA, log=None,
        eval_fn=lambda k, s: tmasks.append(
            {n: m["idx"].clone() for n, m in s["masks"].items()})))
    assert rep.executables == ["dynamic"] * 2 + ["frozen"] * 2
    assert rep.wire_map is None
    assert rep.comm_bytes_internode == [0] * 4
    np.testing.assert_allclose(rep.losses, jlosses, rtol=1e-3)
    for k, jm in enumerate(masks):
        for rule, m in jm.items():
            np.testing.assert_array_equal(to_np(tmasks[k][rule]),
                                          np.asarray(m["idx"]),
                                          err_msg=f"round {k} {rule}")
    assert sorted(tst) == sorted(jst)
    assert int(tst["k"]) == int(jst["k"]) == 4
    for key, v in np_flat(jst["theta"]).items():
        np.testing.assert_allclose(to_np(tst["theta"][key]), v, rtol=1e-3,
                                   atol=1e-5, err_msg=key)


def test_solo_run_reconfigures_and_keeps_its_budgets():
    """A solo run with ``reconfig=True``: no bytes between nodes, each
    rule's mask keeps its budget, theta's pruned groups are zero when the
    masks freeze, the run migrates onto the budget-B model, and prox-SGD
    takes the plain update (no prox term)."""
    eng = _t_engine()
    assert round_comm_bytes(eng)[1:] == (0, 0)
    frozen = {}

    def keep(k, state):
        if k == 1:   # the last dynamic round: masks and theta as they froze
            frozen.update(state)
    ops.reset_launch_counts()
    st, rep = train(eng, RunConfig(outer_iters=5, shape=T_SHAPE, eta=ETA,
                                   reconfig=True, eval_fn=keep, log=None))
    assert ops.launch_counts()["fused_prox_sgd_dyn"] == 0
    assert rep.executables == ["dynamic"] * 2 + ["frozen"] \
        + ["reconfigured"] * 2
    assert (rep.frozen_at, rep.reconfigured_at) == (2, 3)
    assert rep.wire_map is None and rep.wire_map_reconfigured is None
    assert rep.comm_bytes_internode == [0] * 5
    assert np.all(np.isfinite(rep.losses))
    plan, budgets = eng.spec.plan, eng.spec.budgets
    for rule in plan.rules:
        m = frozen["masks"][rule.name]["mask"]
        assert torch.all(m.sum(-1) == budgets[rule.name]), rule.name
        projected = tsp.apply_mask_rule(frozen["theta"], rule, m[None],
                                        offset=1)
        for la in rule.all_leaves:
            assert torch.equal(projected[la.key], frozen["theta"][la.key]), \
                (rule.name, la.key)
    rc = rep.final_engine
    assert rc.reconfigured and rc.spec.solo
    assert sorted(st) == ["k", "masks", "mom", "theta", "weights"]
    for key, shape in rc.bundle.shapes.items():
        assert tuple(st["theta"][key].shape) == (1,) + tuple(shape), key


def test_solo_overlapped_round_is_the_sequential_round():
    a, ra = train(_t_engine(), RunConfig(outer_iters=3, shape=T_SHAPE,
                                         eta=ETA, log=None))
    b, rb = train(_t_engine(), RunConfig(outer_iters=3, shape=T_SHAPE,
                                         eta=ETA, staleness=1, log=None))
    assert ra.losses == rb.losses
    for key, x in a["theta"].items():
        assert torch.equal(b["theta"][key], x), key


def _j_solo_state(use_momentum=True):
    jb, p0 = _p0()
    spec = jhs.EngineSpec(plan=jb.plan, consensus=SOLO, hp=HP,
                          use_momentum=use_momentum)
    st = jax.device_get(jhs.init_state(jax.tree.map(jnp.asarray, p0), spec))
    st["theta"] = perturbed(st["theta"], seed=1)
    if use_momentum:
        st["mom"] = perturbed(st["mom"], seed=2)
    st["k"] = np.int32(3)
    return st, spec, jb


@pytest.mark.parametrize("use_momentum", [True, False])
def test_solo_state_converts_both_ways(use_momentum):
    jst, _, _ = _j_solo_state(use_momentum)
    tst = convert.state_from_jax(jst, device="cpu")
    assert ("mom" in tst) == use_momentum and "z" not in tst
    back = convert.state_to_jax(tst)
    fa, fb = jckpt._flatten(jst), jckpt._flatten(back)
    assert set(fa) == set(fb)
    for p, a in fa.items():
        assert np.asarray(a).dtype == fb[p].dtype, p
        np.testing.assert_array_equal(fb[p], np.asarray(a), err_msg=p)


@pytest.mark.parametrize("use_momentum", [True, False])
def test_solo_checkpoints_cross_both_ways(tmp_path, use_momentum):
    """A solo state saved by the JAX package restores in the port (and
    elastically), and the port's save restores in the JAX package; the
    two saves hold the same arrays."""
    jst, jspec, jb = _j_solo_state(use_momentum)
    tspec = dataclasses.replace(_t_engine().spec, use_momentum=use_momentum)
    ttmpl = ths.init_state({k: torch.zeros(shape) for k, shape in
                            _t_engine().bundle.shapes.items()}, tspec)
    jckpt.save(str(tmp_path / "jax"), jax.tree.map(jnp.asarray, jst),
               {"step": 3})
    last = ckpt.latest(str(tmp_path / "jax"))
    ref = ckpt._flatten(convert.state_from_jax(jst, device="cpu"))
    for restored, _ in (ckpt.restore(last, ttmpl),
                        ckpt.restore_elastic(last, ttmpl, 1)):
        got = ckpt._flatten(restored)
        assert set(got) == set(ref)
        for p, x in ref.items():
            assert got[p].dtype == x.dtype and torch.equal(got[p], x), p
    ckpt.save(str(tmp_path / "port"), convert.state_from_jax(jst, "cpu"),
              {"step": 3})
    ckpt.flush()
    jtmpl = jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jhs.init_state(
            jb.init(jax.random.PRNGKey(0)), jspec)))
    back, meta = jckpt.restore(jckpt.latest(str(tmp_path / "port")), jtmpl)
    assert meta["step"] == 3
    fa, fb = jckpt._flatten(jst), jckpt._flatten(jax.device_get(back))
    assert set(fa) == set(fb)
    for p, a in fa.items():
        np.testing.assert_array_equal(np.asarray(fb[p]), np.asarray(a),
                                      err_msg=p)
