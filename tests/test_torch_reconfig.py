"""Physical reconfiguration in the port, against the JAX reference and
against itself.

* The width mapping, the shrunk plan and the whole-state migration
  (``shrink_config``, ``shrunk_plan``, ``shrunk_projection_mask_state``,
  ``compact_state``/``expand_state``, ``Engine.reconfigure``) equal the
  JAX package's on one numpy state, exactly.
* The port's reconfigured frozen round equals its own full-shape masked
  round from ``expand_reconfigured`` (the reference's conformance claim,
  at its tolerance).
* ``train(..., reconfig=True)`` over a compact+q4 inter-node wire follows
  the JAX ``train`` round for round.

resnet-smoke throughout: full-width resnet18 has no projection-only
(S_s) rules, the smoke config has them.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ConsensusSpec, HsadmmConfig, ShapeConfig, get_config  # noqa: E402
from repro.core import hsadmm as jhs  # noqa: E402
from repro.core import shrinkage as jsh  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import shrink_config as j_shrink_config  # noqa: E402
from repro.train.engine import Engine as JEngine  # noqa: E402
from repro.train.loop import train as j_train  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import shrinkage as tsh  # noqa: E402
from repro_torch.data.pipeline import batches, superbatches  # noqa: E402
from repro_torch.data.synthetic import make_stream  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.models import shrink_config as t_shrink_config  # noqa: E402
from repro_torch.train.engine import Engine  # noqa: E402
from repro_torch.train.loop import RunConfig, train  # noqa: E402

from torch_port_helpers import (jax_reference, np_flat, perturbed,  # noqa: E402
                                to_np)

HP = HsadmmConfig(rho1=1e-2, rho2=1e-3, local_steps=2, t_freeze=2,
                  reconfig_patience=1)
LEVELS = ConsensusSpec(levels=(2, 2), compact_from_level=1)
HIERARCHIES = {
    "chip": ConsensusSpec(levels=(2, 2), compact_from_level=1),
    "pod": ConsensusSpec(levels=(2, 2), compact_from_level=0,
                         granularity="pod"),
    "flat": ConsensusSpec(levels=(4,), compact_from_level=1,
                          granularity="flat"),
}
SHAPE = ShapeConfig("tiny", "train", 32, 8)
ETA = 3e-3


def _shapes(tree, prefix=""):
    """Nested tree of arrays or shape structs -> {"/"-joined key: shape}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_shapes(v, path) if isinstance(v, dict)
                   else {path: tuple(v.shape)})
    return out


def _rule_tuple(r):
    return (r.name, r.groups, r.keep, r.stack_ndims, r.shards, r.group_size,
            tuple((la.key, la.axes) for la in r.leaves),
            tuple((la.key, la.axes) for la in r.followers))


def _cfgs(arch="resnet18", hp=HP):
    return (get_config(arch, smoke=True).replace(hsadmm=hp),
            t_get_config(arch, smoke=True).replace(hsadmm=hp))


@pytest.mark.parametrize("arch,smoke", [("resnet18", True),
                                        ("resnet18", False),
                                        ("resnet152", True)])
def test_shrink_config_and_shrunk_plan_equal_reference(arch, smoke):
    jcfg = get_config(arch, smoke=smoke).replace(hsadmm=HP)
    tcfg = t_get_config(arch, smoke=smoke).replace(hsadmm=HP)
    jb, tb = j_build(jcfg), t_build(tcfg)
    jbud = jhs.EngineSpec(plan=jb.plan, consensus=LEVELS, hp=HP).budgets
    tbud = Engine(tb, consensus=LEVELS, device="cpu").spec.budgets
    assert jbud == tbud
    j2 = j_shrink_config(jcfg, jb.plan, jbud)
    t2 = t_shrink_config(tcfg, tb.plan, tbud)
    assert (t2.cnn_stem, t2.cnn_outs, t2.cnn_cmid) == \
        (j2.cnn_stem, j2.cnn_outs, j2.cnn_cmid)
    shapes = dict(tb.shapes)
    assert [_rule_tuple(r) for r in
            tsh.shrunk_plan(tb.plan, tbud, shapes).rules] == \
        [_rule_tuple(r) for r in jsh.shrunk_plan(jb.plan, jbud, shapes).rules]
    # the shrunk model's leaves are those of the reference's shrunk model
    jp = jax.eval_shape(j_build(j2).init, jax.random.PRNGKey(0))
    assert _shapes(jp) == dict(t_build(t2).shapes)


@pytest.fixture(scope="module")
def frozen():
    """A full-shape resnet-smoke state as numpy: init + seeded noise on
    every iterate and dual, and a random frozen mask per rule (S_s rules
    included)."""
    jcfg, _ = _cfgs()
    jb = j_build(jcfg)
    jspec = jhs.EngineSpec(plan=jb.plan, consensus=LEVELS, hp=HP)
    st = jax.device_get(jhs.init_state(jb.init(jax.random.PRNGKey(0)), jspec))
    for i, name in enumerate(("theta", "u", "mom")):
        st[name] = perturbed(st[name], seed=i)
    st["z"] = [perturbed(z, seed=10 + i) for i, z in enumerate(st["z"])]
    st["v"] = [perturbed(v, seed=20 + i) for i, v in enumerate(st["v"])]
    rng = np.random.default_rng(7)
    for r in jb.plan.rules:
        scores = rng.random((r.groups,)).astype(np.float32)
        mask, idx = jsp.topk_mask(jnp.asarray(scores), r.keep)
        st["masks"][r.name] = {
            "idx": np.asarray(idx), "valid": np.ones(idx.shape, np.float32),
            "mask": np.asarray(mask), "drift": np.zeros((), np.float32)}
    return st


def _j_engine(hier="chip", wire=None):
    jcfg, _ = _cfgs(hp=dataclasses.replace(HP, wire_inter=wire))
    return JEngine(j_build(jcfg), make_host_mesh(), SHAPE,
                   consensus=HIERARCHIES[hier])


def _t_engine(hier="chip", wire=None, device="cpu"):
    _, tcfg = _cfgs(hp=dataclasses.replace(HP, wire_inter=wire))
    return Engine(t_build(tcfg), SHAPE, consensus=HIERARCHIES[hier],
                  device=device)


def _assert_state_equal(tst, jst):
    for name in ("theta", "mom", "u"):
        for k, v in np_flat(jst[name]).items():
            np.testing.assert_array_equal(to_np(tst[name][k]), v, err_msg=k)
    for name in ("z", "v"):
        for tt, jt in zip(tst[name], jst[name], strict=True):
            for k, v in np_flat(jt).items():
                np.testing.assert_array_equal(to_np(tt[k]), v, err_msg=k)
    assert set(tst["masks"]) == set(jst["masks"])
    for rule, m in jst["masks"].items():
        for f, v in m.items():
            np.testing.assert_array_equal(to_np(tst["masks"][rule][f]),
                                          np.asarray(v), err_msg=rule)


def test_shrunk_projection_mask_states_equal_reference(frozen):
    jeng, teng = _j_engine(), _t_engine()
    jplan, tplan = jeng.spec.plan, teng.spec.plan
    budgets, shapes = teng.spec.budgets, dict(teng.bundle.shapes)
    tmasks = convert.masks_from_jax(frozen["masks"], device="cpu")
    jidx = {r: jnp.asarray(m["idx"]) for r, m in frozen["masks"].items()}
    tidx = {r: m["idx"] for r, m in tmasks.items()}
    j2 = jsh.shrunk_plan(jplan, budgets, shapes)
    t2 = tsh.shrunk_plan(tplan, budgets, shapes)
    s_rules = [r for r in tplan.rules if not r.compactable]
    assert s_rules, "resnet-smoke has projection-only shape rules"
    for r in s_rules:
        jm = jsh.shrunk_projection_mask_state(
            jplan.rule(r.name), j2.rule(r.name),
            jax.tree.map(jnp.asarray, frozen["masks"][r.name]), jplan, jidx,
            shapes)
        tm = tsh.shrunk_projection_mask_state(
            r, t2.rule(r.name), tmasks[r.name], tplan, tidx, shapes)
        for f, v in jm.items():
            np.testing.assert_array_equal(to_np(tm[f]), np.asarray(v),
                                          err_msg=f"{r.name}/{f}")


def test_compact_and_expand_state_equal_reference(frozen):
    """The two migration functions, on one state and one set of new
    masks, leaf for leaf."""
    jeng, teng = _j_engine(), _t_engine()
    jplan, tplan = jeng.spec.plan, teng.spec.plan
    tstate = convert.state_from_jax(frozen, device="cpu")
    jstate = jax.tree.map(jnp.asarray, frozen)
    jidx = {r: jstate["masks"][r]["idx"] for r in jstate["masks"]}
    tidx = {r: tstate["masks"][r]["idx"] for r in tstate["masks"]}
    jc = jsh.compact_state(jstate, jplan, jidx, jstate["masks"])
    tc = tsh.compact_state(tstate, tplan, tidx, tstate["masks"])
    _assert_state_equal(tc, jax.device_get(jc))
    fulls = {r.name: r.groups for r in tplan.rules}
    je = jsh.expand_state(jc, jplan, jidx, fulls, jstate["masks"])
    te = tsh.expand_state(tc, tplan, tidx, fulls, tstate["masks"])
    _assert_state_equal(te, jax.device_get(je))


@pytest.mark.parametrize("wire", [None, "compact+q4"])
def test_engine_reconfigure_equals_reference(frozen, wire):
    """``Engine.reconfigure`` migrates the whole state exactly as the
    reference's does (identity masks for the compacted rules, S_s masks
    gathered onto the kept channels), and ``expand_reconfigured`` inverts
    it the same way."""
    jeng, teng = _j_engine(wire=wire), _t_engine(wire=wire)
    jeng2, jst_c = jeng.reconfigure(jax.tree.map(jnp.asarray, frozen))
    teng2, tst_c = teng.reconfigure(convert.state_from_jax(frozen, device="cpu"))
    assert teng2.reconfigured and teng2.parent is teng
    assert not teng.reconfigured
    assert (teng2.cfg.cnn_stem, teng2.cfg.cnn_outs, teng2.cfg.cnn_cmid) == \
        (jeng2.cfg.cnn_stem, jeng2.cfg.cnn_outs, jeng2.cfg.cnn_cmid) == \
        (8, (8, 16), (8, 16))
    assert [c.name for c in teng2.spec.codecs] == \
        [c.name for c in jeng2.spec.codecs]
    jst_c = jax.device_get(jst_c)
    _assert_state_equal(tst_c, jst_c)
    assert tst_c["theta"]["stem"].shape == (4, 3, 3, 3, 8)
    assert tst_c["theta"]["fc_w"].shape == (4, 16, 10)
    _assert_state_equal(teng2.expand_reconfigured(tst_c),
                        jax.device_get(jeng2.expand_reconfigured(
                            jax.tree.map(jnp.asarray, jst_c))))
    with pytest.raises(ValueError, match="already reconfigured"):
        teng2.reconfigure(tst_c)


def test_reconfigure_from_masks_only(frozen):
    teng = _t_engine("chip", "compact+q4")
    teng2, none = teng.reconfigure(
        masks=convert.masks_from_jax(frozen["masks"], device="cpu"))
    assert none is None and teng2.reconfigured
    st = teng2.init_state_fn()(0)
    assert st["theta"]["layer1/b0/conv1"].shape == (4, 3, 3, 8, 16)
    with pytest.raises(ValueError, match="needs state= or masks="):
        teng.reconfigure()


# ---------------------------------------------------------------------------
# conformance: reconfigured round == full-shape masked round (port only)
# ---------------------------------------------------------------------------


def _superbatches(eng):
    return superbatches(batches(make_stream(eng.cfg, SHAPE, eng.workers,
                                            device=eng.device)),
                        HP.local_steps)


def _close(a: dict, b: dict, rtol=5e-4, atol=1e-5):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(to_np(a[k]), to_np(b[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("hier", sorted(HIERARCHIES))
@pytest.mark.parametrize("wire", [None, "compact+q8", "compact+q4"])
def test_reconfigured_round_matches_full_shape(hier, wire):
    """Under frozen masks, rounds of the reconfigured engine equal rounds
    of the full-shape masked round from the migrated state's zero-fill
    expansion: losses, residuals and expanded params (the reference's
    tolerance, tests/test_reconfig.py)."""
    eng = _t_engine(hier, wire)
    it = _superbatches(eng)
    eta = torch.tensor(ETA)
    rdyn = eng.round_step_fn(frozen=False)
    rfrz = eng.round_step_fn(frozen=True)
    state = eng.init_state_fn()(0)
    for _ in range(2):
        state, _ = rdyn(state, next(it), eta)
    state, _ = rfrz(state, next(it), eta)

    eng2, st_c = eng.reconfigure(state)
    st_ref = eng2.expand_reconfigured(st_c)
    rfrz2 = eng2.round_step_fn(frozen=True)
    for _ in range(2):
        sb = next(it)
        st_ref, m_ref = rfrz(st_ref, sb, eta)
        st_c, m_c = rfrz2(st_c, sb, eta)
        np.testing.assert_allclose(to_np(m_c.losses), to_np(m_ref.losses),
                                   rtol=5e-4, atol=1e-5)
        for f in ("r_primal", "s_dual"):
            np.testing.assert_allclose(float(getattr(m_c, f)),
                                       float(getattr(m_ref, f)),
                                       rtol=2e-3, atol=1e-5)
        assert float(m_c.drift) == 0.0
    full2 = eng2.expand_reconfigured(st_c)
    for grp in ("theta", "u", "mom"):
        _close(full2[grp], st_ref[grp])
    for zf, zr in zip(full2["z"], st_ref["z"], strict=True):
        _close(zf, zr)
    for rf, rr in zip(full2["rho"], st_ref["rho"], strict=True):
        _close(rf, rr, rtol=2e-3)


# ---------------------------------------------------------------------------
# the loop, against the JAX loop
# ---------------------------------------------------------------------------

LOOP_HP = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=4, t_freeze=2,
                       reconfig_patience=1, wire_inter="compact+q4")
LOOP_SHAPE = ShapeConfig("tiny", "train", 32, 16)


@pytest.fixture(scope="module")
def runs():
    """5 rounds of both packages with reconfig=True from the same
    (JAX-drawn) init: dynamic, dynamic, frozen, reconfigured x2."""
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=LOOP_HP))
    p0 = jax.device_get(jb.init(jax.random.PRNGKey(0)))
    from repro.train.loop import RunConfig as JRunConfig
    with jax_reference(ieee_quantize=True):
        jst, jrep = j_train(
            JEngine(jb, make_host_mesh(), LOOP_SHAPE, consensus=LEVELS),
            JRunConfig(outer_iters=5, shape=LOOP_SHAPE, eta=1e-2,
                       reconfig=True, log=None))
    tb = t_build(t_get_config("resnet18", smoke=True).replace(
        hsadmm=LOOP_HP))
    tb = dataclasses.replace(
        tb, init=lambda gen, device: convert.params_from_jax(p0, device))
    tst, trep = train(Engine(tb, LOOP_SHAPE, consensus=LEVELS, device="cpu"),
                      RunConfig(outer_iters=5, shape=LOOP_SHAPE, eta=1e-2,
                                reconfig=True, log=None))
    return jax.device_get(jst), jrep, tst, trep


def test_reconfig_train_matches_reference(runs):
    jst, jrep, tst, trep = runs
    assert trep.executables == jrep.executables == \
        ["dynamic"] * 2 + ["frozen"] + ["reconfigured"] * 2
    assert trep.frozen_at == jrep.frozen_at == 2
    assert trep.reconfigured_at == jrep.reconfigured_at == 3
    assert trep.comm_bytes_internode == jrep.comm_bytes_internode
    assert trep.comm_bytes_dense_equiv == jrep.comm_bytes_dense_equiv
    assert trep.wire_map == jrep.wire_map == ["dense", "compact+q4"]
    assert trep.wire_map_reconfigured == jrep.wire_map_reconfigured
    assert trep.reconfig_seconds is not None and trep.reconfig_seconds >= 0
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-3)
    assert trep.final_engine.reconfigured


def test_reconfig_train_final_state_matches_reference(runs):
    """The final (shrunk) iterates, consensus z and migrated masks,
    through ``convert``."""
    jst, _, tst, _ = runs
    ref = convert.state_from_jax(jst, device="cpu")
    assert tst["theta"]["stem"].shape == ref["theta"]["stem"].shape \
        == (4, 3, 3, 3, 8)
    for grp in ("theta", "u"):
        _close(tst[grp], ref[grp], rtol=1e-3, atol=1e-5)
    for tz, jz in zip(tst["z"], ref["z"], strict=True):
        _close(tz, jz, rtol=1e-3, atol=1e-5)
    for rule, m in ref["masks"].items():
        assert torch.equal(tst["masks"][rule]["idx"], m["idx"]), rule


def test_run_reconfig_patience_overrides_the_config():
    """``RunConfig.reconfig_patience`` (fault F): set, it replaces
    ``HsadmmConfig.reconfig_patience`` (1 here), as in the reference; the
    run then waits two frozen rounds before it reconfigures."""
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=LOOP_HP))
    p0 = jax.device_get(jb.init(jax.random.PRNGKey(0)))
    from repro.train.loop import RunConfig as JRunConfig
    with jax_reference(ieee_quantize=True):
        _, jrep = j_train(
            JEngine(jb, make_host_mesh(), LOOP_SHAPE, consensus=LEVELS),
            JRunConfig(outer_iters=5, shape=LOOP_SHAPE, eta=1e-2,
                       reconfig=True, reconfig_patience=2, log=None))
    tb = t_build(t_get_config("resnet18", smoke=True).replace(
        hsadmm=LOOP_HP))
    tb = dataclasses.replace(
        tb, init=lambda gen, device: convert.params_from_jax(p0, device))
    _, trep = train(Engine(tb, LOOP_SHAPE, consensus=LEVELS, device="cpu"),
                    RunConfig(outer_iters=5, shape=LOOP_SHAPE, eta=1e-2,
                              reconfig=True, reconfig_patience=2, log=None))
    assert trep.executables == jrep.executables == \
        ["dynamic"] * 2 + ["frozen"] * 2 + ["reconfigured"]
    assert trep.reconfigured_at == jrep.reconfigured_at == 4
    assert trep.comm_bytes_internode == jrep.comm_bytes_internode
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-3)
