"""The port's loop with checkpoints and fault-tolerance policies, against
the JAX package's ``train``:

* a JAX run saves 4 rounds; both packages resume from copies of its
  directory and run to 6 rounds (full-shape, elastic and reconfigured);
* ``fail_window`` and ``class_scoped`` runs follow the JAX runs;
* all-ones class weights give the unscoped round's bits;
* ``RunConfig.to_json`` / ``from_json``.

resnet-smoke at levels (2, 2); losses within rtol 1e-3 (the tolerance of
``test_torch_train.py::test_train_matches_reference``).
"""
import dataclasses
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ConsensusSpec, HsadmmConfig, ShapeConfig, get_config  # noqa: E402
from repro.dist import ft as jft  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.train.engine import Engine as JEngine  # noqa: E402
from repro.train.loop import RunConfig as JRunConfig  # noqa: E402
from repro.train.loop import train as j_train  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ShapeConfig as TShapeConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.consensus import lead_classes  # noqa: E402
from repro_torch.data.pipeline import batches, superbatches  # noqa: E402
from repro_torch.data.synthetic import make_stream  # noqa: E402
from repro_torch.dist import checkpoint as ckpt  # noqa: E402
from repro_torch.dist import ft  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.train.engine import Engine  # noqa: E402
from repro_torch.train.loop import RunConfig, train  # noqa: E402

from torch_port_helpers import jax_reference, to_np  # noqa: E402

Q8 = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=2, t_freeze=2,
                  wire_inter="compact+q8")
Q4 = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=2, t_freeze=2,
                  reconfig_patience=1, wire_inter="compact+q4")
LEVELS = ConsensusSpec(levels=(2, 2), compact_from_level=1)
SHAPE = ShapeConfig("tiny", "train", 32, 16)
T_SHAPE = TShapeConfig("tiny", "train", 32, 16)
ETA = 1e-2


def _p0(hp):
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=hp))
    return jb, jax.device_get(jb.init(jax.random.PRNGKey(0)))


def _j_run(hp, consensus=LEVELS, **kw):
    jb, _ = _p0(hp)
    with jax_reference(ieee_quantize=True):
        st, rep = j_train(JEngine(jb, make_host_mesh(), SHAPE,
                                  consensus=consensus),
                          JRunConfig(shape=SHAPE, eta=ETA, log=None, **kw))
    return jax.device_get(st), rep


def _t_engine(hp, consensus=LEVELS):
    _, p0 = _p0(hp)
    tb = t_build(t_get_config("resnet18", smoke=True).replace(hsadmm=hp))
    tb = dataclasses.replace(
        tb, init=lambda gen, device: convert.params_from_jax(p0, device))
    return Engine(tb, T_SHAPE, consensus=consensus, device="cpu")


def _t_run(hp, consensus=LEVELS, **kw):
    return train(_t_engine(hp, consensus),
                 RunConfig(shape=T_SHAPE, eta=ETA, log=None, **kw))


def _assert_reports_match(trep, jrep):
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-3)
    assert trep.executables == jrep.executables
    assert trep.frozen_at == jrep.frozen_at
    assert trep.reconfigured_at == jrep.reconfigured_at
    assert trep.comm_bytes_internode == jrep.comm_bytes_internode
    assert trep.comm_bytes_dense_equiv == jrep.comm_bytes_dense_equiv
    assert trep.wire_map == jrep.wire_map
    assert trep.wire_map_reconfigured == jrep.wire_map_reconfigured


def _assert_masks_equal(tst, jst):
    assert set(tst["masks"]) == set(jst["masks"])
    for rule, m in jst["masks"].items():
        np.testing.assert_array_equal(to_np(tst["masks"][rule]["idx"]),
                                      np.asarray(m["idx"]), err_msg=rule)


# ---------------------------------------------------------------------------
# resume from a JAX run's checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{kind: directory} of a JAX run's checkpoints after 4 rounds saved
    every 2 (full-shape compact+q8; compact+q4 reconfigured at round 3)."""
    out = {}
    for kind, hp, kw in (("q8", Q8, {}), ("reconfig", Q4,
                                          {"reconfig": True})):
        d = tmp_path_factory.mktemp(kind)
        _, rep = _j_run(hp, outer_iters=4, ckpt_dir=str(d), ckpt_every=2,
                        ckpt_keep=1, **kw)
        assert rep.outer_iters == 4
        out[kind] = d
    return out


def _copy(src, tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(src, dst)
    return str(dst)


def test_the_jax_run_saved_what_the_port_reads(saved):
    for kind, d in saved.items():
        last = ckpt.latest(str(d))
        assert last.endswith("ckpt_00000004")
        meta = ckpt.read_meta(last)
        assert meta["step"] == 4 and meta["workers"] == 4
        assert meta["levels"] == [2, 2]
        assert meta["reconfigured"] == (kind == "reconfig")
        assert bool(ckpt.load_aux(last)) == (kind == "reconfig")


@pytest.mark.parametrize("kind", ["q8", "reconfig"])
def test_resume_matches_reference(saved, tmp_path, kind):
    hp, kw = (Q8, {}) if kind == "q8" else (Q4, {"reconfig": True})
    jst, jrep = _j_run(hp, outer_iters=6, ckpt_every=0,
                       ckpt_dir=_copy(saved[kind], tmp_path, "j"), **kw)
    tst, trep = _t_run(hp, outer_iters=6, ckpt_every=0,
                       ckpt_dir=_copy(saved[kind], tmp_path, "t"), **kw)
    assert trep.outer_iters == jrep.outer_iters == 6
    assert len(trep.losses) == 2
    _assert_reports_match(trep, jrep)
    _assert_masks_equal(tst, jst)
    if kind == "reconfig":
        assert trep.executables == ["reconfigured"] * 2
        assert trep.frozen_at == trep.reconfigured_at == 4
        assert trep.final_engine.reconfigured
        assert tst["theta"]["stem"].shape == (4, 3, 3, 3, 8)
    else:
        # as in the reference, a resumed run is not frozen until the
        # schedule or the drift says so again
        assert trep.executables == ["dynamic", "frozen"]


def test_resume_twice_is_bit_equal(saved, tmp_path):
    runs = [_t_run(Q4, outer_iters=6, ckpt_every=0, reconfig=True,
                   ckpt_dir=_copy(saved["reconfig"], tmp_path, f"r{i}"))
            for i in range(2)]
    (a, ra), (b, rb) = runs
    assert ra.losses == rb.losses
    for grp in ("theta", "u", "mom"):
        for key in a[grp]:
            assert torch.equal(a[grp][key], b[grp][key]), (grp, key)


def test_elastic_resume_matches_reference(saved, tmp_path):
    """The W=4 save resumed by W=8 engines at levels (2, 4)."""
    wide = ConsensusSpec(levels=(2, 4), compact_from_level=1)
    jst, jrep = _j_run(Q8, wide, outer_iters=5, ckpt_every=0,
                       ckpt_dir=_copy(saved["q8"], tmp_path, "j"))
    tst, trep = _t_run(Q8, wide, outer_iters=5, ckpt_every=0,
                       ckpt_dir=_copy(saved["q8"], tmp_path, "t"))
    assert tst["theta"]["stem"].shape[0] == 8
    _assert_reports_match(trep, jrep)
    _assert_masks_equal(tst, jst)


def test_port_saves_then_jax_resumes(tmp_path):
    """The other direction: the port's run saves, the JAX loop resumes
    from it, and both packages' continuations agree."""
    d = tmp_path / "port"
    _, rep = _t_run(Q8, outer_iters=2, ckpt_dir=str(d), ckpt_every=2)
    assert ckpt.latest(str(d)).endswith("ckpt_00000002")
    jst, jrep = _j_run(Q8, outer_iters=4, ckpt_every=0,
                       ckpt_dir=_copy(d, tmp_path, "j"))
    tst, trep = _t_run(Q8, outer_iters=4, ckpt_every=0,
                       ckpt_dir=_copy(d, tmp_path, "t"))
    _assert_reports_match(trep, jrep)
    _assert_masks_equal(tst, jst)


def test_saves_keep_and_flush(tmp_path):
    """``ckpt_keep`` prunes, ``train`` returns with every save on disk, and
    the saved state is the state ``train`` returned."""
    tst, rep = _t_run(Q8, outer_iters=4, ckpt_dir=str(tmp_path),
                      ckpt_every=1, ckpt_keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["ckpt_00000003", "ckpt_00000004"]
    back, meta = ckpt.restore(ckpt.latest(str(tmp_path)), tst)
    assert meta == {"step": 4, "arch": "resnet-smoke", "workers": 4,
                    "levels": [2, 2], "reconfigured": False}
    flat, ref = ckpt._flatten(back), ckpt._flatten(tst)
    for p in ref:
        assert torch.equal(flat[p], ref[p]), p
    assert len(rep.wall_times) == 4 and min(rep.wall_times) >= 0.0


# ---------------------------------------------------------------------------
# fault-tolerance policies
# ---------------------------------------------------------------------------


def _policies(m):
    return {
        "fail_window": m.compose(m.fail_window({3: (1, 3)}),
                                 m.straggler_decay({1: 0.5}, halflife=2)),
        "class_scoped": m.class_scoped(
            {"cnn:mid0": m.straggler_decay({2: 0.25}, halflife=2),
             "cnn:stem": m.fail_window({0: (1, 3)})}),
    }


@pytest.mark.parametrize("name", ["fail_window", "class_scoped"])
def test_policy_run_matches_reference(name):
    jst, jrep = _j_run(Q8, outer_iters=4, ft_policy=_policies(jft)[name])
    tst, trep = _t_run(Q8, outer_iters=4, ft_policy=_policies(ft)[name])
    _assert_reports_match(trep, jrep)
    _assert_masks_equal(tst, jst)
    np.testing.assert_array_equal(to_np(tst["weights"]), jst["weights"])
    assert ("class_weights" in tst) == (name == "class_scoped")
    if name == "class_scoped":
        assert set(tst["class_weights"]) == set(jst["class_weights"])
        for cls, v in jst["class_weights"].items():
            np.testing.assert_array_equal(to_np(tst["class_weights"][cls]),
                                          v, err_msg=cls)
        np.testing.assert_array_equal(
            to_np(tst["class_weights"]["cnn:stem"]), [1, 1, 1, 1])
        np.testing.assert_allclose(
            to_np(tst["class_weights"]["cnn:mid0"]),
            [1, 1, 1 - 0.75 * 0.5 ** 1.5, 1])


def test_policy_weights_reach_every_round():
    """The state each round runs on carries the policy's vectors."""
    seen = []

    def record(k, state):
        seen.append((k, to_np(state["weights"]).copy(),
                     to_np(state["class_weights"]["cnn:mid0"]).copy()))
    pol = ft.compose(ft.fail_window({3: (1, 3)}), ft.class_scoped(
        {"cnn:mid0": ft.straggler_decay({2: 0.25}, halflife=2)}))
    _t_run(Q8, outer_iters=4, ft_policy=pol, eval_fn=record)
    for k, w, cw in seen:
        np.testing.assert_array_equal(w, pol(k, 4))
        np.testing.assert_array_equal(cw, pol.class_weights(k, 4)["cnn:mid0"])


def test_class_scoped_policy_refuses_unknown_classes():
    pol = ft.class_scoped({"ffn": ft.straggler_decay({0: 0.5})})
    with pytest.raises(ValueError, match="unknown coupling classes"):
        _t_run(Q8, outer_iters=1, ft_policy=pol)


@pytest.mark.parametrize("hp", [
    dataclasses.replace(Q8, wire_inter=None),
    Q8, Q4,
], ids=["dense", "compact+q8", "compact+q4"])
@pytest.mark.parametrize("frozen", [False, True])
def test_all_ones_class_weights_are_bit_equal_to_unscoped(hp, frozen):
    """One round with per-class weights at all ones gives the unscoped
    round's bits; the q4 boundary then launches its table once per lead
    class (counted on the plain route)."""
    eng = _t_engine(hp)
    scoped = eng.with_class_weights(True)
    it = superbatches(batches(make_stream(eng.cfg, T_SHAPE, eng.workers,
                                          device="cpu")), hp.local_steps)
    sb = next(it)
    eta = torch.tensor(ETA)
    st0 = eng.init_state_fn()(0)
    st1 = scoped.init_state_fn()(0)
    assert set(st1["class_weights"]) == {r.name for r in eng.bundle.plan.rules}
    a, ma = eng.round_step_fn(frozen)(st0, sb, eta)
    calls = []
    real = ops.quantize_pack_q4_leaves

    def count(views):
        calls.append(len(views))
        return real(views)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "quantize_pack_q4_leaves", count)
        b, mb = scoped.round_step_fn(frozen)(st1, sb, eta)
    assert torch.equal(ma.losses, mb.losses)
    for grp in ("theta", "u", "mom"):
        for key in a[grp]:
            assert torch.equal(a[grp][key], b[grp][key]), (grp, key)
    for za, zb in zip(a["z"] + a["v"], b["z"] + b["v"], strict=True):
        for key in za:
            assert torch.equal(za[key], zb[key]), key
    for rule in a["masks"]:
        assert torch.equal(a["masks"][rule]["idx"], b["masks"][rule]["idx"])
    if hp is Q4:
        classes = set(lead_classes(eng.bundle.plan).values())
        unruled = set(eng.bundle.shapes) - set(lead_classes(eng.bundle.plan))
        assert len(calls) == len(classes) + bool(unruled)
        assert sum(calls) == len(eng.bundle.shapes)


def test_scoped_weights_move_only_their_class():
    """A class weight of 0 for one worker changes the z of the leaves that
    class leads and of no other leaf."""
    eng = _t_engine(Q8).with_class_weights(True)
    it = superbatches(batches(make_stream(eng.cfg, T_SHAPE, eng.workers,
                                          device="cpu")), 2)
    sb, eta = next(it), torch.tensor(ETA)
    st = eng.init_state_fn()(0)
    a, _ = eng.round_step_fn(True)(st, sb, eta)
    cw = dict(st["class_weights"])
    cw["cnn:mid0"] = torch.tensor([1.0, 0.0, 1.0, 1.0])
    b, _ = eng.round_step_fn(True)(dict(st, class_weights=cw), sb, eta)
    lead = lead_classes(eng.bundle.plan)
    moved = {k for k in a["z"][-1]
             if not torch.equal(a["z"][-1][k], b["z"][-1][k])}
    assert moved and moved <= {k for k, c in lead.items() if c == "cnn:mid0"}


# ---------------------------------------------------------------------------
# RunConfig JSON
# ---------------------------------------------------------------------------

JSON_CASES = {
    "plain": {},
    "ckpt": {"ckpt_dir": "/ckpt", "ckpt_every": 3, "ckpt_keep": 2,
             "resume": False},
    "policy": {"ft_policy": "fail_window"},
    "scoped": {"ft_policy": "class_scoped"},
    "wire": {"wire_inter": "compact+q4", "wire_map": ("dense", "compact+q8"),
             "reconfig": True, "reconfig_patience": 2, "metrics_every": 1},
}


def _run_cfg(cls, m, case):
    kw = dict(JSON_CASES[case])
    if "ft_policy" in kw:
        kw["ft_policy"] = _policies(m)[kw["ft_policy"]]
    shape = T_SHAPE if cls is RunConfig else SHAPE
    return cls(outer_iters=6, shape=shape, eta=3e-3, seed=2, **kw)


@pytest.mark.parametrize("case", sorted(JSON_CASES))
def test_run_config_json_round_trips_and_equals_reference(case):
    import json
    run = _run_cfg(RunConfig, ft, case)
    d = run.to_json()
    assert json.loads(json.dumps(d)) == d
    back = RunConfig.from_json(json.loads(json.dumps(d)))
    assert back.to_json() == d
    for f in dataclasses.fields(RunConfig):
        if f.name not in ("ft_policy", "eval_fn", "log"):
            assert getattr(back, f.name) == getattr(run, f.name), f.name
    if run.ft_policy is not None:
        assert back.ft_policy.spec == run.ft_policy.spec
    jd = _run_cfg(JRunConfig, jft, case).to_json()
    assert d == {k: v for k, v in jd.items() if k in d}


def test_run_config_json_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="not serializable"):
        RunConfig(outer_iters=1, shape=T_SHAPE,
                  ft_policy=lambda k, W: np.ones(W, np.float32)).to_json()
    d = RunConfig(outer_iters=1, shape=T_SHAPE).to_json()
    with pytest.raises(ValueError, match="unknown RunConfig JSON keys"):
        RunConfig.from_json(dict(d, bogus=1))
