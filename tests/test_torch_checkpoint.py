"""The port's checkpoints (``repro_torch.dist.checkpoint``) against the
JAX package's ``repro.dist.checkpoint``: the same on-disk layout, so a
checkpoint of either package restores bit-equal in the other; the same
elastic restore on one file; the atomic write and the background writer.

Every test flushes the writer before it asserts: the writer is one
thread per process, and a save left queued would land in a later test.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ConsensusSpec, HsadmmConfig, get_config  # noqa: E402
from repro.core import hsadmm as jhs  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.dist import checkpoint as jckpt  # noqa: E402
from repro.models import build as j_build  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.dist import checkpoint as ckpt  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.train.engine import Engine  # noqa: E402
from repro_torch.train.loop import _masks_aux, _masks_from_aux  # noqa: E402

from torch_port_helpers import np_flat, perturbed  # noqa: E402

HP = HsadmmConfig(rho1=1e-2, rho2=1e-3, local_steps=2, t_freeze=2)
LEVELS = ConsensusSpec(levels=(2, 2), compact_from_level=1)


@pytest.fixture(autouse=True)
def _flushed():
    yield
    ckpt.flush()


# ---------------------------------------------------------------------------
# the reference's four tests (tests/test_checkpoint.py) on port tensors
# ---------------------------------------------------------------------------


def _state(W):
    return {
        "theta": {"w": torch.arange(W * 6, dtype=torch.float32)
                  .reshape(W, 6)},
        "mom": {"w": torch.ones((W, 6))},
        "u": {"w": torch.full((W, 6), 2.0)},
        "z": [{"w": torch.full((W // 2, 6), 3.0)},
              {"w": torch.full((1, 6), 4.0)}],
        "v": [{"w": torch.zeros((W // 2, 6))}],
        "k": torch.tensor(7, dtype=torch.int32),
        "weights": torch.ones((W,)),
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _leaves(tree) -> dict:
    return ckpt._flatten(tree)


def test_save_restore_roundtrip(tmp_path):
    st = _state(4)
    ckpt.save(str(tmp_path), st, {"step": 7})
    st2, meta = ckpt.restore(ckpt.latest(str(tmp_path)), _zeros_like(st))
    assert meta["step"] == 7
    a, b = _leaves(st), _leaves(st2)
    assert set(a) == set(b)
    for p in a:
        assert b[p].dtype == a[p].dtype and torch.equal(a[p], b[p]), p


def test_keep_policy(tmp_path):
    st = _state(4)
    for s in range(5):
        ckpt.save(str(tmp_path), st, {"step": s}, keep=2)
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("ckpt_")) == ["ckpt_00000003",
                                                "ckpt_00000004"]


def test_elastic_scale_up_seeds_new_workers_from_z(tmp_path):
    st = _state(4)
    ckpt.save(str(tmp_path), st, {"step": 1})
    st2, meta = ckpt.restore_elastic(ckpt.latest(str(tmp_path)),
                                     _zeros_like(_state(8)), 8)
    assert meta["restored_workers"] == 8
    assert torch.equal(st2["theta"]["w"][:4], st["theta"]["w"])
    assert torch.all(st2["theta"]["w"][4:] == 4.0)   # global z
    assert torch.all(st2["u"]["w"][4:] == 0.0)
    assert torch.all(st2["mom"]["w"][4:] == 0.0)
    assert torch.all(st2["weights"] == 1.0)


def test_elastic_scale_down(tmp_path):
    st = _state(8)
    ckpt.save(str(tmp_path), st, {"step": 1})
    st2, _ = ckpt.restore_elastic(ckpt.latest(str(tmp_path)),
                                  _zeros_like(_state(4)), 4)
    assert torch.equal(st2["theta"]["w"], st["theta"]["w"][:4])


# ---------------------------------------------------------------------------
# H-SADMM states across the two packages
# ---------------------------------------------------------------------------


def _j_state(consensus=LEVELS, class_weights=False, seed=0):
    """A resnet-smoke JAX H-SADMM state as numpy, every iterate, dual,
    penalty and weight perturbed by seeded noise, random masks."""
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=HP))
    spec = jhs.EngineSpec(plan=jb.plan, consensus=consensus, hp=HP,
                          class_weights=class_weights)
    st = jax.device_get(jhs.init_state(jb.init(jax.random.PRNGKey(0)), spec))
    for i, name in enumerate(("theta", "u", "mom")):
        st[name] = perturbed(st[name], seed=seed + i)
    for name in ("z", "v", "rho"):
        st[name] = [perturbed(t, seed=seed + 10 * (i + 1))
                    for i, t in enumerate(st[name])]
    rng = np.random.default_rng(seed)
    st["weights"] = rng.random(st["weights"].shape).astype(np.float32)
    if class_weights:
        st["class_weights"] = {
            r: rng.random(v.shape).astype(np.float32)
            for r, v in st["class_weights"].items()}
    for r in jb.plan.rules:
        scores = rng.random((r.groups,)).astype(np.float32)
        mask, idx = jsp.topk_mask(jnp.asarray(scores), r.keep)
        assert idx.shape == st["masks"][r.name]["idx"].shape
        st["masks"][r.name] = {
            "idx": np.asarray(idx), "valid": np.ones(idx.shape, np.float32),
            "mask": np.asarray(mask), "drift": np.float32(rng.random())}
    st["k"] = np.int32(5)
    return st


def _t_template(consensus=LEVELS, class_weights=False):
    eng = Engine(t_build(t_get_config("resnet18", smoke=True)
                         .replace(hsadmm=HP)),
                 consensus=consensus, device="cpu",
                 class_weights=class_weights)
    return eng.init_state_fn()(1)


def _j_template(consensus=LEVELS, class_weights=False):
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=HP))
    spec = jhs.EngineSpec(plan=jb.plan, consensus=consensus, hp=HP,
                          class_weights=class_weights)
    shapes = jax.eval_shape(
        lambda: jhs.init_state(jb.init(jax.random.PRNGKey(0)), spec))
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def _assert_np_trees_equal(a: dict, b: dict):
    fa, fb = jckpt._flatten(a), jckpt._flatten(b)
    assert set(fa) == set(fb)
    for p in fa:
        x, y = np.asarray(fa[p]), np.asarray(fb[p])
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y, err_msg=p)


def _npz(path) -> dict:
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("class_weights", [False, True])
def test_layout_equals_reference(tmp_path, class_weights):
    """One state saved by each package: the same keys, dtypes (int32 mask
    indices), shapes and bytes, and the same meta fields."""
    jst = _j_state(class_weights=class_weights)
    meta = {"step": 4, "arch": "resnet-smoke", "workers": 4,
            "levels": [2, 2], "reconfigured": False}
    jp = jckpt.save(str(tmp_path / "jax"), jst, meta)
    tp = ckpt.save(str(tmp_path / "port"), convert.state_from_jax(
        jst, device="cpu"), meta)
    assert os.path.basename(jp) == os.path.basename(tp) == "ckpt_00000004"
    ja, ta = _npz(jp), _npz(tp)
    assert set(ja) == set(ta)
    assert any(k.startswith("masks/") and k.endswith("/idx") for k in ta)
    assert ("class_weights/cnn:stem" in ta) == class_weights
    for k, a in ja.items():
        assert ta[k].dtype == a.dtype and ta[k].shape == a.shape, k
        assert ta[k].tobytes() == a.tobytes(), k
    assert jckpt.read_meta(tp) == ckpt.read_meta(jp) == meta


@pytest.mark.parametrize("class_weights", [False, True])
def test_jax_checkpoint_restores_in_port(tmp_path, class_weights):
    jst = _j_state(class_weights=class_weights)
    jckpt.save(str(tmp_path), jax.tree.map(jnp.asarray, jst), {"step": 3})
    tst, meta = ckpt.restore(ckpt.latest(str(tmp_path)),
                             _t_template(class_weights=class_weights))
    ref = convert.state_from_jax(jst, device="cpu")
    a, b = _leaves(tst), _leaves(ref)
    assert set(a) == set(b) and meta["step"] == 3
    for p in a:
        assert a[p].dtype == b[p].dtype and torch.equal(a[p], b[p]), p
    assert a["masks/cnn:stem/idx"].dtype == torch.int64


@pytest.mark.parametrize("class_weights", [False, True])
def test_port_checkpoint_restores_in_jax(tmp_path, class_weights):
    tst = convert.state_from_jax(_j_state(class_weights=class_weights,
                                          seed=3), device="cpu")
    ckpt.save(str(tmp_path), tst, {"step": 8})
    jst, meta = jckpt.restore(jckpt.latest(str(tmp_path)),
                              _j_template(class_weights=class_weights))
    assert meta["step"] == 8
    _assert_np_trees_equal(jax.device_get(jst), convert.state_to_jax(tst))


@pytest.mark.parametrize("levels", [(2, 4), (2, 1), (4, 1)])
def test_restore_elastic_equals_reference(tmp_path, levels):
    """One W=4 save restored elastically by both packages into W = 8 or 2
    (and 4 at other levels): equal arrays, leaf for leaf."""
    jst = _j_state()
    jckpt.save(str(tmp_path), jax.tree.map(jnp.asarray, jst), {"step": 2})
    path = jckpt.latest(str(tmp_path))
    consensus = ConsensusSpec(levels=levels, compact_from_level=1)
    W = consensus.num_workers
    jr, jmeta = jckpt.restore_elastic(path, _j_template(consensus), W)
    tr, tmeta = ckpt.restore_elastic(path, _t_template(consensus), W)
    assert jmeta == tmeta and tmeta["restored_workers"] == W
    _assert_np_trees_equal(convert.state_to_jax(tr), jax.device_get(jr))
    if W > 4:   # new workers: theta seeded from the global z, duals zero
        gz = jst["z"][-1]["stem"].mean(axis=0)
        np.testing.assert_array_equal(tr["theta"]["stem"][4:].numpy(),
                                      np.broadcast_to(gz, (W - 4,)
                                                      + gz.shape))
        assert torch.all(tr["u"]["stem"][4:] == 0)
        assert torch.all(tr["weights"][4:] == 1.0)


def test_restore_elastic_falls_back_to_the_deepest_rho_level(tmp_path):
    """A template one level deeper than the save takes its missing rho
    level from the deepest saved one, as the reference's docstring says;
    the reference itself raises there (it finds the level, then refuses
    it as "not elastic")."""
    jst = _j_state()
    jckpt.save(str(tmp_path), jax.tree.map(jnp.asarray, jst), {"step": 2})
    path = jckpt.latest(str(tmp_path))
    deeper = ConsensusSpec(levels=(2, 2, 1), compact_from_level=1)
    with pytest.raises(ValueError, match="not elastic"):
        jckpt.restore_elastic(path, _j_template(deeper), 4)
    tr, _ = ckpt.restore_elastic(path, _t_template(deeper), 4)
    assert len(tr["rho"]) == 3 and len(tr["z"]) == 3
    for key, v in np_flat(jst["rho"][1]).items():
        np.testing.assert_array_equal(tr["rho"][2][key].numpy(), v)
        np.testing.assert_array_equal(tr["rho"][1][key].numpy(), v)


def test_restore_elastic_refuses_what_the_reference_refuses(tmp_path):
    jst = _j_state()
    jckpt.save(str(tmp_path), jax.tree.map(jnp.asarray, jst), {"step": 2})
    path = jckpt.latest(str(tmp_path))
    tmpl = _t_template(class_weights=True)     # the save has none
    with pytest.raises(KeyError, match="no elastic seed rule"):
        ckpt.restore_elastic(path, tmpl, 4)
    with pytest.raises(KeyError, match="has no leaf"):
        ckpt.restore(path, tmpl)
    tmpl = _t_template()
    tmpl["masks"]["cnn:stem"]["idx"] = tmpl["masks"]["cnn:stem"]["idx"][1:]
    with pytest.raises(ValueError, match="not elastic"):
        ckpt.restore_elastic(path, tmpl, 4)
    with pytest.raises(ValueError, match="template"):
        ckpt.restore(path, tmpl)


def test_reconfigured_save_round_trips_aux_masks(tmp_path):
    """A reconfigured state saved with its frozen full-shape masks as aux
    arrays: both packages read the same aux (int32 indices on disk), the
    port's aux masks rebuild an engine whose template the save restores
    into exactly, and the aux keys stay out of the state."""
    jst = _j_state()
    eng = Engine(t_build(t_get_config("resnet18", smoke=True)
                         .replace(hsadmm=HP)), consensus=LEVELS,
                 device="cpu")
    rc, st_c = eng.reconfigure(convert.state_from_jax(jst, device="cpu"))
    ckpt.save(str(tmp_path), st_c, {"step": 6, "reconfigured": True},
              aux=_masks_aux(rc.frozen_masks, eng.bundle.plan),
              background=True)
    ckpt.flush()
    path = ckpt.latest(str(tmp_path))
    assert ckpt.read_meta(path)["reconfigured"]
    aux, jaux = ckpt.load_aux(path), jckpt.load_aux(path)
    assert set(aux) == set(jaux) and all(k.startswith("masks/") for k in aux)
    for k, a in aux.items():
        np.testing.assert_array_equal(a, jaux[k])
        assert a.dtype == (np.int32 if k.endswith("/idx") else np.float32)
    masks = _masks_from_aux(aux, eng.bundle.plan, "cpu")
    for rule, m in rc.frozen_masks.items():
        for f, v in m.items():
            assert masks[rule][f].dtype == v.dtype
            assert torch.equal(masks[rule][f], v), (rule, f)
    rc2, _ = eng.reconfigure(masks=masks)
    back, _ = ckpt.restore(path, rc2.init_state_fn()(0))
    a, b = _leaves(back), _leaves(st_c)
    assert set(a) == set(b)
    for p in a:
        assert torch.equal(a[p], b[p]), p


# ---------------------------------------------------------------------------
# the write path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("background", [False, True])
def test_failing_write_keeps_the_older_checkpoint(tmp_path, monkeypatch,
                                                  capsys, background):
    st = _state(4)
    ckpt.save(str(tmp_path), st, {"step": 1})

    def broken(*a, **kw):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt, "_savez", broken)
    if background:
        ckpt.save(str(tmp_path), st, {"step": 2}, background=True)
        ckpt.flush()   # the writer reports the error and carries on
        assert "disk full" in capsys.readouterr().err
    else:
        with pytest.raises(OSError, match="disk full"):
            ckpt.save(str(tmp_path), st, {"step": 2})
    assert ckpt.latest(str(tmp_path)).endswith("ckpt_00000001")
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000001"]
    monkeypatch.undo()
    ckpt.save(str(tmp_path), st, {"step": 2}, background=True)
    ckpt.flush()
    assert ckpt.latest(str(tmp_path)).endswith("ckpt_00000002")


def test_background_save_snapshots_on_the_callers_thread(tmp_path):
    """The state may change as soon as ``save`` returns: the checkpoint
    holds the values at the call."""
    st = _state(4)
    want = st["theta"]["w"].clone()
    ckpt.save(str(tmp_path), st, {"step": 1}, background=True)
    st["theta"]["w"].add_(100.0)
    ckpt.flush()
    back, _ = ckpt.restore(ckpt.latest(str(tmp_path)), _zeros_like(st))
    assert torch.equal(back["theta"]["w"], want)


def test_resave_of_a_step_replaces_it(tmp_path):
    st = _state(4)
    ckpt.save(str(tmp_path), st, {"step": 3})
    st["u"]["w"].fill_(9.0)
    ckpt.save(str(tmp_path), st, {"step": 3, "note": "again"})
    path = ckpt.latest(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000003"]
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["note"] == "again"
    back, _ = ckpt.restore(path, _zeros_like(st))
    assert torch.all(back["u"]["w"] == 9.0)


def test_incomplete_directories_are_not_checkpoints(tmp_path):
    os.makedirs(tmp_path / "ckpt_00000009")           # no meta.json
    os.makedirs(tmp_path / ".tmp_00000010_1_2")
    assert ckpt.latest(str(tmp_path)) is None
    assert ckpt.latest(str(tmp_path / "missing")) is None


def test_background_saves_from_many_threads(tmp_path):
    """Eight threads queue background saves into their own directories at
    once (more threads than this test's work needs, a short switch
    interval): after one flush every directory holds its newest step,
    pruned to two, and its values."""
    import sys
    import threading
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(i):
            st = _state(4)
            for step in range(6):
                st["theta"]["w"].fill_(float(10 * i + step))
                ckpt.save(str(tmp_path / f"t{i}"), st, {"step": step},
                          keep=2, background=True)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        ckpt.flush()
    finally:
        sys.setswitchinterval(old)
    for i in range(8):
        d = tmp_path / f"t{i}"
        assert sorted(os.listdir(d)) == ["ckpt_00000004", "ckpt_00000005"]
        back, meta = ckpt.restore(ckpt.latest(str(d)), _zeros_like(_state(4)))
        assert meta["step"] == 5
        assert torch.all(back["theta"]["w"] == 10 * i + 5)
