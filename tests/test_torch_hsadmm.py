"""Differential tests of the port's H-SADMM round against the JAX
reference: from one carried-across state, one local step, one dynamic and
one frozen consensus step, and one whole round, for a dense, a compact+q8
and a compact+q4 inter-node boundary (resnet-smoke, levels (2, 2)); a local
step with microbatch accumulation (``grad_accum=2``) and one without
momentum, and the momentum-free state through ``convert`` and checkpoints
both ways.  The JAX side quantizes with IEEE division of the scale, as the
port does (see ``torch_port_helpers``)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ConsensusSpec, HsadmmConfig, ShapeConfig, get_config  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import hsadmm as jhs  # noqa: E402
from repro.data.synthetic import make_stream as j_make_stream  # noqa: E402
from repro.models import build as j_build  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import hsadmm as ths  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402

from torch_port_helpers import (assert_tree_close, jax_reference, np_flat,  # noqa: E402
                                perturbed, to_np)

RTOL, ATOL = 1e-5, 1e-6
LEVELS = ConsensusSpec(levels=(2, 2), compact_from_level=1)
HP = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=2, t_freeze=2)
WIRES = ["dense", "compact+q8", "compact+q4"]
ETA = 1e-2


def _specs(wire, use_momentum=True):
    hp = dataclasses.replace(HP, wire_inter=wire)
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=hp))
    tb = t_build(t_get_config("resnet18", smoke=True).replace(hsadmm=hp))
    jspec = jhs.EngineSpec(plan=jb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(jb.stack_map),
                           use_momentum=use_momentum)
    tspec = ths.EngineSpec(plan=tb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(tb.stack_map),
                           use_momentum=use_momentum)
    return jb, tb, jspec, tspec


@pytest.fixture(scope="module")
def start():
    """A rich start state (init + seeded noise on every iterate and dual)
    and one superbatch, as numpy."""
    jb, _, jspec, _ = _specs("dense")
    st = jax.device_get(jhs.init_state(jb.init(jax.random.PRNGKey(0)), jspec))
    for i, name in enumerate(("theta", "u")):
        st[name] = perturbed(st[name], seed=i)
    st["z"] = [perturbed(z, seed=10 + i) for i, z in enumerate(st["z"])]
    st["v"] = [perturbed(v, seed=20 + i, scale=1e-3)
               for i, v in enumerate(st["v"])]
    stream = j_make_stream(jb.cfg, ShapeConfig("t", "train", 16, 8),
                           LEVELS.num_workers)
    sb = {k: np.stack([np.asarray(stream.batch_at(s)[k]) for s in range(2)])
          for k in ("images", "labels")}
    return st, sb


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port_state(st):
    return convert.state_from_jax(st, device="cpu")


def _assert_state(tst, jst):
    for name in ("theta", "u"):
        assert_tree_close(tst[name], jst[name], RTOL, ATOL)
    for k in range(len(jst["z"])):
        assert_tree_close(tst["z"][k], jst["z"][k], RTOL, ATOL)
    for k in range(len(jst["v"])):
        assert_tree_close(tst["v"][k], jst["v"][k], RTOL, ATOL)
    for k in range(len(jst["rho"])):
        ref = np_flat(jst["rho"][k])
        for key, v in ref.items():
            np.testing.assert_array_equal(to_np(tst["rho"][k][key]), v)
    for rule, m in jst["masks"].items():
        np.testing.assert_array_equal(to_np(tst["masks"][rule]["idx"]),
                                      np.asarray(m["idx"]), err_msg=rule)
        np.testing.assert_array_equal(to_np(tst["masks"][rule]["mask"]),
                                      np.asarray(m["mask"]), err_msg=rule)
    assert int(tst["k"]) == int(jst["k"])


def test_local_step_matches_reference(start):
    st, sb = start
    jb, tb, jspec, tspec = _specs("dense")
    batch = {k: v[0] for k, v in sb.items()}
    with jax_reference():
        jst, jloss = jax.jit(lambda s, b: jhs.local_step(
            s, b, jb.train_loss, jspec, ETA))(_jnp(st), _jnp(batch))
    tst, tloss = ths.local_step(
        _port_state(st), {k: torch.from_numpy(v) for k, v in batch.items()},
        tb.train_loss, tspec, ETA)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    assert_tree_close(tst["theta"], jst["theta"], RTOL, ATOL)
    assert_tree_close(tst["mom"], jst["mom"], RTOL, ATOL)


@pytest.mark.parametrize("wire", WIRES)
def test_consensus_steps_match_reference(start, wire):
    """A dynamic consensus step, then a frozen one from its result."""
    st, _ = start
    jb, tb, jspec, tspec = _specs(wire)
    with jax_reference(ieee_quantize=True):
        step = jax.jit(lambda s, f: jcons.consensus_step(s, jspec, frozen=f),
                       static_argnums=1)
        jdyn, _ = step(_jnp(st), False)
        jfrz, _ = step(jdyn, True)
    tdyn, _ = tcons.consensus_step(_port_state(st), tspec, frozen=False)
    _assert_state(tdyn, jax.device_get(jdyn))
    jdyn = jax.device_get(jdyn)
    tfrz, _ = tcons.consensus_step(_port_state(jdyn), tspec, frozen=True)
    _assert_state(tfrz, jax.device_get(jfrz))


@pytest.mark.parametrize("wire", WIRES)
def test_round_step_matches_reference(start, wire):
    st, sb = start
    jb, tb, jspec, tspec = _specs(wire)
    with jax_reference(ieee_quantize=True):
        jst, jm = jax.jit(lambda s, b: jhs.round_step(
            s, b, jb.train_loss, jspec, jnp.float32(ETA)))(_jnp(st), _jnp(sb))
    tst, tm = ths.round_step(_port_state(st),
                             {k: torch.from_numpy(v) for k, v in sb.items()},
                             tb.train_loss, tspec, ETA)
    _assert_state(tst, jax.device_get(jst))
    np.testing.assert_allclose(to_np(tm.losses), np.asarray(jm.losses),
                               rtol=RTOL)
    np.testing.assert_allclose(float(tm.r_primal), float(jm.r_primal),
                               rtol=1e-4)
    assert float(tm.drift) == float(jm.drift)


@pytest.mark.parametrize("grad_accum,use_momentum", [(2, True), (1, False)])
def test_local_step_options_match_reference(start, grad_accum, use_momentum):
    """``grad_accum=2`` (two contiguous microbatches a worker, gradients
    summed and halved) and ``use_momentum=False`` (no ``mom`` in the
    state, the plain update) against the JAX ``local_step``."""
    st, sb = start
    jb, tb, jspec, tspec = _specs("dense", use_momentum)
    if not use_momentum:
        st = {k: v for k, v in st.items() if k != "mom"}
    batch = {k: v[0] for k, v in sb.items()}
    assert batch["images"].shape[1] % grad_accum == 0
    with jax_reference():
        jst, jloss = jax.jit(lambda s, b: jhs.local_step(
            s, b, jb.train_loss, jspec, ETA, grad_accum=grad_accum))(
                _jnp(st), _jnp(batch))
    tst, tloss = ths.local_step(
        _port_state(st), {k: torch.from_numpy(v) for k, v in batch.items()},
        tb.train_loss, tspec, ETA, grad_accum=grad_accum)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    assert sorted(tst) == sorted(jst)
    assert ("mom" in tst) == use_momentum
    assert_tree_close(tst["theta"], jst["theta"], RTOL, ATOL)
    if use_momentum:
        assert_tree_close(tst["mom"], jst["mom"], RTOL, ATOL)


def test_momentum_free_init_state_matches_reference():
    jb, tb, jspec, tspec = _specs("dense", use_momentum=False)
    jst = jax.device_get(jhs.init_state(jb.init(jax.random.PRNGKey(0)),
                                        jspec))
    tst = ths.init_state(convert.params_from_jax(
        jax.device_get(jb.init(jax.random.PRNGKey(0))), "cpu"), tspec)
    assert "mom" not in tst and sorted(tst) == sorted(jst)
    _assert_state(tst, jst)


def test_momentum_free_state_crosses_both_packages(start, tmp_path):
    """A momentum-free state through ``convert`` both ways, and through a
    checkpoint saved by each package and restored by the other."""
    from repro.dist import checkpoint as jckpt
    from repro_torch.dist import checkpoint as ckpt
    st, _ = start
    jb, tb, jspec, tspec = _specs("dense", use_momentum=False)
    st = {k: v for k, v in st.items() if k != "mom"}
    tst = _port_state(st)
    assert "mom" not in tst
    ref = jckpt._flatten(st)
    back = jckpt._flatten(convert.state_to_jax(tst))
    assert set(back) == set(ref)
    for p, a in ref.items():
        np.testing.assert_array_equal(back[p], np.asarray(a), err_msg=p)
    jckpt.save(str(tmp_path / "jax"), _jnp(st), {"step": 1})
    ttmpl = ths.init_state({k: torch.zeros(shape) for k, shape in
                            tb.shapes.items()}, tspec)
    got, _ = ckpt.restore(ckpt.latest(str(tmp_path / "jax")), ttmpl)
    got, want = ckpt._flatten(got), ckpt._flatten(tst)
    assert set(got) == set(want)
    for p, x in want.items():
        assert torch.equal(got[p], x), p
    ckpt.save(str(tmp_path / "port"), tst, {"step": 1})
    ckpt.flush()
    jtmpl = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jax.eval_shape(
        lambda: jhs.init_state(jb.init(jax.random.PRNGKey(0)), jspec)))
    jback, _ = jckpt.restore(jckpt.latest(str(tmp_path / "port")), jtmpl)
    jback = jckpt._flatten(jax.device_get(jback))
    assert set(jback) == set(ref)
    for p, a in ref.items():
        np.testing.assert_array_equal(np.asarray(jback[p]), np.asarray(a),
                                      err_msg=p)
