"""H-SADMM training of Mamba2 in the port against the JAX package.

* Three rounds of the port's ``round_step`` against a jitted JAX
  ``repro.core.hsadmm.round_step`` from one JAX-drawn state (mamba2-780m
  smoke, levels (2, 2), ``t_freeze=2``): a dense and a compact+q8
  inter-node wire.  The JAX round runs outside any mesh: the JAX
  ``Engine``/``train`` cannot train an LM family on this JAX version
  (``ShardingTypeError`` in ``models/layers.embed_lookup`` under the host
  mesh).  The port's ``train`` runs the same three rounds.
* ``round_comm_bytes`` equals the reference's analytic count for the
  smoke config and for the 4-layer full-width config the card trains.
* ``train(reconfig=True)`` refuses the SSM family, which has no width
  mapping in either package.

Tolerances are those of the port's ResNet round tests
(``test_torch_hsadmm.py``): rtol 1e-5, atol 1e-6; mask indices equal.
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
from repro.models import shrink_config as j_shrink_config  # noqa: E402
from repro.train.engine import Engine as JEngine  # noqa: E402
from repro.train.loop import round_comm_bytes as j_round_comm_bytes  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import hsadmm as ths  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.train.engine import Engine  # noqa: E402
from repro_torch.train.loop import RunConfig, round_comm_bytes, train  # noqa: E402

from torch_port_helpers import (assert_tree_close, jax_reference,  # noqa: E402
                                to_np)

RTOL, ATOL = 1e-5, 1e-6
LEVELS = ConsensusSpec(levels=(2, 2), compact_from_level=1)
SHAPE = ShapeConfig("tiny", "train", 32, 8)    # 2 sequences per worker
ETA = 1e-3
ROUNDS = 3
WIRES = ["dense", "compact+q8"]


def _hp(wire):
    return HsadmmConfig(local_steps=2, t_freeze=2, wire_inter=wire)


@pytest.fixture(scope="module", params=WIRES)
def rounds(request):
    """ROUNDS rounds of both packages from one JAX-drawn state: the JAX
    round jitted (one executable per mask mode), the port's round_step,
    and the port's ``train`` over the same batches."""
    wire = request.param
    hp = _hp(wire)
    jb = j_build(get_config("mamba2-780m", smoke=True).replace(hsadmm=hp))
    jspec = jhs.EngineSpec(plan=jb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(jb.stack_map))
    p0 = jax.device_get(jb.init(jax.random.PRNGKey(0)))
    st0 = jax.device_get(jhs.init_state(jax.tree.map(jnp.asarray, p0),
                                        jspec))
    stream = j_make_stream(jb.cfg, SHAPE, LEVELS.num_workers)
    sbs = [np.stack([np.asarray(stream.batch_at(2 * r + e)["tokens"])
                     for e in range(2)]) for r in range(ROUNDS)]

    jidx, jloss = [], []
    with jax_reference(ieee_quantize=True):
        step = jax.jit(lambda s, b, f: jhs.round_step(
            s, b, jb.train_loss, jspec, jnp.float32(ETA), frozen=f),
            static_argnums=2)
        js = jax.tree.map(jnp.asarray, st0)
        for r, sb in enumerate(sbs):
            js, jm = step(js, {"tokens": jnp.asarray(sb)}, r >= hp.t_freeze)
            jloss.append(np.asarray(jm.losses))
            jidx.append(np.asarray(js["masks"]["ssm_heads"]["idx"]))
    js = jax.device_get(js)

    tb = t_build(t_get_config("mamba2-780m", smoke=True).replace(hsadmm=hp))
    tspec = ths.EngineSpec(plan=tb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(tb.stack_map))
    ts = convert.state_from_jax(st0, device="cpu")
    tidx, tloss = [], []
    for r, sb in enumerate(sbs):
        ts, tm = ths.round_step(ts, {"tokens": torch.from_numpy(sb)},
                                tb.train_loss, tspec, ETA,
                                frozen=r >= hp.t_freeze)
        tloss.append(to_np(tm.losses))
        tidx.append(to_np(ts["masks"]["ssm_heads"]["idx"]))

    tb_j = dataclasses.replace(
        tb, init=lambda gen, device: convert.params_from_jax(p0, device))
    eng = Engine(tb_j, SHAPE, consensus=LEVELS, device="cpu")
    rst, rep = train(eng, RunConfig(outer_iters=ROUNDS, shape=SHAPE, eta=ETA,
                                    metrics_every=1, log=None))
    return dict(wire=wire, js=js, jloss=jloss, jidx=jidx, ts=ts,
                tloss=tloss, tidx=tidx, rst=rst, rep=rep, jb=jb, eng=eng)


def test_round_steps_match_reference(rounds):
    r = rounds
    np.testing.assert_allclose(np.array(r["tloss"]), np.array(r["jloss"]),
                               rtol=RTOL)
    for k, (ti, ji) in enumerate(zip(r["tidx"], r["jidx"], strict=True)):
        np.testing.assert_array_equal(ti, ji, err_msg=f"round {k}")
    js, ts = r["js"], r["ts"]
    for name in ("theta", "u"):
        assert_tree_close(ts[name], js[name], RTOL, ATOL)
    for k in range(2):
        assert_tree_close(ts["z"][k], js["z"][k], RTOL, ATOL)
    assert int(ts["k"]) == ROUNDS


def test_train_runs_the_same_rounds(rounds):
    """The port's ``train`` from the same init: the round steps' losses
    and final state, bit for bit, frozen at round 2, and the reference's
    analytic inter-node bytes every round."""
    r = rounds
    rep, rst, ts = r["rep"], r["rst"], r["ts"]
    assert rep.executables == ["dynamic", "dynamic", "frozen"]
    assert rep.frozen_at == 2
    assert rep.losses == [float(x[-1]) for x in r["tloss"]]
    for name in ("theta", "u"):
        for key, v in ts[name].items():
            assert torch.equal(rst[name][key], v), f"{name}/{key}"
    with jax_reference():
        jeng = JEngine(r["jb"], make_host_mesh(), SHAPE, consensus=LEVELS)
        _, dyn, frz = j_round_comm_bytes(jeng)
    assert rep.comm_bytes_internode == [dyn, dyn, frz]
    assert rep.wire_map == ["dense", r["wire"]]


# (n_layers override, wire) -> the reference's (dense_equiv, dynamic,
# frozen) bytes per round; full width 4 layers is the card's
# configuration, its compact+q8 row the count chip_smoke.py holds
BYTES = {
    ("smoke", "dense"): (338_880, 235_936, 235_872),
    ("smoke", "compact+q8"): (338_880, 67_228, 67_164),
    ("smoke", "compact+q4"): (338_880, 37_744, 37_680),
    ("full4", "dense"): (852_197_632, 738_238_336, 738_237_568),
    ("full4", "compact+q8"): (852_197_632, 186_242_532, 186_241_764),
    ("full4", "compact+q4"): (852_197_632, 93_962_836, 93_962_068),
}


@pytest.mark.parametrize("size,wire", sorted(BYTES))
def test_round_comm_bytes_match_reference(size, wire):
    def cfg(get):
        c = get("mamba2-780m", smoke=size == "smoke")
        if size == "full4":
            c = c.replace(n_layers=4, param_dtype="float32")
        return c.replace(hsadmm=dataclasses.replace(c.hsadmm,
                                                    wire_inter=wire))
    jeng = JEngine(j_build(cfg(get_config)), make_host_mesh(), SHAPE,
                   consensus=LEVELS)
    teng = Engine(t_build(cfg(t_get_config)), SHAPE, consensus=LEVELS,
                  device="cpu")
    assert round_comm_bytes(teng) == j_round_comm_bytes(jeng) \
        == BYTES[size, wire]


def test_reconfig_is_refused_for_the_ssm():
    """Neither package maps the SSM's budgets onto widths: the reference
    raises in ``shrink_config``, the port's ``train`` before any round."""
    jb = j_build(get_config("mamba2-780m", smoke=True))
    with pytest.raises(NotImplementedError):
        j_shrink_config(jb.cfg, jb.plan, {"ssm_heads": 4})
    eng = Engine(t_build(t_get_config("mamba2-780m", smoke=True)), SHAPE,
                 consensus=LEVELS, device="cpu")
    with pytest.raises(NotImplementedError, match="reconfiguration"):
        train(eng, RunConfig(outer_iters=1, shape=SHAPE, reconfig=True,
                             log=None))
    with pytest.raises(NotImplementedError, match="reconfiguration"):
        eng.reconfigure(masks={})


def test_convert_carries_the_ssm_state_both_ways():
    """A JAX H-SADMM state of the layer-stacked LM (nested ``blocks/mixer``
    leaves, the stacked rule's masks) goes to the port and back to the
    same tree, dtypes and bits."""
    hp = _hp("compact+q8")
    jb = j_build(get_config("mamba2-780m", smoke=True).replace(hsadmm=hp))
    jspec = jhs.EngineSpec(plan=jb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(jb.stack_map))
    st = jax.device_get(jhs.init_state(jb.init(jax.random.PRNGKey(1)),
                                       jspec))
    port = convert.state_from_jax(st, device="cpu")
    assert port["theta"]["blocks/mixer/wz"].shape == (4, 2, 64, 8, 16)
    assert port["masks"]["ssm_heads"]["idx"].dtype == torch.int64
    back = convert.state_to_jax(port)
    assert jax.tree.structure(back) == jax.tree.structure(st)
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(back)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)
