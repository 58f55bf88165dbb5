"""H-SADMM training of the dense transformer in the port against the JAX
package.

* Three rounds of the port's ``round_step`` against a jitted JAX
  ``repro.core.hsadmm.round_step`` from one JAX-drawn state (tinyllama
  smoke with 8 query heads in 4 GQA groups, so that ``heads`` prunes as
  well as the 16-shard ``ffn``; levels (2, 2), ``t_freeze=2``), over a
  dense and a compact+q8 inter-node wire.  The JAX round runs outside any
  mesh: the JAX ``Engine``/``train`` cannot train an LM family on this
  JAX version (``ShardingTypeError`` in ``models/layers.embed_lookup``
  under the host mesh).  The port's ``train`` runs the same rounds.
* The migration onto the budget-B model (JAX: ``compact_state`` over the
  ``shrunk_plan``, as its ``Engine.reconfigure`` migrates) against the
  port's ``Engine.reconfigure``, and one reconfigured round against the
  JAX ``round_step`` on the shrunk bundle; the port's ``train`` with
  ``reconfig=True`` runs exactly these steps.
* ``round_comm_bytes`` equals the reference's analytic count for the
  smoke config and for the full-width configs with 4 and 3 layers (the
  card trains 3), full-shape and reconfigured.

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
from repro.core import shrinkage as jsh  # noqa: E402
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
                                np_flat, to_np)

RTOL, ATOL = 1e-5, 1e-6
ARCH = "tinyllama-1.1b"
GQA = dict(n_heads=8, n_kv_heads=4)   # keep_count(4, 0.5, 2) = 2 of 4 groups
LEVELS = ConsensusSpec(levels=(2, 2), compact_from_level=1)
SHAPE = ShapeConfig("tiny", "train", 32, 8)    # 2 sequences per worker
ETA = 1e-3
ROUNDS = 3
WIRES = ["dense", "compact+q8"]
RULES = ("ffn", "heads")


def _hp(wire):
    return HsadmmConfig(local_steps=2, t_freeze=2, reconfig_patience=1,
                        wire_inter=wire)


def _migrate_jax(jspec, bundle2, js):
    """The JAX ``Engine.reconfigure``'s migration, outside a mesh: both
    dense rules are compactable, so each gets the identity mask state of
    its budget."""
    plan, budgets = jspec.plan, jspec.budgets
    shapes2 = jhs.flatten(jax.eval_shape(bundle2.init,
                                         jax.random.PRNGKey(0)))
    idxs = {r.name: js["masks"][r.name]["idx"] for r in plan.rules}
    new_masks = {r.name: jhs.identity_mask_state(
        r, tuple(shapes2[r.leaves[0].key].shape[:r.stack_ndims]),
        budgets[r.name]) for r in bundle2.plan.rules}
    flags = tuple(jspec.boundary_compact(k)
                  for k in range(1, jspec.num_levels + 1))
    return jsh.compact_state(js, plan, idxs, new_masks, flags)


@pytest.fixture(scope="module", params=WIRES)
def rounds(request):
    """ROUNDS rounds of both packages from one JAX-drawn state (the JAX
    round jitted, one executable per mask mode), the port's ``train``
    over the same batches, then the migration and one reconfigured round
    of both packages, and the port's ``train(reconfig=True)`` over all
    four."""
    wire = request.param
    hp = _hp(wire)
    jb = j_build(get_config(ARCH, smoke=True).replace(hsadmm=hp, **GQA))
    jspec = jhs.EngineSpec(plan=jb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(jb.stack_map))
    p0 = jax.device_get(jb.init(jax.random.PRNGKey(0)))
    st0 = jax.device_get(jhs.init_state(jax.tree.map(jnp.asarray, p0),
                                        jspec))
    stream = j_make_stream(jb.cfg, SHAPE, LEVELS.num_workers)
    sbs = [np.stack([np.asarray(stream.batch_at(2 * r + e)["tokens"])
                     for e in range(2)]) for r in range(ROUNDS + 1)]

    jcfg2 = j_shrink_config(jb.cfg, jb.plan, jspec.budgets)
    jb2 = dataclasses.replace(j_build(jcfg2), plan=jsh.shrunk_plan(
        jb.plan, jspec.budgets))
    jspec2 = jhs.EngineSpec(plan=jb2.plan, consensus=LEVELS, hp=hp,
                            stack_map=tuple(jb2.stack_map))
    jidx, jloss = [], []
    with jax_reference(ieee_quantize=True):
        step = jax.jit(lambda s, b, f: jhs.round_step(
            s, b, jb.train_loss, jspec, jnp.float32(ETA), frozen=f),
            static_argnums=2)
        js = jax.tree.map(jnp.asarray, st0)
        for r, sb in enumerate(sbs[:ROUNDS]):
            js, jm = step(js, {"tokens": jnp.asarray(sb)}, r >= hp.t_freeze)
            jloss.append(np.asarray(jm.losses))
            jidx.append({n: np.asarray(js["masks"][n]["idx"])
                         for n in RULES})
        jmig = jax.jit(lambda s: _migrate_jax(jspec, jb2, s))(js)
        jrc, jmrc = jax.jit(lambda s, b: jhs.round_step(
            s, b, jb2.train_loss, jspec2, jnp.float32(ETA), frozen=True))(
            jmig, {"tokens": jnp.asarray(sbs[ROUNDS])})
    js, jmig, jrc = jax.device_get((js, jmig, jrc))

    tb = t_build(t_get_config(ARCH, smoke=True).replace(hsadmm=hp, **GQA))
    tspec = ths.EngineSpec(plan=tb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(tb.stack_map))
    ts = convert.state_from_jax(st0, device="cpu")
    tidx, tloss = [], []
    for r, sb in enumerate(sbs[:ROUNDS]):
        ts, tm = ths.round_step(ts, {"tokens": torch.from_numpy(sb)},
                                tb.train_loss, tspec, ETA,
                                frozen=r >= hp.t_freeze)
        tloss.append(to_np(tm.losses))
        tidx.append({n: to_np(ts["masks"][n]["idx"]) for n in RULES})

    tb_j = dataclasses.replace(
        tb, init=lambda gen, device: convert.params_from_jax(p0, device))
    eng = Engine(tb_j, SHAPE, consensus=LEVELS, device="cpu")
    eng2, tmig = eng.reconfigure(ts)
    trc, tmrc = eng2.round_step_fn(frozen=True)(
        tmig, {"tokens": torch.from_numpy(sbs[ROUNDS])}, torch.tensor(ETA))
    rst, rep = train(eng, RunConfig(outer_iters=ROUNDS, shape=SHAPE, eta=ETA,
                                    metrics_every=1, log=None))
    rcst, rcrep = train(eng, RunConfig(outer_iters=ROUNDS + 1, shape=SHAPE,
                                       eta=ETA, metrics_every=1,
                                       reconfig=True, log=None))
    return dict(wire=wire, js=js, jloss=jloss, jidx=jidx, ts=ts,
                tloss=tloss, tidx=tidx, rst=rst, rep=rep, jb=jb, eng=eng,
                jmig=jmig, tmig=tmig, eng2=eng2, jrc=jrc, jmrc=jmrc,
                trc=trc, tmrc=tmrc, rcst=rcst, rcrep=rcrep)


def test_round_steps_match_reference(rounds):
    r = rounds
    np.testing.assert_allclose(np.array(r["tloss"]), np.array(r["jloss"]),
                               rtol=RTOL)
    for k, (ti, ji) in enumerate(zip(r["tidx"], r["jidx"], strict=True)):
        for name in RULES:
            np.testing.assert_array_equal(ti[name], ji[name],
                                          err_msg=f"round {k} {name}")
    # both rules prune: ffn keeps 4 of 8 columns in each of 16 shards,
    # heads 2 of 4 GQA groups, in each of the 2 layers
    assert r["tidx"][-1]["ffn"].shape == (2, 16, 4)
    assert r["tidx"][-1]["heads"].shape == (2, 2)
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
    for name in ("theta", "u", "mom"):
        for key, v in ts[name].items():
            assert torch.equal(rst[name][key], v), f"{name}/{key}"
    with jax_reference():
        jeng = JEngine(r["jb"], make_host_mesh(), SHAPE, consensus=LEVELS)
        _, dyn, frz = j_round_comm_bytes(jeng)
    assert rep.comm_bytes_internode == [dyn, dyn, frz]
    assert rep.wire_map == ["dense", r["wire"]]


def test_migration_and_reconfigured_round_match_reference(rounds):
    """``Engine.reconfigure`` of the frozen state equals the JAX
    migration (the mask indices exactly, every tree within the round
    tolerance: the states it starts from are the rounds' own), the
    budget-B shapes are the reference's, and one reconfigured round
    follows the JAX round on the shrunk bundle."""
    r = rounds
    eng2, tmig, jmig = r["eng2"], r["tmig"], r["jmig"]
    assert (eng2.cfg.d_ff, eng2.cfg.n_kv_heads, eng2.cfg.n_heads) == \
        (64, 2, 4)
    assert tmig["theta"]["blocks/attn/wq"].shape == (4, 2, 64, 2, 2, 16)
    assert tmig["theta"]["blocks/mlp/wd"].shape == (4, 2, 64, 64)
    for name in RULES:
        for f, v in jmig["masks"][name].items():
            np.testing.assert_array_equal(to_np(tmig["masks"][name][f]),
                                          np.asarray(v), err_msg=name)
    for name in ("theta", "u", "mom"):
        assert_tree_close(tmig[name], jmig[name], RTOL, ATOL)
    for k in range(2):
        assert_tree_close(tmig["z"][k], jmig["z"][k], RTOL, ATOL)
    np.testing.assert_allclose(to_np(r["tmrc"].losses),
                               np.asarray(r["jmrc"].losses), rtol=RTOL)
    for name in ("theta", "u"):
        assert_tree_close(r["trc"][name], r["jrc"][name], RTOL, ATOL)
    assert_tree_close(r["trc"]["z"][0], r["jrc"]["z"][0], RTOL, ATOL)
    _assert_top_z_close(r["trc"]["z"][1], r["jrc"]["z"][1], r["wire"])


def _assert_top_z_close(port, ref, wire):
    """The top level's z within rtol 1e-5, atol 1e-6; over the q8 wire an
    element may instead sit within one q8 step of its row (max |row| /
    127; the payload's rows run along the last axis): the ring rounds x /
    s to an integer, and the last-place differences of two frameworks can
    carry a value across a half step (the quantum rule of
    ``test_torch_codec.py``).  In the compact+q8 reconfigured round one
    element of ``head`` in 20,480 moves by half a step (one of two
    nodes' values)."""
    ref = np_flat(ref)
    assert set(port) == set(ref)
    for k, want in ref.items():
        got = to_np(port[k])
        atol = ATOL if wire == "dense" else np.maximum(
            ATOL, np.abs(want).max(axis=-1, keepdims=True) / 127)
        gap = np.abs(got - want) - (atol + RTOL * np.abs(want))
        assert not (gap > 0).any(), (k, np.argwhere(gap > 0)[:4],
                                     float(gap.max()))


def test_train_with_reconfig_runs_these_steps(rounds):
    """``train(reconfig=True)`` at patience 1: three rounds as above,
    the migration, the reconfigured round, bit for bit, at the
    reference's bytes for each kind of round."""
    r = rounds
    rep, st = r["rcrep"], r["rcst"]
    assert rep.executables == ["dynamic", "dynamic", "frozen",
                               "reconfigured"]
    assert rep.frozen_at == 2 and rep.reconfigured_at == 3
    assert rep.losses[:ROUNDS] == r["rep"].losses
    assert rep.losses[-1] == float(r["tmrc"].losses[-1])
    for name in ("theta", "u", "mom"):
        for key, v in r["trc"][name].items():
            assert torch.equal(st[name][key], v), f"{name}/{key}"
    for k in range(2):
        for key, v in r["trc"]["z"][k].items():
            assert torch.equal(st["z"][k][key], v), f"z{k}/{key}"
    assert rep.comm_bytes_internode[-1] == round_comm_bytes(r["eng2"])[2]


# (size, wire, reconfigured) -> the reference's (dense_equiv, dynamic,
# frozen) bytes per round; "full3" is the card's configuration (full
# width, 3 of 22 layers, f32), its compact+q8 rows the counts
# chip_smoke.py holds (a reconfigured round counts the frozen bytes);
# "full4" the 4-layer one the card's memory did not hold
BYTES = {
    ("smoke", "dense", False): (558_336, 362_784, 361_728),
    ("smoke", "compact+q8", False): (558_336, 100_212, 99_156),
    ("smoke", "compact+q8", True): (361_728, 99_684, 99_156),
    ("full4", "dense", False): (1_229_004_800, 876_773_440, 876_683_264),
    ("full4", "compact+q8", False): (1_229_004_800, 220_299_364,
                                     220_209_188),
    ("full4", "compact+q8", True): (876_683_264, 220_254_276, 220_209_188),
    ("full3", "compact+q8", False): (1_052_827_648, 198_057_036,
                                     197_989_404),
    ("full3", "compact+q8", True): (788_586_496, 198_023_220, 197_989_404),
}


def _identity_masks(plan, shapes, make):
    return {r.name: make(r, tuple(shapes[r.leaves[0].key][:r.stack_ndims]),
                         r.keep) for r in plan.rules}


@pytest.mark.parametrize("size,wire,reconfigured", sorted(BYTES))
def test_round_comm_bytes_match_reference(size, wire, reconfigured):
    def cfg(get):
        c = get(ARCH, smoke=True).replace(**GQA) if size == "smoke" \
            else get(ARCH).replace(n_layers=int(size[-1]),
                                   param_dtype="float32")
        return c.replace(hsadmm=dataclasses.replace(c.hsadmm,
                                                    wire_inter=wire))
    jeng = JEngine(j_build(cfg(get_config)), make_host_mesh(), SHAPE,
                   consensus=LEVELS)
    teng = Engine(t_build(cfg(t_get_config)), SHAPE, consensus=LEVELS,
                  device="cpu")
    if reconfigured:   # the budget-B engines, from frozen masks
        shapes = teng.bundle.shapes
        jeng, _ = jeng.reconfigure(masks=_identity_masks(
            jeng.spec.plan, shapes, jhs.identity_mask_state))
        teng, _ = teng.reconfigure(masks=_identity_masks(
            teng.spec.plan, shapes,
            lambda r, st, B: ths.identity_mask_state(r, st, B, "cpu")))
    assert round_comm_bytes(teng) == j_round_comm_bytes(jeng) \
        == BYTES[size, wire, reconfigured]


def test_convert_carries_the_dense_state_both_ways():
    """A JAX H-SADMM state of the dense LM (nested ``blocks/attn`` and
    ``blocks/mlp`` leaves, the balanced ffn rule's (L, 16, B/16) mask
    indices) goes to the port and back to the same tree, dtypes and
    bits."""
    hp = _hp("compact+q8")
    jb = j_build(get_config(ARCH, smoke=True).replace(hsadmm=hp,
                                                       qkv_bias=True, **GQA))
    jspec = jhs.EngineSpec(plan=jb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(jb.stack_map))
    st = jax.device_get(jhs.init_state(jb.init(jax.random.PRNGKey(1)),
                                       jspec))
    port = convert.state_from_jax(st, device="cpu")
    assert port["theta"]["blocks/attn/wq"].shape == (4, 2, 64, 4, 2, 16)
    assert port["theta"]["blocks/attn/bq"].shape == (4, 2, 4, 2, 16)
    assert port["masks"]["ffn"]["idx"].shape == (2, 16, 4)
    assert port["masks"]["ffn"]["idx"].dtype == torch.int64
    back = convert.state_to_jax(port)
    assert jax.tree.structure(back) == jax.tree.structure(st)
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(back)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)
