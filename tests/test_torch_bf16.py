"""bfloat16 in the port against the JAX package: the configs' own
``param_dtype`` of the LM families.

* The prox-SGD update through ``ops.prox_sgd_update`` at bf16 against the
  jitted JAX shim, ``array_equal``, on the layouts of
  ``tests/test_kernels.py::test_prox_sgd_update_shim`` (per-row rho, a
  1-D leaf, the two plain fallbacks): JAX rounds a Python number
  (``momentum``) to bf16 before it uses it and rounds every operation to
  bf16, and so does the port (``kernels.ref.weak``).  The JAX side takes
  the plain jnp update for the interpreted Pallas kernel
  (``torch_port_helpers.jax_reference``).
* ``quantize_rows`` on bf16 rows against the jitted JAX ``quantize_rows``
  with the eager reference's division: q exact, scales within 1 ulp.
* One bf16 ``round_step`` of tinyllama smoke (8 query heads in 4 GQA
  groups) and of mamba2 smoke, compact+q8, against the jitted JAX
  ``round_step`` outside a mesh from one JAX-drawn state: theta, z, u and
  the losses within rtol = atol = 2e-2 (the JAX suite's bf16 tolerance,
  ``tests/test_kernels.py``), the masks equal; the consensus step alone
  from the JAX round's state, over the dense wire, ``array_equal`` to the
  jitted JAX ``consensus_step`` (the round's tolerance cannot see how the
  consensus rounds).
* ``round_comm_bytes`` at the depths ``chip_smoke.py``'s phase 11 trains
  at bf16 (tinyllama full-shape and reconfigured, mamba2) equals the JAX
  ``Engine``'s.
* ``convert`` of bf16 JAX params both ways, and checkpoints of a bf16
  state: each member of a port save's ``arrays.npz`` byte-equal to a JAX
  save's, restores bit-equal in the port; the JAX ``restore`` of a bf16
  save raises ``ValueError`` (it cannot cast numpy's 2-byte void type).
* The card's cases (the bf16 kernels against their plain versions) are
  in ``tests/test_torch_bf16_cuda.py``, which imports no JAX.
"""
import os
import zipfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ConsensusSpec, HsadmmConfig, ShapeConfig, get_config  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import hsadmm as jhs  # noqa: E402
from repro.data.synthetic import make_stream as j_make_stream  # noqa: E402
from repro.dist import checkpoint as jckpt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.train.engine import Engine as JEngine  # noqa: E402
from repro.train.loop import round_comm_bytes as j_round_comm_bytes  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import hsadmm as ths  # noqa: E402
from repro_torch.dist import checkpoint as ckpt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.train.engine import Engine  # noqa: E402
from repro_torch.train.loop import round_comm_bytes  # noqa: E402

from torch_port_helpers import (ieee_quantize_rows, jax_reference,  # noqa: E402
                                np_flat)

BF16 = torch.bfloat16
TOL = 2e-2    # tests/test_kernels.py: the JAX suite's bf16 tolerance
LEVELS = ConsensusSpec(levels=(2, 2), compact_from_level=1)
SHAPE = ShapeConfig("tiny", "train", 32, 8)    # 2 sequences per worker
ETA = 1e-3
LM = {"tinyllama-1.1b": dict(n_heads=8, n_kv_heads=4), "mamba2-780m": {}}


def _bf16(shape, seed: int, scale: float = 1.0, shift: float = 0.0):
    """A seeded bf16 tensor (numpy normals rounded once) and the same bits
    as a JAX array."""
    x = (np.random.default_rng(seed).standard_normal(shape) * scale
         + shift).astype(np.float32)
    t = torch.from_numpy(x).to(BF16)
    return t, jnp.asarray(convert.to_numpy(t))


def _f32(x) -> np.ndarray:
    """Values of a bf16 JAX array or tensor as f32 numpy (exact)."""
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the prox update and the q8 quantizer at bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,rshape", [
    ((4, 3, 8, 16), (1, 3, 1, 1)),    # layer-wise adaptive rho
    ((4, 16), (1, 1)),                # bias-like leaf
    ((4,), (1,)),                     # 1-D leaf (one padded row)
    ((4, 3, 8, 16), (1, 3, 1, 16)),   # rho varies on minor axis -> fallback
    ((8,), (8,)),                     # 1-D leaf, per-element rho -> fallback
    ((64, 256), (64, 1)),             # a row per rho, 16 384 elements
])
def test_prox_update_matches_jitted_jax(shape, rshape):
    """theta', mom' array_equal to the jitted JAX shim at bf16, rho and
    eta f32 as the rounds hand them in (the shims cast both)."""
    pairs = [_bf16(shape, i, scale=(1.0, 0.1, 1.0, 0.01, 0.5)[i])
             for i in range(5)]
    rho = np.random.default_rng(9).uniform(size=rshape).astype(np.float32) \
        + np.float32(0.1)
    eta = np.float32(3e-3)
    with jax_reference():
        jt, jm = jax.jit(lambda *a: jops.prox_sgd_update(*a, momentum=0.9))(
            *(j for _, j in pairs), jnp.asarray(rho), jnp.asarray(eta))
    tt, tm = tops.prox_sgd_update(*(t for t, _ in pairs), torch.from_numpy(rho),
                                  torch.tensor(eta), momentum=0.9)
    assert tt.dtype == tm.dtype == BF16
    np.testing.assert_array_equal(_f32(tt), _f32(jt))
    np.testing.assert_array_equal(_f32(tm), _f32(jm))


def test_momentum_rounds_like_jax():
    """The hazard the port's ``weak`` rounding answers: with 0.9 kept in
    f32 (PyTorch's way with a Python number) the momentum differs from
    JAX's in many elements; rounded to bf16 (0.8984375) in none."""
    m, jm = _bf16((65536,), 3)
    g, jg = _bf16((65536,), 4)
    want = _f32(jax.jit(lambda m, g: 0.9 * m + g)(jm, jg))
    assert tref.weak(0.9, BF16) == 0.8984375
    np.testing.assert_array_equal(_f32(tref.weak(0.9, BF16) * m + g), want)
    assert np.count_nonzero(_f32(0.9 * m + g) != want) > 1000


@pytest.mark.parametrize("shape", [(37, 64), (8, 1537), (3, 4, 10), (16,)])
def test_quantize_rows_on_bf16_rows(shape):
    """bf16 rows read as f32 (exact): q equal to the jitted JAX quantizer's
    and to the f32 route's, the scales within 1 ulp of JAX's and equal to
    the f32 route's."""
    t, j = _bf16(shape, 5)
    t[(0,) * len(shape)] = float("nan")
    j = jnp.asarray(convert.to_numpy(t))
    q, s = tops.quantize_rows(t)
    jq, js = jax.jit(ieee_quantize_rows)(j)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    q32, s32 = tops.quantize_rows(t.float())
    assert torch.equal(q, q32)
    torch.testing.assert_close(s, s32, rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# one bf16 round of each LM family against the jitted JAX round
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(LM))
def bf16_round(request):
    """One bf16 round of both packages from one state (drawn by the port,
    carried to JAX by ``convert``: the same numbers in both)."""
    arch = request.param
    hp = HsadmmConfig(local_steps=2, t_freeze=2, wire_inter="compact+q8")
    kw = dict(hsadmm=hp, param_dtype="bfloat16", **LM[arch])
    jb = j_build(get_config(arch, smoke=True).replace(**kw))
    jspec = jhs.EngineSpec(plan=jb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(jb.stack_map))
    tb = t_build(t_get_config(arch, smoke=True).replace(**kw))
    tspec = ths.EngineSpec(plan=tb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(tb.stack_map))
    st0 = convert.state_to_jax(ths.init_state(
        tb.init(torch.Generator().manual_seed(0), "cpu"), tspec))
    stream = j_make_stream(jb.cfg, SHAPE, LEVELS.num_workers)
    sb = np.stack([np.asarray(stream.batch_at(e)["tokens"])
                   for e in range(2)])
    with jax_reference(ieee_quantize=True):
        js, jm = jax.jit(lambda s, b: jhs.round_step(
            s, b, jb.train_loss, jspec, jnp.float32(ETA)))(
            jax.tree.map(jnp.asarray, st0), {"tokens": jnp.asarray(sb)})
    js = jax.device_get(js)
    ts, tm = ths.round_step(convert.state_from_jax(st0, device="cpu"),
                            {"tokens": torch.from_numpy(sb)},
                            tb.train_loss, tspec, ETA)
    return dict(arch=arch, js=js, jloss=np.asarray(jm.losses),
                ts=ts, tloss=tm.losses.numpy(), jb=jb, tb=tb)


def _close(port: dict, ref: dict, what: str):
    ref = np_flat(ref)
    assert set(port) == set(ref)
    for k, v in ref.items():
        assert port[k].dtype == BF16, k
        np.testing.assert_allclose(_f32(port[k]), _f32(v), rtol=TOL,
                                   atol=TOL, err_msg=f"{what}/{k}")


def test_bf16_round_matches_reference(bf16_round):
    r = bf16_round
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=TOL, atol=TOL)
    ts, js = r["ts"], r["js"]
    for name in ("theta", "u"):
        _close(ts[name], js[name], name)
    for k in range(2):
        _close(ts["z"][k], js["z"][k], f"z{k}")
    for rule, m in js["masks"].items():
        np.testing.assert_array_equal(ts["masks"][rule]["idx"].numpy(),
                                      np.asarray(m["idx"]), err_msg=rule)


def test_bf16_consensus_step_equals_jitted_jax(bf16_round):
    """The consensus step alone, from the JAX round's state (theta and u
    differ across the workers), over the dense wire: theta, u and every z
    level array_equal to the jitted JAX ``consensus_step``.  The round's
    2e-2 check cannot see a consensus computed in f32 and rounded once;
    this one can (hundreds of thousands of elements differ then).  Over
    q8 a handful of z entries near zero differ by a scale's ulp (the
    quantizer's 1-ulp scales), so the dense wire is the exact case."""
    r = bf16_round
    hp = HsadmmConfig(local_steps=2, t_freeze=2, wire_inter="dense")
    jspec = jhs.EngineSpec(plan=r["jb"].plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(r["jb"].stack_map))
    tspec = ths.EngineSpec(plan=r["tb"].plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(r["tb"].stack_map))
    with jax_reference():
        js, _ = jax.jit(lambda s: jcons.consensus_step(s, jspec,
                                                       detail=False))(
            jax.tree.map(jnp.asarray, r["js"]))
    js = jax.device_get(js)
    ts, _ = tcons.consensus_step(convert.state_from_jax(r["js"],
                                                        device="cpu"),
                                 tspec, detail=False)
    pairs = [(ts["theta"], js["theta"]), (ts["u"], js["u"])] + [
        (ts["z"][k], js["z"][k]) for k in range(2)]
    for port, ref in pairs:
        ref = np_flat(ref)
        assert set(port) == set(ref)
        for k, v in ref.items():
            assert port[k].dtype == BF16, k
            np.testing.assert_array_equal(_f32(port[k]), _f32(v), err_msg=k)


def test_convert_bf16_both_ways(bf16_round):
    """JAX bf16 params (the JAX round's theta) -> port -> JAX: the same
    dtype and bits."""
    p0 = bf16_round["js"]["theta"]
    tp = convert.params_from_jax(p0, device="cpu")
    back = convert.params_to_jax(tp)
    for k, a in np_flat(p0).items():
        assert tp[k].dtype == BF16, k
        b = np_flat(back)[k]
        assert b.dtype == a.dtype, k
        assert b.tobytes() == a.tobytes(), k


# (dense-equivalent, dynamic, frozen) bytes a round over compact+q8 at the
# depths phase 11 of chip_smoke.py trains (its BF16_BYTES and
# BF16_MAMBA_BYTES), at bf16; "reconfigured": the budget-B engine's
BYTES = {
    ("tinyllama-1.1b", 10, False): (1_143_033_856, 353_753_332, 353_527_892),
    ("tinyllama-1.1b", 10, True): (702_631_936, 353_640_612, 353_527_892),
    ("mamba2-780m", 12, False): (660_351_360, 248_950_436, 248_948_132),
}


@pytest.mark.parametrize("arch,layers,reconfigured", sorted(BYTES))
def test_round_comm_bytes_at_bf16(arch, layers, reconfigured):
    def cfg(get):
        c = get(arch).replace(n_layers=layers)
        assert c.param_dtype == "bfloat16"
        return c.replace(hsadmm=HsadmmConfig(wire_inter="compact+q8"))
    shape = ShapeConfig("train_4k", "train", 4096, 4)
    jeng = JEngine(j_build(cfg(get_config)), make_host_mesh(), shape,
                   consensus=LEVELS)
    teng = Engine(t_build(cfg(t_get_config)), shape, consensus=LEVELS,
                  device="cpu")
    if reconfigured:   # the budget-B engines, from all-kept masks
        shapes = teng.bundle.shapes
        jeng, _ = jeng.reconfigure(masks={r.name: jhs.identity_mask_state(
            r, tuple(shapes[r.leaves[0].key][:r.stack_ndims]), r.keep)
            for r in jeng.spec.plan.rules})
        teng, _ = teng.reconfigure(masks={r.name: ths.identity_mask_state(
            r, tuple(shapes[r.leaves[0].key][:r.stack_ndims]), r.keep,
            "cpu") for r in teng.spec.plan.rules})
    with jax_reference():
        want = j_round_comm_bytes(jeng)
    assert round_comm_bytes(teng) == want == BYTES[arch, layers,
                                                   reconfigured]


def _members(path) -> dict:
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_bf16_checkpoints(bf16_round, tmp_path):
    """A JAX save and a port save of one bf16 state: every npz member's
    bytes equal; the port restores either bit for bit; the JAX ``restore``
    of its own save raises (it cannot cast the loaded 2-byte void type)."""
    js = bf16_round["js"]
    meta = {"step": 1}
    jp = jckpt.save(str(tmp_path / "jax"), jax.tree.map(jnp.asarray, js),
                    meta)
    ts = convert.state_from_jax(js, device="cpu")
    tp = ckpt.save(str(tmp_path / "port"), ts, meta)
    ckpt.flush()
    jm, tm = _members(jp), _members(tp)
    assert list(jm) == list(tm)
    assert any(b"'<V2'" in v[:128] for v in tm.values())
    # the port's bytes do not lean on the bfloat16 that JAX registered
    # with numpy in this process: its leaves reach the writer as plain
    # 2-byte void words, which the card's machine (no ml_dtypes) has too
    leaf = next(v for v in ckpt._flatten(ts).values() if v.dtype == BF16)
    assert ckpt._host(leaf, copy=True).dtype.str == "|V2"
    for n in jm:
        assert tm[n] == jm[n], n
    template = {k: v for k, v in bf16_round["ts"].items()}
    for path in (jp, tp):
        got, _ = ckpt.restore(path, template)
        a, b = ckpt._flatten(got), ckpt._flatten(ts)
        for p in b:
            assert a[p].dtype == b[p].dtype, p
            assert torch.equal(a[p].view(torch.int16) if a[p].dtype == BF16
                               else a[p], b[p].view(torch.int16)
                               if b[p].dtype == BF16 else b[p]), p
    with pytest.raises(ValueError):
        jckpt.restore(jp, jax.tree.map(jnp.asarray, js))
