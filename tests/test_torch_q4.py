"""The port's q4 wire format against the JAX reference on the same numpy
inputs: the kernel shims (through the plain versions the wrappers take
for CPU tensors), the nibble-plane ring of ``Q4Codec.group_reduce``, the
codec's encode/decode pairs and its byte accounting.  The JAX side
quantizes with IEEE division of the scale, as the port does (see
``torch_port_helpers``), except where a test says it is jitted as is."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import comm as jcomm  # noqa: E402
from repro.configs import HsadmmConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch import comm as tcomm  # noqa: E402
from repro_torch.kernels import ops, wire  # noqa: E402

from torch_encode_cases import (check_decode_plan,  # noqa: E402
                                check_encode_plan, codec_views, kept_index)
from torch_port_helpers import (ieee_gather_quantize_q4,  # noqa: E402
                                ieee_quantize_pack_q4, jax_reference, to_np)

ANY_RANK = [(), (7,), (1, 1), (3, 5, 7), (4, 2, 3, 9), (4, 1, 10), (64, 10),
            (3, 3, 8, 16)]
COMPACT = [(5, 33, 12), (16, 10, 5), (7, 64, 32), (3, 9, 9), (1, 2, 1)]


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.standard_normal(shape) * scale, np.float32)


def _idx(C, B, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(C, B, replace=False)).astype(np.int32)


def _ulp_close(a, b):
    """Scales within one ulp of each other (the jitted reference's
    ``max * (1/7)`` against the port's ``max / 7``)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.all(np.abs(a - b) <= np.spacing(np.maximum(np.abs(a),
                                                         np.abs(b))))


# ---------------------------------------------------------------------------
# the shims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ANY_RANK)
def test_quantize_pack_q4_equals_eager_reference(shape):
    for seed, scale in enumerate((1e-3, 1.0, 1e3)):
        x = _x(shape, seed, scale)
        jp, js = ieee_quantize_pack_q4(jnp.asarray(x))
        tp, ts = ops.quantize_pack_q4(torch.from_numpy(x))
        assert tp.dtype == torch.uint8 and tuple(tp.shape) == jp.shape
        np.testing.assert_array_equal(to_np(tp), np.asarray(jp))
        np.testing.assert_array_equal(to_np(ts), np.asarray(js))


@pytest.mark.parametrize("shape", [(7,), (3, 5, 7), (64, 10), (3, 3, 8, 16)])
def test_quantize_pack_q4_within_an_ulp_of_jitted_reference(shape):
    """The jitted JAX shim's scale may sit one ulp off the port's."""
    x = _x(shape, 5)
    jp, js = jops.quantize_pack_q4(jnp.asarray(x))
    tp, ts = ops.quantize_pack_q4(torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(tp), np.asarray(jp))
    _ulp_close(to_np(ts), js)


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("C", [1, 10, 33])
def test_quantize_pack_q4_nonfinite_rows_equal_reference(value, C):
    """A row holding NaN or inf keeps the reference's values: NaN or inf
    scale, and the nibble 0 wherever the quotient is NaN."""
    x = _x((4, C), 3)
    x[1, 0] = x[1, C // 2] = value
    x[3, C - 1] = value
    jp, js = ieee_quantize_pack_q4(jnp.asarray(x))
    tp, ts = ops.quantize_pack_q4(torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(tp), np.asarray(jp))
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    assert not np.isfinite(to_np(ts)[1, 0])


@pytest.mark.parametrize("shape", ANY_RANK)
def test_unpack_dequantize_q4_equals_reference(shape):
    x = _x(shape, 7)
    jp, js = ieee_quantize_pack_q4(jnp.asarray(x))
    n = shape[-1] if shape else 1
    jout = jops.unpack_dequantize_q4(jp, js, n)
    tout = ops.unpack_dequantize_q4(torch.from_numpy(np.array(jp)),
                                    torch.from_numpy(np.array(js)), n)
    assert tuple(tout.shape) == jout.shape
    np.testing.assert_array_equal(to_np(tout), np.asarray(jout))


@pytest.mark.parametrize("R,C,B", COMPACT)
def test_gather_quantize_q4_and_scatter_dequantize_equal_reference(R, C, B):
    x, idx = _x((R, C), R * C), _idx(C, B, C)
    jp, js = ieee_gather_quantize_q4(jnp.asarray(x), jnp.asarray(idx))
    tp, ts = ops.gather_quantize_q4(torch.from_numpy(x),
                                    torch.from_numpy(idx).long())
    np.testing.assert_array_equal(to_np(tp), np.asarray(jp))
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    jout = jops.scatter_dequantize_q4(jp, js, jnp.asarray(idx), C)
    tout = ops.scatter_dequantize_q4(tp, ts, torch.from_numpy(idx).long(), C)
    np.testing.assert_array_equal(to_np(tout), np.asarray(jout))
    dropped = np.setdiff1d(np.arange(C), idx)
    assert np.all(to_np(tout)[:, dropped] == 0)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def _tree(lead, seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 3, 8, 16), "odd": (5, 7), "fc": (16, 10), "b": (16,),
              "b_odd": (9,)}
    return {k: np.asarray(rng.standard_normal((lead,) + s), np.float32)
            for k, s in shapes.items()}


def _weights(n):
    return np.linspace(0.5, 1.5, n).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("g,lead", [(2, 4), (4, 4), (2, 8), (4, 8)])
def test_q4_group_reduce_equals_eager_reference(g, lead, weighted):
    """Same quantizer, ring order and f32 nibble-plane accumulation as the
    reference: bit-equal to the JAX codec (not jitted) on the eager
    reference's quantizer, even and odd C, 1-D leaves."""
    tree = _tree(lead, g * lead)
    w = _weights(lead) if weighted else None
    with jax_reference(ieee_quantize=True):
        jout, _ = jcomm.get_codec("compact+q4").group_reduce(
            {k: jnp.asarray(v) for k, v in tree.items()}, g,
            None if w is None else jnp.asarray(w))
    tout, _ = tcomm.get_codec("compact+q4").group_reduce(
        {k: torch.from_numpy(v) for k, v in tree.items()}, g,
        None if w is None else torch.from_numpy(w))
    for k in tree:
        assert tuple(tout[k].shape) == jout[k].shape
        np.testing.assert_array_equal(to_np(tout[k]), np.asarray(jout[k]),
                                      err_msg=k)


@pytest.mark.parametrize("g,lead", [(2, 4), (4, 4)])
def test_q4_group_reduce_within_a_quantum_of_jitted_reference(g, lead):
    """Against the jitted JAX codec (scale max*(1/7), one ulp off), each
    output row stays within one quantum per group member."""
    tree, w = _tree(lead, 11), _weights(lead)
    jout, _ = jax.jit(lambda t, ww: jcomm.get_codec("q4").group_reduce(
        t, g, ww))({k: jnp.asarray(v) for k, v in tree.items()},
                   jnp.asarray(w))
    tout, _ = tcomm.get_codec("q4").group_reduce(
        {k: torch.from_numpy(v) for k, v in tree.items()}, g,
        torch.from_numpy(w))
    for k, x in tree.items():
        xw = x * w.reshape((-1,) + (1,) * (x.ndim - 1))
        rows = xw.reshape(lead, -1, x.shape[-1]) if x.ndim >= 2 \
            else xw.reshape(lead, 1, 1)
        quantum = np.abs(rows).max(axis=-1, keepdims=True) / 7
        tol = quantum.reshape(lead // g, g, -1, 1).sum(axis=1) * 1.01
        diff = np.abs(to_np(tout[k]) - np.asarray(jout[k]))
        diff = diff.reshape(lead // g, -1, rows.shape[-1])
        assert np.all(diff <= tol), k


@pytest.mark.parametrize("spec", ["q4", "compact+q4"])
@pytest.mark.parametrize("shape", ANY_RANK)
def test_q4_encode_decode_equal_reference(spec, shape):
    x = _x(shape, 13, 3.0)
    jc, tc = jcomm.get_codec(spec), tcomm.get_codec(spec)
    with jax_reference(ieee_quantize=True):
        jpay = jc.encode(jnp.asarray(x))
        jdec = jc.decode(jpay, like=jnp.asarray(x))
    tpay = tc.encode(torch.from_numpy(x))
    tdec = tc.decode(tpay, like=torch.from_numpy(x))
    for t, j in zip(tpay, jpay):
        np.testing.assert_array_equal(to_np(t), np.asarray(j))
    assert tuple(tdec.shape) == jdec.shape == x.shape
    np.testing.assert_array_equal(to_np(tdec), np.asarray(jdec))
    with pytest.raises(ValueError, match="template"):
        tc.decode(tpay)


@pytest.mark.parametrize("spec", ["q4", "compact+q4"])
@pytest.mark.parametrize("R,C,B", COMPACT)
def test_q4_encode_compact_decode_expand_equal_reference(spec, R, C, B):
    x, idx = _x((R, C), 17, 2.0), _idx(C, B, R)
    jc, tc = jcomm.get_codec(spec), tcomm.get_codec(spec)
    with jax_reference(ieee_quantize=True):
        jpay = jc.encode_compact(jnp.asarray(x), jnp.asarray(idx))
        jout = jc.decode_expand(jpay, jnp.asarray(idx), C,
                                like=jnp.asarray(x))
    ti = torch.from_numpy(idx).long()
    tpay = tc.encode_compact(torch.from_numpy(x), ti)
    tout = tc.decode_expand(tpay, ti, C, like=torch.from_numpy(x))
    for t, j in zip(tpay, jpay):
        np.testing.assert_array_equal(to_np(t), np.asarray(j))
    np.testing.assert_array_equal(to_np(tout), np.asarray(jout))


def test_q4_encode_compact_within_an_ulp_of_jitted_reference():
    x, idx = _x((16, 64), 19), _idx(64, 32, 3)
    jp, js = jcomm.get_codec("q4").encode_compact(jnp.asarray(x),
                                                  jnp.asarray(idx))
    tp, ts = tcomm.get_codec("q4").encode_compact(
        torch.from_numpy(x), torch.from_numpy(idx).long())
    np.testing.assert_array_equal(to_np(tp), np.asarray(jp))
    _ulp_close(to_np(ts), js)


@pytest.mark.parametrize("spec", ["q4", "compact+q4", "q4+compact"])
def test_q4_wire_bytes_and_spec_parsing_equal_reference(spec):
    t, j = tcomm.get_codec(spec), jcomm.get_codec(spec)
    assert (t.name, t.compact, t.stateful, t.gather) == \
        (j.name, j.compact, j.stateful, j.gather)
    for shape in [(), (7,), (1, 1), (64, 10), (3, 3, 64, 128), (2, 5, 7),
                  (3, 3, 3, 32), (256, 10)]:
        for dtype in ("float32", "bfloat16"):
            assert t.wire_bytes(shape, dtype) == j.wire_bytes(shape, dtype)


def test_q4_level_codecs_equal_reference():
    for hp, levels, kc in [
            (HsadmmConfig(wire_inter="compact+q4"), (4, 4), 1),
            (HsadmmConfig(wire_intra="q4", wire_inter="compact+q8"),
             (2, 2, 2), 1),
            (HsadmmConfig(wire_map=("q4", "compact+q4")), (4, 4), 1)]:
        assert [c.name for c in tcomm.level_codecs(hp, levels, kc)] == \
            [c.name for c in jcomm.level_codecs(hp, levels, kc)]


def test_unported_encode_pairs_refuse():
    """No codec's encode/decode pair refuses any more: the top-k pair
    round-trips (its values and order are held against the reference in
    ``test_torch_topk.py``), and the dense and q8 pairs run on the gather
    kernels (held in ``test_torch_gather.py``)."""
    x = torch.arange(32, dtype=torch.float32).reshape(4, 8) - 15.5
    for spec in ("topk:0.1", "compact+topk:0.1", "topk:1"):
        c = tcomm.get_codec(spec)
        vals, ti = c.encode(x)
        assert vals.shape == ti.shape == (c.element.k_of(32)
                                          if c.compact else c.k_of(32),)
        dec = c.decode((vals, ti), like=x)
        assert dec.shape == x.shape
        kept = dec != 0
        assert torch.equal(dec[kept], x[kept])
        assert int(kept.sum()) == vals.numel()
    assert torch.equal(tcomm.get_codec("topk:1").decode(
        tcomm.get_codec("topk:1").encode(x), like=x), x)
    x, idx = torch.ones(4, 8), torch.arange(4)
    for spec in ("compact+q8", "compact", "q8", "dense"):
        c = tcomm.get_codec(spec)
        assert c.decode(c.encode(x), like=x).shape == x.shape
        assert c.decode_expand(c.encode_compact(x, idx), idx, 8,
                               like=x).shape == x.shape


# ---------------------------------------------------------------------------
# one launch for many leaves: the q4 table and its per-leaf plan
# ---------------------------------------------------------------------------


def test_quantize_pack_q4_leaves_equals_eager_reference():
    """Every leaf of one ``quantize_pack_q4_leaves`` call (one launch of
    the q4 kernel on the card) equals the reference's encode of that
    leaf alone, any rank, odd and even C."""
    xs = [_x(shape, seed, 10.0 ** (seed % 5 - 2))
          for seed, shape in enumerate(ANY_RANK)]
    got = ops.quantize_pack_q4_leaves([torch.from_numpy(x) for x in xs])
    assert len(got) == len(xs)
    for x, (tp, ts) in zip(xs, got):
        jp, js = ieee_quantize_pack_q4(jnp.asarray(x))
        assert tp.dtype == torch.uint8 and tuple(tp.shape) == jp.shape
        np.testing.assert_array_equal(to_np(tp), np.asarray(jp))
        np.testing.assert_array_equal(to_np(ts), np.asarray(js))


@pytest.mark.parametrize("C", [1, 2, 3, 7, 10, 32, 33, 64, 128, 256, 257,
                               1536, 3072, 3073, 6144, 6145, 12288])
@pytest.mark.parametrize("R", [1, 97, 32808])
@pytest.mark.parametrize("xptr,pptr", [(0, 0), (4, 0), (0, 1), (8, 2)])
def test_q4_plan_covers_rows(C, R, xptr, pptr):
    """A leaf's q4 plan: vectors of four floats only where C % 4 == 0, x
    is 16-byte and p 2-byte aligned (else pairs of columns); a power of
    two of lanes; the registers cover the row, or the row streams (one
    warp a row) past 6 vectors a lane at 256 lanes; the blocks cover
    every row."""
    lanes, nv, vec = wire.q4_plan(R, C, xptr, pptr)
    assert vec == (4 if C % 4 == 0 and xptr % 16 == 0 and pptr % 2 == 0
                   else 2)
    nvec = -(-C // vec)
    assert (lanes, nv) == wire._lanes(R, nvec)
    assert lanes in (1, 2, 4, 8, 16, 32, 64, 128, 256)
    blocks = wire.q4_blocks(R, lanes, nv)
    if nv:
        assert nv in wire.QUANT_NV and lanes * nv >= nvec
        assert blocks * (256 // lanes) >= R > (blocks - 1) * (256 // lanes)
    else:
        assert lanes == 32 and nvec > 256 * wire.QUANT_NV[-1]
        assert blocks * 8 >= R > (blocks - 1) * 8


def test_q4_table_holds_the_resnet_payload_in_one_launch():
    """ResNet-18's 62 compact payload leaves at 4 members (phase 3b's q4
    ring) fit one table: one launch, every leaf's rows in registers (no
    leaf streams), 16-byte loads where its width allows."""
    from repro_torch.configs import get_config
    from repro_torch.core.masks import MaskSyncConfig, budget
    from repro_torch.core.shrinkage import plan_payload_shapes
    from repro_torch.models import build
    b = build(get_config("resnet18"))
    budgets = {r.name: budget(r, MaskSyncConfig()) for r in b.plan.rules}
    shapes = plan_payload_shapes(b.shapes, b.plan, budgets).values()
    views = [ops._rc((4,) + tuple(s)) for s in shapes]
    assert len(views) == 62 <= wire.Q4_CAPACITY
    assert sum(R * C for R, C in views) == 11_190_440
    for R, C in views:
        lanes, nv, vec = wire.q4_plan(R, C, 0, 0)
        assert nv > 0 and vec == (4 if C % 4 == 0 else 2)


# ---------------------------------------------------------------------------
# the fused q4 encode's plan (wire.gather_quantize_q4_plan)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ptr", [0, 4])
def test_gather_quantize_q4_plan_covers_codec_operands(ptr):
    """ResNet-18's 60 encode_compact operands at 4 members: every row in
    registers, vectors of four (two packed bytes), read as 16-byte runs at
    an aligned base and column by column at a base 4 bytes off."""
    views = codec_views("resnet18", 4)
    assert len(views) == 60
    for _, R, C, B, _ in views:
        lanes, nv, vec, runs = check_encode_plan(
            wire.gather_quantize_q4_plan, R, B, C, ptr, q4=True)
        assert nv > 0 and vec == 4 and runs == (ptr == 0)
        assert wire.q4_blocks(R, lanes, nv) * (256 // lanes) >= R


@pytest.mark.parametrize("R,B,C,ptr", [
    (1, 256, 512, 0),         # one row
    (97, 9, 33, 0),           # odd B: pairs, one pad nibble
    (97, 10, 33, 0),          # B % 4 == 2: pairs
    (97, 12, 33, 0),          # C % 4 != 0: no 16-byte runs
    (5, 6144, 12288, 0),      # the widest row held in registers
    (5, 8192, 16384, 4),      # too wide: streams
    (3, 3073, 6146, 0),       # too wide for pairs
    (18432, 256, 512, 0),     # ResNet's largest leaf
])
def test_gather_quantize_q4_plan_edges(R, B, C, ptr):
    lanes, nv, vec, runs = check_encode_plan(
        wire.gather_quantize_q4_plan, R, B, C, ptr, q4=True)
    blocks = wire.q4_blocks(R, lanes, nv)
    rows = 8 if nv == 0 else 256 // lanes
    assert blocks * rows >= R > (blocks - 1) * rows


@pytest.mark.parametrize("kind", ["groups", "off4", "unsorted"])
@pytest.mark.parametrize("R,C,B", [(6, 64, 32), (3, 128, 40)])
def test_gather_quantize_q4_equals_jitted_reference(kind, R, C, B):
    """vs the jitted JAX shim with the eager reference's division (fault
    B): packed bytes exact, scales to one ulp."""
    x = _x((R, C), R + C, 3.0)
    idx = kept_index(kind, C, B, 6)
    with jax_reference(ieee_quantize=True):
        jp, js = jax.jit(jops.gather_quantize_q4)(jnp.asarray(x),
                                                  jnp.asarray(idx))
    tp, ts = ops.gather_quantize_q4(torch.from_numpy(x),
                                    torch.from_numpy(idx))
    np.testing.assert_array_equal(to_np(tp), np.asarray(jp))
    assert tuple(ts.shape) == js.shape
    _ulp_close(to_np(ts), js)


# ---------------------------------------------------------------------------
# the q4 decode's plan (wire.unpack_gather_dequantize_q4_plan) and its
# index domain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ptr", [0, 4])
@pytest.mark.parametrize("optr", [0, 4])
def test_unpack_gather_dequantize_q4_plan_covers_codec_operands(ptr, optr):
    """The q4 decodes of ResNet-18's 60 encode_compact operands at 4
    members (p (R, B/2) expanded to C columns): every row in registers;
    float4 stores and 2-byte runs of p at bases 0 and 4 modulo 16, single
    columns where the output is 4 bytes off."""
    views = codec_views("resnet18", 4)
    assert len(views) == 60
    for _, R, C, B, _ in views:
        lanes, nv, vec, runs, unit = check_decode_plan(
            wire.unpack_gather_dequantize_q4_plan, R, C, (B + 1) // 2, ptr,
            optr, q4=True)
        assert nv > 0 and vec == (4 if optr == 0 else 1)
        assert unit == (16 if ptr == 0 else 4) and runs == (optr == 0)


@pytest.mark.parametrize("R,Cout,Cp,ptr,optr,index", [
    (1, 512, 128, 0, 0, True),        # one row
    (97, 33, 17, 0, 0, True),         # Cout % 4 != 0: single columns
    (97, 1, 1, 0, 0, True),           # Cout = 1
    (97, 12, 5, 0, 0, True),          # Cp odd: in place, no runs
    (97, 12, 6, 1, 0, True),          # p 1 byte off: in place, no runs
    (97, 16, 6, 2, 0, True),          # p 2 bytes off: in place, runs
    (97, 16, 8, 4, 0, True),          # staged by words, runs
    (97, 8, 12, 2, 0, True),          # p wider than out: read in place
    (97, 8, 12, 1, 0, True),          # the same 1 byte off: no runs
    (97, 64, 32, 0, 0, False),        # the identity: nothing staged
    (97, 64, 32, 1, 0, False),        # the identity 1 byte off: no runs
    (5, 6144, 1536, 0, 0, True),      # the widest row held in registers
    (5, 8192, 2048, 2, 0, True),      # too wide: streams, nothing staged
    (18432, 512, 128, 0, 0, True),    # ResNet's largest leaf
])
def test_unpack_gather_dequantize_q4_plan_edges(R, Cout, Cp, ptr, optr,
                                                index):
    check_decode_plan(wire.unpack_gather_dequantize_q4_plan, R, Cout, Cp,
                      ptr, optr, q4=True, index=index)


@pytest.mark.parametrize("kind", ["groups", "off4", "cols"])
@pytest.mark.parametrize("R,C,B", [(6, 64, 32), (3, 40, 12), (2, 9, 3)])
def test_unpack_gather_dequantize_q4_zero_index_equals_padded_pallas(
        kind, R, C, B):
    """The q4 decode's extended index (nibble 2*Cp of an (R, Cp) p reading
    as zero) against the TPU kernel in interpret mode on p padded by a
    zero byte column, the JAX contract: bit-equal, NaN on a row whose
    scale is NaN."""
    from repro.kernels import wire as jwire
    rng = np.random.default_rng(R + C + B)
    p = rng.integers(0, 256, (R, (B + 1) // 2)).astype(np.uint8)
    s = np.abs(rng.standard_normal((R, 1))).astype(np.float32)
    s[0, 0] = np.nan
    idx = kept_index(kind, C, B, 3, g=min(8, B)) if kind != "cols" else \
        np.sort(rng.choice(C, B, replace=False))
    tp = torch.from_numpy(p)
    inv = ops._ref.inverse_index_q4(tp, torch.from_numpy(idx), C)
    got = wire.unpack_gather_dequantize_q4(tp, torch.from_numpy(s), inv)
    want = jwire.unpack_gather_dequantize_q4(
        jnp.pad(jnp.asarray(p), ((0, 0), (0, 1))), jnp.asarray(s),
        jnp.asarray(to_np(inv)), interpret=True)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert np.isnan(to_np(got)[0]).all()


def test_q4_decode_shims_pass_the_payload_itself(monkeypatch):
    """The q4 zero-fill shim hands the decode p itself (no padded copy)
    and an int64 inverse index whose dropped columns hold 2*Cp; the plain
    decode hands it no index."""
    seen = []
    monkeypatch.setattr(wire, "unpack_gather_dequantize_q4",
                        lambda p, s, idx: seen.append((p, idx)) or
                        torch.zeros(p.shape[0], idx.shape[0]))
    monkeypatch.setattr(wire, "unpack_dequantize_q4",
                        lambda p, s, n: seen.append((p, n)) or
                        torch.zeros(p.shape[0], n))
    p = torch.ones(3, 2, dtype=torch.uint8)
    idx = torch.tensor([1, 4, 7])
    ops.scatter_dequantize_q4(p, torch.ones(3, 1), idx, 9)
    ops.unpack_dequantize_q4(p, torch.ones(3, 1), 3)
    (p1, inv), (p2, n) = seen
    assert p1.shape == (3, 2) and p1.data_ptr() == p.data_ptr()
    assert inv.dtype == torch.int64
    assert inv.tolist() == [4, 0, 4, 4, 1, 4, 4, 2, 4]
    assert p2.shape == (3, 2) and n == 3
