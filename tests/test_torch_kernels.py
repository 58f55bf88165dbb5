"""The port's kernel shims against the JAX package's references, through
the plain versions the wrappers take for CPU tensors.  The CUDA kernels
against their plain versions are in ``test_torch_kernels_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import compact, ops, wire  # noqa: E402

from torch_encode_cases import (check_decode_plan,  # noqa: E402
                                check_encode_plan, codec_views, kept_index)
from torch_port_helpers import jax_reference, to_np  # noqa: E402

# the shapes of tests/test_kernels.py::test_prox_sgd_update_shim, plus
# stacked (W, ...) leaves as local_step passes them and 0-D leaves
SHIM_CASES = [
    ((4, 3, 8, 16), (1, 3, 1, 1)),    # layer-wise adaptive rho
    ((4, 16), (1, 1)),                # bias-like leaf
    ((4,), (1,)),                     # 1-D leaf (one padded row)
    ((4, 3, 8, 16), (1, 3, 1, 16)),   # rho varies on minor axis: plain
    ((8,), (8,)),                     # 1-D leaf, per-element rho: plain
    ((16, 3, 3, 3, 64), (1, 1, 1, 1, 1)),   # stacked HWIO conv leaf
    ((16, 10), (1, 1)),               # stacked bias
    ((), ()),                         # 0-D leaf
]
QUANT_SHAPES = [(1, 1), (1, 7), (3, 1), (5, 33), (16, 128), (7, 257),
                (64, 10)]
ANY_RANK = [(), (7,), (1, 1), (3, 5, 7), (4, 2, 3, 9), (4, 1, 10)]


def _inputs(shape, rshape, seed=0):
    rng = np.random.default_rng(seed)
    xs = [np.asarray(rng.standard_normal(shape), np.float32)
          for _ in range(5)]
    rho = np.asarray(rng.random(rshape) + 0.1, np.float32)
    return xs, rho


@pytest.mark.parametrize("shape,rshape", SHIM_CASES)
def test_prox_sgd_update_matches_reference(shape, rshape):
    xs, rho = _inputs(shape, rshape)
    eta = np.float32(3e-3)
    tr, mr = jref.fused_prox_sgd_ref(*map(jnp.asarray, xs), eta=eta,
                                     rho=jnp.asarray(rho), momentum=0.9)
    t, m = ops.prox_sgd_update(*map(torch.from_numpy, xs),
                               torch.from_numpy(rho), float(eta),
                               momentum=0.9)
    assert tuple(t.shape) == np.shape(tr) and tuple(m.shape) == np.shape(mr)
    np.testing.assert_allclose(to_np(t), np.asarray(tr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(m), np.asarray(mr), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 128), (6, 128, 256), (128,), (7,), ()])
def test_fused_prox_sgd_scalar_entry_matches_reference(shape):
    xs, _ = _inputs(shape, ())
    t, m = ops.fused_prox_sgd(*map(torch.from_numpy, xs), eta=1e-2, rho=1e-3,
                              momentum=0.9)
    tr, mr = jref.fused_prox_sgd_ref(*map(jnp.asarray, xs), eta=1e-2,
                                     rho=1e-3, momentum=0.9)
    np.testing.assert_allclose(to_np(t), np.asarray(tr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(m), np.asarray(mr), rtol=1e-6, atol=1e-6)


def test_prox_sgd_update_without_momentum_or_consensus():
    """Missing operands take the reference's plain semantics."""
    xs, _ = _inputs((4, 8), ())
    th, g, z, u, _ = map(torch.from_numpy, xs)
    t, m = ops.prox_sgd_update(th, g, None, None, None, None, 1e-2)
    assert m is None
    np.testing.assert_allclose(to_np(t), to_np(th - 1e-2 * g), rtol=1e-6)
    t, m = ops.prox_sgd_update(th, g, z, u, None, torch.tensor(0.3), 1e-2)
    assert m is None
    np.testing.assert_allclose(
        to_np(t), to_np(th - 1e-2 * (g + 0.3 * (th - z + u))), rtol=1e-5,
        atol=1e-6)


def _quant_input(shape, seed):
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 3)
    return np.asarray(rng.standard_normal(shape) * scale, np.float32)


@pytest.mark.parametrize("shape", QUANT_SHAPES)
@pytest.mark.parametrize("levels", [127, 7])
def test_quantize_rows_equals_eager_reference(shape, levels):
    for seed in range(4):
        x = _quant_input(shape, seed)
        qr, sr = jref.quantize_rows_ref(jnp.asarray(x), levels)
        q, s = wire.quantize_rows(torch.from_numpy(x), levels=levels)
        np.testing.assert_array_equal(to_np(q), np.asarray(qr))
        np.testing.assert_array_equal(to_np(s), np.asarray(sr))


NONFINITE = [("nan", np.nan), ("inf", np.inf), ("-inf", -np.inf)]


def _nonfinite_input(value, C):
    """Four rows of width C; row 1 holds ``value`` at two columns."""
    x = _quant_input((4, C), 5)
    x[1, 0] = x[1, C // 2] = value
    return x


@pytest.mark.parametrize("name,value", NONFINITE)
@pytest.mark.parametrize("C", [1, 33])
def test_quantize_rows_nonfinite_row_equals_eager_reference(name, value, C):
    """A non-finite row keeps the reference's values: a NaN scale for a
    NaN row, an inf scale for an inf row, and q = 0 wherever the quotient
    is NaN; the other rows are untouched."""
    x = _nonfinite_input(value, C)
    qr, sr = jref.quantize_rows_ref(jnp.asarray(x))
    q, s = wire.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(q), np.asarray(qr))
    np.testing.assert_array_equal(to_np(s), np.asarray(sr))
    assert not np.isfinite(to_np(s)[1, 0])


@pytest.mark.parametrize("shape", ANY_RANK)
def test_quantize_rows_any_rank_matches_jitted_shim(shape):
    """vs the jitted JAX shim, whose scale is max*(1/127): the scales agree
    to one ulp, and q differs only by one step where that ulp moves a
    value across a rounding boundary."""
    for seed in range(8):
        x = _quant_input(shape, seed)
        qj, sj = jops.quantize_rows(jnp.asarray(x))
        q, s = ops.quantize_rows(torch.from_numpy(x))
        sj, qj = np.asarray(sj), np.asarray(qj)
        assert q.shape == qj.shape and s.shape == sj.shape
        s = to_np(s)
        np.testing.assert_array_less(np.abs(s - sj),
                                     np.spacing(np.abs(sj)) * 1.5)
        same = np.broadcast_to(s == sj, qj.shape)
        dq = np.abs(to_np(q).astype(np.int32) - qj.astype(np.int32))
        assert np.all(dq[same] == 0) and np.all(dq <= 1)


def test_launch_counts_do_not_move_on_the_cpu():
    ops.reset_launch_counts()
    x, idx = torch.ones(4, 8), torch.arange(4)
    ops.prox_sgd_update(*[x] * 5, torch.tensor(0.1), 1e-2)
    ops.quantize_rows(x)
    ops.unpack_dequantize_q4(*ops.quantize_pack_q4(x), 8)
    ops.scatter_dequantize_q4(*ops.gather_quantize_q4(x, idx), idx, 8)
    ops.expand_groups(ops.compact_groups(x[None], idx), idx, 8)
    ops.gather_leaves([x, 2 * x], idx.reshape(4, 1).expand(4, 2), [1, 1], 0, 2)
    ops.quantize_pack_q4_leaves([x, x[0], x.t()])
    ops.scatter_dequantize(*ops.gather_quantize(x, idx), idx, 8)
    ops.dequantize_rows(*ops.quantize_rows(x))
    ops.group_norms_sq(x.reshape(2, 2, 8))
    ops.ssd_chunk_scan(torch.ones(1, 8, 2, 4), torch.ones(1, 8, 2),
                       -torch.ones(2), torch.ones(1, 8, 3),
                       torch.ones(1, 8, 3), chunk=4)
    assert ops.launch_counts() == {
        "fused_prox_sgd": 0, "fused_prox_sgd_dyn": 0, "gather_groups": 0,
        "quantize_rows": 0, "gather_quantize": 0, "gather_dequantize": 0,
        "quantize_pack_q4": 0, "gather_quantize_q4": 0,
        "unpack_gather_dequantize_q4": 0, "group_norms_sq": 0,
        "ssd_chunk_scan": 0}


# ---------------------------------------------------------------------------
# the gather kernel's layouts and the squared group norms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,ax,lead,stack", [
    ((2, 3, 5, 16), 3, 1, 1),      # stacked rule, minor axis (Q = 1)
    ((2, 3, 16, 5), 2, 1, 1),      # stacked rule, inner axis (Q = 5)
    ((4, 3, 3, 8, 12), 3, 1, 0),   # conv input channels (Q = 12)
    ((7, 10), 1, 0, 0)])           # the (R, C) gather of the TPU kernel
def test_gather_axis_equals_take_along_axis(shape, ax, lead, stack):
    rng = np.random.default_rng(4)
    x = np.asarray(rng.standard_normal(shape), np.float32)
    sdims = shape[lead:lead + stack]
    B = shape[ax] // 2 + 1
    idx = np.stack([rng.choice(shape[ax], B, replace=False)
                    for _ in range(int(np.prod(sdims)))]).reshape(sdims + (B,))
    bshape = [1] * len(shape)
    bshape[lead:lead + stack] = sdims
    bshape[ax] = B
    want = np.take_along_axis(x, idx.reshape(bshape), axis=ax)
    got = ops.gather_axis(torch.from_numpy(x), torch.from_numpy(idx), ax,
                          lead)
    np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.parametrize("shape", [(1, 1, 1), (4, 8, 1), (3, 16, 9),
                                   (2, 5, 600), (4, 64, 72)])
def test_group_norms_sq_equals_reference(shape):
    x = _quant_input(shape, 3)
    want = jops.group_norms_sq(jnp.asarray(x))
    got = ops.group_norms_sq(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("ax", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norms_sq_reads_moved_views(ax, dtype):
    """A stacked HWIO weight moved to (G, C, ...) by a view, as the mask
    scores move it: every channel axis, without a contiguous copy on the
    port's side."""
    w = np.asarray(np.random.default_rng(ax).standard_normal(
        (4, 3, 3, 16, 24)), np.float32)
    jw = jnp.moveaxis(jnp.asarray(w, jnp.dtype(dtype)), ax, 1)
    want = jops.group_norms_sq(jw.reshape(4, jw.shape[1], -1))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    got = ops.group_norms_sq(torch.movedim(tw, ax, 1))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5)


def test_group_scores_resnet18_full_match_reference():
    """The dynamic round's mask scores over the full-width ResNet-18 (two
    consensus groups): every rule, rtol 1e-5."""
    from repro.core import sparsity as jsp
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.core import sparsity as tsp
    from repro_torch.models import build as t_build

    tb = t_build(t_get_config("resnet18"))
    rng = np.random.default_rng(5)
    p = {k: np.asarray(rng.standard_normal((2,) + tuple(s)), np.float32)
         for k, s in tb.shapes.items()}
    jp = {}
    for k, v in p.items():
        *parents, leaf = k.split("/")
        node = jp
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for rule in tb.plan.rules:
        np.testing.assert_allclose(
            to_np(tsp.group_scores(tp, rule, offset=1)),
            np.asarray(jsp.group_scores(jp, rule, offset=1)), rtol=1e-5,
            err_msg=rule.name)


# ---------------------------------------------------------------------------
# the launch plans of the group-norm and quantize kernels (plain functions
# of shapes, strides and addresses; the kernels themselves run on the card)
# ---------------------------------------------------------------------------


def _score_views(arch, lead, monkeypatch):
    """(shape, strides) of every view one dynamic round's mask scores hand
    the group-norm kernel wrapper (``core.sparsity.group_scores`` at
    ``lead`` nodes), read off meta tensors: ResNet-18 at full width, or
    phase 6d's Mamba2-780M (4 layers)."""
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.core import sparsity as tsp
    from repro_torch.kernels import group_norms as tgn
    from repro_torch.models import build as t_build
    cfg = t_get_config(arch)
    if arch == "mamba2-780m":
        cfg = cfg.replace(n_layers=4)
    b = t_build(cfg)
    payload = {k: torch.empty((lead,) + tuple(s), device="meta")
               for k, s in b.shapes.items()}
    seen = []

    def record(v):
        seen.append((tuple(v.shape), tuple(v.stride())))
        return torch.zeros(tuple(v.shape[:2]), device="meta")
    monkeypatch.setattr(tgn, "group_norms_sq", record)
    for rule in b.plan.rules:
        tsp.group_scores(payload, rule, offset=1)
    return seen


def _four_d(shape, strides):
    if len(shape) == 3:
        return shape[:2] + (1,) + shape[2:], strides[:2] + (0,) + strides[2:]
    return shape, strides


def _check_norms_plan(shape, strides, elem, ptr):
    """A plan's slices read every fan-in position exactly once, slice after
    slice in the walked dim; its blocks cover every output; it takes
    16-byte vectors only where they are aligned."""
    from repro_torch.kernels import group_norms as tgn
    shape, strides = _four_d(tuple(shape), tuple(strides))
    p = tgn.plan(shape, strides, elem, ptr)
    G, C, K1, K2 = shape
    want = sorted(a * strides[2] + b * strides[3]
                  for a in range(K1) for b in range(K2))
    reads = tgn.slice_reads(p)
    assert len(reads) == p.slices
    assert sorted(o for sl in reads for _, o in sl) == want
    assert p.slices == 1 or p.blocks < tgn.TARGET_BLOCKS
    walked = [[w for w, _ in sl] for sl in reads if sl]
    for a, b in zip(walked, walked[1:]):
        assert max(a) < min(b)
    if p.layout == 1:
        assert strides[1] == 1 and p.group == p.tx * p.vec
        assert p.blocks * p.group >= G * C and p.tx * p.ty <= tgn.THREADS
    else:
        assert p.blocks * (tgn.THREADS // p.group) >= G * C
        assert p.tx * p.ty <= p.group and p.group % 32 == 0
    if p.vec > 1:
        assert p.vec * elem == 16 and ptr % 16 == 0
        other = ((G, strides[0]), (p.rows, p.rs)) + (
            ((p.cols, p.cs),) if p.layout == 1 else ((C, strides[1]),))
        assert all(s % p.vec == 0 for n, s in other if n > 1)
        if p.layout == 1:      # vectors of channels
            assert C % p.vec == 0
        else:                  # vectors along the contiguous fan-in dim
            assert p.cs == 1 and p.cols * p.vec in (K1, K2)
    return p


@pytest.mark.parametrize("arch,lead", [("resnet18", 4),
                                       ("mamba2-780m", 2)])
@pytest.mark.parametrize("elem,ptr", [(4, 0), (4, 4), (2, 0), (2, 2)])
def test_group_norms_plan_covers_score_views(arch, lead, elem, ptr,
                                             monkeypatch):
    """Every score view of a dynamic round (ResNet-18's 40, phase 6d's
    Mamba2 9), aligned and 4 (f32) or 2 (bf16) bytes off alignment."""
    views = _score_views(arch, lead, monkeypatch)
    assert len(views) == {"resnet18": 40, "mamba2-780m": 9}[arch]
    plans = [_check_norms_plan(s, st, elem, ptr) for s, st in views]
    if ptr % 16:
        assert all(p.vec == 1 for p in plans)
    else:
        assert any(p.vec > 1 for p in plans)


@pytest.mark.parametrize("shape,strides", [
    ((2, 5, 98301), (491505, 98301, 1)),          # prime K, column walk
    ((2, 3, 1531, 20), (91860, 20, 60, 1)),       # prime rows, row walk
    ((2, 30, 3001), (90030, 1, 30)),              # C minor, C = 30
    ((2, 64, 7, 3), (2240, 1, 320, 64)),          # C minor, two fan-in dims
    ((4, 64, 9, 96), (55296, 96, 6144, 1)),       # K minor, two dims
    ((2, 6, 1536, 64), (589824, 64, 384, 1)),     # Mamba2-like
    ((4, 1, 5000), (5000, 5000, 1)),              # one channel
    ((4, 96, 1), (96, 1, 1)),                     # K = 1
    ((3, 7, 0), (0, 0, 1)),                       # empty fan-in
    ((2, 9, 11, 13), (1287, 1, 117, 9)),          # C minor, odd everything
    ((2, 4, 6, 10), (240, 60, 1, 6)),             # K1 contiguous
    ((5, 3, 1000), (6000, 2000, 2)),              # no contiguous axis
])
@pytest.mark.parametrize("elem", [4, 2])
def test_group_norms_plan_covers_odd_fan_ins(shape, strides, elem):
    _check_norms_plan(shape, strides, elem, 0)
    _check_norms_plan(shape, strides, elem, 16 - elem)


@pytest.mark.parametrize("C", [1, 3, 10, 24, 31, 32, 33, 64, 127, 128, 256,
                               512, 1536, 1537, 2048, 4096, 6144, 6145])
@pytest.mark.parametrize("R", [1, 97, 213450])
@pytest.mark.parametrize("ptr", [0, 4, 16])
def test_quantize_plan_covers_rows(C, R, ptr):
    """quantize_rows's plan: a power of two of lanes up to 256; 16-byte
    vectors only where C % 4 == 0 and the base is aligned; the registers
    held cover the row (one vector a lane for a small view, where that
    fits), or rows past 6 vectors a lane at 256 lanes stream."""
    lanes, nv, vec = wire.quantize_plan(R, C, ptr)
    assert lanes in (1, 2, 4, 8, 16, 32, 64, 128, 256)
    assert vec == (4 if C % 4 == 0 and ptr % 16 == 0 else 1)
    nvec = C // vec
    if nv:
        assert nv in wire.QUANT_NV and lanes * nv * vec >= C
        per_max = 1 if R * nvec < wire.QUANT_SMALL else wire.QUANT_NV[-1]
        if nvec <= 256 * per_max:     # the fewest lanes that hold the row
            assert lanes * per_max >= nvec
            assert lanes == 1 or lanes // 2 * per_max < nvec
        else:
            assert lanes == 256
    else:
        assert lanes == 32 and nvec > 256 * wire.QUANT_NV[-1]


# ---------------------------------------------------------------------------
# the fused q8 encode's plan (wire.gather_quantize_plan)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ptr", [0, 4])
def test_gather_quantize_plan_covers_codec_operands(ptr):
    """ResNet-18's 60 encode_compact operands at 4 members, whose rules
    keep whole groups of 8: every row in registers, vectors of four, read
    as 16-byte runs at an aligned base and column by column at a base 4
    bytes off."""
    views = codec_views("resnet18", 4)
    assert len(views) == 60
    for _, R, C, B, rule in views:
        assert rule.group_size == 8
        lanes, nv, vec, runs = check_encode_plan(
            wire.gather_quantize_plan, R, B, C, ptr, q4=False)
        assert nv > 0 and vec == 4 and runs == (ptr == 0)


@pytest.mark.parametrize("R,B,C,ptr", [
    (1, 256, 512, 0),         # one row
    (97, 10, 33, 0),          # B % 4 != 0: single columns
    (97, 12, 33, 0),          # C % 4 != 0: no 16-byte runs
    (5, 6144, 12288, 0),      # the widest row held in registers
    (5, 8192, 16384, 0),      # too wide: streams
    (3, 6146, 12288, 4),      # too wide for single columns
    (18432, 256, 512, 16),    # ResNet's largest leaf
    (213450, 1536, 3072, 0),  # a Mamba2-wide view
])
def test_gather_quantize_plan_edges(R, B, C, ptr):
    check_encode_plan(wire.gather_quantize_plan, R, B, C, ptr, q4=False)


@pytest.mark.parametrize("kind", ["groups", "off4", "unsorted"])
@pytest.mark.parametrize("R,C,B", [(6, 64, 32), (3, 128, 40)])
def test_gather_quantize_equals_jitted_reference(kind, R, C, B):
    """vs the jitted JAX shim with the eager reference's division (fault
    B): q exact, scales to one ulp."""
    x = np.asarray(np.random.default_rng(R + C).standard_normal((R, C)) * 3,
                   np.float32)
    idx = kept_index(kind, C, B, 5).astype(np.int32)
    with jax_reference(ieee_quantize=True):
        jq, js = jax.jit(jops.gather_quantize)(jnp.asarray(x),
                                               jnp.asarray(idx))
    tq, ts = ops.gather_quantize(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(to_np(tq), np.asarray(jq))
    js, ts = np.asarray(js), to_np(ts)
    assert ts.shape == js.shape
    assert np.all(np.abs(ts - js) <= np.spacing(np.abs(js)))


# ---------------------------------------------------------------------------
# the q8 decode's plan (wire.gather_dequantize_plan) and its index domain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ptr", [0, 4])
@pytest.mark.parametrize("optr", [0, 4])
def test_gather_dequantize_plan_covers_codec_operands(ptr, optr):
    """The decodes of ResNet-18's 60 encode_compact operands at 4 members
    (q (R, B) expanded to C columns, the codec API's decode_expand): every
    row in registers; float4 stores and 4-byte runs of q (q 4 bytes off
    alignment still reads them), single columns where the output is 4
    bytes off."""
    views = codec_views("resnet18", 4)
    assert len(views) == 60
    for _, R, C, B, _ in views:
        lanes, nv, vec, runs, unit = check_decode_plan(
            wire.gather_dequantize_plan, R, C, B, ptr, optr, q4=False)
        assert nv > 0 and vec == (4 if optr == 0 else 1)
        assert unit == (16 if ptr == 0 else 4) and runs == (optr == 0)


@pytest.mark.parametrize("R,Cout,Cq,ptr,optr,index", [
    (1, 512, 256, 0, 0, True),        # one row
    (97, 33, 33, 0, 0, True),         # Cout % 4 != 0: single columns
    (97, 1, 1, 0, 0, True),           # Cout = 1
    (97, 12, 33, 0, 0, True),         # q wider than out: read in place
    (97, 12, 30, 0, 0, True),         # the same, Cq % 4 != 0: no runs
    (97, 12, 32, 2, 0, True),         # q 2 bytes off, in place: no runs
    (97, 64, 30, 0, 0, True),         # Cq % 4 != 0: in place, no runs
    (97, 64, 32, 4, 0, True),         # staged by words, runs
    (97, 64, 32, 0, 0, True),         # staged by 16-byte units, runs
    (97, 64, 64, 0, 0, False),        # the identity: nothing staged
    (97, 64, 64, 2, 0, False),        # the identity 2 bytes off: no runs
    (5, 6144, 3072, 0, 0, True),      # the widest row held in registers
    (5, 8192, 4096, 0, 0, True),      # too wide: streams, nothing staged
    (3, 1537, 1537, 0, 0, True),      # too wide for single columns
    (18432, 512, 256, 0, 0, True),    # ResNet's largest leaf
])
def test_gather_dequantize_plan_edges(R, Cout, Cq, ptr, optr, index):
    check_decode_plan(wire.gather_dequantize_plan, R, Cout, Cq, ptr, optr,
                      q4=False, index=index)


@pytest.mark.parametrize("kind", ["groups", "off4", "cols"])
@pytest.mark.parametrize("R,C,B", [(6, 64, 32), (3, 40, 12), (1, 9, 1)])
def test_gather_dequantize_zero_index_equals_padded_pallas(kind, R, C, B):
    """The decode's extended index (column B of an (R, B) q reading as a
    zero column) against the TPU kernel in interpret mode on q padded by
    that zero column, the JAX contract: bit-equal, NaN on a row whose
    scale is NaN."""
    from repro.kernels import wire as jwire
    rng = np.random.default_rng(R + C + B)
    q = rng.integers(-127, 128, (R, B)).astype(np.int8)
    s = np.abs(rng.standard_normal((R, 1))).astype(np.float32)
    s[0, 0] = np.nan
    idx = kept_index(kind, C, B, 3, g=min(8, B)) if kind != "cols" else \
        np.sort(rng.choice(C, B, replace=False))
    inv = ops._ref.inverse_index(torch.from_numpy(idx), C)
    got = wire.gather_dequantize(torch.from_numpy(q), torch.from_numpy(s),
                                 inv)
    want = jwire.gather_dequantize(jnp.pad(jnp.asarray(q), ((0, 0), (0, 1))),
                                   jnp.asarray(s), jnp.asarray(to_np(inv)),
                                   interpret=True)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert np.isnan(to_np(got)[0]).all()


def test_q8_decode_shims_pass_the_payload_itself(monkeypatch):
    """The zero-fill shim hands the decode q itself (no padded copy) and
    an inverse index whose dropped columns hold B; the plain decode hands
    it no index."""
    seen = []
    monkeypatch.setattr(wire, "gather_dequantize",
                        lambda q, s, idx: seen.append((q, idx)) or
                        torch.zeros(q.shape[0], idx.shape[0]))
    monkeypatch.setattr(wire, "dequantize_rows",
                        lambda q, s: seen.append((q, None)) or
                        torch.zeros(q.shape))
    q = torch.ones(3, 4, dtype=torch.int8)
    idx = torch.tensor([1, 4, 5, 7])
    ops.scatter_dequantize(q, torch.ones(3, 1), idx, 9)
    ops.dequantize_rows(q, torch.ones(3, 1))
    (q1, inv), (q2, none) = seen
    assert q1.shape == (3, 4) and q1.data_ptr() == q.data_ptr()
    assert inv.dtype == torch.int32
    assert inv.tolist() == [4, 0, 4, 4, 1, 2, 4, 3, 4]
    assert q2.shape == (3, 4) and none is None


# ---------------------------------------------------------------------------
# the gather kernel's table of leaves (kernels/compact.py: plan, tables,
# walk), checked at the full-width models' payload shapes without a tensor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [(1, 4097), (65530, 65541),
                                   ((1 << 20) - 3, (1 << 20) + 3),
                                   ((1 << 31) - 5, 1 << 31)])
def test_fastdiv_divides_like_integer_division(lo, hi):
    """The kernel's division by a constant, (umulhi(n, m) + n) >> s, is
    n // d for every divisor and for n at 0, around multiples of d and at
    the top of its range (n < 2^31)."""
    rng = np.random.default_rng(lo)
    for d in range(lo, hi):
        ms = compact.fastdiv(d)
        assert 0 < ms[0] < 1 << 32
        n = np.concatenate([[0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d,
                             (1 << 31) - 1, (1 << 31) - d],
                            rng.integers(0, 1 << 31, 16)])
        n = n[(n >= 0) & (n < 1 << 31)]
        np.testing.assert_array_equal(compact.fdiv(n, ms), n // d)


def _payload_gathers(arch, lead, monkeypatch):
    """[(R, C, Q, S, B, P, g)] of every leaf the gather kernel takes in one
    dynamic round of the arch's main path (chip_smoke.py phases 3 and 6a:
    the compaction of a (lead, ...) payload by every rule, then its
    expansion), recorded from ``compact.gather_table`` on meta tensors:
    shapes only.  Returns (launches as lists of those tuples)."""
    from repro_torch.configs import get_config
    from repro_torch.core import shrinkage
    from repro_torch.models import build
    cfg = get_config(arch)
    if arch == "mamba2-780m":
        cfg = cfg.replace(n_layers=4, param_dtype="float32")
    b = build(cfg)
    meta = torch.device("meta")
    calls = []

    def record(jobs):
        jobs = list(jobs)
        calls.append([(x.shape[0], x.shape[1],
                       x.shape[2] if x.ndim == 3 else 1,
                       i.shape[0] if i.ndim == 2 else 1, i.shape[-1] * g,
                       p, g) for x, i, p, g in jobs])
        return [torch.empty((x.shape[0], i.shape[-1] * g) + x.shape[2:],
                            device=meta) for x, i, p, g in jobs]

    monkeypatch.setattr(compact, "gather_table", record)
    p = {k: torch.empty((lead,) + tuple(s), device=meta)
         for k, s in b.shapes.items()}
    idxs = {}
    for r in b.plan.rules:
        stack = tuple(b.shapes[r.leaves[0].key][:r.stack_ndims])
        idxs[r.name] = torch.zeros(stack + (r.keep,), dtype=torch.int64,
                                   device=meta)
    c = shrinkage.compact_params(p, b.plan, idxs, offset=1)
    shrinkage.expand_params(c, b.plan, idxs,
                            {r.name: r.groups for r in b.plan.rules},
                            offset=1)
    return calls


FULL_WALK = 1 << 21   # leaves of at most this many units are walked whole


@pytest.mark.parametrize("arch,lead,rules", [("resnet18", 4, 8),
                                             ("mamba2-780m", 2, 1)])
@pytest.mark.parametrize("elem,ptrs", [(4, (0, 0)), (4, (4, 0)),
                                       (2, (0, 2)), (1, (0, 0))])
def test_gather_table_covers_payload_rules(arch, lead, rules, elem, ptrs,
                                           monkeypatch):
    """Every rule's compaction and expansion at the full-width payload
    shapes is one launch (a table of at most CAPACITY leaves); in each,
    the block -> (leaf, tile) search and the threads' walk write every
    output unit of every leaf exactly once, each from the input unit the
    gather names (zeros for the index C/g); the unit is the widest that
    the run of g·Q·elem bytes and both bases allow (16 bytes at every
    aligned f32 ResNet leaf: whole groups of 8 channels)."""
    calls = _payload_gathers(arch, lead, monkeypatch)
    assert len(calls) == 2 * rules
    rng = np.random.default_rng(7)
    for jobs in calls:
        plans = [compact.plan(R, C, Q, S, B, P, g, elem, ptrs)
                 for R, C, Q, S, B, P, g in jobs]
        launches = compact.tables(plans)
        assert len(launches) == 1 and len(launches[0]) == len(jobs)
        firsts = [f for _, f in launches[0]]
        total = firsts[-1] + plans[-1].tiles
        owner = np.repeat(np.arange(len(plans)), [p.tiles for p in plans])
        assert len(owner) == total      # each block one tile of one leaf
        for blk in range(0, total, max(1, total // 4096)):
            assert compact.leaf_of(blk, firsts) == owner[blk]
        for blk in (*firsts, *(f - 1 for f in firsts[1:]), total - 1):
            assert compact.leaf_of(blk, firsts) == owner[blk]
        for p, (R, C, Q, S, B, P, g) in zip(plans, jobs):
            run = g * Q * elem
            assert run % p.unit == 0 and all(a % p.unit == 0 for a in ptrs)
            assert p.unit == 16 or run % (2 * p.unit) \
                or any(a % (2 * p.unit) for a in ptrs)
            if arch == "resnet18" and elem == 4 and ptrs == (0, 0):
                assert g == 8 and p.unit == 16
            idx = rng.integers(0, p.Cg + 1, (p.S, p.Bg))
            if elem == 4 and ptrs == (0, 0) and p.units <= FULL_WALK:
                tiles = np.arange(p.tiles)      # every tile of the leaf
            else:                               # its ends and a sample
                tiles = np.unique(np.concatenate([
                    [0, p.tiles - 1], rng.integers(0, p.tiles, 4)]))
            u, src = compact.walk(p, tiles, idx)
            want = tiles[:, None] * compact.TILE + np.arange(compact.TILE)
            np.testing.assert_array_equal(u, want[want < p.units])
            if len(tiles) == p.tiles:
                assert len(u) == p.units    # each unit once, all of them
            q, l = np.divmod(u, p.L)
            r, j = np.divmod(q, p.Bg)
            c = idx[(r // p.P) % p.S, j]
            np.testing.assert_array_equal(
                src, np.where(c < p.Cg, (r * p.Cg + c) * p.L + l, -1))


def test_gather_tables_split_at_capacity():
    """More leaves than a launch holds go to further launches, in order,
    each numbering its blocks from 0; leaves without output are left
    out."""
    plans = [compact.plan(3 + i % 5, 16, 1 + i % 3, 1, 8, 1, 8 if i % 2
                          else 1, 4, (0, 0)) for i in range(70)]
    plans[5] = compact.plan(0, 16, 4, 1, 8, 1, 1, 4, (0, 0))
    launches = compact.tables(plans)
    assert [len(t) for t in launches] == [compact.CAPACITY] * 2 + [5]
    assert [i for t in launches for i, _ in t] == \
        [i for i in range(70) if i != 5]
    for t in launches:
        assert t[0][1] == 0
        for (i, f), (_, nxt) in zip(t, t[1:]):
            assert nxt == f + plans[i].tiles


@pytest.mark.parametrize("run,ptrs,unit", [
    (32, (0, 0), 16), (32, (4, 0), 4), (32, (0, 8), 8), (256, (0, 0), 16),
    (4, (0, 0), 4), (12, (0, 0), 4), (6, (0, 0), 2), (3, (0, 0), 1),
    (40, (0, 0), 8), (32, (2, 0), 2), (64, (1, 0), 1)])
def test_gather_plan_unit_follows_alignment(run, ptrs, unit):
    p = compact.plan(5, 7, run, 1, 3, 1, 1, 1, ptrs)
    assert p.unit == unit and p.L == run // unit
    assert p.units == 5 * 3 * p.L and p.tiles == -(-p.units // compact.TILE)
