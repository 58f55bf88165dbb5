"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card.  Every case carries the ``cuda`` marker and skips
where there is no card; the file imports no JAX, so it also runs on a
machine with a card and PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import compact  # noqa: E402
from repro_torch.kernels import fused_prox_sgd as tfp  # noqa: E402
from repro_torch.kernels import group_norms  # noqa: E402
from repro_torch.kernels import ops, ref, ssd_scan, wire  # noqa: E402

from torch_encode_cases import codec_views, kept_index  # noqa: E402

pytestmark = pytest.mark.cuda

PROX_SHAPES = [(16, 3, 3, 64, 64), (16, 512, 10), (16, 10), (16, 3, 3, 3, 63),
               (16,), (4, 3, 8, 16)]
QUANT_SHAPES = [(1, 1), (1, 7), (3, 1), (5, 33), (16, 128), (7, 257),
                (64, 10), (4 * 2304, 128), (3, 4096)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(shape, seed, dev, scale=1.0):
    rng = np.random.default_rng(seed)
    x = np.asarray(rng.standard_normal(shape) * scale, np.float32)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("shape", PROX_SHAPES)
def test_prox_dyn_kernel_equals_plain(shape, dev):
    xs = [_randn(shape, i, dev) for i in range(5)]
    rho = torch.full((1,) * len(shape), 1e-3, device=dev)
    ops.reset_launch_counts()
    t, m = ops.prox_sgd_update(*xs, rho, 1e-2)
    assert ops.launch_counts()["fused_prox_sgd_dyn"] == 1
    tp, mp = ref.fused_prox_sgd_ref(*xs, eta=torch.tensor(1e-2, device=dev),
                                    rho=rho, momentum=0.9)
    torch.cuda.synchronize()
    assert torch.equal(t, tp) and torch.equal(m, mp)


def test_prox_dyn_kernel_per_row_rho_equals_plain(dev):
    shape = (4, 3, 8, 16)
    xs = [_randn(shape, i, dev) for i in range(5)]
    rho = _randn((1, 3, 1, 1), 9, dev).abs() + 0.1    # one value per row
    t, m = ops.prox_sgd_update(*xs, rho, 3e-3)
    tp, mp = ref.fused_prox_sgd_ref(*xs, eta=torch.tensor(3e-3, device=dev),
                                    rho=rho, momentum=0.9)
    torch.cuda.synchronize()
    assert torch.equal(t, tp) and torch.equal(m, mp)


@pytest.mark.parametrize("shape", [(4, 128), (6, 128, 256), (7,)])
def test_prox_scalar_kernel_equals_plain(shape, dev):
    xs = [_randn(shape, i, dev) for i in range(5)]
    ops.reset_launch_counts()
    t, m = ops.fused_prox_sgd(*xs, eta=1e-2, rho=1e-3, momentum=0.9)
    assert ops.launch_counts()["fused_prox_sgd"] == 1
    tp, mp = ref.fused_prox_sgd_ref(*xs, eta=1e-2, rho=1e-3, momentum=0.9)
    torch.cuda.synchronize()
    assert torch.equal(t, tp) and torch.equal(m, mp)


@pytest.mark.parametrize("shape", QUANT_SHAPES)
@pytest.mark.parametrize("levels", [127, 7])
def test_quantize_kernel_equals_plain(shape, levels, dev):
    for seed in range(3):
        x = _randn(shape, seed, dev, scale=10.0 ** (seed * 2 - 2))
        q, s = wire.quantize_rows(x, levels=levels)
        qp, sp = ref.quantize_rows_ref(x, levels)
        torch.cuda.synchronize()
        assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("C", [1, 33, 257])
def test_quantize_kernel_nonfinite_row_equals_plain(value, C, dev):
    """A row holding NaN or inf: the kernel keeps the plain version's NaN
    or inf scale and its zeros where the quotient is NaN."""
    x = _randn((4, C), 3, dev)
    x[1, 0] = x[1, C // 2] = float(value)
    q, s = wire.quantize_rows(x)
    qp, sp = ref.quantize_rows_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(q, qp)
    torch.testing.assert_close(s, sp, rtol=0, atol=0, equal_nan=True)
    assert not torch.isfinite(s[1, 0])


# quantize_rows's paths (wire.quantize_plan): 1 to 256 lanes a row, rows
# held in registers (one vector a lane for a small view, up to 6 for a
# large one) or streamed, 16-byte or scalar loads; Mamba2's payload rows
# are 1536 and 64 wide
PATH_WIDTHS = [1, 3, 10, 24, 31, 32, 33, 64, 127, 128, 1536, 1537, 4096]


@pytest.mark.parametrize("C", PATH_WIDTHS)
@pytest.mark.parametrize("R", [1, 97, 20011])
def test_quantize_kernel_paths_equal_plain(C, R, dev):
    x = _randn((R, C), C + R, dev, scale=0.05)
    ops.reset_launch_counts()
    q, s = wire.quantize_rows(x)
    assert ops.launch_counts()["quantize_rows"] == 1
    qp, sp = ref.quantize_rows_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("C", PATH_WIDTHS)
def test_quantize_kernel_unaligned_base_equals_plain(C, dev):
    """A view that starts at element 1 (4 bytes off 16-byte alignment)
    takes the scalar loads, bit-equal all the same."""
    R = 13
    x = _randn((R * C + 1,), C, dev)[1:].view(R, C)
    assert wire.quantize_plan(R, C, x.data_ptr())[2] == 1
    q, s = wire.quantize_rows(x)
    qp, sp = ref.quantize_rows_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("C", PATH_WIDTHS)
def test_quantize_kernel_nonfinite_rows_on_each_path(C, dev):
    """NaN, inf and -inf rows on each path keep the plain version's scale
    (NaN or inf) and its zeros where the quotient is NaN; the finite rows
    around them stay bit-equal."""
    x = _randn((6, C), 2 * C, dev)
    x[1, C // 2] = float("nan")
    x[2, 0] = float("inf")
    x[3, C - 1] = -float("inf")
    x[4, 0] = float("nan")
    x[4, C - 1] = float("inf")
    q, s = wire.quantize_rows(x)
    qp, sp = ref.quantize_rows_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(q, qp)
    torch.testing.assert_close(s, sp, rtol=0, atol=0, equal_nan=True)
    assert not torch.isfinite(s[1:5]).any()


# (R, C) views: odd C, one-element rows (1-D and 0-D leaves), R that no
# block of eight rows divides, and the widths of the compact payload
Q4_SHAPES = [(1, 1), (1, 7), (3, 1), (5, 33), (13, 10), (16, 128), (7, 257),
             (4 * 2304, 32), (4 * 1152, 64), (4 * 16, 10), (3, 4096)]


def _idx(C, B, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.sort(rng.choice(C, B, replace=False))).to(dev)


def _assert_q4_equal(p, s, pp, sp):
    torch.cuda.synchronize()
    assert p.dtype == torch.uint8 and p.shape == pp.shape
    assert torch.equal(p, pp)
    torch.testing.assert_close(s, sp, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("shape", Q4_SHAPES)
def test_quantize_pack_q4_kernel_equals_plain(shape, dev):
    for seed in range(3):
        x = _randn(shape, seed, dev, scale=10.0 ** (seed * 2 - 2))
        ops.reset_launch_counts()
        p, s = wire.quantize_pack_q4(x)
        assert ops.launch_counts()["quantize_pack_q4"] == 1
        _assert_q4_equal(p, s, *ref.quantize_pack_q4_ref(x))


@pytest.mark.parametrize("shape", [(), (7,), (16,), (4, 3, 3, 8, 10)])
def test_quantize_pack_q4_shim_any_rank_equals_plain(shape, dev):
    x = _randn(shape, 4, dev)
    p, s = ops.quantize_pack_q4(x)
    R, C = ops._rc(tuple(shape))
    pp, sp = ref.quantize_pack_q4_ref(x.reshape(R, C))
    _assert_q4_equal(p.reshape(R, -1), s.reshape(R, 1), pp, sp)


@pytest.mark.parametrize("shape", Q4_SHAPES)
def test_gather_quantize_q4_kernel_equals_plain(shape, dev):
    R, C = shape
    for B in sorted({1, max(C // 2, 1), C}):
        x = _randn(shape, B, dev)
        idx = _idx(C, B, R, dev)
        ops.reset_launch_counts()
        p, s = wire.gather_quantize_q4(x, idx)
        assert ops.launch_counts()["gather_quantize_q4"] == 1
        _assert_q4_equal(p, s, *ref.gather_quantize_q4_ref(x, idx))


@pytest.mark.parametrize("shape", Q4_SHAPES)
def test_unpack_gather_dequantize_q4_kernel_equals_plain(shape, dev):
    """Plain decode (idx = arange(C)) and the zero-fill expansion of a
    compact encode (inverse index into p padded by a zero byte)."""
    R, C = shape
    p, s = ref.quantize_pack_q4_ref(_randn(shape, 5, dev))
    ops.reset_launch_counts()
    out = wire.unpack_gather_dequantize_q4(p, s, torch.arange(C, device=dev))
    assert ops.launch_counts()["unpack_gather_dequantize_q4"] == 1
    plain = ref.unpack_gather_dequantize_q4_ref(p, s,
                                                torch.arange(C, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    B = max(C // 2, 1)
    idx = _idx(C, B, 6, dev)
    pc, sc = ref.gather_quantize_q4_ref(_randn(shape, 7, dev), idx)
    full = ops.scatter_dequantize_q4(pc, sc, idx, C)
    plain = ref.scatter_dequantize_q4_ref(pc, sc, idx, C)
    torch.cuda.synchronize()
    assert torch.equal(full, plain)
    dropped = torch.ones(C, dtype=torch.bool, device=dev)
    dropped[idx] = False
    assert torch.all(full[:, dropped] == 0)


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("C", [1, 10, 33, 257])
def test_q4_kernels_nonfinite_rows_equal_plain(value, C, dev):
    """A row holding NaN or inf: all three kernels keep the plain
    versions' values (NaN or inf scale, nibble 0 where the quotient is
    NaN, NaN products on decode)."""
    x = _randn((13, C), 8, dev)
    x[1, 0] = x[1, C // 2] = float(value)
    x[12, C - 1] = float(value)
    p, s = wire.quantize_pack_q4(x)
    _assert_q4_equal(p, s, *ref.quantize_pack_q4_ref(x))
    assert not torch.isfinite(s[1, 0])
    idx = _idx(C, max(C // 2, 1), 9, dev)
    _assert_q4_equal(*wire.gather_quantize_q4(x, idx),
                     *ref.gather_quantize_q4_ref(x, idx))
    ar = torch.arange(C, device=dev)
    torch.testing.assert_close(
        wire.unpack_gather_dequantize_q4(p, s, ar),
        ref.unpack_gather_dequantize_q4_ref(p, s, ar), rtol=0, atol=0,
        equal_nan=True)


def test_wrappers_refuse_bad_operands(dev):
    x = torch.ones(4, 8, device=dev)
    eta = torch.ones(1, 1, device=dev)
    with pytest.raises(TypeError):
        tfp.fused_prox_sgd_dyn(*[x.double()] * 5,
                               torch.ones(4, 1, device=dev,
                                          dtype=torch.float64),
                               eta, momentum=0.9)
    with pytest.raises(ValueError):      # a non-contiguous operand
        tfp.fused_prox_sgd_dyn(x, x, x, x, torch.ones(8, 4, device=dev).t(),
                               torch.ones(4, 1, device=dev), eta,
                               momentum=0.9)
    with pytest.raises(ValueError):
        wire.quantize_rows(torch.ones(8, 4, device=dev).t())
    with pytest.raises(ValueError):
        wire.quantize_rows(x, levels=200)
    with pytest.raises(ValueError):
        wire.quantize_pack_q4(x.double())
    with pytest.raises(ValueError):      # int32 indices
        wire.gather_quantize_q4(x, torch.arange(4, device=dev,
                                                dtype=torch.int32))
    with pytest.raises(ValueError):      # a scale of the wrong shape
        wire.unpack_gather_dequantize_q4(
            torch.zeros(4, 4, dtype=torch.uint8, device=dev),
            torch.ones(4, device=dev), torch.arange(8, device=dev))
    with pytest.raises(ValueError):      # int64 indices
        compact.gather_groups(x, torch.arange(4, device=dev))
    with pytest.raises(ValueError):      # a non-contiguous operand
        compact.gather_groups(torch.ones(8, 4, device=dev).t(),
                              torch.arange(4, device=dev,
                                           dtype=torch.int32))
    with pytest.raises(ValueError):      # float64
        compact.gather_groups(x.double(), torch.arange(
            4, device=dev, dtype=torch.int32))
    with pytest.raises(ValueError):      # int64 indices
        wire.gather_quantize(x, torch.arange(4, device=dev))
    with pytest.raises(ValueError):      # a float32 q
        wire.gather_dequantize(x, torch.ones(4, 1, device=dev),
                               torch.arange(4, device=dev,
                                            dtype=torch.int32))
    with pytest.raises(ValueError):      # float64, and a 2-D operand
        group_norms.group_norms_sq(torch.ones(2, 3, 4, device=dev,
                                              dtype=torch.float64))
    with pytest.raises(ValueError):
        group_norms.group_norms_sq(x)


# ---------------------------------------------------------------------------
# the gather, q8 gather and group-norm kernels
# ---------------------------------------------------------------------------

# (R, C, B): prime R, odd C, B = 1, a full-width conv leaf's rows
GATHER_CASES = [(7, 33, 12), (13, 10, 1), (1, 1, 1), (4 * 2304, 128, 64),
                (31, 257, 129)]


def _idx32(C, B, seed, dev):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(C, B, replace=False)).astype(np.int32)
    return torch.from_numpy(idx).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.uint8])
@pytest.mark.parametrize("R,C,B", GATHER_CASES)
def test_gather_groups_kernel_equals_plain(R, C, B, dtype, dev):
    x = (_randn((R, C), R, dev) * 40).to(dtype)
    idx = _idx32(C, B, B, dev)
    ops.reset_launch_counts()
    out = compact.gather_groups(x, idx)
    assert ops.launch_counts()["gather_groups"] == 1
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert torch.equal(out, ref.gather_groups_ref(x, idx))


@pytest.mark.parametrize("shape,ax,lead,S", [
    ((4, 3, 3, 64, 128), 3, 1, 1),    # conv input channels (Q = 128)
    ((2, 3, 5, 16), 3, 1, 3),         # stacked rule: one index row a slice
    ((2, 3, 16, 5), 2, 1, 3)])        # stacked, inner axis
def test_gather_groups_layouts_equal_plain(shape, ax, lead, S, dev):
    x = _randn(shape, 3, dev)
    B = shape[ax] // 2 + 1
    idx = torch.stack([_idx32(shape[ax], B, i, dev) for i in range(S)])
    if S == 1:
        idx = idx[0]
    else:
        idx = idx.reshape(shape[lead:lead + 1] + (B,))
    out = ops.gather_axis(x, idx, ax, lead)
    plain = ops.gather_axis(x.cpu(), idx.cpu(), ax, lead)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), plain)


# (g, Q, S, dtype, off): whole groups of 8 f32 channels (runs of 32·Q
# bytes, 16-byte units), g = 1 (4-byte runs at Q = 1), Q > 1, S > 1,
# bf16/int8/uint8 runs of 2, 3, 6 or 5 bytes, bases 1 to 4 elements off
# 16-byte alignment
TABLE_CASES = [
    (8, 1, 1, torch.float32, 0), (8, 5, 1, torch.float32, 0),
    (1, 1, 1, torch.float32, 0), (1, 64, 3, torch.float32, 0),
    (8, 1, 3, torch.float32, 1), (2, 3, 1, torch.float32, 1),
    (1, 1, 2, torch.bfloat16, 0), (3, 1, 1, torch.bfloat16, 1),
    (1, 3, 2, torch.int8, 0), (8, 1, 1, torch.int8, 3),
    (1, 5, 3, torch.uint8, 1), (4, 4, 2, torch.uint8, 0)]


def _offset(x, off):
    """A copy of ``x`` whose base lies ``off`` elements past an aligned
    one."""
    flat = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    y = flat[off:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("g,Q,S,dtype,off", TABLE_CASES)
def test_gather_table_paths_equal_plain(g, Q, S, dtype, off, dev):
    """A compaction by kept groups of g channels and the zero-fill
    expansion of its result by the inverse index (the index C/g read as
    zeros, no padded copy), one launch each, bit-equal to the plain
    version."""
    P, Cg, Bg = 3, 6, 4
    R = 2 * S * P
    x = _offset((_randn((R, Cg * g, Q), g + Q, dev) * 40).to(dtype), off)
    rng = np.random.default_rng(S + off)
    kept = np.stack([np.sort(rng.choice(Cg, Bg, replace=False))
                     for _ in range(S)]).astype(np.int32)
    idx = torch.from_numpy(kept).to(dev)
    inv = ref.inverse_index(idx, Cg)
    ops.reset_launch_counts()
    c, = compact.gather_table([(x, idx, P, g)])
    e, = compact.gather_table([(_offset(c, off), inv, P, g)])
    assert ops.launch_counts()["gather_groups"] == 2
    torch.cuda.synchronize()
    assert torch.equal(c, ref.gather_groups_ref(x, idx, P, g))
    assert torch.equal(e, ref.gather_groups_ref(c, inv, P, g))
    dropped = (inv == Bg).repeat_interleave(g, dim=1)    # (S, Cg * g)
    rows = e.reshape(R // (S * P), S, P, Cg * g, Q)
    assert torch.all(rows.permute(1, 3, 0, 2, 4)[dropped] == 0)


def test_gather_table_over_capacity_equals_plain(dev):
    """More leaves than one launch holds: the table splits into launches
    of CAPACITY leaves, every leaf bit-equal to the plain version."""
    jobs = []
    for i in range(compact.CAPACITY + 9):
        g, Q = (8, 1 + i % 4) if i % 2 else (1, 1 + i % 3)
        x = _randn((3 + i % 5, 4 * g, Q), i, dev)
        idx = torch.tensor([3, 0, 4][:1 + i % 3], dtype=torch.int32,
                           device=dev)
        jobs.append((x, idx, 1, g))
    ops.reset_launch_counts()
    outs = compact.gather_table(jobs)
    assert ops.launch_counts()["gather_groups"] == 2
    torch.cuda.synchronize()
    for (x, idx, p, g), out in zip(jobs, outs):
        assert torch.equal(out, ref.gather_groups_ref(x, idx, p, g))


@pytest.mark.parametrize("arch,lead", [("resnet18", 4), ("mamba2-780m", 2)])
def test_rule_gathers_equal_plain_at_full_width(arch, lead, dev,
                                                monkeypatch):
    """One dynamic round's compaction and expansion of a full-width
    payload (mamba2-780m at 4 layers), one launch a rule each way, equal
    to the plain version's on the same card, bit for bit."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.core import shrinkage
    from repro_torch.models import build
    cfg = get_config(arch)
    if arch == "mamba2-780m":
        cfg = cfg.replace(n_layers=4, param_dtype="float32")
    b = build(cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    p = {k: torch.randn((lead,) + tuple(s), generator=gen, device=dev)
         for k, s in b.shapes.items()}
    idxs = {}
    for r in b.plan.rules:
        stack = tuple(b.shapes[r.leaves[0].key][:r.stack_ndims])
        idxs[r.name] = torch.stack([torch.sort(torch.randperm(
            r.groups, generator=gen, device=dev)[:r.keep]).values
            for _ in range(math.prod(stack))]).reshape(stack + (r.keep,))
    fulls = {r.name: r.groups for r in b.plan.rules}
    ops.reset_launch_counts()
    c = shrinkage.compact_params(p, b.plan, idxs, offset=1)
    e = shrinkage.expand_params(c, b.plan, idxs, fulls, offset=1)
    assert ops.launch_counts()["gather_groups"] == 2 * len(b.plan.rules)
    monkeypatch.setattr(compact, "gather_table", lambda jobs: [
        ref.gather_groups_ref(x, i, sr, g) for x, i, sr, g in jobs])
    pc = shrinkage.compact_params(p, b.plan, idxs, offset=1)
    pe = shrinkage.expand_params(pc, b.plan, idxs, fulls, offset=1)
    torch.cuda.synchronize()
    for k in p:
        assert torch.equal(c[k], pc[k]) and torch.equal(e[k], pe[k]), k


def test_quantize_pack_q4_table_equals_plain(dev):
    """One launch encodes leaves of every kind: odd C, C = 1, pairs and
    quads of columns, rows with NaN and inf, a base 4 bytes off
    alignment, rows wide enough to stream; each bit-equal to the plain
    version of that leaf alone."""
    xs = [_randn(shape, i, dev, scale=10.0 ** (i % 5 - 2))
          for i, shape in enumerate([(1, 1), (3, 7), (5, 33), (13, 10),
                                     (16, 128), (7, 257), (4 * 2304, 32),
                                     (2, 6145), (3, 12288), (97, 64)])]
    bad = _randn((13, 10), 20, dev)
    bad[1, 3], bad[5, 0], bad[12, 9] = float("nan"), float("inf"), \
        -float("inf")
    xs += [bad, _offset(_randn((9, 16), 21, dev), 1),
           _offset(_randn((9, 33), 22, dev), 1)]
    ops.reset_launch_counts()
    outs = wire.quantize_pack_q4_table(xs)
    assert ops.launch_counts()["quantize_pack_q4"] == 1
    for x, (p, s) in zip(xs, outs):
        _assert_q4_equal(p, s, *ref.quantize_pack_q4_ref(x))


def test_quantize_pack_q4_table_resnet_payload_equals_plain(dev):
    """ResNet-18's 62 compact payload leaves at 4 members, as the q4 ring
    encodes them in phase 3b: one launch, each bit-equal to the plain
    version."""
    from repro_torch.configs import get_config
    from repro_torch.core.masks import MaskSyncConfig, budget
    from repro_torch.core.shrinkage import plan_payload_shapes
    from repro_torch.models import build
    b = build(get_config("resnet18"))
    budgets = {r.name: budget(r, MaskSyncConfig()) for r in b.plan.rules}
    shapes = plan_payload_shapes(b.shapes, b.plan, budgets).values()
    xs = [_randn((4,) + tuple(s), i, dev, 0.05) for i, s in enumerate(shapes)]
    ops.reset_launch_counts()
    outs = ops.quantize_pack_q4_leaves(xs)
    assert ops.launch_counts()["quantize_pack_q4"] == 1 and len(outs) == 62
    for x, (p, s) in zip(xs, outs):
        R, C = ops._rc(tuple(x.shape))
        _assert_q4_equal(p.reshape(R, -1), s.reshape(R, 1),
                         *ref.quantize_pack_q4_ref(x.reshape(R, C)))


@pytest.mark.parametrize("R,C,B", GATHER_CASES)
def test_q8_gather_kernels_equal_plain(R, C, B, dev):
    x = _randn((R, C), 5, dev, 0.05)
    idx = _idx32(C, B, 2, dev)
    q, s = wire.gather_quantize(x, idx)
    qp, sp = ref.gather_quantize_ref(x, idx)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    out = ops.scatter_dequantize(q, s, idx, C)
    assert torch.equal(out, ref.scatter_dequantize_ref(q, s, idx, C))
    ar = torch.arange(B, device=dev, dtype=torch.int32)
    assert torch.equal(wire.gather_dequantize(q, s, ar),
                       ref.gather_dequantize_ref(q, s, ar))
    torch.cuda.synchronize()


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("C", [1, 10, 33, 257])
def test_q8_gather_kernels_nonfinite_rows_equal_plain(value, C, dev):
    x = _randn((4, C), 6, dev)
    x[1, 0] = value
    idx = torch.arange(0, C, 2, device=dev, dtype=torch.int32)
    q, s = wire.gather_quantize(x, idx)
    qp, sp = ref.gather_quantize_ref(x, idx)
    assert torch.equal(q, qp)
    torch.testing.assert_close(s, sp, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(ops.scatter_dequantize(q, s, idx, C),
                               ref.scatter_dequantize_ref(q, s, idx, C),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("shape", [(1, 1, 1), (4, 8, 1), (4, 512, 10),
                                   (3, 16, 9), (2, 5, 4097)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norms_kernel_equals_plain(shape, dtype, dev):
    x = _randn(shape, 7, dev).to(dtype)
    ops.reset_launch_counts()
    out = group_norms.group_norms_sq(x)
    assert ops.launch_counts()["group_norms_sq"] == 1
    plain = ref.group_norms_sq_ref(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=0)
    assert torch.equal(out, group_norms.group_norms_sq(x))   # same bits


@pytest.mark.parametrize("ax", [1, 2, 3, 4])
def test_group_norms_kernel_reads_moved_views(ax, dev):
    """The mask scores' views of a stacked HWIO weight, every channel
    axis (C minor, K minor, K of two dims), and a transposed 3-D view."""
    w = _randn((4, 3, 3, 64, 96), ax, dev)
    v = torch.movedim(w, ax, 1)
    out = ops.group_norms_sq(v)
    plain = ref.group_norms_sq_ref(v.contiguous().reshape(4, v.shape[1], -1))
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=0)
    t = _randn((4, 300, 64), 9, dev).transpose(1, 2)      # (G, C, K), C minor
    torch.testing.assert_close(group_norms.group_norms_sq(t),
                               ref.group_norms_sq_ref(t), rtol=1e-5, atol=0)
    torch.cuda.synchronize()


# score-like views (base shape, view of the base): a Mamba2 head view at
# moved strides, fan-ins the slices do not divide, K = 1, one channel, C
# minor with one and two fan-in dims, K minor, bases 4 bytes off 16-byte
# alignment
NORM_VIEWS = {
    "mamba_like": ((2, 1536, 6, 64), lambda b: b.permute(0, 2, 1, 3)),
    "k_long_prime": ((2, 5, 98301), lambda b: b),
    "rows_prime": ((2, 1531, 3, 20), lambda b: b.permute(0, 2, 1, 3)),
    "k_one": ((4, 96, 1), lambda b: b),
    "one_channel": ((4, 1, 5000), lambda b: b),
    "c_minor": ((4, 4608, 512), lambda b: b.transpose(1, 2)),
    "c_minor_ragged": ((2, 3001, 30), lambda b: b.transpose(1, 2)),
    "c_minor_two_dim": ((2, 7, 5, 64),
                        lambda b: b[:, :, :3].permute(0, 3, 1, 2)),
    "k_minor_two_dim": ((4, 3, 3, 64, 96),
                        lambda b: torch.movedim(b, 3, 1).reshape(
                            4, 64, 9, 96)),
    "unaligned": ((2 * 5 * 4097 + 1,), lambda b: b[1:].view(2, 5, 4097)),
    "unaligned_c_minor": ((2 * 640 * 64 + 1,),
                          lambda b: b[1:].view(2, 640, 64).transpose(1, 2)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(NORM_VIEWS))
def test_group_norms_kernel_views_equal_plain(name, dtype, dev):
    """Every layout and path of group_norms.plan within rtol 1e-5 of the
    plain version, and the same bits on a second run (the slices' partials
    are added in slice order, with no float atomics)."""
    shape, view = NORM_VIEWS[name]
    v = view(_randn(shape, len(name), dev).to(dtype))
    ops.reset_launch_counts()
    out = group_norms.group_norms_sq(v)
    assert ops.launch_counts()["group_norms_sq"] == 1
    plain = ref.group_norms_sq_ref(v)
    again = group_norms.group_norms_sq(v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=0)
    assert torch.equal(out, again)


def test_smoke_rounds_are_bit_equal(dev):
    """Two resnet-smoke rounds from one seed on the card give the same
    bits (training on the card is deterministic), and one of them runs
    under ``torch.use_deterministic_algorithms``, which raises on any
    nondeterministic operation on the path."""
    from repro_torch.configs import (ConsensusSpec, HsadmmConfig,
                                     ShapeConfig, get_config)
    from repro_torch.data.pipeline import batches, superbatches
    from repro_torch.data.synthetic import make_stream
    from repro_torch.models import build
    from repro_torch.train.engine import Engine

    hp = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=2,
                      wire_inter="compact+q8")
    cfg = get_config("resnet18", smoke=True).replace(hsadmm=hp)
    shape = ShapeConfig("s", "train", 16, 16)
    runs = []
    for strict in (False, True):
        eng = Engine(build(cfg), shape, consensus=ConsensusSpec((2, 2), 1),
                     device=dev)
        sb = next(superbatches(batches(make_stream(cfg, shape, 4,
                                                   device=dev)), 2))
        st = eng.init_state_fn()(0)
        torch.use_deterministic_algorithms(strict)
        try:
            st, m = eng.round_step_fn(frozen=False)(
                st, sb, torch.tensor(1e-2, device=dev))
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        runs.append((st, m))
    (a, ma), (b, mb) = runs
    assert torch.equal(ma.losses, mb.losses)
    for key in a["theta"]:
        assert torch.equal(a["theta"][key], b["theta"][key]), key
        assert torch.equal(a["z"][0][key], b["z"][0][key]), key
    for rule in a["masks"]:
        assert torch.equal(a["masks"][rule]["idx"], b["masks"][rule]["idx"])


# (Bt, T, H, P, N, chunk): chip_smoke.py phase 6a's shape, Q not dividing T
# (T 1000: Q 250, not a multiple of the kernel's 64-row tile), H not a
# multiple of the TPU kernel's head block with Bt = 1, Q = 64, the tiny
# shapes of tests/test_kernels.py, and the edges of the kernel's tiling:
# H 7 (not a multiple of its head pair) with P 24 and N 40 (not multiples
# of its 8 x 8 register tile) and Q 150 (three row tiles, the last
# partial), P 6 and N 10 (rows moved 4 bytes at a time), P 80 (two tiles
# of 64 p)
SSD_CASES = [(4, 4096, 48, 64, 128, 256), (1, 1000, 5, 64, 128, 256),
             (2, 200, 48, 64, 128, 64), (2, 64, 8, 16, 16, 16),
             (2, 48, 4, 8, 8, 8), (1, 300, 7, 24, 40, 150),
             (2, 60, 3, 6, 10, 20), (1, 256, 3, 80, 36, 128)]


def _ssd_operands(Bt, T, H, P, N, dtype, dev, dt_shift=-3.0, seed=0):
    x = _randn((Bt, T, H, P), seed, dev, 0.5).to(dtype)
    dt = torch.nn.functional.softplus(_randn((Bt, T, H), seed + 1, dev)
                                      + dt_shift)
    A = -torch.exp(_randn((Bt, H), seed + 2, dev, 0.3))
    Bm = _randn((Bt, T, N), seed + 3, dev).to(dtype)
    Cm = _randn((Bt, T, N), seed + 4, dev).to(dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,T,H,P,N,chunk", SSD_CASES)
def test_ssd_chunk_scan_kernel_equals_plain(Bt, T, H, P, N, chunk, dtype,
                                            dev):
    """Within tests/test_kernels.py's rtol = atol = 2e-4 of the plain
    version, and the same bits on a second launch."""
    a = _ssd_operands(Bt, T, H, P, N, dtype, dev)
    ops.reset_launch_counts()
    y, h = ssd_scan.ssd_chunk_scan(*a, chunk=chunk)
    y2, h2 = ssd_scan.ssd_chunk_scan(*a, chunk=chunk)
    assert ops.launch_counts()["ssd_chunk_scan"] == 2
    yr, hr = ref.ssd_chunk_scan_ref(*a, chunk)
    torch.cuda.synchronize()
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr.float(), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, hr, rtol=2e-4, atol=2e-4)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,T,H,P,N,chunk", SSD_CASES)
def test_ssd_chunk_scan_kernel_bit_equals_plain(Bt, T, H, P, N, chunk, dtype,
                                                dev):
    """y and h bit for bit the plain version's: both sum every product in
    step order with fused multiply-adds from 0 and form every factor by
    the same expression (csrc/ssd_scan.cu says how)."""
    a = _ssd_operands(Bt, T, H, P, N, dtype, dev, seed=7)
    y, h = ssd_scan.ssd_chunk_scan(*a, chunk=chunk)
    yr, hr = ref.ssd_chunk_scan_ref(*a, chunk)
    torch.cuda.synchronize()
    assert torch.equal(y, yr) and torch.equal(h, hr)


def test_ssd_chunk_scan_kernel_past_exp_range_is_finite(dev):
    """Chunks whose sum of dt*|A| passes 88: the terms above the diagonal
    are skipped, never exp'd, so the output is finite and equals the
    plain version."""
    a = _ssd_operands(2, 512, 4, 64, 128, torch.float32, dev, dt_shift=3.0)
    y, h = ssd_scan.ssd_chunk_scan(*a, chunk=256)
    yr, hr = ref.ssd_chunk_scan_ref(*a, 256)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    torch.testing.assert_close(y, yr, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, hr, rtol=2e-4, atol=2e-4)


def test_ssd_chunk_scan_refuses_bad_operands(dev):
    x, dt, A, Bm, Cm = _ssd_operands(2, 64, 4, 8, 8, torch.float32, dev)
    for bad in ((x, dt, A[0], Bm, Cm), (x, dt.double(), A, Bm, Cm),
                (x, dt, A, Bm.bfloat16(), Cm),
                (x.transpose(1, 2), dt, A, Bm, Cm)):
        with pytest.raises(ValueError):
            ssd_scan.ssd_chunk_scan(*bad, chunk=16)


def test_mamba_smoke_rounds_are_bit_equal(dev):
    """Two mamba2 smoke rounds from one seed on the card (the scan kernel
    inside ``vmap(grad_and_value)``) give the same bits, one of them under
    ``torch.use_deterministic_algorithms``."""
    from repro_torch.configs import (ConsensusSpec, HsadmmConfig,
                                     ShapeConfig, get_config)
    from repro_torch.data.pipeline import batches, superbatches
    from repro_torch.data.synthetic import make_stream
    from repro_torch.models import build
    from repro_torch.train.engine import Engine

    hp = HsadmmConfig(local_steps=2, wire_inter="compact+q8")
    cfg = get_config("mamba2-780m", smoke=True).replace(hsadmm=hp)
    shape = ShapeConfig("s", "train", 64, 8)
    runs = []
    for strict in (False, True):
        eng = Engine(build(cfg), shape, consensus=ConsensusSpec((2, 2), 1),
                     device=dev)
        sb = next(superbatches(batches(make_stream(cfg, shape, 4,
                                                   device=dev)), 2))
        st = eng.init_state_fn()(0)
        ops.reset_launch_counts()
        torch.use_deterministic_algorithms(strict)
        try:
            st, m = eng.round_step_fn(frozen=False)(
                st, sb, torch.tensor(1e-3, device=dev))
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        assert ops.launch_counts()["ssd_chunk_scan"] == 2 * cfg.n_layers
        runs.append((st, m))
    (a, ma), (b, mb) = runs
    assert torch.isfinite(ma.losses).all()
    assert torch.equal(ma.losses, mb.losses)
    for key in a["theta"]:
        assert torch.equal(a["theta"][key], b["theta"][key]), key
        assert torch.equal(a["z"][0][key], b["z"][0][key]), key
    assert torch.equal(a["masks"]["ssm_heads"]["idx"],
                       b["masks"]["ssm_heads"]["idx"])


# ---------------------------------------------------------------------------
# the fused encodes on each path of their plans (wire.gather_quantize_plan,
# wire.gather_quantize_q4_plan): vectors of four kept columns read as one
# 16-byte run or column by column, single columns and pairs, rows held in
# registers or streamed
# ---------------------------------------------------------------------------


def _kept(kind, C, B, seed, dev, g=8):
    """``torch_encode_cases.kept_index`` on the card."""
    return torch.from_numpy(kept_index(kind, C, B, seed, g)).to(dev)


def _encodes_equal_plain(x, idx):
    """Both fused encodes of x[:, idx], one launch each, bit-equal to the
    plain versions."""
    i32 = idx.to(torch.int32)
    ops.reset_launch_counts()
    q, s = wire.gather_quantize(x, i32)
    p, s4 = wire.gather_quantize_q4(x, idx)
    counts = ops.launch_counts()
    assert counts["gather_quantize"] == 1 == counts["gather_quantize_q4"]
    qp, sp = ref.gather_quantize_ref(x, i32)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and torch.equal(q, qp)
    torch.testing.assert_close(s, sp, rtol=0, atol=0, equal_nan=True)
    _assert_q4_equal(p, s4, *ref.gather_quantize_q4_ref(x, idx))


ENCODE_PATHS = [   # (R, C, B, kept kind, base offset in floats)
    (37, 512, 256, "groups", 0),      # 16-byte runs, one vector a lane
    (4608, 512, 256, "groups", 0),    # 16-byte runs, 4 vectors a lane
    (37, 512, 256, "broken", 0),      # a run broken inside a vector
    (37, 512, 256, "off4", 0),        # runs off a multiple of 4
    (37, 512, 256, "cols", 0),        # vectors read column by column
    (97, 33, 10, "cols", 0),          # B % 4 != 0: single columns, pairs
    (97, 33, 9, "cols", 0),           # odd B: a pad nibble
    (13, 512, 256, "groups", 1),      # a base 4 bytes off: no runs
    (1, 512, 256, "groups", 0),       # one row
    (3, 2048, 1024, "groups", 0),     # 256 lanes a row
    (5, 12288, 6144, "groups", 0),    # the widest row staged
    (3, 16384, 8192, "groups", 0),    # streamed rows
    (3, 16384, 8190, "cols", 0),      # streamed single columns and pairs
]


@pytest.mark.parametrize("R,C,B,kind,off", ENCODE_PATHS)
def test_gather_encodes_plan_paths_equal_plain(R, C, B, kind, off, dev):
    x = _randn((R * C + off,), R + B, dev, 0.05)[off:].view(R, C)
    _encodes_equal_plain(x, _kept(kind, C, B, R, dev))


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("kind", ["groups", "cols"])
def test_gather_encodes_nonfinite_rows_equal_plain(value, kind, dev):
    """A kept NaN or inf gives the plain versions' NaN or inf scale and
    zeros where the quotient is NaN; one in a dropped column changes
    nothing."""
    x = _randn((13, 512), 4, dev)
    idx = _kept(kind, 512, 256, 3, dev)
    dropped = torch.ones(512, dtype=torch.bool, device=dev)
    dropped[idx] = False
    x[1, idx[5]] = x[12, idx[-1]] = float(value)
    x[4, dropped.nonzero()[0, 0]] = float(value)
    _encodes_equal_plain(x, idx)


def test_gather_encodes_codec_operands_equal_plain(dev):
    """ResNet-18's 60 encode_compact operands at 4 members (the codec
    API's), at kept sets of whole groups (the rules') and of single
    columns, bit-equal."""
    views = codec_views("resnet18", 4)
    assert len(views) == 60
    for n, (_, R, C, B, rule) in enumerate(views):
        x = _randn((R, C), n, dev, 0.05)
        for kind in ("groups", "cols"):
            _encodes_equal_plain(x, _kept(kind, C, B, n, dev,
                                          rule.group_size))


# ---------------------------------------------------------------------------
# the decodes on each path of their plans (wire.gather_dequantize_plan,
# wire.unpack_gather_dequantize_q4_plan): vectors of four columns read as
# one run or column by column, single columns, zero-index columns, the
# identity, rows held by the plan or streamed, a payload base off
# alignment
# ---------------------------------------------------------------------------


def _close(a, b):
    torch.cuda.synchronize()
    assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _decodes_equal_plain(x, idx, off=0):
    """Both decodes of the plain encodes of x[:, idx] (payload ``off``
    bytes past alignment), one launch a call, bit-equal to the plain
    versions: by the inverse index whose dropped columns read the zero
    index (the shims' operands), on the payload padded by a zero column
    (the TPU kernels'), through the zero-fill shims, without an index, by
    an arange (the payload rows staged) and by every third column (read
    in place)."""
    C, B = x.shape[1], idx.shape[0]
    q, s = ref.gather_quantize_ref(x, idx.to(torch.int32))
    p, s4 = ref.gather_quantize_q4_ref(x, idx)
    q, p = _offset(q, off), _offset(p, off)
    inv, inv4 = ref.inverse_index(idx, C), ref.inverse_index_q4(p, idx, C)
    ops.reset_launch_counts()
    out = wire.gather_dequantize(q, s, inv)
    out4 = wire.unpack_gather_dequantize_q4(p, s4, inv4)
    counts = ops.launch_counts()
    assert counts["gather_dequantize"] == 1
    assert counts["unpack_gather_dequantize_q4"] == 1
    _close(out, ref.gather_dequantize_ref(q, s, inv))
    _close(out4, ref.unpack_gather_dequantize_q4_ref(p, s4, inv4))
    qp, invp = ref.expand_operands(q, idx, C)
    _close(wire.gather_dequantize(qp, s, invp), out)
    pp, invp4 = ref.expand_operands_q4(p, idx, C)
    _close(wire.unpack_gather_dequantize_q4(pp, s4, invp4), out4)
    _close(ops.scatter_dequantize(q, s, idx, C), out)
    _close(ops.scatter_dequantize_q4(p, s4, idx, C), out4)
    _close(wire.dequantize_rows(q, s), ref.dequantize_rows_ref(q, s))
    _close(wire.unpack_dequantize_q4(p, s4, B),
           ref.unpack_dequantize_q4_ref(p, s4, B))
    for ar in (torch.arange(B, device=x.device),      # rows staged
               torch.arange(0, B, 3, device=x.device)):  # read in place
        _close(wire.gather_dequantize(q, s, ar.to(torch.int32)),
               ref.gather_dequantize_ref(q, s, ar))
        _close(wire.unpack_gather_dequantize_q4(p, s4, ar),
               ref.unpack_gather_dequantize_q4_ref(p, s4, ar))
    dropped = torch.ones(C, dtype=torch.bool, device=x.device)
    dropped[idx] = False
    finite = torch.isfinite(s[:, 0]) & torch.isfinite(s4[:, 0])
    assert torch.all(out[finite][:, dropped] == 0)
    assert torch.all(out4[finite][:, dropped] == 0)


DECODE_PATHS = [   # (R, C, B, kept kind, payload base offset in bytes)
    (37, 512, 256, "groups", 0),      # runs of four, one vector a lane
    (4608, 512, 256, "groups", 0),    # runs of four, 4 vectors a lane
    (37, 512, 256, "broken", 0),      # a run broken inside a vector
    (37, 512, 256, "off4", 0),        # runs off a multiple of 4
    (37, 512, 256, "cols", 0),        # vectors read column by column
    (97, 33, 10, "cols", 0),          # Cout % 4 != 0: single columns
    (97, 33, 9, "cols", 0),           # odd B: a pad nibble
    (13, 512, 256, "groups", 1),      # a base 1 byte off: in place
    (13, 512, 256, "groups", 2),      # 2 bytes off: q4 runs, no q8 runs
    (13, 512, 256, "groups", 4),      # 4 bytes off: staged by words
    (1, 512, 256, "groups", 0),       # one row
    (5, 1, 1, "cols", 0),             # Cout = 1
    (3, 2048, 1024, "groups", 0),     # 256 lanes a row
    (5, 6144, 3072, "groups", 0),     # the widest row the plan holds
    (3, 16384, 8192, "groups", 0),    # streamed rows
    (3, 16383, 8190, "cols", 0),      # streamed single columns
]


@pytest.mark.parametrize("R,C,B,kind,off", DECODE_PATHS)
def test_decodes_plan_paths_equal_plain(R, C, B, kind, off, dev):
    x = _randn((R, C), R + B, dev, 0.05)
    _decodes_equal_plain(x, _kept(kind, C, B, R, dev), off)


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("kind", ["groups", "cols"])
def test_decodes_nonfinite_scales_equal_plain(value, kind, dev):
    """A row whose scale is NaN or inf decodes to the plain versions'
    values, NaN on its dropped (zero-index) columns too."""
    x = _randn((13, 512), 4, dev)
    idx = _kept(kind, 512, 256, 3, dev)
    x[1, idx[5]] = x[12, idx[-1]] = float(value)
    _decodes_equal_plain(x, idx)


def test_decodes_codec_operands_equal_plain(dev):
    """The decodes of ResNet-18's 60 encode_compact operands at 4 members
    (the codec API's), at kept sets of whole groups and of single columns,
    bit-equal."""
    views = codec_views("resnet18", 4)
    assert len(views) == 60
    for n, (_, R, C, B, rule) in enumerate(views):
        x = _randn((R, C), n, dev, 0.05)
        for kind in ("groups", "cols"):
            _decodes_equal_plain(x, _kept(kind, C, B, n, dev,
                                          rule.group_size))


def test_decodes_refuse_bad_operands(dev):
    q = torch.zeros(4, 8, dtype=torch.int8, device=dev)
    s = torch.ones(4, 1, device=dev)
    with pytest.raises(ValueError):      # int64 indices
        wire.gather_dequantize(q, s, torch.arange(4, device=dev))
    with pytest.raises(ValueError):      # a non-contiguous q
        wire.dequantize_rows(torch.zeros(8, 4, dtype=torch.int8,
                                         device=dev).t(), s)
    with pytest.raises(ValueError):      # more nibbles than p holds
        wire.unpack_dequantize_q4(q.view(torch.uint8), s, 17)
    with pytest.raises(ValueError):      # int32 indices
        wire.unpack_gather_dequantize_q4(
            q.view(torch.uint8), s, torch.arange(4, device=dev,
                                                 dtype=torch.int32))
