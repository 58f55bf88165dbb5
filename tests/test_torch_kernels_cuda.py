"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card.  Every case carries the ``cuda`` marker and skips
where there is no card; the file imports no JAX, so it also runs on a
machine with a card and PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_prox_sgd as tfp  # noqa: E402
from repro_torch.kernels import ops, ref, wire  # noqa: E402

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
