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

from repro_torch.kernels import ops, wire  # noqa: E402

from torch_port_helpers import to_np  # noqa: E402

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
    ops.scatter_dequantize(*ops.gather_quantize(x, idx), idx, 8)
    ops.dequantize_rows(*ops.quantize_rows(x))
    ops.group_norms_sq(x.reshape(2, 2, 8))
    assert ops.launch_counts() == {
        "fused_prox_sgd": 0, "fused_prox_sgd_dyn": 0, "gather_groups": 0,
        "quantize_rows": 0, "gather_quantize": 0, "gather_dequantize": 0,
        "quantize_pack_q4": 0, "gather_quantize_q4": 0,
        "unpack_gather_dequantize_q4": 0, "group_norms_sq": 0}


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
