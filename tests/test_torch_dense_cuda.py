"""The dense transformer on the card: two tinyllama smoke runs through
freeze and physical reconfiguration bit-equal, and the
:class:`ChunkedAttention` Function's recomputing backward equal to the
VJP of the plain function under plain autograd.  Every case carries the
``cuda`` marker and skips where there is no card; the file imports no
JAX:

    python -m pytest -q -m cuda tests/test_torch_dense_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (ConsensusSpec, HsadmmConfig,  # noqa: E402
                                 ShapeConfig, get_config)
from repro_torch.models import build  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.train.engine import Engine  # noqa: E402
from repro_torch.train.loop import RunConfig, train  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPE = ShapeConfig("s", "train", 64, 8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_dense_smoke_runs_are_bit_equal(dev):
    """tinyllama smoke (8 query heads in 4 GQA groups) at W = 4 over
    compact+q8: two dynamic rounds, a frozen one, the migration and two
    reconfigured rounds, twice, bit for bit."""
    hp = HsadmmConfig(local_steps=2, t_freeze=2, reconfig_patience=1,
                      wire_inter="compact+q8")
    cfg = get_config("tinyllama-1.1b", smoke=True).replace(
        hsadmm=hp, n_heads=8, n_kv_heads=4)
    runs = []
    for _ in range(2):
        eng = Engine(build(cfg), SHAPE, consensus=ConsensusSpec((2, 2), 1),
                     device=dev)
        runs.append(train(eng, RunConfig(outer_iters=5, shape=SHAPE,
                                         eta=1e-3, reconfig=True, log=None)))
    (sa, ra), (sb, rb) = runs
    assert ra.executables == ["dynamic"] * 2 + ["frozen"] \
        + ["reconfigured"] * 2
    assert ra.losses == rb.losses
    assert sa["theta"]["blocks/mlp/wg"].shape == (4, 2, 64, 64)
    for part in ("theta", "u", "mom"):
        assert all(torch.equal(sa[part][k], sb[part][k]) for k in sa[part])
    for za, zb in zip(sa["z"], sb["z"], strict=True):
        assert all(torch.equal(za[k], zb[k]) for k in za)


@pytest.mark.parametrize("T,chunk", [(1024, 256), (600, 256)])
def test_attention_function_backward_equals_plain_vjp(dev, T, chunk):
    """The Function against plain autograd through
    ``chunked_attention_ref`` at tinyllama's heads (4 GQA groups of 8, hd
    64): the same forward bits, and gradients within rtol 1e-5 (the
    Function sums k's and v's gradients over the q chunks in its own
    order)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, T, 4, 8, 64), generator=gen, device=dev)
    k = torch.randn((2, T, 4, 64), generator=gen, device=dev)
    v = torch.randn((2, T, 4, 64), generator=gen, device=dev)
    w = torch.randn(q.shape, generator=gen, device=dev)
    outs, grads = [], []
    for fn in (L.chunked_attention_ref, L.chunked_attention):
        a = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*a, q_chunk=chunk, k_chunk=chunk)
        (out * w).sum().backward()
        outs.append(out.detach())
        grads.append([x.grad for x in a])
    assert torch.equal(outs[0], outs[1])
    for g_plain, g_fn in zip(*grads):
        torch.testing.assert_close(g_fn, g_plain, rtol=1e-5, atol=1e-6)
