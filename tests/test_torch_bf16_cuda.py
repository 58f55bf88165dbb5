"""The bf16 entries of the hand-written kernels on the card against their
plain versions, bit for bit: the prox update (``fused_prox_sgd_dyn`` with
a per-row and a stride-0 rho column, and ``fused_prox_sgd``) and
``quantize_rows`` on bf16 rows, which also equals the f32 route on the
same values.  Every case needs a CUDA card (``cuda`` marker) and skips
without one; the module imports no JAX, so it runs on the card's machine.
The CPU differential tests of the same entries against the JAX package
are in ``tests/test_torch_bf16.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_prox_sgd as tfp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import wire as twire  # noqa: E402

BF16 = torch.bfloat16


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
@pytest.mark.parametrize("R,C", [(4096, 2048), (7, 13), (1, 6), (33, 40)])
def test_bf16_prox_kernel_bit_equal(R, C):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(R + C)
    xs = [torch.randn((R, C), generator=gen, device=dev).to(BF16)
          for _ in range(5)]
    rho = torch.rand((R, 1), generator=gen, device=dev).to(BF16)
    eta = torch.full((1, 1), 3e-3, device=dev).to(BF16)
    for r in (rho, rho[:1].expand(R, 1)):
        t, m = tfp.fused_prox_sgd_dyn(*xs, r, eta, momentum=0.9)
        tp, mp = tref.fused_prox_sgd_ref(*xs, eta=eta, rho=r, momentum=0.9)
        assert torch.equal(t, tp) and torch.equal(m, mp)
    t, m = tfp.fused_prox_sgd(*xs, eta=3e-3, rho=1e-3, momentum=0.9)
    tp, mp = tref.fused_prox_sgd_ref(*xs, eta=3e-3, rho=1e-3, momentum=0.9)
    assert torch.equal(t, tp) and torch.equal(m, mp)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
@pytest.mark.parametrize("R,C", [(4096, 2048), (37, 10), (5, 1537),
                                 (3, 8192)])
def test_bf16_quantize_rows_bit_equal(R, C):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(R * C)
    x = torch.randn((R, C), generator=gen, device=dev).to(BF16)
    x[0, 0] = float("nan")
    q, s = twire.quantize_rows(x)
    qp, sp = tref.quantize_rows_ref(x)
    q32, s32 = twire.quantize_rows(x.float())
    assert torch.equal(q, qp) and torch.equal(q, q32)
    torch.testing.assert_close(s, sp, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(s, s32, rtol=0, atol=0, equal_nan=True)
