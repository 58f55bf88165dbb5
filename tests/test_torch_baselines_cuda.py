"""The baselines and the top-k wire on the card: each trainer's two runs
bit-equal, the top-k exchange equal to the CPU's, and H-SADMM over a top-k
boundary resumed twice bit-equal with its residuals.  Every case carries
the ``cuda`` marker and skips where there is no card; the file imports no
JAX:

    python -m pytest -q -m cuda tests/test_torch_baselines_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.comm import TopKCodec, topk_mask  # noqa: E402
from repro_torch.configs import (ConsensusSpec, HsadmmConfig,  # noqa: E402
                                 ShapeConfig, get_config)
from repro_torch.dist import checkpoint as ckpt  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train import baselines  # noqa: E402
from repro_torch.train.engine import Engine  # noqa: E402
from repro_torch.train.loop import RunConfig, train  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPE = ShapeConfig("s", "train", 16, 16)
TRAINERS = {"ddp": ("ddp_train", {}),
            "topk": ("topk_train", {"rate": 0.05}),
            "q8": ("codec_train", {"codec": "q8"})}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_runs_are_bit_equal(dev, name):
    fn, kw = TRAINERS[name]
    bundle = build(get_config("resnet18", smoke=True))
    (pa, ra), (pb, rb) = [
        getattr(baselines, fn)(bundle, 2, SHAPE, steps=8, eta=1e-2,
                               round_steps=4, **kw) for _ in range(2)]
    assert ra.losses == rb.losses
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert next(iter(pa.values())).device.type == "cuda"


@pytest.mark.parametrize("kind", ["gauss", "tied"])
def test_topk_group_reduce_equals_the_cpu(dev, kind):
    gen = torch.Generator().manual_seed(1)
    shape = (4, 3, 3, 64, 64)
    x = torch.randn(shape, generator=gen) if kind == "gauss" \
        else torch.randint(-3, 4, shape, generator=gen).float()
    e = 0.1 * torch.randn(shape, generator=gen)
    w = torch.linspace(0.5, 1.5, 4)
    codec = TopKCodec(0.01)
    rc, sc = codec.group_reduce({"x": x}, 2, w, {"x": e})
    rg, sg = codec.group_reduce({"x": x.to(dev)}, 2, w.to(dev),
                                {"x": e.to(dev)})
    assert torch.equal(sg["x"].cpu(), sc["x"])
    torch.testing.assert_close(rg["x"].cpu(), rc["x"], rtol=1e-6, atol=0)
    a = (x * w.reshape(4, 1, 1, 1, 1) + e).reshape(4, -1).abs()
    k = codec.k_of(a.shape[-1])
    assert torch.equal(topk_mask(a.to(dev), k).cpu(), topk_mask(a, k))


def test_topk_hsadmm_resumes_bit_equal_twice(dev, tmp_path):
    hp = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=2, t_freeze=2,
                      wire_inter="compact+topk:0.05")
    eng = Engine(build(get_config("resnet18", smoke=True).replace(
        hsadmm=hp)), SHAPE, consensus=ConsensusSpec((2, 2), 1), device=dev)
    st, _ = train(eng, RunConfig(outer_iters=3, shape=SHAPE, eta=1e-2,
                                 ckpt_dir=str(tmp_path), ckpt_every=3,
                                 log=None))
    back, _ = ckpt.restore(ckpt.latest(str(tmp_path)), st)
    wire = ckpt._flatten({"wire": st["wire"]})
    assert wire and all(torch.equal(t, ckpt._flatten(
        {"wire": back["wire"]})[p]) for p, t in wire.items())
    runs = [train(eng, RunConfig(outer_iters=5, shape=SHAPE, eta=1e-2,
                                 ckpt_dir=str(tmp_path), ckpt_every=0,
                                 log=None)) for _ in range(2)]
    (sa, ra), (sb, rb) = runs
    assert ra.losses == rb.losses and len(ra.losses) == 2
    for p, t in ckpt._flatten(sa).items():
        assert torch.equal(t, ckpt._flatten(sb)[p]), p
