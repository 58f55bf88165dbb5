"""The port's training loop against the JAX reference, its byte
accounting, and the port's hygiene: it runs on the card unless asked for
the CPU, and imports nothing of JAX or of the JAX package."""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ConsensusSpec, HsadmmConfig, ShapeConfig, get_config  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.train.engine import Engine as JEngine  # noqa: E402
from repro.train.loop import train as j_train  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.train.engine import Engine  # noqa: E402
from repro_torch.train.loop import (RunConfig, comm_volume,  # noqa: E402
                                    round_comm_bytes, train)

from torch_port_helpers import jax_reference, to_np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HP = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=8, t_freeze=2,
                  wire_inter="compact+q8")
LEVELS = ConsensusSpec(levels=(2, 2), compact_from_level=1)
SHAPE = ShapeConfig("tiny", "train", 32, 16)


@pytest.fixture(scope="module")
def runs():
    """4 rounds of both packages from the same (JAX-drawn) init."""
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=HP))
    p0 = jax.device_get(jb.init(jax.random.PRNGKey(0)))
    with jax_reference():
        jst, jrep = j_train(JEngine(jb, make_host_mesh(), SHAPE,
                                    consensus=LEVELS),
                            outer_iters=4, shape=SHAPE, eta=1e-2, log=None)
    tb = t_build(t_get_config("resnet18", smoke=True).replace(hsadmm=HP))
    tb = dataclasses.replace(
        tb, init=lambda gen, device: convert.params_from_jax(p0, device))
    tst, trep = train(Engine(tb, SHAPE, consensus=LEVELS, device="cpu"),
                      RunConfig(outer_iters=4, shape=SHAPE, eta=1e-2,
                                log=None))
    return jax.device_get(jst), jrep, tst, trep


def test_train_matches_reference(runs):
    jst, jrep, tst, trep = runs
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-3)
    assert trep.frozen_at == jrep.frozen_at == 2
    assert trep.executables == jrep.executables
    assert trep.comm_bytes_internode == jrep.comm_bytes_internode
    assert trep.comm_bytes_dense_equiv == jrep.comm_bytes_dense_equiv
    assert trep.wire_map == jrep.wire_map == ["dense", "compact+q8"]
    for rule, m in jst["masks"].items():
        np.testing.assert_array_equal(to_np(tst["masks"][rule]["idx"]),
                                      np.asarray(m["idx"]), err_msg=rule)


@pytest.mark.parametrize("wire,expected", [
    ("compact+q8", (44_695_848, 2_861_818, 2_860_858)),
    ("dense", (44_695_848, 11_191_400, 11_190_440)),
    ("compact+topk:0.01", (44_695_848, 224_720, 223_760)),
    ("topk:0.01", (44_695_848, 224_720, 223_760)),
])
def test_round_comm_bytes_resnet18_full(wire, expected):
    """Full-width resnet18 at the paper's levels (4, 4): the port's
    analytic inter-node bytes equal the reference's exactly."""
    from repro.train.loop import comm_volume as j_comm_volume
    from repro.train.loop import round_comm_bytes as j_round_comm_bytes
    consensus = ConsensusSpec(levels=(4, 4), compact_from_level=1)
    hp = dataclasses.replace(HsadmmConfig(), wire_inter=wire)
    tb = t_build(t_get_config("resnet18").replace(hsadmm=hp))
    teng = Engine(tb, consensus=consensus, device="cpu")
    jb = j_build(get_config("resnet18").replace(hsadmm=hp))
    jeng = JEngine(jb, make_host_mesh(), consensus=consensus)
    assert round_comm_bytes(teng) == tuple(j_round_comm_bytes(jeng)) \
        == expected
    for wire_fmt in (True, False):
        assert comm_volume(teng, wire_fmt) == \
            tuple(j_comm_volume(jeng, wire_fmt))


def test_engine_runs_on_the_card_unless_asked():
    bundle = t_build(t_get_config("resnet18", smoke=True))
    if torch.cuda.is_available():
        assert Engine(bundle).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(bundle)
    assert Engine(bundle, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("option", [
    {"wire_auto": True},
    {"hlo_stats": True},
])
def test_unported_options_refuse(option):
    bundle = t_build(t_get_config("resnet18", smoke=True))
    eng = Engine(bundle, SHAPE, consensus=LEVELS, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        train(eng, RunConfig(outer_iters=1, shape=SHAPE, log=None, **option))


def test_engine_rejects_unsupported_staleness():
    hp = dataclasses.replace(HP, staleness=2)
    with pytest.raises(ValueError, match="staleness=2"):
        Engine(t_build(t_get_config("resnet18", smoke=True)
                       .replace(hsadmm=hp)), SHAPE, consensus=LEVELS,
               device="cpu")


@pytest.mark.parametrize("option,match", [
    ({"staleness": 1}, "fused_rounds"),
    ({"reconfig": True}, "fused_rounds"),
])
def test_per_step_path_refuses_overlap_and_reconfig(option, match):
    """The per-step dispatch path neither overlaps nor reconfigures (as in
    the reference)."""
    eng = Engine(t_build(t_get_config("resnet18", smoke=True)), SHAPE,
                 consensus=LEVELS, device="cpu")
    with pytest.raises(ValueError, match=match):
        train(eng, RunConfig(outer_iters=1, shape=SHAPE, log=None,
                             fused_rounds=False, **option))


@pytest.fixture(scope="module")
def per_step():
    """5 rounds of the per-step dispatch path (``fused_rounds=False``) in
    both packages, and of the port's fused rounds, masks frozen at round
    3, compact+q8 at levels (2, 2)."""
    hp = dataclasses.replace(HP, local_steps=2, t_freeze=3)
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=hp))
    p0 = jax.device_get(jb.init(jax.random.PRNGKey(0)))
    kw = dict(outer_iters=5, shape=SHAPE, eta=1e-2, metrics_every=2,
              log=None)
    with jax_reference(ieee_quantize=True):
        _, jrep = j_train(JEngine(jb, make_host_mesh(), SHAPE,
                                  consensus=LEVELS),
                          fused_rounds=False, **kw)
    tb = t_build(t_get_config("resnet18", smoke=True).replace(hsadmm=hp))
    tb = dataclasses.replace(
        tb, init=lambda gen, device: convert.params_from_jax(p0, device))
    out = {}
    for fused in (True, False):
        out[fused] = train(Engine(tb, SHAPE, consensus=LEVELS, device="cpu"),
                           RunConfig(fused_rounds=fused, **kw))
    return jrep, out


def test_per_step_path_matches_reference(per_step):
    """The JAX package's own tolerances for its fused and per-step loops
    (``test_fused_round.py::test_fused_and_legacy_loop_agree``)."""
    jrep, out = per_step
    _, trep = out[False]
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=2e-4)
    np.testing.assert_allclose(trep.r_primal, jrep.r_primal, rtol=2e-3)
    assert trep.frozen_at == jrep.frozen_at == 3
    assert trep.executables == jrep.executables
    assert trep.comm_bytes_internode == jrep.comm_bytes_internode


def test_per_step_path_is_bit_equal_to_fused_rounds(per_step):
    """Both paths run the same ops on the same batches: equal losses,
    residuals and final state, bit for bit."""
    _, out = per_step
    (fst, frep), (pst, prep) = out[True], out[False]
    assert prep.losses == frep.losses
    assert prep.r_primal == frep.r_primal
    assert prep.executables == frep.executables
    for grp in ("theta", "mom", "u"):
        for key, x in fst[grp].items():
            assert torch.equal(pst[grp][key], x), (grp, key)
    for zf, zp in zip(fst["z"], pst["z"]):
        for key, x in zf.items():
            assert torch.equal(zp[key], x), key
    for rule, m in fst["masks"].items():
        assert torch.equal(pst["masks"][rule]["idx"], m["idx"]), rule


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Nor ``ml_dtypes`` (JAX's bf16 type), which the card's machine does
    not have: the port carries bf16 across numpy as 2-byte words."""
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "repro",
                                       "ml_dtypes"):
                    bad.append(f"{f.relative_to(ROOT)}: {n}")
    assert not bad, bad


@pytest.mark.parametrize("preset", [None, ":16:8"])
def test_cublas_workspace_is_fixed_at_import(preset):
    """Importing the port fixes cuBLAS's workspace before any CUDA work
    (cuBLAS reads it once, when the first product creates its handle),
    and a value the user set wins."""
    import os
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items()
           if k != "CUBLAS_WORKSPACE_CONFIG"}
    if preset is not None:
        env["CUBLAS_WORKSPACE_CONFIG"] = preset
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-c", "import os, repro_torch; "
         "print(os.environ['CUBLAS_WORKSPACE_CONFIG'])"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == (preset or ":4096:8")
