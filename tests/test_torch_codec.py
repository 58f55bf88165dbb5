"""The port's wire codecs against the JAX reference: byte accounting, spec
parsing and per-boundary selection, and the group exchanges."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import comm as jcomm  # noqa: E402
from repro.configs import HsadmmConfig  # noqa: E402

from repro_torch import comm as tcomm  # noqa: E402

from torch_port_helpers import jax_reference, to_np  # noqa: E402

SPECS = ["dense", "q8", "compact", "compact+q8", "compact+dense", "q8+compact",
         "q4", "compact+q4", "topk:0.01", "topk:1", "compact+topk:0.05"]
SHAPES = [(), (7,), (1, 1), (64, 10), (3, 3, 64, 128), (2, 5, 7)]


@pytest.mark.parametrize("spec", SPECS)
def test_wire_bytes_and_spec_parsing_equal_reference(spec):
    t, j = tcomm.get_codec(spec), jcomm.get_codec(spec)
    assert (t.name, t.compact, t.stateful, t.gather) == \
        (j.name, j.compact, j.stateful, j.gather)
    for shape in SHAPES:
        for dtype in ("float32", "bfloat16"):
            assert t.wire_bytes(shape, dtype) == j.wire_bytes(shape, dtype)


@pytest.mark.parametrize("hp,levels,kc", [
    (HsadmmConfig(), (4, 4), 1),
    (HsadmmConfig(wire_inter="compact+q8"), (4, 4), 1),
    (HsadmmConfig(wire_intra="q8", wire_inter="compact"), (2, 2, 2), 1),
    (HsadmmConfig(wire_inter="q8"), (8,), 1),     # flat ablation: intra
    (HsadmmConfig(wire_inter="q8"), (8,), 0),
    (HsadmmConfig(wire_map=("dense", "compact+q8")), (4, 4), 1),
    (HsadmmConfig(wire_inter="compact+topk:0.01"), (4, 4), 1),
    (HsadmmConfig(wire_map=("topk:0.05", "compact+topk:0.05")), (2, 2), 1),
])
def test_level_codecs_equal_reference(hp, levels, kc):
    assert [c.name for c in tcomm.level_codecs(hp, levels, kc)] == \
        [c.name for c in jcomm.level_codecs(hp, levels, kc)]


def test_spec_errors():
    with pytest.raises(KeyError):
        tcomm.get_codec("zstd")
    with pytest.raises(ValueError):
        tcomm.get_codec("")
    with pytest.raises(ValueError):
        tcomm.compose("q8", "dense")
    with pytest.raises(ValueError):
        tcomm.compose("q8", "topk:0.1")   # two element codecs can't reduce
    with pytest.raises(ValueError):
        tcomm.level_codecs(HsadmmConfig(wire_map=("dense",)), (4, 4), 1)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "permute"])
def test_collective_wire_bytes_equal_reference(kind):
    for g in (1, 2, 4):
        assert tcomm.collective_wire_bytes(kind, g, 1000) == \
            jcomm.collective_wire_bytes(kind, g, 1000)


def _tree(lead, seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 3, 8, 16), "b": (16,), "fc": (16, 10)}
    return {k: np.asarray(rng.standard_normal((lead,) + s), np.float32)
            for k, s in shapes.items()}


def _weights(n):
    return np.linspace(0.5, 1.5, n).astype(np.float32)


@pytest.mark.parametrize("g,lead", [(2, 4), (4, 4), (4, 8)])
def test_dense_group_reduce_matches_reference(g, lead):
    tree, w = _tree(lead, 0), _weights(lead)
    jout, _ = jcomm.get_codec("dense").group_reduce(
        {k: jnp.asarray(v) for k, v in tree.items()}, g, jnp.asarray(w))
    tout, _ = tcomm.get_codec("dense").group_reduce(
        {k: torch.from_numpy(v) for k, v in tree.items()}, g,
        torch.from_numpy(w))
    for k in tree:
        np.testing.assert_allclose(to_np(tout[k]), np.asarray(jout[k]),
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("g,lead", [(2, 4), (4, 4), (4, 8)])
def test_q8_group_reduce_equals_eager_reference(g, lead):
    """Same ring order and f32 accumulation as the reference: bit-equal to
    the JAX codec (not jitted) on the eager reference's quantizer."""
    tree, w = _tree(lead, 1), _weights(lead)
    with jax_reference(ieee_quantize=True):
        jout, _ = jcomm.get_codec("compact+q8").group_reduce(
            {k: jnp.asarray(v) for k, v in tree.items()}, g, jnp.asarray(w))
    tout, _ = tcomm.get_codec("compact+q8").group_reduce(
        {k: torch.from_numpy(v) for k, v in tree.items()}, g,
        torch.from_numpy(w))
    for k in tree:
        np.testing.assert_array_equal(to_np(tout[k]), np.asarray(jout[k]),
                                      err_msg=k)


@pytest.mark.parametrize("g,lead", [(2, 4), (4, 4)])
def test_q8_group_reduce_within_a_quantum_of_jitted_reference(g, lead):
    """Against the jitted JAX codec (scale max*(1/127), one ulp off), each
    output row stays within one quantum per group member."""
    tree, w = _tree(lead, 2), _weights(lead)
    jout, _ = jax.jit(lambda t, ww: jcomm.get_codec("q8").group_reduce(
        t, g, ww))({k: jnp.asarray(v) for k, v in tree.items()},
                   jnp.asarray(w))
    tout, _ = tcomm.get_codec("q8").group_reduce(
        {k: torch.from_numpy(v) for k, v in tree.items()}, g,
        torch.from_numpy(w))
    for k, x in tree.items():
        xw = x * w.reshape((-1,) + (1,) * (x.ndim - 1))
        rows = xw.reshape(lead, -1, x.shape[-1]) if x.ndim >= 2 \
            else xw.reshape(lead, 1, 1)
        quantum = np.abs(rows).max(axis=-1, keepdims=True) / 127
        tol = quantum.reshape(lead // g, g, -1, 1).sum(axis=1) * 1.01
        diff = np.abs(to_np(tout[k]) - np.asarray(jout[k]))
        diff = diff.reshape(lead // g, -1, rows.shape[-1])
        assert np.all(diff <= tol), k


def test_group_sum_matches_reference():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    w = _weights(6)
    np.testing.assert_allclose(
        to_np(tcomm.group_sum(torch.from_numpy(x), 3, torch.from_numpy(w))),
        np.asarray(jcomm.group_sum(jnp.asarray(x), 3, jnp.asarray(w))),
        rtol=1e-6)


def test_compose_matches_reference():
    for parts in (("compact", "q8"), ("q8",), ("compact",)):
        t, j = tcomm.compose(*parts), jcomm.compose(*parts)
        assert (t.name, t.compact) == (j.name, j.compact)
