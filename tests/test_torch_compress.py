"""``repro_torch.distrib.compress`` against ``repro.distrib.compress``:
int8 block quantization and the error-feedback codec, exactly (both
round half to even), at sizes that are and are not multiples of the
256-element block, and the compression ratio."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distrib import compress as JC
from repro_torch.distrib import compress as TC

torch.set_num_threads(1)

SHAPES = [(1000,), (256,), (3, 7, 11), (513, 2), (1,), (4, 256)]


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 10)).astype(np.float32)
    # exact halves after scaling: ties that round half to even
    x.reshape(-1)[:1] = 0.0
    return x


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_and_dequantize_match_the_reference(shape):
    x = _x(shape, len(shape))
    qj, sj = JC._quantize(jnp.asarray(x))
    qt, st = TC._quantize(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    back = TC._dequantize(qt, st, shape)
    assert tuple(back.shape) == shape
    np.testing.assert_array_equal(back.numpy(), np.asarray(JC._dequantize(qj, sj, shape)))


def test_round_half_to_even():
    # a block whose absmax is 127 has scale 1 + 1e-12 / 127 ~ 1: the
    # halves 0.5, 1.5, 2.5 round to 0, 2, 2 in both packages
    x = np.zeros(256, np.float32)
    x[:4] = [127.0, 0.5, 1.5, 2.5]
    qj, _ = JC._quantize(jnp.asarray(x))
    qt, _ = TC._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt[0, :4].tolist() == [127, 0, 2, 2]


def test_error_feedback_codec_matches_the_reference():
    tree = {"a": _x((300,), 1), "b": [_x((17, 5), 2), _x((256,), 3)]}
    codec_j, zero_j = JC.make_error_feedback_codec()
    codec_t, zero_t = TC.make_error_feedback_codec()
    gj = jax.tree.map(jnp.asarray, tree)
    gt = {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(t) for t in tree["b"]]}
    ej, et = zero_j(gj), zero_t(gt)
    assert all(float(e.abs().sum()) == 0 for e in [et["a"], *et["b"]])
    for step in range(3):
        scale = np.float32(1.0 + step)
        gj2 = jax.tree.map(lambda a: a * scale, gj)
        gt2 = {"a": gt["a"] * scale, "b": [t * scale for t in gt["b"]]}
        (oj, ej), (ot, et) = codec_j(gj2, ej), codec_t(gt2, et)
        for a, b in ((oj["a"], ot["a"]), (ej["a"], et["a"])):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for a, b in zip(oj["b"] + ej["b"], ot["b"] + et["b"]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_quantize_roundtrip_accuracy():
    x = torch.from_numpy(_x((1000,), 0))
    q, s = TC._quantize(x)
    back = TC._dequantize(q, s, x.shape)
    assert float((back - x).abs().max()) < float(x.abs().max()) / 100


@pytest.mark.parametrize("jd,td", [(jnp.float32, torch.float32),
                                   (jnp.bfloat16, torch.bfloat16)])
def test_compression_ratio(jd, td):
    assert TC.compression_ratio(td) == JC.compression_ratio(jd)
    assert TC.BLOCK == JC.BLOCK == 256
