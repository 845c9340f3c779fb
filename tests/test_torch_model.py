"""The PyTorch port's deploy blocks, model and decode against the JAX package.

Both sides get the same seeded weights (JAX layout, carried across by
yolov6_tpu_torch/utils/weights.py) and the same inputs, on the CPU in fp32.
Tolerances: blocks rtol 1e-4 / atol 1e-5 (activations are O(1)); head maps
rtol 1e-4 / atol 1e-4; decoded boxes rtol 1e-4 / atol 1e-3 px and scores
atol 1e-5. The two sides sum the convolutions in different orders, nothing
more.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.layers import common as jcommon
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.layers import common as tcommon
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import S_CONFIG, random_jax_variables, small_s_config


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# (id, JAX module, port module, input shapes NHWC, inputs passed as one list)
BLOCK_CASES = [
    ("ConvBNReLU_3x3_s2", lambda: jcommon.ConvBNReLU(16, 3, 2, deploy=True),
     lambda: tcommon.ConvBNReLU(8, 16, 3, 2), [(2, 12, 12, 8)], False),
    ("ConvBNSiLU_1x1", lambda: jcommon.ConvBNSiLU(16, 1, 1, deploy=True),
     lambda: tcommon.ConvBNSiLU(8, 16, 1, 1), [(2, 12, 12, 8)], False),
    ("RepVGGBlock_s2", lambda: jcommon.RepVGGBlock(16, 3, 2, deploy=True),
     lambda: tcommon.RepVGGBlock(8, 16, 3, 2), [(2, 12, 12, 8)], False),
    ("RepBlock_n3", lambda: jcommon.RepBlock(16, n=3, deploy=True),
     lambda: tcommon.RepBlock(8, 16, n=3), [(2, 12, 12, 8)], False),
    ("SimCSPSPPF", lambda: jcommon.SimCSPSPPF(16, 5, deploy=True),
     lambda: tcommon.SimCSPSPPF(8, 16), [(2, 9, 9, 8)], False),
    ("Transpose", lambda: jcommon.Transpose(12),
     lambda: tcommon.Transpose(8, 12), [(2, 5, 7, 8)], False),
    ("BiFusion", lambda: jcommon.BiFusion(8, deploy=True),
     lambda: tcommon.BiFusion((12, 6), 8), [(2, 4, 4, 8), (2, 8, 8, 12), (2, 16, 16, 6)], True),
]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=[c[0] for c in BLOCK_CASES])
def test_block_matches_jax(case):
    _, make_jax, make_port, in_shapes, as_list = case
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal(s).astype(np.float32) for s in in_shapes]
    jmod = make_jax()
    jargs = ([[jnp.asarray(x) for x in xs]] if as_list else [jnp.asarray(x) for x in xs])
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs))
    variables = random_jax_variables(shapes, seed=2)
    want = np.asarray(jmod.apply(variables, *jargs))

    port = make_port()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    targs = [[_nchw(x) for x in xs]] if as_list else [_nchw(x) for x in xs]
    with torch.no_grad():
        got = _nhwc(port(*targs))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_model_decode_matches_jax():
    """Small S graph: every head map (permuted to NHWC) and the decode."""
    img, nc = 128, 80
    jmodel = jax_build_model(small_s_config(JaxConfig), num_classes=nc, deploy=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)), train=False)
    )
    variables = random_jax_variables(shapes, seed=3)
    x = np.random.default_rng(4).uniform(0, 1, (2, img, img, 3)).astype(np.float32)
    head_j, _ = jmodel.apply(variables, jnp.asarray(x), train=False)
    preds_j = np.asarray(jmodel.apply(variables, head_j, method=jmodel.decode))

    model = build_model(small_s_config(Config), num_classes=nc, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
        preds_t = model.decode(head_t).numpy()

    for key in ("cls", "reg"):
        for mj, mt in zip(head_j[key], head_t[key]):
            np.testing.assert_allclose(_nhwc(mt), np.asarray(mj), rtol=1e-4, atol=1e-4)
    assert preds_t.shape == preds_j.shape == (2, 16 * 16 + 8 * 8 + 4 * 4, 5 + nc)
    np.testing.assert_allclose(preds_t[..., :4], preds_j[..., :4], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(preds_t[..., 4], preds_j[..., 4])
    np.testing.assert_allclose(preds_t[..., 5:], preds_j[..., 5:], rtol=0, atol=1e-5)


def test_full_width_s_state_dict():
    """Full-width YOLOv6-S deploy: 142 tensors and 18.5 M parameters, and the
    names the JAX parameter paths map to (only built, not run)."""
    model = build_model(Config.fromfile(S_CONFIG), num_classes=80, device="cpu")
    sd = model.state_dict()
    assert len(sd) == 142
    assert 18.4e6 < sum(v.numel() for v in sd.values()) < 18.6e6
    assert sd["neck.Bifusion0.upsample.upsample_transpose.weight"].shape == (128, 128, 2, 2)
    assert "neck.Bifusion0.upsample.upsample_transpose.bias" in sd
    assert sd["backbone.ERBlock_5.2.cspsppf.cv7.block.conv.weight"].shape == (512, 512, 1, 1)


def test_weights_transpose_bias_and_layouts():
    """A Transpose block's kernel and bias both land under upsample_transpose;
    conv kernels go HWIO -> OIHW."""
    rng = np.random.default_rng(0)
    k_t = rng.standard_normal((2, 2, 4, 6)).astype(np.float32)
    k_c = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    sd = state_dict_from_jax({"params": {
        "neck": {"Bifusion0": {"upsample": {"kernel": k_t, "bias": np.ones(6, np.float32)},
                               "cv1": {"block": {"conv": {"kernel": k_c,
                                                          "bias": np.zeros(5, np.float32)}}}}},
    }})
    assert sorted(sd) == [
        "neck.Bifusion0.cv1.block.conv.bias",
        "neck.Bifusion0.cv1.block.conv.weight",
        "neck.Bifusion0.upsample.upsample_transpose.bias",
        "neck.Bifusion0.upsample.upsample_transpose.weight",
    ]
    np.testing.assert_array_equal(sd["neck.Bifusion0.upsample.upsample_transpose.weight"].numpy(),
                                  k_t.transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(sd["neck.Bifusion0.cv1.block.conv.weight"].numpy(),
                                  k_c.transpose(3, 2, 0, 1))
