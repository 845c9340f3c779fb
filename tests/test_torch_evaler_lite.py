"""The port's Evaler on YOLOv6Lite-S against the JAX package's Evaler, with
the same weights (``state_dict_from_jax``), fp32, on the CPU, at img 160,
batch 4, with tests/test_torch_evaler.py's tolerances and row matching.

Lite-S at full width (4 classes; four levels, strides 8-64) on images whose
long side is 160 (no pixel resized), in square and in rect mode. Unlike the
P6 graphs, the lite graph runs on rect batches: both packages letterbox them
to multiples of 32, and the lite neck reads its stride-64 level from two
stride-32 maps (``p6_conv_1(fpn_out0) + p6_conv_2(pan_out1)``), so no
concat joins the 64 and 32 grids; the JAX Evaler runs them, and so does the
port's. The weights are ``torch_port_utils.random_lite_variables``'s, so
that the rows an image keeps are the model's and not a pick among
near-ties.
"""

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.core.evaler import Evaler as JaxEvaler
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.core.evaler import Evaler
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.data_config import load_data_config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_evaler import AP_TOL, BATCH, NC, _assert_rows_equal
from test_torch_lite_model import LITE_CONFIGS
from torch_port_utils import EVAL_IMG_SIZE, NATIVE_SIZES, random_lite_variables


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    return load_data_config(generate_synth_dataset(
        str(tmp_path_factory.mktemp("evaler_lite")), n_train=0, n_val=8,
        img_size=EVAL_IMG_SIZE, seed=25, sizes=NATIVE_SIZES))


@pytest.fixture(scope="module")
def models(native, tmp_path_factory):
    jmodel = jax_build_model(JaxConfig.fromfile(LITE_CONFIGS["s"]), num_classes=NC, deploy=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, EVAL_IMG_SIZE, EVAL_IMG_SIZE, 3)), train=False))
    variables = random_lite_variables(shapes, seed=33)
    theirs = JaxEvaler(dict(native), batch_size=BATCH, img_size=EVAL_IMG_SIZE, half=False,
                       save_dir=str(tmp_path_factory.mktemp("jax_evaler_lite")))
    theirs.init_model(jmodel, variables)
    model = build_model(Config.fromfile(LITE_CONFIGS["s"]), num_classes=NC, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, theirs, model


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_evaler_matches_jax_lite_s(native, models, tmp_path, rect):
    jmodel, theirs, model = models
    ours = Evaler(dict(native), batch_size=BATCH, img_size=EVAL_IMG_SIZE, half=False,
                  save_dir=str(tmp_path), device="cpu", infer_on_rect=rect)
    ours.init_model(model)
    loader = ours.init_data(None, "val")
    theirs.infer_on_rect = rect
    theirs.do_pr_metric = ours.do_pr_metric = False
    loader_j = theirs.init_data(None, "val")
    shapes = {tuple(b[0].shape[1:3]) for b in loader}
    assert (shapes != {(EVAL_IMG_SIZE, EVAL_IMG_SIZE)}) == rect
    # a side of an odd number of stride-32 cells: the 64 grid rounds it up
    assert any((h // 32) % 2 or (w // 32) % 2 for h, w in shapes)
    rows = ours.predict_model(model, loader)
    rows_j = theirs.predict_model(jmodel, loader_j)
    _assert_rows_equal(rows, rows_j)
    ap, ap_j = ours.eval_model(rows, model, loader), theirs.eval_model(rows_j, jmodel, loader_j)
    np.testing.assert_allclose(ap, ap_j, rtol=0, atol=AP_TOL)
    assert 0 <= ap[1] <= ap[0] <= 1
