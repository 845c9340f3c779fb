"""The port's Evaler on a P6 graph against the JAX package's Evaler, and the
eval CLI's ``--reproduce_640_eval`` rows of the P6 and MBLA configs.

Small N6 (depth 0.1, width 0.125, four levels, strides 8-64) with the same
weights (``state_dict_from_jax``), fp32, on the CPU, at img 256, batch 4,
with tests/test_torch_evaler.py's tolerances and row matching: on images
whose long side is 256 (no pixel resized), and on larger images shrunk by
N6's repro ``shrink_size`` 17 (INTER_AREA to a long side of 239,
letterboxed to 256), each package from its own loader (the port's resizers
equal cv2's bit for bit); square batches, as the repro protocol evaluates.
Rect batches are not held: both packages letterbox them to multiples of 32,
which a stride-64 graph cannot concatenate across levels (ROADMAP queue 3).
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
from yolov6_tpu_torch.tools import eval as eval_cli
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.data_config import load_data_config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_evaler import AP_TOL, BATCH, NC, _assert_rows_equal
from torch_port_utils import MBLA_CONFIGS, P6_CONFIGS, random_jax_variables, small_config

IMG = 256
N6_SHRINK = 17  # configs/experiment/eval_640_repro.py's yolov6n6 row


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaler_p6")
    native = load_data_config(generate_synth_dataset(
        str(root / "native"), n_train=0, n_val=8, img_size=IMG, seed=23,
        sizes=[(256, 192), (192, 256), (256, 256), (256, 160)]))
    shrunk = load_data_config(generate_synth_dataset(
        str(root / "shrunk"), n_train=0, n_val=6, img_size=IMG, seed=24,
        sizes=[(320, 240), (300, 300), (240, 288)]))
    return {"native": native, "shrunk": shrunk}


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(small_config(JaxConfig, P6_CONFIGS["n6"]), num_classes=NC,
                             deploy=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    variables = random_jax_variables(shapes, seed=32)
    model = build_model(small_config(Config, P6_CONFIGS["n6"]), num_classes=NC, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


@pytest.mark.parametrize("which,shrink", [("native", 0), ("shrunk", N6_SHRINK)],
                         ids=["native", "shrink17"])
def test_evaler_matches_jax_small_n6(sets, models, tmp_path, which, shrink):
    jmodel, variables, model = models
    kw = dict(batch_size=BATCH, img_size=IMG, half=False, shrink_size=shrink)
    (tmp_path / "jax").mkdir()
    theirs = JaxEvaler(dict(sets[which]), save_dir=str(tmp_path / "jax"), **kw)
    theirs.init_model(jmodel, variables)
    ours = Evaler(dict(sets[which]), save_dir=str(tmp_path), device="cpu", **kw)
    ours.init_model(model)
    loader, loader_j = ours.init_data(None, "val"), theirs.init_data(None, "val")
    assert {tuple(b[0].shape[1:3]) for b in loader} == {(IMG, IMG)}
    rows = ours.predict_model(model, loader)
    rows_j = theirs.predict_model(jmodel, loader_j)
    _assert_rows_equal(rows, rows_j)
    ap = ours.eval_model(rows, model, loader)
    np.testing.assert_allclose(ap, theirs.eval_model(rows_j, jmodel, loader_j), rtol=0,
                               atol=AP_TOL)
    assert 0 <= ap[1] <= ap[0] <= 1


REPRO_ROWS = [(P6_CONFIGS["n6"], 1280, 17), (P6_CONFIGS["s6"], 1280, 8),
              (P6_CONFIGS["m6"], 1280, 64), (P6_CONFIGS["l6"], 1280, 41),
              (MBLA_CONFIGS["s"], 640, 7), (MBLA_CONFIGS["m"], 640, 7),
              (MBLA_CONFIGS["l"], 640, 7), (MBLA_CONFIGS["x"], 640, 3)]


@pytest.mark.parametrize("config,img_size,shrink", REPRO_ROWS,
                         ids=["n6", "s6", "m6", "l6", "s_mbla", "m_mbla", "l_mbla", "x_mbla"])
def test_reproduce_640_eval_rows(monkeypatch, tmp_path, config, img_size, shrink):
    """``--reproduce_640_eval`` looks the config's row up by its file name and
    evaluates at its size and shrink, at conf 0.03 and IoU 0.65, square."""
    seen = {}

    def run(*args, **kwargs):
        seen.update(img_size=args[4], conf=args[5], iou=args[6], **kwargs)
        return (0.0, 0.0), []

    monkeypatch.setattr(eval_cli, "run", run)
    args = eval_cli.get_args_parser().parse_args(
        ["--data", "unused.json", "--config", config, "--weights", "unused.pt",
         "--reproduce_640_eval", "--save_dir", str(tmp_path), "--device", "cpu"])
    eval_cli.main(args)
    assert (seen["img_size"], seen["shrink_size"]) == (img_size, shrink)
    assert (seen["conf"], seen["iou"], seen["infer_on_rect"]) == (0.03, 0.65, False)
