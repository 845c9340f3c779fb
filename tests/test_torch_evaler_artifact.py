"""``Evaler.init_artifact`` (yolov6_tpu_torch/core/evaler.py; JAX:
evaler.py:146-211) on the CPU: small S exported end2end as a ``.pt2`` at
the eval protocol (conf 0.03, IoU 0.65, max_det 300, multi-label, 8192
candidates), float input (no ``--with-preprocess``), at the Evaler's batch;
over 8 generated PNG images its COCO rows and AP equal those of the live
Evaler on the same model and images, row for row, also through the eval
CLI's ``--artifact``. An artifact that takes uint8 images, or another batch,
is refused.
"""

import numpy as np
import pytest
import torch

from yolov6_tpu_torch.core.evaler import Evaler
from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
from yolov6_tpu_torch.models.end2end import export_program, export_serve_module
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.data_config import load_data_config

from torch_port_utils import NATIVE_SIZES, small_s_config

IMG, NC, BATCH = 160, 4, 4
PROTOCOL = dict(conf_thres=0.03, iou_thres=0.65, max_det=300)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaler_artifact")
    data = load_data_config(generate_synth_dataset(
        str(root / "set"), n_train=0, n_val=8, img_size=IMG, seed=23, sizes=NATIVE_SIZES))
    torch.manual_seed(0)
    model = build_model(small_s_config(Config), num_classes=NC, device="cpu")
    with torch.no_grad():  # spread the head (zero weights, prior bias at init)
        for conv in list(model.detect.cls_preds) + list(model.detect.reg_preds):
            conv.weight.normal_(0, 0.05)
            conv.bias.zero_()
    paths = {}
    for name, kw in (("float", dict(input_dtype=torch.float32)),
                     ("uint8", dict(input_dtype=torch.uint8))):
        paths[name] = str(root / f"s_{name}.pt2")
        module = export_serve_module(model, **PROTOCOL, half=False, multi_label=True,
                                     max_nms=8192)
        export_program(module, BATCH, (IMG, IMG), paths[name], **kw)
    return data, model, paths, root


def _evaler(data, root):
    return Evaler(dict(data), batch_size=BATCH, img_size=IMG, half=False,
                  save_dir=str(root), device="cpu", **PROTOCOL)


def test_artifact_rows_equal_live_evaler(setup):
    data, model, paths, root = setup
    live = _evaler(data, root)
    live.init_model(model)
    loader = live.init_data(None, "val")
    want = live.predict_model(model, loader)
    want_ap = live.eval_model(want, model, loader)

    ev = _evaler(data, root)
    shim = ev.init_artifact(paths["float"], num_classes=NC)
    assert shim.num_classes == NC
    got = ev.predict_model(shim, ev.init_data(None, "val"))
    assert len(want) > 20 and len({r["image_id"] for r in want}) == 8
    assert got == want
    assert ev.eval_model(got, shim, loader) == want_ap


def test_artifact_refused_with_preprocess_or_another_batch(setup, tmp_path):
    data, _, paths, root = setup
    with pytest.raises(ValueError, match="with-preprocess"):
        _evaler(data, root).init_artifact(paths["uint8"], num_classes=NC)
    other = Evaler(dict(data), batch_size=2, img_size=IMG, half=False, save_dir=str(root),
                   device="cpu")
    with pytest.raises(ValueError, match="batch"):
        other.init_artifact(paths["float"], num_classes=NC)


def test_eval_cli_takes_the_artifact(setup, tmp_path):
    """``tools/eval.py --artifact``: the artifact in place of ``--weights``
    scores what the live model scores."""
    from yolov6_tpu_torch.tools import eval as eval_cli

    data, model, paths, _ = setup
    kw = dict(batch_size=BATCH, img_size=IMG, half=False, device="cpu",
              conf_thres=PROTOCOL["conf_thres"], iou_thres=PROTOCOL["iou_thres"])
    (ap50, ap), rows = eval_cli.run(dict(data), artifact=paths["float"],
                                    save_dir=str(tmp_path / "artifact"), **kw)
    (ap50_l, ap_l), rows_l = eval_cli.run(dict(data), model=model, save_dir=str(tmp_path / "live"),
                                          **kw)
    assert rows == rows_l and (ap50, ap) == (ap50_l, ap_l)
