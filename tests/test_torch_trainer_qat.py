"""Quantisation through the port's trainer, train CLI and PTQ CLI, on the CPU:
RepOpt's third stage on configs/repopt/yolov6n_opt_qat.py at full width, 64
px, 8 train and 4 val PNG images, from a tiny hyper-search run (1 epoch) and
a RepOpt run (1 epoch) made by the train CLI.

- ``--quant --calib`` writes ``calib_ckpt.pt`` under ``ptq.calib_output_path``
  whose ranges equal a direct ``quant/ptq.py::calibrate`` of the same graph on
  the same train batches, bit for bit; its ``ptq`` skips leave those convs
  without a range, while every conv weight is quantised (no skip, as the
  JAX trainer's calibration).
- ``--quant`` trains 1 epoch from that file with warmup 0 (``qat`` skipping
  the convs the calibration left unranged): the train graph starts from its
  tensors, the step and every checkpoint (``model`` and
  ``ema``, and the stripped ``last_ckpt.pt``) carry its ranges unchanged,
  and the step's forward and the in-training eval of the EMA run quantised.
- A missing ``calib_pt``, a JAX ``.msgpack`` one and a file without ranges
  raise ``ValueError``, and QAT with a conv the calibration left unranged
  ``KeyError``, when the trainer is built; ``check_supported`` takes ``--quant`` and ``--calib``.
- ``tools/quantize.py`` writes a file that ``read_state_dict`` reads with the
  ranges split off (``--skip-layers`` convs neither quantised nor ranged),
  its ``--eval`` runs quantised, and the eval CLI serves the file in float.
"""

import os.path as osp

import pytest
import torch

from yolov6_tpu_torch.core import engine
from yolov6_tpu_torch.core.engine import Trainer, check_supported
from yolov6_tpu_torch.quant import state as quant_state
from yolov6_tpu_torch.quant.ptq import calibrate, quantize_variables
from yolov6_tpu_torch.quant.state import quant_paths
from yolov6_tpu_torch.tools import eval as eval_cli
from yolov6_tpu_torch.tools import quantize as quantize_cli
from yolov6_tpu_torch.tools import train as train_cli
from yolov6_tpu_torch.utils.checkpoint import (
    load_checkpoint, load_state_dict_file, read_state_dict, save_checkpoint,
)
from yolov6_tpu_torch.utils.config import Config

from torch_port_utils import REPO_ROOT

REPOPT = osp.join(REPO_ROOT, "configs", "repopt")
QAT_CONFIG = osp.join(REPOPT, "yolov6n_opt_qat.py")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(data, out, name, conf, *extra):
    return train_cli.get_args_parser().parse_args([
        "--data-path", data, "--conf-file", conf, "--img-size", "64", "--img-floor", "64",
        "--batch-size", "4", "--workers", "2", "--output-dir", out, "--name", name,
        "--max-labels", "8", "--log-interval", "1", "--seed", "0", "--eval-final-only",
        "--stop_aug_last_n_epoch", "0", "--device", "cpu", *extra])


def _config(path, src, **lines):
    """A copy of ``src`` with each ``dict[key] = value`` line appended."""
    with open(src) as f:
        text = f.read()
    for target, value in lines.items():
        block, key = target.split("__")
        text += f"\n{block}[{key!r}] = {value!r}"
    with open(path, "w") as f:
        f.write(text + "\n")
    return path


@pytest.fixture(scope="module")
def repopt_run(tmp_path_factory):
    """The tiny set, and the hyper-search and RepOpt stages' last checkpoints."""
    from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset

    root = tmp_path_factory.mktemp("qat")
    data = generate_synth_dataset(str(root / "set"), n_train=8, n_val=4, img_size=64, nc=3,
                                  seed=0, sizes=[(64, 64), (80, 60), (48, 64)])
    hs = train_cli.main(_args(data, str(root), "hs", osp.join(REPOPT, "yolov6n_hs.py"),
                              "--epochs", "1"))
    scales = osp.join(hs.save_dir, "weights", "last_ckpt.pt")
    opt_conf = _config(str(root / "opt.py"), osp.join(REPOPT, "yolov6n_opt.py"),
                       model__scales=scales)
    opt = train_cli.main(_args(data, str(root), "opt", opt_conf, "--epochs", "1"))
    return dict(root=root, data=data, scales=scales,
                opt=osp.join(opt.save_dir, "weights", "last_ckpt.pt"))


def _qat_config(run, name, **lines):
    root = run["root"]
    return _config(str(root / name), QAT_CONFIG, model__pretrained=run["opt"],
                   model__scales=run["scales"], ptq__calib_output_path=str(root / name[:-3]),
                   ptq__calib_batches=2, **lines)


@pytest.fixture(scope="module")
def calibration(repopt_run):
    conf = _qat_config(repopt_run, "calib.py", ptq__sensitive_layers_skip=True,
                       ptq__sensitive_layers_list=["detect/reg_preds"])
    trainer = train_cli.main(_args(repopt_run["data"], str(repopt_run["root"]), "calib", conf,
                                   "--epochs", "1", "--quant", "--calib"))
    return trainer


def test_calib_writes_the_ranges_of_a_direct_calibrate(calibration, repopt_run):
    trainer = calibration
    path = trainer.calib_path
    assert path == osp.join(str(repopt_run["root"]), "calib", "calib_ckpt.pt")
    assert trainer.warmup_stepnum == 0 and not trainer.epoch_stats  # it trained nothing
    state, amax = read_state_dict(path, with_quant=True)
    assert sorted(load_checkpoint(path)) == ["model"]
    # the pretrained RepOpt weights, calibrated in eval mode on two train batches
    want = calibrate(trainer.model, (b[0] for b in trainer.train_loader), max_batches=2,
                     skip_patterns=["detect/reg_preds"])
    paths = set(quant_paths(trainer.model).values())
    skipped = {p for p in paths if "detect/reg_preds" in p}
    assert len(skipped) == 3 and set(amax) == set(want) == paths - skipped
    for key, value in want.items():
        assert float(value) > 0 and torch.equal(amax[key], value.cpu()), key
    # every conv weight quantised, the skipped convs' too
    qstate = quantize_variables(trainer.model.state_dict(), trainer.model, 8)
    assert set(state) == set(qstate)
    for key, value in qstate.items():
        assert torch.equal(state[key], value), key
    moved = [k for k, v in trainer.model.state_dict().items() if not torch.equal(v, state[k])]
    assert any("reg_preds" in k for k in moved) and len(moved) > 40


def test_qat_trains_one_epoch_from_the_calibration(calibration, repopt_run, monkeypatch):
    calib_path = calibration.calib_path
    calib_state, calib_amax = read_state_dict(calib_path, with_quant=True)
    # the calibration left detect/reg_preds unranged: QAT skips them too
    conf = _qat_config(repopt_run, "qat.py", qat__calib_pt=calib_path,
                       qat__sensitive_layers_skip=True,
                       qat__sensitive_layers_list=["detect/reg_preds"])
    calls = {"train": 0, "eval": 0}
    phase = {"now": "train"}
    real_fake_quant = quant_state.fake_quant

    def counting(x, amax, num_bits=8):
        calls[phase["now"]] += 1
        return real_fake_quant(x, amax, num_bits)

    real_eval = Trainer.eval_model

    def eval_model(self):
        phase["now"] = "eval"
        real_eval(self)
        phase["now"] = "train"

    monkeypatch.setattr(quant_state, "fake_quant", counting)
    monkeypatch.setattr(Trainer, "eval_model", eval_model)
    args = _args(repopt_run["data"], str(repopt_run["root"]), "qat", conf, "--epochs", "1",
                 "--quant", "--save_ckpt_on_last_n_epoch", "1")
    cfg = train_cli.check_and_init(args)
    trainer = Trainer(args, cfg)
    assert trainer.warmup_stepnum == 0 and trainer.train_step._mask is not None
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(value, calib_state[key]), key  # the calibration's, not pretrained's
    trainer.train()
    n_convs = len(calib_amax)
    assert calls["train"] == 2 * n_convs  # 2 steps, every ranged conv
    assert calls["eval"] == n_convs  # the 4 val images in one batch
    assert len(trainer.eval_stats) == 1 and trainer.epoch_stats[0]["steps"] == 2
    assert all(v == v for v in trainer.epoch_stats[0]["mean_loss"])
    for key, value in trainer.train_step.quant["amax"].items():
        assert torch.equal(value, calib_amax[key]), key
    weights = osp.join(trainer.save_dir, "weights")
    full = load_checkpoint(osp.join(weights, "0_ckpt.pt"))
    for entry in ("model", "ema"):
        ranges = full[entry]["quant"]
        assert set(ranges) == set(calib_amax)
        assert all(torch.equal(ranges[k], calib_amax[k]) for k in ranges)
    stripped, ranges = read_state_dict(osp.join(weights, "last_ckpt.pt"), with_quant=True)
    assert set(ranges) == set(calib_amax)
    assert all(torch.equal(ranges[k], calib_amax[k]) for k in ranges)
    model = load_state_dict_file(osp.join(weights, "last_ckpt.pt"), Config.fromfile(conf),
                                 device="cpu")
    assert set(model.quant_ranges) == set(calib_amax)
    assert all(not m._forward_pre_hooks for m in model.modules())


def test_qat_calibration_file_errors(repopt_run, calibration, tmp_path):
    data, out = repopt_run["data"], str(tmp_path)
    # QAT without the skips that left detect/reg_preds unranged
    conf = _qat_config(repopt_run, "unranged.py", qat__calib_pt=calibration.calib_path)
    with pytest.raises(KeyError, match="no calibrated range for 3 convs"):
        train_cli.main(_args(data, out, "u", conf, "--epochs", "1", "--quant"))
    conf = _qat_config(repopt_run, "no_calib.py", qat__calib_pt="")
    with pytest.raises(ValueError, match="cfg.qat.calib_pt"):
        train_cli.main(_args(data, out, "a", conf, "--epochs", "1", "--quant"))
    conf = _qat_config(repopt_run, "msgpack.py")  # the config's weights/yolov6n_opt_calib.msgpack
    with pytest.raises(ValueError, match="msgpack.*calib_ckpt.pt"):
        train_cli.main(_args(data, out, "b", conf, "--epochs", "1", "--quant"))
    conf = _qat_config(repopt_run, "float.py", qat__calib_pt=repopt_run["opt"])
    with pytest.raises(ValueError, match="no calibrated ranges"):
        train_cli.main(_args(data, out, "c", conf, "--epochs", "1", "--quant"))


@pytest.mark.parametrize("flags", [("quant",), ("calib",), ("quant", "calib")])
def test_check_supported_takes_the_quant_flags(flags):
    args = train_cli.get_args_parser().parse_args([f"--{f}" for f in flags])
    check_supported(args, Config.fromfile(QAT_CONFIG))
    assert engine.check_supported is check_supported


def test_quantize_cli_file_reads_back_and_serves_in_float(repopt_run, tmp_path):
    out = str(tmp_path / "n_ptq8.pt")
    args = quantize_cli.get_args_parser().parse_args([
        "--weights", repopt_run["opt"], "--config", QAT_CONFIG, "--data", repopt_run["data"],
        "--img-size", "64", "--batch-size", "4", "--calib-batches", "2", "--skip-layers",
        "detect/stems", "--output", out, "--eval", "--device", "cpu"])
    path, amax, results = quantize_cli.main(args)
    assert path == out and results is not None and all(0 <= r <= 1 for r in results)
    ckpt = load_checkpoint(path)
    assert sorted(ckpt) == ["model", "quant_bits"] and ckpt["quant_bits"] == 8
    state, ranges = read_state_dict(path, with_quant=True)
    assert "quant" not in state and set(ranges) == set(amax)
    assert not any("detect/stems" in k for k in ranges) and len(ranges) > 40
    float_model = load_state_dict_file(repopt_run["opt"], Config.fromfile(QAT_CONFIG),
                                       device="cpu")
    fstate = float_model.state_dict()
    for key, value in state.items():
        same = torch.equal(value, fstate[key])
        assert same == (value.dim() != 4 or key.startswith("detect.stems.")), key
    # the eval CLI serves the PTQ file in float: ranges attached, not enabled
    model = load_state_dict_file(path, Config.fromfile(QAT_CONFIG), device="cpu")
    assert set(model.quant_ranges) == set(ranges)
    (ap50, ap), rows = eval_cli.run(repopt_run["data"], model=model, batch_size=4, img_size=64,
                                    task="val", save_dir=str(tmp_path / "val"), device="cpu")
    assert all(not m._forward_pre_hooks for m in model.modules())
    (ap50_f, ap_f), rows_f = eval_cli.run(repopt_run["data"], weights=path, config=QAT_CONFIG,
                                          batch_size=4, img_size=64, task="val",
                                          save_dir=str(tmp_path / "val2"), device="cpu")
    assert rows == rows_f and (ap50, ap) == (ap50_f, ap_f)
    save_checkpoint({"model": dict(state, quant={"a/b": torch.ones(2)})}, False, str(tmp_path),
                    "bad")
    with pytest.raises(ValueError, match="scalar ranges"):
        read_state_dict(str(tmp_path / "bad.pt"))
