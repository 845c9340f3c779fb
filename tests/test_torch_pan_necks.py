"""The port's concat PAN necks (RepPANNeck, CSPRepPANNeck, RepPANNeck6,
CSPRepPANNeck_P6) and the configs that use them (configs/experiment/
yolov6t.py, yolov6t_finetune.py, yolov6s_csp_scaled.py, yolov6t_csp_scaled.py)
against the JAX package, on the CPU in fp32.

- Each neck alone, at small widths with stages of 2 blocks (the CSP necks'
  BepC3 with its BottleRep alphas): the deploy form's output; the train
  form in train mode (outputs and updated BN statistics), then eval mode;
  rtol 1e-4 / atol 1e-5, the S tests' block tolerance.
- Whole graphs at 64 px (P6: 128, so that stride 64 has a 2x2 grid): small
  yolov6t and yolov6s_csp_scaled (depth 0.1, width 0.125), and small N6 with
  its neck swapped for each P6 PAN neck and ``fuse_P2`` off (no shipped
  config uses them): the deploy head maps (the same tolerance) and the fold
  of the train form, which loads with strict=True into the deploy graph and
  equals the train form's eval forward.
- The full experiment configs' deploy parameter counts equal the JAX
  package's (its variables' shapes by ``jax.eval_shape``) at 320 px.
- yolov6t trains one epoch through the port's Trainer and its checkpoint
  evaluates through ``tools/eval.py``.
"""

import functools
import os
import os.path as osp

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.layers import common as jcommon
from yolov6_tpu.models import reppan as jreppan
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.layers.reparam import fold_to_deploy
from yolov6_tpu_torch.models import reppan as treppan
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_csp_model import _nchw, _nhwc, _stats_close
from torch_port_utils import P6_CONFIGS, REPO_ROOT, random_jax_variables, small_config

TOL = dict(rtol=1e-4, atol=1e-5)
NC = 3
EXPERIMENT = {k: osp.join(REPO_ROOT, "configs", "experiment", f"{k}.py")
              for k in ("yolov6t", "yolov6t_finetune", "yolov6s_csp_scaled",
                        "yolov6t_csp_scaled")}
# deploy parameter counts of the JAX package's graphs, 80 classes, 320 px
DEPLOY_PARAMS = {"yolov6t": 9_695_532, "yolov6t_finetune": 9_695_532,
                 "yolov6s_csp_scaled": 11_493_210, "yolov6t_csp_scaled": 10_662_804}
# (backbone widths + neck widths, repeats, input maps (h, width) low to high level)
P5_NECK = ([8, 16, 16, 24, 32, 16, 8, 8, 16, 16, 24], [1, 2, 2, 2, 2, 2, 2, 2, 2],
           [(16, 16), (8, 24), (4, 32)])
P6_NECK = ([8, 16, 16, 24, 32, 40, 24, 16, 8, 16, 24, 32], [1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2],
           [(16, 16), (8, 24), (4, 32), (2, 40)])
NECKS = {"RepPANNeck": P5_NECK, "CSPRepPANNeck": P5_NECK, "RepPANNeck6": P6_NECK,
         "CSPRepPANNeck_P6": P6_NECK}


@pytest.mark.parametrize("form", ["deploy", "train"])
@pytest.mark.parametrize("name", list(NECKS))
def test_pan_neck_matches_jax(name, form):
    channels, repeats, maps = NECKS[name]
    deploy = form == "deploy"
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((2, h, h, c)).astype(np.float32) for h, c in maps]
    jneck = getattr(jreppan, name)(channels_list=channels, num_repeats=repeats,
                                   block=jcommon.RepVGGBlock, deploy=deploy)
    shapes = jax.eval_shape(lambda: jneck.init(jax.random.PRNGKey(0),
                                               [jnp.asarray(x) for x in xs]))
    variables = random_jax_variables(shapes, seed=4)
    neck = getattr(treppan, name)(channels, repeats, deploy=deploy)
    neck.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert any(k.endswith(".alpha") for k in neck.state_dict()) == name.startswith("CSP")
    inputs = [jnp.asarray(x) for x in xs]
    if not deploy:
        want, updates = jax.jit(lambda v, a: jneck.apply(v, a, train=True, mutable=[
            "batch_stats"]))(variables, inputs)
        neck.train()
        with torch.no_grad():
            got = neck([_nchw(x) for x in xs])
        for g, w in zip(got, want, strict=True):
            np.testing.assert_allclose(_nhwc(g), np.asarray(w), **TOL)
        _stats_close(neck, updates["batch_stats"])
        neck.load_state_dict(state_dict_from_jax(variables), strict=True)
    neck.eval()
    with torch.no_grad():
        got = neck([_nchw(x) for x in xs])
    want = jax.jit(lambda v, a: jneck.apply(v, a, train=False))(variables, inputs)
    assert len(got) == len(maps)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), **TOL)


def _small(config_cls, name):
    """Small yolov6t / yolov6s_csp_scaled at 64 px, or small N6 at 128 px (a
    2x2 stride-64 grid; these tests run no train-mode BN) with its neck
    swapped for a P6 PAN neck and ``fuse_P2`` off."""
    if name in EXPERIMENT:
        return small_config(config_cls, EXPERIMENT[name]), 64
    cfg = small_config(config_cls, P6_CONFIGS["n6"])
    cfg.model.neck.type = name
    cfg.model.backbone.fuse_P2 = False
    return cfg, 128


@functools.lru_cache(maxsize=None)
def _spec(name, deploy):
    cfg, img = _small(JaxConfig, name)
    jmodel = jax_build_model(cfg, num_classes=NC, deploy=deploy)
    return jmodel, jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)), train=False))


@pytest.mark.parametrize("name", ["yolov6t", "yolov6s_csp_scaled", "RepPANNeck6",
                                  "CSPRepPANNeck_P6"])
def test_small_pan_graph_deploy_and_fold_match_jax(name):
    cfg, img = _small(Config, name)
    jmodel, shapes = _spec(name, True)
    variables = random_jax_variables(shapes, seed=11)
    model = build_model(cfg, num_classes=NC, deploy=True, device="cpu")
    assert type(model.neck).__name__ == cfg.model.neck.type
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = np.random.default_rng(12).uniform(0, 1, (2, img, img, 3)).astype(np.float32)
    head_j, _ = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        head_t, _ = model(_nchw(x))
    for key in ("cls", "reg"):
        assert len(head_t[key]) == (4 if name.endswith(("6", "P6")) else 3)
        for mt, mj in zip(head_t[key], head_j[key], strict=True):
            np.testing.assert_allclose(_nhwc(mt), np.asarray(mj), **TOL)

    train = build_model(cfg, num_classes=NC, deploy=False, device="cpu")
    train.load_state_dict(state_dict_from_jax(random_jax_variables(_spec(name, False)[1], 13)),
                          strict=True)
    model.load_state_dict(fold_to_deploy(train.state_dict(), model), strict=True)
    train.eval()
    with torch.no_grad():
        want, _ = train(_nchw(x))
        got, _ = model(_nchw(x))
    for key in ("cls", "reg"):
        for g, w in zip(got[key], want[key], strict=True):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("name", list(EXPERIMENT))
def test_experiment_config_parameter_count_matches_jax(name):
    """Full width, built and not run: the deploy count equals the JAX
    package's (and the table kept here); the train graph folds into the
    deploy graph with strict=True."""
    jmodel = jax_build_model(JaxConfig.fromfile(EXPERIMENT[name]), num_classes=80, deploy=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 320, 320, 3)), train=False))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    cfg = Config.fromfile(EXPERIMENT[name])
    deploy = build_model(cfg, num_classes=80, deploy=True, device="cpu")
    assert sum(p.numel() for p in deploy.parameters()) == want == DEPLOY_PARAMS[name]
    train = build_model(cfg, num_classes=80, deploy=False, device="cpu")
    deploy.load_state_dict(fold_to_deploy(train.state_dict(), deploy), strict=True)


def test_yolov6t_trains_through_the_trainer_and_evaluates(tmp_path):
    """configs/experiment/yolov6t.py (SIoU, the PAN neck) at full width for one
    epoch of 2 steps on 8 PNG images at 64 px, then its stripped checkpoint
    through the eval CLI's ``run``."""
    from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset
    from yolov6_tpu_torch.tools import eval as eval_cli
    from yolov6_tpu_torch.tools import train as train_cli

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        data = generate_synth_dataset(str(tmp_path / "set"), n_train=8, n_val=4, img_size=64,
                                      nc=NC, seed=0)
        args = train_cli.get_args_parser().parse_args([
            "--data-path", data, "--conf-file", EXPERIMENT["yolov6t"], "--img-size", "64",
            "--img-floor", "64", "--batch-size", "4", "--workers", "1", "--epochs", "1",
            "--output-dir", str(tmp_path / "runs"), "--name", "t", "--max-labels", "8",
            "--seed", "0", "--device", "cpu"])
        trainer = train_cli.main(args)
        assert type(trainer.model.neck).__name__ == "RepPANNeck"
        assert trainer.epoch_stats[0]["steps"] == 2
        assert all(np.isfinite(trainer.epoch_stats[0]["mean_loss"]))
        (ap50, ap), _ = eval_cli.run(
            data=data, weights=osp.join(args.save_dir, "weights", "last_ckpt.pt"),
            config=EXPERIMENT["yolov6t"], batch_size=4, img_size=64, task="val",
            save_dir=str(tmp_path / "eval"), device="cpu")
        assert 0.0 <= ap50 <= 1.0 and 0.0 <= ap <= 1.0
    finally:
        torch.set_num_threads(threads)
    assert os.path.exists(osp.join(args.save_dir, "weights", "best_ckpt.pt"))
