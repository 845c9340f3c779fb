"""The port's distill-NS training step (N/S self-distillation, with the
channel-wise KD) against the JAX package's jitted ``make_train_step(...,
teacher=...)``, on the CPU in fp32.

Small S (depth 0.1, width 0.125, 3 classes) with DFL switched on
(``use_dfl=True``, ``reg_max=16``), as the recipe trains it: the student
has the distill-NS head, the teacher the fuse-AB head, each with its own
seeded train variables; ``ComputeLossDistillNS`` with ``distill_feat``,
temperature 20, ``max_epoch`` 10. b2@64 on the accumulation branch
(batch_size 32). One applied step at epoch 1 of 10 (the KD decay 0.976),
with the comparison and tolerances of
test_torch_train_step.py::check_mid_schedule_step (loss and the four
components rtol 1e-4 / atol 1e-6; each parameter's change and each momentum
buffer within 1e-3 of the JAX leaf's largest magnitude plus a floor for
fp32 noise), then the EMA within 1e-4 + 1e-6; the teacher's weights and BN
statistics do not move.

The floor: the class KD (times T² = 400) and the channel-wise KD make this
step's gradients 34 times the plain S step's (largest momentum 12.8
against 0.38), and the rounding noise with them. The two transposed convs'
biases, whose exact gradient is 0 (a 1x1 conv and a BN follow them), read
8.9e-8 and 1.1e-7 in the JAX step and 1.8e-7 and 1.4e-7 off them in the
port's, above the plain step's 1e-7 floor; every other of the 416 leaf
checks sat within 0.71 of its bound. So the floor is one fp32 ulp of the
step's largest gradient (``floor_scales_with_grad``), 1.5e-6 here. A file
of its own, so that its JAX compile runs on a worker of its own.
"""

import jax
import jax.numpy as jnp
import torch

from test_torch_train_step import (
    EPOCHS, IMG, NC, S_SOLVER, check_ema_against_jax, check_mid_schedule_step,
)

from yolov6_tpu.core.train_step import make_train_step as jax_make_train_step
from yolov6_tpu.losses.loss_distill_ns import ComputeLossDistillNS as JaxLossDistillNS
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.solver.build import build_param_groups
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.core.train_step import make_train_step
from yolov6_tpu_torch.losses.loss_distill_ns import ComputeLossDistillNS
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.solver.build import scale_hyperparams_for_batch
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import random_jax_variables, small_s_config

BATCH_SIZE = 32
DISTILL_KW = dict(num_classes=NC, ori_img_size=IMG, warmup_epoch=0, use_dfl=True, reg_max=16,
                  iou_type="giou", distill_feat=True, max_epoch=EPOCHS, temperature=20)


def _dfl_config(config_cls):
    cfg = small_s_config(config_cls)
    cfg.model.head.use_dfl, cfg.model.head.reg_max = True, 16
    return cfg


def _jax_variables(jmodel, seed):
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    return random_jax_variables(shapes, seed=seed)


def test_train_step_matches_jax_distill_ns_with_feature_kd():
    jmodel = jax_build_model(_dfl_config(JaxConfig), num_classes=NC, distill_ns=True,
                             deploy=False)
    jteacher = jax_build_model(_dfl_config(JaxConfig), num_classes=NC, fuse_ab=True,
                               deploy=False)
    variables, t_variables = _jax_variables(jmodel, 81), _jax_variables(jteacher, 82)
    solver = scale_hyperparams_for_batch(S_SOLVER, BATCH_SIZE)
    jstep = jax_make_train_step(
        jmodel, None, build_param_groups(variables["params"]), solver, max_stepnum=100,
        epochs=EPOCHS, batch_size=BATCH_SIZE, warmup_stepnum=0, img_size=(IMG, IMG),
        teacher=(jteacher, t_variables, JaxLossDistillNS(**DISTILL_KW)))

    teacher = build_model(_dfl_config(Config), num_classes=NC, deploy=False, device="cpu",
                          fuse_ab=True)
    teacher.load_state_dict(state_dict_from_jax(t_variables), strict=True)
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}

    def port_step():
        model = build_model(_dfl_config(Config), num_classes=NC, deploy=False, device="cpu",
                            distill_ns=True)
        model.load_state_dict(state_dict_from_jax(variables), strict=True)
        return make_train_step(model, None, solver, 100, EPOCHS, BATCH_SIZE, 0, (IMG, IMG),
                               half=False, device="cpu",
                               teacher=(teacher, ComputeLossDistillNS(**DISTILL_KW)))

    step, jstate = check_mid_schedule_step(jstep, variables, BATCH_SIZE, 0, port_step=port_step,
                                           floor_scales_with_grad=True)
    assert any(n.startswith("detect.reg_preds_dist.") for n in step.momentum)
    check_ema_against_jax(step, jstate, "distill-NS")
    assert not teacher.training
    for key, value in teacher.state_dict().items():
        assert torch.equal(value, t_before[key]), key
