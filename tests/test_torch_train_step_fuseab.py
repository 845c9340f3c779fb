"""The port's fuse-AB (anchor-aided) training step against the JAX package's
jitted ``make_train_step(..., compute_loss_ab=...)``, on the CPU in fp32.

Small S (depth 0.1, width 0.125, 3 classes, the S config as shipped: GIoU,
no DFL, TAL) with the fuse-AB head, seeded train variables on both sides,
b2@64 on the accumulation branch (batch_size 32). One applied step at epoch
1 of 10, with the comparison and tolerances of
test_torch_train_step.py::check_mid_schedule_step: loss and components (the
anchor-free plus the anchor-based) rtol 1e-4 / atol 1e-6; each parameter's
change and each momentum buffer within 1e-3 of the JAX leaf's largest
magnitude + 1e-7 (× LR for the change, + 2 ulp); then the EMA within 1e-4
of each leaf's largest magnitude + 1e-6. A file of its own, so that its JAX
compile (about 80-100 s on one core) runs on a worker of its own.
"""

import jax
import jax.numpy as jnp

from test_torch_train_step import (
    EPOCHS, IMG, LOSS_KW, NC, S_SOLVER, check_ema_against_jax, check_mid_schedule_step,
)

from yolov6_tpu.core.train_step import make_train_step as jax_make_train_step
from yolov6_tpu.losses.loss import ComputeLoss as JaxComputeLoss
from yolov6_tpu.losses.loss_fuseab import ComputeLossAB as JaxComputeLossAB
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.solver.build import build_param_groups
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.core.train_step import make_train_step
from yolov6_tpu_torch.losses.loss import ComputeLoss
from yolov6_tpu_torch.losses.loss_fuseab import ComputeLossAB
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.solver.build import scale_hyperparams_for_batch
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import random_jax_variables, small_s_config

BATCH_SIZE = 32


def test_train_step_matches_jax_fuse_ab():
    jmodel = jax_build_model(small_s_config(JaxConfig), num_classes=NC, fuse_ab=True,
                             deploy=False)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    variables = random_jax_variables(shapes, seed=71)
    anchors_init = tuple(map(tuple, small_s_config(Config).model.head.anchors_init))
    ab_kw = dict(num_classes=NC, ori_img_size=IMG, iou_type="giou", anchors_init=anchors_init)
    solver = scale_hyperparams_for_batch(S_SOLVER, BATCH_SIZE)
    jstep = jax_make_train_step(
        jmodel, JaxComputeLoss(**LOSS_KW), build_param_groups(variables["params"]), solver,
        max_stepnum=100, epochs=EPOCHS, batch_size=BATCH_SIZE, warmup_stepnum=0,
        img_size=(IMG, IMG), compute_loss_ab=JaxComputeLossAB(**ab_kw))

    def port_step():
        model = build_model(small_s_config(Config), num_classes=NC, deploy=False, device="cpu",
                            fuse_ab=True)
        model.load_state_dict(state_dict_from_jax(variables), strict=True)
        return make_train_step(model, ComputeLoss(**LOSS_KW), solver, 100, EPOCHS, BATCH_SIZE,
                               0, (IMG, IMG), half=False, device="cpu",
                               compute_loss_ab=ComputeLossAB(**ab_kw))

    step, jstate = check_mid_schedule_step(jstep, variables, BATCH_SIZE, 0, port_step=port_step)
    assert any(n.startswith("detect.cls_preds_ab.") for n in step.momentum)
    check_ema_against_jax(step, jstate, "fuse-AB")
