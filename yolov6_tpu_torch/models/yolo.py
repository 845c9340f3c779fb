"""Detector assembly (port of yolov6_tpu/models/yolo.py:29-166): the P5
non-lite graphs (EfficientRep + RepBiFPANNeck for N/S, CSPBepBackbone +
CSPRepBiFPANNeck for M/L, Detect with or without DFL, or the fuse-AB and
distill-NS heads of the training recipes), in the deploy or the train form."""

from __future__ import annotations

import math

from torch import nn

from yolov6_tpu_torch.layers.common import get_block
from yolov6_tpu_torch.models import efficientrep as _efficientrep  # noqa: F401 (registry)
from yolov6_tpu_torch.models import reppan as _reppan  # noqa: F401 (registry)
from yolov6_tpu_torch.models.effidehead import Detect, decode_eval
from yolov6_tpu_torch.models.heads.effidehead_distill_ns import DetectDistillNS
from yolov6_tpu_torch.models.heads.effidehead_fuseab import DetectFuseAB
from yolov6_tpu_torch.utils.device import resolve_device
from yolov6_tpu_torch.utils.registry import BACKBONES, NECKS


def make_divisible(x, divisor=8):
    """Reference yolo.py:50-52 (ceil variant, used by the P5/P6 families)."""
    return math.ceil(x / divisor) * divisor


class Model(nn.Module):
    """backbone -> neck -> head; ``forward`` returns ``(head_out, neck_feats)``."""

    def __init__(self, backbone: nn.Module, neck: nn.Module, detect: Detect,
                 num_classes: int, use_dfl: bool = False, reg_max: int = 0):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.detect = detect
        self.num_classes = num_classes
        self.use_dfl = use_dfl
        self.reg_max = reg_max

    @property
    def strides(self):
        return self.detect.strides

    def forward(self, x):
        neck_feats = self.neck(self.backbone(x))
        return self.detect(neck_feats), neck_feats

    def decode(self, head_out):
        """Raw head maps -> ``[b, A, 5+nc]`` predictions (eval branch)."""
        return decode_eval(head_out, self.num_classes, self.strides, self.use_dfl, self.reg_max)


def build_model(cfg, num_classes: int, deploy: bool = True, device="cuda",
                fuse_ab: bool = False, distill_ns: bool = False) -> Model:
    """Construct the detector from a config on ``device`` (reference:
    yolo.py:55-138; JAX yolo.py:135-165): the deploy graph in eval mode, or
    with ``deploy=False`` the train graph (BN, RepVGG's three branches,
    BottleRep alphas) in train mode. ``fuse_ab`` gives the head the
    anchor-based branch of anchor-aided training (``DetectFuseAB``);
    ``distill_ns`` gives it the N/S self-distillation head
    (``DetectDistillNS``), whose model decodes plain ltrb boxes
    (``use_dfl=False``, ``reg_max=0``) while the config's ``reg_max`` sizes
    the train-only DFL branch. With ``deploy=True`` either builds exactly
    ``Detect``'s deploy graph. Raises ``NotImplementedError`` on the parts
    of the model zoo not ported: P6 heads (``num_layers != 3``), the lite
    family, MBLA stages and block modes other than ``repvgg``,
    ``conv_relu`` and ``conv_silu``."""
    device = resolve_device(device)
    mcfg = cfg.model
    if mcfg.backbone.type == "Lite_EffiBackbone":
        raise NotImplementedError("the lite family (Lite_EffiBackbone, DetectLite) is not ported")
    if mcfg.head.num_layers != 3:
        raise NotImplementedError(
            f"a {mcfg.head.num_layers}-level head (P6) is not ported; the port builds the "
            "3-level P5 graphs")
    num_repeat = [
        (max(round(i * mcfg.depth_multiple), 1) if i > 1 else i)
        for i in (list(mcfg.backbone.num_repeats) + list(mcfg.neck.num_repeats))
    ]
    channels_list = [
        make_divisible(i * mcfg.width_multiple, 8)
        for i in (list(mcfg.backbone.out_channels) + list(mcfg.neck.out_channels))
    ]
    block = get_block(cfg.get("training_mode", "repvgg"))
    bb_kwargs = dict(block=block, fuse_P2=bool(mcfg.backbone.get("fuse_P2")),
                     cspsppf=bool(mcfg.backbone.get("cspsppf")), deploy=deploy)
    neck_kwargs = dict(block=block, deploy=deploy)
    if "CSP" in mcfg.backbone.type:
        stage_block_type = mcfg.backbone.get("stage_block_type", "BepC3")
        bb_kwargs.update(csp_e=mcfg.backbone.csp_e, stage_block_type=stage_block_type)
        neck_kwargs.update(csp_e=mcfg.neck.csp_e, stage_block_type=stage_block_type)
    backbone = BACKBONES.get(mcfg.backbone.type)(channels_list, num_repeat, **bb_kwargs)
    neck = NECKS.get(mcfg.neck.type)(channels_list, num_repeat, **neck_kwargs)
    in_channels = (channels_list[6], channels_list[8], channels_list[10])
    use_dfl, reg_max = bool(mcfg.head.use_dfl), mcfg.head.reg_max
    if distill_ns:
        detect = DetectDistillNS(in_channels, num_classes, reg_max=reg_max, deploy=deploy)
        # the branch that ships is plain ltrb: the decode runs no DFL
        use_dfl, reg_max = False, 0
    elif fuse_ab:
        detect = DetectFuseAB(in_channels, num_classes, reg_max=reg_max,
                              anchors_init=mcfg.head.anchors_init, deploy=deploy)
    else:
        detect = Detect(in_channels, num_classes=num_classes, reg_max=reg_max, deploy=deploy)
    model = Model(backbone, neck, detect, num_classes, use_dfl, reg_max).to(device)
    return model.eval() if deploy else model.train()
