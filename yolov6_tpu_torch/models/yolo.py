"""Detector assembly (port of yolov6_tpu/models/yolo.py:29-166), P5 non-lite
rep graph (EfficientRep + RepBiFPANNeck + Detect without DFL), in the deploy
or the train form."""

from __future__ import annotations

import math

from torch import nn

from yolov6_tpu_torch.layers.common import get_block
from yolov6_tpu_torch.models import efficientrep as _efficientrep  # noqa: F401 (registry)
from yolov6_tpu_torch.models import reppan as _reppan  # noqa: F401 (registry)
from yolov6_tpu_torch.models.effidehead import Detect, decode_eval
from yolov6_tpu_torch.utils.device import resolve_device
from yolov6_tpu_torch.utils.registry import BACKBONES, NECKS


def make_divisible(x, divisor=8):
    """Reference yolo.py:50-52 (ceil variant, used by the P5/P6 families)."""
    return math.ceil(x / divisor) * divisor


class Model(nn.Module):
    """backbone -> neck -> head; ``forward`` returns ``(head_out, neck_feats)``."""

    def __init__(self, backbone: nn.Module, neck: nn.Module, detect: Detect,
                 num_classes: int):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.detect = detect
        self.num_classes = num_classes

    @property
    def strides(self):
        return self.detect.strides

    def forward(self, x):
        neck_feats = self.neck(self.backbone(x))
        return self.detect(neck_feats), neck_feats

    def decode(self, head_out):
        """Raw head maps -> ``[b, A, 5+nc]`` predictions (eval branch)."""
        return decode_eval(head_out, self.num_classes, self.strides)


def build_model(cfg, num_classes: int, deploy: bool = True, device="cuda") -> Model:
    """Construct the detector from a config on ``device`` (reference:
    yolo.py:55-138): the deploy graph in eval mode, or with ``deploy=False``
    the train graph (BN, RepVGG's three branches) in train mode. Raises on
    parts of the model zoo not ported yet."""
    device = resolve_device(device)
    mcfg = cfg.model
    if mcfg.head.use_dfl or mcfg.head.num_layers != 3:
        raise NotImplementedError(
            "only the 3-level head without DFL is ported; DFL comes with the M/L slice")
    num_repeat = [
        (max(round(i * mcfg.depth_multiple), 1) if i > 1 else i)
        for i in (list(mcfg.backbone.num_repeats) + list(mcfg.neck.num_repeats))
    ]
    channels_list = [
        make_divisible(i * mcfg.width_multiple, 8)
        for i in (list(mcfg.backbone.out_channels) + list(mcfg.neck.out_channels))
    ]
    block = get_block(cfg.get("training_mode", "repvgg"))
    backbone = BACKBONES.get(mcfg.backbone.type)(
        channels_list, num_repeat, block=block,
        fuse_P2=bool(mcfg.backbone.get("fuse_P2")),
        cspsppf=bool(mcfg.backbone.get("cspsppf")), deploy=deploy,
    )
    neck = NECKS.get(mcfg.neck.type)(channels_list, num_repeat, block=block, deploy=deploy)
    detect = Detect((channels_list[6], channels_list[8], channels_list[10]),
                    num_classes=num_classes, reg_max=mcfg.head.reg_max, deploy=deploy)
    model = Model(backbone, neck, detect, num_classes).to(device)
    return model.eval() if deploy else model.train()
