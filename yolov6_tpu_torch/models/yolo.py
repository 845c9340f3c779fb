"""Detector assembly (port of yolov6_tpu/models/yolo.py:29-193): the P5 and
P6 non-lite graphs (EfficientRep + RepBiFPANNeck for N/S, CSPBepBackbone +
CSPRepBiFPANNeck for M/L and the MBLA configs, EfficientRep6 +
RepBiFPANNeck6 for N6/S6, CSPBepBackbone_P6 + CSPRepBiFPANNeck_P6 for
M6/L6; Detect with or without DFL, or the fuse-AB and distill-NS heads of
the training recipes), of RepVGG, QARepVGG (V1, V2) or ConvBN blocks, and the
lite family (Lite_EffiBackbone + Lite_EffiNeck + DetectLite), in the deploy
or the train form."""

from __future__ import annotations

import math

from torch import nn

from yolov6_tpu_torch.layers.common import get_block
from yolov6_tpu_torch.models import efficientrep as _efficientrep  # noqa: F401 (registry)
from yolov6_tpu_torch.models import reppan as _reppan  # noqa: F401 (registry)
from yolov6_tpu_torch.models.effidehead import Detect, decode_eval
from yolov6_tpu_torch.models.heads.effidehead_distill_ns import DetectDistillNS
from yolov6_tpu_torch.models.heads.effidehead_fuseab import DetectFuseAB
from yolov6_tpu_torch.models.heads.effidehead_lite import DetectLite
from yolov6_tpu_torch.utils.device import resolve_device
from yolov6_tpu_torch.utils.registry import BACKBONES, NECKS


def make_divisible(x, divisor=8):
    """Reference yolo.py:50-52 (ceil variant, used by the P5/P6 families)."""
    return math.ceil(x / divisor) * divisor


def make_divisible_lite(v, divisor=16):
    """Reference yolo_lite.py:84-88 (JAX: yolo.py:34-39): round to the
    nearest multiple of ``divisor``, at least ``divisor``, bumped up once
    more when that loses over 10% of ``v``."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


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
    ``Detect``'s deploy graph. A 4-level head (P6) reads the neck's last four
    widths and strides 8-64. Raises ``ValueError`` for ``distill_ns`` on a
    P6 config and for ``fuse_ab`` on a config without ``head.anchors_init``
    (the JAX package builds neither). The block mode is the config's
    ``training_mode`` (``get_block``: RepOpt's modes raise
    ``NotImplementedError``). A lite config (``Lite_EffiBackbone``) builds
    the lite graph (``_build_lite``), and raises ``ValueError`` with
    ``fuse_ab`` or ``distill_ns``: the lite family has neither recipe, and
    the JAX package builds the plain lite network whatever they say."""
    device = resolve_device(device)
    mcfg = cfg.model
    if mcfg.backbone.type == "Lite_EffiBackbone":
        if fuse_ab or distill_ns:
            raise ValueError(f"{mcfg.type}: the lite family has no fuse-AB or distillation "
                             "head (its configs train the plain lite network)")
        model = _build_lite(mcfg, num_classes, deploy).to(device)
        return model.eval() if deploy else model.train()
    num_layers = mcfg.head.num_layers
    if num_layers not in (3, 4):
        raise ValueError(f"head.num_layers {num_layers}: the graphs have 3 (P5) or 4 (P6)")
    if distill_ns and num_layers != 3:
        raise ValueError("distill_ns head only supports 3-layer (P5) models")
    if fuse_ab and not mcfg.head.get("anchors_init"):
        raise ValueError(f"fuse_ab needs head.anchors_init, which {mcfg.type} does not set")
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
    # the neck's outputs: every other width of the P5 neck, the last four of the P6 one
    in_channels = (tuple(channels_list[6:11:2]) if num_layers == 3
                   else tuple(channels_list[8:12]))
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


def _build_lite(mcfg, num_classes: int, deploy: bool) -> Model:
    """The lite graph (JAX: yolo.py:169-193): stage widths
    ``make_divisible_lite(out * width_multiple)``, mid widths
    ``make_divisible_lite(int(out * scale_size), 8)`` of those, one head
    width (``neck.unified_channels``), no DFL."""
    out_channels = [make_divisible_lite(i * mcfg.width_multiple)
                    for i in mcfg.backbone.out_channels]
    mid_channels = [make_divisible_lite(int(i * mcfg.backbone.scale_size), divisor=8)
                    for i in out_channels]
    backbone = BACKBONES.get(mcfg.backbone.type)(3, mid_channels, out_channels,
                                                 tuple(mcfg.backbone.num_repeats), deploy=deploy)
    uc = mcfg.neck.unified_channels
    neck = NECKS.get(mcfg.neck.type)(out_channels[2:], uc, deploy=deploy)
    detect = DetectLite((uc,) * mcfg.head.num_layers, num_classes, deploy=deploy)
    return Model(backbone, neck, detect, num_classes, use_dfl=False, reg_max=0)
