"""INT8 fake quantisation, PTQ calibration and QAT (port of yolov6_tpu/quant/,
without the ONNX-level PTQ and QDQ export)."""

from yolov6_tpu_torch.quant.fake_quant import (  # noqa: F401
    fake_quant,
    fake_quant_per_channel,
    jax_path,
    quantize_conv_weights,
)
from yolov6_tpu_torch.quant.state import quant_mode, quant_paths  # noqa: F401
