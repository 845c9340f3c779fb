"""Export backends of the port (port of yolov6_tpu/export/): the ``.pt2``
serving artifact lives in models/end2end.py; here the dependency-free ONNX
writer and its numpy interpreter, INT8 QDQ, TorchScript and NCNN."""
