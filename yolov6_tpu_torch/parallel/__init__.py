"""Data parallelism over torch.distributed (port of yolov6_tpu/parallel/)."""
