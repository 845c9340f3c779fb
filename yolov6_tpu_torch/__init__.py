"""PyTorch port of yolov6_tpu for NVIDIA Hopper GPUs.

A second package beside the JAX one, with the same module layout and names.
It imports torch and numpy only, never jax, flax, cv2 or yolov6_tpu. Models
compute in NCHW; public functions keep the JAX package's layouts (NHWC
images, [b, A, 5+nc] predictions, fixed-shape detections with a valid mask).
Every entry point takes ``device`` (default ``"cuda"``) and raises when CUDA
is asked for and absent.
"""
