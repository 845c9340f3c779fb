"""Shared helpers for the PyTorch port's tests. Imports no JAX at module level,
so the tests that need the card can use it where JAX is absent."""

import os

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S_CONFIG = os.path.join(REPO_ROOT, "configs", "yolov6s.py")


def small_s_config(config_cls):
    """configs/yolov6s.py cut to test size: depth 0.1, width 0.125. It keeps
    every block of the S graph, and stage 4's RepBlock keeps 2 blocks."""
    cfg = config_cls.fromfile(S_CONFIG)
    cfg.model.depth_multiple = 0.1
    cfg.model.width_multiple = 0.125
    return cfg


def random_jax_variables(shapes, seed: int):
    """Overwrite every leaf of a flax variables pytree (arrays or
    ShapeDtypeStructs) with seeded numpy values.

    Conv kernels are He-normal, so activations stay O(1) through the deep
    graph. The head's class and box predictions, zero-initialised in the
    model, get small weights; their biases are spread so scores differ per
    class and box distances stay positive."""
    import jax

    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        shape = tuple(leaf.shape)
        owner = names[-2] if len(names) > 1 else ""
        if names[-1] == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            std = np.sqrt(2.0 / fan_in)
            if owner.startswith(("cls_preds", "reg_preds")):
                std = 0.3 / np.sqrt(fan_in)
            return (rng.standard_normal(shape) * std).astype(np.float32)
        if owner.startswith("cls_preds"):
            return rng.uniform(-4.0, 1.0, shape).astype(np.float32)
        if owner.startswith("reg_preds"):
            return rng.uniform(1.0, 3.0, shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def clustered_candidates(seed, B, K, n_clusters=12, n_cls=3, zero_area=0):
    """Class-offset candidate boxes in overlapping clusters, so that many
    steps really suppress; scores are 0 below a conf of 0.2. ``zero_area``
    boxes of each image are made degenerate (x2 == x1)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(50, 600, (B, n_clusters, 2))
    which = rng.integers(0, n_clusters, (B, K))
    c = np.take_along_axis(centers, which[..., None], 1) + rng.normal(0, 10, (B, K, 2))
    wh = rng.uniform(20, 90, (B, K, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    boxes[:, :zero_area, 2] = boxes[:, :zero_area, 0]
    boxes += (rng.integers(0, n_cls, (B, K)) * 4096.0)[..., None]
    scores = rng.uniform(0, 1, (B, K))
    scores[scores < 0.2] = 0.0
    return boxes.astype(np.float32), scores.astype(np.float32)
