"""Shared helpers for the PyTorch port's tests. Imports no JAX at module level,
so the tests that need the card can use it where JAX is absent."""

import os
import types

import numpy as np

# Under pytest-xdist the workers share the host's cores: torch's default of
# one intra-op thread a core puts workers x cores spinning OpenMP threads on
# them, which quadrupled the port files' CPU time (295 s of wall time for six
# files against 106 s with one thread a worker, 6 workers on 8 cores).
if os.environ.get("PYTEST_XDIST_WORKER"):
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CONFIG = os.path.join(REPO_ROOT, "configs", "yolov6n.py")
S_CONFIG = os.path.join(REPO_ROOT, "configs", "yolov6s.py")
M_CONFIG = os.path.join(REPO_ROOT, "configs", "yolov6m.py")
L_CONFIG = os.path.join(REPO_ROOT, "configs", "yolov6l.py")
# the P6 family at 1280 and the MBLA configs at 640, by short name
P6_CONFIGS = {k: os.path.join(REPO_ROOT, "configs", f"yolov6{k}.py")
              for k in ("n6", "s6", "m6", "l6")}
MBLA_CONFIGS = {k: os.path.join(REPO_ROOT, "configs", "mbla", f"yolov6{k}_mbla.py")
                for k in ("s", "m", "l", "x")}
REPLAY_CHUNK = 1000  # equations a compiled piece of ``jax_in_float64``


def _small(config_cls, path):
    cfg = config_cls.fromfile(path)
    cfg.model.depth_multiple = 0.1
    cfg.model.width_multiple = 0.125
    return cfg


def small_config(config_cls, path):
    """The config at ``path`` cut as small S is: depth 0.1, width 0.125. Cut
    so, a P6 or MBLA graph keeps every kind of block: each stage one unit
    (a RepVGG/ConvBN block, a BepC3 of one BottleRep, or an MBLABlock of one
    BottleRep3 branch), the sixth stage and the third BiFusion of P6."""
    return _small(config_cls, path)


def small_n_config(config_cls):
    """configs/yolov6n.py cut to test size: depth 0.1 and width 0.0625, half
    of small S's width as N's 0.25 is half of S's 0.5; N's SIoU box loss."""
    cfg = _small(config_cls, N_CONFIG)
    cfg.model.width_multiple = 0.0625
    return cfg


def small_s_config(config_cls):
    """configs/yolov6s.py cut to test size: depth 0.1, width 0.125. It keeps
    every block of the S graph, and stage 4's RepBlock keeps 2 blocks."""
    return _small(config_cls, S_CONFIG)


def small_m_config(config_cls):
    """configs/yolov6m.py cut as S is: depth 0.1, width 0.125. Every BepC3
    keeps one BottleRep (stage 4's n is 2), of RepVGG blocks, with its
    alpha; SimSPPF, the CSP neck and the DFL head (reg_max 16) stay."""
    return _small(config_cls, M_CONFIG)


def small_l_config(config_cls):
    """configs/yolov6l.py cut as S is: the M graph of ``conv_silu`` blocks
    (ConvBNSiLU in place of RepVGG, BepC3's 1x1s SiLU) ending in SPPF."""
    return _small(config_cls, L_CONFIG)


def random_jax_variables(shapes, seed: int):
    """Overwrite every leaf of a flax variables pytree (arrays or
    ShapeDtypeStructs) with seeded numpy values.

    Conv kernels are He-normal, so activations stay O(1) through the deep
    graph. The head's class and box predictions, zero-initialised in the
    model, get small weights; their biases are spread so scores differ per
    class and box distances stay positive. BN gammas (train variables) lie
    in [0.4, 0.8] and running variances in [0.5, 1.5], so that eval-mode
    activations also stay O(1) through RepVGG's three summed branches.
    BottleRep alphas lie in [0.5, 1.5]."""
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
        if names[-1] == "scale":
            return rng.uniform(0.4, 0.8, shape).astype(np.float32)
        if names[-1] in ("var", "alpha"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if owner.startswith("cls_preds"):
            return rng.uniform(-4.0, 1.0, shape).astype(np.float32)
        if owner.startswith("reg_preds"):
            return rng.uniform(1.0, 3.0, shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def random_lite_variables(shapes, seed: int):
    """``random_jax_variables`` for the lite family, whose eval-mode signal
    that fill lets fade: hard-swish halves a small input, so at He scale the
    head's maps no longer depend on the image. Here every conv kernel but
    the head's predictions is normal with std 1.4 / sqrt(fan_in), every conv
    bias and BN shift lies in [0.5, 1.5] (where hard-swish has a slope near
    1), running variances in [0.5, 1.5] and means in [-0.2, 0.2], and each BN
    gamma is the running std times a factor in [0.8, 1.2]. The head's
    predictions, whose inputs are then O(10), get a fifth of
    ``random_jax_variables``'s kernel scale and keep its biases, so that
    class scores stay below 0.95 and apart. Lite-S/M/L's eval-mode maps,
    deploy and train form, then differ between two images by over a hundred
    times the tests' tolerances at every level."""
    from flax.traverse_util import flatten_dict, unflatten_dict

    rng = np.random.default_rng(seed)
    flat = flatten_dict(random_jax_variables(shapes, seed))
    for path, leaf in flat.items():
        shape = leaf.shape
        if path[-2].startswith(("cls_preds", "reg_preds")):
            if path[-1] == "kernel":
                flat[path] = leaf * 0.2
            continue
        if path[-1] == "kernel":
            flat[path] = (rng.standard_normal(shape) * 1.4 / np.sqrt(np.prod(shape[:-1]))
                          ).astype(np.float32)
        elif path[-1] == "bias":
            flat[path] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif path[-1] == "var":
            flat[path] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif path[-1] == "mean":
            flat[path] = rng.uniform(-0.2, 0.2, shape).astype(np.float32)
    for path in flat:
        if path[-1] == "scale":
            var = flat[("batch_stats",) + path[1:-1] + ("var",)]
            flat[path] = (rng.uniform(0.8, 1.2, var.shape) * np.sqrt(var + 1e-3)
                          ).astype(np.float32)
    return unflatten_dict(flat)


def jax_in_float64(fn):
    """``fn``, a JAX function of array pytrees, evaluated in float64: its
    jaxpr, traced as written (float32), is replayed under x64 with every
    float32 input, constant, literal, cast and result type raised to
    float64. The JAX package fixes float32 in its modules (the ``dtype``
    fields, the BN's casts), so ``jax.enable_x64`` alone leaves its
    arithmetic in float32; this replay runs the package's own operations,
    in its own order, at double precision. Returns a function of the same
    arguments whose float outputs are float64. The jaxpr is compiled in
    chunks of ``REPLAY_CHUNK`` equations: XLA's CPU compile time grows
    faster than the program: the M train step's 17k equations took about
    280 s to compile whole on one CPU core, about 90 s in chunks."""
    import jax
    import jax.numpy as jnp
    from jax.extend.core import Literal

    f32 = np.dtype(np.float32)

    def widen(x):
        return x.astype(jnp.float64) if x.dtype == f32 else x

    def widen_param(p):
        return np.dtype(np.float64) if isinstance(p, np.dtype) and p == f32 else p

    def literal(v):
        return np.float64(v.val) if v.aval.dtype == f32 else v.val

    def replay(jaxpr, consts, args):
        env = {}

        def read(v):
            return literal(v) if isinstance(v, Literal) else env[v]

        env.update(zip(jaxpr.constvars, map(widen, map(jnp.asarray, consts))))
        env.update(zip(jaxpr.invars, map(widen, args)))
        for eqn in jaxpr.eqns:
            ins = [read(v) for v in eqn.invars]
            # a custom_vjp_call left in the jaxpr is one no gradient goes
            # through (QAT's straight-through round on the image): its forward
            if eqn.primitive.name in ("jit", "custom_jvp_call", "custom_vjp_call"):
                inner = eqn.params.get("jaxpr") or eqn.params["call_jaxpr"]
                outs = replay(inner.jaxpr, inner.consts, ins)
            else:
                params = {k: widen_param(p) for k, p in eqn.params.items()}
                if params.get("update_jaxpr") is not None:  # a scatter's combiner
                    update = params["update_jaxpr"]
                    params["update_jaxpr"] = jax.make_jaxpr(
                        lambda *a, u=update: replay(u, params["update_consts"], a))(
                        *[jax.ShapeDtypeStruct(v.aval.shape, widen_param(v.aval.dtype))
                          for v in update.invars]).jaxpr
                outs = eqn.primitive.bind(*ins, **params)
                outs = outs if eqn.primitive.multiple_results else [outs]
            env.update(zip(eqn.outvars, outs))
        return [read(v) for v in jaxpr.outvars]

    def run(*args):
        closed, out_shape = jax.make_jaxpr(fn, return_shape=True)(*args)
        jaxpr, eqns = closed.jaxpr, closed.jaxpr.eqns
        bounds = range(0, len(eqns), REPLAY_CHUNK)
        # the variables read after each chunk: what it must hand on
        needed = {v for v in jaxpr.outvars if not isinstance(v, Literal)}
        after = []
        for lo in reversed(bounds):
            after.append(set(needed))
            needed.update(v for e in eqns[lo:lo + REPLAY_CHUNK] for v in e.invars
                          if not isinstance(v, Literal))
        after.reverse()
        with jax.enable_x64(True):
            env = dict(zip(jaxpr.constvars, map(widen, map(jnp.asarray, closed.consts))))
            env.update(zip(jaxpr.invars,
                           map(widen, map(jnp.asarray, jax.tree_util.tree_leaves(args)))))
            for lo, later in zip(bounds, after):
                part = eqns[lo:lo + REPLAY_CHUNK]
                made = [v for e in part for v in e.outvars]
                made_set = set(made)
                ins = list(dict.fromkeys(v for e in part for v in e.invars
                                         if not isinstance(v, Literal) and v not in made_set))
                sub = types.SimpleNamespace(constvars=[], invars=ins, eqns=part,
                                            outvars=[v for v in made if v in later])
                outs = jax.jit(lambda a, sub=sub: replay(sub, [], a))([env[v] for v in ins])
                env.update(zip(sub.outvars, outs))
            outs = [literal(v) if isinstance(v, Literal) else env[v] for v in jaxpr.outvars]
        return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(out_shape), outs)

    return run


def edge_centred_targets(img, n_img, n_box, max_labels, num_classes, seed):
    """Padded targets ``[n_img, max_labels, 5]`` (image b has ``n_box - b``
    boxes) whose centres lie on cell edges of every level (multiples of 32
    px, or of 8 in a 64 image) with sizes of whole pixels, so that GT-anchor
    distances tie exactly; with the image-pixel xyxy GT boxes and the GT
    mask, as ComputeLoss derives them."""
    rng = np.random.default_rng(seed)
    step = 8 if img == 64 else 32
    t = np.zeros((n_img, max_labels, 5), np.float32)
    t[:, :, 0] = -1
    for b in range(n_img):
        for j in range(n_box - b):
            cx, cy = rng.integers(1, img // step, 2) * step
            w, h = rng.integers(2, img // 8, 2) * 4
            t[b, j] = [rng.integers(0, num_classes), cx / img, cy / img, w / img, h / img]
    xywh = t[..., 1:5] * np.float32(img)
    gt_bboxes = np.concatenate([xywh[..., :2] - xywh[..., 2:] / 2,
                                xywh[..., :2] + xywh[..., 2:] / 2], -1).astype(np.float32)
    mask_gt = (gt_bboxes.sum(-1, keepdims=True) > 0).astype(np.float32)
    return t, gt_bboxes, mask_gt


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


# (w, h) of the eval-data tests' PNG set at img_size 160: shrunk (INTER_AREA,
# integer and non-integer factors), enlarged (INTER_LINEAR), odd sizes, and
# images read as they are
EVAL_IMG_SIZE = 160
EVAL_SIZES = [(160, 120), (120, 160), (200, 150), (97, 61), (64, 48), (333, 250), (320, 240),
              (150, 200), (160, 160), (81, 160)]
# chip_smoke.py's eval and train-CLI sets at img_size 640 (EVAL_SET there)
CHIP_EVAL_SIZES = [(640, 480), (480, 640), (768, 576), (320, 240)]
# long side 160: no pixel is resized, in square and in rect mode
NATIVE_SIZES = [(160, 120), (120, 160), (160, 160), (160, 96)]


def loaded_shape(w, h, img_size=EVAL_IMG_SIZE, shrink=0):
    """(h, w) of an image after ``load_image``'s ratio-keeping resize."""
    ratio = (img_size - shrink) / max(h, w)
    return (int(h * ratio), int(w * ratio)) if ratio != 1 else (h, w)


def rect_batch_shapes(sizes, batch_size, img_size=EVAL_IMG_SIZE, stride=32, pad=0.5):
    """The rect batches' [h, w] shapes of a set of (w, h) images, as
    ``_setup_rect_batches`` computes them."""
    ar = np.sort(np.array([h / w for w, h in sizes]))
    out = []
    for b in range(0, len(ar), batch_size):
        mini, maxi = ar[b:b + batch_size].min(), ar[b:b + batch_size].max()
        shape = [maxi, 1] if maxi < 1 else [1, 1 / mini] if mini > 1 else [1, 1]
        out.append(tuple(np.ceil(np.array(shape) * img_size / stride + pad).astype(int) * stride))
    return out
