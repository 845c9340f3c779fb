"""The port's RepOpt (yolov6_tpu_torch/layers/common.py: RealVGGBlock,
ScaleLayer, LinearAddBlock; solver/repoptimizer.py; the fold of the
hyper-search graph) against the JAX package, on the CPU in fp32.

- Blocks: each in its deploy form (RealVGG: a biased conv; LinearAdd: the
  train graph, which it keeps) and its train form in train mode (outputs
  and updated BN statistics), then eval mode; ScaleLayer; rtol 1e-4 / atol
  1e-5. Scales are drawn in [0.5, 1.5].
- Graphs: small S in both RepOpt modes (configs/repopt/yolov6s_hs.py,
  yolov6s_opt.py: EfficientRep + RepPANNeck; depth 0.1, width 0.125) at 64
  px, train mode: the head maps and updated BN statistics (the same
  tolerance) and the gradients of a fixed weighted sum of the head maps,
  each parameter within 1e-4 of the JAX gradient's largest magnitude +
  1e-6 (fp32 sums in another order). The parameter groups equal JAX's
  ``build_param_groups``: ScaleLayer scales are decayed weights.
- RepOptimizer: ``extract_scales`` of the hs graph, the RealVGG blocks the
  opt graph has, the gradient masks and ``reinitialize`` with the JAX
  draw of the 1x1 kernels (the JAX package's ``fold_in`` of its key by the
  block path's crc32) equal the JAX package's (exact, or 1e-6 for the
  re-init's float32 arithmetic); the CSLA theorem of
  tests/test_repoptimizer.py on one port block: a plain SGD step on a
  LinearAddBlock's branches, folded, equals a masked step on the folded conv.
- The fold: the hs train graph's state dict folds into the hs deploy graph
  with strict=True, every LinearAddBlock tensor passed through untouched
  (its BN counter included), and the deploy output equals the train form's
  eval output; ``load_state_dict_file`` takes the hs deploy dict as it is.
  The opt graph folds (RealVGG conv+BN into a biased conv) the same way.
- Every configs/repopt/ config at full width: the deploy parameter count
  equals the JAX package's, and the train graph folds into the deploy graph.
"""

import copy
import functools
import os
import zlib

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from yolov6_tpu.layers import common as jcommon
from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.solver import repoptimizer as jrepopt
from yolov6_tpu.solver.build import build_param_groups
from yolov6_tpu.utils.config import Config as JaxConfig

from yolov6_tpu_torch.layers import common as tcommon
from yolov6_tpu_torch.layers.reparam import fold_to_deploy, linearadd_fold
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.solver import repoptimizer as trepopt
from yolov6_tpu_torch.solver.build import param_groups
from yolov6_tpu_torch.utils.checkpoint import load_state_dict_file
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_csp_model import _nchw, _nhwc, _stats_close
from torch_port_utils import REPO_ROOT, jax_in_float64, random_jax_variables, small_config

TOL = dict(rtol=1e-4, atol=1e-5)
F64_TOL = dict(rtol=1e-8, atol=1e-10)  # both sides in float64
# the running statistics in float64, within this share of the leaf's largest
# magnitude: the JAX BN's momentum 0.97 is a float32 constant, so its update
# weighs the batch by 1 - 0.97f = 0.0299999714 where the port's weighs it by
# 0.03, 1e-6 apart
F64_STATS_REL = 1e-6
GRAD_REL, GRAD_FLOOR = 1e-8, 1e-12
IMG, NC = 64, 3
REPOPT = {m: os.path.join(REPO_ROOT, "configs", "repopt", f"yolov6s_{m}.py")
          for m in ("hs", "opt")}


def random_repopt_variables(shapes, seed):
    """``random_jax_variables`` with every ScaleLayer scale (a ``weight``
    leaf) in [0.5, 1.5], so that the branches weigh differently."""
    flat = flatten_dict(random_jax_variables(shapes, seed))
    rng = np.random.default_rng(seed + 1000)
    for path, leaf in flat.items():
        if path[-1] == "weight":
            flat[path] = rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
    return unflatten_dict(flat)


# (id, JAX module(deploy), port module(deploy), input NHWC)
BLOCK_CASES = [
    ("RealVGG_s1", lambda d: jcommon.RealVGGBlock(12, 3, 1, deploy=d),
     lambda d: tcommon.RealVGGBlock(8, 12, 3, 1, deploy=d), (2, 9, 9, 8)),
    ("RealVGG_s2", lambda d: jcommon.RealVGGBlock(12, 3, 2, deploy=d),
     lambda d: tcommon.RealVGGBlock(8, 12, 3, 2, deploy=d), (2, 9, 9, 8)),
    ("LinearAdd_in_eq_out_s1", lambda d: jcommon.LinearAddBlock(8, 3, 1, deploy=d),
     lambda d: tcommon.LinearAddBlock(8, 8, 3, 1, deploy=d), (2, 9, 9, 8)),
    ("LinearAdd_in_ne_out_s1", lambda d: jcommon.LinearAddBlock(12, 3, 1, deploy=d),
     lambda d: tcommon.LinearAddBlock(8, 12, 3, 1, deploy=d), (2, 9, 9, 8)),
    ("LinearAdd_in_eq_out_s2", lambda d: jcommon.LinearAddBlock(8, 3, 2, deploy=d),
     lambda d: tcommon.LinearAddBlock(8, 8, 3, 2, deploy=d), (2, 9, 9, 8)),
]


@pytest.mark.parametrize("form", ["deploy", "train"])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=[c[0] for c in BLOCK_CASES])
def test_repopt_block_matches_jax(case, form):
    name, make_jax, make_port, in_shape = case
    deploy = form == "deploy"
    x = np.random.default_rng(21).standard_normal(in_shape).astype(np.float32)
    jmod = make_jax(deploy)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = random_repopt_variables(shapes, seed=22)
    port = make_port(deploy)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    keys = set(port.state_dict())
    if name.startswith("LinearAdd"):
        assert {"conv.weight", "scale_conv.weight", "conv_1x1.weight", "scale_1x1.weight",
                "bn.weight"} <= keys
        assert ("scale_identity.weight" in keys) == (name == "LinearAdd_in_eq_out_s1")
    if "bn.weight" in keys:  # the train form, and LinearAdd's in both
        want, updates = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        port.train()
        with torch.no_grad():
            np.testing.assert_allclose(_nhwc(port(_nchw(x))), np.asarray(want), **TOL)
        _stats_close(port, updates["batch_stats"])
        port.load_state_dict(state_dict_from_jax(variables), strict=True)
    port.eval()
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, jnp.asarray(x))), **TOL)


def test_scale_layer_matches_jax():
    """LinearAddBlock's ScaleLayer: no shift, scales 1 at init."""
    x = np.random.default_rng(23).standard_normal((2, 5, 5, 6)).astype(np.float32)
    jmod = jcommon.ScaleLayer(6, False, 1.0)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert np.all(np.asarray(variables["params"]["weight"]) == 1.0)
    variables = random_repopt_variables(variables, seed=24)
    port = tcommon.ScaleLayer(6)
    assert torch.equal(port.weight, torch.ones(6))
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, jnp.asarray(x))), **TOL)


@functools.lru_cache(maxsize=None)
def _spec(mode, deploy=False):
    jmodel = jax_build_model(small_config(JaxConfig, REPOPT[mode]), num_classes=NC,
                             deploy=deploy)
    return jmodel, jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))


@pytest.fixture(scope="module", params=["hs", "opt"])
def small_graph(request):
    mode = request.param
    jmodel, shapes = _spec(mode)
    variables = random_repopt_variables(shapes, seed=31)
    model = build_model(small_config(Config, REPOPT[mode]), num_classes=NC, deploy=False,
                        device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = np.random.default_rng(32).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    return mode, jmodel, variables, model, x


def _port_layout64(collection, tree):
    """A float64 JAX tree in the port's names and layout, as float64 numpy:
    ``state_dict_from_jax`` (which casts to float32) of its float32 high
    part plus that of its float32 remainder."""
    hi = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64).astype(np.float32), tree)
    lo = jax.tree_util.tree_map(lambda v, h: (np.asarray(v, np.float64) - h).astype(np.float32),
                                tree, hi)
    sd_hi, sd_lo = (state_dict_from_jax({collection: t}) for t in (hi, lo))
    return {k: sd_hi[k].double().numpy() + sd_lo[k].double().numpy() for k in sd_hi
            if not k.endswith("num_batches_tracked")}


def _head_weights(head_t, seed=33):
    rng = np.random.default_rng(seed)
    return {k: [rng.standard_normal(tuple(m.shape)).astype(np.float32) for m in v]
            for k, v in head_t.items()}


def test_small_repopt_graph_train_forward_and_gradients_match_jax(small_graph):
    """Train mode: the head maps, the updated BN statistics and the
    gradients of sum(head maps * fixed weights), the port in float64
    against the JAX graph evaluated in float64 (``jax_in_float64``; in fp32
    either side's gradients read the BN's rounding, the JAX one's up to 3e-4
    of a leaf's largest magnitude); each graph holds its mode's blocks:
    LinearAddBlocks (hs) or RealVGGBlocks (opt), and no RepVGG."""
    mode, jmodel, variables, model, x = small_graph
    kind = tcommon.LinearAddBlock if mode == "hs" else tcommon.RealVGGBlock
    assert any(isinstance(m, kind) for m in model.modules())
    assert not any(isinstance(m, tcommon.RepVGGBlock) for m in model.modules())
    assert type(model.neck).__name__ == "RepPANNeck"
    model64 = copy.deepcopy(model).double().train()
    head_t, _ = model64(_nchw(x).double())
    weights = _head_weights({k: v for k, v in head_t.items() if k in ("cls", "reg")})
    loss = sum((m * torch.from_numpy(w).double()).sum()
               for k in weights for m, w in zip(head_t[k], weights[k]))
    loss.backward()

    def jloss(params, batch_stats, a):
        (head, _), updates = jmodel.apply({"params": params, "batch_stats": batch_stats}, a,
                                          train=True, mutable=["batch_stats"])
        total = sum((m * jnp.transpose(jnp.asarray(w), (0, 2, 3, 1))).sum()
                    for k in weights for m, w in zip(head[k], weights[k]))
        return total, (head, updates)

    (total_j, (head_j, updates)), grads = jax_in_float64(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"], variables["batch_stats"], jnp.asarray(x))
    np.testing.assert_allclose(float(loss), float(total_j), rtol=1e-9)
    for key in ("cls", "reg"):
        for mt, mj in zip(head_t[key], head_j[key], strict=True):
            np.testing.assert_allclose(_nhwc(mt), np.asarray(mj), **F64_TOL)
    own = model64.state_dict()
    for key, value in _port_layout64("batch_stats", updates["batch_stats"]).items():
        err = float(np.abs(own[key].numpy() - value).max())
        assert err <= F64_STATS_REL * float(np.abs(value).max()), (key, err)
    want = _port_layout64("params", grads)
    got = {n: p.grad for n, p in model64.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()) + GRAD_FLOOR, (name, err)

    groups = param_groups(model)
    jgroups = jax.tree_util.tree_map(lambda p, g: np.full(p.shape, g, np.float32),
                                     variables["params"], build_param_groups(variables["params"]))
    want_groups = {k: int(v.flatten()[0]) for k, v in state_dict_from_jax(
        {"params": jgroups}).items() if not k.endswith("num_batches_tracked")}
    assert groups == want_groups
    if mode == "hs":
        assert groups["backbone.stem.scale_conv.weight"] == 1  # GROUP_WEIGHT


def _jax_scales(mode_vars):
    """JAX scales of the hs variables, keyed by the port's module names."""
    return {".".join(path): sc for path, sc in jrepopt.extract_scales(mode_vars["params"]).items()}


def test_repoptimizer_matches_jax():
    """extract_scales, the block set, the masks and the re-init (with the
    JAX 1x1 draw) against yolov6_tpu/solver/repoptimizer.py."""
    hs_vars = random_repopt_variables(_spec("hs")[1], seed=41)
    hs = build_model(small_config(Config, REPOPT["hs"]), num_classes=NC, deploy=False,
                     device="cpu")
    hs.load_state_dict(state_dict_from_jax(hs_vars), strict=True)
    scales = trepopt.extract_scales(hs.state_dict())
    want = _jax_scales(hs_vars)
    assert set(scales) == set(want) and len(scales) > 10
    assert {len(v) for v in scales.values()} == {2, 3}
    for name, sc in scales.items():
        assert len(sc) == len(want[name])
        for a, b in zip(sc, want[name]):
            np.testing.assert_array_equal(a, np.asarray(b))

    opt_vars = random_repopt_variables(_spec("opt")[1], seed=42)
    opt = build_model(small_config(Config, REPOPT["opt"]), num_classes=NC, deploy=False,
                      device="cpu")
    opt.load_state_dict(state_dict_from_jax(opt_vars), strict=True)
    blocks = trepopt.find_repopt_blocks(opt)
    jblocks = {".".join(p) for p in jrepopt.find_repopt_blocks(opt_vars["params"])}
    assert set(blocks) == jblocks == set(scales)

    jscales = jrepopt.extract_scales(hs_vars["params"])
    masks = trepopt.generate_gradient_masks(opt, scales)
    jmasks = flatten_dict(jrepopt.generate_gradient_masks(opt_vars["params"], jscales))
    assert set(masks) == {f"{b}.conv.weight" for b in blocks}
    for path, m in jmasks.items():
        name = ".".join(path[:-1]) + ".weight"
        if name in masks:
            np.testing.assert_array_equal(masks[name].numpy(), np.transpose(m, (3, 2, 0, 1)))
        else:
            assert np.all(np.asarray(m) == 1.0), name

    key = jax.random.PRNGKey(0)
    want_sd = {k: v for k, v in state_dict_from_jax(
        {"params": jrepopt.reinitialize(opt_vars["params"], jscales, key)}).items()
        if not k.endswith("num_batches_tracked")}
    kernels_1x1 = {}
    for path in jrepopt.find_repopt_blocks(opt_vars["params"]):
        cin, cout = flatten_dict(opt_vars["params"])[path + ("conv", "kernel")].shape[2:]
        block_key = jax.random.fold_in(key, zlib.crc32("/".join(path).encode()) & 0x7FFFFFFF)
        bound = 1.0 / np.sqrt(cin)
        k1 = np.asarray(jax.random.uniform(block_key, (1, 1, cin, cout), jnp.float32,
                                           -bound, bound))
        kernels_1x1[".".join(path)] = torch.from_numpy(np.transpose(k1, (3, 2, 0, 1)).copy())
    before = {n: p.detach().clone() for n, p in opt.named_parameters()}
    trepopt.reinitialize(opt, scales, kernels_1x1=kernels_1x1)
    after = dict(opt.named_parameters())
    assert set(after) == set(want_sd)
    for name, want in want_sd.items():
        if name in masks:
            np.testing.assert_allclose(after[name].detach().numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
            assert not torch.equal(after[name], before[name]), name
        else:
            assert torch.equal(after[name], before[name]), name
    # the port's own draw: the same distribution, other bits
    own = build_model(small_config(Config, REPOPT["opt"]), num_classes=NC, deploy=False,
                      device="cpu")
    own.load_state_dict(state_dict_from_jax(opt_vars), strict=True)
    trepopt.reinitialize(own, scales)
    name = next(iter(masks))
    assert not torch.equal(dict(own.named_parameters())[name], after[name])


def test_csla_masked_step_equals_branch_step():
    """tests/test_repoptimizer.py::test_csla_sgd_equivalence on the port: one
    plain SGD step on a LinearAddBlock's linear part (3x3, 1x1 and identity
    branches, the scales fixed, the identity's trainable), folded by
    ``linearadd_fold``, equals one masked step of the folded 3x3 conv under
    ``generate_gradient_masks``'s mask (the identity scale 1, as the
    reference's mask assumes)."""
    rng = np.random.default_rng(0)
    c = 6
    block = tcommon.LinearAddBlock(c, c, 3, 1, deploy=False)
    with torch.no_grad():
        block.conv.weight.copy_(torch.from_numpy(rng.standard_normal((c, c, 3, 3)) * 0.2))
        block.conv_1x1.weight.copy_(torch.from_numpy(rng.standard_normal((c, c, 1, 1)) * 0.2))
        block.scale_conv.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
        block.scale_1x1.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
        block.scale_identity.weight.fill_(1.0)
    x = torch.from_numpy(rng.standard_normal((2, c, 8, 8)).astype(np.float32))
    tgt = torch.from_numpy(rng.standard_normal((2, c, 8, 8)).astype(np.float32))
    lr = 0.1

    def linear(b):
        return (b.scale_conv(b.conv(x)) + b.scale_1x1(b.conv_1x1(x)) + b.scale_identity(x))

    ((linear(block) - tgt) ** 2).sum().backward()

    def fold(w3, w1, sid):
        return linearadd_fold(w3, block.scale_conv.weight.detach().numpy(), w1,
                              block.scale_1x1.weight.detach().numpy(), sid, c)

    p = {n: t.detach().numpy() for n, t in block.named_parameters()}
    g = {n: t.grad.numpy() for n, t in block.named_parameters() if t.grad is not None}
    after_branches = fold(p["conv.weight"] - lr * g["conv.weight"],
                          p["conv_1x1.weight"] - lr * g["conv_1x1.weight"],
                          p["scale_identity.weight"] - lr * g["scale_identity.weight"])

    plain = tcommon.RealVGGBlock(c, c, 3, 1, deploy=False)
    w = torch.from_numpy(fold(p["conv.weight"], p["conv_1x1.weight"],
                              p["scale_identity.weight"]))
    with torch.no_grad():
        plain.conv.weight.copy_(w)
    ((torch.nn.functional.conv2d(x, plain.conv.weight, padding=1) - tgt) ** 2).sum().backward()
    model = torch.nn.Sequential(plain)
    scales = {"0": tuple(block.get_submodule(n).weight.detach().numpy()
                         for n in ("scale_identity", "scale_1x1", "scale_conv"))}
    trepopt.apply_gradient_masks(model, trepopt.generate_gradient_masks(model, scales))
    after_masked = (plain.conv.weight - lr * plain.conv.weight.grad).detach().numpy()
    np.testing.assert_allclose(after_branches, after_masked, rtol=1e-4, atol=1e-5)


def test_hs_fold_passes_linear_add_blocks_through(small_graph, tmp_path):
    """The hs train graph folds into its deploy graph with strict=True, the
    LinearAddBlocks' tensors untouched; the opt graph folds RealVGG's
    conv+BN. The folded output equals the train form's eval output, and a
    saved hs deploy state dict loads through ``load_state_dict_file``."""
    mode, _, variables, model, x = small_graph
    cfg = small_config(Config, REPOPT[mode])
    deploy = build_model(cfg, num_classes=NC, deploy=True, device="cpu")
    sd = model.state_dict()
    folded = fold_to_deploy(sd, deploy)
    deploy.load_state_dict(folded, strict=True)
    linear_add = [n for n, m in model.named_modules() if isinstance(m, tcommon.LinearAddBlock)]
    assert bool(linear_add) == (mode == "hs")
    for prefix in linear_add:
        own = [k for k in sd if k.startswith(prefix + ".")]
        assert any(k.endswith("bn.num_batches_tracked") for k in own)
        for k in own:
            assert torch.equal(folded[k], sd[k]), k
    if mode == "opt":
        assert all(f"{b}.conv.bias" in folded and f"{b}.bn.weight" not in folded
                   for b in trepopt.find_repopt_blocks(model))
    model.eval()
    with torch.no_grad():
        want, _ = model(_nchw(x))
        got, _ = deploy(_nchw(x))
    model.train()
    for key in ("cls", "reg"):
        for g, w in zip(got[key], want[key], strict=True):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    path = str(tmp_path / "deploy.pt")
    torch.save({"model": deploy.state_dict()}, path)
    loaded = load_state_dict_file(path, cfg, device="cpu")
    for k, v in deploy.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


@pytest.mark.parametrize("name", sorted(os.path.basename(p)[:-3] for p in os.listdir(
    os.path.join(REPO_ROOT, "configs", "repopt"))))
def test_repopt_config_parameter_count_matches_jax(name):
    """Every configs/repopt/ config at full width, built and not run: the
    deploy parameter count equals the JAX package's (its variables' shapes
    by ``jax.eval_shape`` at 64 px); the train graph folds into the deploy
    graph with strict=True (the hs configs' LinearAddBlocks as they are)."""
    path = os.path.join(REPO_ROOT, "configs", "repopt", f"{name}.py")
    jmodel = jax_build_model(JaxConfig.fromfile(path), num_classes=80, deploy=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    cfg = Config.fromfile(path)
    deploy = build_model(cfg, num_classes=80, deploy=True, device="cpu")
    assert sum(p.numel() for p in deploy.parameters()) == want
    train = build_model(cfg, num_classes=80, deploy=False, device="cpu")
    deploy.load_state_dict(fold_to_deploy(train.state_dict(), deploy), strict=True)
