"""Upstream YOLOv6 ``.pt`` checkpoints and fine-tuning in the port
(yolov6_tpu_torch/utils/upstream_ckpt.py, utils/checkpoint.py, the
Trainer's ``pretrained``, ``load_teacher`` and RepOpt scales) against the
JAX package, on the CPU.

Every upstream file here is written by the test: the port's train graph
pickled whole in fp16 through a stub ``yolov6`` package under ``tmp_path``,
with upstream ``Detect``'s DFL projection (``yolov6_tpu_torch.utils.
upstream_ckpt.write_upstream_checkpoint``): a training run's file (the
optimizer's and scheduler's state, numpy float64 learning rates and
results) or a stripped release file. The stub is importable only while the
file is written, and the port's reader must not import it. The JAX package reads the
same file with the stub importable (``load_reference_checkpoint``, which
unpickles the real classes).

- The reader and fold, small S and small S-QA (QARepVGG V2): the train-form
  state dict (the EMA, preferred over the model) equals JAX
  ``import_checkpoint(state, spec, training_mode, deploy=False)`` ->
  ``state_dict_from_jax`` within 1e-6, and ``load_state_dict_file``'s
  deploy graph equals ``import_checkpoint(..., deploy=True)`` within 1e-6
  (both fold the same fp16 values in float32).
- The reader refuses a global outside its allowlist before it runs and a
  projection that is not the fixed ``linspace``; the deploy load and the
  partial load refuse a key their graph lacks; the port's own file and a JAX
  msgpack are told apart by content. A deploy-form upstream file loads into
  the deploy graph.
- The partial load against the JAX ``load_state_dict_partial``, with the
  same class count and with another (the class predictions keep the seed's
  init).
- The Trainer with a copy of configs/yolov6s_finetune.py (cut as small S
  is) whose ``pretrained`` is the port's own file or an upstream file: the
  loaded tensors equal the file's, and for the upstream file what the JAX
  trainer's load (``load_checkpoint_variables`` + ``load_state_dict_partial``)
  takes from it; under another class count the class predictions keep the
  seed's init; a missing file raises.
- ``load_teacher`` and the RepOpt scales read upstream files too.
"""

import os
import os.path as osp
import pickle
import sys
import types

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from yolov6_tpu.models.yolo import build_model as jax_build_model
from yolov6_tpu.utils.checkpoint import load_checkpoint_variables
from yolov6_tpu.utils.checkpoint import load_state_dict_partial as jax_load_state_dict_partial
from yolov6_tpu.utils.config import Config as JaxConfig
from yolov6_tpu.utils.torch_import import import_checkpoint, load_reference_checkpoint

from yolov6_tpu_torch.core.engine import Trainer, read_repopt_scales
from yolov6_tpu_torch.models.yolo import build_model
from yolov6_tpu_torch.solver.repoptimizer import extract_scales
from yolov6_tpu_torch.tools import train as train_cli
from yolov6_tpu_torch.utils.checkpoint import (
    load_state_dict_file, load_state_dict_partial, read_state_dict,
)
from yolov6_tpu_torch.utils.config import Config
from yolov6_tpu_torch.utils.upstream_ckpt import checkpoint_format, write_upstream_checkpoint
from yolov6_tpu_torch.utils.weights import state_dict_from_jax

from torch_port_utils import (
    M_CONFIG, REPO_ROOT, S_CONFIG, random_jax_variables, small_config,
)

NC, IMG = 3, 64
FOLD_TOL = dict(rtol=1e-6, atol=1e-6)
CONFIGS = {"s": S_CONFIG, "s_qa": osp.join(REPO_ROOT, "configs", "qarepvgg", "yolov6s_qa.py")}
FINETUNE = osp.join(REPO_ROOT, "configs", "yolov6s_finetune.py")


class StubOnPath:
    """The stub ``yolov6`` package importable inside the block (for the JAX
    reader), and not after it."""

    def __init__(self, root):
        self.root = str(root)

    def __enter__(self):
        sys.path.insert(0, self.root)

    def __exit__(self, *exc):
        sys.path.remove(self.root)
        for name in [n for n in sys.modules if n == "yolov6" or n.startswith("yolov6.")]:
            del sys.modules[name]


def _spec(cfg_jax, deploy, nc=NC, img=IMG):
    jmodel = jax_build_model(cfg_jax, num_classes=nc, deploy=deploy)
    return jmodel, jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)), train=False))


def _perturbed(model, seed):
    """A copy of ``model`` (train form) with every float tensor moved, the
    EMA that the reader must prefer."""
    import copy

    other = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in other.state_dict().values():
            if t.is_floating_point():
                t.add_(torch.rand(t.shape, generator=gen) * 0.1)
    return other


@pytest.mark.parametrize("name", list(CONFIGS))
def test_upstream_reader_and_fold_match_jax_import(name, tmp_path):
    cfg = small_config(Config, CONFIGS[name])
    jcfg = small_config(JaxConfig, CONFIGS[name])
    _, train_spec = _spec(jcfg, False)
    model = build_model(cfg, num_classes=NC, deploy=False, device="cpu")
    model.load_state_dict(state_dict_from_jax(random_jax_variables(train_spec, seed=51)),
                          strict=True)
    ema = _perturbed(model, 52)
    path = write_upstream_checkpoint(str(tmp_path / "up.pt"), model, tmp_path / "stub", ema=ema)
    assert "yolov6" not in sys.modules and checkpoint_format(path) == "upstream"

    state = read_state_dict(path)
    assert "yolov6" not in sys.modules
    assert set(state) == set(model.state_dict())
    for k, v in ema.state_dict().items():  # the EMA, rounded to fp16 and back
        want = v.half().float() if v.is_floating_point() else v
        assert torch.equal(state[k], want), k
    deploy = load_state_dict_file(path, cfg, device="cpu")
    assert "yolov6" not in sys.modules

    with StubOnPath(tmp_path / "stub"):
        jstate = load_reference_checkpoint(path)
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    # what an upstream training run saves beside its models
    assert all(type(v) is np.float64 for v in ckpt["results"])
    assert type(ckpt["optimizer"]["param_groups"][0]["lr"]) is np.float64
    assert ckpt["optimizer"]["state"] and ckpt["scheduler"]["base_lrs"]
    mode = jcfg.get("training_mode", "repvgg")
    want_train = state_dict_from_jax(import_checkpoint(jstate, train_spec, mode, deploy=False))
    for k, v in want_train.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), err_msg=k, **FOLD_TOL)
    want_deploy = state_dict_from_jax(import_checkpoint(jstate, _spec(jcfg, True)[1], mode,
                                                        deploy=True))
    got = deploy.state_dict()
    assert set(got) == set(want_deploy)
    for k, v in want_deploy.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **FOLD_TOL)


class _Boom:
    """Pickles as a call of ``os.system``: a reader that ran it would leave
    the marker file."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return os.system, (f"touch {self.marker}",)


def test_upstream_reader_refuses_what_it_must(tmp_path):
    cfg = small_config(Config, S_CONFIG)
    model = build_model(cfg, num_classes=NC, deploy=False, device="cpu")
    path = write_upstream_checkpoint(str(tmp_path / "up.pt"), model, tmp_path / "stub")

    # a global outside the allowlist, beside the upstream model
    marker = tmp_path / "ran"
    bad = str(tmp_path / "bad.pt")
    with StubOnPath(tmp_path / "stub"):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        ckpt["extra"] = _Boom(marker)
        torch.save(ckpt, bad)
    assert checkpoint_format(bad) == "upstream"
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        read_state_dict(bad)
    assert not marker.exists()

    # a projection that is not the fixed linspace
    with StubOnPath(tmp_path / "stub"):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        with torch.no_grad():
            ckpt["model"].detect.proj.add_(1)
        torch.save(ckpt, bad)
    with pytest.raises(ValueError, match="linspace"):
        read_state_dict(bad)

    # a key the graph lacks (another config's model), in the deploy and the partial load
    other = small_config(Config, M_CONFIG)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_state_dict_file(path, other, device="cpu")
    with pytest.raises(ValueError, match="not in the train graph"):
        load_state_dict_partial(read_state_dict(path),
                                build_model(other, num_classes=NC, deploy=False, device="cpu"))

    # the port's own file and other content, told apart by content
    own = str(tmp_path / "own.pt")
    torch.save({"model": model.state_dict()}, own)
    assert checkpoint_format(own) == "torch"
    msgpack = tmp_path / "w.pt"
    msgpack.write_bytes(b"\x82\xa5model\x80\xa5epoch\x01")
    with pytest.raises(ValueError, match="not a torch.save zip"):
        read_state_dict(str(msgpack))


def test_deploy_form_upstream_file(tmp_path):
    """An upstream file saved in the deploy form loads strictly into the
    deploy graph (eval, infer, hub), each tensor the file's; the fine-tune's
    partial load refuses it, its keys not the train graph's."""
    cfg = small_config(Config, S_CONFIG)
    model = build_model(cfg, num_classes=NC, deploy=True, device="cpu")
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.uniform_(-0.5, 0.5)
    path = write_upstream_checkpoint(str(tmp_path / "dep.pt"), model, tmp_path / "stub")
    got = load_state_dict_file(path, cfg, device="cpu").state_dict()
    assert set(got) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v.half().float() if v.is_floating_point() else v), k
    with pytest.raises(ValueError, match="not in the train graph"):
        load_state_dict_partial(read_state_dict(path),
                                build_model(cfg, num_classes=NC, deploy=False, device="cpu"))


@pytest.mark.parametrize("src_nc", [NC, 5])
def test_partial_load_matches_jax(src_nc):
    """A checkpoint of ``src_nc`` classes into a seeded graph of NC: every
    tensor of matching name and shape is taken, the rest keep the seed's
    values, as the JAX ``load_state_dict_partial`` merges them."""
    jcfg = small_config(JaxConfig, S_CONFIG)
    src_vars = random_jax_variables(_spec(jcfg, False, nc=src_nc)[1], seed=61)
    dst_vars = random_jax_variables(_spec(jcfg, False)[1], seed=62)
    merged = jax_load_state_dict_partial(src_vars, dst_vars)
    from flax.traverse_util import flatten_dict, unflatten_dict

    flat_m, flat_d = flatten_dict(merged), flatten_dict(dst_vars)
    want = state_dict_from_jax(unflatten_dict(
        {k: (v if v is not None else flat_d[k]) for k, v in flat_m.items()}))

    cfg = small_config(Config, S_CONFIG)
    model = build_model(cfg, num_classes=NC, deploy=False, device="cpu")
    model.load_state_dict(state_dict_from_jax(dst_vars), strict=True)
    matched, total = load_state_dict_partial(state_dict_from_jax(src_vars), model)
    got = model.state_dict()
    assert total == len(got)
    n_cls = sum(1 for k in got if k.startswith("detect.cls_preds."))
    assert matched == total - (0 if src_nc == NC else n_cls)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    from yolov6_tpu_torch.data.synth_detect import generate_synth_dataset

    root = tmp_path_factory.mktemp("finetune_set")
    return generate_synth_dataset(str(root), n_train=4, n_val=4, img_size=64, nc=NC, seed=0)


def _finetune_config(out, pretrained):
    """A copy of configs/yolov6s_finetune.py cut as small S is (depth 0.1,
    width 0.125) whose ``pretrained`` is ``pretrained``; returns its path."""
    with open(FINETUNE) as f:
        src = f.read()
    for old, new in (("pretrained='weights/yolov6s.pt'", f"pretrained={pretrained!r}"),
                     ("depth_multiple=0.33", "depth_multiple=0.1"),
                     ("width_multiple=0.5", "width_multiple=0.125")):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    os.makedirs(out, exist_ok=True)
    conf = osp.join(out, "finetune.py")
    with open(conf, "w") as f:
        f.write(src)
    return conf


def _finetune_trainer(data, out, pretrained):
    """The Trainer of ``_finetune_config``."""
    conf = _finetune_config(out, pretrained)
    args = train_cli.get_args_parser().parse_args([
        "--data-path", data, "--conf-file", conf, "--img-size", str(IMG), "--img-floor",
        str(IMG), "--batch-size", "4", "--workers", "1", "--epochs", "1", "--output-dir", out,
        "--name", "ft", "--max-labels", "8", "--seed", "0", "--device", "cpu"])
    cfg = train_cli.check_and_init(args)
    return Trainer(args, cfg)


def test_finetune_loads_pretrained_from_either_format(tiny_set, tmp_path):
    cfg = Config.fromfile(_finetune_config(str(tmp_path / "cfg"), None))
    torch.manual_seed(7)
    src = build_model(cfg, num_classes=NC, deploy=False, device="cpu")
    with torch.no_grad():
        for t in src.state_dict().values():
            if t.is_floating_point():
                t.uniform_(-0.5, 0.5)
    own = str(tmp_path / "own.pt")
    torch.save({"model": src.state_dict(), "epoch": 0}, own)
    up = write_upstream_checkpoint(str(tmp_path / "up.pt"), src, tmp_path / "stub")

    trainer = _finetune_trainer(tiny_set, str(tmp_path / "a"), own)
    got = trainer.model.state_dict()
    assert trainer.pretrained_matched == (len(got), len(got))
    assert all(torch.equal(got[k], v) for k, v in src.state_dict().items())

    trainer = _finetune_trainer(tiny_set, str(tmp_path / "b"), up)
    got = trainer.model.state_dict()
    assert "yolov6" not in sys.modules
    jcfg = JaxConfig.fromfile(_finetune_config(str(tmp_path / "cfg"), up))
    jmodel, spec = _spec(jcfg, False)
    with StubOnPath(tmp_path / "stub"):
        loaded = load_checkpoint_variables(up, jmodel, img_size=(IMG, IMG), deploy=False,
                                           training_mode="repvgg")
    want = state_dict_from_jax(jax_load_state_dict_partial(
        loaded, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), spec)))
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    for k, v in src.state_dict().items():
        assert torch.equal(got[k], v.half().float() if v.is_floating_point() else v), k

    # another class count: everything but the class predictions
    src80 = build_model(cfg, num_classes=80, deploy=False, device="cpu")
    up80 = write_upstream_checkpoint(str(tmp_path / "up80.pt"), src80, tmp_path / "stub80")
    seeded = _finetune_trainer(tiny_set, str(tmp_path / "c0"), None).model.state_dict()
    trainer = _finetune_trainer(tiny_set, str(tmp_path / "c"), up80)
    got = trainer.model.state_dict()
    n_cls = sum(1 for k in got if k.startswith("detect.cls_preds."))
    assert trainer.pretrained_matched == (len(got) - n_cls, len(got))
    for k, v in src80.state_dict().items():
        if k.startswith("detect.cls_preds."):
            assert torch.equal(got[k], seeded[k]), k
        else:
            assert torch.equal(got[k], v.half().float() if v.is_floating_point() else v), k

    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        _finetune_trainer(tiny_set, str(tmp_path / "d"), str(tmp_path / "missing.pt"))


def test_teacher_and_repopt_scales_read_upstream_files(tmp_path):
    """``load_teacher`` on an upstream fuse-AB S file, and the RepOpt scales
    from an upstream hs file and from the port's own hs checkpoint (its EMA
    first); a JAX msgpack scales path raises and names the formats."""
    cfg = small_config(Config, S_CONFIG)
    teacher_src = build_model(cfg, num_classes=NC, deploy=False, device="cpu", fuse_ab=True)
    with torch.no_grad():
        for t in teacher_src.state_dict().values():
            if t.is_floating_point():
                t.uniform_(-0.5, 0.5)
    path = write_upstream_checkpoint(str(tmp_path / "t.pt"), teacher_src, tmp_path / "stub")
    host = types.SimpleNamespace(cfg=cfg, num_classes=NC, device=torch.device("cpu"))
    teacher = Trainer.load_teacher(host, path)
    assert not teacher.training
    for k, v in teacher_src.state_dict().items():
        assert torch.equal(teacher.state_dict()[k],
                           v.half().float() if v.is_floating_point() else v), k

    hs_cfg = small_config(Config, osp.join(REPO_ROOT, "configs", "repopt", "yolov6s_opt.py"))
    hs_graph_cfg = hs_cfg.copy()
    hs_graph_cfg["training_mode"] = "hyper_search"
    hs = build_model(hs_graph_cfg, num_classes=NC, deploy=False, device="cpu")
    ema = _perturbed(hs, 71)
    up = write_upstream_checkpoint(str(tmp_path / "hs.pt"), hs, tmp_path / "stub_hs", ema=ema)
    own = str(tmp_path / "hs_own.pt")
    torch.save({"model": hs.state_dict(), "ema": ema.state_dict()}, own)
    want = extract_scales(ema.state_dict())
    for path, exact in ((own, True), (up, False)):
        hs_cfg.model.scales = path
        got = extract_scales(read_repopt_scales(hs_cfg))
        assert set(got) == set(want)
        for k in want:
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(
                    a, b if exact else b.astype(np.float16).astype(np.float32))
    hs_cfg.model.scales = "assets/yolov6s_scale.msgpack"
    with pytest.raises(ValueError, match="msgpack.*last_ckpt.pt"):
        read_repopt_scales(hs_cfg)
