"""Reading upstream YOLOv6 ``.pt`` checkpoints without the upstream package
(port of yolov6_tpu/utils/torch_import.py::load_reference_checkpoint and
``torch_state_to_numpy``, :51-80), and writing one for tests.

An upstream checkpoint pickles whole ``nn.Module``s of the ``yolov6``
package, in fp16, beside the run's state: ``{'model': Model, 'ema': Model,
'updates', 'optimizer', 'scheduler', 'epoch', 'results'}``, the optimizer's
and scheduler's state dicts holding numpy float64 learning rates and
``results`` (AP50, AP) as numpy float64 (a released file, stripped, has
``'ema'``, ``'updates'`` and ``'optimizer'`` None). The JAX package
unpickles it with the upstream package importable; the port cannot import
it, and a pickle must not run arbitrary code. So the file is read with
``torch.load(..., weights_only=False, pickle_module=<this module's
unpickler>)``, whose ``find_class`` maps every class of the ``yolov6``
package and of ``torch.nn.modules`` to a stub ``nn.Module`` subclass that
holds the pickled parameters, buffers and children (``__setstate__`` and
``state_dict()`` are ``nn.Module``'s own, and its ``forward`` raises), and
allows otherwise only ``_ALLOWED``: torch's tensor and parameter rebuild
functions, ``collections.OrderedDict``, ``set``, and numpy's scalar and
dtype reconstructors with ``_codecs.encode`` for their bytes. Any other
global raises ``pickle.UnpicklingError``.

The port's module names are upstream's, so the model's state dict is the
port's train-form state dict but for the keys the port computes itself:
``Detect``'s ``proj`` and ``proj_conv.weight``, the fixed DFL projection
``linspace(0, reg_max, reg_max + 1)``, which are checked and dropped.
"""

from __future__ import annotations

import _codecs
import collections
import copy
import importlib
import io
import os
import pickle
import pickletools
import sys
import types
import zipfile
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

# the keys of upstream Detect's DFL projection, which the port computes
PROJ_KEYS = ("detect.proj", "detect.proj_conv.weight")
# numpy's scalar reconstructor (it makes a value of an allowed dtype from
# bytes or from an object the unpickler has already made)
_np_scalar = (np._core if hasattr(np, "_core") else np.core).multiarray.scalar

_ALLOWED = {
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("builtins", "set"): set,
    ("__builtin__", "set"): set,
    ("torch._utils", "_rebuild_tensor_v2"): torch._utils._rebuild_tensor_v2,
    ("torch._utils", "_rebuild_parameter"): torch._utils._rebuild_parameter,
    ("torch._utils", "_rebuild_parameter_with_state"):
        torch._utils._rebuild_parameter_with_state,
    # numpy float64 learning rates and (AP50, AP): numpy 1.x and 2.x names
    ("numpy.core.multiarray", "scalar"): _np_scalar,
    ("numpy._core.multiarray", "scalar"): _np_scalar,
    ("numpy", "dtype"): np.dtype,
    ("_codecs", "encode"): _codecs.encode,
}


class UpstreamModuleStub(nn.Module):
    """An unpickled module of an upstream checkpoint: its tensors and
    children, no code."""

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"{type(self).__name__} is a stub of an upstream module: it holds "
                           "tensors and does not run")


_STUBS: Dict[str, type] = {}


def _stub(module: str, name: str) -> type:
    key = f"{module}.{name}"
    if key not in _STUBS:
        _STUBS[key] = type(name, (UpstreamModuleStub,), {"upstream_class": key})
    return _STUBS[key]


class Unpickler(pickle.Unpickler):
    """Maps the upstream package's and torch's module classes to stubs and
    refuses every global outside ``_ALLOWED``."""

    def find_class(self, module, name):
        if module == "yolov6" or module.startswith(("yolov6.", "torch.nn.modules.")):
            return _stub(module, name)
        if (module, name) in _ALLOWED:
            return _ALLOWED[(module, name)]
        raise pickle.UnpicklingError(
            f"global {module}.{name} is not allowed in an upstream checkpoint (the reader maps "
            "yolov6.* and torch.nn.modules.* classes to stubs and allows only torch's tensor "
            "rebuilds, OrderedDict, set and numpy's scalars)")


def _load(file, **kwargs):
    return Unpickler(file, **kwargs).load()


# what torch.load takes as its ``pickle_module`` (it reads the name too)
pickle_module = types.ModuleType(f"{__name__}.pickle_module")
pickle_module.Unpickler, pickle_module.load = Unpickler, _load

FORMATS = ("the port's own torch.save checkpoint (a state dict of tensors, bare or under "
           "'ema' or 'model')", "an upstream YOLOv6 .pt (pickled yolov6 modules, zip format)")


def checkpoint_format(path: str) -> str:
    """``"upstream"`` when the pickle in the zip file at ``path`` names a
    class of the ``yolov6`` package, else ``"torch"``. Raises ``ValueError``
    for a file that is not a ``torch.save`` zip (a JAX msgpack, a legacy
    torch file)."""
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path} is not a torch.save zip file; the port reads "
                         + " and ".join(FORMATS))
    with zipfile.ZipFile(path) as zf:
        pkl = [n for n in zf.namelist() if n.endswith("/data.pkl") or n == "data.pkl"]
        if len(pkl) != 1:
            raise ValueError(f"{path}: a zip file without one data.pkl, not a torch.save file")
        data = zf.read(pkl[0])
    for op, arg, _ in pickletools.genops(io.BytesIO(data)):
        if isinstance(arg, str) and (op.name == "GLOBAL" or "UNICODE" in op.name) and (
                arg.startswith(("yolov6.", "yolov6 ")) or arg == "yolov6"):
            return "upstream"
    return "torch"


def read_upstream_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model of the upstream checkpoint at ``path`` (its EMA when it has
    one, as the JAX package reads it) as a state dict on
    the CPU, floating tensors in fp32 and ``PROJ_KEYS`` dropped; raises
    ``ValueError`` when the projection is not the fixed ``linspace`` or the
    file holds no model, ``pickle.UnpicklingError`` for a global outside the
    allowlist."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False, pickle_module=pickle_module)
    model = ckpt
    if isinstance(ckpt, dict):
        model = ckpt.get("ema") if ckpt.get("ema") is not None else ckpt.get("model")
    if not isinstance(model, nn.Module):
        raise ValueError(f"{path}: no upstream model under 'ema' or 'model'")
    state = {k: (v.detach().float() if v.is_floating_point() else v.detach())
             for k, v in model.state_dict().items()}
    if PROJ_KEYS[0] in state:
        proj = state.pop(PROJ_KEYS[0])
        reg_max = proj.numel() - 1
        want = torch.linspace(0, reg_max, reg_max + 1)
        conv = state.pop(PROJ_KEYS[1], None)
        if not torch.equal(proj, want) or (conv is not None
                                           and not torch.equal(conv, want.view(1, -1, 1, 1))):
            raise ValueError(f"{path}: detect.proj / proj_conv.weight are not the fixed DFL "
                             f"projection linspace(0, {reg_max}, {reg_max + 1}) that the port "
                             "computes")
    elif PROJ_KEYS[1] in state:
        raise ValueError(f"{path}: detect.proj_conv.weight without detect.proj")
    return state


def write_upstream_checkpoint(path: str, model: nn.Module, stub_root: str,
                              ema: Optional[nn.Module] = None, epoch: int = 3) -> str:
    """Write ``model`` (a port train graph) in the upstream format, for the
    reader's tests: whole fp16 modules of a ``yolov6`` package that is a
    stub written under ``stub_root`` (for each port class
    ``yolov6_tpu_torch.<mod>.<Name>`` a bare ``nn.Module`` subclass
    ``yolov6.<mod>.<Name>``; the port's module names are upstream's). The
    modules keep their parameters, buffers and children; other attributes
    that are callables (the activations) are dropped, as upstream's are
    modules. ``Detect`` gets upstream's DFL projection ``proj`` and
    ``proj_conv.weight`` (``linspace(0, reg_max, reg_max + 1)``).

    With ``ema``, the file is what an upstream training run saves:
    ``model``, ``ema``, ``updates``, the nesterov SGD's state dict (a
    momentum buffer a tensor, the learning rate and momentum numpy float64,
    as upstream's warmup sets them) and the LambdaLR scheduler's, ``epoch``
    and ``results`` (AP50, AP) as numpy float64. Without it, the file is a
    stripped release file: ``model`` (upstream's strip puts the EMA there),
    ``ema``, ``updates`` and ``optimizer`` None, the rest kept. The stub is
    importable only while the file is written: on return neither
    ``stub_root`` is on ``sys.path`` nor ``yolov6`` in ``sys.modules``.
    Returns ``path``."""
    stub_root = str(stub_root)

    def as_upstream(src):
        m = copy.deepcopy(src).cpu().half()
        classes = {}
        for mod in m.modules():
            cls = type(mod)
            if cls.__module__.startswith("yolov6_tpu_torch."):
                classes.setdefault("yolov6." + cls.__module__.split(".", 1)[1], set()).add(
                    cls.__name__)
        for mod_path, names in classes.items():
            parts = mod_path.split(".")
            for i in range(1, len(parts)):
                pkg = os.path.join(stub_root, *parts[:i])
                os.makedirs(pkg, exist_ok=True)
                init = os.path.join(pkg, "__init__.py")
                if not os.path.exists(init):
                    open(init, "w").close()
            with open(os.path.join(stub_root, *parts) + ".py", "w") as f:
                f.write("from torch import nn\n\n" + "".join(
                    f"\nclass {n}(nn.Module):\n    pass\n" for n in sorted(names)))
        importlib.invalidate_caches()
        for mod in list(m.modules()):
            cls = type(mod)
            if cls.__module__.startswith("yolov6_tpu_torch."):
                stub_mod = importlib.import_module("yolov6." + cls.__module__.split(".", 1)[1])
                for k in [k for k, v in vars(mod).items() if callable(v)
                          and not isinstance(v, nn.Module)]:
                    del mod.__dict__[k]
                mod.__class__ = getattr(stub_mod, cls.__name__)
        reg_max = int(src.reg_max) if getattr(src, "use_dfl", False) else 0
        proj = torch.linspace(0, reg_max, reg_max + 1)
        m.detect.proj = nn.Parameter(proj.half(), requires_grad=False)
        m.detect.proj_conv = nn.Conv2d(reg_max + 1, 1, 1, bias=False).half()
        m.detect.proj_conv.weight = nn.Parameter(proj.view(1, -1, 1, 1).half(),
                                                 requires_grad=False)
        return m

    params = [p.detach().float().cpu().requires_grad_() for p in model.parameters()]
    optimizer = torch.optim.SGD(params, lr=0.01, momentum=0.937, nesterov=True)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lr_lambda=lambda e: 1.0)
    for p in params:
        p.grad = torch.zeros_like(p)
    optimizer.step()
    scheduler.step()
    for group in optimizer.param_groups:
        group["lr"] = np.interp(10, [0, 1000], [0.0, group["initial_lr"]])
        group["momentum"] = np.interp(10, [0, 1000], [0.8, 0.937])
    ckpt = {"scheduler": scheduler.state_dict(), "epoch": epoch,
            "results": (np.float64(0.25), np.float64(0.125))}
    sys.path.insert(0, stub_root)
    try:
        if ema is None:
            ckpt.update(model=as_upstream(model), ema=None, updates=None, optimizer=None)
        else:
            ckpt.update(model=as_upstream(model), ema=as_upstream(ema), updates=10,
                        optimizer=optimizer.state_dict())
        torch.save(ckpt, path)
    finally:
        sys.path.remove(stub_root)
        for name in [n for n in sys.modules if n == "yolov6" or n.startswith("yolov6.")]:
            del sys.modules[name]
    return path
