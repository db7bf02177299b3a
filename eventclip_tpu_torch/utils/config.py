"""Attribute-style experiment configuration.

Port of eventclip_tpu/utils/config.py. The shared config files under
`configs/` start with `from eventclip_tpu.utils.config import Params`;
`load_params` executes them with an `__import__` that answers that one
module name with this module, so reading a config never imports the JAX
package (and registers nothing in `sys.modules`).
"""

from __future__ import annotations

import builtins
import copy
import importlib.util
import os
import sys
from typing import Any

# the module name every shared config imports `Params` from
_REFERENCE_CONFIG_MODULE = "eventclip_tpu.utils.config"


class Params:
    """Base class for experiment configs.

    Class attributes defined on subclasses become per-instance attributes on
    construction (deep-copied so CLI overrides never mutate the class).
    """

    # defaults shared by every experiment
    project = "EventCLIP-TPU"
    seed = 0

    def __init__(self, **overrides: Any):
        for klass in reversed(type(self).__mro__):
            for k, v in vars(klass).items():
                if k.startswith("__") or callable(v) or isinstance(v, (classmethod, staticmethod, property)):
                    continue
                setattr(self, k, copy.deepcopy(v))
        for k, v in overrides.items():
            setattr(self, k, copy.deepcopy(v))

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def to_dict(self) -> dict:
        return {k: v for k, v in vars(self).items() if not k.startswith("_")}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        body = ",\n  ".join(f"{k}={v!r}" for k, v in sorted(self.to_dict().items()))
        return f"{type(self).__name__}(\n  {body}\n)"


def _config_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and name == _REFERENCE_CONFIG_MODULE:
        if not fromlist:
            # `import eventclip_tpu.utils.config` binds the top package;
            # only the `from ... import Params` form can be answered here
            raise ImportError(
                f"config files must use `from {_REFERENCE_CONFIG_MODULE} "
                "import Params`"
            )
        return sys.modules[__name__]
    return builtins.__import__(name, globals, locals, fromlist, level)


def _config_file(path: str) -> str:
    if path.endswith(".py"):
        path = path[:-3]
    if os.sep in path or os.path.exists(path + ".py"):
        return path + ".py"
    spec = importlib.util.find_spec(path)  # dotted module path
    if spec is None or spec.origin is None:
        raise FileNotFoundError(f"no config module {path!r}")
    return spec.origin


def load_params(path: str, cls_name: str = "EventCLIPParams") -> Params:
    """Load a config class from a python file path or dotted module path and
    instantiate it (reference CLI contract, train.py:111-115)."""
    file_path = _config_file(path)
    with open(file_path) as f:
        source = f.read()
    namespace = {
        "__name__": os.path.splitext(os.path.basename(file_path))[0],
        "__file__": file_path,
        "__builtins__": dict(vars(builtins), __import__=_config_import),
    }
    exec(compile(source, file_path, "exec"), namespace)
    return namespace[cls_name]()
