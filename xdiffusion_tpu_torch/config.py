"""Configuration: YAML -> DotConfig, and `{target, params}` instantiation.

Counterpart of xdiffusion_tpu/config.py. Config targets name the JAX
package (`xdiffusion_tpu.*`) or the original project (`xdiffusion.*`);
both resolve to this package's classes, and `torch.nn.Identity` to
`context.Identity`.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

import yaml

PACKAGE = "xdiffusion_tpu_torch"


class DotConfig:
    """Dot-accessible view over a nested dict: `cfg.a.b`, `"a" in cfg`,
    `cfg["a"]`, `.get`, `.to_dict()`."""

    def __init__(self, cfg: Dict):
        self._cfg = cfg

    def __getattr__(self, k):
        if k.startswith("_"):
            raise AttributeError(k)
        try:
            v = self._cfg[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return DotConfig(v) if isinstance(v, dict) else v

    def __getitem__(self, k):
        v = self._cfg[k]
        return DotConfig(v) if isinstance(v, dict) else v

    def __contains__(self, k) -> bool:
        return k in self._cfg

    def __iter__(self):
        return iter(self._cfg)

    def keys(self):
        return self._cfg.keys()

    def get(self, k, default=None):
        v = self._cfg.get(k, default)
        return DotConfig(v) if isinstance(v, dict) else v

    def to_dict(self) -> Dict:
        return self._cfg

    def __repr__(self):
        return f"DotConfig({self._cfg!r})"


def load_yaml(path: str) -> DotConfig:
    with open(path, "r") as f:
        return DotConfig(yaml.safe_load(f))


# Schedulers resolve to factory functions rather than their classes; the
# torch optimizer names of the reference configs to the port's factories.
_ALIASES = {
    "torch.nn.Identity": f"{PACKAGE}.context.Identity",
    "torch.optim.Adam": f"{PACKAGE}.optim.Adam",
    "torch.optim.AdamW": f"{PACKAGE}.optim.AdamW",
    "torch.optim.lr_scheduler.LinearLR": f"{PACKAGE}.optim.LinearLR",
    "torch.optim.lr_scheduler.ConstantLR": f"{PACKAGE}.optim.ConstantLR",
    **{
        f"{root}.scheduler.DiscreteNoiseScheduler":
            f"{PACKAGE}.scheduler.discrete_noise_scheduler"
        for root in ("xdiffusion", "xdiffusion_tpu", PACKAGE)
    },
}
_PREFIXES = ("xdiffusion_tpu.", "xdiffusion.", "image_diffusion.")


def resolve_target(path: str) -> str:
    """The dotted path in this package that a config target names."""
    if path in _ALIASES:
        return _ALIASES[path]
    if path.startswith(PACKAGE + "."):
        return path
    for prefix in _PREFIXES:
        if path.startswith(prefix):
            return PACKAGE + "." + path[len(prefix):]
    raise ImportError(f"config target {path!r} names nothing in {PACKAGE}")


def get_obj_from_str(path: str) -> Any:
    module_name, _, name = resolve_target(path).rpartition(".")
    module = importlib.import_module(module_name)
    try:
        return getattr(module, name)
    except AttributeError as e:
        raise ImportError(f"config target {path!r}: {module_name} has no {name}") from e


def instantiate_from_config(config, use_config_struct: bool = False, **extra_kwargs) -> Any:
    """Instantiates `config.target` with `config.params` (or, with
    `instantiate_with_config_struct`, with `config=DotConfig(params)`)."""
    if config is None:
        return None
    if isinstance(config, DotConfig):
        config = config.to_dict()
    if "target" not in config:
        raise KeyError(f"Expected `target` key in config block: {config}")
    cls = get_obj_from_str(config["target"])
    params = config.get("params", {}) or {}
    if use_config_struct or config.get("instantiate_with_config_struct", False):
        return cls(config=DotConfig(params), **extra_kwargs)
    return cls(**params, **extra_kwargs)


def instantiate_partial_from_config(config):
    """A constructor for `config.target` with `config.params` bound."""
    if isinstance(config, DotConfig):
        config = config.to_dict()
    cls = get_obj_from_str(config["target"])
    params = config.get("params", {}) or {}

    def _ctor(**kwargs):
        return cls(**params, **kwargs)

    return _ctor


def type_from_config(config) -> Any:
    if isinstance(config, DotConfig):
        config = config.to_dict()
    return get_obj_from_str(config["target"])
