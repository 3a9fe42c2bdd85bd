"""Environment registry and JSON-config construction.

Counterpart of ``tfmpc_tpu/models/registry.py``: env name -> constructor,
and ``make_env``/``load_env`` build an env from the JSON configs of
``configs/`` (the same schema). Envs are built on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict

import torch

from tfmpc_tpu_torch.models.base import Env
from tfmpc_tpu_torch.models.hvac import make_hvac
from tfmpc_tpu_torch.models.linear import make_linear_system
from tfmpc_tpu_torch.models.navigation import make_navigation
from tfmpc_tpu_torch.models.reservoir import make_reservoir

_REGISTRY: Dict[str, Callable[..., Env]] = {}

# Keys consumed by the CLI/solver rather than the env constructors (the
# config files carry the initial state beside the env's parameters).
_NON_ENV_KEYS = ("name", "x0")


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def registered() -> Dict[str, Callable[..., Env]]:
    return dict(_REGISTRY)


@register("navigation")
def _make_navigation_cfg(config: Dict[str, Any], dtype=torch.float32,
                         device="cuda") -> Env:
    return make_navigation(
        goal=config["goal"],
        deceleration=config.get("deceleration"),
        low=config.get("low"),
        high=config.get("high"),
        dtype=dtype,
        device=device,
    )


@register("hvac")
def _make_hvac_cfg(config: Dict[str, Any], dtype=torch.float32,
                   device="cuda") -> Env:
    kwargs = {
        k: v for k, v in config.items() if k not in _NON_ENV_KEYS + ("adj",)
    }
    return make_hvac(config["adj"], dtype=dtype, device=device, **kwargs)


@register("reservoir")
def _make_reservoir_cfg(config: Dict[str, Any], dtype=torch.float32,
                        device="cuda") -> Env:
    kwargs = {k: v for k, v in config.items() if k not in _NON_ENV_KEYS}
    return make_reservoir(dtype=dtype, device=device, **kwargs)


@register("linear")
def _make_linear_cfg(config: Dict[str, Any], dtype=torch.float32,
                     device="cuda") -> Env:
    kwargs = {
        k: v for k, v in config.items() if k not in _NON_ENV_KEYS + ("A", "B")
    }
    return make_linear_system(config["A"], config["B"], dtype=dtype,
                              device=device, **kwargs)


def make_env(config: Dict[str, Any], dtype=torch.float32,
             device="cuda") -> Env:
    """Construct an env from a config dict ``{"name": ..., <env kwargs>}``."""
    if "name" not in config:
        raise ValueError(
            f"env config must contain a 'name' key; got keys {sorted(config)}"
        )
    name = config["name"]
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown env '{name}'; registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](config, dtype=dtype, device=device)


def load_env(path, dtype=torch.float32, device="cuda") -> Env:
    """Load an env from a JSON config file (the CLI's ``--env`` path)."""
    with open(path) as f:
        config = json.load(f)
    return make_env(config, dtype=dtype, device=device)
