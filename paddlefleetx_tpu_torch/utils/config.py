"""YAML config system: ``_base_`` inheritance, dotted ``-o`` overrides,
distributed-topology derivation and batch-size algebra.

A copy of ``paddlefleetx_tpu/utils/config.py`` (the port imports
nothing of the JAX package). One difference: the world size is an
argument (``nranks``, default 1 — this slice runs on one GPU) instead
of a device probe, and no environment variable is read.
"""

from __future__ import annotations

import argparse
import ast
import copy
import os
from typing import Any, Dict, List, Optional

import yaml

from .log import logger

__all__ = [
    "AttrDict", "parse_config", "override_config", "get_config",
    "process_configs", "parse_args", "bf16_enabled",
]


def bf16_enabled(config) -> bool:
    """Whether the config asks for bf16 compute (AMP-O2 policy)."""
    mix = (config.get("Engine", {}) or {}).get("mix_precision", {}) or {}
    return bool(mix.get("use_pure_fp16")
                or mix.get("dtype") == "bfloat16")


class AttrDict(dict):
    """Dict with attribute access; missing keys raise AttributeError."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __deepcopy__(self, memo):
        out = AttrDict()
        memo[id(self)] = out
        for k, v in self.items():
            out[k] = copy.deepcopy(v, memo)
        return out


def _attrify(obj: Any) -> Any:
    """Recursively convert dicts to AttrDict and literal-eval str leaves."""
    if isinstance(obj, dict):
        return AttrDict({k: _attrify(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_attrify(v) for v in obj]
    if isinstance(obj, str):
        try:
            return ast.literal_eval(obj)
        except (ValueError, SyntaxError):
            return obj
    return obj


def _merge(child: Dict, base: Dict) -> Dict:
    """Merge ``child`` over ``base`` recursively (child wins); a child
    subtree with ``_inherited_: False`` replaces the base subtree."""
    if child.get("_inherited_", True) is False:
        out = dict(child)
        out.pop("_inherited_")
        return out
    out = dict(base)
    for key, val in child.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(val, out[key])
        else:
            out[key] = val
    out.pop("_inherited_", None)
    return out


def parse_config(cfg_file: str) -> AttrDict:
    """Load a YAML file, resolving ``_base_`` inheritance relative to it."""

    def _load(path: str) -> Dict:
        with open(path, "r", encoding="utf-8") as f:
            dic = yaml.safe_load(f) or {}
        base = dic.pop("_base_", None)
        if base is not None:
            base_dic = _load(os.path.join(os.path.dirname(path), base))
            dic = _merge(dic, base_dic)
        return dic

    def _strip_markers(node):
        if isinstance(node, dict):
            node.pop("_inherited_", None)
            for v in node.values():
                _strip_markers(v)
        return node

    return _attrify(_strip_markers(_load(cfg_file)))


def _coerce(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _override(node: Any, keys: List[str], value: str) -> None:
    key: Any = keys[0]
    if isinstance(node, list):
        key = int(key)
        if len(keys) == 1:
            node[key] = _coerce(value)
        else:
            _override(node[key], keys[1:], value)
        return
    if not isinstance(node, dict):
        raise TypeError(f"cannot override into leaf node with key {key!r}")
    if len(keys) == 1:
        if key not in node:
            logger.info("new config field introduced by override: %s", key)
        node[key] = _coerce(value)
    else:
        if key in node and not isinstance(node[key], (dict, list)):
            raise TypeError(
                f"override path descends through scalar {key!r} "
                f"(= {node[key]!r}); refusing to destroy it")
        if key not in node:
            node[key] = AttrDict()
        _override(node[key], keys[1:], value)


def override_config(config: AttrDict,
                    options: Optional[List[str]] = None) -> AttrDict:
    """Apply ``-o dotted.path=value`` overrides in order."""
    for opt in options or []:
        if "=" not in opt:
            raise ValueError(f"override {opt!r} must look like key=value")
        key, value = opt.split("=", 1)
        _override(config, key.split("."), value)
    return config


def process_dist_config(config: AttrDict, nranks: int = 1) -> None:
    """Fill in degree defaults and infer dp_degree from ``nranks``."""
    dist = config.setdefault("Distributed", AttrDict())
    for key in ("mp_degree", "pp_degree"):
        if not dist.get(key):
            dist[key] = 1
    sharding = dist.setdefault("sharding", AttrDict())
    if not sharding.get("sharding_degree"):
        sharding["sharding_degree"] = 1
    sharding.setdefault("sharding_stage", 1)
    sharding.setdefault("sharding_offload", False)
    if not dist.get("cp_degree"):
        dist["cp_degree"] = 1
    other = (dist["mp_degree"] * dist["pp_degree"] * dist["cp_degree"]
             * sharding["sharding_degree"])
    if nranks % other != 0:
        raise ValueError(
            f"device count {nranks} not divisible by "
            f"mp*pp*cp*sharding = {other}")
    if not dist.get("dp_degree"):
        dist["dp_degree"] = nranks // other
    elif dist["dp_degree"] * other != nranks:
        logger.warning(
            "dp_degree %s inconsistent with %s devices "
            "(mp=%s pp=%s sharding=%s); adjusting dp_degree to %s",
            dist["dp_degree"], nranks, dist["mp_degree"], dist["pp_degree"],
            sharding["sharding_degree"], nranks // other)
        dist["dp_degree"] = nranks // other
    dist["world_size"] = nranks


def process_global_configs(config: AttrDict) -> None:
    """Batch-size algebra over the dp x sharding dataflow axis."""
    dist = config["Distributed"]
    dataflow = dist["dp_degree"] * dist["sharding"]["sharding_degree"]
    g = config.setdefault("Global", AttrDict())
    gbs, lbs = g.get("global_batch_size"), g.get("local_batch_size")
    if gbs is None and lbs is None:
        raise ValueError("global_batch_size or local_batch_size must be set")
    if gbs is not None and lbs is not None:
        if gbs != lbs * dataflow:
            raise ValueError(
                f"global_batch_size {gbs} != local_batch_size {lbs} * "
                f"(dp*sharding) {dataflow}")
    elif gbs is not None:
        if gbs % dataflow != 0:
            raise ValueError(
                f"global_batch_size {gbs} not divisible by dp*sharding "
                f"{dataflow}")
        g["local_batch_size"] = gbs // dataflow
    else:
        g["global_batch_size"] = lbs * dataflow
    if not g.get("micro_batch_size"):
        g["micro_batch_size"] = g["local_batch_size"]
    if g["local_batch_size"] % g["micro_batch_size"] != 0:
        raise ValueError(
            f"local_batch_size {g['local_batch_size']} not divisible by "
            f"micro_batch_size {g['micro_batch_size']}")


def process_engine_config(config: AttrDict) -> None:
    """Fill Engine-section defaults (save/load, run limits, mixed
    precision) in place, as the JAX package does."""
    engine = config.setdefault("Engine", AttrDict())
    save_load = engine.setdefault("save_load", AttrDict())
    if save_load.get("save_steps") in (None, -1):
        save_load["save_steps"] = 2 ** 63 - 1
    if save_load.get("save_epoch") in (None, -1):
        save_load["save_epoch"] = 1
    save_load.setdefault("output_dir", "./output")
    save_load.setdefault("ckpt_dir", None)
    if engine.get("eval_iters") is None:
        engine["eval_iters"] = 10
    if engine.get("test_iters") is None:
        engine["test_iters"] = engine["eval_iters"] * 10
    engine["accumulate_steps"] = (
        config.Global.local_batch_size // config.Global.micro_batch_size)
    mp = engine.setdefault("mix_precision", AttrDict())
    level = mp.get("level")
    if level is not None:
        if level not in ("o0", "o1", "o2", "o3"):
            raise ValueError(
                f"mix_precision.level must be o0/o1/o2/o3, got {level!r}")
        mp.setdefault("use_pure_fp16", level in ("o1", "o2", "o3"))
        if level == "o3":
            opt = config.setdefault("Optimizer", AttrDict())
            opt.setdefault("state_dtype", "bfloat16")
    mp.setdefault("use_pure_fp16", False)
    mp.setdefault("dtype", "bfloat16" if mp.get("use_pure_fp16") else "float32")
    mp.setdefault("scale_loss", 1.0)
    mp.setdefault("custom_black_list", [])
    mp.setdefault("custom_white_list", [])


def process_configs(config: AttrDict, nranks: int = 1) -> AttrDict:
    """Topology, batch-size and engine derivations, in place."""
    process_dist_config(config, nranks=nranks)
    process_global_configs(config)
    process_engine_config(config)
    return config


def get_config(fname: str, overrides: Optional[List[str]] = None,
               nranks: int = 1) -> AttrDict:
    """Parse ``fname`` with ``_base_`` inheritance, apply ``-o``
    overrides and derive the topology for ``nranks`` devices."""
    if not os.path.exists(fname):
        raise FileNotFoundError(f"config file {fname} does not exist")
    config = parse_config(fname)
    override_config(config, overrides)
    process_configs(config, nranks=nranks)
    return config


def parse_args(argv: Optional[List[str]] = None,
               extra=None) -> argparse.Namespace:
    """``-c config -o k=v`` command line, plus ``extra(parser)`` hooks."""
    parser = argparse.ArgumentParser("paddlefleetx-tpu-torch")
    parser.add_argument("-c", "--config", required=True, help="config file")
    parser.add_argument(
        "-o", "--override", action="append", default=[],
        help="override config options, e.g. -o Global.seed=1")
    if extra is not None:
        extra(parser)
    return parser.parse_args(argv)
