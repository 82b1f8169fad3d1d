"""Python config files with ``_base_`` inheritance.

Mirrors the mmengine ``Config.fromfile`` surface the reference's configs
rely on (SURVEY §5 "Config / flag system"): a config is a python file
whose module-level variables are the config dict; ``_base_`` lists
parent configs (paths relative to the file) that are deep-merged in
order, child values overriding parents. CLI ``--cfg-options a.b.c=v``
dotted overrides are supported like mmengine DictAction.

The registry-string machinery is deliberately NOT ported (SURVEY §7
architecture stance) — configs carry plain values and the runner maps
the handful of ``type=`` names it knows about.
"""
from __future__ import annotations

import copy
import os.path as osp
from typing import Any, Dict, List, Optional


class Config(dict):
    """dict with attribute access (recursive)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict) and not isinstance(obj, Config):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, Config):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def get_nested(self, dotted: str, default=None):
        cur: Any = self
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Recursively merge ``override`` into ``base`` (override wins).

    ``_delete_=True`` in an override dict replaces instead of merging
    (mmengine convention).
    """
    out = copy.deepcopy(base)
    for k, v in override.items():
        if (
            k in out
            and isinstance(out[k], dict)
            and isinstance(v, dict)
            and not v.get("_delete_", False)
        ):
            out[k] = deep_merge(out[k], v)
        else:
            v = copy.deepcopy(v)
            if isinstance(v, dict):
                v.pop("_delete_", None)
            out[k] = v
    return out


def _exec_config(path: str) -> Dict:
    with open(path) as f:
        src = f.read()
    ns: Dict[str, Any] = {"__file__": osp.abspath(path)}
    exec(compile(src, path, "exec"), ns)
    return {
        k: v
        for k, v in ns.items()
        if not k.startswith("__") and not callable(v) and not isinstance(v, type(osp))
    }


def load_config(path: str, overrides: Optional[List[str]] = None) -> Config:
    """Load a config file, resolving ``_base_`` inheritance."""
    raw = _exec_config(path)
    bases = raw.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict = {}
    for b in bases:
        base_cfg = load_config(osp.join(osp.dirname(path), b))
        merged = deep_merge(merged, base_cfg)
    merged = deep_merge(merged, raw)
    cfg = Config.wrap(merged)
    cfg["filename"] = osp.abspath(path)
    for item in overrides or []:
        key, _, value = item.partition("=")
        _set_dotted(cfg, key, _parse_value(value))
    return cfg


def _parse_value(s: str):
    import ast

    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def _set_dotted(cfg: Dict, dotted: str, value):
    parts = dotted.split(".")
    cur = cfg
    for p in parts[:-1]:
        cur = cur.setdefault(p, Config())
    cur[parts[-1]] = value
