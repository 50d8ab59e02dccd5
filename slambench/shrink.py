"""Shrinking a cell for the tests: `--shrink JSON` merges {"config":
{...}, "traffic": {...}} into the cell's files as loaded (never on
disk)."""

from __future__ import annotations

import json


def merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def apply(cell, spec: str) -> None:
    s = json.loads(spec)
    merge(cell.config, s.get("config", {}))
    merge(cell.traffic, s.get("traffic", {}))
