"""Experiment-management utilities: JSON config dumps, append-only CSV
metrics, run-dir layout (a copy of `lct_gan_tpu/utils/config.py`;
reference: train.py:39-94, 525-549)."""

from __future__ import annotations

import csv
import dataclasses
import json
import os
from datetime import datetime
from typing import Any, Dict, List, Optional

__all__ = [
    "to_jsonable",
    "write_json",
    "append_csv_row",
    "now_timestamp",
    "ensure_dir",
]


def now_timestamp() -> str:
    """Filesystem-safe timestamp, e.g. 20260105_142530
    (reference: train.py:39-42)."""
    return datetime.now().strftime("%Y%m%d_%H%M%S")


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def to_jsonable(obj: Any) -> Any:
    """Best-effort conversion of configs/namespaces into JSON types
    (reference: train.py:50-64)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    if hasattr(obj, "__dict__"):
        return {k: to_jsonable(v) for k, v in vars(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def write_json(path: str, payload: Any) -> None:
    ensure_dir(os.path.dirname(path) or ".")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_jsonable(payload), f, indent=2, sort_keys=True)


def append_csv_row(csv_path: str, row: Dict[str, Any],
                   fieldnames: Optional[List[str]] = None) -> None:
    """Append a row, creating the file with a header if missing; reuse the
    existing header for stable ordering (reference: train.py:73-94)."""
    ensure_dir(os.path.dirname(csv_path) or ".")
    file_exists = os.path.exists(csv_path)
    if fieldnames is None:
        if file_exists:
            with open(csv_path, "r", encoding="utf-8", newline="") as rf:
                header = next(csv.reader(rf), None)
            fieldnames = header if header else list(row.keys())
        else:
            fieldnames = list(row.keys())
    with open(csv_path, "a", encoding="utf-8", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        if not file_exists:
            writer.writeheader()
        writer.writerow(row)
