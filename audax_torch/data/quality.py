"""Dataset quality checks over the framework's Parquet artifacts (port of
``audax/data/quality.py``).

The reference kept DuckDB query cookbooks for completeness, duplicates,
class balance and shape/duration distributions
(.charles/urbansound8k_sql.md §12-§15, .charles/music2abc2mid_sql.md:22-101)
plus the queryable ``processing_success`` column; these functions run
those checks and return one structured report per dataset. The port reads
the columns with ``pyarrow`` alone (no pandas): counts by value list the
values by count, most first, ties in order of first appearance, as
pandas' ``value_counts`` does.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

__all__ = ["urbansound_quality_report", "music_quality_report",
           "format_report"]


def _read(parquet_path: str) -> Dict[str, list]:
    import pyarrow.parquet as pq
    table = pq.read_table(parquet_path)
    return {name: table.column(name).to_pylist()
            for name in table.column_names}


def _value_counts(values: List) -> Dict:
    counts: Dict = {}
    for v in values:
        counts[v] = counts.get(v, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def _duplicates(values: List) -> int:
    return len(values) - len(set(values))


def _split(df: Dict[str, list]):
    ok = df["processing_success"]
    good = {k: [v for v, s in zip(col, ok) if s] for k, col in df.items()}
    return good, len(ok), sum(not s for s in ok)


def urbansound_quality_report(parquet_path: str) -> Dict:
    """Completeness / duplicates / fold & class balance / shape checks for
    the UrbanSound8K feature Parquet."""
    df = _read(parquet_path)
    ok, rows, failed = _split(df)
    shapes = [tuple(int(x) for x in s) for s in ok["mel_shape"]]
    report = {
        "rows": rows,
        "failed_rows": failed,
        "duplicate_files": _duplicates(df["slice_file_name"]),
        "folds": {int(k): v for k, v in
                  sorted(_value_counts(ok["fold"]).items())},
        "class_balance": {str(k): v for k, v in
                          _value_counts(ok["class_name"]).items()},
        "distinct_shapes": sorted(set(shapes)),
        "all_shapes_equal": len(set(shapes)) <= 1,
        "nan_features": int(sum(
            np.isnan(np.asarray(v, np.float32)).any() for v in ok["log_mel"])),
    }
    counts = list(report["class_balance"].values())
    if counts:
        report["class_imbalance_ratio"] = round(
            max(counts) / max(min(counts), 1), 2)
    return report


def music_quality_report(parquet_path: str) -> Dict:
    """Completeness / duration & token distributions / metadata coverage for
    the music_dataset Parquet (music2abc2mid_sql.md checks)."""
    df = _read(parquet_path)
    ok, rows, failed = _split(df)
    return {
        "rows": rows,
        "failed_rows": failed,
        "duplicate_files": _duplicates(df["filename"]),
        "duration_s": _dist(np.asarray(ok["duration"], np.float32)),
        "abc_tokens": _dist(np.asarray(ok["abc_tokens"], np.int32)),
        "empty_abc": sum(len(s) == 0 for s in ok["abc_string"]),
        "missing_tempo": sum(t == 0 for t in ok["tempo"]),
        "missing_key": sum(k == "" for k in ok["key_signature"]),
        "sample_rates": {int(k): v for k, v in
                         _value_counts(ok["sample_rate"]).items()},
    }


def _dist(x: np.ndarray) -> Dict:
    if len(x) == 0:
        return {"n": 0}
    return {"n": int(len(x)), "min": float(np.min(x)),
            "p50": float(np.median(x)), "mean": float(np.mean(x)),
            "max": float(np.max(x))}


def format_report(report: Dict, title: str = "dataset quality") -> str:
    lines = [f"== {title} =="]
    for k, v in report.items():
        lines.append(f"{k:<24} {json.dumps(v, default=str)}")
    return "\n".join(lines)
