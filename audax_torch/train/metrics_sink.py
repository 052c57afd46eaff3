"""Metrics sinks: structured JSONL + logger + optional W&B (own copy of
``audax/train/metrics_sink.py``).

The primary sink is a local JSONL file; W&B mirrors it only when
``WANDB_API_KEY`` is set (or ``use_wandb=True``) and the package imports.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Optional

from audax_torch.core.logging import get_logger

__all__ = ["MetricsSink"]

log = get_logger("audax_torch.metrics")


def _to_py(v):
    try:
        v = v.item()  # numpy / torch scalar
    except AttributeError:
        pass
    except (ValueError, TypeError, RuntimeError):
        # array-valued metric: degrade to a list rather than killing a run
        try:
            return [_to_py(x) for x in list(v)]
        except Exception:
            return str(v)
    # NaN/Inf would serialize as invalid JSON; null keeps the line readable
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class MetricsSink:
    """Write metric dicts to JSONL (and W&B when creds + package exist)."""

    def __init__(self, run_name: str, out_dir: str = "artifacts/runs",
                 config: Optional[Dict] = None, use_wandb: Optional[bool] = None):
        self.run_name = run_name
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{run_name}.metrics.jsonl")
        self._fh = open(self.path, "a", encoding="utf-8")
        self._wandb = None
        if use_wandb is None:
            use_wandb = bool(os.environ.get("WANDB_API_KEY"))
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(
                    project=os.environ.get("WANDB_PROJECT", "audax"),
                    entity=os.environ.get("WANDB_ENTITY") or None,
                    name=run_name, config=config or {},
                )
            except Exception as e:  # missing package / offline
                log.warning("wandb unavailable (%s); JSONL sink only", e)
        if config:
            self._fh.write(json.dumps({"_config": config, "_run": run_name}) + "\n")

    def log(self, metrics: Dict, step: Optional[int] = None, *,
            prefix: str = "", echo: bool = True) -> None:
        record = {(prefix + k if prefix else k): _to_py(v)
                  for k, v in metrics.items()}
        if step is not None:
            record["step"] = int(step)
        record["ts"] = time.time()
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if k != "ts"},
                            step=step)
        if echo:
            shown = {k: (f"{v:.4f}" if isinstance(v, float) else v)
                     for k, v in record.items() if k != "ts"}
            log.info("%s %s", self.run_name, shown)

    def log_image(self, name: str, path: str, step: Optional[int] = None) -> None:
        self.log({name: path}, step=step, echo=False)
        if self._wandb is not None:
            import wandb
            self._wandb.log({name: wandb.Image(path)}, step=step)

    def close(self) -> None:
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
