"""Metric logging: JSONL always, tensorboard or wandb when asked for.

Port of ``consolver_tpu/utils/logging.py``, the trainers' ``log_fn`` hook
(the reference's Accelerate trackers, train_ppo.py:268-270).  tensorboard
and wandb are imported only when ``report_to`` names them, and a missing
one leaves the JSONL alone.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricLogger:
    def __init__(
        self,
        output_dir: str,
        project: str = "consolver-torch",
        report_to: str = "jsonl",  # "jsonl" | "wandb" | "tensorboard"
        config: Optional[Dict[str, Any]] = None,
    ):
        os.makedirs(output_dir, exist_ok=True)
        self.jsonl_path = os.path.join(output_dir, "metrics.jsonl")
        self._wandb = None
        self._tb = None
        if report_to == "wandb":
            try:
                import wandb

                self._wandb = wandb.init(project=project, dir=output_dir, config=config)
            except ImportError:
                pass
        elif report_to == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=output_dir)
            except ImportError:
                pass
        if config is not None:
            with open(os.path.join(output_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        record = {"step": step, "time": time.time(), **metrics}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._tb is not None:
            for k, v in metrics.items():
                try:
                    self._tb.add_scalar(k, float(v), step)
                except (TypeError, ValueError):
                    pass

    def close(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()
