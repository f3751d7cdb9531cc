"""Metric writers with a wandb-like `log(dict)` protocol.

Copy of `flowcompare_tpu/train/metrics.py` (`MetricWriter`, `JsonlWriter`,
`StdoutWriter`, `WandbWriter`, `MultiWriter`); that module imports no JAX,
and the port keeps its own copy so that it imports nothing of the JAX
package. `wandb` is imported only when a `WandbWriter` is built.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricWriter:
    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JsonlWriter(MetricWriter):
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")
        self._t0 = time.time()

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        rec = {"_t": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = step
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue  # non-scalar objects are skipped
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class StdoutWriter(MetricWriter):
    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        scalars = {k: (round(float(v), 5) if hasattr(v, "__float__") else "...")
                   for k, v in metrics.items()}
        print(f"[step {step}] {scalars}")


class WandbWriter(MetricWriter):
    def __init__(self, project: str = "flow_change", config: Optional[dict] = None):
        import wandb  # only where a run asks for it: neither machine installs it
        self._wandb = wandb
        self._run = wandb.init(project=project, config=config)

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._run.finish()


class MultiWriter(MetricWriter):
    def __init__(self, *writers: MetricWriter):
        self.writers = writers

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        for w in self.writers:
            w.log(metrics, step)

    def close(self) -> None:
        for w in self.writers:
            w.close()
