"""Meters and the event log, counterpart of ``cmhse_tpu/utils/logging.py``:
``AverageMeter`` and ``LogCollector`` (the reference's console line) and
``JsonlLogger`` (structured JSONL beside the checkpoints, with best-effort
TensorBoard scalars).
"""

from __future__ import annotations

import json
import os
import time
from collections import OrderedDict


class AverageMeter:
    """Running average (same semantics as the reference's meter)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self) -> str:
        return f"{self.val:.4f} ({self.avg:.4f})"


class LogCollector:
    """Named group of meters; one per train step, printed every log_step."""

    def __init__(self) -> None:
        self.meters: "OrderedDict[str, AverageMeter]" = OrderedDict()

    def update(self, k: str, v: float, n: int = 1) -> None:
        if k not in self.meters:
            self.meters[k] = AverageMeter()
        self.meters[k].update(v, n)

    def __str__(self) -> str:
        return "  ".join(f"{k} {m}" for k, m in self.meters.items())


class JsonlLogger:
    """Append-only JSONL event log next to the checkpoints, with optional
    TensorBoard scalars (``torch.utils.tensorboard``; best-effort: skipped
    when its writer cannot be imported).

    ``enabled=False`` makes every method a no-op without opening the file
    (one writer per log when several processes share the storage)."""

    def __init__(self, path: str, tensorboard: bool = True,
                 enabled: bool = True) -> None:
        self.enabled = enabled
        self.path = path
        self._fh = None
        self._tb = None
        if not enabled:
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a", buffering=1)
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                run_dir = os.path.dirname(os.path.abspath(path))
                self._tb = SummaryWriter(log_dir=os.path.join(run_dir, "tb"))
            except Exception:  # no tensorboard package: scalars are optional
                self._tb = None

    @staticmethod
    def _jsonable(v):
        """numpy scalars, 0-d arrays and 0-d tensors are what callers log
        from device results; coerce them instead of raising."""
        if hasattr(v, "item") and getattr(v, "ndim", None) in (0, None):
            try:
                return v.item()
            except (TypeError, ValueError, RuntimeError):
                pass
        if hasattr(v, "tolist"):
            return v.tolist()
        return str(v)

    def log(self, event: str, **fields) -> None:
        if not self.enabled:
            return
        rec = {"t": time.time(), "event": event, **fields}
        self._fh.write(json.dumps(rec, default=self._jsonable) + "\n")
        if self._tb is not None:
            step = int(fields.get("step", fields.get("epoch", 0)) or 0)
            for k, v in fields.items():
                if isinstance(v, (int, float)) and k not in ("step", "epoch"):
                    self._tb.add_scalar(f"{event}/{k}", v, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._fh is not None:
            self._fh.close()
