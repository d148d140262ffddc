"""Meters and the event log."""

from cmhse_tpu_torch.utils.logging import (AverageMeter, JsonlLogger,
                                           LogCollector)

__all__ = ["AverageMeter", "JsonlLogger", "LogCollector"]
