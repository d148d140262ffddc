"""Meters, the event log and the timing helpers."""

from cmhse_tpu_torch.utils.logging import (AverageMeter, JsonlLogger,
                                           LogCollector)
from cmhse_tpu_torch.utils.timing import Timer, throughput

__all__ = ["AverageMeter", "JsonlLogger", "LogCollector", "Timer",
           "throughput"]
