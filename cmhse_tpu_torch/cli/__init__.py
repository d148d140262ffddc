"""Command-line entry points of the port, the JAX package's ``cmhse-*``
commands with the same module and flag names::

    python -m cmhse_tpu_torch.cli.build_vocab --data_path DIR
    python -m cmhse_tpu_torch.cli.train --data_path DIR ...
    python -m cmhse_tpu_torch.cli.evaluate RUN [--dump_ranks PATH]
    python -m cmhse_tpu_torch.cli.import_torch CKPT.pth.tar OUT
    python -m cmhse_tpu_torch.cli.export_torch RUN OUT.pth.tar
    python -m cmhse_tpu_torch.cli.retrieve RUN --query TEXT

Each runs on the CUDA card, and raises where there is none, unless it is
given ``--platform cpu``.
"""

from __future__ import annotations

import argparse

import torch


def add_platform_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--platform", default="gpu", choices=["gpu", "cpu"],
        help="where to run: the CUDA card (default; raises without one) or "
             "the CPU with the kernels' plain PyTorch versions")


def device_for(platform: str) -> torch.device:
    """The device a ``--platform`` value names, through ``resolve_device``:
    ``gpu`` is the card and raises where there is none."""
    from cmhse_tpu_torch.device import resolve_device

    return resolve_device("cpu" if platform == "cpu" else None)
