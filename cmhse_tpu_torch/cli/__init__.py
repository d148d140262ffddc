"""Command-line entry points of the port, the JAX package's ``cmhse-*``
commands with the same module and flag names::

    python -m cmhse_tpu_torch.cli.build_vocab --data_path DIR
    python -m cmhse_tpu_torch.cli.train --data_path DIR ...
    python -m cmhse_tpu_torch.cli.evaluate RUN [--dump_ranks PATH]
    python -m cmhse_tpu_torch.cli.import_torch CKPT.pth.tar OUT
    python -m cmhse_tpu_torch.cli.export_torch RUN OUT.pth.tar
    python -m cmhse_tpu_torch.cli.retrieve RUN --query TEXT
    python -m cmhse_tpu_torch.cli.serve_daemon RUN --socket PATH

Each runs on the CUDA card, and raises where there is none, unless it is
given ``--platform cpu`` (``retrieve --connect`` asks a running daemon
and needs no card). ``retrieve`` and ``serve_daemon`` take ``--sharded``:
one process shards the gallery over every local device
(:func:`sharded_mesh`), no ``torchrun``.
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


def sharded_mesh(platform: str):
    """The local mesh of ``--sharded`` serving: one process over every
    visible card (or, with ``--platform cpu``, the CPU shards of
    ``parallel.mesh.local_devices``), as the JAX command meshes every local
    device. Refused under ``torchrun`` with more than one rank, which would
    start a daemon a rank, each holding every shard."""
    import os

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise SystemExit(
            f"--sharded serves from one process over every local device; "
            f"run it without torchrun (WORLD_SIZE={world})")
    from cmhse_tpu_torch.parallel.mesh import local_devices, make_mesh

    return make_mesh((-1,), ("data",), devices=local_devices(platform))
