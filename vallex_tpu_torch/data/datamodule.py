"""Argparse-driven train/valid dataloaders, the TtsDataModule surface (port
of vallex_tpu/data/datamodule.py).

The reference's datamodule (data/datamodule.py:62-419) is inert upstream
(its lhotse/icefall imports are commented out); this is the JAX package's
functional equivalent over the HDF5 pipeline in dataset.py, with its flags
and defaults. The stream of global batches is shard `args.data_shard`
((node index, node count) under the trainer's --init-distributed, as the
JAX package shards by (process_index, process_count); else (0, 1)): every
dp rank reads it and takes its own rows (parallel/mesh.py::dp_batch).
"""

from __future__ import annotations

import argparse
import os
from typing import Iterator


class TtsDataModule:
    def __init__(self, args: argparse.Namespace):
        self.args = args

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group(
            title="TTS data related options",
            description="Options for the HDF5 EnCodec-code data pipeline",
        )
        group.add_argument("--data-dir", type=str, default="data")
        group.add_argument(
            "--max-duration", type=float, default=120.0,
            help="max total seconds of audio per batch",
        )
        group.add_argument(
            "--max-cut-duration", type=float, default=20.0,
            help="drop utterances longer than this many seconds",
        )
        group.add_argument("--num-buckets", type=int, default=10)
        group.add_argument("--shuffle", type=bool, default=True)
        group.add_argument("--seed", type=int, default=42)
        group.add_argument(
            "--pack", type=int, default=1,
            help="utterances per packed row (sequence packing; train "
                 "split only, prefix modes 0/1)",
        )

    def _loader(
        self, split: str, shuffle: bool, epoch: int = 0, pack: int = 1
    ) -> Iterator[dict]:
        from .dataset import create_dataloader

        d = self.args.data_dir
        return create_dataloader(
            os.path.join(d, f"{split}.hdf5"),
            os.path.join(d, f"{split}.txt"),
            max_duration=self.args.max_duration,
            max_size=self.args.max_cut_duration,
            num_buckets=self.args.num_buckets,
            shuffle=shuffle,
            seed=self.args.seed + epoch,
            shard=getattr(self.args, "data_shard", (0, 1)),
            pack=pack,
        )

    def train_dataloaders(self, epoch: int = 0) -> Iterator[dict]:
        return self._loader(
            "train", self.args.shuffle, epoch,
            pack=getattr(self.args, "pack", 1),
        )

    def valid_dataloaders(self) -> Iterator[dict]:
        return self._loader("valid", shuffle=False)

    def test_dataloaders(self) -> Iterator[dict]:
        return self._loader("test", shuffle=False)
