"""Dataset composition and rank/world sharding.

Counterpart of cosyvoice_tpu/data/dataset.py: a data-list file of parquet
shards is shuffled per epoch (random.Random(epoch)), partitioned by (rank,
world_size) with the ragged tail dropped so that every rank sees the same
shard count, and run through the processor chain (data/processor.py).
"""

import random
from typing import Callable, Iterator, Sequence


class DataList:
    def __init__(self, paths: Sequence[str], shuffle: bool = True, partition: bool = True,
                 rank: int = 0, world_size: int = 1, epoch: int = 0):
        self.paths = list(paths)
        self.shuffle = shuffle
        self.partition = partition
        self.rank = rank
        self.world_size = world_size
        self.epoch = epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[dict]:
        paths = list(self.paths)
        if self.shuffle:
            random.Random(self.epoch).shuffle(paths)
        if self.partition and self.world_size > 1:
            n = (len(paths) // self.world_size) * self.world_size
            paths = paths[self.rank : n : self.world_size]
        for p in paths:
            yield {"src": p}


class Dataset:
    """The processor chain over the shards of `data_list_file` (one path a
    line). `pipeline` entries take an iterator and return one, typically
    functools.partial-bound processors. Shards are shuffled in training
    mode only."""

    def __init__(self, data_list_file: str, pipeline: Sequence[Callable], mode: str = "train",
                 shuffle: bool = True, partition: bool = True, rank: int = 0, world_size: int = 1):
        with open(data_list_file) as f:
            paths = [line.strip() for line in f if line.strip()]
        self.source = DataList(paths, shuffle=shuffle and mode == "train", partition=partition, rank=rank,
                               world_size=world_size)
        self.pipeline = list(pipeline)

    def set_epoch(self, epoch: int):
        self.source.set_epoch(epoch)

    def __iter__(self):
        it = iter(self.source)
        for fn in self.pipeline:
            it = fn(it)
        return it
