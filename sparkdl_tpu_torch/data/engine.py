"""Serial in-order execution of a frame's plan — counterpart of
``sparkdl_tpu/data/engine.py`` (whose thread-parallel host stages and
re-chunking of device stages wait for a later slice)."""

from __future__ import annotations

from typing import Iterator, Sequence


def execute(sources: Sequence, plan: Sequence) -> Iterator[dict]:
    """Load each partition in order and run every plan stage on it."""
    for source in sources:
        batch = source.load()
        for stage in plan:
            batch = stage.fn(batch)
        yield batch
