"""Host -> device frame streaming.

The reference pulls one frame at a time through a generator chain
(trajectory_parser.py:217-249); at accelerator throughput that starves the device. Here
trajectory batches are re-blocked into fixed-size position blocks and prefetched
on a background thread, so host parsing/IO overlaps with device compute
(double buffering). The engine consumes :class:`FrameBlock`s and turns them into
stacked device `Frame` pytrees.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class FrameBlock:
    """A contiguous run of frames, split into donor and optional extra atoms."""

    donors: np.ndarray  # [B, N, 3] float32
    extras: Optional[np.ndarray]  # [B, M, 3] float32 or None
    start: int  # index of the first frame in the block

    @property
    def n_frames(self) -> int:
        return self.donors.shape[0]


def frame_blocks(
    trajectory,
    *,
    block_size: int,
    donor_atoms: str,
    extra_atoms: str | None = None,
    max_frames: int | None = None,
) -> Iterator[FrameBlock]:
    """Re-block a trajectory's native batches into fixed-size FrameBlocks.

    The final block may be shorter. ``trajectory`` must expose ``iter_batches()``
    yielding (names, positions [F, N_all, 3], start_index).
    """
    donor_sel = extra_sel = None
    buf_d: list[np.ndarray] = []
    buf_e: list[np.ndarray] = []
    buffered = 0
    emitted = 0
    next_start = 0

    def make_block(donors, extras, start):
        return FrameBlock(donors=donors, extras=extras, start=start)

    for names, positions, start in trajectory.iter_batches():
        if donor_sel is None:
            donor_sel = np.nonzero(names == donor_atoms)[0]
            if donor_sel.size == 0:
                raise ValueError(
                    f"No atoms of type {donor_atoms!r} in trajectory "
                    f"(found {sorted(set(names.tolist()))})"
                )
            if extra_atoms is not None:
                extra_sel = np.nonzero(names == extra_atoms)[0]
        d = positions[:, donor_sel]
        e = positions[:, extra_sel] if extra_atoms is not None else None
        if max_frames is not None:
            room = max_frames - emitted - buffered
            if room <= 0:
                break
            d = d[:room]
            e = e[:room] if e is not None else None
        buf_d.append(d)
        if e is not None:
            buf_e.append(e)
        buffered += d.shape[0]

        while buffered >= block_size:
            donors = np.concatenate(buf_d) if len(buf_d) > 1 else buf_d[0]
            extras = (
                (np.concatenate(buf_e) if len(buf_e) > 1 else buf_e[0])
                if buf_e
                else None
            )
            yield make_block(donors[:block_size],
                             extras[:block_size] if extras is not None else None,
                             next_start)
            next_start += block_size
            emitted += block_size
            rest_d = donors[block_size:]
            rest_e = extras[block_size:] if extras is not None else None
            buf_d = [rest_d] if rest_d.shape[0] else []
            buf_e = [rest_e] if rest_e is not None and rest_e.shape[0] else []
            buffered -= block_size

    if buffered:
        donors = np.concatenate(buf_d) if len(buf_d) > 1 else buf_d[0]
        extras = (
            (np.concatenate(buf_e) if len(buf_e) > 1 else buf_e[0]) if buf_e else None
        )
        yield make_block(donors, extras, next_start)


_SENTINEL = object()


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run ``iterator`` on a daemon thread, buffering ``depth`` items — classic
    double buffering so host parsing overlaps device compute."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    error: list[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as exc:  # propagate into the consumer
            error.append(exc)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if error:
                raise error[0]
            return
        yield item
