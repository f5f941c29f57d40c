"""Block framing for IQ byte streams — the host I/O edge of the pipeline.

Mirrors the reference's framing contract (main.rs:49,63,98):

- the stream is consumed in fixed ``block_bytes`` reads (reference: 8192);
- a *short* read (fewer bytes than requested) marks EOF;
- the partial tail block IS processed before stopping;
- bytes beyond the last whole IQ pair are dropped (the reference would have
  panicked on them — dsp.rs:87,103; we degrade gracefully and log).

The pipeline consumes many reference-sized blocks per device dispatch
(a *chunk*), so the reader also exposes ``read_chunk`` which gathers up to
``n_blocks`` blocks while preserving per-block accounting for the track-mode
Doppler staircase (SURVEY §3.2).
"""

from __future__ import annotations

import io
import queue
import threading
from dataclasses import dataclass

__all__ = [
    "BlockReader",
    "ByteRangeReader",
    "Chunk",
    "ChunkPrefetcher",
    "REFERENCE_BLOCK_BYTES",
    "bytes_per_sample",
]

REFERENCE_BLOCK_BYTES = 8192  # main.rs:49


def bytes_per_sample(dtype: str) -> int:
    """Wire bytes per IQ sample pair: i16 → 4, f32 → 8."""
    if dtype == "i16":
        return 4
    if dtype == "f32":
        return 8
    raise ValueError(f"unknown IQ dtype {dtype!r} (want 'i16' or 'f32')")


@dataclass
class Chunk:
    """A batch of reference-sized blocks read from the stream.

    ``data``          : the raw bytes (``sum(block_sizes)`` long).
    ``block_sizes``   : bytes per constituent block; all equal to
                        ``block_bytes`` except possibly the last.
    ``eof``           : True if the stream ended inside this chunk.
    """

    data: bytes
    block_sizes: list[int]
    eof: bool

    @property
    def n_blocks(self) -> int:
        return len(self.block_sizes)


class BlockReader:
    """Reads a binary stream in reference-block units.

    ``read_block`` returns ``(data, eof)`` with the reference's exact
    semantics: ``eof`` iff fewer than ``block_bytes`` arrived.  Uses
    ``readinto``-style accumulation so pipe fragmentation (common under
    ``rtl_fm | doppler``) doesn't produce spurious EOFs — the reference's
    byte-iterator ``take(8192)`` has the same keep-reading behavior.
    """

    def __init__(self, f: io.RawIOBase | io.BufferedIOBase, block_bytes: int = REFERENCE_BLOCK_BYTES):
        if block_bytes <= 0:
            raise ValueError("block_bytes must be positive")
        self._f = f
        self.block_bytes = block_bytes

    def read_block(self) -> tuple[bytes, bool]:
        want = self.block_bytes
        parts: list[bytes] = []
        got = 0
        while got < want:
            piece = self._f.read(want - got)
            if not piece:
                break
            parts.append(piece)
            got += len(piece)
        data = b"".join(parts)
        return data, len(data) != want

    def read_chunk(self, n_blocks: int, before_block=None) -> Chunk:
        """Gather up to ``n_blocks`` blocks (stopping early at EOF).
        ``before_block``, if given, is called before each block's read."""
        datas: list[bytes] = []
        sizes: list[int] = []
        eof = False
        for _ in range(n_blocks):
            if before_block is not None:
                before_block()
            data, eof = self.read_block()
            if data:
                datas.append(data)
                sizes.append(len(data))
            if eof:
                break
        return Chunk(b"".join(datas), sizes, eof)


class ChunkPrefetcher:
    """Background-thread chunk reader: overlap stdin I/O with device compute.

    Wraps a :class:`BlockReader` and keeps up to ``depth`` chunks staged in a
    bounded queue, read by a daemon thread (the ``read()`` syscall releases
    the GIL, so staging genuinely overlaps host planning and device work —
    the double-buffered input path of SURVEY §7 "host I/O becoming the
    bottleneck").  Drop-in for the reader inside :meth:`Pipeline.run`: it
    exposes the same ``read_chunk`` surface, but the chunk width is fixed at
    construction (the pipeline always asks for ``chunk_blocks``).

    Reader exceptions are re-raised on the consumer thread at the matching
    ``read_chunk`` call; the thread always enqueues a final EOF chunk so the
    consumer terminates.

    A take from the queue has no block boundaries, so ``read_chunk`` never
    calls its ``before_block``: the run loop emits the chunk in flight
    after the next chunk's dispatch, never during its read.
    """

    def __init__(self, reader: BlockReader, n_blocks: int, depth: int = 2):
        if depth <= 0:
            raise ValueError("depth must be positive")
        self._reader = reader
        self.n_blocks = int(n_blocks)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        while True:
            try:
                chunk = self._reader.read_chunk(self.n_blocks)
            except Exception as e:  # surface on the consumer side
                self._q.put(e)
                return
            self._q.put(chunk)
            if chunk.eof:
                return

    def read_chunk(self, n_blocks: int, before_block=None) -> Chunk:
        if n_blocks != self.n_blocks:
            raise ValueError(
                f"prefetcher staged {self.n_blocks}-block chunks, "
                f"asked for {n_blocks}"
            )
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item


class ByteRangeReader:
    """File-like view of ``[lo, hi)`` of a seekable binary file.

    The multi-host input path (parallel/distributed.py): each host opens
    the shared capture and streams only its own byte range; EOF is the
    range end, so the per-host pipeline sees exactly its sub-stream with
    the reference's short-read semantics.
    """

    def __init__(self, f, lo: int, hi: int):
        if lo < 0 or hi < lo:
            raise ValueError(f"bad byte range [{lo}, {hi})")
        self._f = f
        self._end = int(hi)
        self._pos = int(lo)
        f.seek(self._pos)

    def read(self, n: int = -1) -> bytes:
        remaining = self._end - self._pos
        if remaining <= 0:
            return b""
        if n is None or n < 0 or n > remaining:
            n = remaining
        data = self._f.read(n)
        self._pos += len(data)
        return data

    def close(self) -> None:
        self._f.close()
