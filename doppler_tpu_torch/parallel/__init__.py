"""Splitting a run: over processes by stream range (``distributed``), and
inside one process over a ``(channel, time)`` grid of devices (``mesh``,
with the sharded steps of ``sharded``)."""
