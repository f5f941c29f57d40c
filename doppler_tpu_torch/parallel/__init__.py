"""Splitting a run over processes: the host split of the stream
(``distributed``)."""
