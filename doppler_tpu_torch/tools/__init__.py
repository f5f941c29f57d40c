"""Measuring and conformance tools of the port, each runnable as
``python -m doppler_tpu_torch.tools.<name>``: ``bench`` (the counterpart of
``bench.py``), ``roofline``,
``probe_chain_precision``, ``probe_cascade_precision``, ``probe_split_tail``,
``conformance``.  Every tool takes ``--device
{cuda,cpu}``, defaults to ``cuda`` and fails without a card; ``--device cpu``
runs the kernels' plain versions (a check of the control flow, not a
measurement)."""
