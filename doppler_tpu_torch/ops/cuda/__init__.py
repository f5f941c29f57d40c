"""Hand-written CUDA kernels (sources in ``doppler_tpu_torch/csrc``) and
their plain torch versions."""
