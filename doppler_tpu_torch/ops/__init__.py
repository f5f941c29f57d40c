"""Device compute: codecs, NCO, resampler, and the CUDA kernel wrappers."""
