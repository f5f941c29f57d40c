"""``python -m doppler_tpu_torch`` — the doppler-compatible CLI entry point."""

import sys

from doppler_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
