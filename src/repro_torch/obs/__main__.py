"""``python -m repro_torch.obs``: the forensics CLI (``obs/cli.py``)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
