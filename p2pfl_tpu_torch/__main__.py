"""``python -m p2pfl_tpu_torch`` -> the CLI."""

import sys

from p2pfl_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
