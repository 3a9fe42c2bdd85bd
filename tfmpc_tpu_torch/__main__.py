"""``python -m tfmpc_tpu_torch``: the command line (``cli.main``)."""

import sys

from tfmpc_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
