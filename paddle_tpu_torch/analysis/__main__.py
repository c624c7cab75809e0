"""``python3 -m paddle_tpu_torch.analysis``: the capture lint over the port."""
import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
