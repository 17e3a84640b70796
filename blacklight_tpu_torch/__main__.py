import sys

from blacklight_tpu_torch.cli import main

sys.exit(main())
