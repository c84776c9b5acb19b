import sys

from webdgs_tpu_torch.cli import main

sys.exit(main())
