"""bin_ms.densify: ``bin_ms.train`` in a densify-phase cell, which reports
``train_it_per_s.densify`` in place of ``train_it_per_s``."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("bin_ms.train.py")))["read"]
