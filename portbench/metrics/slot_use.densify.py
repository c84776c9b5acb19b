"""slot_use.densify: ``slot_use.train`` in a densify-phase cell, which reports
``train_it_per_s.densify`` in place of ``train_it_per_s``."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("slot_use.train.py")))["read"]
