"""The port's benchmark: the configurations (configs.py), the sustained
capacity soak (soak.py), the long-haul stability run (longhaul.py) and the
runner, ``python -m pitchvis_tpu_torch.bench`` (__main__.py).

Every file they write by default lies under the checkout's ``build/``
(listed in .gitignore), never on a file of the JAX package: those hold that
package's own measurements.
"""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(ROOT, "build")
SWEEP_PATH = os.path.join(BUILD_DIR, "BENCH_SWEEP_torch.json")
SOAK_PATH = os.path.join(BUILD_DIR, "SOAK_torch.json")
LONGHAUL_PATH = os.path.join(BUILD_DIR, "LONGHAUL_torch.json")
