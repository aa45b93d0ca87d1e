"""Global settings (dataset cache, verbosity).

The counterpart of ``infercnvpy_tpu/settings.py`` without its compile-cache
configuration: nothing here changes numerics.
"""

from __future__ import annotations

import os
from pathlib import Path

#: Directory where generated datasets are cached (apart from the JAX
#: package's, so processes of the two packages never share a half-written file).
datasetdir = Path(os.environ.get("INFERCNVPY_TPU_TORCH_DATA", "~/.cache/infercnvpy_tpu_torch")).expanduser()

#: Verbosity: 0=errors, 1=warnings, 2=info, 3=debug
verbosity = 1
