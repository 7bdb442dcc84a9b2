"""``python -m halo2_regex_tpu_torch`` -> the CLI."""

import sys

from .cli import main

sys.exit(main())
