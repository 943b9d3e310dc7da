"""`python -m csdr_tpu_torch <command> ...`: the csdr-compatible CLI on the
card (``python -m csdr_tpu_torch.cli`` is the same entry)."""

import sys

from csdr_tpu_torch.cli import main

sys.exit(main())
