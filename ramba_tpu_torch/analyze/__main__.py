"""CLI shim: ``python -m ramba_tpu_torch.analyze <trace.jsonl> ...``."""

from __future__ import annotations

import sys

from ramba_tpu_torch.analyze.lint import main

if __name__ == "__main__":
    sys.exit(main())
