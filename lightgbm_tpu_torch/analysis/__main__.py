"""`python -m lightgbm_tpu_torch.analysis` — run torch-lint."""
from .tpu_lint import main

if __name__ == "__main__":
    raise SystemExit(main())
