"""`python -m lightgbm_tpu_torch` — CLI entry (reference src/main.cpp)."""
from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
