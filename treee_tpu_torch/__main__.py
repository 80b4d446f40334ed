"""``python -m treee_tpu_torch`` == ``python -m treee_tpu_torch.app``."""

from .app import main

if __name__ == "__main__":
    raise SystemExit(main())
