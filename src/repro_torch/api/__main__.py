"""Entry point: ``PYTHONPATH=src python -m repro_torch.api`` (see cli.py)."""

from .cli import main

if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:  # stdout piped into head/less that exited
        raise SystemExit(0)
