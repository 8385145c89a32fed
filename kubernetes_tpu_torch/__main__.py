"""``python -m kubernetes_tpu_torch serve|perf|config`` (copied from
``kubernetes_tpu/__main__.py``, guarded so that importing it runs nothing)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
