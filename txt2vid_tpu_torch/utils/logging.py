"""Timestamped logging (the port's copy of txt2vid_tpu/utils/logging.py)."""

import sys
import time


def _stamp() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S")


def status(msg: str) -> None:
    print(f"[{_stamp()}] {msg}")
    sys.stdout.flush()


def warn(msg: str) -> None:
    print(f"[{_stamp()}] WARN: {msg}", file=sys.stderr)
    sys.stderr.flush()


def error(msg: str) -> None:
    print(f"[{_stamp()}] ERROR: {msg}", file=sys.stderr)
    sys.stderr.flush()
