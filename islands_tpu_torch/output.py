"""Terminal output helpers (reference: src/output.rs:8-65).

Port of islands_tpu/output.py, a copy: the module is framework-free, but
importing islands_tpu pulls in jax.

ANSI-styled status lines, a simple table renderer, and a progress line —
stdlib only (the reference uses indicatif/console/tabled)."""

from __future__ import annotations

import os
import sys
import time


def _use_color(stream) -> bool:
    return (
        hasattr(stream, "isatty") and stream.isatty()
        and os.environ.get("NO_COLOR") is None
    )


def _style(text: str, code: str, stream=None) -> str:
    stream = stream or sys.stdout
    if _use_color(stream):
        return f"\x1b[{code}m{text}\x1b[0m"
    return text


def success(msg: str) -> None:
    print(f"{_style('OK', '32;1')} {msg}")


def error(msg: str) -> None:
    print(f"{_style('ERROR', '31;1')} {msg}", file=sys.stderr)


def warning(msg: str) -> None:
    print(f"{_style('WARN', '33;1')} {msg}")


def info(msg: str) -> None:
    print(f"{_style('INFO', '36')} {msg}")


def table(headers: list[str], rows: list[list[str]]) -> str:
    """Fixed-width text table (reference: tabled usage, output.rs)."""
    cols = [headers] + [[str(c) for c in r] for r in rows]
    widths = [max(len(row[i]) for row in cols) for i in range(len(headers))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [sep]
    lines.append("| " + " | ".join(h.ljust(w) for h, w in zip(headers, widths)) + " |")
    lines.append(sep)
    for r in rows:
        lines.append(
            "| " + " | ".join(str(c).ljust(w) for c, w in zip(r, widths)) + " |"
        )
    lines.append(sep)
    return "\n".join(lines)


class ProgressBar:
    """Carriage-return progress line (reference: indicatif bar, output.rs:8-31)."""

    def __init__(self, total: int, label: str = "", stream=None):
        self.total = max(total, 1)
        self.label = label
        self.count = 0
        self.stream = stream or sys.stderr
        self._start = time.monotonic()

    def advance(self, n: int = 1) -> None:
        self.count += n
        self._draw()

    def _draw(self) -> None:
        if not _use_color(self.stream):
            return
        frac = min(self.count / self.total, 1.0)
        width = 30
        filled = int(frac * width)
        bar = "#" * filled + "-" * (width - filled)
        self.stream.write(
            f"\r{self.label} [{bar}] {self.count}/{self.total}"
        )
        self.stream.flush()

    def finish(self) -> None:
        if _use_color(self.stream):
            self.stream.write("\n")
            self.stream.flush()


class Spinner:
    """Minimal spinner stand-in; prints the label once in non-TTY contexts."""

    def __init__(self, label: str, stream=None):
        self.label = label
        self.stream = stream or sys.stderr

    def __enter__(self):
        self.stream.write(f"{self.label}...\n")
        return self

    def __exit__(self, *exc):
        return False
