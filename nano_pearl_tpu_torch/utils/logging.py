"""Colored stdlib logger (reference: nano_pearl/utils/pearl_logger.py).

The reference builds a rich-based logger with a ``color=`` kwarg
extension; we provide the same call surface on top of the stdlib so the
package has zero soft dependencies.
"""

import logging
import os
import sys

_ANSI = {
    "red": "\033[31m",
    "green": "\033[32m",
    "yellow": "\033[33m",
    "blue": "\033[34m",
    "magenta": "\033[35m",
    "cyan": "\033[36m",
    "reset": "\033[0m",
}


class _ColorAdapter(logging.LoggerAdapter):
    """Accepts ``logger.info(msg, color="blue")`` like the reference logger."""

    def process(self, msg, kwargs):
        color = kwargs.pop("color", None)
        if color and sys.stderr.isatty():
            msg = f"{_ANSI.get(color, '')}{msg}{_ANSI['reset']}"
        return msg, kwargs


def _build_logger() -> _ColorAdapter:
    base = logging.getLogger("nano_pearl_tpu_torch")
    if not base.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s [%(name)s] %(levelname)s: %(message)s", "%H:%M:%S")
        )
        base.addHandler(handler)
        level = os.environ.get("NANO_PEARL_LOG_LEVEL", "INFO").upper()
        base.setLevel(getattr(logging, level, logging.INFO))
        base.propagate = False
    return _ColorAdapter(base, {})


logger = _build_logger()


def get_model_name(path: str) -> str:
    return os.path.basename(os.path.normpath(path)) if path else "<in-memory>"
