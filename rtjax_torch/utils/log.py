"""The package's logger (port of rtjax.utils.log).

Every informational print of the package goes through the module-level
``logger`` (named "rtjax_torch"), so an application can set its level, add
handlers or silence it (``logging.getLogger("rtjax_torch").setLevel(...)``).
The default handler writes bare messages to stderr at INFO.
"""

from __future__ import annotations

import logging
import sys

logger = logging.getLogger("rtjax_torch")

if not logger.handlers:  # idempotent under re-import
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def set_verbosity(level) -> None:
    """Set the package's log level (int or logging name, e.g. "DEBUG")."""
    logger.setLevel(level)
