"""``contrib`` namespace (counterpart of ``paddle_tpu/contrib``). Only
``mixed_precision`` is ported; the other contrib modules wait in
ROADMAP.md's queue."""
from . import mixed_precision  # noqa: F401
