"""Fleet distributed-training API, its collective mode (the reference's
``incubate/fleet``). The parameter-server mode is ROADMAP.md's."""
from . import base  # noqa: F401
