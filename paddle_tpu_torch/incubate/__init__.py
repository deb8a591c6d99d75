"""incubate namespace (the reference's ``fluid/incubate``): the collective
fleet."""
from . import fleet  # noqa: F401
