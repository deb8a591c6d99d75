"""Fleet base: role makers + Fleet interface."""
from .role_maker import Role, PaddleCloudRoleMaker, UserDefinedRoleMaker  # noqa: F401
from .fleet_base import Fleet, DistributedOptimizer  # noqa: F401
