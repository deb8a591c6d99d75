from . import fleet_util, hdfs  # noqa: F401
from .fleet_util import FleetUtil  # noqa: F401
from .hdfs import HDFSClient  # noqa: F401
