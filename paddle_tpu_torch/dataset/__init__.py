"""Dataset readers (reference python/paddle/dataset/).

Counterpart of ``paddle_tpu/dataset/``, kept as its own copy (numpy only):
the same ``PADDLE_TPU_DATA_HOME`` cache layout and md5 checks, and the
same deterministic synthetic stand-ins with the reference sample
contracts where the real files are absent, so both packages read the
same samples. ``common.download`` serves from the cache only; no file is
fetched."""
from . import common  # noqa: F401
from . import image  # noqa: F401
from . import mnist  # noqa: F401
from . import uci_housing  # noqa: F401
from . import cifar  # noqa: F401
from . import imdb  # noqa: F401
from . import imikolov  # noqa: F401
from . import movielens  # noqa: F401
from . import flowers  # noqa: F401
from . import wmt14  # noqa: F401
from . import wmt16  # noqa: F401
from . import conll05  # noqa: F401
from . import voc2012  # noqa: F401
from . import sentiment  # noqa: F401
from . import mq2007  # noqa: F401
