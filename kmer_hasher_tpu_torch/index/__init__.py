from .count_store import CountStore  # noqa: F401
from .position_index import KmerIndex  # noqa: F401
