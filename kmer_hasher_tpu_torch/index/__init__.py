from .position_index import KmerIndex  # noqa: F401
