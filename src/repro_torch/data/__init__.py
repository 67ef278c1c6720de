from .pipeline import DataConfig, Prefetcher, data_iterator, synthetic_batch

__all__ = ["DataConfig", "Prefetcher", "data_iterator", "synthetic_batch"]
