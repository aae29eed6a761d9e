from .pipeline import SyntheticCorpus, ShardedLoader

__all__ = ["SyntheticCorpus", "ShardedLoader"]
