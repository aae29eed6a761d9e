from .adamw import AdamW, AdamWState, cosine_schedule
from .compression import (EFState, compress, decompress,
                          dp_allreduce_compressed, ef_compress_tree,
                          ef_decompress_tree, init_ef_state)

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "EFState",
           "init_ef_state", "compress", "decompress", "ef_compress_tree",
           "ef_decompress_tree", "dp_allreduce_compressed"]
