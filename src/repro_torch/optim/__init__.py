"""Optimiser of the port: AdamW with the cosine schedule and global-norm
clipping, and int8 error-feedback gradient compression."""
from .adamw import (AdamWConfig, AdamWState, adamw_update,
                    clip_by_global_norm, global_norm, init_adamw, schedule)
from .compression import (CompressionState, compress, compressed_grads,
                          decompress, init_compression)

__all__ = ["AdamWConfig", "AdamWState", "adamw_update",
           "clip_by_global_norm", "global_norm", "init_adamw", "schedule",
           "CompressionState", "compress", "compressed_grads", "decompress",
           "init_compression"]
