"""Data: synthetic generators (seeded; the LM token stream and the KRR
sets), chunk sources for out-of-core fits, and CSR sparse rows."""
from .chunks import (ArrayChunkSource, Chunk, ChunkSource,
                     GeneratorChunkSource, MemmapChunkSource, as_chunk_source,
                     gather_rows)
from .pipeline import (LMDataConfig, lm_batch, lm_stream, pumadyn_like,
                       rcv1_like)
from .sparse import CsrMatrix, SparseChunkSource, is_sparse_matrix
