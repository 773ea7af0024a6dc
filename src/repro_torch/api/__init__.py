"""Public API: ``SketchedKRR`` + sampler/solver registries.

    from repro_torch.api import SketchConfig, SketchedKRR
    from repro_torch.core import RBFKernel

    cfg = SketchConfig(kernel=RBFKernel(1.5), p=200, lam=1e-3)  # device="cuda"
    model = SketchedKRR(cfg).fit(X, y)
    y_hat = model.predict(X_test)

Samplers: uniform, diagonal, rls_exact, rls_fast (the default: Theorem-4
fast scores, then the Theorem-3 leverage draw), bless and recursive_rls.
Solvers: exact, nystrom (the default), nystrom_regularized, dnc, and the
iterative falkon_pcg and eigenpro. Backends: hopper (the CUDA kernels), torch (plain PyTorch),
streaming (hopper's tiles over ``block_rows``-row blocks), auto (hopper on
CUDA, torch on the CPU).

Out of core: ``fit(source)`` with a chunk source (eigenpro streams it once
per epoch), ``fit(X_csr, y)`` with CSR rows, ``chunk_rows=`` on the
config, ``partial_fit``/``finalize``.

Serving (``repro_torch.serve``): the landmark fits export their O(p) dual
as a ``ServingState``, which ``solver_state_from_serving`` turns into the
state the solvers' ``predict`` takes; ``make_batched_predict`` serves the
others.
"""
from ..core.kernels import (BernoulliKernel, LinearKernel, PolynomialKernel,
                            RBFKernel)
from ..core.nystrom import ColumnSample
from ..core.precision import Precision
from ..data.chunks import (ArrayChunkSource, ChunkSource,
                           GeneratorChunkSource, MemmapChunkSource,
                           as_chunk_source, gather_rows)
from ..data.sparse import CsrMatrix, SparseChunkSource, is_sparse_matrix
from .config import SketchConfig
from .estimator import (NotFittedError, ServingState, SketchedKRR,
                        serving_state_from_reference,
                        solver_state_from_serving)
from .out_of_core import (CHUNKABLE_SAMPLERS, SPARSE_CHUNK_SOLVERS,
                          ChunkedFitResult, fit_from_source)
from .samplers import SAMPLERS, Sampler, SamplerOutput
from .solvers import SOLVERS, NystromState, Solver
