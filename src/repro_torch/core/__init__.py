"""Core paper library: kernels, ridge-leverage scores, Nyström sketches, KRR."""
from .backends import (BACKENDS, HopperOps, KernelOps, StreamingOps,
                       TorchOps, jittered_cholesky, ops_for, ops_for_config,
                       resolve_backend)
from .kernels import (BernoulliKernel, Kernel, LinearKernel,
                      PolynomialKernel, RBFKernel, gram_matrix,
                      kernel_columns)
from .krr import (RiskReport, empirical_risk, krr_fit, nystrom_krr_fit,
                  risk_exact, risk_nystrom, woodbury_solve)
from .leverage import (FastLeverageResult, draw_landmarks,
                       effective_dimension, fast_ridge_leverage,
                       max_degrees_of_freedom, ridge_leverage_scores,
                       ridge_leverage_scores_eig, theorem3_sample_size,
                       theorem4_sample_size)
from .nystrom import (ColumnSample, NystromApprox, draw_columns,
                      nystrom_factors, nystrom_regularized_factors)
from .precision import (Precision, canonical_dtype_name, dtype_jitter_floor,
                        floored_jitter)
