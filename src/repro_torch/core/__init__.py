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
from .dnc import (DnCModel, dnc_fit, dnc_kernel_evals, dnc_predict,
                  dnc_predict_train)
from .concentration import (bernstein_tail, beta_of_distribution, psi_matrix,
                            sketch_deviation, theorem2_required_p)
from .recursive_rls import (RecursiveRLSResult, recursive_ridge_leverage,
                            sampling_beta)
from .bless import (BlessResult, BlessStage, bless_dict_size,
                    bless_lambda_schedule, bless_leverage,
                    bless_overestimate)
