"""sig_sdp_mmw_tpu — SIG-SDP framework in JAX.

A from-scratch JAX/XLA framework for sparse interference-graph-aided
semidefinite programming (SIG-SDP) applied to large-scale wireless
time-sensitive-network slot scheduling, with the same capabilities as the
reference repo ``zhouyou-gu/sig-sdp-mmw`` (numpy/scipy/cvxpy research code),
re-designed for accelerators:

* the problem ``state`` is a static-shape, padded dense/ELL graph container
  (:mod:`sig_sdp_mmw_tpu.core`) instead of mutable scipy CSR;
* the matrix-multiplicative-weights solver is a single jitted
  ``lax.fori_loop`` whose dominant cost — the action of the matrix
  exponential — is a fixed-iteration batched Lanczos built from dense matmuls
  (:mod:`sig_sdp_mmw_tpu.ops`);
* scenario batching is ``vmap`` + mesh sharding (:mod:`sig_sdp_mmw_tpu.parallel`);
* randomized rounding, feasibility checking, binary search over Z, heuristics
  and exact baselines live in :mod:`sig_sdp_mmw_tpu.models`.

Reference parity citations use ``/root/reference/<path>:<line>`` in docstrings.
"""

__version__ = "0.1.0"

from sig_sdp_mmw_tpu.core.problem import SigState, state_from_arrays  # noqa: F401
