"""Native (C++) host-side components.

The device compute path is XLA; this package is the native *runtime
around it* — currently the multithreaded sparse graph builder
(:mod:`csrc/sig_native.cpp`) that replaces the scipy KD-tree data path of
:mod:`sig_sdp_mmw_tpu.env.large` at production scale.

The shared library is compiled on first use (``g++ -O3 -fopenmp``, ~1 s) and
cached next to the source; every entry point degrades gracefully to the
Python/scipy implementation when a toolchain is unavailable, so the native
layer is an accelerator, never a hard dependency.
"""

from sig_sdp_mmw_tpu.native.builder import (  # noqa: F401
    build_state_csr_native,
    greedy_round_native,
    native_available,
    native_num_threads,
)
