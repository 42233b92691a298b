"""Placement of the block-sparse operands, the compile-cache helper, and the
failure paths of the GPU entry points (chip_smoke.py, bench.py)."""

import pathlib
import sys

import jax
import numpy as np
import pytest

from sig_sdp_mmw_tpu.env.large import generate_large_state_csr
from sig_sdp_mmw_tpu.native import native_available
from sig_sdp_mmw_tpu.utils import runtime

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("packer", ["numpy", "native"])
def test_bcsr_operand_leaves_uncommitted_on_default_device(monkeypatch,
                                                           packer):
    """Every operand leaf lands on the default device, uncommitted, so the
    caller's device_put decides where the solve runs — on both packers."""
    import jax.numpy as jnp

    from sig_sdp_mmw_tpu.ops import bcsr as B

    if packer == "native":
        assert native_available()
        monkeypatch.setattr(B, "_NATIVE_PACK_MIN_NNZ", 0)
    else:
        monkeypatch.setattr(B, "_NATIVE_PACK_MIN_NNZ", 1 << 62)
    S, Q, _ = generate_large_state_csr(20, seed=1, backend="python")
    ops = B.bcsr_operands_from_state(S, Q, block=(8, 128),
                                     dtype=jnp.bfloat16,
                                     store_transpose=True)
    leaves = jax.tree.leaves(ops)
    assert len(leaves) == 11          # 7 arrays + 2 BlockEll pairs
    default = jax.devices()[0]
    for leaf in leaves:
        assert isinstance(leaf, jax.Array)
        assert not leaf.committed
        assert leaf.devices() == {default}
    assert ops.s_blocks.blocks.dtype == jnp.bfloat16
    assert ops.st_blocks.blocks.dtype == jnp.bfloat16

    # An explicit placement commits every leaf to the requested device.
    target = jax.devices()[-1]
    placed = jax.device_put(ops, target)
    assert all(leaf.committed and leaf.devices() == {target}
               for leaf in jax.tree.leaves(placed))


@pytest.mark.parametrize("builder", ["bcsr", "ell"])
def test_host_operands_shard_from_host(builder):
    """``host=True`` leaves are numpy arrays equal to the device build, so a
    mesh placement sends each device its own slice and stages nothing on
    the default device."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sig_sdp_mmw_tpu.core.ell import ell_from_scipy
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state
    from sig_sdp_mmw_tpu.parallel import make_mesh

    S, Q, h = generate_large_state_csr(20, seed=1, backend="python")
    nr = ((S.shape[0] + 4 * 128 - 1) // (4 * 128)) * (4 * 128)
    if builder == "bcsr":
        def build(**kw):
            return bcsr_operands_from_state(S, Q, block=128,
                                            dtype=jnp.bfloat16,
                                            store_transpose=True,
                                            pad_rows_to=nr, **kw)
        row_lens = (nr // 128, nr)
    else:
        def build(**kw):
            return ell_from_scipy(S, Q, h, pad_rows_to=nr, **kw)
        row_lens = (nr,)

    on_host, on_dev = build(host=True), build()
    assert jax.tree.structure(on_host) == jax.tree.structure(on_dev)
    for a, b in zip(jax.tree.leaves(on_host), jax.tree.leaves(on_dev)):
        assert isinstance(a, np.ndarray) and not isinstance(a, jax.Array)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, np.asarray(b))

    mesh = make_mesh(4, batch_size=1)
    n_split = 0
    for leaf in jax.tree.leaves(on_host):
        split = leaf.ndim >= 1 and leaf.shape[0] in row_lens
        spec = P("graph", *([None] * (leaf.ndim - 1))) if split else P()
        placed = jax.device_put(leaf, NamedSharding(mesh, spec))
        shards = placed.addressable_shards
        assert len({s.device for s in shards}) == 4
        if split:
            n_split += 1
            assert all(s.data.shape[0] == leaf.shape[0] // 4 for s in shards)
        np.testing.assert_array_equal(np.asarray(placed), leaf)
    assert n_split >= 2


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compile_cache(monkeypatch, tmp_path, env_set):
    old = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert runtime.enable_compile_cache() == str(tmp_path)
            # The variable is JAX's own: nothing is set in code.
            assert jax.config.jax_compilation_cache_dir == old
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = str(REPO / ".jax_cache")
            assert runtime.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


@pytest.fixture
def repo_on_path(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))


def test_chip_smoke_device_check_raises_on_cpu(repo_on_path, monkeypatch,
                                               capsys):
    import chip_smoke

    monkeypatch.setattr(runtime, "enable_compile_cache", lambda: None)
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase_device()
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_bench_main_fails_when_large_cell_raises(repo_on_path, monkeypatch,
                                                 capsys):
    import bench

    def large_fails(jax_mod):
        raise RuntimeError("large cell failed")

    monkeypatch.setattr(runtime, "enable_compile_cache", lambda: None)
    monkeypatch.setattr(runtime, "require_gpu", jax.devices)
    monkeypatch.setattr(runtime, "gpu_name_and_power_limit",
                        lambda: "test card, 700.00 W")
    monkeypatch.setattr(bench, "_bench_k300", lambda jax_mod, base: 100.0)
    monkeypatch.setattr(bench, "_bench_large", large_fails)
    with pytest.raises(RuntimeError, match="large cell failed"):
        bench.main()
    assert "mmw_iterations_per_sec_K300" not in capsys.readouterr().out
    sys.modules.pop("bench", None)
