"""The port of tools/pallas_probe.py (agi_lidar_slam_torch/tools/probe.py) on
the CPU: the plain versions of its two kernels against numpy and against the
reference's `stage0` kernel body, and the wrappers' checks.

* scale2 (stage0's o = 2 x): exact, against numpy and against the JAX
  kernel body run through `pl.pallas_call(..., interpret=True)`.
* row_gather_sum (stage1's per-tile row gather, in its intended form
  out[t*C + j] = sum_b src[idx[t, j], b, :]): against a float64 numpy sum,
  rtol 1e-6. All terms are positive, so each f32 summation order is within
  (log2(B) + 2) * 2**-24 ~ 4.8e-7 relative of the exact sum; two orders
  differ by at most twice that.
  It is held to numpy and not to its JAX form because that form does not run:
  `_dma_kernel` indexes the (tiles, C) scalar-prefetch index with one index
  (`idx_ref[j]`, tools/pallas_probe.py:49), which is a row of C indices, not
  a scalar, so tracing it raises a TypeError (pinned below). Indexed as
  `idx_ref[pl.program_id(0), j]` it computes the intended function.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from agi_lidar_slam_torch.tools import probe

_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _pallas_probe():
    spec = importlib.util.spec_from_file_location("pallas_probe", _ROOT / "tools" / "pallas_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scale2_matches_numpy_and_the_pallas_stage0_body():
    x = np.random.default_rng(0).normal(size=(256, 128)).astype(np.float32)

    def k(x_ref, o_ref):  # tools/pallas_probe.py:31-32, stage0's kernel body
        o_ref[:] = x_ref[:] * 2.0

    j = pl.pallas_call(k, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                       in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                       out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
                       interpret=True)(jnp.asarray(x))
    t = probe.scale2(torch.from_numpy(x))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(t.numpy(), x * 2)
    assert torch.equal(probe.scale2_ref(torch.ones(3)), torch.full((3,), 2.0))


@pytest.mark.parametrize("C,B,rows,tiles", [(64, 64, 4096, 8), (8, 27, 100, 5)],
                         ids=["probe_defaults", "ragged"])
def test_row_gather_sum_per_tile_form(C, B, rows, tiles):
    """The reference probe's inputs (pallas_probe.py:70-71): out[t*C + j] is
    the row sum of src[idx[t, j]], computed tile by tile in float64."""
    src, idx = probe.probe_inputs(C, B, rows, tiles, device="cpu")
    out = probe.row_gather_sum(idx, src)
    s, ix = src.numpy().astype(np.float64), idx.numpy().reshape(tiles, C)
    expect = np.zeros((tiles * C, 3))
    for t in range(tiles):
        for j in range(C):
            expect[t * C + j] = s[ix[t, j]].sum(axis=0)
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-6, atol=0)
    assert out.shape == (tiles * C, 3)


def test_row_gather_sum_random_and_out_of_range():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(50, 64, 3)).astype(np.float32)
    idx = rng.integers(-3, 53, 300).astype(np.int32)
    out = probe.row_gather_sum(torch.from_numpy(idx), torch.from_numpy(src)).numpy()
    ok = (idx >= 0) & (idx < 50)
    assert ok.sum() > 200 and (~ok).sum() > 5
    expect = src.astype(np.float64)[np.clip(idx, 0, 49)].sum(axis=1)
    # signed terms: the bound scales with the sum of magnitudes
    mag = np.abs(src.astype(np.float64))[np.clip(idx, 0, 49)].sum(axis=1)
    assert np.all(np.abs(out[ok] - expect[ok]) <= 1e-6 * mag[ok])
    assert np.isnan(out[~ok]).all()  # outside [0, rows): NaN, as the kernel writes


def test_gather_bytes_counts_distinct_rows():
    src, idx = probe.probe_inputs(device="cpu")  # 512 indices, 97 coprime to 4096
    assert probe.gather_bytes(idx, src) == 512 * 768 + 512 * 4 + 512 * 12
    src, idx = probe.probe_inputs(64, 64, 16640, 1024, device="cpu")  # the map table's size
    assert probe.gather_bytes(idx, src) == 16640 * 768 + 65536 * 16


def test_wrappers_reject_bad_inputs():
    src, idx = probe.probe_inputs(8, 4, 16, 2, device="cpu")
    with pytest.raises(ValueError, match="idx"):
        probe.row_gather_sum(idx.long(), src)
    with pytest.raises(ValueError, match="src"):
        probe.row_gather_sum(idx, src.double())
    with pytest.raises(ValueError, match="rows,B,3"):
        probe.row_gather_sum(idx, src.reshape(16, 12))
    with pytest.raises(ValueError, match="contiguous"):
        probe.scale2(torch.zeros((3, 4)).T)
    # neither cpu nor cuda: no silent fallback to the plain version
    with pytest.raises(ValueError, match="cpu or cuda"):
        probe.scale2(torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        probe.row_gather_sum(idx.to("meta"), src.to("meta"))


def test_cli_needs_a_card(capsys):
    assert probe.main(["stage9"]) == 2
    if not torch.cuda.is_available():
        assert probe.main(["stage0"]) == 1
        assert "no CUDA device" in capsys.readouterr().err


def test_reference_stage1_indexes_a_row():
    """tools/pallas_probe.py's `_dma_kernel`, called as its stage1 does
    (:74-88) but in interpret mode, does not trace: idx_ref[j] on the
    (tiles, C) prefetch is a row."""
    pp = _pallas_probe()
    C, B, rows, tiles = 8, 4, 64, 2
    src = jnp.arange(rows * B * 3, dtype=jnp.float32).reshape(rows, B, 3)
    idx = (jnp.arange(tiles * C, dtype=jnp.int32) * 97) % rows
    call = pl.pallas_call(
        functools.partial(pp._dma_kernel, C=C, B=B),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(tiles,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((C, 3), lambda i, *_: (i, 0), memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((C, B, 3), jnp.float32),
                            pltpu.SemaphoreType.DMA((8,))]),
        out_shape=jax.ShapeDtypeStruct((tiles * C, 3), jnp.float32), interpret=True)
    with pytest.raises(TypeError):
        call(idx.reshape(tiles, C), src)
