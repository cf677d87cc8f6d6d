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
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

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


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1003, 32768])
@pytest.mark.parametrize("offset", [0, 1])
def test_scale2_tail_and_misaligned_view(n, offset):
    """Every length (a float4 body with a tail of n % 4 on the card) and a
    view 4 bytes past its allocation (not 16-byte aligned: one element a
    thread on the card) give exactly 2 x."""
    x = torch.from_numpy(np.random.default_rng(n).normal(size=n + offset).astype(np.float32))
    v = x[offset:]
    assert v.is_contiguous() and bool(v.data_ptr() % 16) == bool(offset)
    assert torch.equal(probe.scale2(v), v * 2)


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


def _float64_sums(idx, src):
    s, ix = src.numpy().astype(np.float64), idx.numpy()
    ok = (ix >= 0) & (ix < s.shape[0])
    out = np.full((ix.shape[0], 3), np.nan)
    out[ok] = s[ix[ok]].sum(axis=1)
    return out


@pytest.mark.parametrize("case", ["one_row", "distinct", "bucket125"])
def test_row_gather_sum_cases_against_float64(case):
    """chip_smoke's row-gather cases, at a small size: all copies of one row,
    each row once (a permutation), and rows of 125 sub-voxels with indices
    outside the table (whole numbers, so the sums are exact)."""
    make = {"one_row": lambda: probe.one_row_inputs(4096, 64, 300, seed=3, device="cpu"),
            "distinct": lambda: probe.distinct_inputs(64, 300, seed=3, device="cpu"),
            "bucket125": lambda: probe.bucket_inputs(125, 40, 200, seed=3, device="cpu")}
    src, idx = make[case]()
    out, expect = probe.row_gather_sum(idx, src).numpy(), _float64_sums(idx, src)
    if case == "bucket125":
        assert np.isnan(expect).any() and not np.isnan(expect).all()
        np.testing.assert_array_equal(out, expect)
    else:
        np.testing.assert_allclose(out, expect, rtol=1e-6, atol=0)
    if case == "distinct":
        assert sorted(idx.tolist()) == list(range(300))
    if case == "one_row":
        assert torch.unique(idx).numel() == 1


def test_gather_bytes_of_the_distinct_and_one_row_cases():
    src, idx = probe.distinct_inputs(device="cpu")  # 16640 rows, each once
    assert probe.gather_bytes(idx, src) == 16640 * 768 + 16640 * 16
    src, idx = probe.one_row_inputs(device="cpu")  # 65,536 copies of one row
    assert probe.gather_bytes(idx, src) == 768 + 65536 * 16
    src, idx = probe.bucket_inputs(27, 10, 64, seed=0, device="cpu")  # outside: no row
    inside = torch.unique(idx[(idx >= 0) & (idx < 10)]).numel()
    assert probe.gather_bytes(idx, src) == inside * 27 * 12 + 64 * 16


def test_case_builders_are_deterministic_in_the_seed():
    for make in (lambda s: probe.distinct_inputs(64, 300, seed=s, device="cpu"),
                 lambda s: probe.one_row_inputs(64, 64, 300, seed=s, device="cpu"),
                 lambda s: probe.bucket_inputs(27, 50, 100, seed=s, device="cpu")):
        (a_src, a_idx), (b_src, b_idx), (_, c_idx) = make(5), make(5), make(6)
        assert torch.equal(a_src, b_src) and torch.equal(a_idx, b_idx)
        assert not torch.equal(a_idx, c_idx)


def test_gather_scratch_is_per_key_grows_and_wraps(monkeypatch):
    """The claim scratch of the card's row gather, driven with CPU tensors:
    one per (device, stream) key, at least `rows` rows, the epoch advanced a
    launch and, at EPOCH_LIMIT, the tags zeroed and the epoch back at 1."""
    monkeypatch.setattr(probe, "_scratch", {})
    monkeypatch.setattr(probe, "EPOCH_LIMIT", 4)
    tag, sums, e1 = probe.gather_scratch(("a", 1), 10, "cpu")
    assert tag.shape == (10,) and sums.shape == (10, 4) and e1 == 1
    tag[:], sums[:] = 7, 7
    _, _, e2 = probe.gather_scratch(("a", 1), 10, "cpu")
    _, _, other = probe.gather_scratch(("a", 2), 10, "cpu")  # another stream: its own
    assert (e2, other) == (2, 1) and len(probe._scratch) == 2
    _, _, e3 = probe.gather_scratch(("a", 1), 10, "cpu")
    tag4, _, e4 = probe.gather_scratch(("a", 1), 10, "cpu")  # the wrap
    assert (e3, e4) == (3, 1) and tag4 is tag and not (bool(tag.any()) or bool(sums.any()))
    big, _, e5 = probe.gather_scratch(("a", 1), 15, "cpu")  # grown: new, zeroed
    assert big.shape == (20,) and e5 == 1 and not bool(big.any())


@pytest.mark.parametrize("bucket,aligned,loads", [(64, True, "16-byte"), (64, False, "4-byte"),
                                                 (27, True, "4-byte")])
def test_claims_pay_only_on_large_repeated_gathers_and_never_under_capture(bucket, aligned,
                                                                           loads):
    """The wrapper's choice of row claims, from the shapes alone: more indices
    than rows and at least CLAIM_MIN_BYTES gathered for the kernel's loads
    (16-byte at 64 sub-voxels on an aligned table), never under capture."""
    big = -(-probe.CLAIM_MIN_BYTES[loads] // (bucket * 12))  # fewest indices to reach it
    assert probe.claims_pay(big, big // 4, bucket, aligned, capturing=False)
    assert not probe.claims_pay(big, big // 4, bucket, aligned, capturing=True)
    assert not probe.claims_pay(big - 1, big // 4, bucket, aligned, capturing=False)
    assert not probe.claims_pay(big, big, bucket, aligned, capturing=False)  # no repeats


def test_row_gather_sum_claims_at_the_association_tables_size():
    assert probe.claims_pay(65536, 16640, 64, True, capturing=False)
    assert not probe.claims_pay(8192, 2000, 27, True, capturing=False)  # 2.6 MB gathered


def test_row_gather_under_capture_takes_no_claims(monkeypatch):
    """Under CUDA graph capture (simulated: the capture check answers yes) the
    wrapper reads every row, and forcing claims raises: a replay would reuse
    the captured epoch and read the captured launch's sums."""
    src, idx = probe.probe_inputs(64, 64, 300, 20, device="cpu")  # 1280 indices, 300 rows
    monkeypatch.setattr(probe, "CLAIM_MIN_BYTES", {"16-byte": 0, "4-byte": 0})
    chose = []
    real = probe._row_gather
    monkeypatch.setattr(probe, "_row_gather", lambda i, s, claims: (chose.append(claims),
                                                                     real(i, s, claims))[1])
    probe.row_gather_sum(idx, src)
    monkeypatch.setattr(probe, "_capturing", lambda t: True)
    out = probe.row_gather_sum(idx, src)
    assert chose == [True, False]
    assert torch.equal(out, probe.row_gather_sum_ref(idx, src))
    with pytest.raises(RuntimeError, match="graph capture"):
        real(idx, src, True)
