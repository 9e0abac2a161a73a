"""The FFN backward pair's grid and scratch (`ops/ffn_common.py`), on the CPU.

The kernels run only on the card, but the wrappers size their buffers and
split the weight-gradient sums over row groups in Python: these tests hold
that every row is summed exactly once, for every row count of a training
batch up to the bench's 64 x 469.
"""

import numpy as np
import pytest
import torch

from espnet_tpu_torch.ops import ffn_common as fc


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread, and one for the subprocesses this file
    starts: the suite's xdist workers share the CPU, and a worker's extra
    threads oversubscribe it."""
    import os

    import torch as _torch

    n, env = _torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    _torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    _torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env

M_MAX = 64 * 469  # the bench's training rows
MS = np.arange(1, M_MAX + 1)


def _covered_once(m, groups, rows):
    """Rows [0, m) split into `groups` runs of `rows` (the last cut at m):
    every row in exactly one run, no run empty."""
    starts = np.arange(groups) * rows
    sizes = np.minimum(m, starts + rows) - starts
    return bool((sizes > 0).all()) and int(sizes.sum()) == m


@pytest.mark.parametrize("k,n", [(256, 2048), (2048, 256), (256, 1024),
                                 (128, 1024), (384, 2048), (512, 2048),
                                 (512, 1024)])
def test_wgrad_split_sums_every_row_once(k, n):
    tiles = (k // fc.TC_WGRAD_TILE) * (n // fc.TC_WGRAD_TILE)
    for m in MS:
        groups, rows = fc.wgrad_split(int(m), k, n)
        assert rows % fc.TC_WGRAD_ROWS == 0, (m, rows)
        assert 1 <= groups <= max(1, round(264 / tiles)), (m, groups)
        assert _covered_once(int(m), groups, rows), (m, groups, rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_ff", [1024, 2048])
def test_bwd_layout_covers_every_row_once(dtype, d_ff):
    for d in fc.KERNEL_MODEL_DIMS:
        rows = (fc.TC_ROWS_PER_BLOCK[d] if dtype == torch.bfloat16
                else fc.FP32_ROWS_PER_BLOCK)
        for m in MS[::7].tolist() + [M_MAX]:
            lay = fc.bwd_layout(m, d, d_ff, dtype)
            assert lay.tensor_cores == (dtype == torch.bfloat16)
            assert _covered_once(m, lay.row_blocks, rows), (d, m)
            assert _covered_once(m, lay.groups, lay.rows_per_group), (d, m)
            # db1's partial sums come per row block (tensor cores: from the
            # row kernel) or per row group (CUDA cores: from `bwd_w`)
            assert lay.db1_parts == (lay.row_blocks if lay.tensor_cores
                                     else lay.groups)


def test_bwd_layout_at_the_bench_shapes():
    """The conformer's and E-Branchformer's training shapes: 469 row blocks
    of 64 and 8 or 16 row groups of the A^T B kernel (two waves of blocks
    over its 32 or 16 result tiles)."""
    lay = fc.bwd_layout(M_MAX, 256, 2048, torch.bfloat16)
    assert (lay.row_blocks, lay.groups, lay.rows_per_group) == (469, 8, 3776)
    lay = fc.bwd_layout(M_MAX, 256, 1024, torch.bfloat16)
    assert (lay.row_blocks, lay.groups, lay.rows_per_group) == (469, 16, 1888)
    # the float32 parity mode keeps its grid: 32-row blocks, F / 32 chunks
    lay = fc.bwd_layout(M_MAX, 256, 2048, torch.float32)
    assert (lay.row_blocks, lay.groups, lay.rows_per_group) == (938, 4, 7504)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_sums", [1, 3])
def test_bwd_buffers_shapes_and_transient_scratch(dtype, n_sums):
    m, d, f = 333, 384, 1024
    x2 = torch.zeros(m, d, dtype=dtype)
    lay, buf = fc.bwd_buffers(x2, f, n_sums)
    assert buf["dx"].shape == (m, d) and buf["dx"].dtype == dtype
    assert buf["partial"].shape == (lay.row_blocks, n_sums, d)
    assert buf["dw1p"].shape == (lay.groups, d, f)
    assert buf["dw2p"].shape == (lay.groups, f, d)
    assert buf["db1p"].shape == (lay.db1_parts, f)
    for name in ("partial", "dw1p", "dw2p", "db1p"):
        assert buf[name].dtype == torch.float32, name
    if dtype == torch.bfloat16:
        # a and dh: 2·M·F bf16 elements, written and read once per call
        for name in ("a", "dh"):
            assert buf[name].shape == (m, f) and buf[name].dtype == dtype
        assert sum(buf[n].numel() * buf[n].element_size()
                   for n in ("a", "dh")) == 2 * m * f * 2
    else:
        assert buf["a"] is None and buf["dh"] is None
        assert fc.ptr(buf["a"]) is None


def test_aligned16_copies_only_a_misaligned_tensor():
    base = torch.arange(64, dtype=torch.float32).to(torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    assert fc.aligned16(base) is base
    view = base[1:33]  # 2 bytes past an aligned address
    assert view.data_ptr() % 16 != 0
    copy = fc.aligned16(view)
    assert copy.data_ptr() % 16 == 0 and copy.is_contiguous()
    assert torch.equal(copy, view)
