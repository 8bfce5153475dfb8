"""The PyTorch port's K1 row gather (find_circ2_tpu_torch/ops/gather_rows)
against the reference Pallas kernel in interpret mode, numpy, and — on a
CUDA card only — its own plain version. Tolerance 0: integer rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from find_circ2_tpu.ops.pallas_k1 import gather_rows_pallas
from find_circ2_tpu_torch.ops import gather_rows as gr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _table(rng, rows=4096, width=8):
    return rng.integers(-2 ** 31, 2 ** 31, size=(rows, width),
                        dtype=np.int64).astype(np.int32)


def test_gather_rows_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    table = _table(rng)
    idx = rng.integers(0, table.shape[0], size=1024).astype(np.int32)
    want = np.asarray(gather_rows_pallas(jnp.asarray(table),
                                         jnp.asarray(idx), interpret=True))
    got = gr.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 37, 1037])
def test_gather_rows_ragged_matches_take(n):
    rng = np.random.default_rng(n)
    table = _table(rng, rows=999)
    idx = rng.integers(0, table.shape[0], size=n)          # int64
    got = gr.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), np.take(table, idx, axis=0))


@pytest.mark.parametrize("width,n", [(2, 1), (2, 1037), (30, 37),
                                     (30, 1037)])
def test_gather_rows_any_width_matches_take(width, n):
    """Rows of any width (§2b explore's 8-byte ext_id and 120-byte ext
    rows) against jnp.take, ragged n."""
    rng = np.random.default_rng(width * n)
    table = _table(rng, rows=777, width=width)
    idx = rng.integers(0, table.shape[0], size=n).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    got = gr.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.shape == (n, width)
    assert np.array_equal(got.numpy(), want)


def test_gather_rows_off_cpu_never_falls_back():
    """A tensor that is not on the CPU launches the kernel or raises;
    it never takes the plain version."""
    table = torch.empty((16, 8), dtype=torch.int32, device="meta")
    idx = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        gr.gather_rows(table, idx)


@pytest.mark.cuda
def test_gather_rows_kernel_matches_plain_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    table = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 16, 8),
                          dtype=torch.int32, device=cuda_device, generator=g)
    before = gr.launches
    for n, dtype in ((1, torch.int32), (4097, torch.int64),
                     (32_768, torch.int32)):
        idx = torch.randint(0, table.shape[0], (n,), device=cuda_device,
                            generator=g).to(dtype)
        got = gr.gather_rows(table, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, gr.gather_rows_ref(table, idx))
    assert gr.launches == before + 3


@pytest.mark.cuda
def test_gather_rows_kernel_at_explore_shapes_on_card(cuda_device):
    """The kernel's word path at §2b explore's shapes (one 1024-read
    chunk, one anchor side): ext_id rows (W=2, n=124,928) and ext rows
    (W=30, n=62,464), exact against index_select, timed with CUDA
    events."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for width, rows, n in ((2, 1 << 23, 124_928), (30, 1 << 20, 62_464)):
        table = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, width),
                              dtype=torch.int32, device=cuda_device,
                              generator=g)
        idx = torch.randint(0, rows, (n,), device=cuda_device, generator=g)
        got = gr.gather_rows(table, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, gr.gather_rows_ref(table, idx))
        ms = {}
        for name, fn in (("kernel", gr.gather_rows),
                         ("index_select", gr.gather_rows_ref)):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                fn(table, idx)
            stop.record()
            torch.cuda.synchronize()
            ms[name] = start.elapsed_time(stop) / 50
        print(f"gather_rows W={width} n={n}: {ms}")
