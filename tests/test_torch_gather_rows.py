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


@pytest.mark.parametrize("widths,n", [((8, 8), 1), ((8, 2), 1037),
                                      ((8, 30), 37), ((8, 2, 30), 1000),
                                      ((2,), 64)])
def test_gather_rows_multi_matches_take(widths, n):
    """gather_rows_multi against jnp.take per table, tables of several
    row counts sharing one index vector."""
    rng = np.random.default_rng(sum(widths) * n)
    tables = [_table(rng, rows=999 + 7 * i, width=w)
              for i, w in enumerate(widths)]
    idx = rng.integers(0, 999, size=n)
    got = gr.gather_rows_multi([torch.from_numpy(t) for t in tables],
                               torch.from_numpy(idx))
    assert len(got) == len(tables)
    for t, g in zip(tables, got):
        want = np.asarray(jnp.take(jnp.asarray(t), jnp.asarray(idx), axis=0))
        assert g.shape == (n, t.shape[1])
        assert np.array_equal(g.numpy(), want)


def _card_table(g, rows, width, offset):
    """A contiguous int32 [rows, width] table on the card whose base lies
    `offset` 4-byte words past an allocation (a view)."""
    flat = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows * width + offset,),
                         dtype=torch.int32, device=g.device, generator=g)
    return flat[offset:].view(rows, width)


# (width, base offset in words, idx type, n): every vector path of the
# kernel: 16-byte rows with the vectors per row fixed (W=8) and at run
# time (W=12); 8-byte fixed (W=2, W=30) and at run time (W=6); 4-byte
# words (W=1, W=3); and views whose base is not aligned for the wider
# vector, which fall back to a narrower one.
VECTOR_PATHS = [(8, 0, torch.int64, 4097), (8, 0, torch.int32, 1),
                (12, 0, torch.int32, 1037), (2, 0, torch.int64, 124_928),
                (2, 0, torch.int32, 1), (30, 0, torch.int64, 62_464),
                (30, 0, torch.int32, 33), (6, 0, torch.int64, 999),
                (1, 0, torch.int64, 1000), (3, 0, torch.int32, 77),
                (8, 1, torch.int64, 4099), (8, 2, torch.int32, 100),
                (2, 1, torch.int64, 777), (30, 1, torch.int32, 1001)]


@pytest.mark.cuda
@pytest.mark.parametrize("width,offset,dtype,n", VECTOR_PATHS)
def test_gather_rows_vector_paths_on_card(cuda_device, width, offset, dtype,
                                          n):
    g = torch.Generator(device=cuda_device).manual_seed(width * 100 + n)
    table = _card_table(g, 1 << 15, width, offset)
    idx = torch.randint(0, table.shape[0], (n,), device=cuda_device,
                        generator=g).to(dtype)
    before = gr.launches
    got = gr.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gr.gather_rows_ref(table, idx))
    assert gr.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("widths,want_launches", [
    ((8, 8), 1), ((8, 2), 1), ((8, 30), 2), ((8, 2, 30), 2), ((2, 8), 2)])
def test_gather_rows_multi_on_card(cuda_device, widths, want_launches):
    """The main path's pairs, (8, 8) and (8, 2), take one launch; any
    other pair one launch per table; a third table its own call."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(widths))
    tables = [_card_table(g, (1 << 14) + 3 * i, w, 0)
              for i, w in enumerate(widths)]
    for n, dtype in ((124_928, torch.int64), (1, torch.int32),
                     (16_385, torch.int32)):
        idx = torch.randint(0, 1 << 14, (n,), device=cuda_device,
                            generator=g).to(dtype)
        before = gr.multi_launches
        got = gr.gather_rows_multi(tables, idx)
        torch.cuda.synchronize()
        assert gr.multi_launches == before + want_launches
        for t, x in zip(tables, got):
            assert torch.equal(x, gr.gather_rows_ref(t, idx))


class _CurrentDevice:
    """A stand-in for torch.cuda.device that records the device each
    stubbed C call saw as current."""

    current = 0

    def __init__(self, dev) -> None:
        self.dev, self.prev = dev, None

    def __enter__(self):
        self.prev, _CurrentDevice.current = _CurrentDevice.current, self.dev
        return self

    def __exit__(self, *exc):
        _CurrentDevice.current = self.prev


def test_gather_rows_c_call_runs_on_the_tables_device(monkeypatch):
    """Each C call of the row gather runs with the tensors' device
    current, so the default stream's null handle launches there."""
    from find_circ2_tpu_torch import _build
    seen = []

    class Lib:
        def fc2t_gather_rows(self, buf):
            fields = _build.GATHER_ARGS.unpack(buf)
            seen.append((_CurrentDevice.current, fields[-1]))
            return 1

    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", _CurrentDevice)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(_table(rng, rows=64))
    idx = torch.arange(8)
    for dev in (1, 3):
        assert gr._launch(dev, idx, 8, table, torch.empty(8, 8,
                                                          dtype=torch.int32),
                          table, torch.empty(8, 8, dtype=torch.int32)) == 1
    assert seen == [(1, 1), (3, 3)] and _CurrentDevice.current == 0
